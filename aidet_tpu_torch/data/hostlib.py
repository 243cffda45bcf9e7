"""The port's host library: the JPEG decoder and Telea's inpaint.

`aidet_tpu_torch/csrc/jpeg_decode.cpp` and `csrc/inpaint.cpp` are built
together with g++ at first use (`cuda_build.build_host_library`, into
the git-ignored ``build/aidet_tpu_torch/`` beside the kernels) and
loaded with ctypes, which releases the GIL during a call: the loader's
decode threads run in parallel.  There is no fallback: when g++ is
missing or the build fails, the first call raises with the compiler's
error.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_ERR_LEN = 256
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library() -> ctypes.CDLL:
    """The loaded host library, built on the first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            from ..cuda_build import build_host_library
            lib = ctypes.CDLL(str(build_host_library().path))
            i, p = ctypes.c_int, ctypes.c_char_p
            lib.aidet_jpeg_info.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(i),
                ctypes.POINTER(i), ctypes.POINTER(i), p, i]
            lib.aidet_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_long, _U8P, i, i, p, i]
            lib.aidet_inpaint_telea.argtypes = [
                _U8P, _U8P, _U8P, i, i, i, ctypes.c_double]
            for fn in (lib.aidet_jpeg_info, lib.aidet_jpeg_decode,
                       lib.aidet_inpaint_telea):
                fn.restype = i
            _LIB = lib
    return _LIB


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def decode_jpeg(data: bytes, name) -> tuple[np.ndarray, int]:
    """(HWC uint8 BGR pixels, EXIF orientation 1-8) of the JPEG bytes
    ``data``; a ValueError naming ``name`` for a file it does not read."""
    lib = library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w, orientation = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.aidet_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                           ctypes.byref(orientation), err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.aidet_jpeg_decode(data, len(data), _ptr(out), h.value, w.value,
                             err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out, orientation.value


def inpaint_telea(img: np.ndarray, mask: np.ndarray,
                  radius: float = 3.0) -> np.ndarray:
    """`cv2.inpaint(img, mask, radius, cv2.INPAINT_TELEA)` of an HW or
    HWC uint8 image (1 to 4 channels); ``mask`` HW, non-zero where to
    inpaint.  Only the box of the mask grown by the radius and 2 is
    inpainted: Telea's march and its reads reach the radius plus one
    pixel beyond the hole, so the pixels, and their order in the march,
    are those of the whole image."""
    img, mask = np.asarray(img), np.asarray(mask)
    if img.dtype != np.uint8 or mask.shape != img.shape[:2] \
            or img.ndim == 3 and not 1 <= img.shape[2] <= 4:
        raise ValueError(f"inpaint takes uint8 HxW[xC] and an HxW mask, not "
                         f"{img.dtype} {img.shape} and {mask.shape}")
    out = img.copy()
    rows = np.flatnonzero(mask.any(1))
    if not len(rows):
        return out
    cols = np.flatnonzero(mask.any(0))
    m = min(max(int(np.rint(radius)), 1), 100) + 2
    y0, y1 = max(rows[0] - m, 0), min(rows[-1] + m + 1, img.shape[0])
    x0, x1 = max(cols[0] - m, 0), min(cols[-1] + m + 1, img.shape[1])
    crop = np.ascontiguousarray(img[y0:y1, x0:x1])
    hole = np.ascontiguousarray(mask[y0:y1, x0:x1] != 0, np.uint8)
    res = np.empty_like(crop)
    ch = img.shape[2] if img.ndim == 3 else 1
    library().aidet_inpaint_telea(_ptr(crop), _ptr(hole), _ptr(res),
                                  y1 - y0, x1 - x0, ch, float(radius))
    out[y0:y1, x0:x1] = res
    return out
