"""The port's JPEG decoder (`aidet_tpu_torch/csrc/jpeg_decode.cpp` through
`data/hostlib.py` and `data/imio.py::imread`) against `cv2.imread`, on
the CPU, where the host library is built with g++ at first use.

Tolerance: none.  Every file here decodes to cv2's array byte for byte:
the fixtures under tests/fixtures/jpeg (their recorded sha256 too), a
seeded sample of 32 of data/dota_e2e_xl's JPEGs, files written by
`cv2.imwrite` across quality 5 / 50 / 95, sampling 4:4:4 / 4:2:2 /
4:2:0 and grey, sizes 1x1, 17x33 and 333x517, a restart interval and
optimised Huffman tables, and an APP1 orientation tag spliced into a
fixture (all 8 orientations, both byte orders).  Progressive,
truncated and non-JPEG files raise a ValueError naming the file; 6
threads decode the same arrays as one.
"""

import glob
import hashlib
import itertools
import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

from aidet_tpu_torch.data.imio import imread

from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "jpeg")
with open(os.path.join(FIXTURES, "decodes.json")) as _f:
    DECODES = json.load(_f)
E2E = sorted(glob.glob(os.path.join(REPO, "data", "dota_e2e_xl", "*",
                                    "*.jpg")))
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "grey": None}


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(DECODES))
def test_fixture_decodes_equal_cv2(name):
    path = os.path.join(FIXTURES, name)
    want = DECODES[name]
    if "refused" in want:
        with pytest.raises(ValueError, match=want["refused"]):
            imread(path)
        with pytest.raises(ValueError, match=os.path.basename(name)):
            imread(path)
        return
    got = imread(path)
    assert list(got.shape) == want["shape"] and got.dtype == np.uint8
    assert _sha(got) == want["sha256"]
    np.testing.assert_array_equal(got, cv2.imread(path))


def test_e2e_sample_equals_cv2():
    """32 seeded files of the r18_e2e configs' data (2592 baseline 4:2:0
    512^2 JPEGs)."""
    assert len(E2E) >= 2592
    pick = np.random.RandomState(0).choice(len(E2E), 32, replace=False)
    for i in pick:
        np.testing.assert_array_equal(imread(E2E[i]), cv2.imread(E2E[i]),
                                      err_msg=E2E[i])


def _scene(h, w, seed, grey):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([128 + 90 * np.cos(x / (4 + c) - y / (6 + c))
                    for c in range(3)], -1) + rs.normal(0, 30, (h, w, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if grey else img


@pytest.mark.parametrize("quality", [5, 50, 95])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_cv2_written_files_equal_cv2(tmp_path, quality, sampling):
    """Each size, with and without a restart interval (2 MCUs) and
    optimised Huffman tables."""
    for k, ((h, w), rst, opt) in enumerate(itertools.product(
            [(1, 1), (17, 33), (333, 517)], [0, 2], [0, 1])):
        params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                  cv2.IMWRITE_JPEG_OPTIMIZE, opt]
        if SAMPLING[sampling] is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        path = str(tmp_path / f"{h}x{w}_{rst}_{opt}.jpg")
        assert cv2.imwrite(path, _scene(h, w, k, sampling == "grey"), params)
        got, want = imread(path), cv2.imread(path)
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def _app1_orientation(value, little):
    e = "<" if little else ">"
    tiff = ((b"II" if little else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, value, 0)
            + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("little", [True, False], ids=["II", "MM"])
def test_exif_orientation_equals_cv2(tmp_path, little):
    data = open(os.path.join(FIXTURES, "small", "rst2_q75_420_61x93.jpg"),
                "rb").read()
    for value in range(1, 9):
        path = str(tmp_path / f"o{value}.jpg")
        with open(path, "wb") as f:
            f.write(data[:2] + _app1_orientation(value, little) + data[2:])
        got, want = imread(path), cv2.imread(path)
        assert got.shape == want.shape == ((61, 93, 3) if value < 5
                                           else (93, 61, 3)), value
        np.testing.assert_array_equal(got, want, err_msg=str(value))


def test_refuses_progressive_truncated_and_other_files(tmp_path):
    img = _scene(40, 56, 0, False)
    cases = {}
    path = str(tmp_path / "progressive.jpg")
    cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    cases[path] = "progressive"
    data = open(os.path.join(FIXTURES, "dota", sorted(os.listdir(
        os.path.join(FIXTURES, "dota")))[0]), "rb").read()
    for name, cut in (("half.jpg", len(data) // 2), ("no_eoi.jpg", -2),
                      ("header.jpg", 200)):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data[:cut])
        cases[path] = "truncated"
    path = str(tmp_path / "text.jpg")
    with open(path, "wb") as f:
        f.write(b"not an image at all")
    cases[path] = "neither a PNG nor a JPEG"
    path = str(tmp_path / "corrupt.jpg")
    bad = bytearray(data)
    sos = bad.index(b"\xff\xda")
    bad[sos + 20:sos + 400] = b"\xff\x00" * 190        # garbage in the scan
    with open(path, "wb") as f:
        f.write(bytes(bad))
    cases[path] = "corrupt|truncated"
    for path, why in cases.items():
        with pytest.raises(ValueError, match=why) as err:
            imread(path)
        assert os.path.basename(path) in str(err.value)
    with pytest.raises(FileNotFoundError):
        imread(str(tmp_path / "missing.jpg"))


def test_threads_decode_what_one_thread_decodes():
    paths = [os.path.join(FIXTURES, n) for n in sorted(DECODES)
             if "refused" not in DECODES[n]] * 3
    one = [imread(p) for p in paths]
    with ThreadPoolExecutor(6) as pool:
        many = list(pool.map(imread, paths))
    for a, b, p in zip(one, many, paths):
        np.testing.assert_array_equal(a, b, err_msg=p)
