"""The test side of the host data pipeline: resize, normalize, pad.

Port of `aidet_tpu/data/pipeline.py` (`IMAGENET_MEAN` / `IMAGENET_STD`
:20, `normalize_image` :24, `resize_keep_ratio` :38, `TestPipeline`
:303-339) without OpenCV:

- `resize_keep_ratio` returns an image that already has the target
  size untouched (exact; the scene path's 1024^2 patches), and
  otherwise resizes with torch's bilinear interpolation
  (align_corners=False, no antialias: cv2.INTER_LINEAR's sampling),
  rounded to uint8 for uint8 images.  cv2 rounds in fixed point, so a
  pixel may differ from its result by one grey level
  (tests/test_torch_port_inference.py);
- `TestPipeline`'s host normalize is `normalize_image` and zero
  padding, the function the reference's native `normalize_pad`
  computes.

The train side is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def normalize_image(img, mean=IMAGENET_MEAN, std=IMAGENET_STD, to_rgb=True):
    """Parity: pipelines Normalize (transforms.py:405-433)."""
    img = img.astype(np.float32)
    if to_rgb and img.shape[-1] == 3:
        img = img[..., ::-1]
    return (img - mean) / std


def resize_keep_ratio(img, target: int):
    """Resize long edge to target, keep aspect (Resize keep_ratio=True,
    transforms.py:27-112). Returns (img, scale_factor)."""
    h, w = img.shape[:2]
    scale = min(target / h, target / w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    if (nh, nw) == (h, w):
        return img, scale
    x = torch.from_numpy(np.ascontiguousarray(img))
    x = x.reshape(h, w, -1).permute(2, 0, 1)[None]
    x = x.to(torch.float64 if img.dtype == np.float64 else torch.float32)
    out = F.interpolate(x, size=(nh, nw), mode="bilinear",
                        align_corners=False, antialias=False)
    out = out[0].permute(1, 2, 0).reshape((nh, nw) + img.shape[2:])
    if img.dtype == np.uint8:
        out = out.round().clamp(0, 255)
    return out.numpy().astype(img.dtype), scale


class TestPipeline:
    """resize -> normalize -> pad to img_size^2; with device_normalize
    (uint8 BGR images) the raw pixels go out, padded with the mean
    pixel, and the model normalizes them on the card."""
    __test__ = False  # not a pytest class

    def __init__(self, img_size: int = 1024,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 to_rgb: bool = True, device_normalize: bool = False):
        self.img_size = img_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb
        self.device_normalize = device_normalize

    def __call__(self, img):
        size = self.img_size
        img, scale = resize_keep_ratio(img, size)
        h, w = img.shape[:2]
        if (self.device_normalize and img.dtype == np.uint8
                and img.shape[-1] == 3):
            # Mean-pixel padding normalizes to ~0 (host-path parity).
            pad_val = np.round(self.mean[::-1] if self.to_rgb
                               else self.mean).astype(np.uint8)
            padded = np.broadcast_to(pad_val, (size, size, 3)).copy()
            padded[:h, :w] = img
        else:
            x = normalize_image(img, self.mean, self.std, self.to_rgb)
            padded = np.zeros((size, size, img.shape[-1]), np.float32)
            padded[:h, :w] = x
        return dict(imgs=padded,
                    img_shapes=np.asarray([h, w], np.float32),
                    scale_factors=np.asarray(scale, np.float32))
