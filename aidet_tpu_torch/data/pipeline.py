"""The host data pipeline: resize, flip, normalize, pad, pack the gts.

Port of `aidet_tpu/data/pipeline.py` (`IMAGENET_MEAN` / `IMAGENET_STD`
:20, `normalize_image` :24, `resize_keep_ratio` :38, `TrainPipeline`
:49-300 with its box, rbox, mask and CenterMap targets,
`TestPipeline` :303-339, `rasterize_polygons` :342-354,
`collate_batch` :357) without OpenCV:

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

- the masks, mask weights, pseudo-segmentation and heatmap weights
  are `data.centermap`'s and `rasterize_polygons`', whose polygon fill
  is `data.raster.fill_poly` (OpenCV's `fillPoly`).

`TrainPipeline`'s optional train stages come first, in the reference's
order (:136-160): InstaBoost (`data/instaboost.py`, seeded ``seed +
1``), then albu (`data/albu.py`, the vendored subset), which refuses a
sample that carries ignored boxes or segmentations, as the reference's
stage does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import np_rboxes as NR
from . import transforms as T
from .albu import AlbuTransform
from .centermap import heatmap_weight, pointobbs2centermap, \
    pseudo_segmentation
from .instaboost import InstaBoost
from .raster import fill_poly

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


def _np_best_point_sort(pointobbs):
    if len(pointobbs) == 0:
        return pointobbs
    return NR.pointobb_best_point_sort(np.asarray(pointobbs))


class TrainPipeline:
    """resize -> rotate90 -> flip -> normalize -> pad -> fixed-gt pack.

    One ``np.random.RandomState(seed)`` draws, in the reference's order,
    the scale target (``scale_range``), the rotation (``rotate90_ratio``,
    then its multiple of 90°) and the flip, so a seed gives the
    reference's samples.  The loader's decode threads share it, as the
    reference's do: which sample takes which draw then follows the
    threads' timing (ROADMAP §3).

    Targets of the mask family (parity: the reference's LoadAnnotations
    flags and SegRescale 1/4), each over the whole padded img_size^2
    canvas:
      with_mask: gt_masks [max_gt, S, S] at S = mask_size (default
        img_size // 4), binary quads ('binary', MaskOBB) or soft
        centerness pseudo-masks ('centermap', `centermap_rate` and
        `centermap_factor` shape the template);
      with_mask_weight / with_reverse_mask_weight (exclusive):
        gt_mask_weights, the 1 - centerness (or centerness) template
        warped into each quad;
      with_semantic: gt_semantic [img_size // seg_scale]^2, the quads
        painted with their labels (255 beyond the image);
      with_heatmap_weight: gt_seg_weights, the scene's centerness
        maximum (1 - it with reverse_heatmap_weight).
    With device_normalize the [0, 1] maps go out as uint8 (`_quantize`),
    dequantized on the card.

    ``instaboost`` (a dict of `InstaBoost`'s arguments) and ``albu`` (a
    list of albu transform configs) add the train stages that run
    before the resize, InstaBoost first."""

    def __init__(self, img_size: int = 1024, max_gt: int = 256,
                 flip_ratio: float = 0.5, rotate90_ratio: float = 0.0,
                 with_rbox: bool = True,
                 rbox_encode: str = "thetaobb",
                 with_mask: bool = False, mask_size: int = 0,
                 mask_type: str = "binary",
                 with_mask_weight: bool = False,
                 with_reverse_mask_weight: bool = False,
                 with_semantic: bool = False,
                 with_heatmap_weight: bool = False,
                 reverse_heatmap_weight: bool = False,
                 centermap_rate: float = 0.5,
                 centermap_factor: float = 4.0,
                 centermap_template: int = 512,
                 seg_scale: int = 4,
                 scale_range=None, albu=None, instaboost=None,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 to_rgb: bool = True, device_normalize: bool = False,
                 seed: int = 0):
        if with_mask_weight and with_reverse_mask_weight:
            raise ValueError("with_mask_weight and with_reverse_mask_weight "
                             "exclude each other")
        if mask_type not in ("binary", "centermap"):
            raise ValueError(f"mask_type {mask_type!r}")
        if rbox_encode not in ("thetaobb", "pointobb", "hobb"):
            raise ValueError(f"rbox_encode {rbox_encode!r}")
        self.scale_range = scale_range
        self.img_size = img_size
        self.max_gt = max_gt
        self.flip_ratio = flip_ratio
        self.rotate90_ratio = rotate90_ratio
        self.with_rbox = with_rbox
        self.rbox_encode = rbox_encode
        self.with_mask = with_mask
        self.mask_size = mask_size or img_size // 4
        self.mask_type = mask_type
        self.with_mask_weight = with_mask_weight
        self.with_reverse_mask_weight = with_reverse_mask_weight
        self.with_semantic = with_semantic
        self.with_heatmap_weight = with_heatmap_weight
        self.reverse_heatmap_weight = reverse_heatmap_weight
        self.centermap_rate = centermap_rate
        self.centermap_factor = centermap_factor
        self.centermap_template = centermap_template
        self.seg_scale = seg_scale
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb
        self.device_normalize = device_normalize
        self.albu = AlbuTransform(albu) if albu else None
        self.instaboost = (InstaBoost(seed=seed + 1, **instaboost)
                           if instaboost else None)
        self.rng = np.random.RandomState(seed)

    def __call__(self, img, anns):
        """img: HWC uint8 BGR; anns: a dataset's `parse_anns` dict."""
        size = self.img_size
        if self.instaboost is not None:
            img, anns = self.instaboost(img, anns)
        if self.albu is not None:
            img, anns = self._albu(img, anns)
        if self.scale_range is not None:
            lo, hi = self.scale_range
            target = int(self.rng.uniform(lo, min(hi, size)))
        else:
            target = size
        img, scale = resize_keep_ratio(img, target)
        boxes = anns["bboxes"] * scale
        pointobbs = anns.get("pointobbs")
        if pointobbs is not None and len(pointobbs):
            pointobbs = pointobbs * scale

        if self.rotate90_ratio and self.rng.rand() < self.rotate90_ratio:
            img, rp, rb, _ = T.random_rotate90(
                img, pointobbs, boxes, rng=self.rng)
            # None for empty or absent inputs: keep the empty arrays
            boxes = rb if rb is not None else boxes
            pointobbs = rp if rp is not None else pointobbs

        flip = self.rng.rand() < self.flip_ratio
        h, w = img.shape[:2]
        if flip:
            img = img[:, ::-1]
            x1 = w - boxes[:, 2] - 1
            x2 = w - boxes[:, 0] - 1
            boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], -1)
            if pointobbs is not None and len(pointobbs):
                pointobbs = NR.pointobb_flip(pointobbs, (h, w))

        if self.device_normalize:
            # raw uint8 BGR out, padded with the rounded mean pixel so
            # that the pad normalizes to ~0 on the card (as the host
            # path's zero pad after normalize)
            pad_val = np.round(self.mean[::-1] if self.to_rgb
                               else self.mean).astype(np.uint8)
            padded = np.broadcast_to(
                pad_val, (size, size, img.shape[-1])).copy()
            padded[:h, :w] = img
        else:
            img = normalize_image(img, self.mean, self.std, self.to_rgb)
            padded = np.zeros((size, size, img.shape[-1]), np.float32)
            padded[:h, :w] = img

        g = self.max_gt
        n = min(len(boxes), g)
        out_boxes = np.zeros((g, 4), np.float32)
        out_boxes[:n] = boxes[:n]
        out_labels = np.zeros((g,), np.int32)
        out_labels[:n] = anns["labels"][:n]
        out_valid = np.zeros((g,), bool)
        out_valid[:n] = True

        sample = dict(imgs=padded, gt_boxes=out_boxes, gt_labels=out_labels,
                      gt_valid=out_valid,
                      img_shapes=np.asarray([h, w], np.float32))

        if self.with_rbox:
            # a patch whose every annotation was ignored has no
            # pointobbs: it still gets the zero rbox slot, or a mixed
            # batch would not collate
            nr = n if (pointobbs is not None and len(pointobbs)) else 0
            p = _np_best_point_sort(pointobbs[:nr]) if nr else \
                np.zeros((0, 8), np.float32)
            d = {"thetaobb": 5, "pointobb": 8, "hobb": 5}[self.rbox_encode]
            out_r = np.zeros((g, d), np.float32)
            if nr:
                if self.rbox_encode == "pointobb":
                    out_r[:nr] = p
                elif self.rbox_encode == "thetaobb":
                    out_r[:nr] = NR.pointobb2thetaobb(p)
                else:
                    out_r[:nr] = NR.pointobb2hobb(p)
            sample["gt_rboxes"] = out_r
        sample.update(self.mask_targets(pointobbs, anns["labels"], n, h, w))
        return sample

    def _albu(self, img, anns):
        """The albu stage: boxes, labels and pointobbs go through it;
        ignored boxes and polygons would not, so a sample with any of
        them raises (the reference's stage does too)."""
        for stale in ("bboxes_ignore", "segmentations"):
            v = anns.get(stale)
            if v is not None and len(v):
                raise ValueError(
                    f"albu pipeline stage does not transform "
                    f"'{stale}' — this sample carries "
                    f"{len(v)} of them; drop the albu stage or "
                    f"use a pipeline without {stale}")
        img, bb, lab, pp = self.albu(img, anns["bboxes"], anns["labels"],
                                     anns.get("pointobbs"))
        anns = dict(anns, bboxes=bb, labels=lab)
        if pp is not None:
            anns["pointobbs"] = pp
        return img, anns

    def mask_targets(self, pointobbs, labels, n, h, w):
        """The mask family's targets of the first ``n`` quads (see the
        class docstring) of an image whose content is h x w."""
        out = {}
        size, g = self.img_size, self.max_gt
        have = bool(n) and pointobbs is not None and len(pointobbs) > 0
        raw = np.asarray(pointobbs[:n]) if have else None
        quads = (raw.astype(np.float32) if have
                 else np.zeros((0, 8), np.float32))
        ms = self.mask_size
        # only the first n slots hold quads: they are quantized alone and
        # the padding stays 0 (the same arrays as quantizing all g)
        if self.with_mask:
            masks = np.zeros((n, ms, ms), np.float32)
            if have and self.mask_type == "centermap":
                masks = pointobbs2centermap(
                    raw, (size, size), mask_size=ms,
                    factor=self.centermap_factor, rate=self.centermap_rate,
                    template_size=self.centermap_template)
            elif have:
                masks = rasterize_polygons(raw, (size, size), ms)
            out["gt_masks"] = self._pad(self._quantize(masks), g)
        if self.with_mask_weight or self.with_reverse_mask_weight:
            weights = np.zeros((n, ms, ms), np.float32)
            if have:
                weights = pointobbs2centermap(
                    raw, (size, size), mask_size=ms,
                    factor=self.centermap_factor,
                    kind="weight" if self.with_mask_weight else "reverse",
                    template_size=self.centermap_template)
            out["gt_mask_weights"] = self._pad(self._quantize(weights), g)
        out_size = size // self.seg_scale
        if self.with_semantic:
            out["gt_semantic"] = pseudo_segmentation(
                quads, labels[:n], (size, size), out_size, valid_hw=(h, w))
        if self.with_heatmap_weight:
            hw_map = heatmap_weight(quads, (size, size), out_size,
                                    factor=self.centermap_factor)
            if self.reverse_heatmap_weight:
                hw_map = 1.0 - hw_map
            out["gt_seg_weights"] = self._quantize(hw_map)
        return out

    @staticmethod
    def _pad(arr, g):
        """[n, ...] -> [g, ...], zero rows after the first n."""
        out = np.zeros((g,) + arr.shape[1:], arr.dtype)
        out[:len(arr)] = arr
        return out

    def _quantize(self, arr):
        """[0, 1] maps as uint8 (round(value * 255)) when the pipeline
        ships raw pixels (device_normalize): 4x less to move to the card;
        the reference's centermaps are uint8 images too.  Float32
        otherwise."""
        if not self.device_normalize:
            return arr
        return np.round(arr * 255.0).astype(np.uint8)


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


def rasterize_polygons(pointobbs, img_hw, mask_size):
    """Binary masks float32 [N, S, S] of quads [N, 8] in the (H, W)
    frame, rasterised at ``mask_size``^2 over the whole image (the
    corners scaled and rounded, then `raster.fill_poly`)."""
    h, w = img_hw
    out = np.zeros((len(pointobbs), mask_size, mask_size), np.float32)
    scale = [mask_size / w, mask_size / h]
    for i, p in enumerate(pointobbs):
        pts = np.round(np.asarray(p).reshape(4, 2) * scale).astype(np.int32)
        fill_poly(out[i], pts, 1.0)
    return out


def collate_batch(samples: list) -> dict:
    """Stack per-sample dicts into [B, ...] numpy arrays (contiguous:
    a flipped sample's negative strides do not survive the stack)."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}
