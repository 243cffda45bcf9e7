"""CenterMap soft targets and weight maps, synthesised from the OBB
annotations on the host.

Port of `aidet_tpu/data/centermap.py` (the templates :24-61,
`pointobb2pseudomask` :64-86, `pointobbs2centermap` :89-115,
`pseudo_segmentation` :118-156, `heatmap_weight` :159-180) without
OpenCV (`data.raster`):

- `cv2.getPerspectiveTransform` is `raster.perspective_transform` (the
  8x8 system in float64) and `cv2.warpPerspective` (INTER_LINEAR, zero
  border) is `raster.warp_perspective` (an inverse map in float64, a
  bilinear gather), computed only inside the quad's bounding box grown
  by 2 pixels, and by the template's pixels per map pixel where a quad
  is larger than the template: outside it the source lies beyond the
  template's border and the map is exactly 0, as OpenCV's;
- `cv2.contourArea` is the shoelace formula and `cv2.fillPoly`
  `raster.fill_poly`.
"""

from __future__ import annotations

import numpy as np

from .raster import contour_area, fill_poly, perspective_transform, \
    warp_perspective


def generate_centerness_image(size: int = 512, factor: float = 4.0,
                              rate: float = 0.0):
    """Centerness template in [0, 1]: 1 at the centre, 0 at the edges
    (the product of per-axis triangles to the power 1 / factor); values
    below ``rate`` are set to 0."""
    ax = 1.0 - np.abs(np.linspace(-1.0, 1.0, size))
    tmpl = np.outer(ax, ax)
    tmpl = np.power(tmpl, 1.0 / factor).astype(np.float32)
    if rate > 0:
        tmpl = np.where(tmpl >= rate, tmpl, 0.0).astype(np.float32)
    return tmpl


_TEMPLATE_CACHE: dict = {}


def _template(size=512, factor=4.0, rate=0.0, kind="centerness"):
    """kind: 'centerness' | 'weight' (1 - centerness) | 'reverse'."""
    key = (size, factor, rate if kind == "centerness" else 0.0, kind)
    if key not in _TEMPLATE_CACHE:
        if kind == "weight":
            t = 1.0 - generate_centerness_image(size, factor, 0.0)
        elif kind == "reverse":
            t = generate_centerness_image(size, factor, 0.0)
        else:
            t = generate_centerness_image(size, factor, rate)
        _TEMPLATE_CACHE[key] = t.astype(np.float32)
    return _TEMPLATE_CACHE[key]


def pointobb2pseudomask(pointobb, out_hw, template_size: int = 512,
                        factor: float = 4.0, rate: float = 0.0,
                        kind: str = "centerness"):
    """The ``kind`` template warped into one quad ``pointobb`` [8] of an
    (H, W) map: float32 [H, W], 0 outside the quad."""
    tmpl = _template(template_size, factor, rate, kind)
    s = template_size - 1
    src = np.array([[0, 0], [s, 0], [s, s], [0, s]], np.float32)
    dst = np.asarray(pointobb, np.float32).reshape(4, 2)
    m = perspective_transform(src, dst)
    lo, hi = dst.min(0), dst.max(0)
    grow = 2 + int(np.ceil(float((hi - lo).max()) / s))
    window = (int(np.floor(lo[0])) - grow, int(np.floor(lo[1])) - grow,
              int(np.ceil(hi[0])) + grow, int(np.ceil(hi[1])) + grow)
    return warp_perspective(tmpl, m, out_hw, window)


def pointobbs2centermap(pointobbs, out_hw, mask_size: int | None = None,
                        factor: float = 4.0, rate: float = 0.0,
                        kind: str = "centerness",
                        template_size: int = 512):
    """Per-instance maps [N, S, S] (or [N, H, W]) in [0, 1] of quads
    [N, 8] in the (H, W) frame, rasterised at ``mask_size``^2 when
    given (the quads scaled to it)."""
    h, w = out_hw
    if mask_size is not None:
        sx, sy = mask_size / w, mask_size / h
        pointobbs = np.asarray(pointobbs, np.float32).copy()
        pointobbs[:, 0::2] *= sx
        pointobbs[:, 1::2] *= sy
        h = w = mask_size
    out = np.zeros((len(pointobbs), h, w), np.float32)
    for i, p in enumerate(pointobbs):
        out[i] = pointobb2pseudomask(p, (h, w), factor=factor, rate=rate,
                                     kind=kind, template_size=template_size)
    return out


def pseudo_segmentation(pointobbs, labels, img_hw, out_size,
                        valid_hw=None, ignore_label: int = 255):
    """Class-index map int32 [out_size, out_size] painted from quads
    [N, 8] in the (H, W) canvas with their 1-based labels over a 0
    background, larger quads first (smaller ones stay on top); beyond
    the real image extent ``valid_hw`` the map is ``ignore_label``."""
    h, w = img_hw
    seg = np.zeros((out_size, out_size), np.int32)
    if valid_hw is not None:
        vh = max(1, int(round(valid_hw[0] * out_size / h)))
        vw = max(1, int(round(valid_hw[1] * out_size / w)))
        seg[vh:, :] = ignore_label
        seg[:, vw:] = ignore_label
    sy = out_size / h
    sx = out_size / w
    order = np.argsort([-contour_area(
        np.asarray(p, np.float32).reshape(4, 2)) for p in pointobbs]) \
        if len(pointobbs) else []
    for i in order:
        pts = np.round(np.asarray(pointobbs[i], np.float32)
                       .reshape(4, 2) * [sx, sy]).astype(np.int32)
        fill_poly(seg, pts, int(labels[i]))
    return seg


def heatmap_weight(pointobbs, img_hw, out_size, factor: float = 4.0):
    """Scene heatmap weight [out_size, out_size] in [0, 1]: the maximum
    over the quads of the warped centerness template (rate 0)."""
    h, w = img_hw
    out = np.zeros((out_size, out_size), np.float32)
    if not len(pointobbs):
        return out
    quads = np.asarray(pointobbs, np.float32).copy()
    quads[:, 0::2] *= out_size / w
    quads[:, 1::2] *= out_size / h
    for p in quads:
        m = pointobb2pseudomask(p, (out_size, out_size), factor=factor)
        np.maximum(out, m, out=out)
    return out
