"""Host rasterisation without OpenCV: the polygon fill, the perspective
warp and the contour area that the CenterMap and mask targets use.

The reference's pipeline calls OpenCV (`aidet_tpu/data/centermap.py`,
`aidet_tpu/data/pipeline.py::rasterize_polygons`); the card's machine
has no OpenCV, so the port computes the same functions in numpy:

- `fill_poly`: `cv2.fillPoly` with its default 8-connected edges, after
  OpenCV's `imgproc/drawing.cpp`: every edge drawn as an 8-connected
  line (`LineIterator`, after `clipLine` where it leaves the image),
  then the scanline fill of `FillEdgeCollection` over the edges in
  16-bit fixed point (truncating division as C++'s), each row filled
  from the first pixel at or right of the left edge to the last at or
  left of the right edge.  An edge that leaves the image is rebuilt
  from its clipped end points as `CollectPolyEdges` does (`_edges`),
  so polygons across the border fill OpenCV's pixels too
  (tests/test_torch_port_mask_targets.py holds the fill to OpenCV 5.0
  exactly: polygons inside the image, and seeded rotated rectangles
  and random polygons that leave it, with centres inside or outside
  the image).
- `perspective_transform`: `cv2.getPerspectiveTransform`, the 8x8
  linear system of the four point pairs solved in float64.
- `warp_perspective`: `cv2.warpPerspective` with INTER_LINEAR and a
  zero constant border, as an inverse map in float64 and a bilinear
  gather that reads 0 outside the source.  OpenCV rounds the source
  coordinates to 1/32 of a pixel and its weights to 15 bits; this
  does not, so a value may differ from OpenCV's by the rounding of
  those tables (the tests state the bound).  Only pixels inside
  ``window`` (the quad's bounding box, grown) are computed; the rest
  of the map is exactly 0.
- `contour_area`: `cv2.contourArea` (oriented=False), the shoelace
  formula.
- `rotation_matrix_2d`: `cv2.getRotationMatrix2D`, its centre read as
  float32 (OpenCV's Point2f).
- `warp_affine`: `cv2.warpAffine` of uint8 images as OpenCV 5.0's
  vectorised warp computes it: the inverse map cast to float32, each
  source coordinate m0 * x + (m1 * y + m2) with one fused multiply-add
  in float32, and then INTER_NEAREST the nearest pixel (ties to even),
  or INTER_LINEAR (3 channels) the 2x2 neighbours blended along x and
  then y by fused multiply-adds in float32 and rounded to even.  Past
  the last multiple of 16 columns OpenCV's scalar tail computes the
  linear coordinates as (x * m0 + y * m1) + m2 with one fused
  multiply-add, and so does this (16 is the width of OpenCV's AVX-512
  dispatch: on a CPU where OpenCV takes another, its own result moves
  by a rounding there).  Neighbours outside the source read the
  constant border value or reflect (BORDER_REFLECT_101).
"""

from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C++ integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def clip_line(width: int, height: int, p1, p2):
    """OpenCV's `clipLine` of the segment p1-p2 to the image: (inside,
    p1, p2) with the clipped end points (integers)."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line(img, p1, p2, value):
    """OpenCV's 8-connected `Line` (a `LineIterator` from left to
    right): the pixels of the clipped segment, in closed form."""
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        inside, p1, p2 = clip_line(w, h, p1, p2)
        if not inside:
            return
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:
        (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    i = np.arange(major + 1)
    # the minor offset of step i: the count of steps before it whose
    # error term was negative
    m = (2 * minor * i + major - 1) // (2 * major) if major else i * 0
    if vert:
        img[y1 + sy * i, x1 + m] = value
    else:
        img[y1 + sy * m, x1 + i] = value


def _edges(img, pts, value):
    """The edges of OpenCV's `CollectPolyEdges` (shift 0, no offset,
    8-connected): draws each edge's line and returns the non-horizontal
    edges as [y0, y1, x (16.16 fixed point at y0), dx per row].

    An edge with an end point outside the image takes its x from the
    end points `clip_line` returns, and their y too where those differ
    (else its own y, so a clip to one point makes the edge vertical);
    it keeps its own y range, and its x at its first row is
    extrapolated from the clipped point along the slope of the two."""
    h, w = img.shape[:2]
    edges = []
    n = len(pts)
    x0, y0 = int(pts[n - 1][0]), int(pts[n - 1][1])
    for i in range(n):
        x1, y1 = int(pts[i][0]), int(pts[i][1])
        _line(img, (x0, y0), (x1, y1), value)
        if y0 != y1:
            c0, c1 = (x0, y0), (x1, y1)
            if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h
                    and 0 <= y1 < h):
                _, t0, t1 = clip_line(w, h, c0, c1)
                c0, c1 = ((t0, t1) if t0[1] != t1[1]
                          else ((t0[0], y0), (t1[0], y1)))
            edx = _tdiv((c1[0] - c0[0]) << XY_SHIFT, c1[1] - c0[1])
            if y0 < y1:
                edges.append([y0, y1, (c0[0] << XY_SHIFT)
                              + (y0 - c0[1]) * edx, edx])
            else:
                edges.append([y1, y0, (c1[0] << XY_SHIFT)
                              + (y1 - c1[1]) * edx, edx])
        x0, y0 = x1, y1
    return edges


def _fill_edges(img, edges, value):
    """OpenCV's `FillEdgeCollection` (8-connected: no sub-pixel delta):
    the active-edge scanline fill, spans inclusive at both ends."""
    if len(edges) < 2:
        return
    h, w = img.shape[:2]
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3]
                                  for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << XY_SHIFT):
        return
    pending = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    active: list = []
    y_max = min(y_max, h)
    k = 0
    for y in range(pending[0][0], y_max):
        # drop the edges that end here, and merge those that start here
        # into the active list as OpenCV's walk does: a new edge goes
        # before the first active edge whose x is not below its own
        # (ties between new edges keep their sorted order)
        old = [e for e in active if e[1] != y]
        active, j = [], 0
        while j < len(old) or (k < len(pending) and pending[k][0] == y):
            if j < len(old) and not (k < len(pending) and pending[k][0] == y
                                     and old[j][2] >= pending[k][2]):
                active.append(old[j])
                j += 1
            else:
                active.append(list(pending[k]))
                k += 1
        for a, b in zip(active[0::2], active[1::2]):
            if y >= 0:
                lo, hi = sorted((a[2], b[2]))
                # the pixels whose left corner lies in the span
                x1, x2 = (lo + XY_ONE - 1) >> XY_SHIFT, hi >> XY_SHIFT
                if x1 < w and x2 >= 0:
                    img[y, max(x1, 0):min(x2, w - 1) + 1] = value
            a[2] += a[3]
            b[2] += b[3]
        # OpenCV's bubble sort of the active list by x (stable)
        active.sort(key=lambda e: e[2])


def fill_poly(img: np.ndarray, pts, value) -> np.ndarray:
    """`cv2.fillPoly(img, [pts], value)` for one integer polygon
    ``pts`` [N, 2] (x, y), in place; returns ``img``."""
    pts = np.asarray(pts).reshape(-1, 2).astype(np.int64)
    edges = _edges(img, pts, value)
    _fill_edges(img, edges, value)
    return img


def contour_area(pts) -> float:
    """`cv2.contourArea` of a polygon [N, 2]: the shoelace formula,
    unsigned."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    x, y = p[:, 0], p[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))
                 / 2.0)


def perspective_transform(src, dst) -> np.ndarray:
    """`cv2.getPerspectiveTransform`: the 3x3 homography [float64]
    that maps the 4 points ``src`` onto ``dst`` (each [4, 2], read as
    float32 as OpenCV's Point2f), its last entry 1."""
    src = np.asarray(src, np.float32).astype(np.float64)
    dst = np.asarray(dst, np.float32).astype(np.float64)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        (sx, sy), (dx, dy) = src[i], dst[i]
        a[i, :3] = a[i + 4, 3:6] = sx, sy, 1.0
        a[i, 6:] = -sx * dx, -sy * dx
        a[i + 4, 6:] = -sx * dy, -sy * dy
        b[i], b[i + 4] = dx, dy
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def warp_perspective(src: np.ndarray, m: np.ndarray, out_hw,
                     window=None) -> np.ndarray:
    """`cv2.warpPerspective(src, m, (w, h), INTER_LINEAR,
    BORDER_CONSTANT, 0)` of a float32 map: each output pixel reads the
    source at m^-1 (x, y) (float64), bilinear over its 4 neighbours, a
    neighbour outside the source reading 0.  ``window`` (x0, y0, x1, y1),
    inclusive, limits the pixels computed; the others are 0."""
    h, w = out_hw
    out = np.zeros((h, w), np.float32)
    x0, y0, x1, y1 = (0, 0, w - 1, h - 1) if window is None else window
    x0, y0 = max(int(x0), 0), max(int(y0), 0)
    x1, y1 = min(int(x1), w - 1), min(int(y1), h - 1)
    if x1 < x0 or y1 < y0:
        return out
    inv = np.linalg.inv(m)
    xs = np.arange(x0, x1 + 1, dtype=np.float64)
    ys = np.arange(y0, y1 + 1, dtype=np.float64)[:, None]
    den = inv[2, 0] * xs + inv[2, 1] * ys + inv[2, 2]
    den = np.where(den != 0, 1.0 / np.where(den != 0, den, 1.0), 0.0)
    sx = (inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]) * den
    sy = (inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]) * den
    sh, sw = src.shape
    # far outside the source: no neighbour inside (and no overflow)
    sx = np.clip(sx, -2.0, sw + 1.0)
    sy = np.clip(sy, -2.0, sh + 1.0)
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = sx - fx, sy - fy
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)
    acc = np.zeros(sx.shape, np.float64)
    for dy, wy in ((0, 1.0 - ay), (1, ay)):
        for dx, wx in ((0, 1.0 - ax), (1, ax)):
            cx, cy = ix + dx, iy + dy
            inside = (cx >= 0) & (cx < sw) & (cy >= 0) & (cy < sh)
            v = src[np.clip(cy, 0, sh - 1), np.clip(cx, 0, sw - 1)]
            acc += np.where(inside, v, 0.0) * wx * wy
    out[y0:y1 + 1, x0:x1 + 1] = acc
    return out


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """`cv2.getRotationMatrix2D(center, angle, scale)`: the 2x3 float64
    affine rotating by ``angle`` degrees (counter-clockwise) and scaling
    about ``center`` (x, y), read as float32."""
    cx, cy = (float(np.float32(c)) for c in center)
    angle = angle * (math.pi / 180)
    alpha = math.cos(angle) * scale
    beta = math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(m) -> np.ndarray:
    """`cv2.invertAffineTransform` of a 2x3 affine, in float64."""
    m = np.asarray(m, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    return m.reshape(2, 3)


def _fma32(a, b, c):
    """a * b + c rounded once to float32 (a fused multiply-add: the
    product of two float32 is exact in float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def reflect101(p, n):
    """OpenCV's BORDER_REFLECT_101 index of the integer coordinates p
    along a side of n pixels."""
    if n == 1:
        return np.zeros_like(p)
    p = np.abs(p) % (2 * n - 2)
    return np.where(p >= n, 2 * n - 2 - p, p)


# columns of OpenCV's vectorised linear warp loop (AVX-512, 3 channels)
WARP_VECTOR_COLUMNS = 16


def warp_affine(src: np.ndarray, m, out_hw, nearest: bool = False,
                reflect: bool = False, window=None) -> np.ndarray:
    """`cv2.warpAffine(src, m, (w, h), flags=INTER_LINEAR or
    INTER_NEAREST, borderMode=BORDER_CONSTANT (0) or
    BORDER_REFLECT_101)` of a uint8 image, HxW or HxWx3 (linear: 3
    channels); see the module docstring for its arithmetic.
    ``window`` (x0, y0, x1, y1), inclusive, limits the pixels computed;
    the others are 0."""
    src = np.asarray(src)
    if src.dtype != np.uint8 or not (src.ndim == 2 or nearest and
                                     src.ndim == 3 or src.shape[2:] == (3,)):
        raise ValueError(f"warp_affine takes uint8 HxW (nearest) or HxWx3, "
                         f"not {src.dtype} {src.shape}")
    h, w = out_hw
    out = np.zeros((h, w) + src.shape[2:], np.uint8)
    x0, y0, x1, y1 = (0, 0, w - 1, h - 1) if window is None else window
    x0, y0 = max(int(x0), 0), max(int(y0), 0)
    x1, y1 = min(int(x1), w - 1), min(int(y1), h - 1)
    if x1 < x0 or y1 < y0:
        return out
    f32 = np.float32
    inv = invert_affine(m).astype(f32).reshape(6)
    xs = np.arange(x0, x1 + 1, dtype=f32)[None]
    ys = np.arange(y0, y1 + 1, dtype=f32)[:, None]
    tail = xs >= (w // WARP_VECTOR_COLUMNS) * WARP_VECTOR_COLUMNS
    coords = []
    for m0, m1, m2 in (inv[:3], inv[3:]):
        c = _fma32(m0, xs, (m1 * ys + m2).astype(f32))
        if not nearest:
            c = np.where(tail, (_fma32(xs, m0, (ys * m1).astype(f32))
                                + m2).astype(f32), c)
        coords.append(c)
    sx, sy = coords
    sh, sw = src.shape[:2]
    flat = src.reshape(sh * sw, -1)
    if nearest:
        ix, iy = np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64)
    else:
        ix, iy = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)

    def index(p, n):
        """(source index, inside) of the coordinates p along a side of
        n pixels: reflected, or clipped with the inside mask for the
        constant border."""
        inside = (p >= 0) & (p < n)
        if reflect:
            out = p.copy()
            out[~inside] = reflect101(p[~inside], n)
            return out, None
        return np.clip(p, 0, n - 1), inside

    def tap(row, col):
        """The source's pixels (float64: exact) at the (row, col)
        indices, 0 where the constant border reads."""
        (r, rin), (c, cin) = row, col
        v = flat[r * sw + c].astype(np.float64)
        return v if reflect else np.where((rin & cin)[..., None], v, 0.0)

    if nearest:
        res = tap(index(iy, sh), index(ix, sw))
    else:
        a = (sx - ix.astype(f32)).astype(np.float64)[..., None]
        b = (sy - iy.astype(f32)).astype(np.float64)[..., None]
        rows = index(iy, sh), index(iy + 1, sh)
        cols = index(ix, sw), index(ix + 1, sw)

        def lerp(p, q, t):
            """p + t (q - p), the difference rounded to float32, then one
            fused multiply-add (exact in float64, rounded once)."""
            d = (q - p).astype(f32).astype(np.float64)
            return (t * d + p).astype(f32).astype(np.float64)
        res = lerp(lerp(tap(rows[0], cols[0]), tap(rows[0], cols[1]), a),
                   lerp(tap(rows[1], cols[0]), tap(rows[1], cols[1]), a), b)
        res = np.clip(np.rint(res), 0, 255)
    out[y0:y1 + 1, x0:x1 + 1] = res.astype(np.uint8).reshape(
        res.shape[:2] + src.shape[2:])
    return out
