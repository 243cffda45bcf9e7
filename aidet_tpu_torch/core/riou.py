"""Rotated (polygon) IoU on tensors.

Port of `aidet_tpu/core/riou.py` (`_ensure_ccw`, `_inter_soa_hull`,
`_inter_block`, `quad_areas`, `quad_overlaps`, `thetaobb_overlaps`) in
plain PyTorch: the reference writes it as XLA code, not as a Pallas
kernel.  The intersection of two convex quads is the convex hull of at
most 24 candidate points (the corners of each inside the other and the
16 edge crossings); each pair's candidates are built elementwise, sorted
by angle around their centroid (a stable sort: invalid candidates carry
`_BIG_ANG` and duplicates share an angle) and summed by the shoelace
formula.  The candidate index is the leading axis of every buffer.
The reference's opt-in line-integral formulation
(``AIDET_RIOU_IMPL=integral``) is not ported.

All-pairs overlaps are computed in chunks of rows whose candidate
buffers hold at most `CHUNK_PAIRS` pairs (a batch's 15 classes of 256
x 256 candidates for one image), and leading batch dimensions are
solved together: [..., N, 8] x [..., M, 8] -> [..., N, M].
"""

from __future__ import annotations

import torch

from .rboxes import thetaobb2pointobb

_MAX_V = 24        # candidate vertices of quad & quad (4 + 4 + 16)
_BIG_ANG = 1e9
# the pairs one chunk of the all-pairs overlaps builds candidates for
CHUNK_PAIRS = 15 * 256 * 256


def _ensure_ccw(pts: torch.Tensor) -> torch.Tensor:
    """Quads [..., 4, 2] in one orientation (the corners reversed where
    the shoelace sum is negative)."""
    x, y = pts[..., 0], pts[..., 1]
    area2 = (x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y).sum(-1)
    return torch.where((area2 < 0)[..., None, None], pts.flip(-2), pts)


def _inter_hull(px, py, qx, qy):
    """Intersection areas of oriented quads: px, py [4, *dims] (corner
    axis leading), qx, qy [4, *dims] broadcastable -> [*dims]."""
    pxn, pyn = torch.roll(px, -1, 0), torch.roll(py, -1, 0)
    qxn, qyn = torch.roll(qx, -1, 0), torch.roll(qy, -1, 0)
    shape = torch.broadcast_shapes(px.shape[1:], qx.shape[1:])
    cand_x, cand_y, valid = [], [], []

    def inside(ax, ay, bx, by, bxn, byn):
        """[4, *dims]: each corner a on or inside quad b (all four edge
        crosses >= 0)."""
        cr = ((bxn[None] - bx[None]) * (ay[:, None] - by[None])
              - (byn[None] - by[None]) * (ax[:, None] - bx[None]))
        return (cr >= 0).all(1)

    for ax, ay, ins in ((px, py, inside(px, py, qx, qy, qxn, qyn)),
                        (qx, qy, inside(qx, qy, px, py, pxn, pyn))):
        cand_x.append(ax.expand((4,) + shape))
        cand_y.append(ay.expand((4,) + shape))
        valid.append(ins.expand((4,) + shape))

    # the 16 edge crossings, P's edge i against Q's edge j (i major);
    # the denominator is guarded so no inf or nan enters the buffers
    d1x, d1y = (pxn - px)[:, None], (pyn - py)[:, None]   # [4, 1, ...]
    d2x, d2y = (qxn - qx)[None], (qyn - qy)[None]         # [1, 4, ...]
    denom = d1x * d2y - d1y * d2x
    ok = denom.abs() > 1e-12
    safe = torch.where(ok, denom, torch.ones_like(denom))
    rx, ry = qx[None] - px[:, None], qy[None] - py[:, None]
    t = (rx * d2y - ry * d2x) / safe
    u = (rx * d1y - ry * d1x) / safe
    cross_valid = ok & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    t = t.clamp(0.0, 1.0)
    cand_x.append((px[:, None] + t * d1x).expand((4, 4) + shape)
                  .reshape((16,) + shape))
    cand_y.append((py[:, None] + t * d1y).expand((4, 4) + shape)
                  .reshape((16,) + shape))
    valid.append(cross_valid.expand((4, 4) + shape).reshape((16,) + shape))

    cx = torch.cat(cand_x)                      # [24, *dims]
    cy = torch.cat(cand_y)
    v = torch.cat(valid)
    cnt = v.sum(0)                              # [*dims]
    vf = v.to(cx.dtype)
    denom_c = cnt.clamp(min=1).to(cx.dtype)
    ctr_x = (cx * vf).sum(0) / denom_c
    ctr_y = (cy * vf).sum(0) / denom_c

    # every candidate lies on the intersection's boundary and the
    # centroid inside it, so the angle order walks the polygon
    ang = torch.atan2(cy - ctr_y, cx - ctr_x)
    ang = torch.where(v, ang, torch.full_like(ang, _BIG_ANG))
    order = torch.sort(ang, dim=0, stable=True).indices
    sx = torch.gather(cx, 0, order)
    sy = torch.gather(cy, 0, order)
    idx = torch.arange(_MAX_V, device=cx.device).reshape(
        (_MAX_V,) + (1,) * cnt.dim())
    nxt = torch.where(idx + 1 < cnt[None], idx + 1, 0)
    xn = torch.gather(sx, 0, nxt.expand_as(sx))
    yn = torch.gather(sy, 0, nxt.expand_as(sy))
    term = torch.where(idx < cnt[None], sx * yn - xn * sy,
                       torch.zeros_like(sx))
    area = 0.5 * term.sum(0).abs()
    return torch.where(cnt >= 3, area, torch.zeros_like(area))


def _inter_block(p1, p2):
    """All-pairs intersection areas: p1 [..., N, 4, 2] x p2 [..., M, 4, 2]
    -> [..., N, M]."""
    px = p1[..., 0].movedim(-1, 0)[..., :, None]   # [4, ..., N, 1]
    py = p1[..., 1].movedim(-1, 0)[..., :, None]
    qx = p2[..., 0].movedim(-1, 0)[..., None, :]   # [4, ..., 1, M]
    qy = p2[..., 1].movedim(-1, 0)[..., None, :]
    return _inter_hull(px, py, qx, qy)


def quad_areas(quads: torch.Tensor) -> torch.Tensor:
    """Shoelace areas of [..., 8] quads."""
    pts = quads.reshape(quads.shape[:-1] + (4, 2))
    x, y = pts[..., 0], pts[..., 1]
    return 0.5 * (x * torch.roll(y, -1, -1)
                  - torch.roll(x, -1, -1) * y).sum(-1).abs()


def _rows_per_chunk(n: int, m: int, lead: int) -> int:
    """Rows of the all-pairs problem a chunk takes: all of them when
    n * m <= 64^2 or n <= 32 (the reference's threshold), else as many
    as keep the chunk's pairs within CHUNK_PAIRS, and at least 32."""
    if n * m <= 64 * 64 or n <= 32:
        return n
    return max(32, CHUNK_PAIRS // max(lead * m, 1))


def quad_overlaps(quads1: torch.Tensor, quads2: torch.Tensor,
                  mode: str = "iou", aligned: bool = False) -> torch.Tensor:
    """Polygon IoU of two quad sets.

    quads1 [..., N, 8], quads2 [..., M, 8] (the same leading dims, or
    none on one side); mode 'iou' or 'iof' (over the first's area);
    ``aligned``: N == M and the result is [..., N], else [..., N, M].
    Computed in float32; zero-area quads give 0.  The intersection is
    clamped to each operand's area, as in the reference: a zero-area
    quad's degenerate half-plane tests admit the other's corners.
    """
    if mode not in ("iou", "iof"):
        raise ValueError(f"mode {mode!r}: 'iou' or 'iof'")
    quads1, quads2 = quads1.float(), quads2.float()
    p1 = _ensure_ccw(quads1.reshape(quads1.shape[:-1] + (4, 2)))
    p2 = _ensure_ccw(quads2.reshape(quads2.shape[:-1] + (4, 2)))
    a1, a2 = quad_areas(quads1), quad_areas(quads2)

    if aligned:
        inter = _inter_hull(p1[..., 0].movedim(-1, 0),
                            p1[..., 1].movedim(-1, 0),
                            p2[..., 0].movedim(-1, 0),
                            p2[..., 1].movedim(-1, 0))
    else:
        n, m = p1.shape[-3], p2.shape[-3]
        lead = 1
        for d in torch.broadcast_shapes(p1.shape[:-3], p2.shape[:-3]):
            lead *= d
        rows = _rows_per_chunk(n, m, lead)
        inter = torch.cat([_inter_block(p1[..., s:s + rows, :, :], p2)
                           for s in range(0, n, rows)], -2) \
            if n else _inter_block(p1, p2)
        a1, a2 = a1[..., :, None], a2[..., None, :]

    inter = torch.minimum(inter, torch.minimum(a1, a2))
    denom = a1 + a2 - inter if mode == "iou" else a1.expand_as(inter)
    return torch.where(denom > 1e-10, inter / denom.clamp(min=1e-10),
                       torch.zeros_like(inter))


def thetaobb_overlaps(t1, t2, mode: str = "iou", aligned: bool = False):
    """Rotated IoU of two thetaobb sets [..., 5] through their corners."""
    return quad_overlaps(thetaobb2pointobb(t1), thetaobb2pointobb(t2),
                         mode=mode, aligned=aligned)
