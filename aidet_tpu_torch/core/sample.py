"""Fixed-size random and OHEM sampling over padded candidate sets.

Port of `random_topk_mask`, `topk_mask_by_score`, `random_sample_masks`,
`pseudo_sample_masks`, `FixedSample`, `sample_fixed`, and Libra
R-CNN's `instance_balanced_pos_masks`, `iou_balanced_neg_masks` and
`sample_fixed_combined` from `aidet_tpu/core/sample.py`, and of the
OHEM sampler of its two-stage detector (`ohem_sample`).  Anchor heads get
boolean masks, RoI heads fixed-length index arrays with validity
masks, so shapes stay fixed.  Leading batch dimensions are written out
([..., N]).

Randomness comes only from the ``generator`` the caller passes (on the
candidates' device); the global RNG is never drawn from.  In a
data-parallel step each rank samples its own rows of the global batch
from its own generator, seeded from (seed, step, rank)
(`apis.train.step_seed`), so no two ranks draw the same noise.  JAX's
threefry streams cannot be reproduced, so the samplers are held to the
reference by their properties (counts, the positive cap, masks inside
the candidates) and, where every candidate is kept, by equality.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def random_topk_mask(mask, k, generator: torch.Generator):
    """Uniformly select min(k, count) True entries of ``mask`` [..., N]
    (``k`` an int or a [...] tensor) as a boolean mask.

    Entries are ranked by a stable sort of uniform draws (non-candidates
    last), so exactly min(k, count) are selected even where draws tie;
    the reference's bounded top-k threshold (its ``k_max`` path, a TPU
    speed device) may keep more than k on a tie.
    """
    r = torch.rand(mask.shape, generator=generator, device=mask.device)
    score = torch.where(mask, r, r.new_full((), -1.0))
    order = torch.argsort(score, dim=-1, descending=True, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(mask.shape[-1], device=mask.device)
        .expand_as(order))
    if isinstance(k, torch.Tensor):
        k = k[..., None]
    return mask & (rank < k)


def topk_mask_by_score(mask, score, k):
    """The up to ``k`` True entries of ``mask`` [..., N] with the highest
    ``score`` (``k`` an int or a [...] tensor), as a boolean mask: the
    reference's hard-example ranking (OHEMSampler), a stable sort, so
    that ties go to the lower index."""
    s = torch.where(mask, score, score.new_tensor(-float("inf")))
    order = torch.argsort(-s, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(mask.shape[-1], device=mask.device)
        .expand_as(order))
    if isinstance(k, torch.Tensor):
        k = k[..., None]
    return mask & (rank < k)


class SampleMasks(NamedTuple):
    pos: torch.Tensor       # [..., N] bool: selected positives
    neg: torch.Tensor       # [..., N] bool: selected negatives
    num_pos: torch.Tensor   # [...] int
    num_neg: torch.Tensor   # [...] int


def _num_neg(num, num_pos, neg_pos_ub):
    """num - num_pos negatives, capped at neg_pos_ub * max(num_pos, 1)
    when neg_pos_ub >= 0."""
    num_neg = num - num_pos
    if neg_pos_ub >= 0:
        ub = (neg_pos_ub * num_pos.clamp(min=1)).long()
        num_neg = torch.minimum(num_neg, ub)
    return num_neg


def random_sample_masks(assigned, num: int, pos_fraction: float,
                        generator: torch.Generator,
                        neg_pos_ub: float = -1.0) -> SampleMasks:
    """Up to int(num * pos_fraction) positives (assigned > 0) uniformly,
    then num - n_pos negatives (assigned == 0) uniformly, optionally
    capped at neg_pos_ub * n_pos.  Positives are drawn first, then
    negatives, from ``generator``."""
    pos = random_topk_mask(assigned > 0, int(num * pos_fraction),
                           generator)
    num_pos = pos.sum(-1)
    neg = random_topk_mask(assigned == 0,
                           _num_neg(num, num_pos, neg_pos_ub), generator)
    return SampleMasks(pos, neg, num_pos, neg.sum(-1))


def pseudo_sample_masks(assigned) -> SampleMasks:
    """Every positive (assigned > 0) and every negative (assigned == 0)
    of ``assigned`` [..., N], as the reference's PseudoSampler: the
    single-stage heads weigh all anchors."""
    pos = assigned > 0
    neg = assigned == 0
    return SampleMasks(pos, neg, pos.sum(-1), neg.sum(-1))


class FixedSample(NamedTuple):
    """Fixed-length RoI sample (length min(num, N))."""
    inds: torch.Tensor      # [..., num] int64 indices into the candidates
    is_pos: torch.Tensor    # [..., num] bool
    valid: torch.Tensor     # [..., num] bool (False: padding slot)
    gt_inds: torch.Tensor   # [..., num] int64 0-based gt (-1 neg / pad)


def sample_fixed(assigned, num: int, pos_fraction: float,
                 generator: torch.Generator,
                 neg_pos_ub: float = -1.0) -> FixedSample:
    """Fixed-size RoI sampling: the selected positives (in candidate
    order), then the selected negatives, then the other candidates as
    invalid padding slots; the first min(num, N) rows are returned."""
    pos = random_topk_mask(assigned > 0, int(num * pos_fraction),
                           generator)
    neg = random_topk_mask(assigned == 0,
                           _num_neg(num, pos.sum(-1), neg_pos_ub),
                           generator)
    return _pack(pos, neg, assigned, num)


def instance_balanced_pos_masks(assigned, num_pos: int, num_gts: int,
                                generator: torch.Generator):
    """Libra R-CNN's instance-balanced positives (reference :141; parity:
    InstanceBalancedPosSampler): up to max(num_pos // num_gts, 1)
    positives of each gt at random, the shortfall from the other
    positives at random, then at most ``num_pos`` of those at random."""
    n = assigned.shape[-1]
    pos_cand = assigned > 0
    per_gt = max(num_pos // max(num_gts, 1), 1)
    r = torch.rand(assigned.shape, generator=generator,
                   device=assigned.device)
    # rank each positive within its gt's group, in random order
    order = torch.argsort(torch.where(pos_cand, r, r.new_full((), 2.0))
                          + assigned.float() * 4.0, dim=-1, stable=True)
    sorted_assigned = torch.gather(assigned, -1, order)
    idx = torch.arange(n, device=assigned.device).expand_as(order)
    starts = torch.ones_like(pos_cand)
    starts[..., 1:] = sorted_assigned[..., 1:] != sorted_assigned[..., :-1]
    run_start = torch.where(starts, idx, 0).cummax(-1).values
    rank = torch.empty_like(order).scatter_(-1, order, idx - run_start)
    sel = pos_cand & (rank < per_gt)
    sel |= random_topk_mask(pos_cand & ~sel, num_pos - sel.sum(-1),
                            generator)
    r2 = torch.rand(assigned.shape, generator=generator,
                    device=assigned.device)
    return topk_mask_by_score(sel, r2, num_pos)


def iou_balanced_neg_masks(assigned, max_overlaps, num_neg,
                           generator: torch.Generator, floor_thr=-1.0,
                           floor_fraction=0.0, num_bins=3, neg_iou_ub=0.5):
    """Libra R-CNN's IoU-balanced negatives (reference :108; parity:
    IoUBalancedNegSampler): int(num_neg (1 - floor_fraction) / num_bins)
    negatives at random from each of ``num_bins`` equal IoU bins over
    [max(floor_thr, 0), neg_iou_ub), then the shortfall from the other
    negatives at random: at most ``num_neg`` [...] in all."""
    neg_cand = assigned == 0
    floor = max(floor_thr, 0.0)
    per_bin = (num_neg * (1.0 - floor_fraction) / num_bins).long()
    width = (neg_iou_ub - floor) / num_bins
    sel = torch.zeros_like(neg_cand)
    for i in range(num_bins):
        lo, hi = floor + i * width, floor + (i + 1) * width
        in_bin = neg_cand & (max_overlaps >= lo) & (max_overlaps < hi)
        sel |= random_topk_mask(in_bin, torch.minimum(per_bin, num_neg),
                                generator)
    return sel | random_topk_mask(neg_cand & ~sel, num_neg - sel.sum(-1),
                                  generator)


def sample_fixed_combined(assigned, max_overlaps, num: int,
                          pos_fraction: float, generator: torch.Generator,
                          neg_pos_ub: float = -1.0, num_gts: int = 256,
                          floor_thr: float = -1.0,
                          floor_fraction: float = 0.0,
                          num_bins: int = 3) -> FixedSample:
    """Libra R-CNN's fixed-size RoI sample (reference :215; parity:
    CombinedSampler with InstanceBalancedPosSampler and
    IoUBalancedNegSampler, the only pair its configs name), packed as
    `sample_fixed` packs its own."""
    num_pos_max = int(num * pos_fraction)
    pos = instance_balanced_pos_masks(assigned, num_pos_max, num_gts,
                                      generator)
    neg = iou_balanced_neg_masks(
        assigned, max_overlaps, _num_neg(num, pos.sum(-1), neg_pos_ub),
        generator, floor_thr, floor_fraction, num_bins)
    return _pack(pos, neg, assigned, num)


def ohem_sample(assigned, loss, num: int, pos_fraction: float) -> FixedSample:
    """OHEM's fixed-size RoI sample (the reference's two-stage detector,
    two_stage.py:498-540; parity: OHEMSampler): the int(num *
    pos_fraction) positives (assigned > 0) with the highest ``loss``
    [..., N], then the num - n_pos negatives (assigned == 0) with the
    highest, packed as `sample_fixed` packs them."""
    pos = topk_mask_by_score(assigned > 0, loss, int(num * pos_fraction))
    neg = topk_mask_by_score(assigned == 0, loss, num - pos.sum(-1))
    return _pack(pos, neg, assigned, num)


def _pack(pos, neg, assigned, num: int) -> FixedSample:
    """The selected positives (in candidate order), then the selected
    negatives, then the other candidates as invalid padding slots; the
    first min(num, N) rows."""
    n = assigned.shape[-1]
    group = torch.where(pos, 0, torch.where(neg, 1, 2))
    rank = group * n + torch.arange(n, device=assigned.device)
    order = torch.argsort(rank, dim=-1)[..., :num]
    is_pos = torch.gather(pos, -1, order)
    valid = is_pos | torch.gather(neg, -1, order)
    gt = torch.where(is_pos, torch.gather(assigned, -1, order).long() - 1,
                     -1)
    return FixedSample(order, is_pos, valid, gt)
