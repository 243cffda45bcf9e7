"""Fixed-size random and OHEM sampling over padded candidate sets.

Port of `random_topk_mask`, `topk_mask_by_score`, `random_sample_masks`,
`pseudo_sample_masks`, `FixedSample` and `sample_fixed` from
`aidet_tpu/core/sample.py`, and of the OHEM sampler of its two-stage
detector (`ohem_sample`).  Anchor heads get
boolean masks, RoI heads fixed-length index arrays with validity
masks, so shapes stay fixed.  Leading batch dimensions are written out
([..., N]).

Randomness comes only from the ``generator`` the caller passes (on the
candidates' device); the global RNG is never drawn from.  JAX's
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
