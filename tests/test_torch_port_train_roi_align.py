"""The gradient of the port's multi-level RoIAlign on the CPU, where
`roi_align_forward` runs the plain version and autograd gives its
gradient (the plain version of kernel K2's backward).

- Against `jax.grad` of the TPU kernel `roi_align_pallas` run in
  interpret mode, whose custom_vjp is the linear transpose of the XLA
  RoIAlign (as tests/test_roi_align_pallas.py runs it), in float32:
  atol 1e-5.  The rois include thin ones that the TPU kernel's forward
  bumps to a coarser level; its backward does not bump, and neither
  does the port in either direction.
- `torch.autograd.gradcheck` in float64 on a tiny case with rois
  across the map's edges and outside it.
The CUDA backward kernel is held to this gradient on the card by
tests/test_torch_port_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from aidet_tpu.ops import roi_align_pallas as rap

from aidet_tpu_torch.ops import roi_align
from torch_port_helpers import STRIDES, make_inputs, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)
    monkeypatch.setattr(pl, "pallas_call", patched)


def test_plain_gradient_matches_pallas_vjp(interpret_pallas):
    feats, rois = make_inputs(20, b=2, r=12, c=8, img=128)
    w = np.random.RandomState(20).randn(7, 7, 8).astype(np.float32)
    j_grads = jax.grad(lambda fs: jnp.sum(
        rap.roi_align_pallas(fs, jnp.asarray(rois), 7) * w))(
            [jnp.asarray(f) for f in feats])
    leaves = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = roi_align.roi_align_forward(leaves, torch.from_numpy(rois), 7)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for g, r in zip(grads, j_grads):
        assert g.shape == r.shape
        np.testing.assert_allclose(to_np(g), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("aligned", [True, False])
def test_gradcheck_float64(aligned):
    rs = np.random.RandomState(21)
    feats = [torch.from_numpy(rs.randn(1, 32 // s, 32 // s, 2))
             .requires_grad_() for s in STRIDES]
    rois = torch.tensor([[[2.0, 3.0, 20.0, 17.5],      # inside
                          [-6.0, 25.0, 40.0, 36.0],    # across two edges
                          [0.0, 0.0, 31.0, 31.0],      # the whole map
                          [33.0, 34.0, 50.0, 52.0]]],  # outside
                        dtype=torch.float64)

    def fn(*fs):
        return roi_align.batched_multilevel_roi_align(
            fs, rois, 2, STRIDES, finest_scale=8, aligned=aligned)

    assert fn(*feats).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, feats, eps=1e-6, atol=1e-8)


def test_forward_with_grad_on_cpu_is_plain_and_launches_nothing():
    feats, rois = make_inputs(22, b=2, r=6, c=8, img=128)
    handles = (roi_align.roi_align_kernel, roi_align.roi_align_train_kernel,
               roi_align.roi_align_backward_kernel)
    before = [h.launches for h in handles]
    leaves = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = roi_align.roi_align_forward(leaves, torch.from_numpy(rois))
    got = torch.autograd.grad(out.square().sum(), leaves)
    ref_leaves = [torch.from_numpy(f).requires_grad_() for f in feats]
    ref = roi_align.batched_multilevel_roi_align(ref_leaves,
                                                 torch.from_numpy(rois))
    want = torch.autograd.grad(ref.square().sum(), ref_leaves)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [h.launches for h in handles] == before


def test_backward_kernel_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        roi_align.roi_align_backward_kernel(
            torch.zeros(2, 7, 7, 8), torch.zeros(2, 4),
            torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), [(1, 8, 8, 8)], (4,), 2,
            True)
