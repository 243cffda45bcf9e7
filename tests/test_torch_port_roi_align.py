"""Multi-level RoIAlign of the PyTorch port.

On the CPU: the plain version against the reference's XLA
`batched_multilevel_roi_align` in float32 (atol 1e-5), its level
routing against `map_roi_levels` and the TPU kernels' window bump
(exact), and, with bump_to_window=True, against the TPU kernel
`roi_align_band` run in interpret mode in bfloat16 (atol 0.05: the TPU
kernel rounds its interpolation weights to bfloat16).  Kernel K1 itself
is tested on the card by tests/test_torch_port_kernels.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from aidet_tpu.ops.roi_align_pallas import _prepare

from aidet_tpu_torch.ops import roi_align
from torch_port_helpers import STRIDES, make_inputs, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

j_roi_align = importlib.import_module("aidet_tpu.ops.roi_align")


def test_map_roi_levels():
    _, rois = make_inputs(0)
    flat = rois.reshape(-1, 4)
    np.testing.assert_array_equal(
        to_np(roi_align.map_roi_levels(torch.from_numpy(flat), 4)),
        np.asarray(j_roi_align.map_roi_levels(jnp.asarray(flat), 4)))


@pytest.mark.parametrize("out_size,aligned", [(7, True), (14, True),
                                              (7, False)])
def test_plain_matches_xla_reference(out_size, aligned):
    feats, rois = make_inputs(1)
    got = roi_align.batched_multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
        out_size, STRIDES, aligned=aligned)
    ref = j_roi_align.batched_multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), out_size,
        STRIDES, aligned=aligned)
    assert got.shape == ref.shape
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-5)


def test_bumped_routing_matches_tpu_prepare():
    feats, rois = make_inputs(2)
    jf = [jnp.asarray(f) for f in feats]
    cls_ids = _prepare(jf, jnp.asarray(rois), 7, STRIDES, 2, 56, True,
                       use_small=False)[0]
    got = roi_align.route_rois(torch.from_numpy(rois.reshape(-1, 4)),
                               [f.shape[1:3] for f in feats], STRIDES,
                               bump_to_window=True)
    np.testing.assert_array_equal(to_np(got), np.asarray(cls_ids) // 2)
    plain = roi_align.route_rois(torch.from_numpy(rois.reshape(-1, 4)),
                                 [f.shape[1:3] for f in feats], STRIDES)
    assert (to_np(got) != to_np(plain)).sum() >= 2   # the thin rois


@pytest.fixture()
def band_interpret(monkeypatch):
    """Run the TPU kernel in interpret mode, as
    tests/test_roi_align_pallas.py does."""
    monkeypatch.setenv("AIDET_BAND_INTERPRET", "1")
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)
    monkeypatch.setattr(pl, "pallas_call", patched)


@pytest.mark.parametrize("out_size", [7, 14])
def test_bumped_matches_tpu_band_kernel(band_interpret, out_size):
    from aidet_tpu.ops.roi_align_band import roi_align_band
    feats, rois = make_inputs(3, r=16, c=128)
    rois = np.clip(rois, 0, 255)
    tf = [torch.from_numpy(f).bfloat16() for f in feats]
    jf = [jnp.asarray(f).astype(jnp.bfloat16) for f in feats]
    got = roi_align.roi_align_forward(tf, torch.from_numpy(rois), out_size,
                                      STRIDES, bump_to_window=True)
    assert got.dtype == torch.bfloat16
    ref = roi_align_band(jf, jnp.asarray(rois), out_size, STRIDES)
    np.testing.assert_allclose(to_np(got.float()),
                               np.asarray(ref, np.float32), atol=0.05)


def test_forward_on_cpu_is_the_plain_version():
    feats, rois = make_inputs(4, extreme=False)
    tf = [torch.from_numpy(f) for f in feats]
    before = roi_align.roi_align_kernel.launches
    got = roi_align.roi_align_forward(tf, torch.from_numpy(rois))
    ref = roi_align.batched_multilevel_roi_align(tf, torch.from_numpy(rois))
    assert torch.equal(got, ref)
    assert roi_align.roi_align_kernel.launches == before


def test_kernel_checks_reject_cpu_and_odd_inputs():
    feats, rois = make_inputs(5, b=1, r=4, c=12, extreme=False)
    tf = [torch.from_numpy(f) for f in feats]
    with pytest.raises(ValueError, match="CUDA"):
        roi_align.roi_align_kernel.check(tf, torch.from_numpy(rois),
                                         STRIDES, 7, 2)
