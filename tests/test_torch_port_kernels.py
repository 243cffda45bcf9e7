"""Hand-written kernels of the PyTorch port on the card (marker ``gpu``).

These tests need a CUDA card, nvcc and no JAX; without a card they
skip.  Run them on the machine with the card:

    python -m pytest -m gpu tests/test_torch_port_kernels.py

K1 (`aidet_tpu_torch/csrc/roi_align.cu`) is held to its plain version
`batched_multilevel_roi_align` on the same inputs: atol 1e-4 in float32
(the two sum in different orders) and 0.05 in bfloat16 (the output is
rounded to bfloat16 on both sides, one ulp apart at most).

K2's backward (`csrc/roi_align_backward.cu`) is held to the autograd
gradient of the plain version: max abs error within 1e-5 (float32; the
atomics sum in a varying order) or 1e-2 (bfloat16; both round once)
of each level's largest gradient.  K2 as a whole
(`RoIAlignFunction`) launches one forward and one backward, and one
full-width train step of the flagship launches each once.
"""

import numpy as np
import pytest
import torch

from aidet_tpu_torch.flagship import build_flagship
from aidet_tpu_torch.ops import roi_align
from torch_port_helpers import STRIDES, make_inputs, to_np


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_kernels.py")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("out_size,bump", [(7, False), (14, False),
                                           (7, True)])
def test_k1_matches_plain(cuda, dtype, atol, out_size, bump):
    feats, rois = make_inputs(6, c=64)
    tf = [torch.from_numpy(f).to(cuda, dtype) for f in feats]
    tr = torch.from_numpy(rois).to(cuda)
    before = roi_align.roi_align_kernel.launches
    got = roi_align.roi_align_forward(tf, tr, out_size,
                                      bump_to_window=bump)
    torch.cuda.synchronize()
    assert roi_align.roi_align_kernel.launches == before + 1
    ref = roi_align.batched_multilevel_roi_align(tf, tr, out_size,
                                                 bump_to_window=bump)
    assert got.dtype == dtype and got.shape == ref.shape
    np.testing.assert_allclose(to_np(got.float()), to_np(ref.float()),
                               atol=atol)


@pytest.mark.gpu
def test_k1_raises_on_what_it_cannot_take(cuda):
    feats, rois = make_inputs(7, b=1, r=4, c=12, extreme=False)
    tr = torch.from_numpy(rois).to(cuda)
    with pytest.raises(ValueError, match="multiple"):
        roi_align.roi_align_forward(
            [torch.from_numpy(f).to(cuda, torch.bfloat16) for f in feats], tr)
    feats, rois = make_inputs(7, b=1, r=4, c=16, extreme=False)
    tf = [torch.from_numpy(f).to(cuda) for f in feats]
    with pytest.raises(ValueError, match="contiguous"):
        roi_align.roi_align_forward([f.transpose(1, 2) for f in tf], tr)
    with pytest.raises(TypeError):
        roi_align.roi_align_forward([f.half() for f in tf], tr)
    with pytest.raises(ValueError, match="device"):
        roi_align.roi_align_forward([tf[0].cpu()] + tf[1:], tr)


@pytest.mark.gpu
def test_predict_launches_k1_once_per_call(cuda):
    model = build_flagship(256, small=True, device=cuda)
    imgs = torch.randint(0, 256, (2, 256, 256, 3), dtype=torch.uint8,
                         device=cuda)
    shapes = torch.full((2, 2), 256.0, device=cuda)
    before = roi_align.roi_align_kernel.launches
    for _ in range(2):
        out = model.predict(imgs, shapes)
    assert roi_align.roi_align_kernel.launches == before + 2
    assert out["rboxes"].shape == (2, 16, 5)
    assert torch.isfinite(out["boxes"]).all()


def k2_inputs(cuda, dtype, seed=8, out_size=7):
    feats, rois = make_inputs(seed, c=64)
    tf = [torch.from_numpy(f).to(cuda, dtype) for f in feats]
    tr = torch.from_numpy(rois).to(cuda)
    g = torch.Generator().manual_seed(seed)
    grad_out = torch.randn(tuple(rois.shape[:2]) + (out_size, out_size, 64),
                           generator=g).to(cuda, dtype)
    return tf, tr, grad_out


def plain_grads(feats, rois, grad_out, out_size=7):
    leaves = [f.detach().requires_grad_() for f in feats]
    out = roi_align.batched_multilevel_roi_align(leaves, rois, out_size)
    return torch.autograd.grad(out, leaves, grad_out)


# float32 at 1e-5: at these few rois a cell sums tens of terms; chip_smoke.py
# holds the train step's shapes (thousands of terms a cell) to 1e-4 and
# says why next to its BWD_REL_TOL
K2_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_size", [7, 14])
def test_k2_backward_matches_plain_gradient(cuda, dtype, out_size):
    feats, rois, grad_out = k2_inputs(cuda, dtype, out_size=out_size)
    b, r = rois.shape[:2]
    flat = rois.reshape(-1, 4).contiguous()
    lvls = roi_align.route_rois(flat, [f.shape[1:3] for f in feats],
                                STRIDES)
    bidx = torch.arange(b, dtype=torch.int32,
                        device=cuda).repeat_interleave(r)
    before = roi_align.roi_align_backward_kernel.launches
    got = roi_align.roi_align_backward_kernel(
        grad_out.reshape(b * r, out_size, out_size, -1).contiguous(), flat,
        bidx, lvls, [tuple(f.shape) for f in feats], STRIDES, 2, True)
    torch.cuda.synchronize()
    assert roi_align.roi_align_backward_kernel.launches == before + 1
    ref = plain_grads(feats, rois, grad_out, out_size)
    for g, w in zip(got, ref):
        assert g.dtype == dtype and g.shape == w.shape
        scale = float(w.float().abs().max())
        np.testing.assert_allclose(to_np(g.float()), to_np(w.float()),
                                   atol=K2_TOL[dtype] * scale, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_function_launches_forward_and_backward_once(cuda, dtype):
    feats, rois, grad_out = k2_inputs(cuda, dtype, seed=9)
    leaves = [f.detach().requires_grad_() for f in feats]
    handles = (roi_align.roi_align_kernel, roi_align.roi_align_train_kernel,
               roi_align.roi_align_backward_kernel)
    before = [h.launches for h in handles]
    out = roi_align.roi_align_forward(leaves, rois)
    got = torch.autograd.grad(out, leaves, grad_out)
    torch.cuda.synchronize()
    assert [h.launches - n for h, n in zip(handles, before)] == [0, 1, 1]
    ref_out = roi_align.batched_multilevel_roi_align(feats, rois)
    np.testing.assert_allclose(to_np(out.float()), to_np(ref_out.float()),
                               atol=1e-4 if dtype == torch.float32 else 0.05)
    for g, w in zip(got, plain_grads(feats, rois, grad_out)):
        scale = float(w.float().abs().max())
        np.testing.assert_allclose(to_np(g.float()), to_np(w.float()),
                                   atol=K2_TOL[dtype] * scale, rtol=0)


@pytest.mark.gpu
def test_full_width_train_step_launches_k2_once_each(cuda):
    import chip_smoke
    out = chip_smoke.run_train(device="cuda", steps=1)
    assert out["launches"] == dict(roi_align=0, roi_align_train_forward=1,
                                   roi_align_backward=1)
    assert out["param_dtype"] == "torch.float32"
    assert out["compute_dtype"] == "torch.bfloat16"
