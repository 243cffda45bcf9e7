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

K3 (`csrc/roi_align_bandx.cu`) and K4 (`csrc/rroi_align.cu`) are held
to their plain versions at K1's tolerances, and the small
RBBoxRCNNRRoI's predict launches K4 and K1 (K3 under AIDET_ROI_BAND=x)
once per call.
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
    want = dict.fromkeys(chip_smoke.HANDLES, 0)
    want.update(roi_align_train_forward=1, roi_align_backward=1)
    assert out["launches"] == want
    assert out["param_dtype"] == "torch.float32"
    assert out["compute_dtype"] == "torch.bfloat16"


# K3 (`csrc/roi_align_bandx.cu`) is held to K1's plain version, which
# its plain version equals bit for bit (tests/test_torch_port_rroi_ops.py),
# at K1's tolerances; K4 (`csrc/rroi_align.cu`) to its plain version
# `ops/rroi_align.py::batched_rroi_align` alike.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("bump", [False, True])
def test_k3_matches_plain(cuda, dtype, atol, bump):
    feats, rois = make_inputs(10, r=40, c=64)
    tf = [torch.from_numpy(f).to(cuda, dtype) for f in feats]
    tr = torch.from_numpy(rois).to(cuda)
    before = roi_align.roi_align_bandx_kernel.launches
    got = roi_align.roi_align_bandx_forward(tf, tr, 7, bump_to_window=bump)
    torch.cuda.synchronize()
    assert roi_align.roi_align_bandx_kernel.launches == before + 1
    ref = roi_align.batched_multilevel_roi_align(tf, tr, 7,
                                                 bump_to_window=bump)
    assert got.dtype == dtype and got.shape == ref.shape
    np.testing.assert_allclose(to_np(got.float()), to_np(ref.float()),
                               atol=atol)


@pytest.mark.gpu
def test_k3_reads_beyond_its_band(cuda):
    """Tall thin rois on the finest level (no window bump) span more
    than the 48 staged rows, and a 1536^2 pyramid is wider than the
    staged columns: those cells come from global memory."""
    img = 1536
    rng = np.random.RandomState(11)
    feats = [torch.from_numpy(rng.randn(1, img // s, img // s, 16)
                              .astype(np.float32)).to(cuda)
             for s in STRIDES]
    rois = torch.tensor([[[1200., 10., 1240., 400.], [30., 900., 60., 1500.],
                          [1100., 1100., 1500., 1180.]]], device=cuda)
    got = roi_align.roi_align_bandx_forward(feats, rois, 7)
    ref = roi_align.batched_multilevel_roi_align(feats, rois, 7)
    np.testing.assert_allclose(to_np(got), to_np(ref), atol=1e-4)


def rroi_inputs(cuda, dtype, seed=12, b=2, r=24, c=64, img=256):
    rng = np.random.RandomState(seed)
    feats = [torch.from_numpy(rng.randn(b, img // s, img // s, c)
                              .astype(np.float32)).to(cuda, dtype)
             for s in STRIDES]
    rr = np.concatenate([rng.uniform(-20, img + 20, (b, r, 2)),
                         rng.uniform(2, 200, (b, r, 2)),
                         rng.uniform(-np.pi / 2, 0, (b, r, 1))], -1)
    return feats, torch.from_numpy(rr.astype(np.float32)).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("bump", [False, True])
def test_k4_matches_plain(cuda, dtype, atol, bump):
    from aidet_tpu_torch.ops import rroi_align
    feats, rr = rroi_inputs(cuda, dtype)
    before = rroi_align.rroi_align_kernel.launches
    got = rroi_align.rroi_align_forward(feats, rr, 7, bump_to_window=bump)
    torch.cuda.synchronize()
    assert rroi_align.rroi_align_kernel.launches == before + 1
    ref = rroi_align.batched_rroi_align(feats, rr, 7, bump_to_window=bump)
    assert got.dtype == dtype and got.shape == ref.shape
    np.testing.assert_allclose(to_np(got.float()), to_np(ref.float()),
                               atol=atol)


@pytest.mark.gpu
def test_k3_k4_raise_on_what_they_cannot_take(cuda):
    from aidet_tpu_torch.ops import rroi_align
    feats, rr = rroi_inputs(cuda, torch.float32, b=1, r=4)
    with pytest.raises(ValueError, match=r"\[B, R, 5\]"):
        rroi_align.rroi_align_forward(feats, rr[..., :4].contiguous())
    leaves = [f.requires_grad_() for f in feats]
    with pytest.raises(ValueError, match="forward only"):
        rroi_align.rroi_align_forward(leaves, rr)
    boxes = torch.tensor([[[10., 10., 50., 60.]]], device=cuda)
    with pytest.raises(ValueError, match="no backward"):
        roi_align.roi_align_bandx_forward(leaves, boxes)


@pytest.mark.gpu
@pytest.mark.parametrize("band,dtype", [("1", torch.float32),
                                        ("x", torch.float32),
                                        ("x", torch.bfloat16)])
def test_rroi_predict_launches_k4_and_k1_or_k3(cuda, band, dtype,
                                               monkeypatch):
    """K4 once per call; K3 in place of K1 under AIDET_ROI_BAND=x for
    bfloat16 features only, as the reference selects it."""
    from aidet_tpu_torch.ops import rroi_align
    from aidet_tpu_torch.rroi import build_rroi
    monkeypatch.setenv("AIDET_ROI_BAND", band)
    model = build_rroi(256, small=True, device=cuda, dtype=dtype)
    imgs = torch.randint(0, 256, (2, 256, 256, 3), dtype=torch.uint8,
                         device=cuda)
    shapes = torch.full((2, 2), 256.0, device=cuda)
    handles = (roi_align.roi_align_kernel, roi_align.roi_align_bandx_kernel,
               rroi_align.rroi_align_kernel)
    before = [h.launches for h in handles]
    for _ in range(2):
        out = model.predict(imgs, shapes)
    torch.cuda.synchronize()
    bandx = band == "x" and dtype == torch.bfloat16
    assert [h.launches - n for h, n in zip(handles, before)] == \
        [0 if bandx else 2, 2 if bandx else 0, 2]
    assert out["rboxes"].shape == (2, 20, 5)
    assert torch.isfinite(out["rboxes"]).all()
