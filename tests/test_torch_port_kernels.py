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
to their plain versions at K1's tolerances (K3 also where its plan is
strained: a hot band, boxes beyond the budget, rois beyond their
band), K3's plan kernel to its twin `bandx_chunks` bit for bit, and
`roi_align_bandx_forward` launches the plan and the reduction with no
torch sort, scan or scatter between them; the small
RBBoxRCNNRRoI's predict launches K4 and K1 (K3 under AIDET_ROI_BAND=x)
once per call.

K4's backward (`csrc/rroi_align_backward.cu`) is held to the autograd
gradient of the plain `batched_rroi_align` at K2's backward's
tolerances, its per-sample plan and its entries per tile to the torch
twins' (tests/roi_kernel_twins.py: its sample points are the plain
version's, bit for bit); K4 as a whole (`RRoIAlignFunction`) launches
one forward and one backward, and one full-width train step of the
RBBoxRCNNRRoI launches K2's and K4's forward and backward once each.
K4's launch shapes: a block per roi at roi counts on either side of
the card's 132 SMs and bins whose plan takes several chunks; and a
backward whose zero blocks (32 tiles each) meet empty tiles beside hot
ones, with a channel slice of 128 that C does not fill.
"""

import numpy as np
import pytest
import torch

from aidet_tpu_torch.flagship import build_flagship
from aidet_tpu_torch.ops import roi_align, rroi_align
from torch_port_helpers import (STRIDES, make_inputs, make_rroi_inputs,
                                to_np)


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



# K3's plan on the card against its twin, and K3 where its plan is
# strained: hundreds of rois in one band, boxes beyond the stage's
# budget, rois that reach beyond their band, one image
def k3_strained(cuda, case, dtype=torch.float32, c=32):
    """Levels [B, H, W, c] and rois [B, R, 4] of one of K3's strained
    cases on the card."""
    rng = np.random.RandomState(13)
    img, b = (1536, 1) if case == "tall" else (512, 2)
    feats = [torch.from_numpy(rng.randn(b, img // s, img // s, c)
                              .astype(np.float32)).to(cuda, dtype)
             for s in STRIDES]
    if case == "hot":       # 400 rois of 8..60 px, first rows in one band
        n = 400
        y = rng.uniform(66, 126, (b, n))
        x = rng.uniform(0, 440, (b, n))
        wh = rng.uniform(8, 60, (b, n, 2))
    elif case == "wide":    # 18 rois a key whose box exceeds the budget
        n = 36
        y = np.tile(rng.uniform(130, 140, n), (b, 1))
        x = rng.uniform(0, 400, (b, n))
        wh = np.stack([rng.uniform(80, 110, (b, n)),
                       rng.uniform(100, 150, (b, n))], -1)
    else:                   # tall and wide rois on a 1536^2 pyramid
        n = 24
        y = rng.uniform(0, 1100, (b, n))
        x = rng.uniform(0, 1400, (b, n))
        wh = np.stack([rng.uniform(4, 120, (b, n)),
                       rng.uniform(200, 420, (b, n))], -1)
    rois = np.stack([x, y, x + wh[..., 0], y + wh[..., 1]], -1)
    return feats, torch.from_numpy(rois.astype(np.float32)).to(cuda)


def k3_routed(feats, rois_b):
    b, r = rois_b.shape[:2]
    rois = rois_b.reshape(b * r, 4).contiguous()
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    lvls = roi_align.route_rois(rois, level_hw, STRIDES).contiguous()
    bidx = (torch.arange(b * r, dtype=torch.int32, device=rois.device)
            // r)
    return rois, lvls, bidx, level_hw


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["hot", "wide", "tall"])
def test_k3_plan_equals_twin(cuda, case):
    """The card's plan (one kernel) gives the twin's order and chunk
    table, bit for bit: start, count, row0 and the staged box, capped
    by the kernel's budget."""
    feats, rois_b = k3_strained(cuda, case)
    rois, lvls, bidx, level_hw = k3_routed(feats, rois_b)
    k3 = roi_align.roi_align_bandx_kernel
    before = (k3.plan_launches, k3.launches)
    plan = k3.plan(rois, bidx, lvls, level_hw, STRIDES, rois_b.shape[0])
    torch.cuda.synchronize()
    assert (k3.plan_launches, k3.launches) == (before[0] + 1, before[1])
    twin = roi_align.bandx_chunks(rois, bidx, lvls, level_hw, STRIDES,
                                  rois_b.shape[0],
                                  stage_cells=k3.stage_cells)
    assert torch.equal(plan.perm.long(), twin.perm)
    assert torch.equal(plan.chunks[:, :7].long(), twin.table())
    full = twin.box[:, 1] * roi_align.bandx_chunks(
        rois, bidx, lvls, level_hw, STRIDES, rois_b.shape[0]).box[:, 3]
    capped = full > twin.box[:, 1] * twin.box[:, 3]
    if case == "wide":
        assert bool(capped.any())   # the budget bites
    if case == "hot":
        assert int(twin.count.max()) == 18


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("case", ["hot", "wide", "tall"])
def test_k3_matches_plain_where_its_plan_is_strained(cuda, dtype, atol,
                                                     case):
    """K3 against K1's plain version (K1's tolerances) with hundreds of
    rois in one band, boxes beyond the budget (their rois read global
    memory) and rois beyond their band, on one image of 1536^2."""
    feats, rois_b = k3_strained(cuda, case, dtype)
    got = roi_align.roi_align_bandx_forward(feats, rois_b, 7)
    ref = roi_align.batched_multilevel_roi_align(feats, rois_b, 7)
    assert got.dtype == dtype and got.shape == ref.shape
    np.testing.assert_allclose(to_np(got.float()), to_np(ref.float()),
                               atol=atol)


@pytest.mark.gpu
def test_k3_launches_its_plan_and_reduction_and_no_torch_sort(cuda):
    """On CUDA tensors `roi_align_bandx_forward` launches the plan and
    the reduction once each, and between the rois and the launches runs
    no torch sort, scan or scatter (the profiler's aten ops)."""
    from torch.profiler import ProfilerActivity, profile
    feats, rois_b = k3_strained(cuda, "hot", torch.bfloat16)
    k3 = roi_align.roi_align_bandx_kernel
    roi_align.roi_align_bandx_forward(feats, rois_b, 7)     # built
    torch.cuda.synchronize()
    before = (k3.plan_launches, k3.launches)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        roi_align.roi_align_bandx_forward(feats, rois_b, 7)
        torch.cuda.synchronize()
    assert (k3.plan_launches, k3.launches) == (before[0] + 1,
                                               before[1] + 1)
    ops = {e.key for e in prof.key_averages()}
    banned = ("sort", "argsort", "cumsum", "cummax", "scatter",
              "scatter_add_", "scatter_reduce", "index_put_", "nonzero")
    assert not [o for o in ops if o.startswith("aten::")
                and o[6:].rstrip("_") in {b.rstrip("_") for b in banned}]


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
    """K3 and K4 raise on what they cannot take; K4 takes features that
    need a gradient (through `RRoIAlignFunction`), K3 does not."""
    feats, rr = rroi_inputs(cuda, torch.float32, b=1, r=4)
    with pytest.raises(ValueError, match=r"\[B, R, 5\]"):
        rroi_align.rroi_align_forward(feats, rr[..., :4].contiguous())
    leaves = [f.requires_grad_() for f in feats]
    assert rroi_align.rroi_align_forward(leaves, rr).requires_grad
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


# K1's window plan and stripes, and K2's tile lists, where the designs
# can break; each against the plain version at the tolerances above
def k1_case(cuda, feats, rois, dtype, out_size=7, ratio=2, aligned=True):
    tf = [torch.from_numpy(f).to(cuda, dtype) for f in feats]
    tr = torch.from_numpy(np.asarray(rois, np.float32)).to(cuda)
    got = roi_align.roi_align_forward(tf, tr, out_size, STRIDES, ratio,
                                      aligned=aligned)
    torch.cuda.synchronize()
    ref = roi_align.batched_multilevel_roi_align(tf, tr, out_size, STRIDES,
                                                 ratio, aligned=aligned)
    assert got.dtype == dtype and got.shape == ref.shape
    np.testing.assert_allclose(to_np(got.float()), to_np(ref.float()),
                               atol=1e-4 if dtype == torch.float32 else 0.05)


K1_EDGE = [[0., 0., 1023., 1023.],      # the whole image: level 3
           [4., 500., 1000., 525.],     # 1:40 across: stripes of columns
           [600., 8., 625., 1000.],     # 1:40 down: many listed rows
           [-60., -40., 90., 70.],      # partly outside the map
           [1100., 1200., 1300., 1500.],   # fully outside it
           [1010., 1015., 1040., 1030.],   # across the last row and column
           [300., 300., 302., 301.]]    # smaller than a cell


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_size,ratio,aligned", [
    (7, 2, True), (7, 3, True), (14, 1, True), (14, 3, True),
    (7, 2, False)])
def test_k1_window_edge_cases(cuda, dtype, out_size, ratio, aligned):
    """C=256 gives the bfloat16 block 16 vectors and tiles of 32 cells:
    the 1:40 rois need several stripes at ratio >= 3."""
    rng = np.random.RandomState(40)
    feats = [rng.randn(2, 1024 // s, 1024 // s, 256).astype(np.float32)
             for s in STRIDES]
    rois = np.stack([K1_EDGE, K1_EDGE[::-1]]).astype(np.float32)
    k1_case(cuda, feats, rois, dtype, out_size, ratio, aligned)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_all_rois_on_one_image(cuda, dtype):
    feats, rois = make_inputs(41, b=1, r=60, c=64)
    k1_case(cuda, feats, rois, dtype)


def k2_case(cuda, dtype, feats, rois, out_size=7, seed=42):
    """K2's backward on levels ``feats`` (numpy) and rois [B, R, 4];
    returns (its gradients, the plain ones, the flat inputs)."""
    tf = [torch.from_numpy(f).to(cuda, dtype) for f in feats]
    tr = torch.from_numpy(np.asarray(rois, np.float32)).to(cuda)
    b, r = tr.shape[:2]
    flat = tr.reshape(-1, 4).contiguous()
    lvls = roi_align.route_rois(flat, [f.shape[1:3] for f in tf], STRIDES)
    bidx = torch.arange(b, dtype=torch.int32,
                        device=cuda).repeat_interleave(r)
    g = torch.randn((b * r, out_size, out_size, tf[0].shape[-1]),
                    generator=torch.Generator().manual_seed(seed))
    g = g.to(cuda, dtype)
    got = roi_align.roi_align_backward_kernel(
        g, flat, bidx, lvls, [tuple(f.shape) for f in tf], STRIDES, 2, True)
    torch.cuda.synchronize()
    ref = plain_grads(tf, tr, g.reshape((b, r) + g.shape[1:]), out_size)
    return got, ref, (g, flat, bidx, lvls, [tuple(f.shape) for f in tf])


def assert_k2_close(got, ref, dtype):
    for a, w in zip(got, ref):
        assert a.dtype == dtype and a.shape == w.shape
        scale = max(float(w.float().abs().max()), 1e-30)
        np.testing.assert_allclose(to_np(a.float()), to_np(w.float()),
                                   atol=K2_TOL[dtype] * scale, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_backward_hot_tile(cuda, dtype):
    """200 rois stacked on one 4x4-cell tile: one list holds nearly all
    entries."""
    rng = np.random.RandomState(43)
    feats = [rng.randn(1, 256 // s, 256 // s, 64).astype(np.float32)
             for s in STRIDES]
    xy = rng.uniform(100.5, 101.5, (200, 2))
    rois = np.concatenate([xy, xy + rng.uniform(2, 6, (200, 2))], -1)[None]
    got, ref, _ = k2_case(cuda, dtype, feats, rois)
    assert_k2_close(got, ref, dtype)
    counts = roi_align.roi_align_backward_kernel.scratch[
        :roi_align.roi_align_backward_kernel.tiles]
    assert int(counts.max()) >= 0.9 * int(counts.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_backward_tile_edges_and_map_edges(cuda, dtype):
    """Rois whose samples straddle 4-cell tile edges, and rois across the
    map's last row and column (clamped corners that coincide); levels 1
    to 3 get no roi."""
    rng = np.random.RandomState(44)
    feats = [rng.randn(2, 256 // s, 256 // s, 32).astype(np.float32)
             for s in STRIDES]
    rois = np.array([[[14., 14., 50., 30.], [230., 240., 262., 270.],
                      [62.5, 31., 66., 97.], [250., 0., 290., 40.]],
                     [[0., 0., 15., 15.], [240., 200., 255., 255.],
                      [-8., 100., 30., 130.], [31.5, 31.5, 33.5, 33.5]]],
                    np.float32)
    got, ref, (_, _, _, lvls, _) = k2_case(cuda, dtype, feats, rois)
    assert set(lvls.tolist()) == {0}
    assert_k2_close(got, ref, dtype)
    for g in got[1:]:
        assert not bool(g.any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_backward_no_rois(cuda, dtype):
    shapes = [(2, 64 // s, 64 // s, 32) for s in STRIDES]
    got = roi_align.roi_align_backward_kernel(
        torch.zeros(0, 7, 7, 32, dtype=dtype, device=cuda),
        torch.zeros(0, 4, device=cuda),
        torch.zeros(0, dtype=torch.int32, device=cuda),
        torch.zeros(0, dtype=torch.int32, device=cuda), shapes, STRIDES, 2,
        True)
    torch.cuda.synchronize()
    for g, shape in zip(got, shapes):
        assert g.dtype == dtype and tuple(g.shape) == shape
        assert not bool(g.any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_backward_twice_and_its_lists(cuda, dtype):
    """Two launches on the same inputs agree within the tolerance (the
    lists' order follows the fill's atomics, so the float32 sums' order
    may differ), and the kernel's entries per tile equal the torch
    twin's (tests/roi_kernel_twins.py)."""
    from roi_kernel_twins import tile_binning
    feats, rois = make_inputs(45, c=64)
    got, ref, args = k2_case(cuda, dtype, feats, rois)
    kernel = roi_align.roi_align_backward_kernel
    counts = kernel.scratch[:kernel.tiles].cpu().long()
    g, flat, bidx, lvls, shapes = args
    twin = tile_binning(flat.cpu(), bidx.cpu(), lvls.cpu(), shapes, STRIDES,
                        7)
    assert torch.equal(counts, twin["counts"])
    again = kernel(g, flat, bidx, lvls, shapes, STRIDES, 2, True)
    torch.cuda.synchronize()
    assert_k2_close(again, got, dtype)
    assert_k2_close(got, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ratio,aligned", [(1, True), (3, True),
                                           (2, False)])
def test_k2_backward_sampling_ratio_and_v1(cuda, dtype, ratio, aligned):
    """Bins of 1 and 9 samples, and the v1 offsets and size clamp: the
    tile lists follow each bin's sample grid."""
    feats, rois, grad_out = k2_inputs(cuda, dtype, seed=46)
    b, r = rois.shape[:2]
    flat = rois.reshape(-1, 4).contiguous()
    lvls = roi_align.route_rois(flat, [f.shape[1:3] for f in feats],
                                STRIDES)
    bidx = torch.arange(b, dtype=torch.int32,
                        device=cuda).repeat_interleave(r)
    got = roi_align.roi_align_backward_kernel(
        grad_out.reshape(b * r, 7, 7, -1).contiguous(), flat, bidx, lvls,
        [tuple(f.shape) for f in feats], STRIDES, ratio, aligned)
    torch.cuda.synchronize()
    leaves = [f.detach().requires_grad_() for f in feats]
    out = roi_align.batched_multilevel_roi_align(
        leaves, rois, 7, STRIDES, ratio, aligned=aligned)
    assert_k2_close(got, torch.autograd.grad(out, leaves, grad_out), dtype)


def k4_backward_case(cuda, dtype, feats, rr, out_size=7, ratio=2,
                     aligned=True, seed=47):
    """K4's backward on levels ``feats`` (numpy) and rotated rois
    [B, R, 5]; returns (its gradients, the plain ones, the flat inputs)."""
    tf = [torch.from_numpy(f).to(cuda, dtype) for f in feats]
    tr = torch.from_numpy(np.asarray(rr, np.float32)).to(cuda)
    b, r = tr.shape[:2]
    flat = tr.reshape(-1, 5).contiguous()
    lvls = rroi_align.route_rrois(flat, [f.shape[1:3] for f in tf], STRIDES)
    bidx = torch.arange(b, dtype=torch.int32,
                        device=cuda).repeat_interleave(r)
    g = torch.randn((b * r, out_size, out_size, tf[0].shape[-1]),
                    generator=torch.Generator().manual_seed(seed))
    g = g.to(cuda, dtype)
    shapes = [tuple(f.shape) for f in tf]
    got = rroi_align.rroi_align_backward_kernel(g, flat, bidx, lvls, shapes,
                                                STRIDES, ratio, aligned)
    torch.cuda.synchronize()
    leaves = [f.detach().requires_grad_() for f in tf]
    out = rroi_align.batched_rroi_align(leaves, tr, out_size, STRIDES, ratio,
                                        aligned=aligned)
    ref = torch.autograd.grad(out, leaves, g.reshape(out.shape))
    return got, ref, (g, flat, bidx, lvls, shapes)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ratio,aligned", [(2, True), (3, True),
                                           (2, False)])
def test_k4_backward_matches_plain_gradient(cuda, dtype, ratio, aligned):
    """Random rotated rois of any theta, and the edge rois of
    `EDGE_RROIS`: turned past pi/2, partly outside the map, across its
    last row and column, smaller than a cell, long and thin."""
    feats, rr = make_rroi_inputs(48, c=64)
    got, ref, _ = k4_backward_case(cuda, dtype, feats, rr, ratio=ratio,
                                   aligned=aligned)
    assert_k2_close(got, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_backward_twice_and_its_lists(cuda, dtype):
    """Two launches agree within the tolerance (the lists' order follows
    the fill's atomics), and the kernel's entries per tile equal the
    torch twin's."""
    from roi_kernel_twins import rotated_tile_binning
    feats, rr = make_rroi_inputs(49, c=64)
    got, ref, args = k4_backward_case(cuda, dtype, feats, rr)
    kernel = rroi_align.rroi_align_backward_kernel
    counts = kernel.scratch[:kernel.tiles].cpu().long()
    g, flat, bidx, lvls, shapes = args
    twin = rotated_tile_binning(flat.cpu(), bidx.cpu(), lvls.cpu(), shapes,
                                STRIDES, 7)
    assert torch.equal(counts, twin["counts"])
    again = kernel(g, flat, bidx, lvls, shapes, STRIDES, 2, True)
    torch.cuda.synchronize()
    assert_k2_close(again, got, dtype)
    assert_k2_close(got, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_backward_hot_tile_and_no_rois(cuda, dtype):
    """150 rotated rois stacked on one spot: one list holds most
    entries; and no rois at all: a zero gradient."""
    rng = np.random.RandomState(50)
    feats = [rng.randn(1, 256 // s, 256 // s, 32).astype(np.float32)
             for s in STRIDES]
    rr = np.concatenate([rng.uniform(100.5, 101.5, (150, 2)),
                         rng.uniform(2, 6, (150, 2)),
                         rng.uniform(-np.pi, np.pi, (150, 1))], -1)[None]
    got, ref, _ = k4_backward_case(cuda, dtype, feats, rr)
    assert_k2_close(got, ref, dtype)
    kernel = rroi_align.rroi_align_backward_kernel
    counts = kernel.scratch[:kernel.tiles]
    assert int(counts.max()) >= 0.5 * int(counts.sum()) > 0
    shapes = [tuple(f.shape) for f in feats]
    empty = kernel(torch.zeros(0, 7, 7, 32, dtype=dtype, device=cuda),
                   torch.zeros(0, 5, device=cuda),
                   torch.zeros(0, dtype=torch.int32, device=cuda),
                   torch.zeros(0, dtype=torch.int32, device=cuda), shapes,
                   STRIDES, 2, True)
    torch.cuda.synchronize()
    for e, shape in zip(empty, shapes):
        assert e.dtype == dtype and tuple(e.shape) == shape
        assert not bool(e.any())


@pytest.mark.gpu
@pytest.mark.parametrize("name,roi_dim", [("roi_align", 4),
                                          ("rroi_align", 5)])
def test_backward_kernels_raise_on_rois_they_cannot_take(cuda, name,
                                                         roi_dim):
    """K2's backward reads 4 floats per roi, K4's 5: rois of another
    width, dtype or layout, and routing of another length, raise before
    a launch."""
    kernel = getattr(roi_align if roi_dim == 4 else rroi_align,
                     f"{name}_backward_kernel")
    shapes = [(1, 64 // s, 64 // s, 32) for s in STRIDES]
    k = 3
    g = torch.zeros(k, 7, 7, 32, device=cuda)
    ints = torch.zeros(k, dtype=torch.int32, device=cuda)
    good = torch.full((k, roi_dim), 8.0, device=cuda)
    bad = [torch.zeros(k, 9 - roi_dim, device=cuda),
           good.double(),
           torch.full((roi_dim, k), 8.0, device=cuda).t()]
    before = kernel.launches
    for rois in bad:
        with pytest.raises(ValueError, match=f"rois must be .*{roi_dim}"):
            kernel(g, rois, ints, ints, shapes, STRIDES, 2, True)
    with pytest.raises(ValueError, match="bidx and lvls"):
        kernel(g, good, ints[:2], ints, shapes, STRIDES, 2, True)
    assert kernel.launches == before
    kernel(g, good, ints, ints, shapes, STRIDES, 2, True)
    assert kernel.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_function_launches_forward_and_backward_once(cuda, dtype):
    feats, rr = rroi_inputs(cuda, dtype, seed=51)
    leaves = [f.detach().requires_grad_() for f in feats]
    handles = (rroi_align.rroi_align_kernel,
               rroi_align.rroi_align_backward_kernel)
    before = [h.launches for h in handles]
    out = rroi_align.rroi_align_forward(leaves, rr)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(51))
    got = torch.autograd.grad(out, leaves, g.to(cuda, dtype))
    torch.cuda.synchronize()
    assert [h.launches - n for h, n in zip(handles, before)] == [1, 1]
    ref_leaves = [f.detach().requires_grad_() for f in feats]
    ref_out = rroi_align.batched_rroi_align(ref_leaves, rr)
    np.testing.assert_allclose(to_np(out.float()), to_np(ref_out.float()),
                               atol=1e-4 if dtype == torch.float32 else 0.05)
    ref = torch.autograd.grad(ref_out, ref_leaves, g.to(cuda, dtype))
    assert_k2_close(got, ref, dtype)


@pytest.mark.gpu
def test_full_width_rroi_train_step_launches_k2_and_k4_once_each(cuda):
    import chip_smoke
    out = chip_smoke.run_rroi_train(device="cuda", steps=1)
    want = dict.fromkeys(chip_smoke.HANDLES, 0)
    want.update(roi_align_train_forward=1, roi_align_backward=1,
                rroi_align=1, rroi_align_backward=1)
    assert out["launches"] == want
    assert out["param_dtype"] == "torch.float32"
    assert out["compute_dtype"] == "torch.bfloat16"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("k,out_size,ratio", [
    (1, 7, 2), (3, 7, 2), (133, 7, 2), (265, 7, 2), (5, 14, 3),
    (4, 32, 2)])
def test_k4_forward_launch_shapes(cuda, dtype, atol, k, out_size, ratio):
    """One block per roi for any K (one SM's worth, more than the
    card's SMs, two waves' worth), and bins planned in several chunks
    of the kernel's 512 samples (14x14 at ratio 3, 32x32 at ratio 2);
    C=160 leaves the last warp's channel vectors part-filled."""
    feats, rr = rroi_inputs(cuda, dtype, seed=13, b=1, r=k, c=160)
    got = rroi_align.rroi_align_forward(feats, rr, out_size,
                                        sampling_ratio=ratio)
    torch.cuda.synchronize()
    ref = rroi_align.batched_rroi_align(feats, rr, out_size,
                                        sampling_ratio=ratio)
    assert got.dtype == dtype and got.shape == ref.shape
    np.testing.assert_allclose(to_np(got.float()), to_np(ref.float()),
                               atol=atol)


@pytest.mark.gpu
def test_k4_backward_plan_equals_twin(cuda):
    """The plan pass's per-sample entries in the work buffer equal the torch
    twin's bit for bit: the same corners and the same float32
    weights."""
    from roi_kernel_twins import rotated_sample_plan
    feats, rr = make_rroi_inputs(52, c=64)
    _, _, (g, flat, bidx, lvls, shapes) = k4_backward_case(
        cuda, torch.float32, feats, rr)
    kernel = rroi_align.rroi_align_backward_kernel
    k, n = flat.shape[0], 7 * 2
    got = kernel.work[:4 * k * n * n].cpu()
    twin = rotated_sample_plan(flat.cpu(), lvls.cpu(),
                               [q[1:3] for q in shapes], STRIDES, 7)
    assert torch.equal(got.view(k, n, n, 4), twin)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_backward_empty_tiles_beside_hot_ones(cuda, dtype):
    """A 512^2 pyramid (2720 tiles, C=160: two 128-channel slices, the
    second part-filled): 85 zero blocks of 32 tiles; 60 rotated rois
    stacked on one spot and 6 scattered leave most tiles empty beside a
    few hot ones, in the same zero blocks.
    Against the plain gradient, and the entries per tile against the
    twin's."""
    from roi_kernel_twins import rotated_tile_binning
    rng = np.random.RandomState(53)
    feats = [rng.randn(2, 512 // s, 512 // s, 160).astype(np.float32)
             for s in STRIDES]
    hot = np.concatenate([rng.uniform(300.5, 301.5, (60, 2)),
                          rng.uniform(2, 8, (60, 2)),
                          rng.uniform(-np.pi, np.pi, (60, 1))], -1)
    spread = np.concatenate([rng.uniform(0, 512, (6, 2)),
                             rng.uniform(8, 400, (6, 2)),
                             rng.uniform(-np.pi, np.pi, (6, 1))], -1)
    rr = np.stack([np.concatenate([hot, spread[:3]]),
                   np.concatenate([spread[3:], hot])[:63]])
    got, ref, (g, flat, bidx, lvls, shapes) = k4_backward_case(
        cuda, dtype, feats, rr)
    assert_k2_close(got, ref, dtype)
    kernel = rroi_align.rroi_align_backward_kernel
    counts = kernel.scratch[:kernel.tiles].cpu().long()
    twin = rotated_tile_binning(flat.cpu(), bidx.cpu(), lvls.cpu(), shapes,
                                STRIDES, 7)
    assert torch.equal(counts, twin["counts"])
    used = int((counts > 0).sum())
    assert kernel.tiles == 2720 and used < 0.2 * kernel.tiles
    assert int(counts.max()) >= 60


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_backward_partial_tiles(cuda, dtype):
    """Levels whose sides are no multiple of the 4-cell tile (a 228^2
    image: 57, 28, 14 and 7 cells): the last tiles of a row or column
    hold fewer cells, whether they get entries or zeros; against the
    plain gradient, and the entries per tile against the twin's."""
    from roi_kernel_twins import rotated_tile_binning
    feats, rr = make_rroi_inputs(54, c=64, img=228, edge=False)
    rr[0, :3] = [[226., 226., 30., 20., 0.4], [114., 226., 200., 8., 0.],
                 [226., 114., 8., 200., 1.2]]
    got, ref, (g, flat, bidx, lvls, shapes) = k4_backward_case(
        cuda, dtype, feats, rr)
    assert [s[1] for s in shapes] == [57, 28, 14, 7]
    assert_k2_close(got, ref, dtype)
    kernel = rroi_align.rroi_align_backward_kernel
    twin = rotated_tile_binning(flat.cpu(), bidx.cpu(), lvls.cpu(), shapes,
                                STRIDES, 7)
    assert torch.equal(kernel.scratch[:kernel.tiles].cpu().long(),
                       twin["counts"])
