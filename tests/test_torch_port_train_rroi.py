"""The RRoI train slice: the rotated RoIAlign's backward (K4's plain
version and its autograd Function) and the small RBBoxRCNNRRoI's train
step (ResNet-18, 64-channel FPN, a thetaobb or pointobb first-stage
rbbox head and an rtheta refinement head, 128^2 input, 4 gts per
image) in the reference and in the PyTorch port, with the reference's
weights carried over by the weight bridge, on the same seeded batch,
in float32 on the CPU.

- The plain rotated backward (the autograd gradient of the port's
  `batched_rroi_align`) against jax.vjp of the reference's XLA
  `batched_rroi_align`, which `rroi_align_pallas._vjp_bwd` returns:
  each level within 1e-5 of its largest gradient.
- `RRoIAlignFunction` on CPU tensors: the plain forward and the plain
  autograd gradient, bit for bit (under torch's deterministic
  algorithms: the plain gradient's scatter-add on the CPU otherwise
  sums in a varying order), and no gradient for the rois.
- The train_cfg keeps every candidate (`keep_every_candidate_cfg`), so
  both sides sample the same anchors and rois in the same order
  although their random streams differ, and the refinement branch takes
  every sampled roi (pos_fraction 1).  Tolerances as for the flagship
  (tests/test_torch_port_train_flagship.py): each of the 8 losses
  within 1e-4 relative; the refinement losses' gradient on every leaf
  they reach (the refinement head, and through the rotated crop's
  backward the FPN and the backbone) within 1e-3 of the leaf's largest
  magnitude; one SGD step of `make_train_step`: its metrics within
  1e-4 relative and each parameter's update within 1e-3 of its largest.
  The refinement losses give the first-stage rbbox head exactly no
  gradient (the stage-1 decode is detached), on both sides.  The
  gradient of all 8 losses is held leaf by leaf through the SGD step's
  updates (batch 1): on batch 0 one input of a ReLU of the bbox head
  lies within the two frameworks' float32 difference of zero (the port
  -6.1e-5 in float32 and float64 alike, the reference +2.8e-5), and the
  reference's side of it moves that head's first FC's gradient by 4e-3
  of its largest.

The first stage's regression layer (`rbbox_head.fc_reg`, the same on
both sides) is set as a trained one would be: its kernel scaled by 0.01
and a fixed bias, a turn of 0.2 rad with small offsets for thetaobb,
for pointobb a parallelogram (each corner moved along its side by 0.2
of the roi's w or h).  With the reference's random initialisation the
stage-1 boxes decode hundreds of pixels off the image, every rotated
crop reads zeros, and the refinement head gets no gradient; and a
generic near-rectangular pointobb quad has two candidate rectangles of
near-equal area in `pointobb2thetaobb`, which the two frameworks, a
rounding apart, may resolve to different rectangles (the ties that
chip_smoke.py's `rbox_clear_of_ties` skips in predict).  The gt
pointobbs are exact rotated rectangles, whose candidates are one
rectangle.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aidet_tpu.models import build_detector
from aidet_tpu.parallel import train as j_train

from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.core.rboxes import thetaobb2pointobb
from aidet_tpu_torch.flagship import keep_every_candidate_cfg
from aidet_tpu_torch.models.detectors import two_stage
from aidet_tpu_torch.ops import rroi_align
from aidet_tpu_torch.parallel import train
from aidet_tpu_torch.rroi import build_rroi
from test_models_forward import IMG, _small_cfg
from torch_port_helpers import (EDGE_RROIS, STRIDES, make_rroi_inputs,
                                perturb_norms, to_np)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

j_rroi_align = importlib.import_module("aidet_tpu.ops.rroi_align")

G, MAX_NUM = 4, 100
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
          "loss_rbbox_cls", "loss_rbbox", "loss_rbbox_refine",
          "loss_rbbox_refine_cls")
REFINE = ("loss_rbbox_refine", "loss_rbbox_refine_cls")
CFG = keep_every_candidate_cfg(IMG, G, MAX_NUM)


@pytest.mark.parametrize("out_size,ratio,aligned", [
    (7, 2, True), (7, 2, False), (5, 3, True)])
def test_plain_backward_matches_jax_vjp(out_size, ratio, aligned):
    feats, rr = make_rroi_inputs(60, c=16)
    g = np.random.RandomState(60).randn(
        *rr.shape[:2], out_size, out_size, 16).astype(np.float32)
    _, vjp = jax.vjp(
        lambda fs: j_rroi_align.batched_rroi_align(
            fs, jnp.asarray(rr), out_size, STRIDES, ratio, aligned=aligned),
        [jnp.asarray(f) for f in feats])
    ref = vjp(jnp.asarray(g))[0]
    leaves = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = rroi_align.batched_rroi_align(leaves, torch.from_numpy(rr),
                                        out_size, STRIDES, ratio,
                                        aligned=aligned)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(to_np(a), b, atol=1e-5 * np.abs(b).max(),
                                   rtol=0)


def test_edge_rrois_cover_the_backward_cases():
    """The edge rois of the inputs above: thetas past +-pi/2, rois partly
    outside the map, w or h below one cell of their level, and rois the
    TPU kernel's forward bumps to a coarser level."""
    rr = torch.tensor(EDGE_RROIS)
    hw = [(256 // s, 256 // s) for s in STRIDES]
    lvls = rroi_align.route_rrois(rr, hw, STRIDES).long()
    bumped = rroi_align.route_rrois(rr, hw, STRIDES, bump_to_window=True)
    stride = torch.tensor(STRIDES, dtype=torch.float32)[lvls]
    assert bool((rr[:, 4].abs() > np.pi / 2).any())
    reach = rr[:, 2:4].max(-1).values / 2
    assert bool(((rr[:, :2] - reach[:, None] < 0)
                 | (rr[:, :2] + reach[:, None] > 256)).any())
    assert bool((rr[:, 2:4].min(-1).values / stride < 1).any())
    assert bool((bumped.long() > lvls).any())


@pytest.fixture()
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def test_function_on_cpu_is_the_plain_version(deterministic):
    feats, rr = make_rroi_inputs(61, c=16)
    flat = torch.from_numpy(rr.reshape(-1, 5))
    lvls = rroi_align.route_rrois(flat, [f.shape[1:3] for f in feats],
                                  STRIDES)
    bidx = torch.arange(rr.shape[0]).repeat_interleave(rr.shape[1])
    leaves = [torch.from_numpy(f).requires_grad_() for f in feats]
    rois = flat.clone().requires_grad_()
    out = rroi_align.RRoIAlignFunction.apply(rois, bidx, lvls, 7, STRIDES, 2,
                                             True, *leaves)
    plain_leaves = [torch.from_numpy(f).requires_grad_() for f in feats]
    ref = rroi_align.rroi_align_plain(plain_leaves, flat, bidx, lvls, 7,
                                      STRIDES)
    assert torch.equal(out, ref)
    g = torch.from_numpy(np.random.RandomState(61).randn(*out.shape)
                         .astype(np.float32))
    got = torch.autograd.grad(out, [rois] + leaves, g, allow_unused=True)
    assert got[0] is None
    for a, b in zip(got[1:], torch.autograd.grad(ref, plain_leaves, g)):
        assert torch.equal(a, b)


def test_forward_entry_takes_gradients_on_cpu():
    """`rroi_align_forward` on CPU tensors that need a gradient: the
    plain version, differentiable (it raised before K4's backward)."""
    feats, rr = make_rroi_inputs(62, b=1, r=8, c=8)
    leaves = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = rroi_align.rroi_align_forward(leaves, torch.from_numpy(rr))
    ref = rroi_align.batched_rroi_align(
        [f.detach() for f in leaves], torch.from_numpy(rr))
    assert torch.equal(out.detach(), ref)
    grads = torch.autograd.grad(out.sum(), leaves)
    assert sum(float(g.abs().sum()) for g in grads) > 0


def make_batch(seed, encode):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(8, IMG - 60, (2, G, 2))
    wh = rs.uniform(12, 50, (2, G, 2))
    theta = rs.uniform(-1.5, -0.01, (2, G, 1))
    f32 = np.float32
    rboxes = np.concatenate([xy + wh / 2, wh, theta], -1).astype(f32)
    if encode == "pointobb":
        rboxes = to_np(thetaobb2pointobb(torch.from_numpy(rboxes)))
    return dict(
        imgs=rs.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8),
        gt_boxes=np.concatenate([xy, xy + wh], -1).astype(f32),
        gt_rboxes=rboxes,
        gt_valid=np.asarray([[True] * G, [True] * (G - 1) + [False]]),
        gt_labels=rs.randint(1, 16, (2, G)).astype(np.int32),
        img_shapes=np.asarray([[IMG, IMG], [IMG, IMG - 16]], f32))


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def reference(encode):
    cfg = _small_cfg()
    for key, enc in (("rbbox_head", encode), ("rbbox_refine_head", "rtheta")):
        cfg[key] = dict(type="RBBoxHead", num_classes=16, in_channels=64,
                        fc_out_channels=128, encode=enc)
    cfg["train_cfg"] = dict(CFG, rpn_proposal=dict(
        nms_pre=200, nms_post=MAX_NUM, max_num=MAX_NUM))
    return build_detector(dict(type="RBBoxRCNNRRoI", rbbox_encode=encode,
                               **cfg))


# the first stage's regression bias per class (see the module docstring)
FIRST_STAGE_BIAS = dict(thetaobb=[0.05, -0.05, 0.1, -0.1, 0.2],
                        pointobb=[0.2, 0.0, 0.0, 0.2, -0.2, 0.0, 0.0, -0.2])


@pytest.fixture(scope="module", params=["thetaobb", "pointobb"])
def models(request):
    encode = request.param
    jm = reference(encode)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    v = perturb_norms(v, 5)
    reg = v["params"]["_rbbox_head"]["fc_reg"]
    reg["kernel"] = reg["kernel"] * np.float32(0.01)
    reg["bias"] = np.tile(np.asarray(FIRST_STAGE_BIAS[encode], np.float32),
                          16)
    sd, unmapped = flax_to_state_dict(v)
    assert not unmapped
    tm = build_rroi(IMG, small=True, device="cpu", train=True, train_cfg=CFG,
                    encode=encode)
    tm.load_state_dict(sd, strict=True)
    return encode, jm, v, tm


@pytest.fixture(scope="module")
def one_step(models):
    """Losses and the gradients of the refinement losses alone, of one
    loss evaluation on both sides."""
    encode, jm, v, tm = models
    batch = make_batch(0, encode)

    def loss_fn(params):
        return jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                        method="loss",
                        rngs={"sampling": jax.random.PRNGKey(1)},
                        **jax_batch(batch))

    @jax.jit
    def ref_fn(params):
        losses, vjp = jax.vjp(loss_fn, params)
        refine = vjp({k: (jnp.ones_like(x) if k in REFINE
                          else jnp.zeros_like(x))
                      for k, x in losses.items()})[0]
        return losses, refine

    j_losses, j_refine = ref_fn(v["params"])
    losses = tm.loss(**torch_batch(batch),
                     generator=torch.Generator().manual_seed(0))
    names, params = zip(*tm.named_parameters())
    refine = torch.autograd.grad(sum(losses[k] for k in REFINE), params,
                                 allow_unused=True)
    return dict(
        ref_losses={k: float(x) for k, x in j_losses.items()},
        losses={k: x.detach() for k, x in losses.items()},
        ref_refine=flax_to_state_dict({"params": j_refine})[0],
        refine=dict(zip(names, refine)))


@pytest.mark.parametrize("key", LOSSES)
def test_loss_matches_reference(one_step, key):
    ref, got = one_step["ref_losses"], one_step["losses"]
    assert set(got) == set(ref) == set(LOSSES)
    assert got[key].dtype == torch.float32
    np.testing.assert_allclose(float(got[key]), ref[key], rtol=1e-4,
                               atol=1e-7)


def assert_leaf_close(g, r, name):
    """A gradient leaf within 1e-3 of the reference leaf's largest
    magnitude; None (no loss reaches it) where the reference's is 0."""
    r = to_np(r)
    if g is None:
        assert not r.any(), name
        return
    scale = max(float(np.abs(r).max()), 1e-12)
    np.testing.assert_allclose(to_np(g) / scale, r / scale, atol=1e-3,
                               rtol=0, err_msg=name)


def test_refine_gradient_leaves_match_reference(one_step):
    """Every leaf that the refinement losses reach (the refinement head,
    and through the rotated crop's backward the FPN and the backbone)
    gets the reference's gradient of those losses."""
    grads, ref = one_step["refine"], one_step["ref_refine"]
    assert set(grads) == set(ref)
    reached = [n for n, g in grads.items() if g is not None and bool(g.any())]
    assert any(n.startswith("rbbox_refine_head.") for n in reached)
    assert any(n.startswith("neck.") for n in reached)
    assert any(n.startswith("backbone.") for n in reached)
    for name, g in grads.items():
        assert_leaf_close(g, ref[name], name)


def test_refine_losses_train_the_refine_head_only(one_step):
    """The refinement losses give the refinement head's fc_reg the
    reference's gradient, and the first-stage rbbox head none: its
    decode is detached (the reference's stop_gradient)."""
    grads, ref = one_step["refine"], one_step["ref_refine"]
    g = grads["rbbox_refine_head.fc_reg.weight"]
    assert g is not None and float(g.abs().sum()) > 0
    assert_leaf_close(g, ref["rbbox_refine_head.fc_reg.weight"], "fc_reg")
    for name in ("rbbox_head.fc_reg.weight", "rbbox_head.fc_reg.bias"):
        assert grads[name] is None or not bool(grads[name].any()), name
        assert not to_np(ref[name]).any(), name


@pytest.fixture(scope="module")
def sgd_step(models):
    """One step of the reference's `make_train_step` and one of the
    port's from the same parameters and zero momentum."""
    encode, jm, v, tm = models
    batch = make_batch(1, encode)
    optimizer = j_train.build_optimizer(j_train.build_lr_schedule(0.02))
    state = j_train.TrainState(step=jnp.zeros((), jnp.int32),
                               params=v["params"],
                               batch_stats=v["batch_stats"],
                               opt_state=optimizer.init(v["params"]))
    step = j_train.make_train_step(jm, optimizer, donate=False)
    state, ref_m = step(state, jax_batch(batch), jax.random.PRNGKey(2))

    names, params = zip(*tm.named_parameters())
    sd, _ = flax_to_state_dict({"params": v["params"]})
    with torch.no_grad():
        for n, p in zip(names, params):
            p.copy_(sd[n])
    before = [p.detach().clone() for p in params]
    opt = train.build_optimizer(train.build_lr_schedule(0.02))
    t_state, m = train.make_train_step(tm, opt)(
        train.create_train_state(tm, opt), torch_batch(batch),
        torch.Generator().manual_seed(0))
    assert t_state.step == 1
    after_ref, _ = flax_to_state_dict({"params": state.params})
    return dict(ref_metrics={k: float(x) for k, x in ref_m.items()},
                metrics={k: float(x) for k, x in m.items()}, names=names,
                before=before, after=[p.detach().clone() for p in params],
                ref_after=[after_ref[n] for n in names])


def test_train_step_metrics_match_reference(sgd_step):
    ref, got = sgd_step["ref_metrics"], sgd_step["metrics"]
    assert set(got) == set(ref) == set(LOSSES) | {"loss", "grad_norm"}
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_parameter_updates_match_reference(sgd_step):
    t = sgd_step
    for name, b, a, r in zip(t["names"], t["before"], t["after"],
                             t["ref_after"]):
        d, d_ref = to_np(a - b), to_np(r - b)
        scale = max(float(np.abs(d_ref).max()), 1e-12)
        np.testing.assert_allclose(d / scale, d_ref / scale, atol=1e-3,
                                   rtol=0, err_msg=name)


# faults planted in the rotated crop's backward: the gradient of the
# crops that the backward is handed loses one value, one bin, one roi
def _lose(index):
    def fault(grad_out):
        grad_out = grad_out.clone()
        grad_out[index] = 0.0
        return grad_out
    return fault


PLANTED = {"one channel of one bin": _lose((5, 3, 3, 7)),
           "one bin": _lose((5, 3, 3)), "one roi": _lose(5)}


def crop_with_faulty_backward(fault):
    """`rroi_align_forward`'s signature, the plain forward, and a
    backward that hands ``fault(grad_out)`` to the plain one."""
    class Faulty(rroi_align.RRoIAlignFunction):
        @staticmethod
        def backward(ctx, grad_out):
            return rroi_align.RRoIAlignFunction.backward(ctx,
                                                         fault(grad_out))

    def crop(feats, rrois_b, out_size=7, featmap_strides=STRIDES,
             sampling_ratio=2, finest_scale=56, aligned=True):
        b, r = rrois_b.shape[:2]
        rrois = rrois_b.detach().reshape(b * r, 5).contiguous()
        lvls = rroi_align.route_rrois(rrois, [f.shape[1:3] for f in feats],
                                      featmap_strides, finest_scale)
        bidx = torch.arange(b).repeat_interleave(r)
        out = Faulty.apply(rrois, bidx, lvls, out_size,
                           tuple(featmap_strides), sampling_ratio, aligned,
                           *feats)
        return out.reshape(b, r, out_size, out_size, -1)
    return crop


@pytest.fixture(scope="module")
def reference_train_steps():
    """chip_smoke.py's rroi_reference_train step on the CPU (small
    RBBoxRCNNRRoI, float32, every candidate kept) and its train_cfg."""
    import chip_smoke
    net = chip_smoke.build_train_model("rroi", 256, "cpu")[0]
    cfg = keep_every_candidate_cfg(
        256, 8, net.train_cfg["rpn_proposal"]["max_num"])
    return chip_smoke, cfg, chip_smoke.train_step_once("cpu", 256, 8, cfg,
                                                       model="rroi")


@pytest.mark.parametrize("fault", list(PLANTED))
def test_reference_train_limits_catch_a_faulty_rotated_backward(
        reference_train_steps, fault, monkeypatch):
    """chip_smoke.py's rroi_reference_train holds the kernels' step to
    the plain versions' on the card at 1e-4 (losses and grad_norm
    relative, the update's relative L2), and the card's to the CPU's at
    2e-3, which bounds the card's float32 drift (1.0996e-3 with and
    without the kernels on the NVIDIA H100 80GB HBM3, 700.00 W).  A
    backward that loses one value of the crops' gradient moves the
    update by 1.24e-3 relative L2 on the CPU: under the 2e-3, and caught
    by the 1e-4; one bin or one roi moves it past both."""
    chip_smoke, cfg, clean = reference_train_steps
    monkeypatch.setattr(two_stage, "rroi_align_forward",
                        crop_with_faulty_backward(PLANTED[fault]))
    faulty = chip_smoke.train_step_once("cpu", 256, 8, cfg, model="rroi")
    reading = chip_smoke.compare_steps(fault, faulty, clean)
    assert reading["update_rel_l2"] > 10 * 1e-4
    with pytest.raises(AssertionError, match="the update differs"):
        chip_smoke.compare_steps(fault, faulty, clean, dict(
            losses_rel=1.0, update_rel_l2=1e-4, leaf_over_largest=1.0))
