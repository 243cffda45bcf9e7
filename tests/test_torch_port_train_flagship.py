"""The slice as a whole: the small flagship's train step (RBBoxRCNN,
ResNet-18, 64-channel FPN, 128^2 input, 4 gts per image) in the
reference and in the PyTorch port, with the reference's weights
carried over by the weight bridge, on the same seeded batch, on the
CPU.

The train_cfg keeps every candidate (`keep_every_candidate_cfg`), so
both sample the same anchors and rois in the same order although
their random streams differ.  The reference runs its XLA RoIAlign
(its CPU path; the TPU kernel's gradient is held to the port's in
tests/test_torch_port_train_roi_align.py).

Tolerances, float32: each loss within 1e-4 relative, every gradient
leaf within 1e-3 of the leaf's largest magnitude; over 3 SGD steps of
`make_train_step`, the metrics within 1e-4 relative and each
parameter's update within 1e-3 of its largest update.  The 3 steps are
step-locked: the port takes each step from the reference's parameters
and momentum.  Run freely, the two trajectories part at the 1e-3 level
within 3 steps: a ReLU whose input lies within float32 rounding of zero
passes the gradient on one side and not on the other (seen in
layer2_block0 after one step, where float64 agrees with the
reference), and the next step's proposals and losses then differ.  bfloat16
compute with float32 parameters (both sides): the backbone+FPN maps
within 3e-2 of each level's largest magnitude and the two RPN losses
within 1e-2 relative (the reference computes its BCE in bfloat16, the
port in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _build_flagship
from aidet_tpu.parallel import train as j_train

from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.flagship import build_flagship, keep_every_candidate_cfg
from aidet_tpu_torch.parallel import train
from torch_port_helpers import perturb_norms, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

IMG, G, MAX_NUM = 128, 4, 64
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
          "loss_rbbox_cls", "loss_rbbox")
CFG = keep_every_candidate_cfg(IMG, G, MAX_NUM)


def make_batch(seed):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(8, IMG - 60, (2, G, 2))
    wh = rs.uniform(12, 50, (2, G, 2))
    theta = rs.uniform(-1.5, -0.01, (2, G, 1))
    f32 = np.float32
    return dict(
        imgs=rs.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8),
        gt_boxes=np.concatenate([xy, xy + wh], -1).astype(f32),
        gt_rboxes=np.concatenate([xy + wh / 2, wh, theta], -1).astype(f32),
        gt_valid=np.asarray([[True] * G, [True] * (G - 1) + [False]]),
        gt_labels=rs.randint(1, 16, (2, G)).astype(np.int32),
        img_shapes=np.asarray([[IMG, IMG], [IMG, IMG - 16]], f32))


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    jm = _build_flagship(IMG, small=True)
    jm = jm.clone(train_cfg=dict(
        CFG, rpn_proposal=dict(nms_pre=128, nms_post=MAX_NUM,
                               max_num=MAX_NUM)))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    v = perturb_norms(v, 5)
    sd, unmapped = flax_to_state_dict(v)
    assert not unmapped

    def port(dtype=None):
        tm = build_flagship(IMG, small=True, device="cpu", train=True,
                            dtype=dtype, train_cfg=CFG)
        tm.load_state_dict(sd, strict=True)
        return tm
    return jm, v, port


@pytest.fixture(scope="module")
def one_step(models):
    """Losses and gradients of one loss evaluation on both sides."""
    jm, v, port = models
    batch = make_batch(0)

    def loss_fn(params):
        losses = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]},
                          method="loss", rngs={"sampling":
                                               jax.random.PRNGKey(1)},
                          **jax_batch(batch))
        return sum(jax.tree.leaves(losses)), losses

    (_, j_losses), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    ref_grads, _ = flax_to_state_dict({"params": j_grads})
    tm = port()
    losses = tm.loss(**torch_batch(batch),
                     generator=torch.Generator().manual_seed(0))
    names, params = zip(*tm.named_parameters())
    grads = torch.autograd.grad(sum(losses.values()), params,
                                allow_unused=True)
    return (j_losses, ref_grads,
            {k: v.detach() for k, v in losses.items()},
            dict(zip(names, grads)))


@pytest.mark.parametrize("key", LOSSES)
def test_loss_matches_reference(one_step, key):
    j_losses, _, losses, _ = one_step
    assert set(losses) == set(j_losses) == set(LOSSES)
    assert losses[key].dtype == torch.float32
    np.testing.assert_allclose(float(losses[key]), float(j_losses[key]),
                               rtol=1e-4, atol=1e-7)


def test_every_gradient_leaf_matches_reference(one_step):
    _, ref_grads, _, grads = one_step
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        r = to_np(ref_grads[name])
        frozen = name.startswith(("backbone.stem_", "backbone.layer1_"))
        if g is None:
            # no loss reaches it: the frozen stages, and the FPN level
            # whose anchors all lie across the 128^2 image's border
            assert frozen or name.startswith("neck.fpn3"), name
            assert not r.any(), name
            continue
        assert not frozen, name
        scale = max(float(np.abs(r).max()), 1e-12)
        np.testing.assert_allclose(to_np(g) / scale, r / scale, atol=1e-3,
                                   rtol=0, err_msg=name)


STEPS = 3


def to_port(tree, names):
    """A reference parameter tree as tensors in the port's order."""
    sd, _ = flax_to_state_dict({"params": tree})
    return [sd[n].clone() for n in names]


@pytest.fixture(scope="module")
def trajectories(models):
    """3 steps of the reference's `make_train_step` on one batch, and
    the port's step from each of the reference's states (its parameters
    and momentum): a step-locked comparison, so that no step inherits
    the rounding of the earlier ones.  Returns, per step, the
    reference's and the port's metrics, and the parameters before the
    step and after it on both sides (in the port's order)."""
    jm, v, port = models
    batch = make_batch(1)
    optimizer = j_train.build_optimizer(j_train.build_lr_schedule(0.02))
    state = j_train.TrainState(step=jnp.zeros((), jnp.int32),
                               params=v["params"],
                               batch_stats=v["batch_stats"],
                               opt_state=optimizer.init(v["params"]))
    step = j_train.make_train_step(jm, optimizer, donate=False)

    tm = port()
    names, params = zip(*tm.named_parameters())
    opt = train.build_optimizer(train.build_lr_schedule(0.02))
    t_step = train.make_train_step(tm, opt)
    out = []
    for i in range(STEPS):
        before = to_port(state.params, names)
        trace = to_port(optax.tree_utils.tree_get(state.opt_state, "trace"),
                        names)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        t_state = train.TrainState(i, tm, trace)
        t_state, m = t_step(t_state, torch_batch(batch),
                            torch.Generator().manual_seed(i))
        assert t_state.step == i + 1
        state, ref_m = step(state, jax_batch(batch), jax.random.PRNGKey(2))
        out.append(dict(
            ref_metrics={k: float(x) for k, x in ref_m.items()},
            metrics={k: float(x) for k, x in m.items()},
            before=before, ref_after=to_port(state.params, names),
            after=[p.detach().clone() for p in params], names=names))
    return out


@pytest.mark.parametrize("i", range(STEPS))
def test_train_step_metrics_match_reference(trajectories, i):
    ref, got = trajectories[i]["ref_metrics"], trajectories[i]["metrics"]
    assert set(got) == set(ref) == set(LOSSES) | {"loss", "grad_norm"}
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    # the first step's gradient norm exceeds 35: the clip is exercised
    assert trajectories[0]["ref_metrics"]["grad_norm"] > 35


@pytest.mark.parametrize("i", range(STEPS))
def test_parameter_updates_match_reference(trajectories, i):
    t = trajectories[i]
    for name, b, a, r in zip(t["names"], t["before"], t["after"],
                             t["ref_after"]):
        d, d_ref = to_np(a - b), to_np(r - b)
        scale = max(float(np.abs(d_ref).max()), 1e-12)
        np.testing.assert_allclose(d / scale, d_ref / scale, atol=1e-3,
                                   rtol=0, err_msg=name)


def test_frozen_parameters_take_weight_decay_and_warmup_lr(trajectories):
    """The stem gets a zero gradient, so its first update is the weight
    decay alone at the first step's lr (0.02 x 1/3): p1 = p0 (1 - lr0
    wd); the second adds the momentum: p2 = p1 - lr1 wd (p1 + 0.9 p0);
    on both sides."""
    k = trajectories[0]["names"].index("backbone.stem_conv.weight")
    lr0, lr1, wd = 0.02 / 3, train.build_lr_schedule(0.02)(1), 1e-4
    p0 = trajectories[0]["before"][k]
    p1, p2 = trajectories[0]["after"][k], trajectories[1]["after"][k]
    torch.testing.assert_close(p1, p0 * (1 - lr0 * wd), rtol=1e-6, atol=0)
    torch.testing.assert_close(trajectories[1]["before"][k], p1, rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(p2, p1 - lr1 * wd * (p1 + 0.9 * p0),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(trajectories[1]["ref_after"][k], p2,
                               rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def bf16(models):
    """bfloat16 compute with float32 parameters on both sides: the
    reference built with dtype=bfloat16 (flax keeps its params in
    float32), the port's training build with compute_dtype bfloat16."""
    jm, v, port = models
    jb = jm.clone(dtype=jnp.bfloat16)
    batch = make_batch(2)
    ref_feats = jax.jit(lambda v, x: jb.apply(
        v, x, method=lambda m, i: m.extract_feat(i)))(
            v, jnp.asarray(batch["imgs"]))
    ref_losses = jax.jit(lambda v, b: jb.apply(
        v, method="loss", rngs={"sampling": jax.random.PRNGKey(3)}, **b))(
            v, jax_batch(batch))
    tm = port(torch.bfloat16)
    assert tm.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    with torch.no_grad():
        with tm._mixed_precision("cpu"):
            feats = tm.extract_feat(torch.from_numpy(batch["imgs"]))
        losses = tm.loss(**torch_batch(batch),
                         generator=torch.Generator().manual_seed(3))
    return ref_feats, ref_losses, feats, losses


def test_bf16_backbone_and_fpn_match_reference(bf16):
    ref_feats, _, feats, _ = bf16
    assert len(feats) == len(ref_feats) == 5
    for a, b in zip(feats, ref_feats):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        r = np.asarray(b, np.float32)
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(to_np(a.float()) / scale, r / scale,
                                   atol=3e-2, rtol=0)


@pytest.mark.parametrize("key", ["loss_rpn_cls", "loss_rpn_bbox"])
def test_bf16_rpn_losses_match_reference(bf16, key):
    _, ref_losses, _, losses = bf16
    np.testing.assert_allclose(float(losses[key]), float(ref_losses[key]),
                               rtol=1e-2)
    assert all(torch.isfinite(v) for v in losses.values())


def test_sampling_is_reproducible_under_a_seeded_generator():
    """The flagship's own train_cfg samples at random: one seed gives
    one result, another seed another."""
    tm = build_flagship(IMG, small=True, device="cpu", train=True)
    batch = torch_batch(make_batch(3))

    def run(seed):
        with torch.no_grad():
            return tm.loss(**batch,
                           generator=torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    assert all(torch.equal(a[k], b[k]) for k in LOSSES)
    assert any(not torch.equal(a[k], c[k]) for k in LOSSES)


def test_num_samples_beyond_the_candidates_is_refused():
    cfg = dict(CFG, rcnn=dict(num_samples=G + MAX_NUM + 1,
                              pos_fraction=1.0))
    tm = build_flagship(IMG, small=True, device="cpu", train=True,
                        train_cfg=cfg)
    with pytest.raises(ValueError, match="num_samples"):
        with torch.no_grad():
            tm.loss(**torch_batch(make_batch(4)),
                    generator=torch.Generator().manual_seed(0))
