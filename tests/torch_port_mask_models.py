"""The small mask-family models of the reference and of the PyTorch
port, shared by tests/test_torch_port_centermap.py (CenterMap-Net) and
tests/test_torch_port_maskobb.py (MaskOBB, CenterMapOBB): the small
architecture of tests/test_models_forward.py with the mask (and
semantic) heads, the reference's weights carried over by the weight
bridge, predict and loss of both on the same seeded batch (uint8 images
and targets, as the pipeline ships them), under a train_cfg that keeps
every candidate so that both sides sample the same rois.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aidet_tpu.models import build_detector as j_build

from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.flagship import keep_every_candidate_cfg
from aidet_tpu_torch.models.builder import build_detector
from test_models_forward import IMG, _small_cfg
from torch_port_helpers import perturb_norms, to_np

G, MAX_NUM = 4, 100


def _centermap_cfg(**extra):
    cfg = _small_cfg(
        mask_head=dict(type="CenterMapHead", num_convs=2, in_channels=64,
                       conv_out_channels=64, num_classes=16),
        semantic_head=dict(type="WPSGAHead", in_channels=64, channels=64,
                           num_classes=16))
    cfg.update(extra)
    return cfg


MODELS = dict(
    CenterMapNet=_centermap_cfg,
    CenterMapOBB=lambda: _small_cfg(mask_head=dict(
        type="CenterMapHead", num_convs=2, in_channels=64,
        conv_out_channels=64, num_classes=16)),
    MaskOBB=lambda: _small_cfg(mask_head=dict(
        type="FCNMaskHead", num_convs=2, in_channels=64,
        conv_out_channels=64, num_classes=16)))


def _batch(kind):
    rs = np.random.RandomState(6)
    xy = rs.uniform(8, IMG - 60, (2, G, 2))
    wh = rs.uniform(12, 50, (2, G, 2))
    ms = IMG // 4
    out = dict(
        imgs=rs.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8),
        gt_boxes=np.concatenate([xy, xy + wh], -1).astype(np.float32),
        gt_valid=np.asarray([[True] * G, [True] * (G - 1) + [False]]),
        gt_labels=rs.randint(1, 16, (2, G)).astype(np.int32),
        img_shapes=np.asarray([[IMG, IMG], [IMG, IMG - 16]], np.float32),
        gt_masks=np.round(rs.rand(2, G, ms, ms) * 255).astype(np.uint8))
    if kind != "MaskOBB":
        out["gt_mask_weights"] = np.round(
            rs.rand(2, G, ms, ms) * 255).astype(np.uint8)
    if kind == "CenterMapNet":
        out["gt_semantic"] = rs.randint(0, 16, (2, ms, ms)).astype(np.int32)
        out["gt_semantic"][1, -3:] = 255
        out["gt_seg_weights"] = np.round(
            rs.rand(2, ms, ms) * 255).astype(np.uint8)
    return out


def run_pair(kind, test_cfg=None, loss=True):
    """(kind, reference predict, port predict, reference losses, port
    losses) of the small ``kind`` model, under ``test_cfg`` if given;
    without ``loss`` the losses are None."""
    cfg = MODELS[kind]()
    if test_cfg is not None:
        cfg["test_cfg"] = test_cfg
    cfg["train_cfg"] = dict(
        keep_every_candidate_cfg(IMG, G, MAX_NUM),
        rpn_proposal=dict(nms_pre=200, nms_post=MAX_NUM, max_num=MAX_NUM))
    jm = j_build(dict(type=kind, **cfg))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    v = perturb_norms(v, 7)
    sd, unmapped = flax_to_state_dict(v)
    assert not unmapped
    tm = build_detector(dict(type=kind, **cfg), device="cpu", train=True)
    tm.load_state_dict(sd, strict=True)
    batch = _batch(kind)
    ref_pred = jax.jit(functools.partial(jm.apply, method="predict"))(
        v, jnp.asarray(batch["imgs"]), jnp.asarray(batch["img_shapes"]))
    tm.eval()
    got_pred = tm.predict(torch.from_numpy(batch["imgs"]),
                          torch.from_numpy(batch["img_shapes"]))
    ref_loss = got_loss = None
    if loss:
        ref_loss = {k: float(x) for k, x in jax.jit(functools.partial(
            jm.apply, method="loss"))(
                v, rngs={"sampling": jax.random.PRNGKey(1)},
                **{k: jnp.asarray(x) for k, x in batch.items()}).items()}
        got_loss = {k: float(x) for k, x in tm.loss(
            **{k: torch.from_numpy(x) for k, x in batch.items()},
            generator=torch.Generator().manual_seed(0)).items()}
    return (kind, {k: np.asarray(x) for k, x in ref_pred.items()},
            {k: to_np(x) for k, x in got_pred.items()}, ref_loss, got_loss)


def check_predict(pair):
    kind, ref, got, _, _ = pair
    assert set(got) == set(ref) == {"boxes", "scores", "labels", "valid",
                                    "masks"}
    assert got["masks"].shape == ref["masks"].shape == (2, 20, 28, 28)
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    assert np.abs(got["boxes"] - ref["boxes"]).max() < 1e-2
    assert np.abs(got["scores"] - ref["scores"]).max() < 1e-4
    assert np.abs(got["masks"] - ref["masks"]).max() < 1e-3
    if kind == "MaskOBB":      # sigmoids
        assert got["masks"].min() >= 0 and got["masks"].max() <= 1


def check_loss(pair):
    kind, _, _, ref, got = pair
    want = {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
            "loss_mask"} | ({"loss_seg"} if kind == "CenterMapNet" else set())
    assert set(got) == set(ref) == want
    for k in want:
        assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), (k, got[k], ref[k])
        assert got[k] > 0, k
