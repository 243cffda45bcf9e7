"""Small detectors of the reference and of the PyTorch port with the same
weights, shared by tests/test_torch_port_gn.py, test_torch_port_ohem.py,
test_torch_port_soft_nms.py and test_torch_port_tta.py: the small
architecture of tests/test_models_forward.py (ResNet-18, a 64-channel
FPN, 128^2), the reference's variables with seeded norms carried over
by the weight bridge, and a seeded batch of uint8 images and thetaobb
gts.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aidet_tpu.models import build_detector as j_build

from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.core import rboxes as tr
from aidet_tpu_torch.flagship import keep_every_candidate_cfg
from aidet_tpu_torch.models.builder import build_detector
from aidet_tpu_torch.utils.config import Config
from test_models_forward import IMG, _small_cfg
from torch_port_helpers import to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, MAX_NUM = 4, 100
GN = dict(type="GN", num_groups=32)
THETA_HEAD = dict(type="RBBoxHead", num_classes=16, in_channels=64,
                  fc_out_channels=128, encode="thetaobb")


def perturb_all_norms(variables, seed):
    """Seeded scales, biases and statistics for every FrozenBN and
    GroupNorm of flax variables (a GroupNorm's scope names end in
    "bn{i}" or "norm{i}")."""
    rng = np.random.RandomState(seed)

    def walk(tree, name=""):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, k)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
            elif k == "mean" or (k == "bias" and ("bn" in name
                                                  or "norm" in name)):
                out[k] = rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(variables)


def theta_cfg(gn=False, **extra):
    """The small thetaobb RBBoxRCNN (with ``gn`` its ResNet-18 and FPN in
    GroupNorm, the r18_e2e recipe at 64 channels), under a train_cfg
    that keeps every candidate unless ``extra`` sets another."""
    cfg = _small_cfg(rbbox_head=THETA_HEAD)
    if gn:
        cfg["backbone"] = dict(cfg["backbone"], norm_cfg=GN)
        cfg["neck"] = dict(cfg["neck"], norm_cfg=GN)
    cfg["train_cfg"] = dict(
        keep_every_candidate_cfg(IMG, G, MAX_NUM),
        rpn_proposal=dict(nms_pre=200, nms_post=MAX_NUM, max_num=MAX_NUM))
    cfg.update(extra)
    return dict(type="RBBoxRCNN", **cfg)


def theta_batch(seed=6):
    rs = np.random.RandomState(seed)
    t = np.concatenate([rs.uniform(20, IMG - 20, (2, G, 2)),
                        rs.uniform(8, 40, (2, G, 2)),
                        rs.uniform(-1.5, -0.05, (2, G, 1))],
                       -1).astype(np.float32)
    p = to_np(tr.thetaobb2pointobb(torch.from_numpy(t)))
    return dict(
        imgs=rs.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8),
        gt_boxes=np.concatenate([p[..., 0::2].min(-1, keepdims=True),
                                 p[..., 1::2].min(-1, keepdims=True),
                                 p[..., 0::2].max(-1, keepdims=True),
                                 p[..., 1::2].max(-1, keepdims=True)], -1),
        gt_rboxes=t,
        gt_valid=np.asarray([[True] * G, [True] * (G - 1) + [False]]),
        gt_labels=rs.randint(1, 16, (2, G)).astype(np.int32),
        img_shapes=np.asarray([[IMG, IMG], [IMG, IMG - 16]], np.float32))


def pair(cfg, seed=0):
    """(reference module, its variables, the port's model in eval mode
    with the same weights) of the detector config ``cfg``."""
    jm = j_build(cfg)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                         jnp.zeros((1, cfg["img_size"], cfg["img_size"], 3)))
    v = perturb_all_norms(v, 9)
    sd, unmapped = flax_to_state_dict(v)
    assert not unmapped
    tm = build_detector(cfg, device="cpu", train=True)
    tm.load_state_dict(sd, strict=True)
    return jm, v, tm.eval()


def ref_predict(jm, v, batch):
    out = jax.jit(functools.partial(jm.apply, method="predict"))(
        v, jnp.asarray(batch["imgs"]), jnp.asarray(batch["img_shapes"]))
    return {k: np.asarray(x) for k, x in out.items()}


def ref_loss(jm, v, batch):
    out = jax.jit(functools.partial(jm.apply, method="loss"))(
        v, rngs={"sampling": jax.random.PRNGKey(1)},
        **{k: jnp.asarray(x) for k, x in batch.items()})
    return {k: float(x) for k, x in out.items()}


def port_predict(tm, batch):
    return {k: to_np(x) for k, x in tm.predict(
        torch.from_numpy(batch["imgs"]),
        torch.from_numpy(batch["img_shapes"])).items()}


def port_loss(tm, batch):
    return {k: float(x.detach()) for k, x in tm.loss(
        **{k: torch.from_numpy(x) for k, x in batch.items()},
        generator=torch.Generator().manual_seed(0)).items()}


def assert_losses_close(got, ref, rel):
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= rel * abs(ref[k]), (k, got[k], ref[k])
        assert got[k] > 0, k


@functools.lru_cache(maxsize=None)
def reference_tree(path):
    """The shapes of the reference's variables of the config at ``path``
    (relative to the repo)."""
    jm = j_build(dict(Config.fromfile(os.path.join(REPO, path)).model))
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3)))


def assert_bridge_loads(path):
    """The reference's variables of the config at ``path`` (its shapes,
    filled with seeded values) load strictly into the port's build of
    it through `flax_to_state_dict`, nothing unmapped.  Returns (model,
    state_dict)."""
    cfg = Config.fromfile(os.path.join(REPO, path))
    tm = build_detector(dict(cfg.model), train_cfg=cfg.get("train_cfg"),
                        test_cfg=cfg.get("test_cfg"), device="cpu")
    rs = np.random.RandomState(0)
    v = jax.tree.map(lambda s: rs.randn(*s.shape).astype(np.float32),
                     reference_tree(path))
    sd, unmapped = flax_to_state_dict(v, tm)
    assert not unmapped
    tm.load_state_dict(sd, strict=True)
    return tm, sd
