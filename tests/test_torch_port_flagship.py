"""The slice as a whole: the small flagship (RBBoxRCNN, ResNet-18,
64-channel FPN, 256^2 input) of the reference and of the PyTorch port,
with the reference's weights carried over by the weight bridge, on the
same seeded uint8 images, in float32 on the CPU.

Bar (tests/test_parity_demo.py): equal labels and valid, boxes and
rboxes within 1 px, theta within 1e-2, scores within 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_flagship

from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.flagship import build_flagship
from torch_port_helpers import perturb_norms, to_np

IMG = 256


@pytest.fixture(scope="module")
def models():
    jm = _build_flagship(IMG, small=True)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    v = perturb_norms(v, 0)
    sd, unmapped = flax_to_state_dict(v)
    tm = build_flagship(IMG, small=True, device="cpu")
    return jm, v, tm, sd, unmapped


@pytest.fixture(scope="module")
def outputs(models):
    jm, v, tm, sd, _ = models
    tm.load_state_dict(sd, strict=True)
    imgs = np.random.RandomState(0).randint(0, 256, (2, IMG, IMG, 3),
                                            np.uint8)
    shapes = np.asarray([[IMG, IMG], [IMG, 200]], np.float32)
    ref = jax.jit(lambda v, i, s: jm.apply(v, i, s, method="predict"))(
        v, jnp.asarray(imgs), jnp.asarray(shapes))
    got = tm.predict(torch.from_numpy(imgs), torch.from_numpy(shapes))
    feats_ref = jax.jit(lambda v, i: jm.apply(
        v, i, method=lambda m, x: m.extract_feat(x)))(v, jnp.asarray(imgs))
    with torch.no_grad():
        feats = tm.extract_feat(torch.from_numpy(imgs))
    return ({k: np.asarray(x) for k, x in ref.items()},
            {k: to_np(x) for k, x in got.items()}, feats_ref, feats)


def test_bridge_maps_every_leaf(models):
    _, v, tm, sd, unmapped = models
    assert unmapped == []
    n_leaves = len(jax.tree_util.tree_leaves(v))
    assert len(sd) == n_leaves
    want = tm.state_dict()
    assert set(sd) == set(want)
    for k, t in sd.items():
        assert tuple(t.shape) == tuple(want[k].shape), k


def test_features_match(outputs):
    _, _, feats_ref, feats = outputs
    assert len(feats) == 5
    for a, b in zip(feats, feats_ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-4)


def test_output_shapes(outputs):
    ref, got, _, _ = outputs
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    assert got["valid"].sum() > 0


def test_labels_and_valid_equal(outputs):
    ref, got, _, _ = outputs
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])


def test_boxes_within_1px(outputs):
    ref, got, _, _ = outputs
    assert np.abs(got["boxes"] - ref["boxes"]).max() < 1.0


def test_rboxes_within_1px_and_theta(outputs):
    ref, got, _, _ = outputs
    assert np.abs(got["rboxes"][..., :4] - ref["rboxes"][..., :4]).max() < 1.0
    assert np.abs(got["rboxes"][..., 4] - ref["rboxes"][..., 4]).max() < 1e-2


def test_scores_within_1e2(outputs):
    ref, got, _, _ = outputs
    assert np.abs(got["scores"] - ref["scores"]).max() < 1e-2


def test_bfloat16_predict_runs_on_cpu():
    """The full model's dtype at the small model's widths: finite
    fixed-shape outputs; boxes decode in float32 against the float32
    anchors, scores stay in the heads' bfloat16 (as the reference's;
    tests/test_torch_port_bf16_scores.py holds them to it)."""
    tm = build_flagship(128, small=True, device="cpu", dtype=torch.bfloat16)
    imgs = torch.randint(0, 256, (1, 128, 128, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))
    out = tm.predict(imgs, torch.tensor([[128.0, 128.0]]))
    assert out["boxes"].shape == (1, 16, 4)
    assert out["rboxes"].shape == (1, 16, 5)
    for k in ("boxes", "rboxes", "scores"):
        assert out[k].dtype == (torch.bfloat16 if k == "scores"
                                else torch.float32)
        assert torch.isfinite(out[k]).all()


def test_bridge_covers_the_full_flagship():
    """The full configuration (ResNet-50 with the space-to-depth stem,
    256-channel FPN, 1024-wide heads): every leaf of the reference's
    parameter tree maps onto the port's state_dict with its shape
    (shapes from `jax.eval_shape`, so nothing is compiled)."""
    jm = _build_flagship(128)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3), jnp.float32))
    v = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes)
    sd, unmapped = flax_to_state_dict(v)
    assert unmapped == []
    tm = build_flagship(128, device="cpu", dtype=torch.float32)
    want = tm.state_dict()
    assert set(sd) == set(want)
    for k, t in sd.items():
        assert tuple(t.shape) == tuple(want[k].shape), k
    assert tuple(want["backbone.stem_conv.weight"].shape) == (64, 12, 4, 4)
