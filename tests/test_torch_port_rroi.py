"""The RRoI slice as a whole: the small RBBoxRCNNRRoI (ResNet-18,
64-channel FPN, a pointobb first-stage rbbox head and an rtheta
refinement head, 128^2 input) of the reference and of the PyTorch
port, with the reference's weights carried over by the weight bridge,
on the same 2 seeded uint8 images, in float32 on the CPU.

Bar: equal valid; every valid detection paired with one of the same
image and label whose score is within 1e-4 and box within 1e-2 px
(pairing, as chip_smoke.py's match_detections does, because detections
whose scores tie within the two frameworks' rounding may come out in
either order); the paired first-stage pointobbs (each side's model run
without its refinement head) and the paired refined rboxes' centre and
size within 0.05 px plus 1e-4 of their largest coordinate (random
weights decode boxes thousands of pixels wide, and the two frameworks'
float32 FPN outputs differ by up to 1e-4: the worst seen is 0.037 px
on a 318-px box), the refined theta within 1e-3.

The refined rboxes are compared where the first-stage quad is clear of
a tie in `pointobb2thetaobb` (chip_smoke.py's `rbox_clear_of_ties`):
its smallest candidate rectangle 1e-3 (relative) below the next.
Random weights decode self-intersecting quads whose two smallest
candidates tie; there the two frameworks,
1e-3 px apart on the quad, may pick the other edge (the same rectangle
with theta shifted by pi/2 and w, h swapped), re-crop it rotated by
pi/2, and refine it differently.  At least half of the detections must
be clear of a tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aidet_tpu.models import build_detector

import chip_smoke
from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.rroi import build_rroi
from test_models_forward import IMG, _small_cfg
from torch_port_helpers import perturb_norms, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _reference(refine=True):
    cfg = _small_cfg()
    cfg["rbbox_head"] = dict(type="RBBoxHead", num_classes=16,
                             in_channels=64, fc_out_channels=128,
                             encode="pointobb")
    if not refine:      # the first stage alone
        return build_detector(dict(type="RBBoxRCNN",
                                   rbbox_encode="pointobb", **cfg))
    cfg["rbbox_refine_head"] = dict(type="RBBoxHead", num_classes=16,
                                    in_channels=64, fc_out_channels=128,
                                    encode="rtheta")
    return build_detector(dict(type="RBBoxRCNNRRoI",
                               rbbox_encode="pointobb", **cfg))


@pytest.fixture(scope="module")
def models():
    jm = _reference()
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    v = perturb_norms(v, 0)
    sd, unmapped = flax_to_state_dict(v)
    tm = build_rroi(IMG, small=True, device="cpu")
    return jm, v, tm, sd, unmapped


def test_bridge_maps_the_refine_head(models):
    _, v, tm, sd, unmapped = models
    assert unmapped == []
    assert len(sd) == len(jax.tree_util.tree_leaves(v))
    want = tm.state_dict()
    assert set(sd) == set(want)
    refine = sorted(k for k in sd if k.startswith("rbbox_refine_head."))
    assert refine == sorted(k for k in want
                            if k.startswith("rbbox_refine_head."))
    assert tuple(sd["rbbox_refine_head.fc_reg.weight"].shape) == (80, 128)
    assert tuple(sd["rbbox_head.fc_reg.weight"].shape) == (128, 128)
    for k, t in sd.items():
        assert tuple(t.shape) == tuple(want[k].shape), k


@pytest.fixture(scope="module")
def outputs(models):
    """(reference, port) predict outputs, each with the first stage's
    pointobbs under "quads"."""
    jm, v, tm, sd, _ = models
    tm.load_state_dict(sd, strict=True)
    imgs = np.random.RandomState(0).randint(0, 256, (2, IMG, IMG, 3),
                                            np.uint8)
    shapes = np.asarray([[IMG, IMG], [IMG, 100]], np.float32)
    args = (jnp.asarray(imgs), jnp.asarray(shapes))
    ref = jax.jit(lambda v, i, s: jm.apply(v, i, s, method="predict"))(
        v, *args)
    v1 = {col: {k: t for k, t in tree.items() if k != "_rbbox_refine_head"}
          for col, tree in v.items()}
    j1 = _reference(refine=False)
    ref1 = jax.jit(lambda v, i, s: j1.apply(v, i, s, method="predict"))(
        v1, *args)
    ref = {k: np.array(x) for k, x in ref.items()}
    ref["quads"] = np.array(ref1["rboxes"])
    t_args = (torch.from_numpy(imgs), torch.from_numpy(shapes))
    got = {k: to_np(x) for k, x in tm.predict(*t_args).items()}
    head, tm.rbbox_refine_head = tm.rbbox_refine_head, None
    try:
        got["quads"] = to_np(tm.predict(*t_args)["rboxes"])
    finally:
        tm.rbbox_refine_head = head
    return ref, got


def _pairs(ref, got):
    """(image, port index, reference index) of every valid port
    detection, paired with the reference's detection of the same image
    and label whose score is within 1e-4 and box within 1e-2 px (the
    nearest box), each used once."""
    out = []
    for b in range(got["valid"].shape[0]):
        free = set(np.nonzero(ref["valid"][b])[0].tolist())
        for i in np.nonzero(got["valid"][b])[0]:
            cand = [(np.abs(got["boxes"][b, i] - ref["boxes"][b, j]).max(),
                     j) for j in free
                    if got["labels"][b, i] == ref["labels"][b, j]
                    and abs(got["scores"][b, i] - ref["scores"][b, j]) <= 1e-4]
            cand = [c for c in cand if c[0] <= 1e-2]
            assert cand, f"port detection {i} of image {b} has no partner"
            j = min(cand)[1]
            free.discard(j)
            out.append((b, i, j))
    return out


def test_output_shapes_and_dtypes(outputs):
    ref, got = outputs
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    assert got["rboxes"].shape == (2, 20, 5)
    assert got["quads"].shape == (2, 20, 8)
    assert got["scores"].dtype == np.float32
    assert int(got["valid"].sum()) >= 20


def test_valid_equal(outputs):
    ref, got = outputs
    np.testing.assert_array_equal(got["valid"], ref["valid"])


def test_first_stage_quads_match(outputs):
    ref, got = outputs
    for b, i, j in _pairs(ref, got):
        q = ref["quads"][b, j]
        assert np.abs(got["quads"][b, i] - q).max() \
            <= 0.05 + 1e-4 * np.abs(q).max(), (b, i, j)


def test_refined_rboxes_match_where_the_quad_is_clear_of_a_tie(outputs):
    ref, got = outputs
    pairs = _pairs(ref, got)
    tie_free = to_np(chip_smoke.rbox_clear_of_ties(
        torch.from_numpy(ref["quads"])))
    clear = [(b, i, j) for b, i, j in pairs if tie_free[b, j]]
    assert len(clear) >= len(pairs) / 2, (len(clear), len(pairs))
    for b, i, j in clear:
        g, r = got["rboxes"][b, i], ref["rboxes"][b, j]
        assert np.abs(g[:4] - r[:4]).max() \
            <= 0.05 + 1e-4 * np.abs(r[:4]).max(), (b, i, j, g, r)
        assert abs(g[4] - r[4]) <= 1e-3, (b, i, j, g, r)


def test_refined_rboxes_zero_where_invalid(outputs):
    _, got = outputs
    assert np.isfinite(got["rboxes"]).all()
    assert (got["rboxes"][~got["valid"]] == 0).all()


@pytest.mark.parametrize("encode,top", [("pointobb", "_rbbox_head"),
                                        ("rtheta", "_rbbox_refine_head")])
def test_rbbox_heads_and_decodes(encode, top):
    """The pointobb first-stage head (HBB rois) and the rtheta
    refinement head (rotated rois) with the reference's weights, carried
    over under their top-level names: outputs within 1e-5, decodes
    within 1e-3 px (1e-5 relative) and softmax scores within 1e-5."""
    from aidet_tpu.models.heads import bbox_head as j_bbox_head

    from aidet_tpu_torch.models.heads import bbox_head
    from torch_port_helpers import load_flax
    rs = np.random.RandomState(13)
    crops = rs.randn(12, 7, 7, 64).astype(np.float32)
    jm = j_bbox_head.RBBoxHead(num_classes=16, in_channels=64,
                               fc_out_channels=128, encode=encode)
    tm = bbox_head.RBBoxHead(num_classes=16, in_channels=64,
                             fc_out_channels=128, encode=encode)
    v = jax.jit(jm.init)(jax.random.PRNGKey(13), jnp.asarray(crops))
    ref_cls, ref_reg = jax.jit(jm.apply)(v, jnp.asarray(crops))
    load_flax(tm, v, top)
    with torch.no_grad():
        cls, reg = tm(torch.from_numpy(crops))
    np.testing.assert_allclose(to_np(cls), np.asarray(ref_cls), atol=1e-5)
    np.testing.assert_allclose(to_np(reg), np.asarray(ref_reg), atol=1e-5)
    assert reg.shape == (12, 16 * (8 if encode == "pointobb" else 5))

    xy = rs.uniform(0, 200, (12, 2))
    wh = rs.uniform(4, 60, (12, 2))
    if encode == "pointobb":
        rois = np.concatenate([xy, xy + wh], -1)
    else:
        rois = np.concatenate([xy, wh, rs.uniform(-np.pi / 2, 0, (12, 1))],
                              -1)
    rois = rois.astype(np.float32)
    got = bbox_head.rbbox_head_decode(torch.from_numpy(rois), cls, reg,
                                      encode)
    ref = j_bbox_head.rbbox_head_decode(jnp.asarray(rois), ref_cls, ref_reg,
                                        encode)
    np.testing.assert_allclose(to_np(got[0]), np.asarray(ref[0]), atol=1e-3,
                               rtol=1e-5)
    np.testing.assert_allclose(to_np(got[1]), np.asarray(ref[1]), atol=1e-5)
