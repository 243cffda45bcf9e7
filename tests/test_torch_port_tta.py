"""Test-time augmentation of the PyTorch port against the JAX reference
on the CPU.

Bounds (the reference's weights carried over by the weight bridge,
float32):
- `TwoStageDetector.aug_predict` of the small thetaobb RBBoxRCNN
  (tests/torch_port_pairs.py) on 4 variants of one 100x128 image
  (scales 96 and 128, identity and flip, each on the 128^2 canvas):
  the same valid and labels as the reference's `aug_predict`
  (two_stage.py:872), boxes within 1e-2 px, averaged scores within
  1e-5;
- `apis.tta.aug_test_image` of that model with its rbox quads, at the
  scale the reference's static anchors take (the model's img_size)
  with flip: the same merged labels, boxes within 1e-2 px, scores
  within 1e-5, quads within 5e-2 px of the reference's
  `aug_test_image` (random weights decode rboxes hundreds of pixels
  long, whose corners carry a theta's float32 rounding); at a smaller
  scale too, which the reference cannot run (its variant's canvas
  misses its anchors), the port's boxes stay in the original frame;
- `tools/torch_test.py --tta --device cpu` against `tools/test.py --tta
  --n-devices 1` on a small CenterMap-Net config (its conv_logits bias
  0.5, so that the random maps straddle the mask threshold) over 2
  seeded 256^2 PNG patches, `tta = dict(scales=(256,), flip=True)`:
  the same names, merged labels, boxes within 1e-2 px, scores within
  1e-5, and the quads fitted from the masks within 1e-2 px, but for
  minimum-area rectangles that tie on small blobs (OpenCV's minAreaRect
  in the reference, the port's numpy calipers): at most a quarter of
  them, each of the same area within 2% and centre within 1 px.
The gpu-marked case runs chip_smoke's tta_reference phase (the small
GroupNorm thetaobb model's `aug_test_image` on the card against the
CPU).
"""

import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from aidet_tpu_torch.apis.tta import _variant, aug_test_image
from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.models.builder import build_detector
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp

    import aidet_tpu.apis.inference as ref_inference
    from aidet_tpu.apis.tta import aug_test_image as ref_aug_test_image
    from aidet_tpu.utils.config import Config as RefConfig
    from torch_port_pairs import REPO, pair, theta_cfg
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")

T = torch.from_numpy
IMG = 128
PATCH = 256


def image(seed=3, h=100, w=IMG):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


@pytest.fixture(scope="module")
def theta_pair():
    return pair(theta_cfg())


@needs_reference
def test_aug_predict_matches_the_reference(theta_pair):
    jm, v, tm = theta_pair
    img = image()
    parts = [_variant(tm, np.ascontiguousarray(img[:, ::-1] if f else img), s)
             for s in (96, 128) for f in (False, True)]
    imgs, shapes, sfs = (torch.cat(x) for x in zip(*parts))
    flips = torch.tensor([False, True, False, True])
    got = {k: to_np(x) for k, x in tm.aug_predict(imgs, shapes, flips,
                                                  sfs).items()}
    ref = jax.jit(lambda *a: jm.apply(v, *a, method="aug_predict"))(
        *(jnp.asarray(to_np(x)) for x in (imgs, shapes, flips, sfs)))
    ref = {k: np.asarray(x) for k, x in ref.items()}
    assert set(got) == set(ref) == {"boxes", "scores", "labels", "valid"}
    assert got["boxes"].shape == (1, 20, 4) and got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    assert np.abs(got["boxes"] - ref["boxes"]).max() < 1e-2
    assert np.abs(got["scores"] - ref["scores"]).max() < 1e-5


def by_label(out, key="boxes", labels="labels", scores="scores"):
    """Merged detections sorted by (label, -score)."""
    order = np.lexsort((-np.asarray(out[scores]), np.asarray(out[labels])))
    return (np.asarray(out[labels])[order], np.asarray(out[scores])[order],
            np.asarray(out[key])[order])


def quad_area(q):
    x, y = q[:, 0::2], q[:, 1::2]
    return 0.5 * np.abs((x * np.roll(y, -1, 1) - np.roll(x, -1, 1) * y).sum(1))


def assert_merged_close(got, ref, quad_tol, fit_ties=0.0):
    """Merged boxes and quads paired in (label, -score) order.  A quad
    may differ beyond ``quad_tol`` where the mask's minimum-area
    rectangle is a tie (OpenCV's minAreaRect in the reference, the
    port's numpy calipers): then at most a ``fit_ties`` share of them,
    with the same area within 2% and centres within 1 px."""
    g, r = by_label(got), by_label(ref)
    assert len(g[0]) == len(r[0]) > 0
    np.testing.assert_array_equal(g[0], r[0])
    assert np.abs(g[1] - r[1]).max() < 1e-5
    assert np.abs(g[2] - r[2]).max() < 1e-2
    g = by_label(got, "quads", "quad_labels", "quad_scores")
    r = by_label(ref, "quads", "quad_labels", "quad_scores")
    np.testing.assert_array_equal(g[0], r[0])
    assert np.abs(g[1] - r[1]).max() < 1e-5
    off = np.abs(g[2] - r[2]).max(1) >= quad_tol
    assert off.mean() <= fit_ties, off.mean()
    ga, ra = quad_area(g[2][off]), quad_area(r[2][off])
    assert (np.abs(ga - ra) <= 0.02 * ra).all()
    centre = np.abs(g[2][off].reshape(-1, 4, 2).mean(1)
                    - r[2][off].reshape(-1, 4, 2).mean(1))
    assert (centre <= 1.0).all()


@needs_reference
def test_aug_test_image_matches_the_reference(theta_pair):
    jm, v, tm = theta_pair
    img = image(4, h=IMG)
    got = aug_test_image(tm, img, scales=(IMG,), flip=True,
                         rbox_encode="thetaobb")
    ref = ref_aug_test_image(jm, v, img, scales=(IMG,), flip=True,
                             rbox_encode="thetaobb")
    assert {"quads", "quad_scores", "quad_labels"} <= set(got)
    assert_merged_close(got, ref, 5e-2)
    small = aug_test_image(tm, image(5), scales=(96, IMG), flip=True,
                           rbox_encode="thetaobb")
    assert len(small["boxes"]) > 0
    assert small["boxes"][:, [0, 2]].max() <= IMG
    assert small["boxes"][:, [1, 3]].max() <= 100
    with pytest.raises(ValueError, match="canvas"):
        aug_test_image(tm, img, scales=(2 * IMG,))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tta_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tta_scripts"))
    ann, prefix, _ = chip_smoke.write_patch_set(root, 0, 2, PATCH, 10,
                                                seed=7)
    body = dict(model=dict(chip_smoke.small_mask_model("centermap"),
                           img_size=PATCH),
                test_cfg=dict(chip_smoke.SMALL_TEST_CFG, rcnn=dict(
                    max_per_img=16, score_thr=0.05, nms_thr=0.5)),
                data=dict(test=dict(type="DOTADataset", ann_file=ann,
                                    img_prefix=prefix, test_mode=True)),
                tta=dict(scales=[PATCH], flip=True))
    config = os.path.join(root, "tta_small.py")
    with open(config, "w") as f:
        for k, val in body.items():
            f.write(f"{k} = {json.loads(json.dumps(val))!r}\n")
    ref_model, variables, cfg = ref_inference.init_detector(config)
    params = jax.device_get(variables["params"])
    logits = dict(params["_mask_head"]["conv_logits"])
    logits["bias"] = np.full(np.shape(logits["bias"]), 0.5, np.float32)
    params["_mask_head"] = dict(params["_mask_head"], conv_logits=logits)
    variables = dict(variables, params=params)
    sd, unmapped = flax_to_state_dict(variables)
    assert not unmapped
    port = build_detector(RefConfig.fromfile(config).model, device="cpu")
    port.load_state_dict(sd, strict=True)
    ckpt = os.path.join(root, "weights.pt")
    torch.save(port.state_dict(), ckpt)
    out, argv = {}, sys.argv
    saved_init = ref_inference.init_detector
    try:
        ref_inference.init_detector = lambda *a, **k: (ref_model, variables,
                                                       cfg)
        for name, extra in (("test", ["--n-devices", "1"]),
                            ("torch_test", ["--checkpoint", ckpt,
                                            "--device", "cpu"])):
            pkl = os.path.join(root, f"{name}.pkl")
            sys.argv = [name, config, "--tta", "--out", pkl,
                        "--submit-dir", os.path.join(root, name), *extra]
            _tool(name).main()
            with open(pkl, "rb") as f:
                out[name] = pickle.load(f)
    finally:
        ref_inference.init_detector = saved_init
        sys.argv = argv
    return root, out


@needs_reference
def test_torch_test_tta_matches_tools_test(tta_runs):
    root, out = tta_runs
    ref, got = out["test"], out["torch_test"]
    assert got["names"] == ref["names"] and len(got["results"]) == 2
    for r, g in zip(ref["results"], got["results"]):
        assert set(g) == set(r) == {"boxes", "scores", "labels", "valid",
                                    "quads", "quad_scores", "quad_labels"}
        assert_merged_close(g, r, 1e-2, fit_ties=0.25)
    for name in ("test", "torch_test"):
        assert sorted(os.listdir(os.path.join(root, name, "obb")))



@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_tta.py")
    out = chip_smoke.run_tta_reference()
    assert out["max_abs_err"]["unpaired"] == 0 and out["merged"] > 0
