"""Helpers shared by the tests of the PyTorch port (tests/test_torch_port_*).

Inputs are made with numpy from a seed and handed to both packages.
"""

import os

import numpy as np
import pytest
import torch

from aidet_tpu_torch.convert import TOP_LEVEL, flax_to_state_dict

STRIDES = (4, 8, 16, 32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Autouse in the test modules that import it: torch on one thread
    while the module runs in a pytest-xdist worker, its default thread
    count restored after.  The workers share the machine's cores, and
    torch's default of a thread per core then spends most of its time
    in oversubscribed OpenMP waits (the isolation test's subprocesses
    run on one thread for the same reason).  Only modules whose limits
    hold at one thread import it: two tests of test_torch_port_gn.py
    and test_torch_port_full_models.py pass at the default thread count
    alone (a loss 2.8e-5 off in relative terms, an rbox tie)."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def perturb_norms(variables, seed):
    """Replace the identity frozen-BN statistics and affine of freshly
    initialised flax variables by seeded random ones, so that the
    weight bridge and FrozenBN are exercised."""
    rng = np.random.RandomState(seed)

    def walk(tree, name=""):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, k)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
            elif k == "mean" or (k == "bias" and "bn" in name):
                out[k] = rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(variables)


def load_flax(module: torch.nn.Module, variables, top: str):
    """Load the flax variables of one reference module (as it sits
    under ``top`` in a detector, e.g. "_backbone") into ``module``."""
    wrapped = {col: {top: tree} for col, tree in variables.items()}
    sd, unmapped = flax_to_state_dict(wrapped)
    assert not unmapped, unmapped
    prefix = TOP_LEVEL[top] + "."
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                           strict=True)
    return module.eval()


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def make_inputs(seed, b=2, r=24, c=32, img=256, extreme=True):
    """Four NHWC levels (strides 4..32) of a ``img``^2 input and rois
    [b, r, 4] of 2..140 px, some partly outside the image."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(b, img // s, img // s, c).astype(np.float32)
             for s in STRIDES]
    xy = rng.uniform(-20, img - 40, (b, r, 2))
    wh = rng.uniform(2, 140, (b, r, 2))
    rois = np.concatenate([xy, np.minimum(xy + wh, img + 10)], -1)
    if extreme:   # thin rois that the TPU kernels bump to coarser levels
        rois[:, :3] = [[10., 100., 250., 108.], [30., 5., 38., 240.],
                       [0., 0., img - 1., img - 1.]]
    return feats, rois.astype(np.float32)


# rotated rois (cx, cy, w, h, theta) on a 256^2 image where the designs
# of the rotated RoIAlign can break: the whole image turned, across the
# last row and column, partly outside at theta past pi/2, w and h below
# one cell, long thin rois that the TPU kernel bumps to coarser levels
# (their span exceeds its window), and a sub-cell roi at theta ~ pi
EDGE_RROIS = [[128., 128., 256., 256., 0.3], [254., 254., 30., 20., -0.6],
              [-10., 50., 40., 30., 2.5], [100., 100., 2., 1.5, -2.0],
              [128., 60., 200., 6., 0.1], [60., 128., 8., 220., -1.4],
              [128., 128., 0.5, 0.5, 3.1]]


def make_rroi_inputs(seed, b=2, r=24, c=32, img=256, edge=True):
    """Four NHWC levels (strides 4..32) of a ``img``^2 input and rotated
    rois [b, r, 5]: centres in [-20, img + 20], sides 1..200 px, thetas
    in [-2 pi, 2 pi]; the first of image 0 are `EDGE_RROIS` (for a 256^2
    image) if ``edge``."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(b, img // s, img // s, c).astype(np.float32)
             for s in STRIDES]
    rr = np.concatenate([rng.uniform(-20, img + 20, (b, r, 2)),
                         rng.uniform(1, 200, (b, r, 2)),
                         rng.uniform(-2 * np.pi, 2 * np.pi, (b, r, 1))], -1)
    if edge:
        rr[0, :len(EDGE_RROIS)] = EDGE_RROIS
    return feats, rr.astype(np.float32)
