"""HRNet and HRFPN of the PyTorch port against the JAX reference on the
CPU.

Bounds (seeded inputs, the reference's weights with seeded FrozenBN
statistics and affines carried over by the weight bridge):
- one `HRModule` of 3 branches (8, 16, 32 channels), 2 blocks a branch,
  at 9x7 / 5x4 / 3x2 (odd sizes, where only a half-pixel nearest resize
  agrees): within 1e-5 of the largest output;
- a narrow HRNet (width 8, one module a stage of 1 block a branch) at
  64^2 and at 67x45: every stream within 1e-5 of its largest value
  (random FrozenBN weights grow the activations to ~1e3);
- HRFPN over streams of 33x35 .. 5x5 (bilinear upsampling to odd
  sizes, average pools that drop a remainder): within 1e-5;
- `configs/dota_centermap_obb_hrnet_ms.py` builds with HRNet-W32 and
  HRFPN, and the reference's variables of it (shapes from
  `jax.eval_shape`) load strictly through the weight bridge, nothing
  unmapped.
The gpu-marked case runs chip_smoke's hrnet_reference phase (the small
HRNet CenterMapOBB on the card against the CPU).
"""

import numpy as np
import pytest
import torch

from aidet_tpu_torch.models.backbones.hrnet import HRModule, HRNet
from aidet_tpu_torch.models.necks.hrfpn import HRFPN
from torch_port_helpers import load_flax, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp

    from aidet_tpu.models.backbones.hrnet import HRModule as JHRModule
    from aidet_tpu.models.backbones.hrnet import HRNet as JHRNet
    from aidet_tpu.models.necks.hrfpn import HRFPN as JHRFPN
    from torch_port_pairs import assert_bridge_loads, perturb_all_norms
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
T = torch.from_numpy
NARROW = dict(width=8, stage_modules=(1, 1, 1, 1), stage_blocks=1)


def run(jm, tm, inputs, top, wrap):
    """The reference module and the port's with its weights on seeded
    inputs: (port outputs, reference's)."""
    xs = [jnp.asarray(x) for x in inputs]
    arg = xs if wrap else xs[0]
    v = perturb_all_norms(jax.jit(jm.init)(jax.random.PRNGKey(0), arg), 3)
    ref = jax.jit(jm.apply)(v, arg)
    if top is None:      # a bare module: its tree under a scope of its own
        v = {k: {"m": t} for k, t in v.items()}
        holder = torch.nn.Module()
        holder.m = tm
        load_flax(holder, v, "_backbone")
    else:
        load_flax(tm, v, top)
    with torch.no_grad():
        if top is None:  # HRModule maps NCHW streams
            got = [y.permute(0, 2, 3, 1) for y in tm(
                [T(x).permute(0, 3, 1, 2) for x in inputs])]
        else:
            got = tm([T(x) for x in inputs] if wrap else T(inputs[0]))
    return [to_np(g) for g in got], [np.asarray(r) for r in ref]


def assert_close(got, ref, rel=1e-5):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= rel * np.abs(r).max() + 1e-6


@needs_reference
def test_hr_module_matches_the_reference():
    sizes = ((9, 7), (5, 4), (3, 2))
    rs = np.random.RandomState(0)
    chans = (8, 16, 32)
    xs = [rs.randn(2, h, w, c).astype(np.float32)
          for (h, w), c in zip(sizes, chans)]
    got, ref = run(JHRModule(num_branches=3, num_blocks=2, channels=chans),
                   HRModule(3, 2, chans, chans), xs, None, wrap=True)
    assert_close(got, ref)


@needs_reference
@pytest.mark.parametrize("hw", [(64, 64), (67, 45)])
def test_narrow_hrnet_matches_the_reference(hw):
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    got, ref = run(JHRNet(**NARROW), HRNet(**NARROW), [x], "_backbone",
                   wrap=False)
    assert [g.shape[-1] for g in got] == [8, 16, 32, 64]
    assert_close(got, ref)


@needs_reference
def test_hrfpn_matches_the_reference():
    rs = np.random.RandomState(2)
    xs = [rs.randn(2, -(-33 // 2 ** i), -(-35 // 2 ** i), c).astype(
        np.float32) for i, c in enumerate((8, 16, 32, 64))]
    got, ref = run(JHRFPN(in_channels=(8, 16, 32, 64), out_channels=16),
                   HRFPN((8, 16, 32, 64), 16), xs, "_neck", wrap=True)
    assert [g.shape[1:3] for g in got] == [(33, 35), (16, 17), (8, 8),
                                           (4, 4), (2, 2)]
    assert_close(got, ref)


@needs_reference
def test_hrnet_config_builds_and_loads_the_bridges_weights():
    tm, _ = assert_bridge_loads("configs/dota_centermap_obb_hrnet_ms.py")
    assert isinstance(tm.backbone, HRNet) and isinstance(tm.neck, HRFPN)
    assert tm.backbone.stage4_module2.fuse3_0_2.weight.shape == (256, 32, 3,
                                                                  3)
    assert tm.mask_head.num_convs == 10


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_hrnet.py")
    import chip_smoke
    out = chip_smoke.run_hrnet_reference()
    assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
