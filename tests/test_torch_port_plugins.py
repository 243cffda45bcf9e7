"""The ResNet plug-ins of the PyTorch port against the reference: ConvWS,
Scale, GCNet's ContextBlock (att and avg pooling), NonLocal2D and
GeneralizedAttention per attention term, with a spatial range and with
q_stride 2; the ResNet with ``conv_cfg=dict(type="ConvWS")``, ``gcb``
and ``gen_attention``; the small FasterRCNN with '1111' attention, the
small GCNet Mask R-CNN and the small GN+WS Mask R-CNN end to end
(predict and a train step's losses); and the configs of the three
families through the weight bridge.

Inputs are made with numpy from a seed; weights are the reference's
(`seeded_variables`: kernels N(0, 1 / fan_in), every other leaf N(0,
0.1)), carried over by `flax_to_state_dict`.  The leaves the reference
starts at zero (GeneralizedAttention's ``gamma``, ContextBlock's
``channel_add_conv2`` and NonLocal2D's ``conv_out`` kernels) are seeded
nonzero, so that no plug-in is the identity.  Tolerances (float32): a
module's output within 1e-5 of its largest magnitude (1e-4 through a
ResNet); detections paired in any order with boxes within 2e-2 px,
scores within 2e-4 and masks within 1e-3 (`LIMITS`; 5e-2 px and 5e-4
through the attention); losses within 1e-4 of their value.  The gpu
case runs chip_smoke's slice-16 reference phases.
"""

import numpy as np
import pytest
import torch

from aidet_tpu_torch.models.plugins import (ContextBlock, ConvWS,
                                            GeneralizedAttention, NonLocal2D,
                                            Scale)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import to_np

try:
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from aidet_tpu.models import plugins as J
    from aidet_tpu.models.backbones.resnet import ResNet as JResNet
    from aidet_tpu_torch.convert import flax_to_state_dict
    from aidet_tpu_torch.models.backbones.resnet import ResNet
    from torch_port_helpers import load_flax
    from torch_port_pairs import (SMALL_MASK_HEAD, assert_bridge_loads,
                                  assert_losses_close, assert_matched,
                                  hbb_batch, hbb_cfg, port_loss,
                                  port_predict, ref_loss, ref_predict,
                                  seeded_variables, shaped_pair,
                                  shaped_variables)
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
T = torch.from_numpy
GN = dict(type="GN", num_groups=32)
# boxes within 2e-2 px (seen 1.3e-2 through the context blocks'
# LayerNorm, as in the cascade's pairs), scores within 2e-4, masks
# within 1e-3; through the attention's softmaxes boxes within 5e-2 px
# and scores within 5e-4 (seen 2.4e-2 and 2.3e-4)
LIMITS = dict(boxes=2e-2, scores=2e-4, masks=1e-3)
ATTENTION_LIMITS = dict(boxes=5e-2, scores=5e-4)


def assert_close(got, ref, rel=1e-5):
    got, ref = to_np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-12), err


def load_module(module, variables):
    """The variables of one reference module into ``module`` through the
    weight bridge (as a submodule "m" of a backbone)."""
    sd, unmapped = flax_to_state_dict(
        {col: {"_backbone": {"m": tree}} for col, tree in variables.items()})
    assert not unmapped, unmapped
    module.load_state_dict({k[len("backbone.m."):]: v for k, v in sd.items()},
                           strict=True)
    return module.eval()


def nhwc(seed, shape=(2, 9, 11, 32)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def run_port(module, x):
    with torch.no_grad():
        return module(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@needs_reference
@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_conv_ws_matches_the_reference(stride, dilation):
    """The standardised kernel: population std over (kh, kw, in) plus
    1e-5; the kernel's mean is shifted off zero so that it matters."""
    x = nhwc(1)
    jm = J.ConvWS(features=16, kernel_size=3, stride=stride,
                  padding=dilation, dilation=dilation)
    v = seeded_variables(jm, jnp.asarray(x))
    v["params"]["kernel"] = v["params"]["kernel"] * 3.0 + 0.2
    tm = load_module(ConvWS(32, 16, 3, stride, dilation, dilation), v)
    assert_close(run_port(tm, x), jm.apply(v, jnp.asarray(x)))


@needs_reference
def test_scale_matches_the_reference():
    x = nhwc(2)
    jm = J.Scale(init_value=1.7)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = load_module(Scale(0.0), v)
    assert float(tm.weight.detach()) == pytest.approx(1.7)
    with torch.no_grad():
        assert_close(tm(T(x)), jm.apply(v, jnp.asarray(x)))


@needs_reference
@pytest.mark.parametrize("pooling", ["att", "avg"])
def test_context_block_matches_the_reference(pooling):
    """flax's LayerNorm over the channels (epsilon 1e-6); the zero
    kernel of channel_add_conv2 seeded."""
    x = nhwc(3)
    jm = J.ContextBlock(ratio=1 / 4, pooling_type=pooling)
    v = seeded_variables(jm, jnp.asarray(x))
    assert np.abs(v["params"]["channel_add_conv2"]["kernel"]).max() > 0
    tm = load_module(ContextBlock(32, 1 / 4, pooling), v)
    assert_close(run_port(tm, x), jm.apply(v, jnp.asarray(x)))


@needs_reference
def test_non_local_matches_the_reference():
    x = nhwc(4)
    jm = J.NonLocal2D(reduction=2)
    v = seeded_variables(jm, jnp.asarray(x))
    assert np.abs(v["params"]["conv_out"]["kernel"]).max() > 0
    tm = load_module(NonLocal2D(32, 2), v)
    assert_close(run_port(tm, x), jm.apply(v, jnp.asarray(x)))


def attention_pair(x, seed=0, **kw):
    """The reference module, its seeded variables (shapes from a 1x1 map:
    they do not depend on the map's size, and a q_stride > 1 fails at
    the residual add on any larger one) with ``gamma`` 1.3, and the
    port's module with them."""
    jm = J.GeneralizedAttention(in_dim=x.shape[-1], num_heads=4, **kw)
    v = seeded_variables(jm, jnp.asarray(x[:, :1, :1]), seed=seed)
    v["params"]["gamma"] = np.float32(1.3)
    return jm, v, load_module(GeneralizedAttention(x.shape[-1], num_heads=4,
                                                   **kw), v)


@needs_reference
@pytest.mark.parametrize("attention_type", ["1000", "0100", "0010", "0001",
                                            "1111", "1010", "0101"])
@pytest.mark.parametrize("kv_stride", [1, 2])
def test_generalized_attention_matches_the_reference(attention_type,
                                                     kv_stride):
    """Each energy term alone, all four, and the pairs that share a
    bias, on a 9x11 map (odd sides: the strided key grid is uneven),
    ``gamma`` 1.3."""
    x = nhwc(5)
    jm, v, tm = attention_pair(x, attention_type=attention_type,
                               kv_stride=kv_stride)
    assert_close(run_port(tm, x), jm.apply(v, jnp.asarray(x)))


@needs_reference
@pytest.mark.parametrize("spatial_range", [0, 1, 3])
def test_generalized_attention_spatial_range_matches_the_reference(
        spatial_range):
    """The local mask (-inf outside the range) at kv_stride 2, with a
    position magnitude and embedding width of their own."""
    x = nhwc(6)
    jm, v, tm = attention_pair(x, attention_type="1111",
                               spatial_range=spatial_range,
                               position_embedding_dim=24,
                               position_magnitude=2.0)
    assert_close(run_port(tm, x), jm.apply(v, jnp.asarray(x)))


class _Stop(Exception):
    pass


@needs_reference
def test_generalized_attention_q_stride_matches_the_reference():
    """q_stride 2: both raise a TypeError at the residual add (the
    output has the strided size); the projected attention before it
    (``proj_conv``'s output) is held to the reference's, read by a flax
    method interceptor."""
    x = nhwc(7, (2, 10, 12, 32))
    jm, v, tm = attention_pair(x, attention_type="1111", q_stride=2,
                               spatial_range=2)

    def grab(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.module.name == "proj_conv":
            raise _Stop(out)
        return out
    with fnn.intercept_methods(grab), pytest.raises(_Stop) as ref:
        jm.apply(v, jnp.asarray(x))
    with pytest.raises(TypeError):
        jm.apply(v, jnp.asarray(x))
    seen = []
    tm.proj_conv.register_forward_hook(lambda m, i, o: seen.append(o))
    with pytest.raises(TypeError, match="q_stride 2"):
        run_port(tm, x)
    assert_close(seen[0].permute(0, 2, 3, 1), ref.value.args[0])


@needs_reference
@pytest.mark.parametrize("depth,options", [
    (18, dict(conv_cfg=dict(type="ConvWS"), norm_cfg=GN)),
    (50, dict(gcb=dict(ratio=1 / 16), stage_with_gcb=(False, True, True,
                                                      True))),
    (18, dict(gen_attention=dict(attention_type="1111", num_heads=8,
                                 kv_stride=2),
              gen_attention_stages=(False, False, True, True)))],
    ids=["conv_ws_gn", "gcb", "gen_attention"])
def test_resnet_plugins_match_the_reference(depth, options):
    """The ResNet at 64^2 with each plug-in (`shaped_variables`: the
    context blocks' kernels drawn, every norm seeded; then
    `seed_plugins`); with ConvWS the 7x7 stem is standardised too."""
    jm = JResNet(depth=depth, **options)
    x = np.random.RandomState(8).randn(2, 64, 64, 3).astype(np.float32)
    v = seed_plugins(shaped_variables(jm, img=64))
    tm = load_flax(ResNet(depth=depth, **options), v, "_backbone")
    if "conv_cfg" in options:
        assert isinstance(tm.stem_conv, ConvWS)
    if "gen_attention" in options:
        assert isinstance(tm.layer4_block1_gen_attention,
                          GeneralizedAttention)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(T(x))
    for g, r in zip(got, ref):
        assert_close(g, r, 1e-4)


def seed_plugins(v, seed=0):
    """Each GeneralizedAttention's ``gamma`` in [0.5, 1.5] and its biases
    U(0, 0.5) (`shaped_variables` leaves them 0: the identity), its
    query and key kernels times 0.1.  At N(0, 1 / fan_in) on a random
    backbone's activations the energies reach hundreds, the softmax
    picks single keys by margins that float32's rounding of the two
    runs moves, and C5 differs by 8e-4 of its largest value; damped,
    the energies stay within a few units and C5 within 4e-6."""
    rs = np.random.RandomState(seed)

    def walk(tree):
        for k, x in tree.items():
            if k in ("query_conv", "key_conv"):
                x["kernel"] = x["kernel"] * np.float32(0.1)
            elif hasattr(x, "items"):
                walk(x)
            elif k == "gamma":
                tree[k] = np.float32(rs.uniform(0.5, 1.5))
            elif k in ("appr_bias", "geom_bias"):
                tree[k] = rs.uniform(0, 0.5, np.shape(x)).astype(np.float32)
    walk(v)
    return v


# the small detectors of the slice's reference phases (as chip_smoke's
# kinds of those names): ResNet-18 (ResNet-50 for GCNet, whose context
# blocks sit in bottlenecks) under the small 64-channel FPN, 16
# classes, 128^2
def small_cfg(kind):
    r50_neck = dict(type="FPN", in_channels=(256, 512, 1024, 2048),
                    out_channels=64, num_outs=5)
    mask_head = dict(type="FCNMaskHead", **SMALL_MASK_HEAD)
    if kind == "attention":
        return hbb_cfg("FasterRCNN", backbone=dict(
            type="ResNet", depth=18, gen_attention=dict(
                attention_type="1111", num_heads=8, kv_stride=2),
            gen_attention_stages=(False, False, True, True)))
    if kind == "gcb":
        return hbb_cfg("MaskRCNN", backbone=dict(
            type="ResNet", depth=50, gcb=dict(ratio=1 / 16),
            stage_with_gcb=(False, True, True, True)), neck=r50_neck,
            mask_head=mask_head)
    return hbb_cfg("MaskRCNN", backbone=dict(
        type="ResNet", depth=18, norm_cfg=GN, conv_cfg=dict(type="ConvWS")),
        neck=dict(type="FPN", in_channels=(64, 128, 256, 512),
                  out_channels=64, num_outs=5, norm_cfg=GN),
        bbox_head=dict(type="ConvFCBBoxHead", num_classes=16,
                       in_channels=64, num_shared_convs=2, num_fcs=1,
                       conv_out_channels=64, fc_out_channels=128,
                       norm_cfg=GN),
        mask_head=dict(mask_head, norm_cfg=GN))


@needs_reference
@pytest.mark.parametrize("kind", ["attention", "gcb", "gn_ws"])
def test_small_detector_matches_the_reference(kind):
    """Predict (every detection paired, masks too) and one train step's
    losses of the small detector against the reference, same weights."""
    cfg = small_cfg(kind)
    jm, v, _ = shaped_pair(cfg)
    v = seed_plugins(v)
    from aidet_tpu_torch.models.builder import build_detector
    sd, unmapped = flax_to_state_dict(v)
    assert not unmapped, unmapped
    tm = build_detector(cfg, device="cpu", train=True)
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    masks = cfg["type"] == "MaskRCNN"
    batch = hbb_batch(masks=masks)
    limits = dict(LIMITS) if masks else ATTENTION_LIMITS
    assert_matched(port_predict(tm, batch), ref_predict(jm, v, batch),
                   limits)
    assert_losses_close(port_loss(tm, batch), ref_loss(jm, v, batch), 1e-4)


@needs_reference
@pytest.mark.parametrize("config", [
    "faster_rcnn_attention_1111_r50_fpn_1x",
    "faster_rcnn_attention_0010_dcn_r50_fpn_1x",
    "mask_rcnn_r4_gcb_c3-c5_r50_fpn_1x",
    "mask_rcnn_r50_fpn_gn_ws_2x"])
def test_config_weights_load_through_the_bridge(config):
    """The reference's variables of the config (shapes from a trace,
    seeded values) load strictly into the port's build, every leaf
    mapped: the attention's raw biases, gamma and position linears, the
    context blocks' LayerNorm, ConvWS kernels, the GN mask head's norms."""
    tm, sd = assert_bridge_loads(f"configs/{config}.py")
    if "attention_1111" in config:
        assert sd["backbone.layer3_block0_gen_attention.gamma"].shape == ()
        assert sd["backbone.layer4_block2_gen_attention.appr_geom_fc_x"
                  ".weight"].shape == (2048, 1024)
    if "0010" in config:
        assert not hasattr(tm.backbone.layer3_block0_gen_attention,
                           "geom_bias")
    if "gcb" in config:
        assert sd["backbone.layer2_block0.context_block.ln.weight"].shape \
            == (128,)
    if "gn_ws" in config:
        assert isinstance(tm.backbone.layer1_block0.conv2, ConvWS)
        assert "mask_head.norm3.weight" in sd


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_plugins.py")
    import chip_smoke
    for kind in ("attention", "gcb", "gn_ws"):
        out = chip_smoke.run_hbb_reference(kind=kind)
        assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
