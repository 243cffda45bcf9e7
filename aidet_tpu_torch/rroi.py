"""RBBoxRCNNRRoI: the Point-OBB RBBoxRCNN with rotated-RoI refinement.

`build_rroi` mirrors `configs/dota_rroi_point_obb_r50_fpn_1x.py` (the
reference's RBBoxRCNNRRoI, BASELINE config #3): a first-stage
RBBoxHead regressing pointobb corners from horizontal RoI crops, whose
selected detections are re-cropped by rotated RoIAlign and refined by
an rtheta RBBoxHead.  Two configurations:

- full (``small=False``): ResNet-50 with the space-to-depth stem (as
  `build_flagship` builds it; the config names the plain 7x7 stem,
  which computes the same function), a 5-level FPN at 256 channels, RPN,
  SharedFC, pointobb and rtheta RBBox heads at 1024 FC channels, 16
  classes, in bfloat16, with the config's test_cfg: nms_pre 2000 /
  nms_post 2000 / max_num 2000 proposals and 100 detections per image,
  and its train_cfg, the reference's defaults (`DEFAULT_TRAIN_CFG`:
  RPN 256 anchors at 0.5, proposals 2000 / 2000 / 2000 at nms 0.7,
  512 RoIs at 0.25);
- small (``small=True``): ResNet-18, 64 channels, 128-wide FCs and the
  test_cfg 200 / 100 / 100 / 20 and train_cfg (proposals 200 / 100 /
  100, 32 RoIs) of the reference's small test config
  (tests/test_models_forward.py `_small_cfg`), in float32, for the CPU
  tests.

``train=False`` builds the predict model, every parameter in the
compute dtype; ``train=True`` the trainer's, with float32 parameters
and `TwoStageDetector.loss` computing in the compute dtype under
autocast, as `build_flagship` does.  Weights are random, drawn from a
seeded `torch.Generator` (or loaded later from converted reference
weights, see `aidet_tpu_torch.convert`).

The space-to-depth stem and bfloat16 are the serving choices: the
config itself computes in float32 with a 7x7 stem, and its weights
load into this build because `convert.flax_to_state_dict(variables,
model)` relays the 7x7 stem kernel for the s2d stem (exact:
tests/test_torch_port_full_models.py).  To build the config as it is
written, use `aidet_tpu_torch.models.builder.build_detector` or
`aidet_tpu_torch.apis.inference.init_detector`.
"""

from __future__ import annotations

from .flagship import build_parts, default_dtype, finish
from .models.detectors.two_stage import TwoStageDetector, _merge
from .models.heads.bbox_head import RBBoxHead


def build_rroi(img_size: int, small: bool = False, device="cuda",
               dtype=None, seed: int = 0, train: bool = False,
               train_cfg=None, encode: str = "pointobb") -> TwoStageDetector:
    """The RBBoxRCNNRRoI on ``device``, computing in ``dtype`` (default:
    bfloat16 for the full model, float32 for the small one), with random
    weights from ``torch.Generator().manual_seed(seed)``.  Parameters
    are in ``dtype`` too, unless ``train``: then they stay float32.
    ``train_cfg`` overrides the configuration's train_cfg; ``encode``
    is the first-stage rbbox codec (the config's pointobb, or
    thetaobb)."""
    width = 64 if small else 256
    fc = 128 if small else 1024
    caps = (200, 100, 100, 20) if small else (2000, 2000, 2000, 100)
    test_cfg = dict(
        rpn=dict(nms_pre=caps[0], nms_post=caps[1], max_num=caps[2],
                 nms_thr=0.7),
        rcnn=dict(score_thr=0.05, nms_thr=0.5, max_per_img=caps[3]))
    own_train_cfg = dict(
        rpn_proposal=dict(nms_pre=200, nms_post=100, max_num=100),
        rcnn=dict(num_samples=32)) if small else {}
    model = TwoStageDetector(
        *build_parts(small, encode=encode), img_size=img_size,
        train_cfg=_merge(own_train_cfg, train_cfg), test_cfg=test_cfg,
        compute_dtype=default_dtype(small, dtype),
        rbbox_refine_head=RBBoxHead(num_classes=16, in_channels=width,
                                    fc_out_channels=fc, encode="rtheta"))
    return finish(model, small, device, dtype, seed, train)
