"""RBBoxRCNNRRoI: the Point-OBB RBBoxRCNN with rotated-RoI refinement.

`build_rroi` mirrors `configs/dota_rroi_point_obb_r50_fpn_1x.py` (the
reference's RBBoxRCNNRRoI, BASELINE config #3): a first-stage
RBBoxHead regressing pointobb corners from horizontal RoI crops, whose
selected detections are re-cropped by rotated RoIAlign and refined by
an rtheta RBBoxHead.  Two configurations:

- full (``small=False``): ResNet-50 with the space-to-depth stem (as
  `build_flagship` builds it), a 5-level FPN at 256 channels, RPN,
  SharedFC, pointobb and rtheta RBBox heads at 1024 FC channels, 16
  classes, in bfloat16, with the config's test_cfg: nms_pre 2000 /
  nms_post 2000 / max_num 2000 proposals and 100 detections per image;
- small (``small=True``): ResNet-18, 64 channels, 128-wide FCs and the
  test_cfg 200 / 100 / 100 / 20 of the reference's small test config
  (tests/test_models_forward.py `_small_cfg`), in float32, for the CPU
  tests.

Predict only: `TwoStageDetector.loss` raises for a model with a
refinement head.  Weights are random, drawn from a seeded
`torch.Generator` (or loaded later from converted reference weights,
see `aidet_tpu_torch.convert`).
"""

from __future__ import annotations

from .flagship import build_parts, default_dtype, finish
from .models.detectors.two_stage import TwoStageDetector
from .models.heads.bbox_head import RBBoxHead


def build_rroi(img_size: int, small: bool = False, device="cuda",
               dtype=None, seed: int = 0) -> TwoStageDetector:
    """The RBBoxRCNNRRoI predict model on ``device``, computing in
    ``dtype`` (default: bfloat16 for the full model, float32 for the
    small one), with random weights from
    ``torch.Generator().manual_seed(seed)``."""
    width = 64 if small else 256
    fc = 128 if small else 1024
    caps = (200, 100, 100, 20) if small else (2000, 2000, 2000, 100)
    test_cfg = dict(
        rpn=dict(nms_pre=caps[0], nms_post=caps[1], max_num=caps[2],
                 nms_thr=0.7),
        rcnn=dict(score_thr=0.05, nms_thr=0.5, max_per_img=caps[3]))
    model = TwoStageDetector(
        *build_parts(small, encode="pointobb"), img_size=img_size,
        test_cfg=test_cfg, compute_dtype=default_dtype(small, dtype),
        rbbox_refine_head=RBBoxHead(num_classes=16, in_channels=width,
                                    fc_out_channels=fc, encode="rtheta"))
    return finish(model, small, device, dtype, seed)
