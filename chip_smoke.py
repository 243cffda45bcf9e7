#!/usr/bin/env python3
"""Run the PyTorch port's flagship predict and train paths, the
RBBoxRCNNRRoI predict and train paths, scene serving, the train loop
and test run from a config file, CenterMap-Net's predict and train
paths, RetinaNetOBB and H-OBB, the GroupNorm r18_e2e recipes and a
learning run, HRNet with TTA, OHEM and soft-NMS, and the HBB R-CNN
family (FasterRCNN, RPN -> FastRCNN, ResNeXt, Cascade R-CNN, HTC) on
one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its ``elapsed_s``:

1. device: the card's name and count, and nvidia-smi's name and power
   limit.  Exits non-zero when ``torch.cuda.is_available()`` is false.
2. build: nvcc builds every kernel library of the paths from the
   checkout, one nvcc process per source, all at once: the RoIAlign
   forward (`aidet_tpu_torch/csrc/roi_align.cu`: K1, and K2's forward),
   K2's backward (`csrc/roi_align_backward.cu`), K3
   (`csrc/roi_align_bandx.cu`), K4's forward (`csrc/rroi_align.cu`) and
   K4's backward (`csrc/rroi_align_backward.cu`), with ptxas's
   registers, shared memory and spills.
3. kernels: each kernel against its plain PyTorch version on seeded
   inputs at its path's shapes, its time from CUDA events and the
   plain version's, its bound and its share of the bound (bound_ms /
   ms).  ``ms`` is the time per launch of eager launches between CUDA
   events: the device's time, or the host's time to enqueue a launch
   where that is longer; beside it ``device_ms``, the device time alone
   (CUDA events around replays of a CUDA graph of the launches), and
   ``host_ms``, the enqueue time alone.  K1 at the RRoI predict's 2000
   rois per image (7x7) and at
   predict's (2 images of 1024^2, 1000 rois per image, the four
   pyramid levels at C=256, bfloat16, 7x7 and 14x14), K2's forward and
   backward at the train step's (512 rois per image, 7x7; the backward
   in bfloat16 and float32, against the autograd gradient of the plain
   version, launched twice and the two held to the same limits, with
   its tile lists: entries, the longest list and the spread of the
   lengths, the tiles and the share without entries, and its scratch
   bytes), K3 (its plan and its reduction; the plan's chunk table held
   to its twin `bandx_chunks`, with the bytes its boxes stage and the
   reduction's blocks per SM) at
   the RRoI predict's horizontal crops (2000 rois per image, 7x7) and
   K4 at its rotated crops (100 rotated rois per image, 7x7, without
   and with the TPU kernel's window bump), both in bfloat16 and
   float32, and K4's backward at the RRoI train step's (128 rotated
   rois per image, 7x7, bfloat16 and float32, held and reported as K2's
   backward); K2's forward and backward also at the mask branch's
   14x14 on 128 rois per image (bfloat16; the backward in float32
   too).
4. reference: the small flagship (ResNet-18, float32) predict on the
   card against the same weights on the CPU, where the plain versions
   run.
5. reference_train: one train step of the small flagship (float32),
   on the card against the CPU, under a train_cfg whose samplers keep
   every candidate: losses, grad_norm and the parameters' updates.
6. predict: the full-width flagship (ResNet-50 FPN, bfloat16, 1024^2,
   2000/1000 proposals, 100 detections) on 3 requests of 2 seeded
   random uint8 images, with K1's launch count (1 per call).
7. train: the full-width flagship's train step (float32 parameters,
   bfloat16 compute, the reference's train_cfg and optimizer), batch 2
   of 1024^2 with 64 gts, 1 warm-up and 3 timed steps, with K2's
   launch counts (1 forward and 1 backward per step) and the last
   backward's tile lists.
8. rroi_reference: the small RBBoxRCNNRRoI (ResNet-18, float32)
   predict on the card against the same weights on the CPU.
9. rroi_predict: the full-width RBBoxRCNNRRoI (ResNet-50 FPN, pointobb
   and rtheta heads, bfloat16, 1024^2, 2000 proposals, 100 detections)
   on 3 requests of 2 seeded random uint8 images, with K1's and K4's
   launch counts (1 each per call).
10. rroi_predict_bandx: one more call under AIDET_ROI_BAND=x: K3 once
   (its plan and its reduction), K1 never, K4 once, its detections
   paired with the last K1 call's.
11. rroi_reference_train: one train step of the small RBBoxRCNNRRoI
   (float32) on the card against the CPU, as reference_train: its 8
   losses, grad_norm and the parameters' updates.
12. rroi_train: the full-width RBBoxRCNNRRoI's train step (float32
   parameters, bfloat16 compute, the config's train_cfg), batch 2 of
   1024^2 with 64 pointobb gts, 1 warm-up and 3 timed steps, with the
   launch counts (K2's forward and backward and K4's forward and
   backward, once each per step) and the last backwards' tile lists.
13. scene_reference: one seeded 1024^2 scene (numpy rotated
   rectangles over the 15 DOTA classes) tiled on the card at patch 512
   / overlap 100 (9 patches) through the small flagship (float32), on
   the card against the CPU with the same weights: the card's patches
   equal `tile_image`'s bytes, the merged scene detections pair up, the
   DOTA mAPs agree, and the ground truth fed back as detections scores
   mAP 1.0.
14. scene: scene serving at full width, as bench.py's
   measure_scene_e2e: 3072^2 seeded scenes in pinned host memory ->
   card -> `device_tiler` (1024^2 patches, 200 px overlap: 16) -> one
   batch-16 flagship predict (K1 once) -> lift (outputs to the host,
   thetaobbs to quads) -> per-class rotated-NMS merge -> DOTA eval.
   1 warm scene, 4 pipelined at depth 1 (patches/s), 2 serial with
   each stage's ms; K1's launches (1 per scene), merged detections and
   mAP per scene (near 0 with random weights: a plumbing check).
15. loop: the train loop and the test run of
   `configs/dota_theta_obb_r50_fpn_1x.py` (RBBoxRCNN R50-FPN, 1024^2,
   float32 as the config names no dtype, its optimizer and schedule as
   written) on 24 train and 8 val seeded synthetic patches written as
   PNG: `train_detector` through `DOTADataset`, `GroupedLoader` and
   `TrainPipeline` (host normalize, flip_ratio 0) for 2 epochs at
   batch 2 (12 steps an epoch) with a checkpoint each epoch, then
   again from the epoch-1 checkpoint (its epoch held to the
   uninterrupted run's; under torch.profiler: the device's idle
   share), then `init_detector` from the checkpoint directory,
   `run_inference` over the val patches at batch 8 (held to predict on
   the same batch), the scene merge and the DOTA eval (the ground truth
   as detections scores 1.0).  Every step's losses, grad_norm and lr,
   ms per step, images/s, the loader wait per step, the checkpoint
   save and load ms, K2's launches (1 forward and 1 backward a step)
   and K1's (1 an inference batch).
16. centermap_reference and 17. maskobb_reference: the small
   CenterMap-Net (the CenterMap and WPSGA heads) and the small MaskOBB
   (the FCN mask head, sigmoid masks), float32 with TF32 off, on the
   card against the CPU: predict's detections paired and their 28 x 28
   masks within 1e-2, then one train step under a train_cfg that keeps
   every candidate (each loss, loss_mask and loss_seg among them, and
   the update, held as reference_train's).
18. centermap_predict: `configs/dota_centermap_net_tgrs_mask_weight_v4.py`
   as written (R101-FPN, float32 with cuDNN's TF32, 1000 detections an
   image) on 3 requests of 2 seeded uint8 1024^2 images: ms per call,
   K1's launches (4 a call: 7x7 and 14x14, multi-level and on the
   semantic map), peak memory, detections, and the host's mask-to-OBB
   fit as its own stage.
19. centermap_train: the same config's train step on batches that the
   port's `TrainPipeline` made from 8 seeded PNG patches of 60 objects
   (CenterMap masks, mask weights, pseudo-segmentation, heatmap
   weights, shipped as uint8), 1 warm-up and 3 timed steps: every loss,
   ms per step, K2's launches (4 forward and 4 backward a step), peak
   memory, and the pipeline's host ms per image for each target kind.

20-23. retinanet_obb_reference, retinanet_obb, h_obb_reference, h_obb:
   RetinaNetOBB and the H-OBB RBBoxRCNN, the small models on the card
   against the CPU, then their configs as written.
24. gn_reference: the small thetaobb RBBoxRCNN and RBBoxRCNNRRoI with
   the r18_e2e recipe's GroupNorm in their ResNet-18 and FPN (float32,
   cuDNN off in the step) on the card against the CPU: predict paired,
   one train step's losses and update.
25. theta_r18_e2e and 26. rroi_r18_e2e: `configs/dota_theta_obb_r18_e2e.py`
   and `configs/dota_rroi_point_obb_r18_e2e.py` as written (R18-GN,
   FPN-GN at 128 channels, 512^2, float32): 3 predict calls and 1 + 3
   train steps at batch 2, K1 (and K4) a call, K2 (and K4) a step.
27. learn: the port's learning run, `train_detector` on the r18_e2e
   thetaobb architecture from seeded random weights over 8 seeded 512^2
   synthetic patches (150 epochs, 600 steps at batch 2, the config's
   optimizer, warmup 50 steps), then `run_inference`, the scene merge
   and the DOTA eval on the same scenes: the first and last 10 steps'
   loss, OBB and HBB mAP@0.5; fails under an OBB mAP of 0.5.
28. hrnet_reference and 29. hrnet: a small HRNet + HRFPN CenterMapOBB
   on the card against the CPU, then `configs/dota_centermap_obb_hrnet_ms.py`
   as written (HRNet-W32, HRFPN, the 10-conv CenterMap head, 1024^2):
   3 predict calls, `aug_test_image` at the config's tta (4 variants),
   1 + 2 train steps through `TrainPipeline` at its scale_range.
30. ohem_reference and 31. ohem: the small thetaobb model's OHEM step on
   the card against the CPU, then `configs/dota_theta_obb_ohem_r50_fpn_1x.py`
   as written: 1 + 3 train steps, K2's forward twice a step (the
   scoring pass over every candidate, and the sample).
32. soft_nms_reference and 33. soft_nms: the small CenterMap-Net under
   soft-NMS on the card against the CPU, then
   `configs/dota_centermap_net_tgrs_reverse_seg_weight_v4.py` as written
   and the same weights under hard NMS: ms per call and the NMS stage's.
34. tta_reference: `aug_test_image` of the small GroupNorm thetaobb
   model on the card against the CPU.
35-39. hbb_reference_faster, _fast, _resnext, _cascade, _htc: the
   small FasterRCNN (its weights through `convert.mmdet_to_state_dict`
   from an mmdet-named state_dict), RPN -> FastRCNN, a ResNeXt-50
   FasterRCNN, Cascade Mask R-CNN and HTC with its semantic branch
   (float32, TF32 off) on the card against the CPU: predict paired
   (masks within 1e-2), one train step held as reference_train's under
   a train_cfg that keeps every candidate of every stage.
40-45. faster, faster_x101, rpn_fast, cascade, cascade_mask, htc: the
   COCO configs as written (float32, 81 classes, 1024^2, batch 2):
   1 + 3 predict calls each (ms per call, K1 once a call, three times for
   the cascade's stages, 4 with its mask, 8 for HTC: its stages, its
   masks and their semantic crops; the RPN's proposals fed to
   FastRCNN's `predict_from_proposals`), and 1 + 3 train steps of
   FasterRCNN R50, the cascade and HTC (K2 forward and backward once a
   step, 3 times, 12 times; HTC's on `TrainPipeline` batches with masks
   and the pseudo segmentation), peak memory.  `configs/htc_r50_fpn_1x.py`
   runs with an HTCMaskHead (`HTC_CONFIG`'s note).
The kernels phase also holds K1, K2 and K4 at the r18_e2e shapes
(C=128, float32, 512^2), and K1 and K2 at the HBB family's (float32:
2 x 1000 proposals, HTC's semantic map at stride 8).
Last, after the slices' phases, ddp (`run_ddp`): two ranks over gloo on
the one card, each with its 2 images of a global batch of 4, take the
full flagship's train step, held to one process's step over the 4
images, and the train phase's step, timed with its ``allreduce`` span;
then the test run sharded over them and gathered, every detection
paired with one process's; then `tools/torch_dist_train.sh` at one
process (torchrun, NCCL) trains the loop config for 2 steps.  The rank
processes are this script with ``--ddp-rank``.
Then the data layer's train paths (`run_slice18`): jpeg, every JPEG
fixture of tests/fixtures/jpeg through the host library's decoder
(built with g++ in the build phase, beside the kernels) held to cv2's
recorded decode, and ms per 512^2 decode on one thread and in the
loader's pool; voc, `configs/faster_rcnn_r50_fpn_1x_voc0712.py` as
written on its list of two VOCDatasets (a ConcatDataset) over the
fixture JPEGs with seeded XML, 4 steps at batch 2 and the test run over
the val list; buildchange, `configs/bc_v002_mask_rcnn_r50_v2_jinan_roof.py`
on seeded roof quads over the fixtures, 3 steps and the test run;
instaboost, `configs/mask_rcnn_r50_fpn_instaboost_4x.py` on the fixture
DOTA patches' polygons, 3 steps (the samples InstaBoost changed) and
the test run; r18_e2e_jpeg, `configs/dota_theta_obb_r18_e2e.py` on the
fixture patches and their real annotations, 3 steps and the test run,
then 3 steps with the albu config's list in its pipeline (the samples
albu changed).  Each prints ms and the loader's wait per step, the
test run's seconds, K2's launches (once forward and once backward a
step, twice with a mask head) and K1's (once a test batch, twice with
a mask head); then the script's wall time.

Then one ``{"kernels": [...]}`` line (each kernel's ``launches`` on its
first path, and ``launches_by_path`` on every path), nvidia-smi's name
and power limit line, and last ``{"ok": true, "device": {...}}``.  A failure anywhere
prints its traceback and exits non-zero without those lines.  The
script imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import math
import subprocess
import sys
import time

T0 = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
ATOL_BF16 = 0.05              # kernel vs plain version, bfloat16 features
# K2's and K4's backward against the plain gradient: max abs error over
# a level's largest plain gradient.  bfloat16 outputs are rounded once on
# both sides (one ulp is 2^-8 of the magnitude); float32 ones differ by
# the order of summation (atomics on both sides).  At the train step's
# shapes (1024 rois, C=256) a cell sums up to thousands of terms of both
# signs, and the error reached 1.06e-5 of the largest on the H100, so
# the limit is 1e-4; the gpu tests (tests/test_torch_port_kernels.py,
# a few rois per image) sum tens of terms a cell and hold float32 to
# 1e-5
BWD_REL_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
ATOL_F32 = 1e-4               # the same in float32 (summation order)
MAIN = dict(batch=2, rois=1000, img=1024, channels=256,
            strides=(4, 8, 16, 32))
TRAIN = dict(batch=2, rois=512, img=1024, channels=256, max_gt=64)
# the RRoI predict's crops: 2000 proposals per image (K1 or K3), 100
# detections per image re-cropped rotated (K4)
RROI = dict(batch=2, rois=2000, img=1024, channels=256, rrois=100)
# the RRoI train step's rotated crops: 512 * 0.25 = 128 per image
RTRAIN = dict(batch=2, img=1024, channels=256, rrois=128)
# the mask branch's train crops: the 512 * 0.25 = 128 first samples per
# image at 14x14
MASK_TRAIN = dict(batch=2, rois=128, img=1024, channels=256)
# CenterMap-Net's semantic map: one float32 level at level 0's stride
# ([2, 256, 256, 256] at 1024^2), cropped at every roi of the path
SEMANTIC_STRIDES = (4,)
# the kernels' wrappers (module of aidet_tpu_torch.ops, handle) by the
# name of their entry in the kernels line
HANDLES = dict(roi_align=("roi_align", "roi_align_kernel"),
               roi_align_train_forward=("roi_align",
                                        "roi_align_train_kernel"),
               roi_align_backward=("roi_align", "roi_align_backward_kernel"),
               roi_align_bandx=("roi_align", "roi_align_bandx_kernel"),
               rroi_align=("rroi_align", "rroi_align_kernel"),
               rroi_align_backward=("rroi_align",
                                    "rroi_align_backward_kernel"))


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase(name, **fields):
    emit(dict(phase=name, elapsed_s=time.perf_counter() - T0, **fields))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def run_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs the port on a CUDA card")
    info = dict(kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(), nvidia_smi=nvidia_smi_line(),
                torch=torch.__version__, cuda=torch.version.cuda)
    phase("device", **info)
    return info


def handle(name):
    """The kernel wrapper of the kernels line's entry ``name``."""
    import importlib
    module, attr = HANDLES[name]
    return getattr(importlib.import_module(f"aidet_tpu_torch.ops.{module}"),
                   attr)


def run_build():
    """One nvcc per kernel source, all started together; every handle
    is loaded from its source's build."""
    from concurrent.futures import ThreadPoolExecutor

    from aidet_tpu_torch.cuda_build import (CSRC, HOST_SOURCES, REPO_ROOT,
                                            build_all, build_host_library,
                                            ptxas_report)
    t0 = time.perf_counter()
    handles = [handle(name) for name in HANDLES]
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(build_host_library)
        by_source = build_all({h.source for h in handles})
        host = host.result()
    for h in handles:
        h.load(by_source[h.source])
    phase("build", wall_s=time.perf_counter() - t0, libraries=[dict(
        source=str(src.relative_to(REPO_ROOT)),
        library=str(b.path.relative_to(REPO_ROOT)), nvcc_s=b.seconds,
        ptxas=ptxas_report(b.log)) for src, b in by_source.items()],
        host_library=dict(sources=[str((CSRC / s).relative_to(REPO_ROOT))
                                   for s in HOST_SOURCES],
                          library=str(host.path.relative_to(REPO_ROOT)),
                          gxx_s=host.seconds))


def main_path_rois(gen, batch, n, img):
    """Proposal-like rois [B, R, 4]: log-uniform sizes 8..512 px, aspect
    ratios 1/4..4, centres inside the image, clipped to it."""
    import torch
    u = torch.rand(batch, n, 5, generator=gen)
    size = 8.0 * 64.0 ** u[..., 0]
    ratio = 4.0 ** (2 * u[..., 1] - 1)
    w, h = size * ratio.sqrt(), size / ratio.sqrt()
    cx, cy = u[..., 2] * img, u[..., 3] * img
    rois = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return rois.clamp(0, img - 1)


def launch_counts(reset=False):
    """Every kernel's launch count by name (set to 0 first if
    ``reset``)."""
    counts = {}
    for name in HANDLES:
        h = handle(name)
        if reset:
            h.launches = 0
            if hasattr(h, "plan_launches"):   # K3's plan, counted apart
                h.plan_launches = 0
        counts[name] = h.launches
    return counts


def cuda_ms(fn, iters, warmup):
    """ms per call of ``fn`` launched eagerly, between CUDA events: the
    device time, or the host's time to enqueue a call where that is
    longer."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def capture(fn, iters, warmup):
    """A CUDA graph of ``iters`` calls of ``fn`` (after ``warmup`` eager
    ones)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_ms(graph, iters, reps=3):
    """ms per call of a graph of ``iters`` calls, replayed ``reps``
    times between CUDA events: the device's time alone, without the
    host's cost of enqueueing each launch."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def host_ms(fn, iters):
    """ms of host time per call to enqueue ``fn`` (no synchronisation
    inside the window; the launch queue holds them all)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def kernel_times(fn, iters, warmup):
    """A kernel's times per launch: ms, launched eagerly (`cuda_ms`);
    device_ms, the device's alone (`replay_ms` of a `capture`); host_ms,
    the host's to enqueue one (`host_ms`)."""
    ms = cuda_ms(fn, iters, warmup)
    graph = capture(fn, iters, warmup)
    device_ms = replay_ms(graph, iters)
    del graph
    return dict(ms=ms, device_ms=device_ms, host_ms=host_ms(fn, iters))


def cells_and_samples(feats, ys, xs, lvls, bidx):
    """(distinct feature cells that the samples (y, x) [K, n, n] of rois
    on levels ``lvls`` of images ``bidx`` read, samples inside their
    map).  A sample outside its map reads nothing; the others read their
    4 clamped bilinear corners.  The cells are what a RoIAlign forward
    must read of the pyramid: the rest of it is no input of this run's
    work."""
    import torch
    dev = ys.device
    lv = lvls.long()
    hs = torch.tensor([f.shape[1] for f in feats], device=dev)[lv]
    ws = torch.tensor([f.shape[2] for f in feats], device=dev)[lv]
    sizes = [f.shape[1] * f.shape[2] for f in feats]
    off = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                       device=dev)[lv]
    h, w = hs[:, None, None].float(), ws[:, None, None].float()
    inside = (ys >= -1) & (ys <= h) & (xs >= -1) & (xs <= w)
    y = torch.minimum(ys.clamp(min=0.0), h - 1)
    x = torch.minimum(xs.clamp(min=0.0), w - 1)
    y0, x0 = torch.floor(y), torch.floor(x)
    y1, x1 = torch.minimum(y0 + 1, h - 1), torch.minimum(x0 + 1, w - 1)
    base = (bidx.long() * sum(sizes) + off)[:, None, None]
    wl = ws[:, None, None]
    ids = torch.cat([(base + (yi * wl + xi).long())[inside]
                     for yi in (y0, y1) for xi in (x0, x1)])
    return int(torch.unique(ids).numel()), float(inside.sum())


def bound(nbytes, flops):
    """(ms, what bounds it): the larger of the bytes at the HBM rate and
    the operations at the float32 rate."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / F32_FLOPS * 1e3
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms
                                 else "operations")


def gather_bound(feats, coords, rois, lvls, bidx, out):
    """Least time for a RoIAlign forward's work on this card: the cells
    its samples read (`cells_and_samples` of ``coords``, the plain
    version's `sample_coords`), the rois and their routing (level and
    image, int32) read once and the output written once, against the
    FMAs of the samples inside their map (4 corners, 2 flops each, per
    channel)."""
    cells, samples = cells_and_samples(feats, *coords, lvls, bidx)
    c = feats[0].shape[-1]
    nbytes = (cells * c * feats[0].element_size() + rois.numel() * 4
              + 2 * lvls.numel() * 4 + out.numel() * out.element_size())
    return bound(nbytes, samples * c * 4 * 2)


def roi_align_bound(feats, rois, lvls, bidx, out, strides,
                    sampling_ratio=2):
    """`gather_bound` of the (horizontal) RoIAlign forward."""
    from aidet_tpu_torch.ops.roi_align import sample_coords
    coords = sample_coords(rois, lvls, strides, out.shape[-2],
                           sampling_ratio)
    return gather_bound(feats, coords, rois, lvls, bidx, out)


def roi_align_backward_bound(feats, rois, lvls, bidx, grad_out, strides,
                             sampling_ratio=2, coords_fn=None):
    """Least time for K2's backward (K4's with ``coords_fn`` the rotated
    `sample_coords`): grad_out, the rois and the routing read once and
    the gradient written once in its dtype; against one multiply and
    one add per corner of every sample inside its map, per channel."""
    nbytes = (grad_out.numel() * grad_out.element_size()
              + rois.numel() * 4 + 2 * lvls.numel() * 4
              + sum(f.numel() for f in feats) * feats[0].element_size())
    from aidet_tpu_torch.ops.roi_align import sample_coords
    s, c = grad_out.shape[-2], grad_out.shape[-1]
    coords = (coords_fn or sample_coords)(rois, lvls, strides, s,
                                          sampling_ratio)
    adds = cells_and_samples(feats, *coords, lvls, bidx)[1] * 4 * c
    return bound(nbytes, 2 * adds)


def backward_lists(kernel):
    """A backward's (K2's or K4's) tile lists from its last launch's
    scratch: entries, the longest list and the spread of the lengths of
    the non-empty ones, the tiles, the non-empty ones and the share of
    empty ones, and the scratch's bytes."""
    import torch
    counts = kernel.scratch[:kernel.tiles].long()
    used = counts[counts > 0].float()
    q = (torch.quantile(used, torch.tensor([0.5, 0.9, 0.99],
                                           device=used.device)).tolist()
         if used.numel() else [0.0] * 3)
    return dict(entries=int(counts.sum()), longest_list=int(counts.max()),
                tiles=int(counts.numel()), tiles_used=int(used.numel()),
                empty_share=1.0 - used.numel() / counts.numel(),
                list_p50=q[0], list_p90=q[1], list_p99=q[2],
                scratch_bytes=kernel.scratch.numel() * 4)


def main_path_inputs(gen, shape, dtype, device, strides=MAIN["strides"]):
    """Seeded levels [B, img/s, img/s, C] for each stride (the FPN's
    four, or the semantic map's one) and proposal-like rois of one
    path's ``shape`` (MAIN or TRAIN), with their routing."""
    import torch
    from aidet_tpu_torch.ops.roi_align import route_rois
    b, r, img, c = (shape[k] for k in ("batch", "rois", "img", "channels"))
    feats = [torch.randn(b, img // s, img // s, c, generator=gen)
             .to(device=device, dtype=dtype) for s in strides]
    rois_b = main_path_rois(gen, b, r, img).to(device)
    rois = rois_b.reshape(b * r, 4).contiguous()
    lvls = route_rois(rois, [f.shape[1:3] for f in feats], strides)
    bidx = torch.arange(b, dtype=torch.int32,
                        device=device).repeat_interleave(r)
    return feats, rois_b, rois, lvls, bidx


def run_forward_kernel(kernel, name, shape, sizes, device="cuda",
                       dtype_name="bfloat16", strides=MAIN["strides"],
                       plain_chunks=1):
    """A RoIAlign forward handle (K1, or K2's forward) against the
    plain version at ``shape`` for each out_size in ``sizes``, in
    ``dtype_name`` (limit ATOL_BF16 or ATOL_F32), on the levels of
    ``strides`` (the FPN's four, or the semantic map's one); returns the
    fields of its entry in the kernels line (the first size's), with its
    share of the bound (bound_ms / ms).  The plain version runs on
    ``plain_chunks`` slices of each image's rois in turn (each roi's
    crop is its own), its time the whole loop's."""
    import torch
    from aidet_tpu_torch.ops.roi_align import batched_multilevel_roi_align
    dtype = getattr(torch, dtype_name)
    atol = ATOL_BF16 if dtype == torch.bfloat16 else ATOL_F32
    feats, rois_b, rois, lvls, bidx = main_path_inputs(
        torch.Generator().manual_seed(0), shape, dtype, device, strides)
    result = None
    for s in sizes:
        out = torch.empty((rois.shape[0], s, s, shape["channels"]),
                          dtype=dtype, device=device)

        def launch():
            kernel(feats, rois, bidx, lvls, out, strides, 2, True)

        def plain():
            return torch.cat([batched_multilevel_roi_align(
                feats, part, s, strides) for part in rois_b.chunk(
                    plain_chunks, 1)], 1)

        launch()
        ref = plain()
        torch.cuda.synchronize()
        err = (out.reshape(ref.shape).float() - ref.float()).abs().max()
        err = float(err)
        if not math.isfinite(err) or err > atol:
            raise AssertionError(f"{name} s={s} {dtype_name} on "
                                 f"{len(strides)} level(s): max abs err "
                                 f"{err} > {atol} against the plain version")
        bound_ms, bound_by = roi_align_bound(feats, rois, lvls, bidx, out,
                                             strides)
        fields = dict(max_abs_err=err, **kernel_times(launch, 50, 5),
                      plain_ms=cuda_ms(plain, 5, 1), bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None)
        fields["bound_share"] = bound_ms / fields["ms"]
        phase("kernels", kernel=name, out_size=s, rois=rois.shape[0],
              levels=len(strides), channels=shape["channels"],
              img=shape["img"], dtype=dtype_name, atol=atol,
              plain_chunks=plain_chunks, **fields)
        result = result or fields
    return result


def run_backward_kernel(device="cuda", rotated=False, shape=None, s=7,
                        dtype_names=("bfloat16", "float32"),
                        strides=MAIN["strides"]):
    """K2's backward (K4's if ``rotated``) against the autograd gradient
    of the plain version at the train step's shapes (7x7: 2 x 512 rois,
    or 2 x 128 rotated rois; K2's at ``shape`` and ``s`` x ``s`` if
    given, on the levels of ``strides``), in each of ``dtype_names``,
    launched twice and both launches held to the limits; returns the
    first dtype's fields of its entry in the kernels line."""
    import torch
    from aidet_tpu_torch.ops import roi_align, rroi_align
    kernel = (rroi_align.rroi_align_backward_kernel if rotated
              else roi_align.roi_align_backward_kernel)
    plain_fn = (rroi_align.batched_rroi_align if rotated
                else roi_align.batched_multilevel_roi_align)
    label = "K4 backward" if rotated else "K2 backward"
    result = None
    for name in dtype_names:
        dtype = getattr(torch, name)
        gen = torch.Generator().manual_seed(1)
        if rotated:
            feats, rois_b, rois, lvls, bidx = rroi_train_inputs(
                gen, dtype, device, shape=shape or RTRAIN)
        else:
            feats, rois_b, rois, lvls, bidx = main_path_inputs(
                gen, shape or TRAIN, dtype, device, strides)
        shapes = [tuple(f.shape) for f in feats]
        grad_out = torch.randn(rois.shape[0], s, s, feats[0].shape[-1],
                               generator=gen).to(device=device, dtype=dtype)
        leaves = [f.detach().requires_grad_() for f in feats]
        out = plain_fn(leaves, rois_b, s, strides)

        def launch():
            return kernel(grad_out, rois, bidx, lvls, shapes, strides, 2,
                          True)

        def plain():
            return torch.autograd.grad(out, leaves,
                                       grad_out.reshape(out.shape),
                                       retain_graph=True)

        got, ref = launch(), plain()
        torch.cuda.synchronize()
        errs, limits = [], []
        for g, r in zip(got, ref):
            if g.dtype != dtype or g.shape != r.shape:
                raise AssertionError(f"{label}: {g.dtype} "
                                     f"{tuple(g.shape)} for {r.dtype} "
                                     f"{tuple(r.shape)}")
            errs.append(float((g.float() - r.float()).abs().max()))
            limits.append(BWD_REL_TOL[name] * float(r.float().abs().max()))
        if not all(math.isfinite(e) and e <= lim
                   for e, lim in zip(errs, limits)):
            raise AssertionError(f"{label} {name}: max abs err per "
                                 f"level {errs} over the limits {limits}")
        lists = backward_lists(kernel)
        again = launch()
        torch.cuda.synchronize()
        rerun = [float((a.float() - b.float()).abs().max())
                 for a, b in zip(again, got)]
        if not all(e <= lim for e, lim in zip(rerun, limits)):
            raise AssertionError(f"{label} {name}: two launches differ "
                                 f"by {rerun} per level, limits {limits}")
        rerun_err = max(rerun)
        bound_ms, bound_by = roi_align_backward_bound(
            feats, rois, lvls, bidx, grad_out, strides,
            coords_fn=rroi_align.sample_coords if rotated else None)
        fields = dict(max_abs_err=max(errs), **kernel_times(launch, 20, 3),
                      plain_ms=cuda_ms(plain, 5, 1), bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None)
        fields["bound_share"] = bound_ms / fields["ms"]
        phase("kernels", kernel=("rroi_align_backward" if rotated
                                 else "roi_align_backward"), out_size=s,
              rois=rois.shape[0], levels=len(feats),
              channels=feats[0].shape[-1], img=(shape or TRAIN)["img"],
              dtype=name,
              max_abs_err_per_level=errs,
              limit_per_level=limits, rel_tol=BWD_REL_TOL[name],
              rerun_max_abs_diff=rerun_err, lists=lists, **fields)
        result = result or fields
    return result


def run_bandx_kernel(device="cuda"):
    """K3 against its plain version at the RRoI predict's horizontal
    crops (2 x 2000 rois, 7x7), bfloat16 then float32, and its plan
    against the plan's twin (`bandx_chunks` with the kernel's budget:
    the same order and chunk table, or an error); returns the bfloat16
    fields of its entry in the kernels line.  Its times are those of
    the plan and the reduction together (the path's launches), and of
    each alone; beside them the bytes that the card's boxes stage (and
    that the twin's would stage without the budget) and the
    reduction's blocks per SM."""
    import torch
    from aidet_tpu_torch.ops.roi_align import bandx_chunks
    from aidet_tpu_torch.ops.roi_align import roi_align_bandx_kernel as k3
    from aidet_tpu_torch.ops.roi_align import roi_align_bandx_plain
    strides = MAIN["strides"]
    s = 7
    result = None
    for dtype, atol in ((torch.bfloat16, ATOL_BF16), (torch.float32,
                                                      ATOL_F32)):
        name = str(dtype).split(".")[-1]
        feats, rois_b, rois, lvls, bidx = main_path_inputs(
            torch.Generator().manual_seed(2), RROI, dtype, device)
        level_hw = [tuple(f.shape[1:3]) for f in feats]
        out = torch.empty((rois.shape[0], s, s, RROI["channels"]),
                          dtype=dtype, device=device)

        def plan():
            return k3.plan(rois, bidx, lvls, level_hw, strides,
                           RROI["batch"], s)

        planned = plan()

        def reduce():
            k3(feats, rois, bidx, lvls, planned, out, strides, 2, True)

        def launch():
            k3(feats, rois, bidx, lvls, plan(), out, strides, 2, True)

        def plain():
            return roi_align_bandx_plain(feats, rois_b, s, strides)

        launch()
        ref = plain()
        torch.cuda.synchronize()
        err = float((out.reshape(ref.shape).float() - ref.float())
                    .abs().max())
        if not math.isfinite(err) or err > atol:
            raise AssertionError(f"roi_align_bandx {name}: max abs err "
                                 f"{err} > {atol} against the plain version")
        twin = bandx_chunks(rois, bidx, lvls, level_hw, strides,
                            RROI["batch"], s, stage_cells=k3.stage_cells)
        if not (torch.equal(planned.perm.long(), twin.perm)
                and torch.equal(planned.chunks[:, :7].long(), twin.table())):
            raise AssertionError(f"roi_align_bandx {name}: the card's plan "
                                 "differs from its twin's")
        used = planned.chunks[:, 1] > 0
        cell_bytes = RROI["channels"] * out.element_size()
        staged = float((planned.chunks[used, 4].long()
                        * planned.chunks[used, 6].long()).sum()) * cell_bytes
        uncapped = bandx_chunks(rois, bidx, lvls, level_hw, strides,
                                RROI["batch"], s).box
        staged_uncapped = float((uncapped[:, 1] * uncapped[:, 3]).sum()) \
            * cell_bytes
        bound_ms, bound_by = roi_align_bound(feats, rois, lvls, bidx, out,
                                             strides)
        fields = dict(max_abs_err=err, **kernel_times(launch, 20, 3),
                      plain_ms=cuda_ms(plain, 3, 1), bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None)
        fields["bound_share"] = bound_ms / fields["ms"]
        fields["device_bound_share"] = bound_ms / fields["device_ms"]
        alone = {part: kernel_times(fn, 20, 3)
                 for part, fn in (("plan", plan), ("reduce", reduce))}
        phase("kernels", kernel="roi_align_bandx", out_size=s,
              rois=rois.shape[0], dtype=name, atol=atol,
              chunks=int(used.sum()), chunk_bound=planned.chunks.shape[0],
              plan_equals_twin=True, slice_bytes=k3.SLICE_BYTES,
              stage_bytes=k3.STAGE_BYTES, blocks_per_sm=k3.blocks_per_sm(
                  dtype), staged_bytes=staged,
              staged_bytes_uncapped=staged_uncapped,
              **{f"{part}_{key}": v for part, times in alone.items()
                 for key, v in times.items()}, **fields)
        result = result or fields
    return result


def rroi_path_inputs(gen, dtype, device, shape=RROI):
    """Seeded levels as the RRoI predict's (``shape``'s) and 2 x 100
    rotated rois drawn like its detections: centres inside the image,
    sides log-uniform over 8..512 px, thetas in [-pi/2, 0)."""
    import torch
    b, n, img, c = (shape[k] for k in ("batch", "rrois", "img", "channels"))
    feats = [torch.randn(b, img // s, img // s, c, generator=gen)
             .to(device=device, dtype=dtype) for s in MAIN["strides"]]
    u = torch.rand(b, n, 5, generator=gen)
    rrois_b = torch.stack([u[..., 0] * img, u[..., 1] * img,
                           8.0 * 64.0 ** u[..., 2], 8.0 * 64.0 ** u[..., 3],
                           -math.pi / 2 * u[..., 4]], -1).to(device)
    return feats, rrois_b


def rroi_train_inputs(gen, dtype, device, batch=None, shape=RTRAIN):
    """Seeded levels as the RRoI train step's and 2 x 128 rotated rois
    (``batch`` x 128 where given)
    drawn like its stage-1 boxes under random weights: centres inside
    the image, sides log-uniform over 2..1024 px (the clip the loss
    applies; a 1024-px side spans all 32 cells of level 3), any theta
    in [-pi, pi); with their routing (no window bump, as the path)."""
    import torch
    from aidet_tpu_torch.ops.rroi_align import route_rrois
    b, n, img, c = (shape[k] for k in ("batch", "rrois", "img",
                                       "channels"))
    b = batch or b
    feats = [torch.randn(b, img // s, img // s, c, generator=gen)
             .to(device=device, dtype=dtype) for s in MAIN["strides"]]
    u = torch.rand(b, n, 5, generator=gen)
    rrois_b = torch.stack([u[..., 0] * img, u[..., 1] * img,
                           2.0 * 512.0 ** u[..., 2], 2.0 * 512.0 ** u[..., 3],
                           math.pi * (2 * u[..., 4] - 1)], -1).to(device)
    rrois = rrois_b.reshape(b * n, 5).contiguous()
    lvls = route_rrois(rrois, [f.shape[1:3] for f in feats],
                       MAIN["strides"])
    bidx = torch.arange(b, dtype=torch.int32,
                        device=device).repeat_interleave(n)
    return feats, rrois_b, rrois, lvls, bidx


def run_rroi_kernel(device="cuda", shape=RROI, dtypes=("bfloat16",
                                                       "float32"),
                    bumps=(False, True)):
    """K4 against its plain version at the RRoI predict's rotated crops
    (2 x 100 rrois, 7x7; the levels of ``shape``), routed without and
    with the TPU kernel's window bump (``bumps``), in each of
    ``dtypes``; returns the fields of its entry in the kernels line (the
    first dtype's, the first bump's: bfloat16, no bump, the path's)."""
    import torch
    from aidet_tpu_torch.ops.rroi_align import (batched_rroi_align,
                                                route_rrois,
                                                rroi_align_kernel,
                                                sample_coords)
    strides = MAIN["strides"]
    s = 7
    result = None
    for name in dtypes:
        dtype = getattr(torch, name)
        atol = ATOL_BF16 if dtype == torch.bfloat16 else ATOL_F32
        feats, rrois_b = rroi_path_inputs(torch.Generator().manual_seed(3),
                                          dtype, device, shape)
        b, r = rrois_b.shape[:2]
        rrois = rrois_b.reshape(b * r, 5).contiguous()
        bidx = torch.arange(b, dtype=torch.int32,
                            device=device).repeat_interleave(r)
        for bump in bumps:
            lvls = route_rrois(rrois, [f.shape[1:3] for f in feats],
                               strides, bump_to_window=bump)
            out = torch.empty((b * r, s, s, shape["channels"]),
                              dtype=dtype, device=device)

            def launch():
                rroi_align_kernel(feats, rrois, bidx, lvls, out, strides, 2,
                                  True)

            def plain():
                return batched_rroi_align(feats, rrois_b, s, strides,
                                          bump_to_window=bump)

            launch()
            ref = plain()
            torch.cuda.synchronize()
            err = float((out.reshape(ref.shape).float() - ref.float())
                        .abs().max())
            if not math.isfinite(err) or err > atol:
                raise AssertionError(f"rroi_align {name} bump={bump}: max "
                                     f"abs err {err} > {atol} against the "
                                     "plain version")
            coords = sample_coords(rrois, lvls, strides, s)
            bound_ms, bound_by = gather_bound(feats, coords, rrois, lvls,
                                              bidx, out)
            fields = dict(max_abs_err=err, **kernel_times(launch, 50, 5),
                          plain_ms=cuda_ms(plain, 5, 1), bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
            fields["bound_share"] = bound_ms / fields["ms"]
            phase("kernels", kernel="rroi_align", out_size=s, rrois=b * r,
                  channels=shape["channels"], img=shape["img"], dtype=name,
                  bump_to_window=bump, atol=atol, **fields)
            result = result or fields
    return result


def run_kernels():
    """Every kernel of the paths against its plain version; returns the
    fields of each one's entry in the kernels line, by name."""
    from aidet_tpu_torch.ops.roi_align import (roi_align_kernel,
                                               roi_align_train_kernel)
    # K1 at the RRoI predict's 2 x 2000 proposals too, and K2 at the
    # mask branch's 14x14 on 2 x 128 rois (phase lines)
    run_forward_kernel(roi_align_kernel, "roi_align", RROI, (7,))
    run_forward_kernel(roi_align_train_kernel, "roi_align_train_forward",
                       MASK_TRAIN, (14,))
    run_backward_kernel(shape=MASK_TRAIN, s=14)
    run_centermap_kernels(roi_align_kernel, roi_align_train_kernel)
    run_e2e_kernels(roi_align_kernel, roi_align_train_kernel)
    run_hbb_kernels(roi_align_kernel, roi_align_train_kernel)
    run_slice14_kernels(roi_align_kernel, roi_align_train_kernel)
    return dict(
        roi_align=run_forward_kernel(roi_align_kernel, "roi_align", MAIN,
                                     (7, 14)),
        roi_align_train_forward=run_forward_kernel(
            roi_align_train_kernel, "roi_align_train_forward", TRAIN, (7,)),
        roi_align_backward=run_backward_kernel(),
        roi_align_bandx=run_bandx_kernel(),
        rroi_align=run_rroi_kernel(),
        rroi_align_backward=run_backward_kernel(rotated=True))


def run_centermap_kernels(k1, k2_forward):
    """K1 and K2 at the CenterMap path's own shapes and dtype (float32),
    each against the plain version, with its bound, on its own line.
    Four FPN levels: K1 at 7x7 on 2 x 2000 proposals and at 14x14 on
    2 x 1000 detections (predict), K2's forward at 7x7 on 2 x 512
    sampled rois and at 14x14 on 2 x 128 positives (train).  One level,
    the semantic map ([2, 256, 256, 256] at stride 4) cropped at the
    same rois: K1 (predict), and K2's forward and backward (train)."""
    for strides in (MAIN["strides"], SEMANTIC_STRIDES):
        run_forward_kernel(k1, "roi_align", RROI, (7,),
                           dtype_name="float32", strides=strides)
        run_forward_kernel(k1, "roi_align", MAIN, (14,),
                           dtype_name="float32", strides=strides)
        run_forward_kernel(k2_forward, "roi_align_train_forward", TRAIN,
                           (7,), dtype_name="float32", strides=strides)
        run_forward_kernel(k2_forward, "roi_align_train_forward",
                           MASK_TRAIN, (14,), dtype_name="float32",
                           strides=strides)
    for shape, s in ((TRAIN, 7), (MASK_TRAIN, 14)):
        run_backward_kernel(shape=shape, s=s, dtype_names=("float32",),
                            strides=SEMANTIC_STRIDES)


# the r18_e2e recipe's shapes: 512^2, its FPN at 128 channels, float32
E2E_PREDICT = dict(batch=2, rois=2000, img=512, channels=128)
E2E_TRAIN = dict(batch=2, rois=512, img=512, channels=128)
E2E_RROI = dict(batch=2, rrois=100, img=512, channels=128)
E2E_RTRAIN = dict(batch=2, rrois=128, img=512, channels=128)


def run_e2e_kernels(k1, k2_forward):
    """K1, K2 (forward and backward) and K4 (forward and backward) at
    the r18_e2e paths' shapes (`E2E_PREDICT`, `E2E_TRAIN`, `E2E_RROI`,
    `E2E_RTRAIN`: C=128, float32, 7x7), each against its plain version
    with its bound, on its own line."""
    run_forward_kernel(k1, "roi_align", E2E_PREDICT, (7,),
                       dtype_name="float32")
    run_forward_kernel(k2_forward, "roi_align_train_forward", E2E_TRAIN,
                       (7,), dtype_name="float32")
    run_backward_kernel(shape=E2E_TRAIN, dtype_names=("float32",))
    run_rroi_kernel(shape=E2E_RROI, dtypes=("float32",), bumps=(False,))
    run_backward_kernel(rotated=True, shape=E2E_RTRAIN,
                        dtype_names=("float32",))


def run_reference(device="cuda"):
    """Small flagship (float32) on ``device`` against the same weights
    and images on the CPU: equal labels and valid, boxes and rboxes
    within 1 px, scores within 1e-2."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from aidet_tpu_torch.flagship import build_flagship
    img = 256
    imgs = torch.randint(0, 256, (2, img, img, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    shapes = torch.full((2, 2), float(img))
    outs = [build_flagship(img, small=True, device=d).predict(
        imgs.to(d), shapes.to(d)) for d in (device, "cpu")]
    got, ref = ({k: v.cpu() for k, v in o.items()} for o in outs)
    limits = dict(boxes=1.0, rboxes=1.0, theta=1e-2, scores=1e-2)
    errs = match_detections(got, ref, limits)
    phase("reference", model="small flagship float32", img=img,
          n_valid=int(got["valid"].sum()), max_abs_err=errs, limits=limits)


def run_rroi_reference(device="cuda"):
    """Small RBBoxRCNNRRoI (float32) on ``device`` against the same
    weights and images on the CPU: equal valid counts, every detection
    paired by label with scores within 1e-2, boxes within 1 px, refined
    rboxes within 1 px plus 1e-4 of their largest coordinate (random
    weights decode boxes thousands of pixels wide) and theta within
    1e-2, the rboxes compared where the first-stage quad is clear of a
    tie (`rbox_clear_of_ties`), and a detection at the 20-per-image cut
    whose score ties the other run's last within 1e-2 may be another
    member of the tie."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from aidet_tpu_torch.rroi import build_rroi
    img = 256
    imgs = torch.randint(0, 256, (2, img, img, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    shapes = torch.full((2, 2), float(img))
    models = [build_rroi(img, small=True, device=d) for d in (device, "cpu")]
    got, ref = ({k: v.cpu() for k, v in m.predict(
        imgs.to(d), shapes.to(d)).items()}
        for m, d in zip(models, (device, "cpu")))
    clear = rbox_clear_of_ties(first_stage_quads(models[1], imgs, shapes))
    limits = dict(boxes=1.0, rboxes=1.0, rboxes_rel=1e-4, theta=1e-2,
                  scores=1e-2)
    errs = match_detections(got, ref, limits, rbox_clear=clear,
                            cut_slack=True)
    n_valid = int(got["valid"].sum())
    n_clear = int((clear & ref["valid"]).sum())
    if n_clear < n_valid / 2:
        raise AssertionError(f"rroi_reference: only {n_clear} of {n_valid} "
                             "first-stage quads are clear of a tie")
    phase("rroi_reference", model="small RBBoxRCNNRRoI float32", img=img,
          n_valid=n_valid, n_rbox_compared=n_clear, max_abs_err=errs,
          limits=limits)


def match_detections(got, ref, limits, rbox_clear=None, max_unpaired=0,
                     cut_slack=False):
    """Pair every valid detection of ``got`` with one of ``ref`` of the
    same image and label whose score, box, rbox centre and size (px)
    and theta are within ``limits`` (with "rboxes_rel", the rbox limit
    grows by that share of the rbox's largest coordinate; without
    "rboxes", only scores and boxes, of any width, are held; with
    "masks", each pair's largest mask difference too); raise if the
    valid counts differ or more than ``max_unpaired`` detections find no
    partner.  Detections whose scores differ by less than the two runs'
    rounding may come out in either order, so partners are searched
    for, not taken by position.  ``rbox_clear`` [B, K] (bool, over
    ``ref``'s detections): where False, the rbox is not compared (see
    `rbox_clear_of_ties`).  ``cut_slack``: a detection without a partner
    whose score is within the score limit of ``ref``'s lowest kept
    score of its image is excused (counted as "at_cut"): at the
    max_per_img cut, two runs may keep different members of a tie.
    Returns the largest differences over the pairs, the counts of
    detections without a partner, and for up to 8 of those the
    differences to the nearest box of their label ("nearest")."""
    rel = limits.get("rboxes_rel", 0.0)
    keys = [k for k in limits if k != "rboxes_rel"]
    errs = dict.fromkeys(keys, 0.0)
    unpaired = at_cut = 0
    nearest = []
    for b in range(got["valid"].shape[0]):
        gi = got["valid"][b].nonzero().flatten().tolist()
        ri = ref["valid"][b].nonzero().flatten().tolist()
        if len(gi) != len(ri):
            raise AssertionError(f"image {b} has {len(gi)} detections, "
                                 f"the run it is held to {len(ri)}")
        cut = float(ref["scores"][b, ri].float().min()) if ri else 0.0
        free = set(ri)
        for i in gi:
            best = near = None
            for j in free:
                if got["labels"][b, i] != ref["labels"][b, j]:
                    continue
                d = dict(
                    scores=abs(float(got["scores"][b, i]
                                     - ref["scores"][b, j])),
                    boxes=float((got["boxes"][b, i]
                                 - ref["boxes"][b, j]).abs().max()))
                if "masks" in limits:
                    d["masks"] = float((got["masks"][b, i].float()
                                        - ref["masks"][b, j].float())
                                       .abs().max())
                lim = dict(limits)
                if "rboxes" in limits:
                    d.update(
                        rboxes=float((got["rboxes"][b, i, :4]
                                      - ref["rboxes"][b, j, :4]).abs().max()),
                        theta=abs(float(got["rboxes"][b, i, 4]
                                        - ref["rboxes"][b, j, 4])))
                    lim["rboxes"] += rel * float(
                        ref["rboxes"][b, j, :4].abs().max())
                    if rbox_clear is not None \
                            and not bool(rbox_clear[b, j]):
                        d.update(rboxes=0.0, theta=0.0)
                if near is None or d["boxes"] < near["boxes"]:
                    near = dict(d, rbox_limit=lim.get("rboxes"))
                if all(d[k] <= lim[k] for k in keys) and (
                        best is None or d["scores"] < best[1]["scores"]):
                    best = (j, d)
            if best is None:
                if cut_slack and float(got["scores"][b, i]) \
                        <= cut + limits["scores"]:
                    at_cut += 1
                    continue
                unpaired += 1
                if len(nearest) < 8:
                    nearest.append(dict(image=b, index=i, nearest=near))
                if unpaired > max_unpaired:
                    raise AssertionError(
                        f"detection {i} of image {b} (score "
                        f"{float(got['scores'][b, i])}, label "
                        f"{int(got['labels'][b, i])}) has no partner in "
                        f"the run it is held to ({unpaired} so far; "
                        f"nearest {nearest})")
                continue
            free.discard(best[0])
            errs = {k: max(errs[k], best[1][k]) for k in errs}
    return dict(errs, unpaired=unpaired, at_cut=at_cut, nearest=nearest)


def rbox_clear_of_ties(quads, gap=1e-3):
    """[B, K] bool: the first-stage pointobbs [B, K, 8] whose smallest
    candidate rectangle in `pointobb2thetaobb` is ``gap`` (relative)
    below the next.  Random weights decode self-intersecting quads whose two
    smallest candidates tie; two runs a rounding apart may then pick
    the other edge (the same rectangle with theta shifted by pi/2 and
    w, h swapped) and re-crop and refine it differently, so their
    refined rboxes are not comparable."""
    import torch
    pts = quads.double().reshape(quads.shape[:2] + (4, 2))
    e = torch.roll(pts, -1, -2) - pts
    ang = torch.atan2(e[..., 1], e[..., 0])[..., None]      # [B, K, 4, 1]
    x, y = pts[..., None, :, 0], pts[..., None, :, 1]       # [B, K, 1, 4]
    u = x * torch.cos(ang) + y * torch.sin(ang)
    v = -x * torch.sin(ang) + y * torch.cos(ang)
    area = ((u.amax(-1) - u.amin(-1)) * (v.amax(-1) - v.amin(-1))).sort(-1)
    a = area.values
    return (a[..., 1] - a[..., 0]) > gap * a[..., 0].clamp(min=1e-9)


def first_stage_quads(model, imgs, shapes):
    """The first-stage pointobbs of an RBBoxRCNNRRoI: its predict with
    the refinement head taken off for the call."""
    head, model.rbbox_refine_head = model.rbbox_refine_head, None
    try:
        return model.predict(imgs, shapes)["rboxes"]
    finally:
        model.rbbox_refine_head = head


def run_predict(device="cuda", small=False, calls=3, batch=2, seed=0):
    """Drive the flagship's predict ``calls`` times on ``batch`` seeded
    random uint8 images; check the outputs and the launch counts (K1
    once per call on the card, none on the CPU, where the plain version
    runs; K2 never).  Returns the phase's fields."""
    import torch
    from aidet_tpu_torch.flagship import build_flagship
    img = 256 if small else 1024
    model = build_flagship(img, small=small, device=device, seed=seed)
    imgs = torch.randint(0, 256, (batch, img, img, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))
    imgs = imgs.to(device)
    shapes = torch.full((batch, 2), float(img), device=device)
    on_card = torch.device(device).type == "cuda"
    k = model.test_cfg["rcnn"]["max_per_img"]
    shapes_want = dict(boxes=(batch, k, 4), rboxes=(batch, k, 5),
                       scores=(batch, k), labels=(batch, k),
                       valid=(batch, k))

    launch_counts(reset=True)
    times = []
    for _ in range(calls):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.predict(imgs, shapes)
        if on_card:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for key, shape in shapes_want.items():
            if tuple(out[key].shape) != shape:
                raise AssertionError(f"predict: {key} shape "
                                     f"{tuple(out[key].shape)} != {shape}")
        for key in ("boxes", "rboxes", "scores"):
            if not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"predict: {key} not finite")
    launches = launch_counts()
    want = dict.fromkeys(HANDLES, 0)
    want["roi_align"] = calls if on_card else 0
    if launches != want:
        raise AssertionError(f"predict: launches {launches} in {calls} "
                             f"calls, expected {want}")
    steady = times[1:] or times
    ms = sum(steady) / len(steady)
    return dict(img=img, batch=batch, calls=calls,
                dtype=str(next(model.parameters()).dtype),
                first_call_ms=times[0], ms_per_call=ms,
                images_per_s=batch * 1e3 / ms, launches=launches,
                n_valid=int(out["valid"].sum()))


def run_rroi_predict(device="cuda", small=False, calls=3, batch=2, seed=0,
                     band="1"):
    """Drive the RBBoxRCNNRRoI predict ``calls`` times on ``batch``
    seeded random uint8 images with AIDET_ROI_BAND=``band`` for the
    calls; check the outputs and the launch counts (on the card K4 once
    per call, and K1 once per call, or K3 under band "x" in bfloat16;
    none on the CPU, where the plain versions run).  Returns (the
    phase's fields, the model, the images, their shapes, the last
    call's outputs)."""
    import os
    import torch
    from aidet_tpu_torch.rroi import build_rroi
    img = 256 if small else RROI["img"]
    model = build_rroi(img, small=small, device=device, seed=seed)
    imgs = torch.randint(0, 256, (batch, img, img, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))
    imgs = imgs.to(device)
    shapes = torch.full((batch, 2), float(img), device=device)
    on_card = torch.device(device).type == "cuda"
    k = model.test_cfg["rcnn"]["max_per_img"]
    shapes_want = dict(boxes=(batch, k, 4), rboxes=(batch, k, 5),
                       scores=(batch, k), labels=(batch, k),
                       valid=(batch, k))
    before = os.environ.get("AIDET_ROI_BAND")
    os.environ["AIDET_ROI_BAND"] = band
    try:
        launch_counts(reset=True)
        times = []
        for _ in range(calls):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.predict(imgs, shapes)
            if on_card:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            for key, shape in shapes_want.items():
                if tuple(out[key].shape) != shape:
                    raise AssertionError(f"rroi_predict: {key} shape "
                                         f"{tuple(out[key].shape)} != "
                                         f"{shape}")
            for key in ("boxes", "rboxes", "scores"):
                if not bool(torch.isfinite(out[key]).all()):
                    raise AssertionError(f"rroi_predict: {key} not finite")
        launches = launch_counts()
    finally:
        if before is None:
            del os.environ["AIDET_ROI_BAND"]
        else:
            os.environ["AIDET_ROI_BAND"] = before
    want = dict.fromkeys(HANDLES, 0)
    if on_card:
        bandx = band == "x" and model.dtype == torch.bfloat16
        want["roi_align_bandx" if bandx else "roi_align"] = calls
        want["rroi_align"] = calls
    plans = handle("roi_align_bandx").plan_launches
    if launches != want or plans != want["roi_align_bandx"]:
        raise AssertionError(f"rroi_predict: launches {launches} and "
                             f"{plans} of K3's plan in {calls} calls, "
                             f"expected {want} and K3's count")
    steady = times[1:] or times
    ms = sum(steady) / len(steady)
    fields = dict(img=img, batch=batch, calls=calls, roi_band=band,
                  dtype=str(next(model.parameters()).dtype),
                  first_call_ms=times[0], call_ms=times, ms_per_call=ms,
                  images_per_s=batch * 1e3 / ms, launches=launches,
                  bandx_plan_launches=plans, n_valid=int(out["valid"].sum()))
    return fields, model, imgs, shapes, out


# The first stage's pointobb regression of the small RBBoxRCNNRRoI in
# rroi_reference_train, as a trained one would be: its weight scaled by
# 0.01 and a bias per class that moves each corner along its side by
# 0.2 of the roi's w or h.  Random weights decode quads whose two
# candidate rectangles in `pointobb2thetaobb` nearly tie, and two runs
# a rounding apart (card and CPU) may pick different ones; the
# parallelogram's candidates do not tie.
POINTOBB_BIAS = (0.2, 0.0, 0.0, 0.2, -0.2, 0.0, 0.0, -0.2)


def build_train_model(model, img, device, small=True, train_cfg=None,
                      seed=0):
    """The training build of ``model`` ("flagship" or "rroi") and the
    encode of its gt rboxes."""
    import torch
    if model == "flagship":
        from aidet_tpu_torch.flagship import build_flagship
        return build_flagship(img, small=small, device=device, train=True,
                              train_cfg=train_cfg, seed=seed), "thetaobb"
    from aidet_tpu_torch.rroi import build_rroi
    net = build_rroi(img, small=small, device=device, train=True,
                     train_cfg=train_cfg, seed=seed)
    if small:
        reg = net.rbbox_head.fc_reg
        with torch.no_grad():
            reg.weight.mul_(0.01)
            reg.bias.copy_(torch.tensor(POINTOBB_BIAS).repeat(
                reg.bias.numel() // len(POINTOBB_BIAS)))
    return net, "pointobb"


def train_step_once(device, img, n_gt, train_cfg, seed=0, model="flagship"):
    """One train step of the small ``model`` (float32) on ``device``;
    returns (metrics as floats, parameters before, after), on the
    CPU."""
    import torch
    from aidet_tpu_torch.flagship import synthetic_train_batch
    from aidet_tpu_torch.parallel.train import (build_lr_schedule,
                                                build_optimizer,
                                                create_train_state,
                                                make_train_step)
    net, encode = build_train_model(model, img, device, train_cfg=train_cfg,
                                    seed=seed)
    params = list(net.parameters())
    before = [p.detach().cpu().clone() for p in params]
    optimizer = build_optimizer(build_lr_schedule(base_lr=0.02))
    state = create_train_state(net, optimizer)
    step = make_train_step(net, optimizer)
    batch = synthetic_train_batch(2, img, n_gt, seed, device, encode)
    _, metrics = step(state, batch,
                      torch.Generator(device=device).manual_seed(seed))
    return ({k: float(v) for k, v in metrics.items()}, before,
            [p.detach().cpu() for p in params])


def compare_steps(name, got, ref, limits=None, resolved_only=False):
    """Two train steps from the same weights (each `train_step_once`'s
    (metrics, before, after)): each metric's relative difference, the
    difference of the parameters' updates as a whole (relative L2 norm)
    and per leaf (over the leaf's largest update), held to ``limits``
    (losses_rel, update_rel_l2, leaf_over_largest) if given.  With
    ``resolved_only``, a leaf whose largest update is under
    `UPDATE_RESOLUTION` float32 ulps of its largest weight is left out
    of the per-leaf check and counted in ``leaves_below_resolution``:
    there one ulp of a weight, a rounding on either side, is more than
    1/128 of the update, near the 1e-2 limit.  Returns them."""
    import torch
    rel = {k: abs(got[0][k] - ref[0][k]) / max(abs(ref[0][k]), 1e-6)
           for k in ref[0]}
    if limits and not all(math.isfinite(got[0][k])
                          and rel[k] <= limits["losses_rel"]
                          for k in ref[0]):
        raise AssertionError(f"{name}: {got[0]} against {ref[0]} "
                             f"(relative {rel})")
    worst, diff2, ref2, below = (0.0, 0), 0.0, 0.0, 0
    for i, (gb, ga, rb, ra) in enumerate(zip(*got[1:], *ref[1:])):
        if not torch.equal(gb, rb):
            raise AssertionError(f"{name}: initial weights differ")
        d_ref = ra - rb
        d = (ga - gb) - d_ref
        diff2 += float(d.double().square().sum())
        ref2 += float(d_ref.double().square().sum())
        largest = float(d_ref.abs().max())
        if resolved_only and largest < UPDATE_RESOLUTION * float(
                torch.finfo(torch.float32).eps * rb.abs().max()):
            below += 1
            continue
        err = float(d.abs().max()) / max(largest, 1e-30)
        worst = max(worst, (err, i))
    update_rel = math.sqrt(diff2 / ref2)
    if limits and (update_rel > limits["update_rel_l2"]
                   or worst[0] > limits["leaf_over_largest"]):
        raise AssertionError(f"{name}: the update differs by "
                             f"{update_rel} (relative L2), {worst[0]} of "
                             f"the largest in leaf {worst[1]} (limits "
                             f"{limits})")
    out = dict(max_rel_err=max(rel.values()), update_rel_l2=update_rel,
               worst_leaf=worst[1], worst_leaf_err_over_largest=worst[0],
               limits=limits)
    if resolved_only:
        out["leaves_below_resolution"] = below
    return out


def plain_versions():
    """A context in which `TwoStageDetector` crops with the plain
    RoIAlign and rotated RoIAlign (torch ops and autograd) in place of
    the kernels, on any device."""
    import contextlib
    from aidet_tpu_torch.models.detectors import two_stage
    from aidet_tpu_torch.ops import roi_align, rroi_align

    @contextlib.contextmanager
    def swap():
        saved = two_stage.roi_align_forward, two_stage.rroi_align_forward

        def plain(*args, train=False, **kwargs):   # train picks a handle
            return roi_align.batched_multilevel_roi_align(*args, **kwargs)
        two_stage.roi_align_forward = plain
        two_stage.rroi_align_forward = rroi_align.batched_rroi_align
        try:
            yield
        finally:
            two_stage.roi_align_forward, two_stage.rroi_align_forward = saved
    return swap()


def run_reference_train(device="cuda", model="flagship"):
    """The small ``model``'s train step (float32; "flagship" or "rroi",
    the RBBoxRCNNRRoI with its first stage's regression set as
    `POINTOBB_BIAS` says) on ``device`` against the same step on the
    CPU, under a train_cfg that keeps every candidate (so both sample
    the same rois): each loss and grad_norm within 1e-3 relative; the
    parameters' update as a whole within 1e-3 (relative L2 norm of the
    difference), and each parameter's within 1e-2 of its largest
    update.

    For the RBBoxRCNNRRoI the step also runs on ``device`` with the
    plain versions in place of the kernels (`plain_versions`), and the
    kernels' step is held to it: the losses within 1e-4 relative, the
    update within 1e-4 relative L2 and each leaf within 1e-3 of its
    largest; the plain versions' step against the CPU's is reported.
    That 1e-4 check is the one that catches a kernel's fault: a backward
    that loses one value of the crops' gradient moves the update by
    1.24e-3 relative L2 (tests/test_torch_port_train_rroi.py plants it
    on the CPU).  The update's whole against the CPU's is held to 2e-3,
    not 1e-3, which only bounds the card's float32 drift: on the NVIDIA
    H100 80GB HBM3, 700.00 W it read 1.0996e-3 with the kernels and
    1.0996e-3 with the plain versions on the card (the kernels against
    the plain versions: 1.85e-6), so the difference is the rest of the
    model's float32 arithmetic on the card (the flagship's reads
    5.0e-4)."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from aidet_tpu_torch.flagship import keep_every_candidate_cfg
    img, n_gt = 256, 8
    net = build_train_model(model, img, "cpu")[0]
    max_num = net.train_cfg["rpn_proposal"]["max_num"]
    cfg = keep_every_candidate_cfg(img, n_gt, max_num)
    got = train_step_once(device, img, n_gt, cfg, model=model)
    ref = train_step_once("cpu", img, n_gt, cfg, model=model)
    names = [n for n, _ in net.named_parameters()]
    if model == "flagship":
        name, title = "reference_train", "small flagship float32"
        limits = dict(losses_rel=1e-3, update_rel_l2=1e-3,
                      leaf_over_largest=1e-2)
    else:
        name, title = "rroi_reference_train", "small RBBoxRCNNRRoI float32"
        limits = dict(losses_rel=1e-3, update_rel_l2=2e-3,
                      leaf_over_largest=1e-2)
    cpu = compare_steps(name, got, ref, limits)
    cpu["worst_leaf"] = names[cpu["worst_leaf"]]
    fields = dict(losses_card=got[0], losses_cpu=ref[0], **cpu)
    if model == "rroi":
        with plain_versions():
            plain = train_step_once(device, img, n_gt, cfg, model=model)
        k = compare_steps(f"{name} (kernels against plain versions)", got,
                          plain, dict(losses_rel=1e-4, update_rel_l2=1e-4,
                                      leaf_over_largest=1e-3))
        k["worst_leaf"] = names[k["worst_leaf"]]
        fields["kernels_against_plain_on_card"] = k
        c = compare_steps(f"{name} (plain versions against the CPU)",
                          plain, ref)
        c["worst_leaf"] = names[c["worst_leaf"]]
        fields["plain_on_card_against_cpu"] = c
    phase(name, model=title, img=img, gts=n_gt, **fields)


def run_train(device="cuda", small=False, steps=3, batch=2, seed=0,
              model="flagship"):
    """Drive the train step of ``model`` ("flagship", or "rroi": the
    RBBoxRCNNRRoI with pointobb gts): 1 warm-up step, then ``steps``
    timed ones on a synthetic batch; check that every loss is finite,
    that the parameters moved, and the launch counts (per timed step on
    the card K2's forward and backward once, and for the RRoI model K4's
    forward and backward once; none on the CPU, where the plain versions
    run; K1 and K3 never).  Returns the phase's fields."""
    import torch
    from aidet_tpu_torch.flagship import synthetic_train_batch
    from aidet_tpu_torch.parallel.train import (build_lr_schedule,
                                                build_optimizer,
                                                create_train_state,
                                                make_train_step)
    img = 256 if small else TRAIN["img"]
    max_gt = 16 if small else TRAIN["max_gt"]
    on_card = torch.device(device).type == "cuda"
    net, encode = build_train_model(model, img, device, small=small,
                                    seed=seed)
    params = list(net.parameters())
    before = [p.detach().clone() for p in params]
    optimizer = build_optimizer(build_lr_schedule(base_lr=0.02))
    state = create_train_state(net, optimizer)
    step = make_train_step(net, optimizer)
    data = synthetic_train_batch(batch, img, max_gt, seed, device, encode)
    gen = torch.Generator(device=device).manual_seed(seed)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = step(state, data, gen)
    first_ms = (time.perf_counter() - t0) * 1e3

    launch_counts(reset=True)
    times = []
    for _ in range(steps):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, data, gen)
        if on_card:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
        if bad:
            raise AssertionError(f"train: {bad} not finite")
    launches = launch_counts()
    kernels = ["roi_align_train_forward", "roi_align_backward"]
    if model == "rroi":
        kernels += ["rroi_align", "rroi_align_backward"]
    lists = ({k: backward_lists(handle(k)) for k in kernels
              if k.endswith("backward")} if on_card else None)
    want = dict.fromkeys(HANDLES, 0)
    want.update(dict.fromkeys(kernels, steps if on_card else 0))
    if launches != want:
        raise AssertionError(f"{model} train: launches {launches} in "
                             f"{steps} steps, expected {want}")
    # every parameter of the heads must move; elsewhere a parameter
    # that is zero and gets no gradient stays (the frozen stages' FrozenBN
    # biases, and an FPN level whose anchors all lie across the border)
    names = [n for n, _ in net.named_parameters()]
    still = [n for n, a, p in zip(names, before, params)
             if torch.equal(a, p.detach())]
    if any(n.split(".")[0].endswith("_head") for n in still):
        raise AssertionError(f"{model} train: parameters did not move: "
                             f"{still}")
    moved = len(params) - len(still)
    ms = sum(times) / len(times)
    return dict(img=img, batch=batch, max_gt=max_gt, steps=steps,
                param_dtype=str(params[0].dtype),
                compute_dtype=str(net.compute_dtype),
                first_step_ms=first_ms, step_ms=times, ms_per_step=ms,
                images_per_s=batch * 1e3 / ms,
                peak_memory_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                                 if on_card else None),
                metrics={k: float(v) for k, v in metrics.items()},
                params_moved=moved, launches=launches,
                backward_lists=lists)


def run_rroi_train(device="cuda", small=False, steps=3, batch=2, seed=0):
    """`run_train` of the RBBoxRCNNRRoI."""
    return run_train(device, small, steps, batch, seed, model="rroi")


# Scene serving: a 3072^2 scene cut into 1024^2 patches at 200 px
# overlap is 16 patches, one batch-16 predict (bench.py's
# measure_scene_e2e); the card-against-CPU check cuts a 1024^2 scene
# into 512^2 patches at 100 px (9 patches) for the small flagship
SCENE = dict(size=3072, patch=1024, overlap=200, objects=200)
SCENE_SMALL = dict(size=512, patch=256, overlap=56, objects=12)
SCENE_REF = dict(size=1024, patch=512, overlap=100, objects=40)
# merged detections of the small float32 flagship, card against CPU:
# the reference phase's limits, on all 8 quad coordinates
SCENE_REF_LIMITS = dict(boxes=1.0, scores=1e-2)
SCENE_MAP_TOL = 1e-6
SCENE_NOTE = ("random weights: the mAP is a plumbing check of "
              "lift, merge and eval, not a quality figure")


def synth_scene(seed, size, n_objects):
    """A seeded uint8 BGR scene [size, size, 3] and its ground truth:
    a textured background with ``n_objects`` rotated rectangles, sides
    10-160 px and aspect 1-4, theta in [-pi/2, 0), labels over the 15
    DOTA classes (0-based), each filled by a half-plane test over its
    bounding box (numpy alone: the card's machine has no OpenCV).
    Returns (scene, dict(boxes [M, 8] quads, labels [M], difficult
    [M]))."""
    import numpy as np
    rs = np.random.RandomState(seed)
    img = rs.randint(50, 90, (size, size, 3)).astype(np.uint8)
    quads, labels = [], rs.randint(0, 15, n_objects)
    for _ in range(n_objects):
        h = rs.uniform(10, 160 / 2)
        w = min(h * rs.uniform(1.0, 4.0), 160.0)
        theta = rs.uniform(-np.pi / 2, 0)
        half = np.hypot(w, h) / 2 + 2
        cx, cy = rs.uniform(half, size - half, 2)
        c, s = np.cos(theta), np.sin(theta)
        dx = np.array([-w, w, w, -w]) / 2
        dy = np.array([-h, -h, h, h]) / 2
        q = np.stack([cx + c * dx - s * dy, cy + s * dx + c * dy], -1)
        x0, y0 = np.floor(q.min(0)).astype(int)
        x1, y1 = np.ceil(q.max(0)).astype(int) + 1
        ys, xs = np.mgrid[y0:y1, x0:x1]
        e = np.roll(q, -1, 0) - q                             # [4, 2]
        cross = (e[:, None, None, 0] * (ys - q[:, None, None, 1])
                 - e[:, None, None, 1] * (xs - q[:, None, None, 0]))
        inside = (cross >= 0).all(0) | (cross <= 0).all(0)
        img[y0:y1, x0:x1][inside] = rs.randint(120, 255, 3)
        quads.append(q.reshape(8))
    gt = dict(boxes=np.asarray(quads, np.float32), labels=labels,
              difficult=np.zeros(n_objects, bool))
    return img, gt


def lift(out):
    """Predict's outputs to the host, each patch's thetaobbs as quads:
    the merge's input dicts."""
    import torch
    from aidet_tpu_torch.data.np_rboxes import thetaobb2pointobb
    host = {k: (out[k].float() if out[k].dtype == torch.bfloat16
                else out[k]).cpu().numpy()
            for k in ("rboxes", "scores", "labels", "valid")}
    quads = thetaobb2pointobb(host["rboxes"])
    return [dict(boxes=quads[i], scores=host["scores"][i],
                 labels=host["labels"][i], valid=host["valid"][i])
            for i in range(len(quads))]


def merge(dets, offsets, workers=None):
    """One scene's patch detections merged by per-class rotated NMS
    (``workers``: `merge_patch_detections`'s; None starts its process
    pool once two classes have 64 candidates)."""
    from aidet_tpu_torch.data.tiling import merge_patch_detections
    return merge_patch_detections(dets, offsets, num_classes=15,
                                  box_type="quad", workers=workers)


def scene_map(merged, gt):
    """DOTA (task 1, VOC-07) mAP of one scene's merged detections."""
    from aidet_tpu_torch.core.eval.class_names import DOTA_CLASSES
    from aidet_tpu_torch.core.eval.dota import dota_eval
    return dota_eval({"scene": merged}, {"scene": gt}, DOTA_CLASSES,
                     task="obb")[0]


def as_batch(merged):
    """A merged scene as a one-image batch of tensors for
    `match_detections` (quads in place of boxes)."""
    import torch
    k = len(merged["scores"])
    return dict(boxes=torch.from_numpy(merged["boxes"])[None],
                scores=torch.from_numpy(merged["scores"])[None],
                labels=torch.from_numpy(merged["labels"])[None],
                valid=torch.ones(1, k, dtype=torch.bool))


def run_scene_reference(device="cuda", size=SCENE_REF["size"],
                        patch=SCENE_REF["patch"],
                        overlap=SCENE_REF["overlap"], seed=0):
    """One seeded scene through the small flagship (float32) on
    ``device`` and on the CPU with the same weights: the device tiler's
    patches equal `tile_image`'s bytes; the merged detections pair up
    (`match_detections`: same labels, scores within 1e-2, quads within
    1 px); the two DOTA mAPs agree within 1e-6; the ground truth fed
    back as detections scores mAP 1.0 (within 1e-6: the VOC-07 AP sums
    eleven float32 precisions).  Returns the phase's fields."""
    import numpy as np
    import torch
    from aidet_tpu_torch.data.tiling import device_tiler, tile_image
    from aidet_tpu_torch.flagship import build_flagship
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    scene, gt = synth_scene(seed, size, SCENE_REF["objects"])
    tiler, offsets = device_tiler(size, size, patch, overlap, device=device)
    tiles = tiler(torch.from_numpy(scene).to(device))
    host_tiles, host_offsets = tile_image(scene, patch, overlap)
    if not (np.array_equal(tiles.cpu().numpy(), host_tiles)
            and np.array_equal(offsets, host_offsets)):
        raise AssertionError("scene_reference: the device tiler's patches "
                             "differ from tile_image's")
    n = len(offsets)
    runs = {}
    for run, d, imgs in (("device", device, tiles),
                         ("cpu", "cpu", torch.from_numpy(host_tiles))):
        model = build_flagship(patch, small=True, device=d, seed=seed)
        out = model.predict(imgs, torch.full((n, 2), float(patch),
                                             device=d))
        runs[run] = merge(lift(out), offsets)
    got, ref = runs["device"], runs["cpu"]
    errs = match_detections(as_batch(got), as_batch(ref), SCENE_REF_LIMITS)
    maps = dict(device=scene_map(got, gt), cpu=scene_map(ref, gt))
    if abs(maps["device"] - maps["cpu"]) > SCENE_MAP_TOL:
        raise AssertionError(f"scene_reference: mAP {maps}")
    gt_map = scene_map(dict(gt, scores=np.ones(len(gt["labels"]),
                                               np.float32)), gt)
    if abs(gt_map - 1.0) > SCENE_MAP_TOL:
        raise AssertionError(f"scene_reference: ground truth as detections "
                             f"scores mAP {gt_map}, not 1.0")
    return dict(scene=size, patch=patch, overlap=overlap, patches=n,
                objects=len(gt["labels"]), merged=len(got["scores"]),
                merged_cpu=len(ref["scores"]), tiles_equal=True,
                max_abs_err=errs, limits=SCENE_REF_LIMITS, map=maps,
                map_tol=SCENE_MAP_TOL, gt_as_detections_map=gt_map,
                note=SCENE_NOTE)


def run_scene(device="cuda", small=False, scenes=4, serial=2, seed=0):
    """Serve seeded scenes through the flagship as bench.py's
    measure_scene_e2e does: scene (pinned host memory) -> card ->
    `device_tiler` -> one predict of all patches (K1 inside) -> lift
    (outputs to the host, thetaobbs to quads) -> per-class rotated-NMS
    merge, and DOTA eval against the scene's ground truth.  One warm
    scene, then ``scenes`` pipelined at depth 1 (scene i's lift and
    merge on a host thread while scene i+1 is transferred, tiled and
    predicted; the thread's copies wait on an event of scene i's
    predict, on a stream of their own; each scene's lift + merge ms on
    that thread is reported), then ``serial`` scenes with each
    stage timed between synchronisations; their merge is then timed
    again in this process (workers=0, not on the path), and must give
    the same detections.  K1 launches once per scene
    on the card (the plain version runs on the CPU).  Returns the
    phase's fields."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from aidet_tpu_torch.data.tiling import close_merge_pool, device_tiler
    from aidet_tpu_torch.flagship import build_flagship
    cfg = SCENE_SMALL if small else SCENE
    size, patch = cfg["size"], cfg["patch"]
    on_card = torch.device(device).type == "cuda"
    model = build_flagship(patch, small=small, device=device, seed=seed)
    tiler, offsets = device_tiler(size, size, patch, cfg["overlap"],
                                  device=device)
    n = len(offsets)
    shapes = torch.full((n, 2), float(patch), device=device)
    data = []
    for i in range(1 + scenes + serial):
        scene, gt = synth_scene(seed + i, size, cfg["objects"])
        scene = torch.from_numpy(scene)
        data.append((scene.pin_memory() if on_card else scene, gt))
    copy_stream = torch.cuda.Stream() if on_card else None

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def dispatch(scene):
        out = model.predict(tiler(scene.to(device, non_blocking=True)),
                            shapes)
        done = None
        if on_card:
            done = torch.cuda.Event()
            done.record()
        return out, done

    drain_ms = []

    def drain(out, done):
        t0 = time.perf_counter()
        if on_card:
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_event(done)
                merged = merge(lift(out), offsets)
        else:
            merged = merge(lift(out), offsets)
        drain_ms.append((time.perf_counter() - t0) * 1e3)
        return merged

    def check(merged, what):
        k = len(merged["scores"])
        if merged["boxes"].shape != (k, 8) \
                or not np.isfinite(merged["boxes"]).all() \
                or not np.isfinite(merged["scores"]).all():
            raise AssertionError(f"scene: {what} merged detections "
                                 f"{merged['boxes'].shape}, not finite or "
                                 "not quads")
        return k

    try:
        check(drain(*dispatch(data[0][0])), "warm")
        launch_counts(reset=True)
        sync()
        t0 = time.perf_counter()
        merged = []
        with ThreadPoolExecutor(max_workers=1) as host:
            pending = None
            for scene, _ in data[1:1 + scenes]:
                nxt = dispatch(scene)
                if pending is not None:
                    merged.append(pending.result())
                pending = host.submit(drain, *nxt)
            merged.append(pending.result())
        pipelined_s = time.perf_counter() - t0
        dets = [check(m, "pipelined") for m in merged]
        pipelined_drain_ms = drain_ms[1:]

        stages = dict.fromkeys(("transfer", "tile", "predict", "lift",
                                "merge", "eval"), 0.0)
        maps = []
        in_process_ms = 0.0
        for scene, gt in data[1 + scenes:]:
            sync()
            t = [time.perf_counter()]
            dev = scene.to(device, non_blocking=True)
            sync()
            t.append(time.perf_counter())
            tiles = tiler(dev)
            sync()
            t.append(time.perf_counter())
            out = model.predict(tiles, shapes)
            sync()
            t.append(time.perf_counter())
            patch_dets = lift(out)
            t.append(time.perf_counter())
            m = merge(patch_dets, offsets)
            t.append(time.perf_counter())
            maps.append(scene_map(m, gt))
            t.append(time.perf_counter())
            for k, a, b in zip(stages, t, t[1:]):
                stages[k] += (b - a) * 1e3 / serial
            dets.append(check(m, "serial"))
            t0 = time.perf_counter()
            m1 = merge(patch_dets, offsets, workers=0)
            in_process_ms += (time.perf_counter() - t0) * 1e3 / serial
            if any(not np.array_equal(m[k], m1[k]) for k in m):
                raise AssertionError("scene: the pooled merge differs "
                                     "from the in-process one")
        launches = launch_counts()
    finally:
        close_merge_pool()
    want = dict.fromkeys(HANDLES, 0)
    want["roi_align"] = scenes + serial if on_card else 0
    if launches != want:
        raise AssertionError(f"scene: launches {launches} in "
                             f"{scenes + serial} scenes, expected {want}")
    if not all(0.0 <= m <= 1.0 for m in maps):
        raise AssertionError(f"scene: mAP {maps}")
    return dict(scene=size, patch=patch, overlap=cfg["overlap"],
                patches_per_scene=n, batch=n, objects=cfg["objects"],
                dtype=str(next(model.parameters()).dtype),
                scenes_pipelined=scenes, pipelined_s=pipelined_s,
                patches_per_s=scenes * n / pipelined_s,
                pipelined_drain_ms=pipelined_drain_ms,
                scenes_serial=serial, serial_stage_ms=stages,
                serial_ms_per_scene=sum(stages.values()),
                merge_in_process_ms=in_process_ms,
                launches=launches, k1_launches_per_scene=launches[
                    "roi_align"] / (scenes + serial),
                merged_per_scene=dets, map=maps, note=SCENE_NOTE)


# The train loop and the test run (the loop phase): the flagship's
# architecture from its config file, trained on seeded synthetic DOTA
# patches written as PNG (a checkout of the repo holds no dataset), then
# resumed, tested and scored
LOOP_CONFIG = "configs/dota_theta_obb_r50_fpn_1x.py"
LOOP = dict(train=24, val=8, size=1024, objects=60, epochs=2, batch=2,
            test_batch=8)
LOOP_SMALL = dict(train=4, val=2, size=256, objects=12, epochs=2, batch=2,
                  test_batch=2)
# the small architecture of `flagship.build_flagship(small=True)` as a
# config, for the CPU rehearsals and tests
SMALL_MODEL = dict(
    type="RBBoxRCNN", backbone=dict(type="ResNet", depth=18),
    neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=64,
              num_outs=5),
    rpn_head=dict(type="RPNHead", in_channels=64, feat_channels=64,
                  num_anchors=3),
    bbox_head=dict(type="SharedFCBBoxHead", num_classes=16, in_channels=64,
                   fc_out_channels=128),
    rbbox_head=dict(type="RBBoxHead", num_classes=16, in_channels=64,
                    fc_out_channels=128, encode="thetaobb"),
    rbbox_encode="thetaobb", img_size=256)
SMALL_TRAIN_CFG = dict(rpn_proposal=dict(nms_pre=128, nms_post=64,
                                         max_num=64),
                       rcnn=dict(num_samples=16))
SMALL_TEST_CFG = dict(rpn=dict(nms_pre=128, nms_post=64, max_num=64),
                      rcnn=dict(max_per_img=16))
# run_inference against predict on the same batch, in one process with
# the same weights: the same function on the same inputs
LOOP_INFER_LIMITS = dict(boxes=1e-3, rboxes=1e-3, theta=1e-4, scores=1e-5)
# the resumed run against the run it resumes, each loss and grad_norm
# relative to its value (over at least 1): the first step within 1e-5
# (its losses read the restored weights, batch and sampling seed; only
# grad_norm sums a gradient, whose last bits vary from run to run on the
# card), the second within 0.1 (it reads the restored momentum trace
# and schedule; on the H100 a resumed run's second step differed by
# up to 2.9e-2, while on the CPU a zeroed trace moved the small model's
# second step by 0.40 and a step count restored as 0 its first by 0.23)
LOOP_RESUME_REL = dict(first=1e-5, second=0.1)


def write_patch_set(root, first, count, size, objects, seed):
    """``count`` seeded synthetic patches S<first>..S<first+count-1>
    (`synth_scene`, each its own scene at offset 0) written under
    ``root`` as ``images/S<k>__1.0__0___0.png`` by `imio.imwrite`, their
    COCO-style json in the format of data/dota's patch jsons (bbox as
    xywh, pointobb, segmentation, area, categories 1-15 named as
    DOTA_CLASSES) and their scene ground truth json in the format of
    data/dota's ``*_scene_gt_obb.json``.  Returns (ann_file, img_prefix,
    gt_json)."""
    import os

    import numpy as np
    from aidet_tpu_torch.core.eval.class_names import DOTA_CLASSES
    from aidet_tpu_torch.data.imio import imwrite
    prefix = os.path.join(root, "images")
    os.makedirs(prefix, exist_ok=True)
    images, anns, gts = [], [], {}
    for k in range(first, first + count):
        img, gt = synth_scene(seed + k, size, objects)
        name = f"S{k}__1.0__0___0.png"
        imwrite(os.path.join(prefix, name), img)
        images.append(dict(id=k + 1, file_name=name, width=size,
                           height=size))
        for q, label in zip(gt["boxes"].astype(float), gt["labels"]):
            x, y = q[0::2], q[1::2]
            area = 0.5 * abs(np.dot(x, np.roll(y, -1))
                             - np.dot(y, np.roll(x, -1)))
            anns.append(dict(
                id=len(anns) + 1, image_id=k + 1,
                category_id=int(label) + 1,
                bbox=[x.min(), y.min(), x.max() - x.min(),
                      y.max() - y.min()],
                pointobb=q.tolist(), segmentation=[q.tolist()],
                area=float(area), iscrowd=0))
        gts[f"S{k}"] = dict(boxes=gt["boxes"].tolist(),
                            labels=gt["labels"].tolist(),
                            difficult=gt["difficult"].tolist())
    split = f"S{first}_{first + count}"
    ann_file = os.path.join(root, f"{split}.json")
    gt_json = os.path.join(root, f"{split}_scene_gt_obb.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=[
            dict(id=i + 1, name=c) for i, c in enumerate(DOTA_CLASSES)]), f)
    with open(gt_json, "w") as f:
        json.dump(gts, f)
    return ann_file, prefix, gt_json


def loop_config(root, small=False, seed=0):
    """The loop's config (`LOOP_CONFIG` as written, or its small
    architecture) with its data paths on seeded patches written under
    ``root`` (`write_patch_set`: the train set and the val set), 2
    epochs at batch 2, a log record every step and a checkpoint every
    epoch; the optimizer and schedule as written.  Returns (config, the
    val set's scene gt json)."""
    from aidet_tpu_torch.utils.config import Config
    sizes = LOOP_SMALL if small else LOOP
    cfg = Config.fromfile(LOOP_CONFIG).to_dict()
    if small:
        cfg.update(model=SMALL_MODEL, train_cfg=SMALL_TRAIN_CFG,
                   test_cfg=SMALL_TEST_CFG,
                   train_pipeline=dict(cfg["train_pipeline"], img_size=256))
    train = write_patch_set(root, 0, sizes["train"], sizes["size"],
                            sizes["objects"], seed)
    val = write_patch_set(root, sizes["train"], sizes["val"], sizes["size"],
                          sizes["objects"], seed)
    cfg["data"] = dict(
        train=dict(cfg["data"]["train"], ann_file=train[0],
                   img_prefix=train[1]),
        test=dict(cfg["data"]["test"], ann_file=val[0], img_prefix=val[1]))
    cfg.update(total_epochs=sizes["epochs"], batch_size=sizes["batch"],
               log_interval=1, checkpoint_interval=1)
    return Config(cfg, LOOP_CONFIG), val[2]


class LoopRecords(logging.Handler):
    """Inside a with block, keeps the ``train`` records of the loop's
    log (`apis.train.train_detector`)."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        if hasattr(record, "train"):
            self.records.append(record.train)

    def __enter__(self):
        from aidet_tpu_torch.utils.logging import get_root_logger
        get_root_logger().addHandler(self)
        return self.records

    def __exit__(self, *exc):
        logging.getLogger("aidet_tpu_torch").removeHandler(self)


def span_device_time(prof, span="train_epoch"):
    """The card's time inside the host windows of the ``span`` events:
    (window ms, busy ms: the union of the intervals of every kernel and
    copy on the card, clipped to the windows; the 6 kernels or copies
    with the most time in them)."""
    events = prof.events()
    on_card = [str(getattr(e, "device_type", "")).endswith("CUDA")
               for e in events]
    # a record_function span has a row on the card too (its extent);
    # its name is also a host event's, which no kernel's or copy's is
    host = {e.name for e, card in zip(events, on_card) if not card}
    windows = [e.time_range for e, card in zip(events, on_card)
               if e.name == span and not card]
    device = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e, card in zip(events, on_card)
                    if card and e.name not in host)
    window = busy = 0.0
    by_name: dict = {}
    for w in windows:
        window += w.end - w.start
        end = w.start
        for a, b, name in device:
            if b <= w.start or a >= w.end:
                continue
            by_name[name] = by_name.get(name, 0.0) + min(b, w.end) - max(
                a, w.start)
            a, b = max(a, end), min(b, w.end)
            if b > a:
                busy += b - a
                end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return window / 1e3, busy / 1e3, [dict(name=k[:80], ms=v / 1e3)
                                      for k, v in top]


def loop_train(cfg, work_dir, device, seed=0, resume_from=None,
               profile=False):
    """One `apis.train.train_detector` run of ``cfg`` (the trainer's
    build of its model, flip_ratio 0): its ``train`` log records, launch
    counts (set to 0 just before), wall seconds, the count of
    parameters that moved, and with ``profile`` on the card the card's
    time in the epoch spans (`span_device_time`, under torch.profiler)."""
    import torch
    from aidet_tpu_torch.apis.train import train_detector
    from aidet_tpu_torch.data.builder import build_dataset
    from aidet_tpu_torch.data.pipeline import TrainPipeline
    from aidet_tpu_torch.models.builder import build_detector
    from torch.profiler import ProfilerActivity, profile as profiler
    on_card = torch.device(device).type == "cuda"
    model = build_detector(cfg.model, train_cfg=cfg.train_cfg,
                           test_cfg=cfg.test_cfg, device=device, seed=seed,
                           train=True)
    run = dict(seed=seed, optimizer=cfg.optimizer, lr_config=cfg.lr_config,
               total_epochs=cfg.total_epochs, batch_size=cfg.batch_size,
               log_interval=cfg.log_interval,
               checkpoint_interval=cfg.checkpoint_interval,
               pipeline=TrainPipeline(**dict(cfg.train_pipeline,
                                             flip_ratio=0.0)))
    dataset = build_dataset(cfg.data.train)
    before = [p.detach().clone() for p in model.parameters()]
    prof = profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                    ) if profile and on_card else None
    with LoopRecords() as records:
        if on_card:
            torch.cuda.synchronize()
        launch_counts(reset=True)
        t0 = time.perf_counter()
        if prof is not None:
            prof.start()
        try:
            train_detector(model, dataset, run, work_dir=work_dir,
                           resume_from=resume_from, device=device)
            if on_card:
                torch.cuda.synchronize()
        finally:
            if prof is not None:
                prof.stop()
        wall = time.perf_counter() - t0
        launches = launch_counts()
    moved = sum(not torch.equal(a, p.detach())
                for a, p in zip(before, model.parameters()))
    return dict(records=records, launches=launches, wall_s=wall,
                moved=moved, n_params=len(before),
                device_time=span_device_time(prof) if prof else None)


def loop_test(cfg, ckpt_dir, gt_json, device, batch):
    """`init_detector(cfg, ckpt_dir)` and `apis.test.run_inference` over
    the config's test set at ``batch`` (launch counts set to 0 just
    before, read just after), held to `predict` of the same batch
    (`LOOP_INFER_LIMITS`); the detections merged into scenes
    (`DOTADataset.merge_patches_to_scenes`) and scored against
    ``gt_json`` (DOTA task 1), and the ground truth scored as
    detections, which must give mAP 1.0.  Returns the fields."""
    import numpy as np
    import torch
    from aidet_tpu_torch.apis.inference import init_detector, to_numpy
    from aidet_tpu_torch.apis.test import run_inference
    from aidet_tpu_torch.data.builder import build_dataset
    from aidet_tpu_torch.data.imio import imread
    from aidet_tpu_torch.data.np_rboxes import thetaobb2pointobb
    from aidet_tpu_torch.data.pipeline import TestPipeline
    on_card = torch.device(device).type == "cuda"
    model, _ = init_detector(cfg, ckpt_dir, device=device)
    dataset = build_dataset(cfg.data.test)
    if on_card:
        torch.cuda.synchronize()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    results, names = run_inference(model, dataset, batch_size=batch)
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    batches = -(-len(dataset) // batch)
    want = dict.fromkeys(HANDLES, 0)
    want["roi_align"] = batches if on_card else 0
    if launches != want:
        raise AssertionError(f"loop: launches {launches} in {batches} "
                             f"inference batches, expected {want}")
    pipe = TestPipeline(img_size=model.img_size, device_normalize=True)
    samples = [pipe(imread(dataset.img_path(i))) for i in range(len(dataset))]
    imgs, shapes, factors = (
        torch.from_numpy(np.stack([s[k] for s in samples])).to(device)
        for k in ("imgs", "img_shapes", "scale_factors"))
    ref = to_numpy(model.predict(imgs, shapes, factors))
    got = {k: np.stack([r[k] for r in results]) for k in results[0]}
    errs = match_detections({k: torch.from_numpy(v) for k, v in got.items()},
                            {k: torch.from_numpy(v) for k, v in ref.items()},
                            LOOP_INFER_LIMITS)
    dets = [dict(boxes=thetaobb2pointobb(r["rboxes"]), scores=r["scores"],
                 labels=r["labels"], valid=r["valid"]) for r in results]
    merged = dataset.merge_patches_to_scenes(dets, names, task="obb")
    with open(gt_json) as f:
        gts = {scene: {k: np.asarray(v) for k, v in g.items()}
               for scene, g in json.load(f).items()}
    val_map = dataset.evaluate_scenes(merged, gts)[0]
    gt_map = dataset.evaluate_scenes(
        {k: dict(g, scores=np.ones(len(g["labels"]), np.float32))
         for k, g in gts.items()}, gts)[0]
    if abs(gt_map - 1.0) > SCENE_MAP_TOL:
        raise AssertionError(f"loop: the ground truth as detections scores "
                             f"mAP {gt_map}, not 1.0")
    return dict(inference_s=seconds, inference_batch=batch,
                inference_launches=launches,
                k1_launches_per_batch=launches["roi_align"] / batches,
                inference_against_predict=errs,
                inference_limits=LOOP_INFER_LIMITS,
                n_valid=int(got["valid"].sum()), merged_scenes=len(merged),
                val_map=val_map, gt_as_detections_map=gt_map,
                note=SCENE_NOTE)


def tf32_defaults():
    """A context with PyTorch's default TF32 settings (cuDNN's
    convolutions in TF32, matrix products in float32), restored after:
    the float32 configs run as a user's would."""
    import contextlib
    import torch

    @contextlib.contextmanager
    def ctx():
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
    return ctx()


def run_loop(device="cuda", small=False, seed=0):
    """Train `LOOP_CONFIG` (full width, or its small architecture) from
    PNG patches through `DOTADataset`, `GroupedLoader` and
    `TrainPipeline` (host normalize, flip_ratio 0), checkpointing each
    epoch (`loop_train`), under PyTorch's default TF32 settings (cuDNN
    on, matmul off), twice:

    1. loop: 2 epochs as a user runs them: every loss finite, the
       parameters moved, ms per step, images/s, the loader's wait and
       the checkpoints' save ms;
    2. resumed: epoch 2 again from run 1's epoch-1 checkpoint
       (resume_from), under torch.profiler on the card (the card's time
       in the epoch span: its idle share in the profiled window, and
       against run 1's unprofiled ms per step), with the load ms.  Its
       steps are held to run 1's epoch 2 (`LOOP_RESUME_REL`): every
       step's lr equal; the first step's losses and grad_norm (the
       restored weights, loader order and sampling seed); the second's
       (the restored momentum trace and schedule).  Later steps are
       reported, not held: on the card K2's backward sums each tile in
       the order its integer atomics fill the lists, and cuDNN's
       backward may too, so a run differs from itself in the last bits
       of its gradients, and random-weight trajectories part within a
       few steps.  On the CPU the phase runs on one thread (the plain
       RoIAlign's backward accumulates in thread order otherwise) and
       every step is held equal.

    Then test and score from run 1's checkpoint directory
    (`loop_test`).  K2's forward and backward launch once a step in
    both runs (none on the CPU).  Returns the phase's fields."""
    import torch
    on_card = torch.device(device).type == "cuda"
    threads = torch.get_num_threads()
    if not on_card:
        torch.set_num_threads(1)
    try:
        with tf32_defaults():
            return _run_loop(device, small, seed, on_card)
    finally:
        torch.set_num_threads(threads)


def _resume_errors(resumed, want):
    """Each resumed step's largest difference from the run it resumes,
    over its losses and grad_norm, relative to the value (over at least
    1)."""
    if [r["step"] for r in resumed] != [r["step"] for r in want]:
        raise AssertionError("loop: the resumed run took steps "
                             f"{[r['step'] for r in resumed]}, not "
                             f"{[r['step'] for r in want]}")
    return [max(abs(r["metrics"][k] - w["metrics"][k])
                / max(1.0, abs(w["metrics"][k])) for k in w["metrics"])
            for r, w in zip(resumed, want)]


def _run_loop(device, small, seed, on_card):
    import os
    import shutil
    import tempfile
    sizes = LOOP_SMALL if small else LOOP
    with tempfile.TemporaryDirectory() as root:
        cfg, gt_json = loop_config(root, small, seed)
        first = loop_train(cfg, os.path.join(root, "loop"), device, seed)
        resume_dir = os.path.join(root, "resumed", "ckpt")
        shutil.copytree(os.path.join(root, "loop", "ckpt", "step_1"),
                        os.path.join(resume_dir, "step_1"))
        again = loop_train(cfg, os.path.join(root, "resumed"), device, seed,
                           resume_from=resume_dir, profile=True)
        test = loop_test(cfg, os.path.join(root, "loop", "ckpt"), gt_json,
                         device, sizes["test_batch"])
    steps = [r for r in first["records"] if "metrics" in r]
    resumed = [r for r in again["records"] if "metrics" in r]
    if len(steps) != cfg.total_epochs * (sizes["train"] // sizes["batch"]):
        raise AssertionError(f"loop: {len(steps)} step records")
    bad = [(r["step"], k) for r in steps + resumed
           for k, v in r["metrics"].items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"loop: losses not finite at {bad}")
    if first["moved"] == 0:
        raise AssertionError("loop: the parameters did not move")
    for name, run, n in (("loop", first, len(steps)),
                         ("resumed", again, len(resumed))):
        want = dict.fromkeys(HANDLES, 0)
        if on_card:
            want.update(roi_align_train_forward=n, roi_align_backward=n)
        if run["launches"] != want:
            raise AssertionError(f"loop: the {name} run's launches "
                                 f"{run['launches']} in {n} steps, expected "
                                 f"{want}")
    epoch2 = [r for r in steps if r["epoch"] == 2]
    resume = _resume_errors(resumed, epoch2)
    limits = ([LOOP_RESUME_REL["first"], LOOP_RESUME_REL["second"]]
              if on_card else [0.0] * len(resume))
    if any(e > lim for e, lim in zip(resume, limits)) or [
            r["lr"] for r in resumed] != [r["lr"] for r in epoch2]:
        raise AssertionError(
            f"loop: the resumed run differs from the uninterrupted one: "
            f"{resume} (relative; limits {limits}), lr "
            f"{[r['lr'] for r in resumed]} against "
            f"{[r['lr'] for r in epoch2]}")
    timed = steps[1:]     # the first step builds cuDNN's plans
    ms = 1e3 * sum(r["time"] for r in timed) / len(timed)
    profiled = dict(ms_per_step=1e3 * sum(r["time"] for r in resumed)
                    / len(resumed))
    if again["device_time"] is not None:
        window, busy, top = again["device_time"]
        per_step = busy / len(resumed)
        profiled.update(window_ms=window, device_ms_per_step=per_step,
                        idle_share_in_window=1.0 - busy / window,
                        idle_share_against_unprofiled=1.0 - per_step / ms,
                        top_device_events=top)
    return dict(
        config=LOOP_CONFIG + (" (small architecture)" if small else ""),
        img=sizes["size"], batch=cfg.batch_size, epochs=cfg.total_epochs,
        train_patches=sizes["train"], val_patches=sizes["val"],
        objects=sizes["objects"], dtype="float32 parameters and compute "
        "(the config names none); TF32 in cuDNN's convolutions (PyTorch's "
        "default)",
        steps=[dict(step=r["step"], epoch=r["epoch"], lr=r["lr"],
                    **r["metrics"]) for r in steps],
        first_step_ms=steps[0]["time"] * 1e3,
        step_ms=[r["time"] * 1e3 for r in steps], ms_per_step=ms,
        images_per_s=cfg.batch_size * 1e3 / ms,
        loader_wait_ms_per_step=1e3 * sum(r["data_time"] for r in timed)
        / len(timed),
        loop_wall_s=first["wall_s"], params_moved=first["moved"],
        params=first["n_params"],
        checkpoint_save_ms=[r["checkpoint_save_s"] * 1e3
                            for r in first["records"]
                            if "checkpoint_save_s" in r],
        checkpoint_load_ms=[r["checkpoint_load_s"] * 1e3
                            for r in again["records"]
                            if "checkpoint_load_s" in r],
        resumed_steps=[dict(step=r["step"], **r["metrics"])
                       for r in resumed],
        resume_rel=resume, resume_limits=limits, profiled=profiled,
        launches=first["launches"], resumed_launches=again["launches"],
        k2_launches_per_step=first["launches"]["roi_align_backward"]
        / len(steps), **test)


# The CenterMap family (MaskOBB, CenterMapOBB, CenterMap-Net): the
# paper's configuration at full width, 2 images of 1024^2, 3 predict
# calls and 3 train steps (1 warm-up step first) from 8 PNG patches of
# 60 objects; the CPU rehearsal at the small architecture on 256^2
CENTERMAP_CONFIG = "configs/dota_centermap_net_tgrs_mask_weight_v4.py"
CENTERMAP = dict(img=1024, batch=2, calls=3, steps=3, patches=8,
                 objects=60)
CENTERMAP_SMALL = dict(img=256, batch=2, calls=2, steps=1, patches=4,
                       objects=12)
# the small architecture (`SMALL_MODEL`'s backbone, FPN, RPN and bbox
# head) with the mask family's heads at its widths
SMALL_MASK_HEADS = dict(
    centermap=dict(
        type="CenterMapNet",
        mask_head=dict(type="CenterMapHead", num_convs=4, in_channels=64,
                       conv_out_channels=64, num_classes=16),
        semantic_head=dict(type="WPSGAHead", in_channels=64, channels=64,
                           num_classes=16)),
    maskobb=dict(
        type="MaskOBB",
        mask_head=dict(type="FCNMaskHead", num_convs=4, in_channels=64,
                       conv_out_channels=64, num_classes=16)))
# predict on the card against the CPU (float32, TF32 off): the
# reference phase's limits, and each paired detection's 28 x 28 map
# within 1e-2 (raw CenterMap values or sigmoids, of order 1)
MASK_REF_LIMITS = dict(boxes=1.0, scores=1e-2, masks=1e-2)
MASK_REF_TRAIN_LIMITS = dict(losses_rel=1e-3, update_rel_l2=1e-3,
                             leaf_over_largest=1e-2)
MASK_TITLES = dict(centermap="small CenterMap-Net float32",
                   maskobb="small MaskOBB float32")


def small_mask_model(kind):
    """The small architecture's config with ``kind``'s heads."""
    cfg = {k: v for k, v in SMALL_MODEL.items()
           if k not in ("type", "rbbox_head", "rbbox_encode")}
    cfg.update(SMALL_MASK_HEADS[kind])
    return cfg


def build_mask_model(kind, device, train=False, train_cfg=None, seed=0):
    """The small ``kind`` model ("centermap" or "maskobb") from
    `build_detector`: the predict build, or with ``train`` the
    trainer's (float32 either way)."""
    from aidet_tpu_torch.models.builder import build_detector
    from aidet_tpu_torch.models.detectors.two_stage import _merge
    return build_detector(small_mask_model(kind),
                          train_cfg=_merge(SMALL_TRAIN_CFG, train_cfg),
                          test_cfg=SMALL_TEST_CFG, device=device, seed=seed,
                          train=train)


def mask_targets(kind, quads, labels, img, device_normalize=True):
    """The mask family's targets of one image's quads [G, 8] (labels
    [G], 1-based) over an img^2 canvas, as `TrainPipeline` makes them:
    CenterMap soft masks and mask weights, pseudo-segmentation and heatmap
    weights ("centermap"), or binary masks ("maskobb"), at img / 4;
    [0, 1] maps as uint8 with ``device_normalize``."""
    import numpy as np
    from aidet_tpu_torch.data.pipeline import TrainPipeline
    pipe = TrainPipeline(
        img_size=img, max_gt=len(quads), with_mask=True,
        mask_type="centermap" if kind == "centermap" else "binary",
        with_mask_weight=kind == "centermap",
        with_semantic=kind == "centermap",
        with_heatmap_weight=kind == "centermap",
        device_normalize=device_normalize)
    return pipe.mask_targets(np.asarray(quads, np.float32),
                              np.asarray(labels), len(quads), img, img)


def mask_train_batch(kind, batch, img, n_gt, seed, device):
    """`flagship.synthetic_train_batch` with the targets of
    `mask_targets` from its rotated gts (uint8 maps, dequantized on the
    card)."""
    import numpy as np
    import torch
    from aidet_tpu_torch.data.np_rboxes import thetaobb2pointobb
    from aidet_tpu_torch.flagship import synthetic_train_batch
    data = synthetic_train_batch(batch, img, n_gt, seed, device)
    quads = thetaobb2pointobb(data["gt_rboxes"].cpu().numpy())
    labels = data["gt_labels"].cpu().numpy()
    per = [mask_targets(kind, q, lb, img) for q, lb in zip(quads, labels)]
    for k in per[0]:
        data[k] = torch.from_numpy(np.stack([t[k] for t in per])).to(device)
    return data


def mask_step_once(kind, device, img, n_gt, train_cfg, seed=0):
    """One train step of the small ``kind`` model on ``device``: as
    `train_step_once`, on `mask_train_batch`."""
    import torch
    from aidet_tpu_torch.parallel.train import (build_lr_schedule,
                                                build_optimizer,
                                                create_train_state,
                                                make_train_step)
    net = build_mask_model(kind, device, train=True, train_cfg=train_cfg,
                           seed=seed)
    params = list(net.parameters())
    before = [p.detach().cpu().clone() for p in params]
    optimizer = build_optimizer(build_lr_schedule(base_lr=0.02))
    state = create_train_state(net, optimizer)
    step = make_train_step(net, optimizer)
    batch = mask_train_batch(kind, 2, img, n_gt, seed, device)
    _, metrics = step(state, batch,
                      torch.Generator(device=device).manual_seed(seed))
    return ({k: float(v) for k, v in metrics.items()}, before,
            [p.detach().cpu() for p in params])


def run_mask_reference(device="cuda", kind="centermap"):
    """The small ``kind`` model (float32, TF32 off) on ``device``
    against the CPU with the same weights: predict on 2 seeded uint8
    images (`match_detections` with `MASK_REF_LIMITS`: every detection
    paired, its mask too), then one train step under a train_cfg that
    keeps every candidate (`compare_steps` with
    `MASK_REF_TRAIN_LIMITS`: each loss, loss_mask and loss_seg among
    them, and grad_norm within 1e-3 relative, the update within 1e-3
    relative L2, each leaf within 1e-2 of its largest update).  Returns
    the phase's fields."""
    import torch
    from aidet_tpu_torch.flagship import keep_every_candidate_cfg
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img, n_gt = 256, 8
    imgs = torch.randint(0, 256, (2, img, img, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    shapes = torch.full((2, 2), float(img))
    got, ref = ({k: v.cpu() for k, v in build_mask_model(kind, d).predict(
        imgs.to(d), shapes.to(d)).items()} for d in (device, "cpu"))
    errs = match_detections(got, ref, MASK_REF_LIMITS)
    net = build_mask_model(kind, "cpu", train=True)
    cfg = keep_every_candidate_cfg(img, n_gt,
                                   net.train_cfg["rpn_proposal"]["max_num"])
    step = [mask_step_once(kind, d, img, n_gt, cfg) for d in (device, "cpu")]
    train = compare_steps(f"{kind}_reference", *step, MASK_REF_TRAIN_LIMITS)
    train["worst_leaf"] = [n for n, _ in net.named_parameters()][
        train["worst_leaf"]]
    return dict(model=MASK_TITLES[kind], img=img, tf32=False,
                n_valid=int(got["valid"].sum()), max_abs_err=errs,
                limits=MASK_REF_LIMITS, gts=n_gt, losses_card=step[0][0],
                losses_cpu=step[1][0], train=train)


def centermap_model(device, small, seed=0, train=False):
    """`CENTERMAP_CONFIG` as written (float32: it names no dtype), or
    with ``small`` the small CenterMap-Net, from `build_detector` with
    seeded weights; returns (model, config dict)."""
    from aidet_tpu_torch.models.builder import build_detector
    from aidet_tpu_torch.utils.config import Config
    cfg = Config.fromfile(CENTERMAP_CONFIG).to_dict()
    if small:
        cfg.update(model=dict(small_mask_model("centermap"), img_size=256),
                   train_cfg=SMALL_TRAIN_CFG, test_cfg=SMALL_TEST_CFG,
                   train_pipeline=dict(cfg["train_pipeline"], img_size=256,
                                       max_gt=64))
    model = build_detector(cfg["model"], train_cfg=cfg["train_cfg"],
                           test_cfg=cfg["test_cfg"], device=device,
                           seed=seed, train=train)
    return model, cfg


def run_centermap_predict(device="cuda", small=False, seed=0):
    """CenterMap-Net's predict (`centermap_model`) on 2 seeded uint8
    images, ``calls`` times, under `tf32_defaults`: the outputs' shapes
    and finiteness, ms per call, K1's launches (4 a call on the card:
    7x7 and 14x14, each multi-level and on the semantic map; none on
    the CPU), peak memory, then the host's OBB extraction of the last
    call (`core.masks.masks_to_thetaobbs`, timed apart, at the
    threshold 0.5 and at the median of the maps' values) and the
    detections and non-empty OBBs.  Returns the phase's fields."""
    import numpy as np
    import torch
    from aidet_tpu_torch.apis.inference import to_numpy
    from aidet_tpu_torch.core.masks import masks_to_thetaobbs
    sizes = CENTERMAP_SMALL if small else CENTERMAP
    on_card = torch.device(device).type == "cuda"
    b, img = sizes["batch"], sizes["img"]
    with tf32_defaults():
        model, cfg = centermap_model(device, small, seed)
        imgs = torch.randint(0, 256, (b, img, img, 3), dtype=torch.uint8,
                             generator=torch.Generator().manual_seed(seed))
        imgs = imgs.to(device)
        shapes = torch.full((b, 2), float(img), device=device)
        k = model.test_cfg["rcnn"]["max_per_img"]
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        times = []
        for _ in range(sizes["calls"]):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.predict(imgs, shapes)
            if on_card:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = launch_counts()
    want = dict.fromkeys(HANDLES, 0)
    want["roi_align"] = 4 * sizes["calls"] if on_card else 0
    if launches != want:
        raise AssertionError(f"centermap_predict: launches {launches} in "
                             f"{sizes['calls']} calls, expected {want}")
    if tuple(out["masks"].shape) != (b, k, 28, 28) or "rboxes" in out:
        raise AssertionError("centermap_predict: masks "
                             f"{tuple(out['masks'].shape)}, keys {set(out)}")
    for key in ("boxes", "scores", "masks"):
        if not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"centermap_predict: {key} not finite")
    host = to_numpy(out)

    def obb_stage(thr):
        t0 = time.perf_counter()
        obbs = np.stack([masks_to_thetaobbs(host["masks"][i],
                                            host["boxes"][i],
                                            host["valid"][i], thr)
                         for i in range(b)])
        if not np.isfinite(obbs).all():
            raise AssertionError("centermap_predict: OBBs not finite")
        return obbs, (time.perf_counter() - t0) * 1e3 / b

    obbs, obb_ms = obb_stage(0.5)
    # random weights leave most maps under the 0.5 threshold, which
    # skips the label and the hull; at the median of the valid maps'
    # values about half of each map passes: an assumed foreground
    # share, not a user's (centermap_train times the stage on the gt
    # targets' own maps)
    median = float(np.median(host["masks"][host["valid"]]))
    busy, busy_ms = obb_stage(median)
    busy_masks = int((busy[..., 2:4] > 0).any(-1).sum())
    steady = times[1:] or times
    ms = sum(steady) / len(steady)
    return dict(
        config=CENTERMAP_CONFIG + (" (small architecture)" if small else ""),
        img=img, batch=b, calls=sizes["calls"], max_per_img=k,
        dtype="float32 parameters and compute (the config names none); "
        "TF32 in cuDNN's convolutions (PyTorch's default)",
        first_call_ms=times[0], call_ms=times, ms_per_call=ms,
        images_per_s=b * 1e3 / ms, launches=launches,
        k1_launches_per_call=launches["roi_align"] / sizes["calls"],
        peak_memory_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if on_card else None),
        n_valid=int(host["valid"].sum()),
        nonempty_obbs=int((obbs[..., 2:4] > 0).any(-1).sum()),
        host_obb_ms_per_image=obb_ms, median_thr=median,
        nonempty_obbs_at_median_thr=busy_masks,
        host_obb_ms_per_image_at_median_thr=busy_ms,
        host_obb_ms_per_nonempty_mask_at_median_thr=(
            busy_ms * b / max(busy_masks, 1)),
        foreground_share_at_median_thr=float(
            (host["masks"][host["valid"]] > median).mean()))


def centermap_batches(cfg, root, sizes, seed):
    """``sizes["steps"] + 1`` batches of ``sizes["batch"]`` made by the
    port's `TrainPipeline` (the config's train_pipeline with uint8
    transfer, `device_normalize`, the port's script's default) from
    seeded synthetic PNG patches (`write_patch_set`) read back by
    `DOTADataset`; and the pipeline's host ms per image for each target
    kind, each timed as the pipeline with that kind alone, less the
    pipeline without any."""
    from aidet_tpu_torch.data.builder import build_dataset
    from aidet_tpu_torch.data.imio import imread
    from aidet_tpu_torch.data.pipeline import TrainPipeline, collate_batch
    n = sizes["batch"] * (sizes["steps"] + 1)
    ann, prefix, _ = write_patch_set(root, 0, n, sizes["img"],
                                     sizes["objects"], seed)
    dataset = build_dataset(dict(cfg["data"]["train"], ann_file=ann,
                                 img_prefix=prefix))
    inputs = [(imread(dataset.img_path(i)), dataset.parse_anns(i))
              for i in range(n)]
    pipe_cfg = dict(cfg["train_pipeline"], device_normalize=True, seed=seed)
    kinds = dict(mask=dict(with_mask=True), mask_weight=dict(
        with_mask_weight=True), semantic=dict(with_semantic=True),
        heatmap_weight=dict(with_heatmap_weight=True))
    off = {k: False for k in ("with_mask", "with_mask_weight",
                              "with_semantic", "with_heatmap_weight")}

    def ms_per_image(extra):
        pipe = TrainPipeline(**{**pipe_cfg, **off, **extra})
        t0 = time.perf_counter()
        for img, anns in inputs:
            pipe(img, anns)
        return (time.perf_counter() - t0) * 1e3 / n

    base = ms_per_image({})
    target_ms = {k: ms_per_image(v) - base for k, v in kinds.items()}
    pipe = TrainPipeline(**pipe_cfg)
    t0 = time.perf_counter()
    samples = [pipe(img, anns) for img, anns in inputs]
    full_ms = (time.perf_counter() - t0) * 1e3 / n
    b = sizes["batch"]
    batches = [collate_batch(samples[i:i + b]) for i in range(0, n, b)]
    return batches, dict(base_ms_per_image=base,
                         target_ms_per_image=target_ms,
                         pipeline_ms_per_image=full_ms,
                         obb_fit_on_gt_centermaps=gt_centermap_obb_fit(
                             samples, sizes["img"]))


def gt_centermap_obb_fit(samples, img):
    """The host's mask-to-OBB fit (`masks_to_thetaobbs` at the 0.5
    threshold of the code and the reference) on maps that a head which
    had learnt its targets would give: each gt's own CenterMap target
    cropped at its box to 28x28 (`mask_target`, the train targets'
    crop).  Random weights give no such maps, so this is the stage's
    cost on the foreground share of real targets: ms per image and per
    non-empty mask, masks, and the share of crop pixels over 0.5."""
    import numpy as np
    import torch
    from aidet_tpu_torch.core.masks import masks_to_thetaobbs
    from aidet_tpu_torch.core.sample import FixedSample
    from aidet_tpu_torch.core.targets import mask_target
    crops = []
    for smp in samples:
        masks = torch.from_numpy(smp["gt_masks"]).float()[None] / 255.0
        boxes = torch.from_numpy(smp["gt_boxes"]).float()[None]
        valid = torch.from_numpy(smp["gt_valid"])[None]
        g = masks.shape[1]
        inds = torch.arange(g)[None]
        sample = FixedSample(inds, valid, valid, inds)
        crops.append(mask_target(sample, boxes * (masks.shape[-1] / img),
                                 masks, 28)[0].numpy())
    t0 = time.perf_counter()
    obbs = [masks_to_thetaobbs(c, smp["gt_boxes"], smp["gt_valid"], 0.5)
            for c, smp in zip(crops, samples)]
    ms = (time.perf_counter() - t0) * 1e3
    nonempty = sum(int((o[:, 2:4] > 0).any(-1).sum()) for o in obbs)
    fg = np.concatenate([c[smp["gt_valid"]] > 0.5
                         for c, smp in zip(crops, samples)])
    return dict(ms_per_image=ms / len(samples),
                ms_per_nonempty_mask=ms / max(nonempty, 1),
                masks=int(sum(smp["gt_valid"].sum() for smp in samples)),
                nonempty_masks=nonempty,
                foreground_share=float(fg.mean()) if fg.size else 0.0)


def run_centermap_train(device="cuda", small=False, seed=0):
    """CenterMap-Net's train step (`centermap_model`, the trainer's
    build: float32 parameters and compute, the config's train_cfg and
    optimizer, with the train phases' schedule) under `tf32_defaults`, on `centermap_batches`: 1 warm-up
    step, then ``steps`` timed ones; every loss finite (loss_mask and
    loss_seg among them), the heads' parameters moved, ms per step, K2's
    launches (4 forward and 4 backward a step on the card: 7x7 and
    14x14, each multi-level and on the semantic map; none on the CPU),
    peak memory, and the pipeline's host ms.  Returns the phase's
    fields."""
    import tempfile

    import torch
    from aidet_tpu_torch.parallel.train import (build_lr_schedule,
                                                build_optimizer,
                                                create_train_state,
                                                make_train_step)
    sizes = CENTERMAP_SMALL if small else CENTERMAP
    on_card = torch.device(device).type == "cuda"
    with tf32_defaults():
        net, cfg = centermap_model(device, small, seed, train=True)
        with tempfile.TemporaryDirectory() as root:
            batches, host = centermap_batches(cfg, root, sizes, seed)
        data = [{k: (torch.from_numpy(v).long() if v.dtype.kind == "i"
                     else torch.from_numpy(v)).to(device)
                 for k, v in bt.items()} for bt in batches]
        params = list(net.parameters())
        before = [p.detach().clone() for p in params]
        # the config's optimizer is build_optimizer's defaults
        optimizer = build_optimizer(build_lr_schedule(
            base_lr=cfg["optimizer"]["lr"]))
        state = create_train_state(net, optimizer)
        step = make_train_step(net, optimizer)
        gen = torch.Generator(device=device).manual_seed(seed)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, data[0], gen)
        first_ms = (time.perf_counter() - t0) * 1e3
        launch_counts(reset=True)
        times, steps = [], []
        for batch in data[1:]:
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, gen)
            if on_card:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            steps.append({k: float(v) for k, v in metrics.items()})
        launches = launch_counts()
    n = len(times)
    bad = [(i, k) for i, m in enumerate(steps) for k, v in m.items()
           if not math.isfinite(v)]
    if bad or not {"loss_mask", "loss_seg"} <= set(steps[0]):
        raise AssertionError(f"centermap_train: losses {steps[-1]} "
                             f"(not finite: {bad})")
    want = dict.fromkeys(HANDLES, 0)
    if on_card:
        want.update(roi_align_train_forward=4 * n, roi_align_backward=4 * n)
    if launches != want:
        raise AssertionError(f"centermap_train: launches {launches} in {n} "
                             f"steps, expected {want}")
    names = [nm for nm, _ in net.named_parameters()]
    still = [nm for nm, a, p in zip(names, before, params)
             if torch.equal(a, p.detach()) and nm.split(".")[0].endswith(
                 "_head")]
    if still:
        raise AssertionError(f"centermap_train: heads did not move: {still}")
    ms = sum(times) / n
    return dict(
        config=CENTERMAP_CONFIG + (" (small architecture)" if small else ""),
        img=sizes["img"], batch=sizes["batch"], steps=n,
        objects=sizes["objects"],
        dtype="float32 parameters and compute (the config names none); "
        "TF32 in cuDNN's convolutions (PyTorch's default)",
        losses=steps, first_step_ms=first_ms, step_ms=times,
        ms_per_step=ms, images_per_s=sizes["batch"] * 1e3 / ms,
        launches=launches,
        k2_launches_per_step=dict(
            forward=launches["roi_align_train_forward"] / n,
            backward=launches["roi_align_backward"] / n),
        peak_memory_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if on_card else None),
        pipeline=host)


# The single-stage and H-OBB detectors: RetinaNetOBB (BASELINE config
# #2) and the H-OBB RBBoxRCNN (config #3's H-based head), each card
# against CPU at the small architecture, then the config as written at
# full width: 3 predict calls and 1 warm-up + 3 timed train steps, at
# batch 2 of 1024^2 with 64 gts; the CPU rehearsal at the small
# architecture on 256^2.  RetinaHead's classification prior (-log(99))
# puts every random-weight score near 0.01, under score_thr 0.05, so
# `retina_cls`'s bias is set to 0 in every phase: all 15 classes pass
# and the rotated NMS does the full work of 15 x 256 candidates an image
RETINA_OBB_CONFIG = "configs/dota_retinanet_theta_obb_r50_fpn_1x.py"
H_OBB_CONFIG = "configs/dota_h_obb_r50_fpn_1x.py"
DETECTORS = dict(img=1024, batch=2, calls=3, steps=3, max_gt=64)
DETECTORS_SMALL = dict(img=128, batch=2, calls=1, steps=1, max_gt=16)
# the small RetinaNetOBB has 5 classes: its rotated NMS (2 x 5 x 256^2
# pairs a call) stays a few seconds in the CPU rehearsals
SMALL_RETINA_OBB = dict(
    type="RetinaNetOBB", backbone=dict(type="ResNet", depth=18),
    neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=64,
              num_outs=5, start_level=1, add_extra_convs=True),
    bbox_head=dict(type="RetinaHead", num_classes=6, in_channels=64,
                   feat_channels=64, stacked_convs=4, num_anchors=9,
                   reg_dim=5),
    rbox_encode="thetaobb", img_size=256)
SMALL_RETINA_TEST_CFG = dict(nms_pre=200, score_thr=0.05, rnms_thr=0.1,
                             max_per_img=50)
# predict on the card against the CPU (float32, TF32 off): the
# reference phase's limits; the H-OBB's rboxes are hobbs, all five of
# them in px (its "theta" limit is the h's), plus 1e-4 of their largest
# coordinate (random weights decode hobbs thousands of pixels long)
RETINA_REF_LIMITS = dict(boxes=1.0, rboxes=1.0, theta=1e-2, scores=1e-2)
H_OBB_REF_LIMITS = dict(boxes=1.0, rboxes=1.0, rboxes_rel=1e-4, theta=1.0,
                        scores=1e-2)
# the thetaobb models' (GroupNorm, OHEM) are the flagship reference's;
# the RBBoxRCNNRRoI's are rroi_reference's
REF_LIMITS = dict(
    retinanet_obb=RETINA_REF_LIMITS,
    gn_theta=dict(boxes=1.0, rboxes=1.0, theta=1e-2, scores=1e-2),
    ohem=dict(boxes=1.0, rboxes=1.0, theta=1e-2, scores=1e-2),
    gn_rroi=dict(boxes=1.0, rboxes=1.0, rboxes_rel=1e-4, theta=1e-2,
                 scores=1e-2))
DETECTOR_REF_TRAIN_LIMITS = dict(losses_rel=1e-3, update_rel_l2=1e-3,
                                 leaf_over_largest=1e-2)
# `compare_steps(resolved_only=True)`: the float32 ulps of a leaf's
# largest weight its largest update must span for the per-leaf check.
# At `retina_cls`'s bias 0 the focal loss's gradient norm (~8.7e3)
# clips every other leaf's gradient by ~250x, and the small
# RetinaNetOBB's P7 conv (neck.extra1) then moves by ~4 ulps: the card
# and the CPU differed there by one ulp of one weight, 2.1e-2 of the
# leaf's largest update, while the update as a whole differed by 4.3e-4
# relative L2 (NVIDIA H100 80GB HBM3, 700.00 W)
UPDATE_RESOLUTION = 128
# the reference train steps run with cuDNN off: against the CPU's
# float64 update, cuDNN's float32 (TF32 off) differed by up to 1.16e-2
# of a leaf's largest update on a 15-class small RetinaNetOBB and
# 5.8e-2 on this 5-class one, PyTorch's own CUDA convolutions by 1.0e-3
# and 9.3e-4, the CPU's float32 by 1.1e-3 and 9.3e-4 (the card's
# float64 by 6.4e-7; NVIDIA H100 80GB HBM3, 700.00 W,
# tools/torch_grad_precision.py): the phase holds the port's
# arithmetic, not cuDNN's choice of algorithm


def small_h_obb(robust=False):
    """The small architecture (`SMALL_MODEL`) with a hobb rbbox head."""
    return dict(SMALL_MODEL, rbbox_encode="hobb", hobb_robust_loss=robust,
                rbbox_head=dict(SMALL_MODEL["rbbox_head"], encode="hobb"))


# the r18_e2e recipe (GroupNorm ResNet-18 and FPN from scratch) and the
# slice's other configs, each run as written
E2E_THETA_CONFIG = "configs/dota_theta_obb_r18_e2e.py"
E2E_RROI_CONFIG = "configs/dota_rroi_point_obb_r18_e2e.py"
OHEM_CONFIG = "configs/dota_theta_obb_ohem_r50_fpn_1x.py"
SOFT_NMS_CONFIG = "configs/dota_centermap_net_tgrs_reverse_seg_weight_v4.py"
HRNET_CONFIG = "configs/dota_centermap_obb_hrnet_ms.py"
E2E = dict(img=512, batch=2, calls=3, steps=3, max_gt=64)
OHEM = dict(DETECTORS, calls=0)
GN_CFG = dict(type="GN", num_groups=32)
K1 = dict(roi_align=1)
K2 = dict(roi_align_train_forward=1, roi_align_backward=1)
K4 = dict(rroi_align=1)
K4_TRAIN = dict(rroi_align=1, rroi_align_backward=1)


def small_gn(rroi=False):
    """The small architecture with the r18_e2e recipe's GroupNorm in its
    ResNet-18 and FPN; with ``rroi`` the RBBoxRCNNRRoI's pointobb and
    rtheta heads."""
    model = dict(SMALL_MODEL, backbone=dict(type="ResNet", depth=18,
                                            norm_cfg=GN_CFG),
                 neck=dict(SMALL_MODEL["neck"], norm_cfg=GN_CFG))
    if rroi:
        head = dict(SMALL_MODEL["rbbox_head"], encode="pointobb")
        model.update(type="RBBoxRCNNRRoI", rbbox_head=head,
                     rbbox_encode="pointobb",
                     rbbox_refine_head=dict(head, encode="rtheta"))
    return model


def _small(model, retina=False):
    return (dict(model=model, test_cfg=SMALL_RETINA_TEST_CFG) if retina else
            dict(model=model, train_cfg=SMALL_TRAIN_CFG,
                 test_cfg=SMALL_TEST_CFG))


# each detector kind of the detector phases: its config as written, its
# small architecture (a function of hobb_robust_loss), the sizes of its
# paths, and its launches a predict call and a train step on the card
KINDS = dict(
    retinanet_obb=dict(config=RETINA_OBB_CONFIG, sizes=DETECTORS,
                       small=lambda r: _small(SMALL_RETINA_OBB, True),
                       predict={}, train={}),
    h_obb=dict(config=H_OBB_CONFIG, sizes=DETECTORS,
               small=lambda r: _small(small_h_obb(r)), predict=K1, train=K2),
    gn_theta=dict(config=None, sizes=None, small=lambda r: _small(small_gn()),
                  predict=K1, train=K2),
    gn_rroi=dict(config=None, sizes=None,
                 small=lambda r: _small(small_gn(rroi=True)),
                 predict=dict(K1, **K4), train=dict(K2, **K4_TRAIN)),
    theta_r18_e2e=dict(config=E2E_THETA_CONFIG, sizes=E2E,
                       small=lambda r: _small(small_gn()), predict=K1,
                       train=K2),
    rroi_r18_e2e=dict(config=E2E_RROI_CONFIG, sizes=E2E,
                      small=lambda r: _small(small_gn(rroi=True)),
                      predict=dict(K1, **K4), train=dict(K2, **K4_TRAIN)),
    # OHEM scores every candidate without gradient (a K2 forward), then
    # trains on its sample (a K2 forward and backward)
    ohem=dict(config=OHEM_CONFIG, sizes=OHEM,
              small=lambda r: dict(_small(SMALL_MODEL), train_cfg=dict(
                  SMALL_TRAIN_CFG, rcnn=dict(sampler="ohem",
                                             num_samples=32))),
              predict=K1, train=dict(K2, roi_align_train_forward=2)))


def detector(kind, device, small, train=False, robust=False, seed=0,
             train_cfg=None, img=256):
    """The small (for ``img``^2 images) or full detector of ``kind`` (a
    key of `KINDS`; ``robust``: an H-OBB model's hobb_robust_loss) from
    `build_detector` with seeded weights, RetinaNetOBB's `retina_cls`
    bias 0, a small RBBoxRCNNRRoI's training build with its first
    stage's regression set as `POINTOBB_BIAS` says; returns (model, the
    encode of its gt rboxes)."""
    import torch
    from aidet_tpu_torch.models.builder import build_detector
    from aidet_tpu_torch.models.detectors.two_stage import _merge
    from aidet_tpu_torch.utils.config import Config
    spec = KINDS[kind]
    if small:
        cfg = spec["small"](robust)
        cfg["model"] = dict(cfg["model"], img_size=img)
    else:
        cfg = Config.fromfile(spec["config"]).to_dict()
        if kind == "h_obb":
            cfg["model"] = dict(cfg["model"], hobb_robust_loss=robust)
    model = build_detector(cfg["model"], train_cfg=_merge(
        cfg.get("train_cfg") or {}, train_cfg), test_cfg=cfg.get("test_cfg"),
        device=device, seed=seed, train=train)
    if kind == "retinanet_obb":
        with torch.no_grad():
            model.bbox_head.retina_cls.bias.zero_()
        return model, "thetaobb"
    if small and train and model.rbbox_refine_head is not None:
        reg = model.rbbox_head.fc_reg
        with torch.no_grad():
            reg.weight.mul_(0.01)
            reg.bias.copy_(torch.tensor(POINTOBB_BIAS).repeat(
                reg.bias.numel() // len(POINTOBB_BIAS)))
    return model, model.rbbox_head.encode


def detector_step_once(kind, device, img, n_gt, train_cfg=None, robust=False,
                       seed=0, dtype=None):
    """One train step of the small ``kind`` detector on ``device``: as
    `train_step_once`, its gts in the detector's encode; with ``dtype``
    (float64) the model, its compute and the batch in it (the
    parameters before the step are returned as built, in float32)."""
    import torch
    from aidet_tpu_torch.flagship import synthetic_train_batch
    from aidet_tpu_torch.parallel.train import (build_lr_schedule,
                                                build_optimizer,
                                                create_train_state,
                                                make_train_step)
    net, encode = detector(kind, device, True, train=True, robust=robust,
                           seed=seed, train_cfg=train_cfg, img=img)
    before = [p.detach().cpu().clone() for p in net.parameters()]
    batch = synthetic_train_batch(2, img, n_gt, seed, device, encode)
    if dtype is not None:
        net = net.to(dtype)
        net.compute_dtype = dtype
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in batch.items()}
    params = list(net.parameters())
    optimizer = build_optimizer(build_lr_schedule(base_lr=0.01))
    state = create_train_state(net, optimizer)
    step = make_train_step(net, optimizer)
    _, metrics = step(state, batch,
                      torch.Generator(device=device).manual_seed(seed))
    return ({k: float(v) for k, v in metrics.items()}, before,
            [p.detach().cpu() for p in params])


def run_detector_reference(device="cuda", kind="retinanet_obb", img=256):
    """The small ``kind`` detector (float32, TF32 off) on ``device``
    against the CPU with the same weights: predict on 2 seeded uint8
    images (`match_detections`: every detection paired; a detection at
    the max_per_img cut whose score ties the other run's last may be
    another member of the tie), then one train step (`compare_steps`
    with `DETECTOR_REF_TRAIN_LIMITS`, the per-leaf limit on the leaves
    whose update float32 resolves, `UPDATE_RESOLUTION`), its
    convolutions PyTorch's own CUDA kernels (cuDNN off, as the note at
    `UPDATE_RESOLUTION` says); RetinaNetOBB
    samples nothing, the two-stage models run under a train_cfg that
    keeps every candidate (the H-OBB model once without and once with
    hobb_robust_loss), but for OHEM's RoI sample, which is deterministic
    given the head.  The RBBoxRCNNRRoI's rboxes are compared where its
    first-stage quad is clear of a tie (`rbox_clear_of_ties`), and its
    update held to 2e-3 relative L2, as rroi_reference_train's.  The
    GroupNorm models' float32 update lies farther from float64 than the
    others' on either device (`GN_FLOAT32_NOTE`): their card step and
    their CPU step are each held to the CPU's float64 step, and the
    card's distance to it may exceed the limits only up to twice the
    CPU's own (losses still card against CPU).  Returns the phase's
    fields."""
    import torch
    from aidet_tpu_torch.flagship import keep_every_candidate_cfg
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n_gt = 8
    imgs = torch.randint(0, 256, (2, img, img, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    shapes = torch.full((2, 2), float(img))
    models = [detector(kind, d, True, img=img)[0] for d in (device, "cpu")]
    got, ref = ({k: v.cpu() for k, v in m.predict(
        imgs.to(d), shapes.to(d)).items()}
        for m, d in zip(models, (device, "cpu")))
    limits = REF_LIMITS.get(kind, H_OBB_REF_LIMITS)
    clear = None
    if getattr(models[1], "rbbox_refine_head", None) is not None:
        clear = rbox_clear_of_ties(first_stage_quads(models[1], imgs, shapes))
    errs = match_detections(got, ref, limits, rbox_clear=clear,
                            cut_slack=True)
    net = models[1]
    names = [n for n, _ in net.named_parameters()]
    cfg = None if kind == "retinanet_obb" else keep_every_candidate_cfg(
        img, n_gt, net.train_cfg["rpn_proposal"]["max_num"])
    if kind == "ohem":
        cfg = dict(rpn=cfg["rpn"])
    train_limits = (dict(DETECTOR_REF_TRAIN_LIMITS, update_rel_l2=2e-3)
                    if clear is not None else DETECTOR_REF_TRAIN_LIMITS)
    train = {}
    for robust in (False, True) if kind == "h_obb" else (False,):
        with torch.backends.cudnn.flags(enabled=False):
            steps = [detector_step_once(kind, d, img, n_gt, cfg, robust)
                     for d in (device, "cpu")]
        if kind.startswith("gn_"):
            t = gn_step_against_float64(
                kind, steps, lambda d, dtype: detector_step_once(
                    kind, d, img, n_gt, cfg, robust, dtype=dtype),
                train_limits, names)
        else:
            t = compare_steps(f"{kind}_reference", *steps, train_limits,
                              resolved_only=True)
            t["worst_leaf"] = names[t["worst_leaf"]]
        train["robust" if robust else "plain"] = dict(
            losses_card=steps[0][0], losses_cpu=steps[1][0], **t)
    return dict(img=img, tf32=False, n_valid=int(got["valid"].sum()),
                max_abs_err=errs, limits=limits, gts=n_gt,
                train_cudnn=False, train=train)


# the small GroupNorm models' first-step update in float32 against the
# CPU's float64, on the CPU alone (gn_reference's own fields on the
# card's machine): 9.9e-4 relative L2 with its default threads and
# 2.8e-3 with one (thetaobb), 4.3e-4 and 7.2e-3 (RBBoxRCNNRRoI), the
# worst leaf at 2.2e-2 and 6.1e-2 of its largest update with one
# thread -- the float32 rounding of the GroupNorm statistics' sums
# moves stage 3's update most
GN_FLOAT32_NOTE = ("the GroupNorm models' float32 update lies up to "
                   "7.2e-3 relative L2 and 6.1e-2 of a leaf's largest "
                   "update from float64 on the CPU alone, by its thread "
                   "count")


def gn_step_against_float64(kind, steps, step_once, limits, names,
                            note=GN_FLOAT32_NOTE):
    """A GroupNorm model's card and CPU float32 steps (``steps``) against
    the CPU's float64 step (``step_once(device, dtype)`` makes one):
    the losses card against CPU within ``limits``; the update's relative
    L2 and worst leaf of the card against float64 within the larger of
    ``limits`` and twice the farthest of the CPU's float32 steps from
    float64 (with its default threads, and with one: the order of its
    sums moves the update as far as the device does).  Returns the
    fields."""
    import torch
    f64 = step_once("cpu", torch.float64)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = step_once("cpu", None)
    finally:
        torch.set_num_threads(threads)
    compare_steps(f"{kind}_reference (losses)", steps[0],
                  (steps[1][0], steps[0][1], steps[0][2]),
                  dict(limits, update_rel_l2=math.inf,
                       leaf_over_largest=math.inf))
    card, cpu, cpu_one = (compare_steps(f"{kind}_reference", st, f64,
                                        resolved_only=True)
                          for st in (*steps, one))
    for key, limit in (("update_rel_l2", limits["update_rel_l2"]),
                       ("worst_leaf_err_over_largest",
                        limits["leaf_over_largest"])):
        bound = max(limit, 2 * cpu[key], 2 * cpu_one[key])
        if not card[key] <= bound:
            raise AssertionError(f"{kind}_reference: the card's {key} "
                                 f"{card[key]} against float64 exceeds "
                                 f"{bound} (the CPU's float32: {cpu[key]}, "
                                 f"with one thread {cpu_one[key]})")
    for t in (card, cpu, cpu_one):
        t["worst_leaf"] = names[t["worst_leaf"]]
    return dict(card_against_float64=card, cpu_against_float64=cpu,
                cpu_one_thread_against_float64=cpu_one,
                losses_float64=f64[0], limits=limits, note=note)


def staged_retina_predict(model, imgs, shapes, sync):
    """RetinaNetOBB's predict in its stages, each timed on the host clock
    between ``sync`` calls: features (normalize, backbone, FPN), head,
    top-k and decode, rotated multiclass NMS.  Returns (outputs, stage
    ms, candidates entering each image's NMS: per class its valid
    candidates up to the top-k of 256)."""
    import torch
    from aidet_tpu_torch.core.rboxes import RBBOX_CODECS, pointobb2bbox
    from aidet_tpu_torch.models.heads import anchor_head as ah
    ec = model.test_cfg
    stages, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        sync()
        now = time.perf_counter()
        stages[name] = (now - t) * 1e3
        t = now
    with torch.no_grad():
        feats = model.extract_feat(imgs)
        lap("features")
        cls_flat, reg_flat = model._head(feats)
        lap("head")
        dim, _, decode, to_quad = RBBOX_CODECS[model.rbox_encode]
        a, d, s = ah.topk_per_level(cls_flat, reg_flat, model.anchors,
                                    model.level_sizes, ec["nms_pre"])
        rboxes = decode(a, d, model.target_means, model.target_stds)
        quads = to_quad(rboxes)
        lap("topk_decode")
        res, rboxes = ah.rotated_detections(
            rboxes, quads, s, ec["score_thr"], ec.get("rnms_thr",
                                                      model.rnms_thr),
            ec["max_per_img"])
        lap("rotated_nms")
    per_class = (s > ec["score_thr"]).sum(1)                  # [B, C]
    cand = per_class.clamp(max=max(256, ec["max_per_img"])).sum(-1)
    out = dict(boxes=pointobb2bbox(res.boxes), scores=res.scores,
               labels=res.labels, valid=res.valid, rboxes=rboxes)
    return out, stages, [int(c) for c in cand]


def run_detector_paths(device="cuda", small=False, kind="retinanet_obb",
                       seed=0):
    """``kind``'s config as written (float32 with cuDNN's TF32, as
    PyTorch's default; `retina_cls`'s bias 0), or with ``small`` its
    small architecture: ``calls`` predict calls on 2 seeded uint8
    images (ms per call, detections, peak memory; RetinaNetOBB's also
    in stages, `staged_retina_predict`, held equal to predict), then 1
    warm-up and ``steps`` timed train steps on `synthetic_train_batch`
    with ``max_gt`` gts in the detector's encode (every loss finite, the
    heads' parameters moved, ms per step, peak memory).  Launches, per
    call and per step on the card, are `KINDS`': RetinaNetOBB none; the
    two-stage models K1 once a call and K2 once forward and once
    backward a step, the RBBoxRCNNRRoI K4 besides, OHEM K2's forward
    twice (its scoring pass's and its sample's rois counted in
    ``k2_forward_rois_per_step``; OHEM runs no predict call).  Returns
    {"predict": fields, "train": fields}."""
    import torch
    from aidet_tpu_torch.flagship import synthetic_train_batch
    from aidet_tpu_torch.parallel.train import (build_lr_schedule,
                                                build_optimizer,
                                                create_train_state,
                                                make_train_step)
    spec = KINDS[kind]
    sizes = (dict(DETECTORS_SMALL, calls=min(spec["sizes"]["calls"], 1))
             if small else spec["sizes"])
    b, img = sizes["batch"], sizes["img"]
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def per(counts, n):
        want = dict.fromkeys(HANDLES, 0)
        if on_card:
            want.update({k: v * n for k, v in counts.items()})
        return want
    out = {}
    with tf32_defaults():
        model, encode = detector(kind, device, small, seed=seed, img=img)
        imgs = torch.randint(0, 256, (b, img, img, 3), dtype=torch.uint8,
                             generator=torch.Generator().manual_seed(seed))
        imgs = imgs.to(device)
        shapes = torch.full((b, 2), float(img), device=device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        times = []
        for _ in range(sizes["calls"]):
            sync()
            t0 = time.perf_counter()
            pred = model.predict(imgs, shapes)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = launch_counts()
        fields = dict(calls=len(times), call_ms=times,
                      ms_per_call=sum(times) / max(len(times), 1),
                      n_valid=int(pred["valid"].sum()) if times else 0,
                      peak_memory_gib=(torch.cuda.max_memory_allocated()
                                       / 2 ** 30 if on_card else None))
        if kind == "retinanet_obb":
            staged = [staged_retina_predict(model, imgs, shapes, sync)
                      for _ in range(sizes["calls"])]
            for key in pred:
                if not torch.equal(staged[-1][0][key], pred[key]):
                    raise AssertionError(f"{kind}: the staged predict's "
                                         f"{key} differs from predict's")
            fields.update(
                stage_ms={k: [s[1][k] for s in staged]
                          for k in staged[0][1]},
                nms_candidates_per_image=staged[-1][2])
        want = per(spec["predict"], len(times))
        if launches != want:
            raise AssertionError(f"{kind} predict: launches {launches} in "
                                 f"{len(times)} calls, expected {want}")
        if times and (not all(bool(torch.isfinite(v.float()).all())
                              for v in pred.values())
                      or fields["n_valid"] == 0):
            raise AssertionError(f"{kind} predict: {fields}")
        if times:
            out["predict"] = dict(fields, launches=launches)
            del pred
        del model

        net = detector(kind, device, small, train=True, seed=seed,
                       img=img)[0]
        params = list(net.parameters())
        before = [p.detach().clone() for p in params]
        optimizer = build_optimizer(build_lr_schedule(base_lr=0.01))
        state = create_train_state(net, optimizer)
        step = make_train_step(net, optimizer)
        data = synthetic_train_batch(b, img, sizes["max_gt"], seed, device,
                                     encode)
        gen = torch.Generator(device=device).manual_seed(seed)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, data, gen)
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        launch_counts(reset=True)
        times, losses = [], []
        for _ in range(sizes["steps"]):
            sync()
            t0 = time.perf_counter()
            state, metrics = step(state, data, gen)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(v) for k, v in metrics.items()})
        launches = launch_counts()
    n = len(times)
    bad = [(i, k) for i, m in enumerate(losses) for k, v in m.items()
           if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{kind} train: not finite {bad}")
    want = per(spec["train"], n)
    if launches != want:
        raise AssertionError(f"{kind} train: launches {launches} in {n} "
                             f"steps, expected {want}")
    names = [nm for nm, _ in net.named_parameters()]
    still = [nm for nm, a, p in zip(names, before, params)
             if torch.equal(a, p.detach()) and nm.split(".")[0].endswith(
                 "_head")]
    if still:
        raise AssertionError(f"{kind} train: heads did not move: {still}")
    ms = sum(times) / n
    out["train"] = dict(
        steps=n, max_gt=sizes["max_gt"], encode=encode, losses=losses,
        first_step_ms=first_ms, step_ms=times, ms_per_step=ms,
        images_per_s=b * 1e3 / ms, launches=launches,
        peak_memory_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if on_card else None))
    if kind == "ohem":
        # the scoring pass crops every candidate (the gts, then the
        # proposals), the sample's pass num_samples rois an image
        tc = net.train_cfg
        out["train"]["k2_forward_rois_per_step"] = dict(
            ohem_scoring=b * (sizes["max_gt"] + tc["rpn_proposal"]["max_num"]),
            sample=b * tc["rcnn"]["num_samples"])
    out["config"] = spec["config"] + (" (small architecture)" if small
                                      else "")
    out["img"], out["batch"] = img, b
    out["dtype"] = ("float32 parameters and compute (the config names "
                    "none); TF32 in cuDNN's convolutions (PyTorch's "
                    "default)")
    return out


# Slice 12: the repo's remaining DOTA configs.  Soft-NMS (CenterMap-Net
# as written with test_cfg.rcnn.nms soft, against the same weights with
# hard NMS), HRNet-W32 + HRFPN CenterMapOBB (predict, train through
# `TrainPipeline` at its scale_range, multi-scale flip TTA), and the
# port's first learning run (the r18_e2e recipe from seeded random
# weights on synthetic patches, scored by the DOTA eval on them)
SOFT_NMS_SMALL_TEST_CFG = dict(SMALL_TEST_CFG, rcnn=dict(
    max_per_img=16, nms=dict(type="soft_nms")))
HRNET = dict(img=1024, batch=2, calls=3, steps=2, objects=60)
HRNET_SMALL = dict(img=256, batch=2, calls=1, steps=1, objects=12)
# a narrow HRNet with HRFPN at the small architecture's widths
SMALL_HRNET = dict(
    type="CenterMapOBB",
    backbone=dict(type="HRNet", width=16, stage_modules=(1, 1, 1, 1),
                  stage_blocks=2),
    neck=dict(type="HRFPN", in_channels=(16, 32, 64, 128), out_channels=64,
              num_outs=5),
    rpn_head=SMALL_MODEL["rpn_head"], bbox_head=SMALL_MODEL["bbox_head"],
    mask_head=dict(type="CenterMapHead", num_convs=2, in_channels=64,
                   conv_out_channels=64, num_classes=16))
# the learning run: 8 seeded patches of 512^2 (10 objects each, every
# patch its own scene), at most 600 steps at batch 2 (150 epochs of 4
# steps), the config's optimizer, its warmup cut to 50 steps and its
# step decay at the same fractions of the run (epochs 9 and 11 of 12);
# scored on the same scenes.  Random weights score an OBB mAP near 0.
LEARN = dict(patches=8, size=512, objects=10, epochs=150, batch=2,
             warmup=50)
LEARN_SMALL = dict(patches=2, size=256, objects=6, epochs=2, batch=2,
                   warmup=1)
LEARN_MAP_BAR = 0.5
# aug_test_image on the card against the CPU: the small thetaobb model's
# merged detections paired as the reference phases pair predict's
TTA_REF_LIMITS = dict(boxes=1.0, scores=1e-2)


def timed_nms(sync):
    """A context in which `TwoStageDetector`'s multiclass NMS (the
    bbox_decode_nms stage's NMS: hard or soft) is timed on the host
    clock between ``sync`` calls; yields the list of its ms."""
    import contextlib
    from aidet_tpu_torch.models.detectors import two_stage

    @contextlib.contextmanager
    def swap():
        inner, ms = two_stage.multiclass_nms, []

        def timed(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            return out
        two_stage.multiclass_nms = timed
        try:
            yield ms
        finally:
            two_stage.multiclass_nms = inner
    return swap()


def soft_nms_models(device, small, seed=0):
    """The soft-NMS CenterMap-Net (`SOFT_NMS_CONFIG` as written, or the
    small CenterMap-Net under soft-NMS) and the same weights under hard
    NMS at the same IoU threshold: {"soft": model, "hard": model}."""
    from aidet_tpu_torch.models.builder import build_detector
    from aidet_tpu_torch.models.detectors.two_stage import _merge
    from aidet_tpu_torch.ops.nms import nms_cfg_kwargs
    from aidet_tpu_torch.utils.config import Config
    if small:
        model_cfg = dict(small_mask_model("centermap"), img_size=256)
        test_cfg, train_cfg = SOFT_NMS_SMALL_TEST_CFG, SMALL_TRAIN_CFG
    else:
        cfg = Config.fromfile(SOFT_NMS_CONFIG).to_dict()
        model_cfg, test_cfg, train_cfg = (cfg["model"], cfg["test_cfg"],
                                          cfg["train_cfg"])
    thr = nms_cfg_kwargs(test_cfg["rcnn"])["iou_thr"]
    hard = _merge(test_cfg, dict(rcnn=dict(nms=dict(type="nms",
                                                    iou_thr=thr))))
    return {name: build_detector(model_cfg, train_cfg=train_cfg,
                                 test_cfg=t, device=device, seed=seed)
            for name, t in (("soft", test_cfg), ("hard", hard))}


def run_soft_nms(device="cuda", small=False, seed=0):
    """CenterMap-Net under soft-NMS (`soft_nms_models`) and the same
    weights under hard NMS, ``calls`` predict calls each on 2 seeded
    uint8 images under `tf32_defaults`: ms per call, the bbox_decode_nms
    stage's multiclass NMS ms (`timed_nms`), detections, K1's launches
    (4 a call on the card: 7x7 and 14x14, multi-level and on the
    semantic map), peak memory.  Returns the phase's fields."""
    import torch
    sizes = CENTERMAP_SMALL if small else CENTERMAP
    b, img = sizes["batch"], sizes["img"]
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()
    out = {}
    with tf32_defaults():
        models = soft_nms_models(device, small, seed)
        imgs = torch.randint(0, 256, (b, img, img, 3), dtype=torch.uint8,
                             generator=torch.Generator().manual_seed(seed))
        imgs = imgs.to(device)
        shapes = torch.full((b, 2), float(img), device=device)
        for name, model in models.items():
            model.predict(imgs, shapes)           # warm
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            launch_counts(reset=True)
            times = []
            with timed_nms(sync) as nms_ms:
                for _ in range(sizes["calls"]):
                    sync()
                    t0 = time.perf_counter()
                    pred = model.predict(imgs, shapes)
                    sync()
                    times.append((time.perf_counter() - t0) * 1e3)
            launches = launch_counts()
            want = dict.fromkeys(HANDLES, 0)
            if on_card:
                want["roi_align"] = 4 * len(times)
            if launches != want:
                raise AssertionError(f"soft_nms {name}: launches {launches} "
                                     f"in {len(times)} calls, expected "
                                     f"{want}")
            if not all(bool(torch.isfinite(v.float()).all())
                       for v in pred.values()) or not pred["valid"].any():
                raise AssertionError(f"soft_nms {name}: outputs not finite "
                                     "or empty")
            out[name] = dict(
                nms=model.test_cfg["rcnn"].get("nms"), call_ms=times,
                ms_per_call=sum(times) / len(times),
                nms_ms=nms_ms, nms_ms_per_call=sum(nms_ms) / len(nms_ms),
                n_valid=int(pred["valid"].sum()),
                score_mean=float(pred["scores"][pred["valid"]].mean()),
                launches=launches,
                peak_memory_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                                 if on_card else None))
    return dict(config=SOFT_NMS_CONFIG + (" (small architecture)"
                                          if small else ""),
                img=img, batch=b,
                max_per_img=models["soft"].test_cfg["rcnn"]["max_per_img"],
                dtype="float32 (the config names none); TF32 in cuDNN's "
                "convolutions (PyTorch's default)", **out,
                launches=out["soft"]["launches"])


def run_soft_nms_reference(device="cuda"):
    """The small CenterMap-Net under soft-NMS (float32, TF32 off) on
    ``device`` against the CPU with the same weights: predict's
    detections, their decayed scores and masks paired
    (`MASK_REF_LIMITS`).  Returns the phase's fields."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img = 256
    imgs = torch.randint(0, 256, (2, img, img, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    shapes = torch.full((2, 2), float(img))
    got, ref = ({k: v.cpu() for k, v in soft_nms_models(d, True)[
        "soft"].predict(imgs.to(d), shapes.to(d)).items()}
        for d in (device, "cpu"))
    errs = match_detections(got, ref, MASK_REF_LIMITS, cut_slack=True)
    return dict(model="small CenterMap-Net float32, soft-NMS", img=img,
                tf32=False, n_valid=int(got["valid"].sum()),
                max_abs_err=errs, limits=MASK_REF_LIMITS)


def hrnet_model(device, small, seed=0, train=False):
    """`HRNET_CONFIG` as written (float32: it names no dtype), or with
    ``small`` `SMALL_HRNET` at 256^2 (its pipeline's scale_range and
    TTA scales scaled alike), from `build_detector` with seeded
    weights; returns (model, config dict)."""
    from aidet_tpu_torch.models.builder import build_detector
    from aidet_tpu_torch.utils.config import Config
    cfg = Config.fromfile(HRNET_CONFIG).to_dict()
    if small:
        cfg.update(model=dict(SMALL_HRNET, img_size=256),
                   train_cfg=SMALL_TRAIN_CFG, test_cfg=SMALL_TEST_CFG,
                   train_pipeline=dict(cfg["train_pipeline"], img_size=256,
                                       max_gt=64, scale_range=(192, 256)),
                   tta=dict(cfg["tta"], scales=(192, 256)))
    model = build_detector(cfg["model"], train_cfg=cfg["train_cfg"],
                           test_cfg=cfg["test_cfg"], device=device,
                           seed=seed, train=train)
    return model, cfg


def run_hrnet_reference(device="cuda"):
    """The small HRNet CenterMapOBB (`SMALL_HRNET`, float32, TF32 off)
    on ``device`` against the CPU with the same weights: predict's
    detections and masks paired (`MASK_REF_LIMITS`).  Returns the
    phase's fields."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img = 256
    imgs = torch.randint(0, 256, (2, img, img, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    shapes = torch.full((2, 2), float(img))
    got, ref = ({k: v.cpu() for k, v in hrnet_model(d, True)[0].predict(
        imgs.to(d), shapes.to(d)).items()} for d in (device, "cpu"))
    errs = match_detections(got, ref, MASK_REF_LIMITS, cut_slack=True)
    return dict(model="small HRNet-W16 + HRFPN CenterMapOBB float32",
                img=img, tf32=False, n_valid=int(got["valid"].sum()),
                max_abs_err=errs, limits=MASK_REF_LIMITS)


def hrnet_batches(cfg, root, sizes, seed):
    """``sizes["steps"] + 1`` batches of ``sizes["batch"]`` made by the
    port's `TrainPipeline` (the config's train_pipeline: its scale_range,
    CenterMap masks, uint8 transfer) from seeded synthetic PNG patches;
    and the pipeline's host ms per image."""
    from aidet_tpu_torch.data.builder import build_dataset
    from aidet_tpu_torch.data.imio import imread
    from aidet_tpu_torch.data.pipeline import TrainPipeline, collate_batch
    n = sizes["batch"] * (sizes["steps"] + 1)
    ann, prefix, _ = write_patch_set(root, 0, n, sizes["img"],
                                     sizes["objects"], seed)
    dataset = build_dataset(dict(cfg["data"]["train"], ann_file=ann,
                                 img_prefix=prefix))
    pipe = TrainPipeline(**dict(cfg["train_pipeline"], device_normalize=True,
                                seed=seed))
    t0 = time.perf_counter()
    samples = [pipe(imread(dataset.img_path(i)), dataset.parse_anns(i))
               for i in range(n)]
    ms = (time.perf_counter() - t0) * 1e3 / n
    b = sizes["batch"]
    return [collate_batch(samples[i:i + b]) for i in range(0, n, b)], ms


def run_hrnet(device="cuda", small=False, seed=0):
    """HRNet-W32 + HRFPN CenterMapOBB (`hrnet_model`) under
    `tf32_defaults`: ``calls`` predict calls on 2 seeded uint8 images
    (ms per call, K1 twice a call on the card: 7x7 and 14x14), then
    `apis.tta.aug_test_image` of one seeded synthetic scene at the
    config's ``tta`` (scales x flip: 4 variants, each on the model's
    canvas; one warm-up image, then one timed: ms per TTA image, K1 per
    variant, merged detections and quads), then the trainer's build on
    `hrnet_batches`: 1 warm-up and ``steps`` timed train steps (every
    loss finite, the heads moved, ms per step, K2 twice forward and
    twice backward a step on the card), peak memory.  Returns the
    phase's fields."""
    import tempfile

    import torch
    from aidet_tpu_torch.apis.tta import aug_test_image
    from aidet_tpu_torch.parallel.train import (build_lr_schedule,
                                                build_optimizer,
                                                create_train_state,
                                                make_train_step)
    sizes = HRNET_SMALL if small else HRNET
    b, img = sizes["batch"], sizes["img"]
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()
    out = {}
    with tf32_defaults():
        model, cfg = hrnet_model(device, small, seed)
        imgs = torch.randint(0, 256, (b, img, img, 3), dtype=torch.uint8,
                             generator=torch.Generator().manual_seed(seed))
        imgs = imgs.to(device)
        shapes = torch.full((b, 2), float(img), device=device)
        model.predict(imgs, shapes)               # warm
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        times = []
        for _ in range(sizes["calls"]):
            sync()
            t0 = time.perf_counter()
            pred = model.predict(imgs, shapes)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = launch_counts()
        want = dict.fromkeys(HANDLES, 0)
        if on_card:
            want["roi_align"] = 2 * len(times)
        if launches != want or not pred["valid"].any() or not all(
                bool(torch.isfinite(v.float()).all()) for v in pred.values()):
            raise AssertionError(f"hrnet predict: launches {launches} "
                                 f"(expected {want}), valid "
                                 f"{int(pred['valid'].sum())}")
        out["predict"] = dict(
            calls=len(times), call_ms=times, ms_per_call=sum(times) / len(
                times), n_valid=int(pred["valid"].sum()), launches=launches,
            peak_memory_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                             if on_card else None))

        tta = dict(cfg["tta"])
        scene = synth_scene(seed + 100, img, sizes["objects"])[0]
        aug_test_image(model, scene, scales=tta["scales"],
                       flip=tta["flip"])          # warm
        sync()
        launch_counts(reset=True)
        t0 = time.perf_counter()
        merged = aug_test_image(model, scene, scales=tta["scales"],
                                flip=tta["flip"])
        sync()
        tta_ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts()
        variants = len(tta["scales"]) * (2 if tta["flip"] else 1)
        want = dict.fromkeys(HANDLES, 0)
        if on_card:
            want["roi_align"] = 2 * variants
        if launches != want or "quads" not in merged:
            raise AssertionError(f"hrnet tta: launches {launches} (expected "
                                 f"{want}), keys {sorted(merged)}")
        out["tta"] = dict(
            scales=list(tta["scales"]), flip=tta["flip"], variants=variants,
            ms_per_image=tta_ms, launches=launches,
            merged_boxes=len(merged["boxes"]),
            merged_quads=len(merged["quads"]))
        del model, pred

        net = hrnet_model(device, small, seed, train=True)[0]
        with tempfile.TemporaryDirectory() as root:
            batches, host_ms = hrnet_batches(cfg, root, sizes, seed)
        data = [{k: (torch.from_numpy(v).long() if v.dtype.kind == "i"
                     else torch.from_numpy(v)).to(device)
                 for k, v in bt.items()} for bt in batches]
        params = list(net.parameters())
        before = [p.detach().clone() for p in params]
        optimizer = build_optimizer(build_lr_schedule(
            base_lr=cfg["optimizer"]["lr"]))
        state = create_train_state(net, optimizer)
        step = make_train_step(net, optimizer)
        gen = torch.Generator(device=device).manual_seed(seed)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, data[0], gen)
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        launch_counts(reset=True)
        times, steps = [], []
        for batch in data[1:]:
            sync()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, gen)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            steps.append({k: float(v) for k, v in metrics.items()})
        launches = launch_counts()
    n = len(times)
    bad = [(i, k) for i, m in enumerate(steps) for k, v in m.items()
           if not math.isfinite(v)]
    want = dict.fromkeys(HANDLES, 0)
    if on_card:
        want.update(roi_align_train_forward=2 * n, roi_align_backward=2 * n)
    if bad or "loss_mask" not in steps[0] or launches != want:
        raise AssertionError(f"hrnet train: not finite {bad}, launches "
                             f"{launches} (expected {want})")
    names = [nm for nm, _ in net.named_parameters()]
    still = [nm for nm, a, p in zip(names, before, params)
             if torch.equal(a, p.detach()) and nm.split(".")[0].endswith(
                 "_head")]
    if still:
        raise AssertionError(f"hrnet train: heads did not move: {still}")
    ms = sum(times) / n
    out["train"] = dict(
        steps=n, losses=steps, first_step_ms=first_ms, step_ms=times,
        ms_per_step=ms, images_per_s=b * 1e3 / ms, launches=launches,
        scale_range=list(cfg["train_pipeline"]["scale_range"]),
        img_shapes=[[float(x) for x in bt["img_shapes"].reshape(-1)]
                    for bt in batches[1:]],
        pipeline_ms_per_image=host_ms,
        peak_memory_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if on_card else None))
    return dict(config=HRNET_CONFIG + (" (small architecture)" if small
                                       else ""),
                img=img, batch=b, dtype="float32 (the config names none); "
                "TF32 in cuDNN's convolutions (PyTorch's default)", **out)


def run_tta_reference(device="cuda"):
    """`apis.tta.aug_test_image` of the small thetaobb model (float32,
    TF32 off) on one seeded 200 x 256 image at scales (192, 256) with
    flip, on ``device`` against the CPU with the same weights: the
    merged boxes paired by label (`TTA_REF_LIMITS`), the same count of
    merged quads.  Returns the phase's fields."""
    import numpy as np
    import torch
    from aidet_tpu_torch.apis.tta import aug_test_image
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img = np.random.RandomState(2).randint(0, 256, (200, 256, 3)).astype(
        np.uint8)
    outs = []
    for d in (device, "cpu"):
        model = detector("gn_theta", d, True, img=256)[0]
        outs.append(aug_test_image(model, img, scales=(192, 256), flip=True,
                                   rbox_encode="thetaobb"))

    def batch(m):
        k = len(m["scores"])
        return dict(boxes=torch.from_numpy(m["boxes"][None]),
                    scores=torch.from_numpy(m["scores"][None]),
                    labels=torch.from_numpy(m["labels"][None]).long(),
                    valid=torch.ones(1, k, dtype=torch.bool))
    errs = match_detections(batch(outs[0]), batch(outs[1]), TTA_REF_LIMITS)
    if len(outs[0]["quads"]) != len(outs[1]["quads"]):
        raise AssertionError(f"tta_reference: {len(outs[0]['quads'])} "
                             f"merged quads against {len(outs[1]['quads'])}")
    return dict(model="small GroupNorm thetaobb RBBoxRCNN float32",
                scales=[192, 256], flip=True, tf32=False,
                merged=len(outs[0]["scores"]),
                merged_quads=len(outs[0]["quads"]), max_abs_err=errs,
                limits=TTA_REF_LIMITS)


def learn_config(root, small=False, seed=0):
    """`E2E_THETA_CONFIG`'s architecture and optimizer (or the small
    GroupNorm architecture) on `write_patch_set`'s seeded patches, the
    same set for training and test, with `LEARN`'s schedule; returns
    (config, the scenes' gt json, the schedule as run)."""
    from aidet_tpu_torch.utils.config import Config
    sizes = LEARN_SMALL if small else LEARN
    cfg = Config.fromfile(E2E_THETA_CONFIG).to_dict()
    if small:
        cfg.update(model=dict(small_gn(), img_size=sizes["size"]),
                   train_cfg=SMALL_TRAIN_CFG, test_cfg=SMALL_TEST_CFG)
    ann, prefix, gt_json = write_patch_set(root, 0, sizes["patches"],
                                           sizes["size"], sizes["objects"],
                                           seed)
    epochs = sizes["epochs"]
    lr = dict(cfg["lr_config"], warmup_iters=sizes["warmup"],
              step=(round(epochs * 9 / 12), round(epochs * 11 / 12)))
    cfg["data"] = dict(
        train=dict(cfg["data"]["train"], ann_file=ann, img_prefix=prefix),
        test=dict(cfg["data"]["test"], ann_file=ann, img_prefix=prefix))
    cfg.update(lr_config=lr, total_epochs=epochs,
               batch_size=sizes["batch"], log_interval=1,
               checkpoint_interval=epochs,
               train_pipeline=dict(cfg["train_pipeline"],
                                   img_size=sizes["size"]))
    steps = epochs * sizes["patches"] // sizes["batch"]
    schedule = dict(steps=steps, epochs=epochs, batch=sizes["batch"],
                    optimizer=cfg["optimizer"], lr_config=lr,
                    patches=sizes["patches"], objects=sizes["objects"],
                    size=sizes["size"])
    return Config(cfg, E2E_THETA_CONFIG), gt_json, schedule


def run_learn(device="cuda", small=False, seed=0):
    """The port's learning run: `train_detector` on `learn_config` from
    seeded random weights (float32, TF32 as PyTorch's default), then
    `init_detector` from its checkpoint, `run_inference` over the same
    patches, the scene merge and the DOTA eval (VOC-07 AP at IoU 0.5,
    OBB on the rboxes' quads and HBB on the boxes).  Fails when the OBB
    mAP is under `LEARN_MAP_BAR` (not with ``small``, a plumbing
    rehearsal).  Returns the phase's fields: the total loss of the
    first and last 10 steps, ms per step, the mAPs and their classes'
    APs, K2's launches in training and K1's in the test run."""
    import tempfile

    import numpy as np
    import torch
    from aidet_tpu_torch.apis.inference import init_detector
    from aidet_tpu_torch.apis.test import run_inference
    from aidet_tpu_torch.data.builder import build_dataset
    from aidet_tpu_torch.data.np_rboxes import (pointobb2bbox,
                                                thetaobb2pointobb)
    on_card = torch.device(device).type == "cuda"
    with tf32_defaults(), tempfile.TemporaryDirectory() as root:
        cfg, gt_json, schedule = learn_config(root, small, seed)
        run = loop_train(cfg, f"{root}/run", device, seed)
        model, _ = init_detector(cfg, f"{root}/run/ckpt", device=device)
        dataset = build_dataset(cfg.data.test)
        launch_counts(reset=True)
        results, names = run_inference(model, dataset,
                                       batch_size=schedule["patches"])
        test_launches = launch_counts()
        with open(gt_json) as f:
            gts = {scene: {k: np.asarray(v) for k, v in g.items()}
                   for scene, g in json.load(f).items()}
    maps = {}
    for task in ("obb", "hbb"):
        dets = [dict(boxes=(thetaobb2pointobb(r["rboxes"]) if task == "obb"
                            else r["boxes"]), scores=r["scores"],
                     labels=r["labels"], valid=r["valid"]) for r in results]
        merged = dataset.merge_patches_to_scenes(dets, names, task=task)
        task_gts = gts if task == "obb" else {
            k: dict(g, boxes=pointobb2bbox(g["boxes"])) for k, g in
            gts.items()}
        m, aps = dataset.evaluate_scenes(merged, task_gts, task=task)
        maps[task] = dict(map=float(m), aps={k: float(v)
                                             for k, v in aps.items()})
    losses = [r["metrics"]["loss"] for r in run["records"] if "metrics" in r]
    want = dict.fromkeys(HANDLES, 0)
    if on_card:
        want.update(roi_align_train_forward=schedule["steps"],
                    roi_align_backward=schedule["steps"])
    if run["launches"] != want or len(losses) != schedule["steps"]:
        raise AssertionError(f"learn: launches {run['launches']} (expected "
                             f"{want}) in {len(losses)} logged steps")
    step_ms = [r["time"] * 1e3 for r in run["records"] if "metrics" in r]
    fields = dict(
        config=E2E_THETA_CONFIG + (" (small architecture)" if small else ""),
        schedule=schedule, seed=seed, steps=len(losses),
        loss_first_10=losses[:10], loss_last_10=losses[-10:],
        ms_per_step=float(np.mean(step_ms[1:] if len(step_ms) > 1
                                  else step_ms)),
        train_wall_s=run["wall_s"], train_launches=run["launches"],
        test_launches=test_launches, obb_map=maps["obb"]["map"],
        hbb_map=maps["hbb"]["map"], obb_aps=maps["obb"]["aps"],
        hbb_aps=maps["hbb"]["aps"], map_bar=LEARN_MAP_BAR,
        evaluated_on="the training scenes (a learning check, as the "
        "reference's README:92)")
    if not small and not maps["obb"]["map"] >= LEARN_MAP_BAR:
        raise AssertionError(f"learn: OBB mAP@0.5 {maps['obb']['map']} is "
                             f"under {LEARN_MAP_BAR}: {fields}")
    return fields


# Slice 13: the HBB R-CNN family as the COCO configs write them
# (float32, 81 classes): FasterRCNN with ResNet-50 and ResNeXt-101
# 64x4d, the RPN feeding FastRCNN, Cascade R-CNN with and without its
# mask head, and HTC with its semantic branch
FASTER_CONFIG = "configs/faster_rcnn_r50_fpn_1x.py"
FASTER_X101_CONFIG = "configs/faster_rcnn_x101_64x4d_fpn_1x.py"
RPN_CONFIG = "configs/rpn_r50_fpn_1x.py"
FAST_CONFIG = "configs/fast_rcnn_r50_fpn_1x.py"
CASCADE_CONFIG = "configs/cascade_rcnn_r50_fpn_1x.py"
CASCADE_MASK_CONFIG = "configs/cascade_mask_rcnn_r50_fpn_1x.py"
# every HTC config of the repo names an FCNMaskHead, which the
# reference's mask information flow cannot call (it raises a TypeError,
# and so does the port's builder); HTC's own head, as upstream's
# htc_r50_fpn_1x names it, takes its place
HTC_CONFIG = "configs/htc_r50_fpn_1x.py"
HBB = dict(img=1024, batch=2, calls=3, steps=3, max_gt=64, objects=60)
HBB_SMALL = dict(img=256, batch=2, calls=1, steps=1, max_gt=4, objects=6)
SMALL_HBB_MASK_HEAD = dict(num_convs=2, in_channels=64, conv_out_channels=64,
                           num_classes=16)
SMALL_HBB_SEMANTIC_HEAD = dict(type="FusedSemanticHead", num_ins=5,
                               fusion_level=1, in_channels=64,
                               conv_out_channels=64, num_classes=16)
SMALL_RESNEXT = dict(
    backbone=dict(type="ResNeXt", depth=50, groups=4, base_width=4),
    neck=dict(SMALL_MODEL["neck"], in_channels=(256, 512, 1024, 2048)))
# the reference phases' train steps: 4 gts an image, and proposals
# capped at 50 valid ones (10 a level after NMS) in 64 rows, so that
# every cascade stage's valid candidates (the gts, then the previous
# stage's sample: up to 4 x 4 + 50 in HTC's last interleaved mask
# sample) fit in the 4 + 64 samples and every stage keeps all of them
HBB_REF_GTS = 4
HBB_REF_PROPOSALS = dict(nms_pre=16, nms_post=10, max_num=64)
HBB_REF_LIMITS = dict(boxes=1.0, scores=1e-2)
# each kind's small architecture (for the reference phases and the CPU
# rehearsals), its config as written, and its launches a predict call
# and a train step on the card: K1 once a call for each stage's crop,
# the mask crop and each semantic crop; K2 (forward and backward) once
# a step for each stage's, each mask loss's and each semantic crop
HBB_KINDS = dict(
    faster=dict(small=dict(type="FasterRCNN"), config=FASTER_CONFIG,
                predict=K1, train=K2),
    faster_x101=dict(small=dict(type="FasterRCNN", **SMALL_RESNEXT),
                     config=FASTER_X101_CONFIG, predict=K1, train=None),
    cascade=dict(small=dict(type="CascadeRCNN"), config=CASCADE_CONFIG,
                 predict=dict(roi_align=3),
                 train=dict(roi_align_train_forward=3,
                            roi_align_backward=3)),
    cascade_mask=dict(
        small=dict(type="CascadeRCNN", mask_head=dict(
            type="FCNMaskHead", **SMALL_HBB_MASK_HEAD)),
        config=CASCADE_MASK_CONFIG, predict=dict(roi_align=4), train=None,
        masks=True),
    htc=dict(
        small=dict(type="HTC", mask_head=dict(type="HTCMaskHead",
                                              **SMALL_HBB_MASK_HEAD),
                   semantic_head=SMALL_HBB_SEMANTIC_HEAD),
        config=HTC_CONFIG, predict=dict(roi_align=8),
        train=dict(roi_align_train_forward=12, roi_align_backward=12),
        masks=True, pipeline=HTC_CONFIG))


def hbb_cfg(kind, small, img=256, train_cfg=None):
    """(model config, train_cfg, test_cfg) of ``kind`` (a key of
    `HBB_KINDS`, or "rpn" / "fast"): its small architecture at ``img``
    with `SMALL_TRAIN_CFG` and `SMALL_TEST_CFG`, or its config as
    written (HTC's mask head as `HTC_CONFIG`'s note says); ``train_cfg``
    merged over the train_cfg."""
    from aidet_tpu_torch.models.detectors.two_stage import _merge
    from aidet_tpu_torch.utils.config import Config
    if small and HBB_KINDS.get(kind, {}).get("dense"):
        spec = HBB_KINDS[kind]
        return (dict(spec["small"], img_size=spec.get("img", img)),
                _merge({}, train_cfg), DENSE_SMALL_TEST_CFG)
    if small:
        model = dict(SMALL_MODEL, img_size=img)
        del model["rbbox_head"], model["rbbox_encode"]
        if kind == "rpn":
            del model["bbox_head"]
        model.update(type="RPN" if kind == "rpn" else "FastRCNN")
        if kind in HBB_KINDS:
            model.update(HBB_KINDS[kind]["small"])
        if model["type"] == "RPN":
            model.pop("bbox_head", None)
        spec = HBB_KINDS.get(kind, {})
        test = _merge(dict(rpn=SMALL_TEST_CFG["rpn"]) if model["type"]
                      == "RPN" else SMALL_TEST_CFG,
                      spec.get("small_test_cfg"))
        train = _merge(SMALL_TRAIN_CFG, spec.get("small_train_cfg"))
    else:
        path = dict(rpn=RPN_CONFIG, fast=FAST_CONFIG).get(kind) or \
            HBB_KINDS[kind]["config"]
        cfg = Config.fromfile(path).to_dict()
        model, train, test = (cfg["model"], cfg.get("train_cfg"),
                              cfg.get("test_cfg"))
        if kind == "htc":
            model["mask_head"] = dict(model["mask_head"], type="HTCMaskHead")
    return model, _merge(train or {}, train_cfg), test


def hbb_model(kind, device, small, img=256, train=False, train_cfg=None,
              seed=0):
    """`build_detector` of `hbb_cfg` on ``device`` with seeded weights
    (the same on every device).  The offset convs that start at zero
    (the deformable conv is then a plain conv) get seeded weights, so
    that the deformable convs sample off the grid, as trained ones do: a
    GA head's N(0, 0.5), a `DeformConv2d`'s (ResNet's dcn) N(0, 1 /
    fan_in).  The dense kinds' class and location prior biases are set to
    0 (at the focal loss's prior every sigmoid score lies under the
    score_thr of random weights' predict).  The plug-ins that start as
    the identity are seeded too: each ContextBlock's channel_add_conv2
    N(0, 1 / fan_in) (and its conv_mask bias N(0, 0.1): the softmax over
    the positions ignores that shift, so its gradient is rounding alone,
    which a zero weight leaves no resolution to compare), each
    GeneralizedAttention's ``gamma`` U(0.5, 1.5),
    its query and key convs times 0.1 (at N(0, 1 / fan_in) the energies
    of random weights reach hundreds, and the softmax then picks keys by
    margins the two devices' rounding moves)."""
    import torch
    from aidet_tpu_torch.models.builder import build_detector
    from aidet_tpu_torch.models.plugins import (ContextBlock,
                                                GeneralizedAttention)
    from aidet_tpu_torch.ops.deform_conv import DeformConv2d
    model, train_c, test_c = hbb_cfg(kind, small, img, train_cfg)
    net = build_detector(model, train_cfg=train_c, test_cfg=test_c,
                         device=device, seed=seed, train=train)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, DeformConv2d):
                w = m.conv_offset.weight
                w.copy_(torch.randn(w.shape, generator=gen)
                        / math.sqrt(w[0].numel()))
            elif name.endswith("adaption_offset"):
                m.weight.copy_(0.5 * torch.randn(m.weight.shape,
                                                 generator=gen))
            elif name.split(".")[-1] in PRIOR_CONVS:
                m.bias.zero_()
            elif isinstance(m, ContextBlock):
                w = m.channel_add_conv2.weight
                w.copy_(torch.randn(w.shape, generator=gen)
                        / math.sqrt(w[0].numel()))
                if hasattr(m, "conv_mask"):
                    m.conv_mask.bias.copy_(0.1 * torch.randn(
                        m.conv_mask.bias.shape, generator=gen))
            elif isinstance(m, GeneralizedAttention):
                m.gamma.fill_(0.5 + float(torch.rand((), generator=gen)))
                for conv in (getattr(m, "query_conv", None),
                             getattr(m, "key_conv", None)):
                    if conv is not None:
                        conv.weight.mul_(0.1)
    return net


def mmdet_named(model):
    """The state_dict of a ResNet-FPN FasterRCNN under mmdet's names
    (the inverse of `convert.MMDET_NAMES`, the box head's first FC
    relaid to torch's (c, h, w) flatten): a checkpoint as mmdet would
    save this model."""
    import re
    names = [(r"backbone\.stem_conv\.(.*)", r"backbone.conv1.\1"),
             (r"backbone\.stem_bn\.(.*)", r"backbone.bn1.\1"),
             (r"backbone\.layer(\d)_block(\d+)\.ds_conv\.(.*)",
              r"backbone.layer\1.\2.downsample.0.\3"),
             (r"backbone\.layer(\d)_block(\d+)\.ds_bn\.(.*)",
              r"backbone.layer\1.\2.downsample.1.\3"),
             (r"backbone\.layer(\d)_block(\d+)\.(.*)",
              r"backbone.layer\1.\2.\3"),
             (r"neck\.lateral(\d+)\.(.*)", r"neck.lateral_convs.\1.conv.\2"),
             (r"neck\.fpn(\d+)\.(.*)", r"neck.fpn_convs.\1.conv.\2"),
             (r"bbox_head\.shared_fc(\d+)\.(.*)",
              r"bbox_head.shared_fcs.\1.\2"), (r"(.*)", r"\1")]
    out = {}
    for key, value in model.state_dict().items():
        for pattern, repl in names:
            m = re.fullmatch(pattern, key)
            if m:
                break
        value = value.detach().cpu().float()
        if key == "bbox_head.shared_fc0.weight":
            s = model.bbox_head.roi_feat_size
            value = value.reshape(value.shape[0], s, s, -1).permute(
                0, 3, 1, 2).reshape(value.shape[0], -1)
        out[m.expand(repl)] = value
    return out


def hbb_train_batch(b, img, n_gt, seed, device, masks=False,
                    semantic=False):
    """`synthetic_train_batch` (normalized float images, ``n_gt`` boxes
    an image) with, if asked, each gt's box filled in a [n_gt, img,
    img] mask and a seeded [img / 4]^2 semantic map of classes 0..15."""
    import torch
    from aidet_tpu_torch.flagship import synthetic_train_batch
    batch = synthetic_train_batch(b, img, n_gt, seed, device)
    if masks:
        xy = torch.arange(img, device=device, dtype=torch.float32)
        bx = batch["gt_boxes"][..., None, None]
        batch["gt_masks"] = ((xy[None, :] >= bx[..., 0, :, :])
                             & (xy[None, :] <= bx[..., 2, :, :])
                             & (xy[:, None] >= bx[..., 1, :, :])
                             & (xy[:, None] <= bx[..., 3, :, :])).float()
    if semantic:
        batch["gt_semantic"] = torch.randint(
            0, 16, (b, img // 4, img // 4),
            generator=torch.Generator().manual_seed(seed)).to(device)
    return batch


def hbb_step_once(kind, device, img, seed=0, dtype=None):
    """One train step of the small ``kind`` on ``device`` under a
    train_cfg that keeps every candidate of every stage
    (`HBB_REF_PROPOSALS`); returns (metrics, parameters before, after),
    on the CPU.  With ``dtype`` (float64) the model, its compute and the
    batch in it (the parameters before the step as built, in
    float32)."""
    import torch
    from aidet_tpu_torch.flagship import keep_every_candidate_cfg
    from aidet_tpu_torch.parallel.train import (build_lr_schedule,
                                                build_optimizer,
                                                create_train_state,
                                                make_train_step)
    spec = HBB_KINDS.get(kind, {})
    props = spec.get("ref_proposals", HBB_REF_PROPOSALS)
    cfg = dict(keep_every_candidate_cfg(img, HBB_REF_GTS, props["max_num"]),
               rpn_proposal=props)
    net = hbb_model(kind, device, True, img, train=True, train_cfg=cfg,
                    seed=seed)
    before = [p.detach().cpu().clone() for p in net.parameters()]
    batch = hbb_train_batch(2, img, HBB_REF_GTS, seed, device,
                            masks=spec.get("masks", False),
                            semantic=kind == "htc")
    if dtype is not None:
        net = net.to(dtype)
        net.compute_dtype = dtype
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in batch.items()}
    params = list(net.parameters())
    optimizer = build_optimizer(build_lr_schedule(base_lr=0.01))
    state = create_train_state(net, optimizer)
    with cpu_jitter(seed):
        _, metrics = make_train_step(net, optimizer)(
            state, batch, torch.Generator(device=device).manual_seed(seed))
    return ({k: float(v) for k, v in metrics.items()}, before,
            [p.detach().cpu() for p in params])


def run_hbb_reference(device="cuda", kind="faster", img=256):
    """The small ``kind`` ("faster", its weights loaded through
    `convert.mmdet_to_state_dict` from `mmdet_named`; "fast": the RPN's
    proposals, then FastRCNN's `predict_from_proposals` on the CPU's;
    "resnext": a FasterRCNN with a ResNeXt-50 (groups 4); "cascade":
    Cascade Mask R-CNN; "htc": HTC with its semantic branch), float32
    with TF32 off, on ``device`` against the CPU with the same weights:
    predict on 2 seeded uint8 images (`match_detections` with
    `HBB_REF_LIMITS`, and masks within 1e-2), then one train step
    (cuDNN off, as the note at `UPDATE_RESOLUTION` says; "fast" trains
    the RPN) held by `compare_steps` to `DETECTOR_REF_TRAIN_LIMITS`, or,
    for the kinds whose float32 update the CPU's own thread count moves
    past those limits (``ref_float64``: GCNet's and GN+WS's,
    `PLUGIN_FLOAT32_NOTE`), held with the CPU's to the CPU's float64
    step (`gn_step_against_float64`).  Returns the phase's fields."""
    import torch
    from aidet_tpu_torch.convert import mmdet_to_state_dict
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = dict(resnext="faster_x101", cascade="cascade_mask",
                c4="c4_mask").get(kind, kind)
    spec = HBB_KINDS.get(kind, {})
    dense = spec.get("dense", False)
    img = spec.get("img") or spec.get("ref_img") or img
    imgs = torch.randint(0, 256, (2, img, img, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    if dense:   # these detectors read their images as they are
        imgs = torch.randn((2, img, img, 3),
                           generator=torch.Generator().manual_seed(1))
    shapes = torch.full((2, 2), float(img))
    devices = (device, "cpu")
    models = [hbb_model(arch, d, True, img) for d in devices]
    out = dict(img=img, tf32=False)
    if kind == "faster":
        sd, unmapped = mmdet_to_state_dict(mmdet_named(models[1]),
                                           models[1])
        if unmapped:
            raise AssertionError(f"mmdet_to_state_dict left {unmapped}")
        for k, v in models[1].state_dict().items():
            if not torch.equal(sd[k].to(v.dtype), v.cpu()):
                raise AssertionError(f"{k}: the mmdet round trip differs")
        for m in models:
            m.load_state_dict(sd, strict=True)
        out["weights"] = "mmdet_to_state_dict"
    limits = dict(HBB_REF_LIMITS)
    names = [n for n, _ in models[1].named_parameters()]
    if kind == "fast":
        rpns = [hbb_model("rpn", d, True, img) for d in devices]
        names = [n for n, _ in rpns[1].named_parameters()]
        props = [{k: v.cpu() for k, v in r.predict(
            imgs.to(d), shapes.to(d)).items()} for r, d in zip(rpns, devices)]
        if not torch.equal(props[0]["valid"], props[1]["valid"]):
            raise AssertionError("fast: the RPN's valid proposals differ")
        v = props[1]["valid"]
        out["rpn_max_abs_err"] = dict(
            boxes=float((props[0]["boxes"] - props[1]["boxes"])[v].abs()
                        .max()),
            scores=float((props[0]["scores"] - props[1]["scores"])[v].abs()
                         .max()))
        if not (out["rpn_max_abs_err"]["boxes"] <= limits["boxes"]
                and out["rpn_max_abs_err"]["scores"] <= limits["scores"]):
            raise AssertionError(f"fast: the RPN's proposals {out}")
        got, ref = ({k: v.cpu() for k, v in m.predict_from_proposals(
            imgs.to(d), props[1]["boxes"].to(d), props[1]["valid"].to(d),
            shapes.to(d)).items()} for m, d in zip(models, devices))
    else:
        got, ref = ({k: v.cpu() for k, v in m.predict(
            imgs.to(d), shapes.to(d)).items()}
            for m, d in zip(models, devices))
        if "masks" in ref:
            limits["masks"] = 1e-2
    errs = match_detections(got, ref, limits, cut_slack=True)
    del models
    step_kind = "rpn" if kind == "fast" else arch
    with torch.backends.cudnn.flags(enabled=False):
        steps = [hbb_step_once(step_kind, d, img) for d in devices]
        if spec.get("ref_float64"):
            t = gn_step_against_float64(
                kind, steps, lambda d, dtype: hbb_step_once(
                    step_kind, d, img, dtype=dtype),
                DETECTOR_REF_TRAIN_LIMITS, names, PLUGIN_FLOAT32_NOTE)
        else:
            t = compare_steps(f"{kind}_reference", *steps,
                              DETECTOR_REF_TRAIN_LIMITS, resolved_only=True)
            t["worst_leaf"] = names[t["worst_leaf"]]
    return dict(out, n_valid=int(got["valid"].sum()), max_abs_err=errs,
                limits=limits, gts=HBB_REF_GTS, train_cudnn=False,
                train=dict(losses_card=steps[0][0], losses_cpu=steps[1][0],
                           **t))


def hbb_pipeline_batches(root, sizes, seed, config=HTC_CONFIG):
    """``sizes["steps"] + 1`` batches of ``sizes["batch"]`` made by the
    port's `TrainPipeline` (the train_pipeline of ``config``: HTC's masks
    and pseudo segmentation, or Mask Scoring R-CNN's masks; uint8
    transfer) from seeded synthetic PNG patches (`write_patch_set`) read
    back by `DOTADataset` (the repo has no COCO images); and the
    pipeline's host ms per image."""
    from aidet_tpu_torch.data.builder import build_dataset
    from aidet_tpu_torch.data.imio import imread
    from aidet_tpu_torch.data.pipeline import TrainPipeline, collate_batch
    from aidet_tpu_torch.utils.config import Config
    n = sizes["batch"] * (sizes["steps"] + 1)
    ann, prefix, _ = write_patch_set(root, 0, n, sizes["img"],
                                     sizes["objects"], seed)
    dataset = build_dataset(dict(type="DOTADataset", ann_file=ann,
                                 img_prefix=prefix))
    pipe_cfg = Config.fromfile(config).to_dict()["train_pipeline"]
    pipe = TrainPipeline(**dict(pipe_cfg, img_size=sizes["img"],
                                max_gt=sizes["max_gt"],
                                device_normalize=True, seed=seed))
    t0 = time.perf_counter()
    samples = [pipe(imread(dataset.img_path(i)), dataset.parse_anns(i))
               for i in range(n)]
    ms = (time.perf_counter() - t0) * 1e3 / n
    b = sizes["batch"]
    return [collate_batch(samples[i:i + b]) for i in range(0, n, b)], ms


def run_hbb_paths(device="cuda", small=False, kind="faster", seed=0):
    """``kind``'s config as written (`hbb_cfg`: float32 with cuDNN's
    TF32, as PyTorch's default), or with ``small`` its small
    architecture: 1 warm-up and ``calls`` timed predict calls on 2
    seeded uint8 images (ms per call, detections, peak memory;
    "rpn_fast": the RPN's proposals, then FastRCNN's
    `predict_from_proposals` on them, each so timed), then,
    where `HBB_KINDS` gives train launches, 1 warm-up and ``steps``
    timed train steps (every loss finite, the heads moved, ms per step,
    peak memory) on `synthetic_train_batch` with ``max_gt`` gts, HTC's
    on `hbb_pipeline_batches`.  Launches, a call and a step on the card,
    are `HBB_KINDS`'; FastRCNN K1 once a call, the RPN none.  Returns
    {"predict": fields, "train": fields, ...}."""
    import tempfile

    import torch
    from aidet_tpu_torch.flagship import synthetic_train_batch
    from aidet_tpu_torch.parallel.train import (build_lr_schedule,
                                                build_optimizer,
                                                create_train_state,
                                                make_train_step)
    sizes = HBB_SMALL if small else HBB
    b, img = sizes["batch"], sizes["img"]
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def expect(name, counts, n):
        want = dict.fromkeys(HANDLES, 0)
        if on_card:
            want.update({k: v * n for k, v in counts.items()})
        got = launch_counts()
        if got != want:
            raise AssertionError(f"{kind} {name}: launches {got} in {n}, "
                                 f"expected {want}")
        return got

    def peak():
        return (torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
                else None)

    def timed_calls(name, call, counts):
        call()          # warm-up: cuDNN's plans
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        times = []
        for _ in range(sizes["calls"]):
            sync()
            t0 = time.perf_counter()
            res = call()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        fields = dict(calls=len(times), call_ms=times,
                      ms_per_call=sum(times) / len(times),
                      launches=expect(name, counts, len(times)),
                      peak_memory_gib=peak())
        if not all(bool(torch.isfinite(v.float()).all())
                   for v in res.values()) or not res["valid"].any():
            raise AssertionError(f"{kind} {name}: {fields}")
        return res, dict(fields, n_valid=int(res["valid"].sum()))

    spec = HBB_KINDS.get(kind, {})
    if spec.get("img"):
        img = spec["img"]
    imgs = torch.randint(0, 256, (b, img, img, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))
    if spec.get("dense"):      # these detectors read their images as they are
        imgs = torch.randn((b, img, img, 3),
                           generator=torch.Generator().manual_seed(seed))
    imgs = imgs.to(device)
    shapes = torch.full((b, 2), float(img), device=device)
    out = dict(config=(f"{kind} (small architecture)" if small else
                       "configs as written"), img=img, batch=b)
    with tf32_defaults():
        if kind == "rpn_fast":
            rpn = hbb_model("rpn", device, small, img, seed=seed)
            props, out["rpn_predict"] = timed_calls(
                "rpn_predict", lambda: rpn.predict(imgs, shapes), {})
            del rpn
            fast = hbb_model("fast", device, small, img, seed=seed)
            _, out["fast_predict"] = timed_calls(
                "fast_predict", lambda: fast.predict_from_proposals(
                    imgs, props["boxes"], props["valid"], shapes), K1)
            out["proposals_per_image"] = int(props["boxes"].shape[1])
            return out
        spec = HBB_KINDS[kind]
        model = hbb_model(kind, device, small, img, seed=seed)
        _, out["predict"] = timed_calls(
            "predict", lambda: model.predict(imgs, shapes), spec["predict"])
        del model
        if spec["train"] is None:
            return out
        net = hbb_model(kind, device, small, img, train=True, seed=seed)
        params = list(net.parameters())
        before = [p.detach().clone() for p in params]
        optimizer = build_optimizer(build_lr_schedule(base_lr=0.01))
        state = create_train_state(net, optimizer)
        step = make_train_step(net, optimizer)
        pipeline_ms = None
        if "pipeline" in spec:
            with tempfile.TemporaryDirectory() as root:
                batches, pipeline_ms = hbb_pipeline_batches(
                    root, sizes, seed, spec["pipeline"])
            batches = [{k: (torch.from_numpy(v).long() if v.dtype.kind == "i"
                            else torch.from_numpy(v)).to(device)
                        for k, v in x.items()} for x in batches]
        else:
            batches = [synthetic_train_batch(b, img, sizes["max_gt"], seed,
                                             device)] * (sizes["steps"] + 1)
        gen = torch.Generator(device=device).manual_seed(seed)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[0], gen)
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        launch_counts(reset=True)
        times, losses = [], []
        for data in batches[1:]:
            sync()
            t0 = time.perf_counter()
            state, metrics = step(state, data, gen)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(v) for k, v in metrics.items()})
        launches = expect("train", spec["train"], len(times))
    bad = [(i, k) for i, m in enumerate(losses) for k, v in m.items()
           if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{kind} train: not finite {bad}")
    names = [nm for nm, _ in net.named_parameters()]
    # a dense head's leaf that no positive anchor reaches (SepBN's
    # regression norms of a level whose anchors match no gt) keeps its
    # zero bias: weight decay moves only what is not zero
    still = [nm for nm, a, p in zip(names, before, params)
             if torch.equal(a, p.detach()) and "_head" in nm.split(".")[0]
             and (a.any() or not spec.get("dense"))]
    if still:
        raise AssertionError(f"{kind} train: heads did not move: {still}")
    ms = sum(times) / len(times)
    out["train"] = dict(
        steps=len(times), losses=losses, first_step_ms=first_ms,
        step_ms=times, ms_per_step=ms, images_per_s=b * 1e3 / ms,
        launches=launches, peak_memory_gib=peak(),
        batches=(f"TrainPipeline ({spec['pipeline']}) on seeded PNG "
                 f"patches, {pipeline_ms} host ms an image"
                 if "pipeline" in spec else
                 f"synthetic, {sizes['max_gt']} gts an image"))
    return out


# K1 and K2 at the slice's own shapes in float32: the COCO configs'
# 1000 proposals an image (FasterRCNN, FastRCNN) and 2000 (the
# cascades), 100 detections, and HTC's semantic map: one 256-channel
# level at stride 8 ([2, 128, 128, 256] at 1024^2)
HBB_PREDICT = dict(batch=2, rois=1000, img=1024, channels=256)
HBB_DETS = dict(batch=2, rois=100, img=1024, channels=256)
HTC_SEMANTIC_STRIDES = (8,)


def run_hbb_kernels(k1, k2_forward):
    """K1 (7x7 on 2 x 1000 proposals, four levels; 7x7 on 2 x 2000 and
    14x14 on 2 x 100 detections on the semantic map's one level) and
    K2 (forward and backward: 7x7 on 2 x 512 samples and 14x14 on 2 x
    128 positives on the semantic map) in float32, each against its
    plain version with its bound, on its own line."""
    run_forward_kernel(k1, "roi_align", HBB_PREDICT, (7,),
                       dtype_name="float32")
    run_forward_kernel(k1, "roi_align", RROI, (7,), dtype_name="float32",
                       strides=HTC_SEMANTIC_STRIDES)
    run_forward_kernel(k1, "roi_align", HBB_DETS, (14,),
                       dtype_name="float32", strides=HTC_SEMANTIC_STRIDES)
    for shape, s in ((TRAIN, 7), (MASK_TRAIN, 14)):
        run_forward_kernel(k2_forward, "roi_align_train_forward", shape,
                           (s,), dtype_name="float32",
                           strides=HTC_SEMANTIC_STRIDES)
        run_backward_kernel(shape=shape, s=s, dtype_names=("float32",),
                            strides=HTC_SEMANTIC_STRIDES)


def run_slice13(card):
    """The reference phases of the HBB family (FasterRCNN with mmdet
    weights, RPN -> FastRCNN, ResNeXt, Cascade Mask R-CNN, HTC), then
    the configs as written: predict of FasterRCNN R50 and X101-64x4d,
    RPN -> FastRCNN, Cascade, Cascade Mask and HTC, and the train steps
    of FasterRCNN R50, Cascade and HTC.  Returns the runs' fields by
    path name."""
    for kind in ("faster", "fast", "resnext", "cascade", "htc"):
        phase(f"hbb_reference_{kind}", card=card,
              **run_hbb_reference(kind=kind))
    runs = {}
    for kind, title in (("faster", "FasterRCNN R50-FPN"),
                        ("faster_x101", "FasterRCNN X101-64x4d-FPN"),
                        ("rpn_fast", "RPN -> FastRCNN R50-FPN"),
                        ("cascade", "Cascade R-CNN R50-FPN"),
                        ("cascade_mask", "Cascade Mask R-CNN R50-FPN"),
                        ("htc", "HTC R50-FPN with semantic")):
        paths = run_hbb_paths(kind=kind)
        for part in ("predict", "train", "rpn_predict", "fast_predict"):
            if part in paths:
                runs[f"{kind}_{part}".replace("rpn_fast_", "")] = \
                    paths[part]
        phase(kind, model=title, card=card, **paths)
    return runs


# Slice 14: the rest of the two-stage zoo as the COCO configs write
# them (float32, 81 classes): the C4 detectors (res5 as the shared RoI
# head on one 1024-channel level at stride 16), Mask Scoring R-CNN,
# GA-RPN and GA-Faster R-CNN, Grid R-CNN, Double-Head R-CNN and Libra
# R-CNN (BFP and the combined sampler)
C4_CONFIG = "configs/faster_rcnn_r50_caffe_c4_1x.py"
C4_MASK_CONFIG = "configs/mask_rcnn_r50_caffe_c4_1x.py"
MS_CONFIG = "configs/ms_rcnn_r50_fpn_1x.py"
GA_RPN_CONFIG = "configs/ga_rpn_r50_caffe_fpn_1x.py"
GA_FASTER_CONFIG = "configs/ga_faster_rcnn_r50_fpn_1x.py"
GRID_CONFIG = "configs/grid_rcnn_r50_fpn_2x.py"
DH_CONFIG = "configs/dh_faster_rcnn_r50_fpn_1x.py"
LIBRA_CONFIG = "configs/libra_faster_rcnn_r50_fpn_1x.py"
SMALL_C4 = dict(
    backbone=dict(type="ResNet", depth=18, num_stages=3, out_indices=(2,),
                  style="caffe"),
    neck=dict(type="Identity"),
    shared_head=dict(type="ResLayer", depth=18, stage=3, stride=2,
                     style="caffe"),
    rpn_head=dict(type="RPNHead", in_channels=256, feat_channels=64,
                  num_anchors=6),
    bbox_head=dict(type="BBoxHead", with_avg_pool=True, num_classes=16,
                   in_channels=512, roi_feat_size=7),
    strides=(16,), anchor_scales=(4, 8))
SMALL_GA_RPN = dict(type="GARPNHead", in_channels=64, feat_channels=64)
# C4's one level: 16 proposals after NMS, so that the 4 gts and them fill
# the 20 samples of the reference steps' keep-every-candidate train_cfg
# (the plain RoIAlign's gathers and their gradient at 256 channels take
# most of a CPU step)
C4_REF_PROPOSALS = dict(nms_pre=16, nms_post=16, max_num=16)
# and the small C4 models' predict: 16 proposals an image
C4_SMALL_TEST_CFG = dict(rpn=dict(nms_pre=16, nms_post=16, max_num=16))
HBB_KINDS.update(
    c4=dict(small=dict(type="FasterRCNN", **SMALL_C4), config=C4_CONFIG,
            predict=K1, train=K2, ref_proposals=C4_REF_PROPOSALS,
            small_test_cfg=C4_SMALL_TEST_CFG),
    c4_mask=dict(
        small=dict(type="MaskRCNN", **SMALL_C4, mask_head=dict(
            type="FCNMaskHead", num_convs=0, in_channels=512,
            conv_out_channels=64, num_classes=16)),
        config=C4_MASK_CONFIG, predict=dict(roi_align=2), train=None,
        ref_proposals=C4_REF_PROPOSALS, masks=True,
        small_test_cfg=C4_SMALL_TEST_CFG),
    ms=dict(
        small=dict(type="MaskScoringRCNN", mask_head=dict(
            type="FCNMaskHead", **SMALL_HBB_MASK_HEAD), mask_iou_head=dict(
                type="MaskIoUHead", num_convs=2, num_fcs=1, in_channels=64,
                conv_out_channels=32, fc_out_channels=64, num_classes=16)),
        config=MS_CONFIG, predict=dict(roi_align=2),
        train=dict(roi_align_train_forward=2, roi_align_backward=2),
        masks=True, pipeline=MS_CONFIG),
    ga_rpn=dict(small=dict(type="RPN", rpn_head=SMALL_GA_RPN),
                config=GA_RPN_CONFIG, predict={}, train=None),
    ga_faster=dict(small=dict(type="GAFasterRCNN", rpn_head=SMALL_GA_RPN),
                   config=GA_FASTER_CONFIG, predict=K1, train=K2),
    grid=dict(
        small=dict(type="GridRCNN", grid_head=dict(
            type="GridHead", num_convs=2, in_channels=64,
            point_feat_channels=8, norm_groups=9)),
        config=GRID_CONFIG, predict=dict(roi_align=2),
        train=dict(roi_align_train_forward=2, roi_align_backward=2)),
    dh=dict(
        small=dict(type="DoubleHeadRCNN", bbox_head=dict(
            type="DoubleConvFCBBoxHead", num_classes=16, in_channels=64,
            num_convs=2, conv_out_channels=128, fc_out_channels=128)),
        config=DH_CONFIG, predict=K1, train=K2),
    libra=dict(
        small=dict(type="FasterRCNN", neck=[
            SMALL_MODEL["neck"], dict(type="BFP", in_channels=64,
                                      num_levels=5)]),
        small_train_cfg=dict(rcnn=dict(sampler="combined")),
        config=LIBRA_CONFIG, predict=K1, train=K2))


@contextlib.contextmanager
def cpu_jitter(seed):
    """Grid R-CNN's training jitter drawn on the CPU from a generator
    seeded with ``seed`` + 2 and moved to the rois' device, while the
    context lasts: the card's and the CPU's generators draw different
    streams, and the reference steps must jitter alike to be compared."""
    import torch
    from aidet_tpu_torch.models.detectors import two_stage
    own = two_stage.jitter_rois
    gen = torch.Generator().manual_seed(seed + 2)

    def jitter(rois, img_shapes, generator):
        return own(rois.cpu(), img_shapes.cpu(), gen).to(rois.device)
    two_stage.jitter_rois = jitter
    try:
        yield
    finally:
        two_stage.jitter_rois = own


# K1 and K2 at the C4 detectors' shapes, float32: one 1024-channel level
# at stride 16 ([2, 64, 64, 1024] at 1024^2) cropped at 14x14, the 2 x
# 1000 proposals of predict and the 2 x 512 samples of a train step; and
# K1 at Grid R-CNN's 14x14 on the 2 x 100 detections over four levels
C4_STRIDES = (16,)
C4_PREDICT = dict(batch=2, rois=1000, img=1024, channels=1024)
C4_TRAIN = dict(batch=2, rois=512, img=1024, channels=1024)


def run_slice14_kernels(k1, k2_forward):
    """K1 (14x14 on 2 x 1000 proposals of the C4 level; 14x14 on 2 x 100
    detections, four levels) and K2 (forward and backward, 14x14 on 2 x
    512 samples of the C4 level) in float32, each against its plain
    version with its bound, on its own line; the plain version of the
    C4 predict shape runs in 4 chunks of rois (one call would hold ~30
    GB of corner gathers)."""
    run_forward_kernel(k1, "roi_align", C4_PREDICT, (14,),
                       dtype_name="float32", strides=C4_STRIDES,
                       plain_chunks=4)
    run_forward_kernel(k2_forward, "roi_align_train_forward", C4_TRAIN,
                       (14,), dtype_name="float32", strides=C4_STRIDES)
    run_backward_kernel(shape=C4_TRAIN, s=14, dtype_names=("float32",),
                        strides=C4_STRIDES)
    run_forward_kernel(k1, "roi_align", HBB_DETS, (14,),
                       dtype_name="float32")


def run_slice14(card):
    """The reference phases of slice 14's families (C4 with its mask
    branch, Mask Scoring R-CNN, GA-Faster R-CNN, Grid R-CNN, Double-Head
    R-CNN, Libra R-CNN), then the configs as written: predict of all
    eight, and the train steps of FasterRCNN C4, MS, GA-Faster, Grid,
    Double-Head and Libra.  Returns the runs' fields by path name."""
    for kind in ("c4", "ms", "ga_faster", "grid", "dh", "libra"):
        phase(f"hbb_reference_{kind}", card=card,
              **run_hbb_reference(kind=kind))
    runs = {}
    for kind, title in (("c4", "FasterRCNN R50-C4 caffe"),
                        ("c4_mask", "Mask R-CNN R50-C4 caffe"),
                        ("ms", "Mask Scoring R-CNN R50-FPN"),
                        ("ga_rpn", "GA-RPN R50-FPN caffe"),
                        ("ga_faster", "GA-Faster R-CNN R50-FPN"),
                        ("grid", "Grid R-CNN R50-FPN"),
                        ("dh", "Double-Head R-CNN R50-FPN"),
                        ("libra", "Libra R-CNN R50-FPN-BFP")):
        paths = run_hbb_paths(kind=kind)
        for part in ("predict", "train"):
            if part in paths:
                runs[f"{kind}_{part}"] = paths[part]
        phase(kind, model=title, card=card, **paths)
    return runs


# Slice 15: the single-stage zoo (FCOS, ATSS, FoveaBox, RepPoints,
# GA-RetinaNet, FreeAnchor, RetinaNet with the SepBN head, GHM and
# NAS-FPN, SSD300) and ResNet's deformable stages, as the COCO configs
# write them (float32, 81 classes); the dense detectors launch no
# RoIAlign, the dcn R-CNNs K1 and K2 on a deformable backbone
FCOS_CONFIG = "configs/fcos_r50_fpn_1x.py"
ATSS_CONFIG = "configs/atss_r50_fpn_1x.py"
FOVEA_CONFIG = "configs/fovea_r50_fpn_1x.py"
REPPOINTS_CONFIG = "configs/reppoints_moment_r50_fpn_1x.py"
REPPOINTS_DCN_CONFIG = "configs/reppoints_moment_r101_dcn_fpn_2x.py"
GA_RETINA_CONFIG = "configs/ga_retinanet_r50_fpn_1x.py"
FREE_ANCHOR_CONFIG = "configs/retinanet_free_anchor_r50_fpn_1x.py"
SEPBN_CONFIG = "configs/retinanet_sepbn_r50_fpn_1x.py"
GHM_CONFIG = "configs/retinanet_ghm_r50_fpn_1x.py"
NASFPN_CONFIG = "configs/retinanet_nasfpn_r50_1x.py"
SSD_CONFIG = "configs/ssd300_coco.py"
DCN_CONFIG = "configs/faster_rcnn_dconv_c3-c5_r50_fpn_1x.py"
MDCONV_CONFIG = "configs/mask_rcnn_mdconv_c3-c5_r50_fpn_1x.py"
# the output convs whose bias starts at the focal loss's prior (and GA's
# location prior); `hbb_model` sets them to 0 in the dense kinds
PRIOR_CONVS = ("fcos_cls", "atss_cls", "fovea_cls", "cls_out", "ga_cls",
               "conv_loc", "retina_cls")
DENSE_SMALL_TEST_CFG = dict(nms_pre=200, score_thr=0.05, nms_thr=0.5,
                            max_per_img=50)
SMALL_DENSE_NECK = dict(type="FPN", in_channels=(64, 128, 256, 512),
                        out_channels=64, num_outs=5, start_level=1,
                        add_extra_convs=True, extra_convs_on_inputs=False)
SMALL_RETINA_NECK = dict(SMALL_DENSE_NECK, extra_convs_on_inputs=True)
SMALL_RETINA_HEAD = dict(type="RetinaHead", num_anchors=9)
SMALL_SEPBN_HEAD = dict(type="RetinaSepBNHead", num_anchors=9, num_ins=5)
GHM_LOSSES = dict(
    loss_cls=dict(type="GHMC", bins=30, momentum=0.75, use_sigmoid=True,
                  loss_weight=1.0),
    loss_bbox=dict(type="GHMR", mu=0.02, bins=10, momentum=0.7,
                   loss_weight=10.0))
# the small dcn R-CNN: ResNet-50 with DCNv2 in C4 and C5 under the
# small 64-channel FPN, at 128^2 (the plain deformable conv's gathers
# and their gradient lead a CPU step)
SMALL_DCN_BACKBONE = dict(
    backbone=dict(type="ResNet", depth=50, dcn=dict(modulated=True),
                  stage_with_dcn=(False, False, True, True)),
    neck=dict(SMALL_MODEL["neck"], in_channels=(256, 512, 1024, 2048)))


def small_dense(type_name, head, neck=SMALL_DENSE_NECK, **extra):
    """A small dense detector: ResNet-18, a 64-channel FPN P3-P7, ``head``
    at 64 channels with 2 tower convs, 16 classes."""
    return dict(type=type_name, backbone=dict(type="ResNet", depth=18),
                neck=neck, bbox_head=dict(dict(
                    num_classes=16, in_channels=64, feat_channels=64,
                    stacked_convs=2), **head), **extra)


SMALL_SEPBN_GHM = small_dense("RetinaNet", SMALL_SEPBN_HEAD,
                              SMALL_RETINA_NECK, **GHM_LOSSES)
SMALL_REPPOINTS = small_dense(
    "RepPointsDetector", dict(type="RepPointsHead", point_feat_channels=64),
    transform_method="moment")
HBB_KINDS.update(
    fcos=dict(small=small_dense("FCOS", dict(type="FCOSHead"),
                                center_sampling=True),
              config=FCOS_CONFIG),
    atss=dict(small=small_dense("ATSS", dict(type="ATSSHead")),
              config=ATSS_CONFIG),
    fovea=dict(small=small_dense("FOVEA", dict(type="FoveaHead")),
               config=FOVEA_CONFIG),
    reppoints=dict(small=SMALL_REPPOINTS, config=REPPOINTS_CONFIG),
    reppoints_dcn=dict(small=SMALL_REPPOINTS, config=REPPOINTS_DCN_CONFIG,
                       train=None),
    ga_retina=dict(small=small_dense("GARetinaNet",
                                     dict(type="GARetinaHead"),
                                     SMALL_RETINA_NECK),
                   config=GA_RETINA_CONFIG),
    free_anchor=dict(small=small_dense(
        "FreeAnchorRetinaNet", SMALL_RETINA_HEAD, SMALL_RETINA_NECK,
        free_anchor_cfg=dict(pre_anchor_topk=20)),
        config=FREE_ANCHOR_CONFIG),
    sepbn=dict(small=SMALL_SEPBN_GHM, config=SEPBN_CONFIG),
    ghm=dict(small=SMALL_SEPBN_GHM, config=GHM_CONFIG),
    sepbn_ghm=dict(small=SMALL_SEPBN_GHM, config=None),
    nasfpn=dict(small=small_dense(
        "RetinaNet", SMALL_SEPBN_HEAD, dict(
            type="NASFPN", in_channels=(64, 128, 256, 512), out_channels=64,
            num_outs=5, stack_times=2, start_level=1)),
        config=NASFPN_CONFIG),
    ssd=dict(small=dict(type="SSD", input_size=300,
                        bbox_head=dict(type="SSDHead", num_classes=21)),
             config=SSD_CONFIG, img=300))
# the dense kinds: float images (they read them as they are), no
# RoIAlign launch a call or a step
for _spec in HBB_KINDS.values():
    if _spec.get("small", {}).get("type") in (
            "FCOS", "ATSS", "FOVEA", "RepPointsDetector", "GARetinaNet",
            "FreeAnchorRetinaNet", "RetinaNet", "SSD"):
        _spec.update(dense=True, predict={})
        _spec.setdefault("train", {})
HBB_KINDS.update(
    dcn=dict(small=dict(type="FasterRCNN", **SMALL_DCN_BACKBONE),
             config=DCN_CONFIG, predict=K1, train=K2, ref_img=128),
    mdconv=dict(small=dict(type="MaskRCNN", **SMALL_DCN_BACKBONE,
                           mask_head=dict(type="FCNMaskHead",
                                          **SMALL_HBB_MASK_HEAD)),
                config=MDCONV_CONFIG, predict=dict(roi_align=2), train=None,
                masks=True, ref_img=128))
# each reference phase's kind, and the configs as written with their titles
SLICE15_REFERENCES = ("fcos", "atss", "fovea", "reppoints", "ga_retina",
                      "free_anchor", "sepbn_ghm", "nasfpn", "ssd", "dcn")
SLICE15_PATHS = (
    ("fcos", "FCOS R50-FPN"), ("atss", "ATSS R50-FPN"),
    ("fovea", "FoveaBox R50-FPN"),
    ("reppoints", "RepPoints moment R50-FPN-GN"),
    ("ga_retina", "GA-RetinaNet R50-FPN"),
    ("free_anchor", "FreeAnchor RetinaNet R50-FPN"),
    ("sepbn", "RetinaNet R50-FPN SepBN head"),
    ("ghm", "RetinaNet R50-FPN GHMC + GHMR"),
    ("nasfpn", "RetinaNet R50-NAS-FPN SepBN head"),
    ("ssd", "SSD300 VGG-16"),
    ("dcn", "FasterRCNN R50-FPN dconv C3-C5"),
    ("mdconv", "Mask R-CNN R50-FPN mdconv C3-C5"),
    ("reppoints_dcn", "RepPoints moment R101-FPN-GN dconv C3-C5"))


def run_slice15(card):
    """The reference phases of slice 15's families (small models, the card
    against the CPU: FCOS with centre sampling, ATSS, FoveaBox, RepPoints
    moment, GA-RetinaNet, FreeAnchor, RetinaNet with the SepBN head and
    the GHM losses, NAS-FPN, SSD300, a FasterRCNN with DCNv2 stages),
    then the configs as written: predict of all thirteen, and the train
    steps of all but Mask R-CNN mdconv and RepPoints R101 dcn.  Returns
    the runs' fields by path name."""
    for kind in SLICE15_REFERENCES:
        phase(f"{kind}_reference", card=card, **run_hbb_reference(kind=kind))
    runs = {}
    for kind, title in SLICE15_PATHS:
        paths = run_hbb_paths(kind=kind)
        for part in ("predict", "train"):
            if part in paths:
                runs[f"{kind}_{part}"] = paths[part]
        phase(kind, model=title, card=card, **paths)
    return runs


# Slice 16: ResNet's plug-ins (generalized attention, GCNet's context
# blocks, weight-standardised convs) and FPN_CARAFE as the COCO configs
# write them (float32, 81 classes): R-CNNs whose RoIAlign is K1 and K2;
# and the reference's XLA-only ops, which are plain PyTorch on the card
ATTENTION_0010_CONFIG = "configs/faster_rcnn_attention_0010_r50_fpn_1x.py"
ATTENTION_1111_CONFIG = "configs/faster_rcnn_attention_1111_r50_fpn_1x.py"
ATTENTION_DCN_CONFIG = "configs/faster_rcnn_attention_1111_dcn_r50_fpn_1x.py"
GCB_CONFIG = "configs/mask_rcnn_r16_gcb_c3-c5_r50_fpn_1x.py"
FASTER_CARAFE_CONFIG = "configs/faster_rcnn_carafe_r50_fpn_1x.py"
MASK_CARAFE_CONFIG = "configs/mask_rcnn_r50_fpn_carafe_1x.py"
GN_WS_CONFIG = "configs/mask_rcnn_r50_fpn_gn_ws_2x.py"
SMALL_ATTENTION = dict(backbone=dict(
    type="ResNet", depth=18, gen_attention=dict(
        attention_type="1111", num_heads=8, kv_stride=2),
    gen_attention_stages=(False, False, True, True)))
SMALL_MASK = dict(type="MaskRCNN", mask_head=dict(type="FCNMaskHead",
                                                  **SMALL_HBB_MASK_HEAD))
MASK_K1 = dict(roi_align=2)
MASK_K2 = dict(roi_align_train_forward=2, roi_align_backward=2)
HBB_KINDS.update(
    attention=dict(small=dict(type="FasterRCNN", **SMALL_ATTENTION),
                   config=ATTENTION_1111_CONFIG, predict=K1, train=K2,
                   ref_img=128),
    attention_0010=dict(small=dict(type="FasterRCNN", **SMALL_ATTENTION),
                        config=ATTENTION_0010_CONFIG, predict=K1, train=K2),
    attention_dcn=dict(small=dict(type="FasterRCNN", **SMALL_ATTENTION),
                       config=ATTENTION_DCN_CONFIG, predict=K1, train=None),
    gcb=dict(small=dict(SMALL_MASK, backbone=dict(
        type="ResNet", depth=50, gcb=dict(ratio=1 / 16),
        stage_with_gcb=(False, True, True, True)),
        neck=SMALL_DCN_BACKBONE["neck"]),
        config=GCB_CONFIG, predict=MASK_K1, train=MASK_K2, masks=True,
        pipeline=GCB_CONFIG, ref_img=128),
    faster_carafe=dict(small=dict(type="FasterRCNN", neck=dict(
        type="FPN_CARAFE", in_channels=(64, 128, 256, 512), out_channels=64,
        num_outs=5)), config=FASTER_CARAFE_CONFIG, predict=K1, train=K2),
    gn_ws=dict(small=dict(SMALL_MASK, backbone=dict(
        type="ResNet", depth=18, norm_cfg=GN_CFG,
        conv_cfg=dict(type="ConvWS")), neck=dict(
            SMALL_MODEL["neck"], norm_cfg=GN_CFG),
        mask_head=dict(SMALL_MASK["mask_head"], norm_cfg=GN_CFG)),
        config=GN_WS_CONFIG, predict=MASK_K1, train=MASK_K2, masks=True,
        pipeline=GN_WS_CONFIG, ref_img=128))
HBB_KINDS.update(carafe=dict(
    HBB_KINDS["faster_carafe"], small=dict(
        SMALL_MASK, neck=HBB_KINDS["faster_carafe"]["small"]["neck"]),
    config=MASK_CARAFE_CONFIG, predict=MASK_K1, train=MASK_K2, masks=True,
    pipeline=MASK_CARAFE_CONFIG, ref_img=128))
for _kind in ("gcb", "gn_ws"):
    HBB_KINDS[_kind]["ref_float64"] = True
# the small GCNet and GN+WS Mask R-CNNs' first-step update in float32
# against the CPU's float64, on the CPU alone: GCNet 8.9e-4 relative L2
# with its default threads (5.9e-5 with one), the worst leaf at 2.2e-2
# of its largest update (layer4's conv2); GN+WS 1.2e-3 and 4.1e-2 with
# one thread (8.8e-5 with its default threads); CARAFE's and the
# attention's stay under 4e-5 and 2e-3 either way
PLUGIN_FLOAT32_NOTE = ("the GCNet and GN+WS models' float32 update lies up "
                       "to 1.2e-3 relative L2 and 4.1e-2 of a leaf's "
                       "largest update from float64 on the CPU alone, by "
                       "its thread count")
SLICE16_REFERENCES = ("attention", "gcb", "carafe", "gn_ws")
SLICE16_PATHS = (
    ("attention_0010", "FasterRCNN R50-FPN attention 0010"),
    ("attention", "FasterRCNN R50-FPN attention 1111"),
    ("gcb", "Mask R-CNN R50-FPN GCNet r16 C3-C5"),
    ("faster_carafe", "FasterRCNN R50-FPN_CARAFE"),
    ("carafe", "Mask R-CNN R50-FPN_CARAFE"),
    ("gn_ws", "Mask R-CNN R50-FPN GN+WS"),
    ("attention_dcn", "FasterRCNN R50-FPN attention 1111 dconv C3-C5"))
# the ops phase's shapes: one 1024^2 image's four 256-channel levels with
# 1000 proposals (multilevel_roi_align_fused, K1), 256 rois on its
# stride-16 level (the deformable pools) and stride-32 level (roi_pool),
# a 128^2 map of 256 channels (CARAFE's P4 -> P3, grid_sample, the
# masked conv); and the CPU rehearsal's
SLICE16_OPS = dict(img=1024, channels=256, rois=1000, pool_rois=256,
                   map=128)
SLICE16_OPS_SMALL = dict(img=256, channels=32, rois=100, pool_rois=32,
                         map=32)
OPS_REL = 1e-4      # card against CPU, of the output's largest magnitude


def run_slice16_ops(device="cuda", small=False):
    """The reference's XLA-only ops on ``device`` against the CPU on the
    same seeded inputs (`SLICE16_OPS`, or `SLICE16_OPS_SMALL` with
    ``small``), float32 with TF32 off: each
    output within `OPS_REL` of its largest magnitude, and for the
    deformable pools and their packs the gradient of a seeded cotangent
    too, computed in float64 on both (its float32 differences are
    reported: in a pack the offsets come from the features, and a sample
    that the two devices' float32 rounding puts on either side of a cell
    edge takes another cell's slope, which moved the features' gradient
    by 1.8e-2 of its largest; float64 leaves no sample that close),
    with the device's ms a call; `multilevel_roi_align_fused` at
    roi_scale_factor 1.0 and 1.5, through K1 (one launch each, counted
    here) against K1's plain version on the CPU.  Returns the fields."""
    import torch
    from aidet_tpu_torch.ops import deform_pool as dp
    from aidet_tpu_torch.ops.carafe import CARAFEPack
    from aidet_tpu_torch.ops.grid_sample import (affine_grid, grid_sample,
                                                 masked_conv2d)
    from aidet_tpu_torch.ops.roi_align import multilevel_roi_align_fused
    from aidet_tpu_torch.ops.roi_pool import roi_pool
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"
    sz = SLICE16_OPS_SMALL if small else SLICE16_OPS
    gen = torch.Generator().manual_seed(16)
    c, img = sz["channels"], sz["img"]
    feats = [torch.randn((img // st, img // st, c), generator=gen)
             for st in MAIN["strides"]]
    rois = main_path_rois(gen, 1, sz["rois"], img)[0]
    xy = torch.rand((sz["pool_rois"], 2), generator=gen) * img * 0.9
    pool_rois = torch.cat([xy, xy + 8 + torch.rand(
        (sz["pool_rois"], 2), generator=gen) * img * 0.3], 1)
    fmap = torch.randn((2, sz["map"], sz["map"], c), generator=gen)
    theta = torch.tensor([[[1.1, 0.2, 0.05], [-0.1, 0.9, -0.1]],
                          [[0.8, -0.3, 0.2], [0.25, 1.05, 0.1]]])
    weight = torch.randn((c, c, 3, 3), generator=gen) / math.sqrt(9 * c)
    mask = (torch.rand((2, sz["map"], sz["map"], 1), generator=gen)
            > 0.5).float()
    pack = dict(out_size=7, out_channels=c, spatial_scale=1 / 16,
                sample_per_part=2, trans_std=0.1)
    packs = {}
    for name, cls, extra in (
            ("deform_pack", dp.DeformRoIPoolingPack, {}),
            ("mdeform_pack", dp.ModulatedDeformRoIPoolingPack,
             dict(num_mask_fcs=2))):
        m = cls(**pack, **extra)
        with torch.no_grad():
            for p in m.parameters():     # the zero-started linears too
                p.copy_(torch.randn(p.shape, generator=gen)
                        / math.sqrt(p.shape[-1]))
        packs[name] = m
    carafe = CARAFEPack(c)
    cot = torch.randn((sz["pool_rois"], 7, 7, c), generator=gen)
    cases = dict(
        roi_align_fused_1_0=lambda d, t: multilevel_roi_align_fused(
            [t(f) for f in feats], t(rois), 7, MAIN["strides"],
            roi_scale_factor=1.0),
        roi_align_fused_1_5=lambda d, t: multilevel_roi_align_fused(
            [t(f) for f in feats], t(rois), 7, MAIN["strides"],
            roi_scale_factor=1.5),
        roi_pool=lambda d, t: roi_pool(t(feats[3]), t(pool_rois), 7,
                                       1 / 32),
        grid_sample=lambda d, t: grid_sample(
            t(fmap), affine_grid(t(theta), (2, sz["map"], sz["map"])),
            padding_mode="zeros"),
        masked_conv2d=lambda d, t: masked_conv2d(t(fmap), t(mask),
                                                 t(weight)),
        carafe=lambda d, t: carafe.to(d)(t(fmap).permute(0, 3, 1, 2)))
    out = dict(shapes=sz, rel_limit=OPS_REL, tf32=False)
    on_device = {}

    def to_device(x):       # each input copied to the device once
        if id(x) not in on_device:
            on_device[id(x)] = x.to(device)
        return on_device[id(x)]
    launch_counts(reset=True)
    with torch.no_grad():
        for name, fn in cases.items():
            out[name] = dict(rel_err=_rel_err(fn(device, to_device),
                                              fn("cpu", lambda x: x)))
    # the comparisons' launches: K1 once for each fused call
    out["launches"] = launch_counts()
    if on_card:
        with torch.no_grad():
            for name, fn in cases.items():
                out[name]["ms"] = cuda_ms(lambda: fn(device, to_device), 3,
                                          1)
    # the deformable pools: forward and the gradient for the features
    # (and the offsets), card against CPU; the gradients also in float64
    off = 0.3 * torch.randn((sz["pool_rois"], 7, 7, 2), generator=gen)
    cached = {}

    def put(x, d, dtype):   # x on (d, dtype), converted once
        key = (id(x), d, dtype)
        if key not in cached:
            module = isinstance(x, torch.nn.Module)
            cached[key] = (copy.deepcopy(x) if module else x).to(d, dtype)
        return cached[key]
    grad_cases = dict(
        deform_roi_pool=lambda d, f, o: dp.deform_roi_pool(
            f, put(pool_rois, d, f.dtype), o, 7, 1 / 16, 2, 0.1),
        deform_pack=lambda d, f, o: put(packs["deform_pack"], d, f.dtype)(
            f, put(pool_rois, d, f.dtype)),
        mdeform_pack=lambda d, f, o: put(packs["mdeform_pack"], d, f.dtype)(
            f, put(pool_rois, d, f.dtype)))

    def run(fn, d, dtype):
        f = put(feats[2], d, dtype).detach().requires_grad_()
        o = put(off, d, dtype).detach().requires_grad_()
        y = fn(d, f, o)
        grads = torch.autograd.grad((y * put(cot, d, dtype)).sum(), (f, o),
                                    allow_unused=True)
        return y.detach(), grads[0], grads[1]

    for name, fn in grad_cases.items():
        (y, g, go), (y_ref, g_ref, go_ref) = (
            run(fn, d, torch.float32) for d in (device, "cpu"))
        fields = dict(rel_err=_rel_err(y, y_ref),
                      grad_f32_max_rel=_rel_err(g, g_ref),
                      grad_f32_rel_l2=_rel_l2(g, g_ref))
        (_, g, go), (_, g_ref, go_ref) = (
            run(fn, d, torch.float64) for d in (device, "cpu"))
        fields["grad_rel_err"] = _rel_err(g, g_ref)
        if go_ref is not None:
            fields["offset_grad_rel_err"] = _rel_err(go, go_ref)
        if on_card:
            fields["forward_backward_ms"] = cuda_ms(
                lambda: run(fn, device, torch.float32), 3, 1)
        out[name] = fields
    bad = {k: v for k, v in out.items() if isinstance(v, dict) and any(
        k2.endswith("rel_err") and not x <= OPS_REL for k2, x in v.items())}
    want = dict.fromkeys(HANDLES, 0)
    if on_card:
        want["roi_align"] = 2
    if bad or out["launches"] != want:
        raise AssertionError(f"slice16 ops: {bad or out['launches']}")
    return out


def _rel_err(got, ref):
    """Largest |got - ref| over ref's largest magnitude (inf if not
    finite)."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    err = float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-12))
    return err if math.isfinite(err) else math.inf


def _rel_l2(got, ref):
    """||got - ref|| / ||ref|| in float64 (inf if not finite)."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    err = float((got - ref).norm() / ref.norm().clamp(min=1e-30))
    return err if math.isfinite(err) else math.inf


def run_slice16(card):
    """The reference phases of slice 16's plug-ins (small models, the card
    against the CPU: FasterRCNN with '1111' attention, GCNet Mask R-CNN,
    CARAFE Mask R-CNN, GN+WS Mask R-CNN), the configs as written
    (`SLICE16_PATHS`: predict of all seven, the train steps of all but
    the attention dcn one), then the ops phase.  Returns the runs'
    fields by path name."""
    for kind in SLICE16_REFERENCES:
        phase(f"{kind}_reference", card=card, **run_hbb_reference(kind=kind))
    runs = {}
    for kind, title in SLICE16_PATHS:
        paths = run_hbb_paths(kind=kind)
        for part in ("predict", "train"):
            if part in paths:
                runs[f"{kind}_{part}"] = paths[part]
        phase(kind, model=title, card=card, **paths)
    phase("slice16_ops", card=card, **run_slice16_ops())
    return runs


# the data-parallel phase: a seeded global batch of 4 over 2 ranks on the
# one card (gloo, which carries CUDA tensors; NCCL refuses two ranks on
# one device), and the loop phase's 8 val patches over the same ranks.
# In the compared step the second rank's images hold ``few_gt`` of the
# ``max_gt`` valid gts, so the ranks' normaliser counts differ, as a
# rank-local normaliser would show (`ddp_compared_batch`)
DDP = dict(img=1024, batch=4, max_gt=64, few_gt=8, steps=3, patches=8,
           train=4, test_batch=2, size=1024, objects=60)
DDP_SMALL = dict(img=256, batch=4, max_gt=16, few_gt=2, steps=1, patches=4,
                 train=4, test_batch=2, size=256, objects=12)
DDP_WORLD = 2
# the 2-rank step against the 1-process step over the whole batch, both
# in float32 with TF32 off, on the same card and kernels: they differ
# only in the order of the gradient's sums (over ranks, and in K2's
# backward in the order of its atomics), read on the H100 as 1e-7 of
# the losses, 2.75e-6 of the update (relative L2) and 6.4e-4 of a
# leaf's largest update.  A normaliser left rank-local reads 1.4e-2 to
# 1.0, 1.8e-4 and 1.5e-2 there (`tools/torch_ddp_normaliser_check.sh`),
# so the limits sit between the two
DDP_LIMITS = dict(losses_rel=1e-5, update_rel_l2=1e-4,
                  leaf_over_largest=5e-3)
DDP_RANK_LIMIT_S = 420
# modules that no process of the port may import (the card's machine
# has none of them)
REFERENCE_MODULES = ("jax", "jaxlib", "flax", "optax", "aidet_tpu",
                     "__graft_entry__")


def ddp_config(root, small, sizes, seed=0):
    """The loop phase's config (`LOOP_CONFIG` as written, or its small
    architecture) on seeded patches under ``root``: ``sizes["train"]``
    train patches (2 steps of a global batch of 2 for one epoch) and the
    loop phase's val patches (S24..S31 of seed 0 at full size), written
    as a config file for the port's scripts.  Returns (its path, the
    config)."""
    from aidet_tpu_torch.utils.config import Config
    cfg = Config.fromfile(LOOP_CONFIG).to_dict()
    if small:
        cfg.update(model=SMALL_MODEL, train_cfg=SMALL_TRAIN_CFG,
                   test_cfg=SMALL_TEST_CFG,
                   train_pipeline=dict(cfg["train_pipeline"],
                                       img_size=sizes["size"]))
    train = write_patch_set(root, 0, sizes["train"], sizes["size"],
                            sizes["objects"], seed)
    val = write_patch_set(root, 24, sizes["patches"], sizes["size"],
                          sizes["objects"], seed)
    cfg["data"] = dict(
        train=dict(cfg["data"]["train"], ann_file=train[0],
                   img_prefix=train[1]),
        test=dict(cfg["data"]["test"], ann_file=val[0], img_prefix=val[1]))
    body = {k: cfg.get(k) for k in ("model", "train_cfg", "test_cfg",
                                     "data", "train_pipeline", "optimizer",
                                     "lr_config")}
    body.update(total_epochs=1, batch_size=2,
                run=dict(num_workers=2, log_interval=1))
    path = f"{root}/ddp_config.py"
    with open(path, "w") as f:
        for k, v in body.items():
            f.write(f"{k} = {json.loads(json.dumps(v))!r}\n")
    return path, Config.fromfile(path)


def ddp_train_model(device, small, sizes, compare, seed=0):
    """The flagship's training build: with ``compare`` in float32 under
    a train_cfg that keeps every candidate (so that ranks and a single
    process sample the same rois), else as the train phase runs it."""
    import torch
    from aidet_tpu_torch.flagship import build_flagship
    from aidet_tpu_torch.flagship import keep_every_candidate_cfg
    if not compare:
        return build_flagship(sizes["img"], small=small, device=device,
                              train=True, seed=seed)
    net = build_flagship(sizes["img"], small=small, device="meta",
                         train=True)
    cfg = keep_every_candidate_cfg(sizes["img"], sizes["max_gt"],
                                   net.train_cfg["rpn_proposal"]["max_num"])
    return build_flagship(sizes["img"], small=small, device=device,
                          train=True, dtype=torch.float32, train_cfg=cfg,
                          seed=seed)


def ddp_compared_batch(sizes, seed, device):
    """The compared step's seeded global batch: `synthetic_train_batch`,
    its second half's images with only their first ``few_gt`` gts
    valid."""
    from aidet_tpu_torch.flagship import synthetic_train_batch
    batch = synthetic_train_batch(sizes["batch"], sizes["img"],
                                  sizes["max_gt"], seed, device)
    batch["gt_valid"][sizes["batch"] // 2:, sizes["few_gt"]:] = False
    return batch


def ddp_step(net, batch, gen):
    """One `make_train_step` step (the train phase's optimizer): (metrics
    as floats, parameters after, on the CPU)."""
    from aidet_tpu_torch.parallel.train import (build_lr_schedule,
                                                build_optimizer,
                                                create_train_state,
                                                make_train_step)
    optimizer = build_optimizer(build_lr_schedule(base_lr=0.02))
    step = make_train_step(net, optimizer)
    _, metrics = step(create_train_state(net, optimizer), batch, gen)
    return ({k: float(v) for k, v in metrics.items()},
            [p.detach().to("cpu", copy=True) for p in net.parameters()])


def ddp_timed_steps(net, batch, rank, steps, seed=0):
    """The train phase's optimizer on ``net`` over this rank's ``batch``:
    one warm step, ``steps`` steps timed on the host's clock between
    synchronisations (the ranks lined up by a barrier before each; the
    kernels' launches counted from 0), then one step under
    torch.profiler.  Each step's sampling seed is `step_seed` of (seed,
    step, rank).  Returns ms per step, each step's ms, the host ms of the
    ``allreduce``, ``backward`` and ``optimizer`` spans (on the card a
    span also has a device entry, whose host time is 0), the all-reduce
    bucket's bytes, the timed steps' launches, the last metrics and a
    checksum of the parameters after."""
    import torch
    from aidet_tpu_torch.apis.train import step_seed
    from aidet_tpu_torch.parallel.dist import barrier
    from aidet_tpu_torch.parallel.train import (build_lr_schedule,
                                                build_optimizer,
                                                create_train_state,
                                                make_train_step)
    from torch.profiler import ProfilerActivity, profile as profiler
    on_card = batch["imgs"].is_cuda

    def sync():
        if on_card:
            torch.cuda.synchronize()
    optimizer = build_optimizer(build_lr_schedule(base_lr=0.02))
    state = create_train_state(net, optimizer)
    step = make_train_step(net, optimizer)
    gen = torch.Generator(device=batch["imgs"].device)

    def one():
        gen.manual_seed(step_seed(seed, state.step, rank))
        return step(state, batch, gen)[1]
    one()
    sync()
    launch_counts(reset=True)
    times = []
    for _ in range(steps):
        barrier()
        sync()
        t0 = time.perf_counter()
        metrics = one()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    with profiler(activities=[ProfilerActivity.CPU]
                  + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
        metrics = one()
        sync()
    spans = {}
    for e in prof.key_averages():
        if e.key in ("allreduce", "backward", "optimizer"):
            spans[e.key] = max(spans.get(e.key, 0.0), e.cpu_time_total / 1e3)
    params = list(net.parameters())
    return dict(
        ms_per_step=sum(times) / len(times), step_ms=times, span_ms=spans,
        allreduce_bytes=sum(p.numel() * p.element_size() for p in params),
        launches=launches, metrics={k: float(v) for k, v in metrics.items()},
        param_checksum=float(sum(p.detach().double().square().sum()
                                 for p in params)))


def stack_results(results):
    import numpy as np
    import torch
    return {k: torch.from_numpy(np.stack([np.asarray(r[k])
                                          for r in results]))
            for k in results[0]}


def ddp_reference(device, small, sizes, root, seed=0):
    """The one-process runs the ranks are held to, saved under ``root``:
    the compared step over the whole global batch (with its weights) and
    the test run over the val patches (with the model's weights), both
    with TF32 off."""
    import torch
    from aidet_tpu_torch.apis.inference import init_detector
    from aidet_tpu_torch.apis.test import run_inference
    from aidet_tpu_torch.data.builder import build_dataset
    cfg_path, cfg = ddp_config(root, small, sizes, seed)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    net = ddp_train_model(device, small, sizes, compare=True, seed=seed)
    weights = {k: v.detach().to("cpu", copy=True)
               for k, v in net.state_dict().items()}
    batch = ddp_compared_batch(sizes, seed, device)
    t0 = time.perf_counter()
    metrics, after = ddp_step(net, batch, torch.Generator(
        device=device).manual_seed(seed))
    step_s = time.perf_counter() - t0
    del net, batch
    model, _ = init_detector(cfg, None, device=device, seed=seed)
    results, names = run_inference(model, build_dataset(cfg.data.test),
                                   batch_size=sizes["test_batch"])
    torch.save(dict(weights=weights, metrics=metrics, after=after,
                    infer_weights={k: v.detach().cpu() for k, v in
                                   model.state_dict().items()},
                    results=results, names=names), f"{root}/reference.pt")
    del model
    if on_card:
        torch.cuda.empty_cache()
    return cfg_path, dict(one_process_step_s=step_s,
                          one_process_metrics=metrics)


def ddp_rank(rank, root, device, small, seed=0):
    """One rank's part of the ddp phase (see `run_ddp`); returns its
    fields (rank 0's comparisons among them)."""
    import torch
    from aidet_tpu_torch.apis.inference import init_detector
    from aidet_tpu_torch.apis.test import run_inference
    from aidet_tpu_torch.apis.train import step_seed
    from aidet_tpu_torch.data.builder import build_dataset
    from aidet_tpu_torch.flagship import synthetic_train_batch
    from aidet_tpu_torch.parallel.mesh import (create_mesh, replicate,
                                               shard_batch)
    from aidet_tpu_torch.utils.config import Config
    sizes = DDP_SMALL if small else DDP
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()
    ref = torch.load(f"{root}/reference.pt", weights_only=False)
    mesh = create_mesh(DDP_WORLD)
    out = dict(rank=rank)
    # TF32 off throughout (the one-process runs' setting): the compared
    # step (float32, every candidate kept) and the test run are held to
    # them, and cuDNN's TF32 convolutions round by algorithm, which a
    # process may choose by its free memory
    if on_card:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    net = ddp_train_model(device, small, sizes, compare=True, seed=seed + 1)
    net.load_state_dict(ref["weights"], strict=True)
    replicate(net, mesh)
    batch = shard_batch(ddp_compared_batch(sizes, seed, device), mesh)
    before = [ref["weights"][n] for n, _ in net.named_parameters()]
    got = ddp_step(net, batch, torch.Generator(device=device).manual_seed(
        step_seed(seed, 0, rank)))
    out["valid_gts"] = int(batch["gt_valid"].sum())
    if rank == 0:
        # held to `DDP_LIMITS` by `run_ddp` once both ranks are done,
        # so that a failing comparison leaves no rank waiting
        names = [n for n, _ in net.named_parameters()]
        cmp = compare_steps("ddp", (got[0], before, got[1]),
                            (ref["metrics"], before, ref["after"]))
        cmp["worst_leaf"] = names[cmp["worst_leaf"]]
        out.update(against_one_process=cmp, metrics_2rank=got[0],
                   metrics_1process=ref["metrics"])
    del net, batch, got
    if on_card:
        torch.cuda.empty_cache()
    # the train phase's step (its dtype, train_cfg and optimizer) on the
    # rank's 2 images, timed
    net = ddp_train_model(device, small, sizes, compare=False, seed=seed + 1)
    net.load_state_dict(ref["weights"], strict=True)
    replicate(net, mesh)
    batch = shard_batch(synthetic_train_batch(
        sizes["batch"], sizes["img"], sizes["max_gt"], seed, device), mesh)
    timed = ddp_timed_steps(net, batch, rank, sizes["steps"], seed)
    bad = [k for k, v in timed["metrics"].items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"ddp rank {rank}: {bad} not finite")
    if "allreduce" not in timed["span_ms"]:
        raise AssertionError(f"ddp rank {rank}: no allreduce span")
    launches = timed.pop("launches")
    out.update(
        timed, allreduce_span_ms=timed["span_ms"]["allreduce"],
        train_launches=launches, k2_forward_per_step=launches[
            "roi_align_train_forward"] / sizes["steps"],
        k2_backward_per_step=launches["roi_align_backward"] / sizes["steps"],
        compute_dtype=str(net.compute_dtype))
    del net, batch
    if on_card:
        torch.cuda.empty_cache()
    # the test run, sharded by the group and gathered
    cfg = Config.fromfile(f"{root}/ddp_config.py")
    model, _ = init_detector(cfg, None, device=device, seed=seed + 1)
    model.load_state_dict(ref["infer_weights"], strict=True)
    dataset = build_dataset(cfg.data.test)
    sync()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    results, names = run_inference(model, dataset,
                                   batch_size=sizes["test_batch"])
    sync()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    if names != ref["names"]:
        raise AssertionError(f"ddp rank {rank}: gathered names {names}")
    errs = match_detections(stack_results(results),
                            stack_results(ref["results"]), LOOP_INFER_LIMITS)
    out.update(test_s=seconds, test_launches=launches,
               test_against_one_process=errs,
               n_valid=int(sum(int(r["valid"].sum()) for r in results)))
    return out


def ddp_rank_main(argv) -> int:
    """`python3 chip_smoke.py --ddp-rank RANK ROOT DEVICE small|full`: one
    rank of the ddp phase (gloo on ``DEVICE``, rendezvous at ROOT/store);
    writes its fields to ROOT/rank{RANK}.json."""
    rank, root, device, size = int(argv[0]), argv[1], argv[2], argv[3]
    from aidet_tpu_torch.parallel.dist import init_distributed
    init_distributed(rank, DDP_WORLD, local_rank=0,
                     init_method=f"file://{root}/store", device=device,
                     backend="gloo", timeout_s=DDP_RANK_LIMIT_S)
    out = ddp_rank(rank, root, device, size == "small")
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in REFERENCE_MODULES)
    if leaked:
        raise AssertionError(f"ddp rank {rank} imported {leaked}")
    with open(f"{root}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    import torch.distributed as tdist
    tdist.destroy_process_group()
    return 0


def ddp_ranks(device, small, root):
    """Start the ranks (each `ddp_rank_main`) and wait for them; a rank
    that fails or outlives `DDP_RANK_LIMIT_S` fails the phase, and the
    others are killed.  Returns their fields by rank."""
    import os
    env = dict(os.environ)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ddp-rank", str(r),
         root, device, "small" if small else "full"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(DDP_WORLD)]
    deadline = time.monotonic() + DDP_RANK_LIMIT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"ddp rank {r} exited {p.returncode}:\n"
                                 f"{log[-3000:]}")
    out = []
    for r in range(DDP_WORLD):
        with open(f"{root}/rank{r}.json") as f:
            out.append(json.load(f))
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_launcher(device, cfg_path, root):
    """`tools/torch_dist_train.sh CONFIG 1`: torchrun with one process
    (NCCL on the card, gloo with --device cpu) trains the config for its
    one epoch; its log's step lines, backend and checkpoint."""
    import os
    work = f"{root}/launcher"
    args = ["bash", "tools/torch_dist_train.sh", cfg_path, "1", "--work-dir",
            work] + (["--device", "cpu"] if device == "cpu" else [])
    env = dict(os.environ, PYTHON=sys.executable, PORT=str(free_port()))
    t0 = time.perf_counter()
    proc = subprocess.run(args, cwd=os.path.dirname(os.path.abspath(
        __file__)), env=env, capture_output=True, text=True,
        timeout=DDP_RANK_LIMIT_S)
    wall = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"torch_dist_train.sh exited "
                             f"{proc.returncode}:\n{log[-3000:]}")
    backend = "nccl" if device != "cpu" else "gloo"
    steps = [line.split(" - ")[-1] for line in log.splitlines()
             if "epoch 1 iter" in line]
    if not any("iter 2/2" in line for line in steps) \
            or f"backend {backend}" not in log:
        raise AssertionError(f"torch_dist_train.sh: no step 2/2 or no "
                             f"{backend} group in its log:\n{log[-3000:]}")
    ckpt = sorted(os.listdir(f"{work}/ckpt"))
    if ckpt != ["meta.json", "model_1", "step_1"]:
        raise AssertionError(f"torch_dist_train.sh wrote {ckpt}")
    return dict(wall_s=wall, backend=backend, step_lines=steps,
                checkpoint=ckpt)


def run_ddp(device="cuda", small=False, seed=0):
    """The data-parallel phase.  The launching process runs the
    one-process references (`ddp_reference`; the kernels were built
    before), then two ranks over gloo on the one card, each
    (`ddp_rank`):

    - the flagship's train step (full width: R50-FPN at 1024^2) on its 2
      images of a seeded global batch of 4 (`ddp_compared_batch`: 64
      gts an image on rank 0, 8 on rank 1), from the same weights, in
      float32 with TF32 off and every candidate kept, rank 0 comparing
      the update with the one-process step over all 4 images
      (`compare_steps`), held here to `DDP_LIMITS`;
    - the train phase's step (bfloat16 compute, its train_cfg), timed:
      ms per 2-rank step, the ``allreduce`` span's host ms (torch.profiler;
      gloo copies the bucket through the host), K2's launches per rank;
    - `run_inference` over the loop phase's 8 val patches (the loop
      config's model, float32 with TF32 off), sharded over the ranks and
      gathered, every detection paired with the one-process run's
      (`match_detections`, `LOOP_INFER_LIMITS`).

    Then `tools/torch_dist_train.sh` at one process (torchrun, NCCL on
    the card) trains the loop config for 2 steps.  Every rank's
    parameters must agree after the timed steps.  Returns the fields and
    the launches of the ranks' train and test paths."""
    import shutil
    import tempfile
    import torch
    sizes = DDP_SMALL if small else DDP
    root = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    threads = torch.get_num_threads()
    try:
        t0 = time.perf_counter()
        if device == "cpu":         # the ranks' order of sums
            torch.set_num_threads(1)
        cfg_path, fields = ddp_reference(device, small, sizes, root, seed)
        torch.set_num_threads(threads)
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = ddp_ranks(device, small, root)
        ranks_s = time.perf_counter() - t0
        cmp = ranks[0]["against_one_process"]
        if not (all(math.isfinite(v) for v in ranks[0]["metrics_2rank"]
                    .values())
                and cmp["max_rel_err"] <= DDP_LIMITS["losses_rel"]
                and cmp["update_rel_l2"] <= DDP_LIMITS["update_rel_l2"]
                and cmp["worst_leaf_err_over_largest"]
                <= DDP_LIMITS["leaf_over_largest"]):
            raise AssertionError(
                f"ddp: the 2-rank step against one process's {cmp} "
                f"(limits {DDP_LIMITS}); 2-rank metrics "
                f"{ranks[0]['metrics_2rank']}, one process's "
                f"{ranks[0]['metrics_1process']}")
        launcher = ddp_launcher(device, cfg_path, root)
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(root, ignore_errors=True)
    sums = {r["param_checksum"] for r in ranks}
    if len(sums) != 1:
        raise AssertionError(f"ddp: the ranks' parameters differ: {sums}")
    on_card = device != "cpu"
    want = dict.fromkeys(HANDLES, 0)
    want.update(roi_align_train_forward=sizes["steps"] * on_card,
                roi_align_backward=sizes["steps"] * on_card)
    test_batches = -(-sizes["patches"] // DDP_WORLD // sizes["test_batch"])
    want_test = dict(dict.fromkeys(HANDLES, 0),
                     roi_align=test_batches * on_card)
    for r in ranks:
        if r["train_launches"] != want or r["test_launches"] != want_test:
            raise AssertionError(f"ddp rank {r['rank']}: launches "
                                 f"{r['train_launches']} / "
                                 f"{r['test_launches']}, expected {want} / "
                                 f"{want_test}")
        if r["test_against_one_process"]["unpaired"]:
            raise AssertionError(f"ddp rank {r['rank']}: unpaired "
                                 f"detections {r['test_against_one_process']}")
    rank0 = ranks[0]
    return dict(
        img=sizes["img"], global_batch=sizes["batch"], world=DDP_WORLD,
        backend="gloo", limits=DDP_LIMITS,
        compared_valid_gts_by_rank=[r["valid_gts"] for r in ranks],
        against_one_process=dict(rank0["against_one_process"],
                                 limits=DDP_LIMITS),
        ms_per_2rank_step=max(r["ms_per_step"] for r in ranks),
        step_ms_by_rank=[r["step_ms"] for r in ranks],
        allreduce_span_ms_by_rank=[r["allreduce_span_ms"] for r in ranks],
        span_ms_by_rank=[r["span_ms"] for r in ranks],
        allreduce_bytes=rank0["allreduce_bytes"],
        compute_dtype=rank0["compute_dtype"],
        k2_per_step_by_rank=[(r["k2_forward_per_step"],
                              r["k2_backward_per_step"]) for r in ranks],
        metrics=rank0["metrics"],
        test=dict(patches=sizes["patches"], batch=sizes["test_batch"],
                  s_by_rank=[r["test_s"] for r in ranks],
                  against_one_process=rank0["test_against_one_process"],
                  limits=LOOP_INFER_LIMITS, n_valid=rank0["n_valid"]),
        launcher=launcher, reference_s=ref_s, ranks_s=ranks_s, **fields,
        train_path=dict(launches=rank0["train_launches"]),
        test_path=dict(launches=rank0["test_launches"]))


# ---------------------------------------------------------------------
# slice 18: the data layer's train paths: the JPEG decoder, VOC with
# ConcatDataset, BuildChange, InstaBoost and albu
# ---------------------------------------------------------------------

JPEG_FIXTURES = "tests/fixtures/jpeg"
VOC_CONFIG = "configs/faster_rcnn_r50_fpn_1x_voc0712.py"
BUILDCHANGE_CONFIG = "configs/bc_v002_mask_rcnn_r50_v2_jinan_roof.py"
INSTABOOST_CONFIG = "configs/mask_rcnn_r50_fpn_instaboost_4x.py"
R18_E2E_CONFIG = "configs/dota_theta_obb_r18_e2e.py"
ALBU_CONFIG = "configs/mask_rcnn_r50_fpn_albu_1x.py"
JPEG_REPEATS = 20        # timed decodes of each 512^2 fixture
LOADER_WORKERS = 4       # GroupedLoader's decode threads (its default)
DATA_SMALL_IMG = 256     # the CPU rehearsals' image size
SMALL_DATA_MASK_HEAD = dict(type="FCNMaskHead", num_convs=2, in_channels=64,
                            conv_out_channels=64)


def jpeg_fixtures():
    """(relative name, the fixture's record in decodes.json) of every
    JPEG fixture, and the paths of the 512^2 DOTA patches among them."""
    import os
    with open(os.path.join(JPEG_FIXTURES, "decodes.json")) as f:
        decodes = json.load(f)
    dota = [os.path.join(JPEG_FIXTURES, n) for n in sorted(decodes)
            if n.startswith("dota/")]
    return decodes, dota


def run_jpeg(repeats=JPEG_REPEATS):
    """Every JPEG fixture through `imio.imread` (the host library's C++
    decoder), held to cv2's decode recorded in the fixtures'
    decodes.json (shape and sha256 of the array), the progressive one
    refused; then ms per 512^2 4:2:0 decode of the DOTA fixtures on one
    thread and in a pool of the loader's `LOADER_WORKERS` threads
    (wall ms over the images decoded: what a loader epoch pays).
    Returns the phase's fields."""
    import hashlib
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from aidet_tpu_torch.data.imio import imread
    decodes, dota = jpeg_fixtures()
    refused = []
    for name, want in decodes.items():
        path = os.path.join(JPEG_FIXTURES, name)
        if "refused" in want:
            try:
                imread(path)
            except ValueError as e:
                if want["refused"] not in str(e) or name not in str(e):
                    raise AssertionError(f"jpeg: {name} refused as {e}")
                refused.append(name)
                continue
            raise AssertionError(f"jpeg: {name} was decoded, not refused")
        img = np.ascontiguousarray(imread(path))
        sha = hashlib.sha256(img.tobytes()).hexdigest()
        if list(img.shape) != want["shape"] or sha != want["sha256"]:
            raise AssertionError(f"jpeg: {name} decodes to {img.shape} "
                                 f"{sha}, not cv2's {want}")
    paths = dota * repeats
    t0 = time.perf_counter()
    for p in paths:
        imread(p)
    one = (time.perf_counter() - t0) * 1e3 / len(paths)
    with ThreadPoolExecutor(LOADER_WORKERS) as pool:
        t0 = time.perf_counter()
        list(pool.map(imread, paths))
        pooled = (time.perf_counter() - t0) * 1e3 / len(paths)
    return dict(files=len(decodes), equal_to_cv2=len(decodes) - len(refused),
                refused=refused, decodes_timed=len(paths),
                ms_per_512_image_one_thread=one,
                ms_per_512_image_pool=pooled, pool_threads=LOADER_WORKERS,
                host_cpus=os.cpu_count())


def write_voc_xml(path, w, h, objects):
    """A VOC annotation of an image w x h: (name, difficult, box)."""
    rows = [f"<annotation><size><width>{w}</width><height>{h}</height>"
            "<depth>3</depth></size>"]
    for name, difficult, box in objects:
        x1, y1, x2, y2 = (int(v) for v in box)
        rows.append(f"<object><name>{name}</name><difficult>{difficult}"
                    f"</difficult><bndbox><xmin>{x1}</xmin><ymin>{y1}"
                    f"</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>"
                    "</object>")
    with open(path, "w") as f:
        f.write("".join(rows) + "</annotation>")


def write_voc_data(root, data, seed):
    """The VOC config's data (a list of two VOCDatasets, VOC2007 and
    VOC2012, and VOC2007's val list) on the JPEG fixtures copied under
    ``root``: VOC2007 trains on 4 DOTA patches (512^2), VOC2012 on the
    small fixtures of both aspects (4 images: 333x517, 517x333, 61x93,
    120x90), VOC2007's val list is its 6 DOTA patches; seeded XML of 1 to
    6 objects of the 20 classes an image, about 1 in 8 difficult.
    Returns the config's data dict."""
    import os
    import shutil

    import numpy as np
    from aidet_tpu_torch.core.eval.class_names import VOC_CLASSES
    from aidet_tpu_torch.data.imio import imread
    decodes, dota = jpeg_fixtures()
    small = [os.path.join(JPEG_FIXTURES, n) for n in sorted(decodes)
             if n.startswith("small/") and "refused" not in decodes[n]
             and min(decodes[n]["shape"][:2]) >= 60]
    rs = np.random.RandomState(seed)
    sets = {}
    for year, files in (("VOC2007", dota), ("VOC2012", small)):
        prefix = os.path.join(root, year)
        os.makedirs(os.path.join(prefix, "JPEGImages"))
        os.makedirs(os.path.join(prefix, "Annotations"))
        ids = []
        for p in files:
            i = os.path.basename(p)[:-4]
            shutil.copy(p, os.path.join(prefix, "JPEGImages", f"{i}.jpg"))
            h, w = imread(p).shape[:2]
            objects = []
            for _ in range(rs.randint(1, 7)):
                bw, bh = rs.uniform(0.15, 0.6, 2) * (w, h)
                x1, y1 = rs.uniform(0, w - bw), rs.uniform(0, h - bh)
                objects.append((VOC_CLASSES[rs.randint(20)],
                                int(rs.rand() < 0.125),
                                (x1, y1, x1 + bw, y1 + bh)))
            write_voc_xml(os.path.join(prefix, "Annotations", f"{i}.xml"),
                          w, h, objects)
            ids.append(i)
        sets[year] = (prefix, ids)
        with open(os.path.join(prefix, "train.txt"), "w") as f:
            f.write("\n".join(ids[:4]) + "\n")
    prefix, ids = sets["VOC2007"]
    with open(os.path.join(prefix, "val.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    train = [dict(d, ann_file=os.path.join(sets[os.path.basename(
        d["img_prefix"])][0], "train.txt"), img_prefix=sets[os.path.basename(
            d["img_prefix"])][0]) for d in data["train"]]
    return dict(train=train, test=dict(
        data["test"], ann_file=os.path.join(prefix, "val.txt"),
        img_prefix=prefix))


def write_roof_data(root, data, seed):
    """BuildChange-format data on the six DOTA fixtures: a COCO JSON of
    seeded roof quads (category 1, "building": the polygon, its box,
    area and pointobb) per image, for train and test.  Returns the
    config's data dict."""
    import os

    import numpy as np
    from aidet_tpu_torch.data.np_rboxes import thetaobb2pointobb
    _, dota = jpeg_fixtures()
    rs = np.random.RandomState(seed)
    images, anns = [], []
    for k, p in enumerate(dota):
        images.append(dict(id=k + 1, file_name=os.path.basename(p),
                           width=512, height=512))
        n = rs.randint(6, 16)
        tob = np.concatenate([rs.uniform(60, 452, (n, 2)),
                              rs.uniform(16, 90, (n, 2)),
                              rs.uniform(-np.pi / 2, 0, (n, 1))], -1)
        for q in thetaobb2pointobb(tob.astype(np.float32)).astype(float):
            x, y = q[0::2].clip(0, 511), q[1::2].clip(0, 511)
            q = np.stack([x, y], 1).reshape(-1)
            area = 0.5 * abs(np.dot(x, np.roll(y, -1))
                             - np.dot(y, np.roll(x, -1)))
            anns.append(dict(id=len(anns) + 1, image_id=k + 1,
                             category_id=1, iscrowd=0, area=float(area),
                             bbox=[x.min(), y.min(), x.max() - x.min(),
                                   y.max() - y.min()],
                             segmentation=[q.tolist()],
                             pointobb=q.tolist()))
    path = os.path.join(root, "roofs.json")
    with open(path, "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name="building")]), f)
    prefix = os.path.dirname(dota[0])
    return dict(train=dict(data["train"], ann_file=path, img_prefix=prefix),
                test=dict(data["test"], ann_file=path, img_prefix=prefix))


def dota_fixture_data(root, data, seed):
    """The six DOTA fixture patches with their real annotations
    (the fixtures' dota.json, COCO format with DOTA's quads), for train
    and test."""
    import os
    prefix = os.path.join(JPEG_FIXTURES, "dota")
    ann = os.path.join(JPEG_FIXTURES, "dota.json")
    return dict(train=dict(data["train"], ann_file=ann, img_prefix=prefix),
                test=dict(data["test"], ann_file=ann, img_prefix=prefix))


# each data phase: its config as written, its data, the classes of its
# small architecture, and K2's launches a train step and K1's a test
# batch (the box crops, and with masks the mask crops too)
DATA_PHASES = dict(
    voc=dict(config=VOC_CONFIG, data=write_voc_data, classes=21, masks=False),
    buildchange=dict(config=BUILDCHANGE_CONFIG, data=write_roof_data,
                     classes=2, masks=True),
    instaboost=dict(config=INSTABOOST_CONFIG, data=dota_fixture_data,
                    classes=81, masks=True),
    r18_e2e_jpeg=dict(config=R18_E2E_CONFIG, data=dota_fixture_data,
                      classes=16, masks=False))


def data_config(kind, root, small, seed=0):
    """`DATA_PHASES[kind]`'s config (as written, or its small
    architecture at `DATA_SMALL_IMG`) with its data written under
    ``root``, one epoch at batch 2, a log record every step and a
    checkpoint at the epoch's end."""
    from aidet_tpu_torch.utils.config import Config
    spec = DATA_PHASES[kind]
    cfg = Config.fromfile(spec["config"]).to_dict()
    if small and kind == "r18_e2e_jpeg":
        cfg.update(model=dict(SMALL_MODEL, img_size=DATA_SMALL_IMG),
                   train_cfg=SMALL_TRAIN_CFG, test_cfg=SMALL_TEST_CFG)
    elif small:
        model, train, test = hbb_cfg("faster", True, DATA_SMALL_IMG)
        model["bbox_head"] = dict(model["bbox_head"],
                                  num_classes=spec["classes"])
        if spec["masks"]:
            model.update(type="MaskRCNN", mask_head=dict(
                SMALL_DATA_MASK_HEAD, num_classes=spec["classes"]))
        cfg.update(model=model, train_cfg=train, test_cfg=test)
    if small:
        cfg["train_pipeline"] = dict(cfg.get("train_pipeline") or {},
                                     img_size=DATA_SMALL_IMG)
    cfg["data"] = spec["data"](root, cfg["data"], seed)
    cfg.update(total_epochs=1, batch_size=2, log_interval=1,
               checkpoint_interval=1)
    return Config(cfg, spec["config"])


class CountChanges:
    """A train stage (InstaBoost's or albu's) that counts the samples it
    was given and those whose image it changed; thread-safe, as the
    loader's decode threads share the pipeline."""

    def __init__(self, stage):
        import threading
        self.stage, self.samples, self.changed = stage, 0, 0
        self.lock = threading.Lock()

    def __call__(self, img, *args):
        import numpy as np
        out = self.stage(img, *args)
        changed = not np.array_equal(out[0], img)
        with self.lock:
            self.samples += 1
            self.changed += changed
        return out


class WithoutPolygons:
    """A dataset whose samples leave out their polygons (segmentations,
    kept or ignored): the albu stage refuses a sample that carries them,
    as the reference's does, and a theta-OBB model reads the quads from
    the pointobbs."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __len__(self):
        return len(self.dataset)

    def parse_anns(self, idx):
        return {k: v for k, v in self.dataset.parse_anns(idx).items()
                if k not in ("segmentations", "segmentations_ignore")}


def data_train(cfg, work_dir, device, seed=0, albu=None):
    """`train_detector` of ``cfg`` as tools/torch_train.py builds it (the
    model on ``device``, `TrainPipeline` of its train_pipeline with the
    raw uint8 images, `LOADER_WORKERS` decode threads) for one epoch, its
    InstaBoost and albu stages counted (`CountChanges`); ``albu`` adds
    that albu list to the pipeline and trains on the samples without
    their polygons (`WithoutPolygons`).  Launch counts set to 0 just
    before and read just after.  Returns the run's fields."""
    import torch
    from aidet_tpu_torch.apis.train import train_detector
    from aidet_tpu_torch.data.builder import build_dataset
    from aidet_tpu_torch.data.pipeline import TrainPipeline
    from aidet_tpu_torch.models.builder import build_detector
    on_card = torch.device(device).type == "cuda"
    model = build_detector(cfg.model, train_cfg=cfg.get("train_cfg"),
                           test_cfg=cfg.get("test_cfg"), device=device,
                           seed=seed, train=True)
    pipe_cfg = dict(cfg.get("train_pipeline") or {})
    pipe_cfg.setdefault("device_normalize", True)
    pipe_cfg.setdefault("img_size", model.img_size)
    if albu:
        pipe_cfg["albu"] = albu
    pipeline = TrainPipeline(**pipe_cfg)
    stages = {}
    for name in ("instaboost", "albu"):
        if getattr(pipeline, name) is not None:
            stages[name] = CountChanges(getattr(pipeline, name))
            setattr(pipeline, name, stages[name])
    dataset = build_dataset(cfg.data.train)
    if albu:
        dataset = WithoutPolygons(dataset)
    run = dict(seed=seed, optimizer=cfg.get("optimizer", {}),
               lr_config=cfg.get("lr_config", {}),
               total_epochs=cfg.total_epochs, batch_size=cfg.batch_size,
               log_interval=cfg.log_interval, num_workers=LOADER_WORKERS,
               checkpoint_interval=cfg.checkpoint_interval,
               pipeline=pipeline)
    with LoopRecords() as records:
        if on_card:
            torch.cuda.synchronize()
        launch_counts(reset=True)
        t0 = time.perf_counter()
        train_detector(model, dataset, run, work_dir=work_dir, device=device)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
    steps = [r for r in records if "time" in r]
    losses = [r["metrics"] for r in steps]
    if not steps or not all(math.isfinite(v) for d in losses
                            for v in d.values()):
        raise AssertionError(f"data phase: losses {losses}")
    return dict(steps=len(steps), wall_s=wall,
                ms_per_step=[1e3 * r["time"] for r in steps],
                loader_wait_ms_per_step=[1e3 * r["data_time"]
                                         for r in steps],
                metrics_first=losses[0], metrics_last=losses[-1],
                launches=launches, img_size=pipeline.img_size,
                stages={k: dict(samples=s.samples, changed=s.changed)
                        for k, s in stages.items()})


def data_test(cfg, ckpt_dir, device, batch=2):
    """`init_detector(cfg, ckpt_dir)` and `run_inference` over the
    config's test set at ``batch``, launch counts set to 0 just before
    and read just after."""
    import numpy as np
    import torch
    from aidet_tpu_torch.apis.inference import init_detector
    from aidet_tpu_torch.apis.test import run_inference
    from aidet_tpu_torch.data.builder import build_dataset
    on_card = torch.device(device).type == "cuda"
    model, _ = init_detector(cfg, ckpt_dir, device=device)
    dataset = build_dataset(cfg.data.test)
    if on_card:
        torch.cuda.synchronize()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    results, _ = run_inference(model, dataset, batch_size=batch,
                               pipeline_cfg=cfg.get("test_pipeline"))
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    if len(results) != len(dataset):
        raise AssertionError(f"data phase: {len(results)} results for "
                             f"{len(dataset)} images")
    return dict(images=len(results), batches=-(-len(dataset) // batch),
                s=seconds, launches=launches,
                n_valid=int(sum(np.asarray(r["valid"]).sum()
                                for r in results)))


def check_data_launches(kind, train, test, on_card):
    """K2 forward and backward `per` times a step (2 with a mask head,
    else 1) and K1 `per` times a test batch on the card, none on the
    CPU; each kernel's count of the run beside it."""
    per = 2 if DATA_PHASES[kind]["masks"] else 1
    runs = [(train, dict(roi_align_train_forward=per * train["steps"],
                         roi_align_backward=per * train["steps"]))]
    if test is not None:
        runs.append((test, dict(roi_align=per * test["batches"])))
    for run, want in runs:
        want = dict(dict.fromkeys(HANDLES, 0), **(want if on_card else {}))
        if run["launches"] != want:
            raise AssertionError(f"{kind}: launches {run['launches']}, "
                                 f"expected {want}")
    return per


def run_data_phase(kind, device="cuda", small=False, seed=0):
    """One data phase (`DATA_PHASES`): its config as written (or small)
    on its data under a temporary directory, one epoch at batch 2
    (`data_train`), then the test run from the checkpoint (`data_test`);
    K2 and K1 held to their counts (`check_data_launches`).  InstaBoost's
    must change at least one sample.  The r18_e2e_jpeg phase trains a
    second epoch with the albu config's list added to its pipeline on
    the samples without their polygons, after checking that the stage
    refuses the samples with them (as the reference's does), and albu
    must change at least one sample.  Returns the phase's fields, with
    each run's launches."""
    import os
    import tempfile

    import torch
    on_card = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as root:
        cfg = data_config(kind, root, small, seed)
        train = data_train(cfg, os.path.join(root, "w"), device, seed)
        test = data_test(cfg, os.path.join(root, "w", "ckpt"), device)
        per = check_data_launches(kind, train, test, on_card)
        fields = dict(config=DATA_PHASES[kind]["config"], train=train,
                      test=test, k2_per_step=per, k1_per_batch=per)
        if kind == "instaboost" and train["stages"]["instaboost"][
                "changed"] < 1:
            raise AssertionError(f"instaboost changed no sample: {train}")
        if kind == "r18_e2e_jpeg":
            fields["albu"] = data_albu(cfg, root, device, seed)
            check_data_launches(kind, fields["albu"], None, on_card)
    return fields


def data_albu(cfg, root, device, seed):
    """The albu run of the r18_e2e_jpeg phase (see `run_data_phase`)."""
    import os

    from aidet_tpu_torch.data.builder import build_dataset
    from aidet_tpu_torch.data.imio import imread
    from aidet_tpu_torch.data.pipeline import TrainPipeline
    from aidet_tpu_torch.utils.config import Config
    albu = Config.fromfile(ALBU_CONFIG).train_pipeline.albu
    dataset = build_dataset(cfg.data.train)
    pipe = TrainPipeline(**dict(cfg.train_pipeline, albu=albu))
    try:
        pipe(imread(dataset.img_path(0)), dataset.parse_anns(0))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("albu took a sample with its polygons")
    out = data_train(cfg, os.path.join(root, "albu"), device, seed,
                     albu=albu)
    if out["stages"]["albu"]["changed"] < 1:
        raise AssertionError(f"albu changed no sample: {out}")
    return dict(out, refused_with_polygons=refused)


def run_slice18(card):
    """The jpeg phase, then the data phases (`run_data_phase`: voc,
    buildchange, instaboost, r18_e2e_jpeg); returns their runs' fields
    by path name."""
    phase("jpeg", card=card, **run_jpeg())
    runs = {}
    for kind, title in (("voc", "FasterRCNN R50-FPN, 21 classes"),
                        ("buildchange", "Mask R-CNN R50-FPN, 2 classes"),
                        ("instaboost", "Mask R-CNN R50-FPN, 81 classes"),
                        ("r18_e2e_jpeg", "RBBoxRCNN R18-GN FPN-GN 128")):
        out = run_data_phase(kind)
        runs[f"{kind}_train"], runs[f"{kind}_test"] = out["train"], out["test"]
        if "albu" in out:
            runs[f"{kind}_albu_train"] = out["albu"]
        phase(kind, model=title, card=card, **out)
    return runs


KERNELS = (
    ("roi_align", "aidet_tpu_torch/csrc/roi_align.cu",
     "aidet_tpu/ops/roi_align_band.py:115", "predict"),
    ("roi_align_train_forward", "aidet_tpu_torch/csrc/roi_align.cu",
     "aidet_tpu/ops/roi_align_pallas.py:344", "train"),
    ("roi_align_backward", "aidet_tpu_torch/csrc/roi_align_backward.cu",
     "aidet_tpu/ops/roi_align_pallas.py:378-393", "train"),
    ("roi_align_bandx", "aidet_tpu_torch/csrc/roi_align_bandx.cu",
     "aidet_tpu/ops/roi_align_bandx.py:124", "rroi_predict_bandx"),
    ("rroi_align", "aidet_tpu_torch/csrc/rroi_align.cu",
     "aidet_tpu/ops/rroi_align_pallas.py:247", "rroi_predict"),
    ("rroi_align_backward", "aidet_tpu_torch/csrc/rroi_align_backward.cu",
     "aidet_tpu/ops/rroi_align_pallas.py:282-296", "rroi_train"),
)


def run_rroi_paths(card):
    """The rroi_predict phase (3 calls, K1 and K4), then one call under
    AIDET_ROI_BAND=x (K3 and K4) whose detections are paired with the
    last K1 call's: same labels, scores within 2e-2 (a few bfloat16
    ulps), boxes within 2 px, rboxes within 2 px plus 1e-2 of their
    largest coordinate and theta within 5e-2 where the first-stage
    quad is clear of a tie by 5e-2 (bfloat16 deltas move a quad's
    corners by up to 2^-8 of its size).  K1 and K3 compute one function
    in another order, so a crop may differ by an ulp of bfloat16, and
    random weights rank near-tied scores: at most 5 of the 200
    detections may find no partner, besides those at the 100-per-image
    cut.  Returns the two runs' fields by phase name."""
    fields, model, imgs, shapes, k1_out = run_rroi_predict()
    phase("rroi_predict", model="RBBoxRCNNRRoI R50-FPN", card=card,
          **fields)
    clear = rbox_clear_of_ties(first_stage_quads(model, imgs, shapes),
                               gap=5e-2)
    del model
    bandx, _, _, _, k3_out = run_rroi_predict(calls=1, band="x")
    limits = dict(boxes=2.0, rboxes=2.0, rboxes_rel=1e-2, theta=5e-2,
                  scores=2e-2)
    errs = match_detections(k3_out, k1_out, limits, rbox_clear=clear,
                            max_unpaired=5, cut_slack=True)
    phase("rroi_predict_bandx", model="RBBoxRCNNRRoI R50-FPN", card=card,
          against_k1=errs, limits=limits, **bandx)
    return dict(rroi_predict=fields, rroi_predict_bandx=bandx)


def run_slice12(card, loop_ms_per_step=None):
    """The phases of the GroupNorm r18_e2e recipes, the learning run,
    HRNet, OHEM (beside the loop phase's plain thetaobb step,
    ``loop_ms_per_step``), soft-NMS and TTA, in that order; returns
    their runs' fields by path name (those with launches)."""
    phase("gn_reference", model="small R18-GN FPN-GN float32", card=card,
          theta=run_detector_reference(kind="gn_theta"),
          rroi=run_detector_reference(kind="gn_rroi"))
    runs = {}
    for kind, title in (("theta_r18_e2e", "RBBoxRCNN"),
                        ("rroi_r18_e2e", "RBBoxRCNNRRoI")):
        paths = run_detector_paths(kind=kind)
        runs[f"{kind}_predict"] = paths["predict"]
        runs[f"{kind}_train"] = paths["train"]
        phase(kind, model=f"{title} R18-GN FPN-GN 128", card=card, **paths)
    learn = run_learn()
    runs["learn"] = dict(launches=learn["train_launches"])
    runs["learn_test"] = dict(launches=learn["test_launches"])
    phase("learn", model="RBBoxRCNN R18-GN FPN-GN 128", card=card, **learn)
    phase("hrnet_reference", card=card, **run_hrnet_reference())
    hrnet = run_hrnet()
    runs.update({f"hrnet_{k}": hrnet[k] for k in ("predict", "tta", "train")})
    phase("hrnet", model="CenterMapOBB HRNet-W32 HRFPN", card=card, **hrnet)
    phase("ohem_reference", model="small RBBoxRCNN float32, OHEM",
          card=card, **run_detector_reference(kind="ohem"))
    ohem = run_detector_paths(kind="ohem")
    runs["ohem_train"] = ohem["train"]
    phase("ohem", model="RBBoxRCNN R50-FPN, OHEM", card=card,
          loop_plain_ms_per_step=loop_ms_per_step, **ohem)
    phase("soft_nms_reference", card=card, **run_soft_nms_reference())
    soft = run_soft_nms()
    runs["soft_nms"] = soft
    phase("soft_nms", model="CenterMap-Net R101-FPN", card=card, **soft)
    phase("tta_reference", card=card, **run_tta_reference())
    return runs


def main() -> int:
    info = run_device()
    run_build()
    measured = run_kernels()
    run_reference()
    run_reference_train()
    runs = dict(predict=run_predict())
    phase("predict", model="flagship R50-FPN", card=info["nvidia_smi"],
          **runs["predict"])
    runs["train"] = run_train()
    phase("train", model="flagship R50-FPN", card=info["nvidia_smi"],
          **runs["train"])
    run_rroi_reference()
    runs.update(run_rroi_paths(info["nvidia_smi"]))
    run_reference_train(model="rroi")
    runs["rroi_train"] = run_rroi_train()
    phase("rroi_train", model="RBBoxRCNNRRoI R50-FPN",
          card=info["nvidia_smi"], **runs["rroi_train"])
    phase("scene_reference", model="small flagship float32",
          **run_scene_reference())
    phase("scene", model="flagship R50-FPN", card=info["nvidia_smi"],
          **run_scene())
    runs["loop"] = run_loop()
    phase("loop", model="RBBoxRCNN R50-FPN", card=info["nvidia_smi"],
          **runs["loop"])
    for kind in ("centermap", "maskobb"):
        phase(f"{kind}_reference", **run_mask_reference(kind=kind))
    runs["centermap_predict"] = run_centermap_predict()
    phase("centermap_predict", model="CenterMap-Net R101-FPN",
          card=info["nvidia_smi"], **runs["centermap_predict"])
    runs["centermap_train"] = run_centermap_train()
    phase("centermap_train", model="CenterMap-Net R101-FPN",
          card=info["nvidia_smi"], **runs["centermap_train"])
    for kind, title in (("retinanet_obb", "RetinaNetOBB"),
                        ("h_obb", "H-OBB RBBoxRCNN")):
        phase(f"{kind}_reference", model=f"small {title} float32",
              **run_detector_reference(kind=kind))
        paths = run_detector_paths(kind=kind)
        runs[f"{kind}_predict"] = paths["predict"]
        runs[f"{kind}_train"] = paths["train"]
        phase(kind, model=f"{title} R50-FPN", card=info["nvidia_smi"],
              **paths)
    runs.update(run_slice12(info["nvidia_smi"], runs["loop"]["ms_per_step"]))
    runs.update(run_slice13(info["nvidia_smi"]))
    runs.update(run_slice14(info["nvidia_smi"]))
    slice15 = run_slice15(info["nvidia_smi"])
    # the dense detectors launch no kernel: the kernels line counts the
    # dcn R-CNNs' paths
    runs.update({k: v for k, v in slice15.items()
                 if k.split("_")[0] in ("dcn", "mdconv")})
    runs.update(run_slice16(info["nvidia_smi"]))
    ddp = run_ddp()
    runs["ddp_train"] = ddp.pop("train_path")
    runs["ddp_test"] = ddp.pop("test_path")
    phase("ddp", model="flagship R50-FPN; loop config R50-FPN",
          card=info["nvidia_smi"], **ddp)
    runs.update(run_slice18(info["nvidia_smi"]))
    phase("wall", script_s=time.perf_counter() - T0)
    emit({"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=runs[path]["launches"][name],
        launches_by_path={p: r["launches"][name] for p, r in runs.items()
                          if "launches" in r},
        **measured[name])
        for name, source, replaces, path in KERNELS]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:
        sys.exit(ddp_rank_main(sys.argv[2:]))
    sys.exit(main())
