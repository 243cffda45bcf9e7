#!/usr/bin/env python3
"""Run the PyTorch port's flagship predict and train paths and the
RBBoxRCNNRRoI predict and train paths on one CUDA card.

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
   bytes), K3 at
   the RRoI predict's horizontal crops (2000 rois per image, 7x7) and
   K4 at its rotated crops (100 rotated rois per image, 7x7, without
   and with the TPU kernel's window bump), both in bfloat16 and
   float32, and K4's backward at the RRoI train step's (128 rotated
   rois per image, 7x7, bfloat16 and float32, held and reported as K2's
   backward).
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
10. rroi_predict_bandx: one more call under AIDET_ROI_BAND=x: K3 once,
   K1 never, K4 once, its detections paired with the last K1 call's.
11. rroi_reference_train: one train step of the small RBBoxRCNNRRoI
   (float32) on the card against the CPU, as reference_train: its 8
   losses, grad_norm and the parameters' updates.
12. rroi_train: the full-width RBBoxRCNNRRoI's train step (float32
   parameters, bfloat16 compute, the config's train_cfg), batch 2 of
   1024^2 with 64 pointobb gts, 1 warm-up and 3 timed steps, with the
   launch counts (K2's forward and backward and K4's forward and
   backward, once each per step) and the last backwards' tile lists.

Then one ``{"kernels": [...]}`` line, nvidia-smi's name and power limit
line, and last ``{"ok": true, "device": {...}}``.  A failure anywhere
prints its traceback and exits non-zero without those lines.  The
script imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import json
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
    from aidet_tpu_torch.cuda_build import (REPO_ROOT, build_shared_library,
                                            ptxas_report)
    t0 = time.perf_counter()
    handles = [handle(name) for name in HANDLES]
    sources = sorted({h.source for h in handles})
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        builds = list(pool.map(build_shared_library, sources))
    by_source = dict(zip(sources, builds))
    for h in handles:
        h.load(by_source[h.source])
    phase("build", wall_s=time.perf_counter() - t0, libraries=[dict(
        source=str(src.relative_to(REPO_ROOT)),
        library=str(b.path.relative_to(REPO_ROOT)), nvcc_s=b.seconds,
        ptxas=ptxas_report(b.log)) for src, b in zip(sources, builds)])


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


def main_path_inputs(gen, shape, dtype, device):
    """Seeded levels [B, img/s, img/s, C] and proposal-like rois of one
    path's ``shape`` (MAIN or TRAIN), with their routing."""
    import torch
    from aidet_tpu_torch.ops.roi_align import route_rois
    b, r, img, c = (shape[k] for k in ("batch", "rois", "img", "channels"))
    strides = MAIN["strides"]
    feats = [torch.randn(b, img // s, img // s, c, generator=gen)
             .to(device=device, dtype=dtype) for s in strides]
    rois_b = main_path_rois(gen, b, r, img).to(device)
    rois = rois_b.reshape(b * r, 4).contiguous()
    lvls = route_rois(rois, [f.shape[1:3] for f in feats], strides)
    bidx = torch.arange(b, dtype=torch.int32,
                        device=device).repeat_interleave(r)
    return feats, rois_b, rois, lvls, bidx


def run_forward_kernel(kernel, name, shape, sizes, device="cuda"):
    """A RoIAlign forward handle (K1, or K2's forward) against the
    plain version at ``shape`` for each out_size in ``sizes``, bfloat16;
    returns the fields of its entry in the kernels line (the first
    size's), with its share of the bound (bound_ms / ms)."""
    import torch
    from aidet_tpu_torch.ops.roi_align import batched_multilevel_roi_align
    strides = MAIN["strides"]
    feats, rois_b, rois, lvls, bidx = main_path_inputs(
        torch.Generator().manual_seed(0), shape, torch.bfloat16, device)
    result = None
    for s in sizes:
        out = torch.empty((rois.shape[0], s, s, shape["channels"]),
                          dtype=torch.bfloat16, device=device)

        def launch():
            kernel(feats, rois, bidx, lvls, out, strides, 2, True)

        def plain():
            return batched_multilevel_roi_align(feats, rois_b, s, strides)

        launch()
        ref = plain()
        torch.cuda.synchronize()
        err = (out.reshape(ref.shape).float() - ref.float()).abs().max()
        err = float(err)
        if not math.isfinite(err) or err > ATOL_BF16:
            raise AssertionError(f"{name} s={s}: max abs err {err} > "
                                 f"{ATOL_BF16} against the plain version")
        bound_ms, bound_by = roi_align_bound(feats, rois, lvls, bidx, out,
                                             strides)
        fields = dict(max_abs_err=err, **kernel_times(launch, 50, 5),
                      plain_ms=cuda_ms(plain, 5, 1), bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None)
        fields["bound_share"] = bound_ms / fields["ms"]
        phase("kernels", kernel=name, out_size=s, rois=rois.shape[0],
              dtype="bfloat16", atol=ATOL_BF16, **fields)
        result = result or fields
    return result


def run_backward_kernel(device="cuda", rotated=False):
    """K2's backward (K4's if ``rotated``) against the autograd gradient
    of the plain version at the train step's shapes (7x7: 2 x 512 rois,
    or 2 x 128 rotated rois), in bfloat16 and in float32, launched twice
    and both launches held to the limits; returns the bfloat16 fields of
    its entry in the kernels line."""
    import torch
    from aidet_tpu_torch.ops import roi_align, rroi_align
    strides = MAIN["strides"]
    s = 7
    kernel = (rroi_align.rroi_align_backward_kernel if rotated
              else roi_align.roi_align_backward_kernel)
    plain_fn = (rroi_align.batched_rroi_align if rotated
                else roi_align.batched_multilevel_roi_align)
    label = "K4 backward" if rotated else "K2 backward"
    result = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        gen = torch.Generator().manual_seed(1)
        if rotated:
            feats, rois_b, rois, lvls, bidx = rroi_train_inputs(gen, dtype,
                                                                device)
        else:
            feats, rois_b, rois, lvls, bidx = main_path_inputs(
                gen, TRAIN, dtype, device)
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
              rois=rois.shape[0], dtype=name, max_abs_err_per_level=errs,
              limit_per_level=limits, rel_tol=BWD_REL_TOL[name],
              rerun_max_abs_diff=rerun_err, lists=lists, **fields)
        result = result or fields
    return result


def run_bandx_kernel(device="cuda"):
    """K3 against its plain version at the RRoI predict's horizontal
    crops (2 x 2000 rois, 7x7), bfloat16 then float32; returns the
    bfloat16 fields of its entry in the kernels line."""
    import torch
    from aidet_tpu_torch.ops.roi_align import (BAND_H, bandx_chunks,
                                               roi_align_bandx_kernel,
                                               roi_align_bandx_plain)
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

        def chunk():
            return bandx_chunks(rois, bidx, lvls, level_hw, strides,
                                RROI["batch"], s)

        chunks = chunk()

        def launch():
            roi_align_bandx_kernel(feats, rois, bidx, lvls, chunks, out,
                                   strides, 2, True)

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
        used = chunks.count > 0
        first = chunks.perm[chunks.start[used]]
        lv = lvls[first].long()
        hs = torch.tensor([h for h, _ in level_hw], device=device)[lv]
        ws = torch.tensor([w for _, w in level_hw], device=device)[lv]
        stage_w = min(max(w for _, w in level_hw),
                      roi_align_bandx_kernel.STAGE_BYTES // (BAND_H * 16))
        staged = float(((hs - chunks.row0[used]).clamp(max=BAND_H)
                        * ws.clamp(max=stage_w)).sum()) \
            * RROI["channels"] * out.element_size()
        bound_ms, bound_by = roi_align_bound(feats, rois, lvls, bidx, out,
                                             strides)
        fields = dict(max_abs_err=err, **kernel_times(launch, 20, 3),
                      plain_ms=cuda_ms(plain, 3, 1), bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None)
        fields["bound_share"] = bound_ms / fields["ms"]
        phase("kernels", kernel="roi_align_bandx", out_size=s,
              rois=rois.shape[0], dtype=name, atol=atol,
              chunks=int(used.sum()), chunk_bound=chunks.start.shape[0],
              staged_bytes=staged,
              staged_ms=staged / HBM_BYTES_PER_S * 1e3,
              chunking_ms=cuda_ms(chunk, 5, 1), **fields)
        result = result or fields
    return result


def rroi_path_inputs(gen, dtype, device):
    """Seeded levels as the RRoI predict's and 2 x 100 rotated rois
    drawn like its detections: centres inside the image, sides
    log-uniform over 8..512 px, thetas in [-pi/2, 0)."""
    import torch
    b, n, img, c = (RROI[k] for k in ("batch", "rrois", "img", "channels"))
    feats = [torch.randn(b, img // s, img // s, c, generator=gen)
             .to(device=device, dtype=dtype) for s in MAIN["strides"]]
    u = torch.rand(b, n, 5, generator=gen)
    rrois_b = torch.stack([u[..., 0] * img, u[..., 1] * img,
                           8.0 * 64.0 ** u[..., 2], 8.0 * 64.0 ** u[..., 3],
                           -math.pi / 2 * u[..., 4]], -1).to(device)
    return feats, rrois_b


def rroi_train_inputs(gen, dtype, device, batch=None):
    """Seeded levels as the RRoI train step's and 2 x 128 rotated rois
    (``batch`` x 128 where given)
    drawn like its stage-1 boxes under random weights: centres inside
    the image, sides log-uniform over 2..1024 px (the clip the loss
    applies; a 1024-px side spans all 32 cells of level 3), any theta
    in [-pi, pi); with their routing (no window bump, as the path)."""
    import torch
    from aidet_tpu_torch.ops.rroi_align import route_rrois
    b, n, img, c = (RTRAIN[k] for k in ("batch", "rrois", "img",
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


def run_rroi_kernel(device="cuda"):
    """K4 against its plain version at the RRoI predict's rotated crops
    (2 x 100 rrois, 7x7), routed without and with the TPU kernel's
    window bump, bfloat16 then float32; returns the fields of its
    entry in the kernels line (bfloat16, no bump: the path's)."""
    import torch
    from aidet_tpu_torch.ops.rroi_align import (batched_rroi_align,
                                                route_rrois,
                                                rroi_align_kernel,
                                                sample_coords)
    strides = MAIN["strides"]
    s = 7
    result = None
    for dtype, atol in ((torch.bfloat16, ATOL_BF16), (torch.float32,
                                                      ATOL_F32)):
        name = str(dtype).split(".")[-1]
        feats, rrois_b = rroi_path_inputs(torch.Generator().manual_seed(3),
                                          dtype, device)
        b, r = rrois_b.shape[:2]
        rrois = rrois_b.reshape(b * r, 5).contiguous()
        bidx = torch.arange(b, dtype=torch.int32,
                            device=device).repeat_interleave(r)
        for bump in (False, True):
            lvls = route_rrois(rrois, [f.shape[1:3] for f in feats],
                               strides, bump_to_window=bump)
            out = torch.empty((b * r, s, s, RROI["channels"]), dtype=dtype,
                              device=device)

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
                  dtype=name, bump_to_window=bump, atol=atol, **fields)
            result = result or fields
    return result


def run_kernels():
    """Every kernel of the paths against its plain version; returns the
    fields of each one's entry in the kernels line, by name."""
    from aidet_tpu_torch.ops.roi_align import (roi_align_kernel,
                                               roi_align_train_kernel)
    # K1 at the RRoI predict's 2 x 2000 proposals too (a phase line)
    run_forward_kernel(roi_align_kernel, "roi_align", RROI, (7,))
    return dict(
        roi_align=run_forward_kernel(roi_align_kernel, "roi_align", MAIN,
                                     (7, 14)),
        roi_align_train_forward=run_forward_kernel(
            roi_align_train_kernel, "roi_align_train_forward", TRAIN, (7,)),
        roi_align_backward=run_backward_kernel(),
        roi_align_bandx=run_bandx_kernel(),
        rroi_align=run_rroi_kernel(),
        rroi_align_backward=run_backward_kernel(rotated=True))


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
    grows by that share of the rbox's largest coordinate); raise if the
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
                                 - ref["boxes"][b, j]).abs().max()),
                    rboxes=float((got["rboxes"][b, i, :4]
                                  - ref["rboxes"][b, j, :4]).abs().max()),
                    theta=abs(float(got["rboxes"][b, i, 4]
                                    - ref["rboxes"][b, j, 4])))
                lim = dict(limits, rboxes=limits["rboxes"] + rel * float(
                    ref["rboxes"][b, j, :4].abs().max()))
                if rbox_clear is not None and not bool(rbox_clear[b, j]):
                    d.update(rboxes=0.0, theta=0.0)
                if near is None or d["boxes"] < near["boxes"]:
                    near = dict(d, rbox_limit=lim["rboxes"])
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
    if launches != want:
        raise AssertionError(f"rroi_predict: launches {launches} in "
                             f"{calls} calls, expected {want}")
    steady = times[1:] or times
    ms = sum(steady) / len(steady)
    fields = dict(img=img, batch=batch, calls=calls, roi_band=band,
                  dtype=str(next(model.parameters()).dtype),
                  first_call_ms=times[0], call_ms=times, ms_per_call=ms,
                  images_per_s=batch * 1e3 / ms, launches=launches,
                  n_valid=int(out["valid"].sum()))
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


def compare_steps(name, got, ref, limits=None):
    """Two train steps from the same weights (each `train_step_once`'s
    (metrics, before, after)): each metric's relative difference, the
    difference of the parameters' updates as a whole (relative L2 norm)
    and per leaf (over the leaf's largest update), held to ``limits``
    (losses_rel, update_rel_l2, leaf_over_largest) if given.  Returns
    them."""
    import torch
    rel = {k: abs(got[0][k] - ref[0][k]) / max(abs(ref[0][k]), 1e-6)
           for k in ref[0]}
    if limits and not all(math.isfinite(got[0][k])
                          and rel[k] <= limits["losses_rel"]
                          for k in ref[0]):
        raise AssertionError(f"{name}: {got[0]} against {ref[0]} "
                             f"(relative {rel})")
    worst, diff2, ref2 = (0.0, 0), 0.0, 0.0
    for i, (gb, ga, rb, ra) in enumerate(zip(*got[1:], *ref[1:])):
        if not torch.equal(gb, rb):
            raise AssertionError(f"{name}: initial weights differ")
        d_ref = ra - rb
        d = (ga - gb) - d_ref
        diff2 += float(d.double().square().sum())
        ref2 += float(d_ref.double().square().sum())
        err = float(d.abs().max()) / max(float(d_ref.abs().max()), 1e-30)
        worst = max(worst, (err, i))
    update_rel = math.sqrt(diff2 / ref2)
    if limits and (update_rel > limits["update_rel_l2"]
                   or worst[0] > limits["leaf_over_largest"]):
        raise AssertionError(f"{name}: the update differs by "
                             f"{update_rel} (relative L2), {worst[0]} of "
                             f"the largest in leaf {worst[1]} (limits "
                             f"{limits})")
    return dict(max_rel_err=max(rel.values()), update_rel_l2=update_rel,
                worst_leaf=worst[1], worst_leaf_err_over_largest=worst[0],
                limits=limits)


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
        two_stage.roi_align_forward = roi_align.batched_multilevel_roi_align
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
    emit({"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=runs[path]["launches"][name], **measured[name])
        for name, source, replaces, path in KERNELS]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
