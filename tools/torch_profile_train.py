#!/usr/bin/env python3
"""Where the time of the PyTorch port's train step goes, on one CUDA
card: the flagship's, or the RBBoxRCNNRRoI's.

    python tools/torch_profile_train.py [--model flagship|rroi]
        [--batch 2] [--steps 3]

For each batch size: the full-width model's training build
(`build_flagship(1024, train=True)`, or `build_rroi(1024, train=True)`:
ResNet-50 FPN, float32 parameters, bfloat16 compute, the reference's
train_cfg), the reference's optimizer (SGD, momentum 0.9, weight decay
1e-4, clip 35, warmup), on the seeded synthetic batch of
`synthetic_train_batch` (1024^2, 64 gts per image: thetaobbs, or
pointobbs for the RRoI model);
one warm-up step, then ``--steps`` steps timed with the host clock
around `torch.cuda.synchronize()`, then the same steps under
`torch.profiler` (CPU and CUDA activity).  Prints one JSON line per
batch size, as tools/torch_profile_predict.py does for predict:
ms_per_step, images_per_s, device_ms_per_step and device_busy_share,
the spans of `TwoStageDetector.loss` and of the step (backbone, neck,
rpn_head, rpn_loss, rpn_proposals, rcnn_sample, roi_align, roi_heads,
rroi_refine and its rroi_align, backward, optimizer) with host ms and
device extent per step, the top kernels, K2's and K4's launches per
step, and peak memory; port_kernels, the port's RoIAlign device kernels
by name with their ms and count per step on the path,
k2_device_ms_per_step: K2's forward (`roi_align_kernel`) and backward
(its zero, count, place, fill and accumulate kernels,
`roi_align_bwd_*`) summed, and k4_device_ms_per_step: K4's forward
(`rroi_align_kernel`) and backward (`rroi_align_bwd_*`) summed (zeros
for the flagship).

Needs a CUDA card; imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from torch_profile_predict import card_line, summarize  # noqa: E402

SPANS = ("backbone", "neck", "rpn_head", "rpn_loss", "rpn_proposals",
         "rcnn_sample", "roi_align", "roi_heads", "rroi_refine", "rroi_align",
         "backward", "optimizer")


def profile(batch, steps, model_name="flagship"):
    import torch
    from torch.profiler import ProfilerActivity
    from aidet_tpu_torch.flagship import build_flagship, synthetic_train_batch
    from aidet_tpu_torch.ops import roi_align as ra
    from aidet_tpu_torch.ops import rroi_align as rra
    from aidet_tpu_torch.parallel.train import (build_lr_schedule,
                                                build_optimizer,
                                                create_train_state,
                                                make_train_step)
    from aidet_tpu_torch.rroi import build_rroi

    if model_name == "rroi":
        model, encode = build_rroi(1024, train=True, seed=0), "pointobb"
    else:
        model, encode = build_flagship(1024, train=True, seed=0), "thetaobb"
    optimizer = build_optimizer(build_lr_schedule(base_lr=0.02))
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer)
    data = synthetic_train_batch(batch, 1024, 64, 0, "cuda", encode)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, data, gen)                # warm-up
    torch.cuda.synchronize()
    handles = dict(k2_forward=ra.roi_align_train_kernel,
                   k2_backward=ra.roi_align_backward_kernel,
                   k4_forward=rra.rroi_align_kernel,
                   k4_backward=rra.rroi_align_backward_kernel)
    for h in handles.values():
        h.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, data, gen)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = {k: h.launches / steps for k, h in handles.items()}

    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step(state, data, gen)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    out = dict(model=model_name, batch=batch, steps=steps,
               ms_per_step=wall_ms, images_per_s=batch * 1e3 / wall_ms,
               launches_per_step=launches,
               loss=float(metrics["loss"]),
               **summarize(prof, SPANS, steps, prof_wall_ms),
               max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    out["device_ms_per_step"] = out.pop("device_ms_per_call")
    out["profiled_ms_per_step"] = out.pop("profiled_ms_per_call")
    for key, prefix in (("k2_device_ms_per_step", "::roi_align_"),
                        ("k4_device_ms_per_step", "::rroi_align_")):
        out[key] = {
            part: sum(v["ms"] for name, v in out["port_kernels"].items()
                      if prefix + tag in name)
            for part, tag in (("forward", "kernel"), ("backward", "bwd_"))}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("flagship", "rroi"),
                    default="flagship")
    ap.add_argument("--batch", type=int, nargs="+", default=[2])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = card_line()
    for b in args.batch:
        print(json.dumps(dict(card=card, **profile(b, args.steps,
                                                     args.model))),
              flush=True)


if __name__ == "__main__":
    main()
