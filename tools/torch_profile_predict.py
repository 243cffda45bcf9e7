#!/usr/bin/env python3
"""Where the time of the PyTorch port's flagship predict goes, on one
CUDA card.

    python tools/torch_profile_predict.py [--batch 2 16] [--calls 5]

For each batch size: the full-width flagship (`build_flagship(1024)`,
ResNet-50 FPN, bf16, seeded random weights) on seeded random uint8
1024^2 images; one warm-up call, then ``--calls`` calls timed with the
host clock around `torch.cuda.synchronize()`, then the same calls under
`torch.profiler` (CPU and CUDA activity).  Prints one JSON line per
batch size:

- ms_per_call and images_per_s (host clock, profiler off);
- device_ms_per_call: the summed time of all device kernels, memsets
  and copies per call, and device_busy_share = device_ms / wall ms of
  the profiled calls;
- spans: per stage of `TwoStageDetector.predict` (its record_function
  spans), host ms per call and the span's extent on the device
  timeline per call;
- top_kernels: the 12 device kernels with the most time per call.

Needs a CUDA card; imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SPANS = ("backbone", "neck", "rpn_head", "rpn_proposals", "roi_align",
         "bbox_head", "bbox_decode_nms", "rbbox_head")


def _dev_time(avg, self_only):
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for n in names:
        if hasattr(avg, n):
            return float(getattr(avg, n))
    return 0.0


def profile(batch, calls):
    import torch
    from torch.profiler import ProfilerActivity
    from aidet_tpu_torch.flagship import build_flagship
    from aidet_tpu_torch.ops.roi_align import roi_align_kernel

    model = build_flagship(1024, seed=0)
    imgs = torch.randint(0, 256, (batch, 1024, 1024, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0)).cuda()
    shapes = torch.full((batch, 2), 1024.0, device="cuda")
    model.predict(imgs, shapes)                      # warm-up
    torch.cuda.synchronize()
    roi_align_kernel.launches = 0
    t0 = time.perf_counter()
    for _ in range(calls):
        model.predict(imgs, shapes)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    launches = roi_align_kernel.launches

    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            model.predict(imgs, shapes)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / calls

    return dict(
        batch=batch, calls=calls, ms_per_call=wall_ms,
        images_per_s=batch * 1e3 / wall_ms, roi_align_launches=launches,
        **summarize(prof, SPANS, calls, prof_wall_ms),
        max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def summarize(prof, span_names, calls, prof_wall_ms):
    """Per call: the device's busy ms and share, each span's host ms and
    device extent, and the 12 kernels with the most device time."""
    # key_averages holds, per name, a host row (device_type CPU) and for
    # device work a device row; a record_function span has both: its
    # host time and its extent on the device timeline (first kernel
    # start to last kernel end, idle gaps included)
    kernels, spans = [], {k: {} for k in span_names}
    for a in prof.key_averages():
        on_device = str(getattr(a, "device_type", "")).endswith("CUDA")
        if a.key in spans:
            if on_device:
                spans[a.key]["device_extent_ms"] = (
                    _dev_time(a, True) / 1e3 / calls)
            else:
                spans[a.key]["host_ms"] = a.cpu_time_total / 1e3 / calls
        elif on_device:
            kernels.append(a)
    device_ms = sum(_dev_time(a, True) for a in kernels) / 1e3 / calls
    top = sorted(kernels, key=lambda a: -_dev_time(a, True))[:12]
    return dict(
        profiled_ms_per_call=prof_wall_ms, device_ms_per_call=device_ms,
        device_busy_share=device_ms / prof_wall_ms, spans=spans,
        top_kernels=[dict(name=a.key[:90], ms=_dev_time(a, True) / 1e3
                          / calls, count=a.count // calls) for a in top])


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[2, 16])
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = card_line()
    for b in args.batch:
        print(json.dumps(dict(card=card, **profile(b, args.calls))),
              flush=True)


if __name__ == "__main__":
    main()
