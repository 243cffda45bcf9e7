#!/usr/bin/env python3
"""Time the port's RoIAlign kernels against those of another checkout,
in turns, on one CUDA card.

    python tools/torch_kernel_ab.py --parent DIR [--rounds 2]
        [--only rroi|bandx]

DIR is the root of another tree of this repository (an unpacked
``git archive`` of an earlier commit).  Both trees' K1 (the RoIAlign
forward, `aidet_tpu_torch/csrc/roi_align.cu`, also K2's forward), K2's
backward (`csrc/roi_align_backward.cu`), K4's forward (the rotated
RoIAlign, `csrc/rroi_align.cu`) and K4's backward
(`csrc/rroi_align_backward.cu`) are built with nvcc, eight nvcc
processes at once, each into its tree's build directory, and called
through each tree's own wrapper on the same seeded inputs as
`chip_smoke.py`'s kernels phase:

- K1 at the flagship predict's 2 x 1000 rois, 7x7 and 14x14, and at
  the RRoI predict's 2 x 2000 rois, 7x7 (bfloat16);
- K2's forward at the train step's 2 x 512 rois, 7x7 (bfloat16);
- K2's backward there, in bfloat16 and float32;
- K4's forward at the RRoI predict's 2 x 100 rotated rois and the RRoI
  train step's 2 x 128, 7x7 (bfloat16 and float32);
- K4's backward at the RRoI train step's 2 x 128 rotated rois, 7x7,
  and at the training batch of `bench.py`, 8 x 128 (bfloat16 and
  float32);
- K3 (`csrc/roi_align_bandx.cu`) at the RRoI predict's 2 x 2000 rois,
  7x7 (bfloat16 and float32): what the path launches, the rois'
  chunking and the reduction together (this tree's plan kernel, or an
  earlier tree's torch chunking `bandx_chunks`), and each part alone.

Each case checks both kernels against the plain version (the limits of
`chip_smoke.py`), then times them in the order parent, this tree, this
tree, parent, ``--rounds`` times, two ways: ``ms``, launched eagerly
between CUDA events (`chip_smoke.cuda_ms`, the kernels line's ``ms``:
the device's time, or the host's time to enqueue a launch where that
is longer; ``host_ms``, each tree's, measured once); and
``device_ms``, the device time alone, from CUDA events around replays
of a CUDA graph of the launches (`chip_smoke.capture`, `replay_ms`).
K3's device times are the sums of the device's kernel and copy times
per call under `torch.profiler` (``device_by``: "profiler"): an
earlier tree's chunking copies host lists to the card and cannot be
captured in a CUDA graph.  It prints one JSON line per case (K3: per
part): the times of each tree (ms per
launch, in order), their means and ratio (``speedup``, parent over
this tree), the bound and each tree's share of it (bound / mean time),
the same of the device times, and the errors.  The first line is
nvidia-smi's name and power limit.

Needs a CUDA card; imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def load_tree(root: Path, name: str):
    """The `ops.roi_align` and `ops.rroi_align` modules of the port in
    the tree ``root``, imported as package ``name`` (its kernels build
    under ``root``)."""
    init = root / "aidet_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return (importlib.import_module(f"{name}.ops.roi_align"),
            importlib.import_module(f"{name}.ops.rroi_align"))


def build(modules, rotated):
    """Build every tree's K1, K2 backward, K3, K4 forward and K4 backward
    library at once (each handle with its own tree's builder); returns
    (source, nvcc seconds) per library."""
    handles = [h for m in modules for h in (m.roi_align_kernel,
                                            m.roi_align_backward_kernel,
                                            m.roi_align_bandx_kernel)]
    handles += [h for m in rotated for h in (m.rroi_align_kernel,
                                             m.rroi_align_backward_kernel)]
    with ThreadPoolExecutor(max_workers=len(handles)) as pool:
        builds = list(pool.map(lambda h: h.load(), handles))
    return [(str(h.source), b.seconds) for h, b in zip(handles, builds)]


def in_turns(timers, rounds):
    """The readings of timers = (parent, tree), taken parent, tree,
    tree, parent, ``rounds`` times."""
    times = ([], [])
    for _ in range(rounds):
        for i in (0, 1, 1, 0):
            times[i].append(timers[i]())
    return times


def forward_case(mods, shape, s, rounds):
    import torch
    strides = cs.MAIN["strides"]
    feats, rois_b, rois, lvls, bidx = cs.main_path_inputs(
        torch.Generator().manual_seed(0), shape, torch.bfloat16, "cuda")
    ref = mods[0].batched_multilevel_roi_align(feats, rois_b, s, strides)
    outs, fns, errs = [], [], []
    for m in mods:
        out = torch.empty((rois.shape[0], s, s, shape["channels"]),
                          dtype=torch.bfloat16, device="cuda")

        def launch(m=m, out=out):
            m.roi_align_kernel(feats, rois, bidx, lvls, out, strides, 2, True)
        launch()
        torch.cuda.synchronize()
        errs.append(float((out.reshape(ref.shape).float() - ref.float())
                          .abs().max()))
        outs.append(out)
        fns.append(launch)
    if not all(math.isfinite(e) and e <= cs.ATOL_BF16 for e in errs):
        raise AssertionError(f"forward s={s}: errors {errs}")
    bound_ms, bound_by = cs.roi_align_bound(feats, rois, lvls, bidx,
                                            outs[1], strides)
    return dict(kernel="roi_align", rois=rois.shape[0], out_size=s,
                dtype="bfloat16", max_abs_err=errs, bound_ms=bound_ms,
                bound_by=bound_by, **timed(fns, rounds, 50, 5, bound_ms))


def backward_case(mods, dtype, rounds):
    import torch
    strides = cs.MAIN["strides"]
    gen = torch.Generator().manual_seed(1)
    feats, rois_b, rois, lvls, bidx = cs.main_path_inputs(
        gen, cs.TRAIN, dtype, "cuda")
    shapes = [tuple(f.shape) for f in feats]
    grad_out = torch.randn(rois.shape[0], 7, 7, cs.TRAIN["channels"],
                           generator=gen).to(device="cuda", dtype=dtype)
    leaves = [f.detach().requires_grad_() for f in feats]
    out = mods[0].batched_multilevel_roi_align(leaves, rois_b, 7, strides)
    ref = torch.autograd.grad(out, leaves, grad_out.reshape(out.shape))
    name = str(dtype).split(".")[-1]
    fns, errs = [], []
    for m in mods:
        def launch(m=m):
            return m.roi_align_backward_kernel(grad_out, rois, bidx, lvls,
                                               shapes, strides, 2, True)
        got = launch()
        torch.cuda.synchronize()
        worst = 0.0
        for g, r in zip(got, ref):
            err = float((g.float() - r.float()).abs().max())
            lim = cs.BWD_REL_TOL[name] * float(r.float().abs().max())
            if not (math.isfinite(err) and err <= lim):
                raise AssertionError(f"backward {name}: {err} > {lim}")
            worst = max(worst, err)
        errs.append(worst)
        fns.append(launch)
    bound_ms, bound_by = cs.roi_align_backward_bound(feats, rois, lvls, bidx,
                                                     grad_out, strides)
    return dict(kernel="roi_align_backward", rois=rois.shape[0], out_size=7,
                dtype=name, max_abs_err=errs, bound_ms=bound_ms,
                bound_by=bound_by, **timed(fns, rounds, 20, 3, bound_ms))


def rroi_forward_case(mods, dtype, train, rounds):
    """K4's forward of both trees at the RRoI train step's rotated
    crops (``train``) or the RRoI predict's, routed as the path routes
    them (no window bump)."""
    import torch
    strides = cs.MAIN["strides"]
    gen = torch.Generator().manual_seed(3)
    if train:
        feats, rrois_b, rrois, lvls, bidx = cs.rroi_train_inputs(
            gen, dtype, "cuda")
    else:
        feats, rrois_b = cs.rroi_path_inputs(gen, dtype, "cuda")
        b, r = rrois_b.shape[:2]
        rrois = rrois_b.reshape(b * r, 5).contiguous()
        lvls = mods[1].route_rrois(rrois, [f.shape[1:3] for f in feats],
                                   strides)
        bidx = torch.arange(b, dtype=torch.int32,
                            device="cuda").repeat_interleave(r)
    ref = mods[1].batched_rroi_align(feats, rrois_b, 7, strides)
    atol = cs.ATOL_BF16 if dtype == torch.bfloat16 else cs.ATOL_F32
    outs, fns, errs = [], [], []
    for m in mods:
        out = torch.empty((rrois.shape[0], 7, 7, feats[0].shape[-1]),
                          dtype=dtype, device="cuda")

        def launch(m=m, out=out):
            m.rroi_align_kernel(feats, rrois, bidx, lvls, out, strides, 2,
                                True)
        launch()
        torch.cuda.synchronize()
        errs.append(float((out.reshape(ref.shape).float() - ref.float())
                          .abs().max()))
        outs.append(out)
        fns.append(launch)
    name = str(dtype).split(".")[-1]
    if not all(math.isfinite(e) and e <= atol for e in errs):
        raise AssertionError(f"rroi_align {name}: errors {errs}")
    coords = mods[1].sample_coords(rrois, lvls, strides, 7)
    bound_ms, bound_by = cs.gather_bound(feats, coords, rrois, lvls, bidx,
                                         outs[1])
    return dict(kernel="rroi_align", path="rroi_train" if train
                else "rroi_predict", rrois=rrois.shape[0], out_size=7,
                dtype=name, max_abs_err=errs, bound_ms=bound_ms,
                bound_by=bound_by, **timed(fns, rounds, 50, 5, bound_ms))


def timed(fns, rounds, iters, warmup, bound_ms):
    """Eager times and device times (graph replays) of fns = (parent
    launch, tree launch) in turns, and each one's host time."""
    parent, tree = in_turns([lambda fn=fn: cs.cuda_ms(fn, iters, warmup)
                             for fn in fns], rounds)
    graphs = [cs.capture(fn, iters, warmup) for fn in fns]
    d_parent, d_tree = in_turns([lambda g=g: cs.replay_ms(g, iters)
                                 for g in graphs], rounds)
    del graphs
    mean = [sum(t) / len(t) for t in (parent, tree)]
    d_mean = [sum(t) / len(t) for t in (d_parent, d_tree)]
    return dict(parent_ms=parent, ms=tree, parent_mean_ms=mean[0],
                mean_ms=mean[1], speedup=mean[0] / mean[1],
                parent_bound_share=bound_ms / mean[0],
                bound_share=bound_ms / mean[1], parent_device_ms=d_parent,
                device_ms=d_tree, parent_device_mean_ms=d_mean[0],
                device_mean_ms=d_mean[1],
                device_speedup=d_mean[0] / d_mean[1],
                parent_device_bound_share=bound_ms / d_mean[0],
                device_bound_share=bound_ms / d_mean[1],
                host_ms=[cs.host_ms(fn, iters) for fn in fns])


def rroi_backward_case(mods, dtype, rounds, batch):
    """K4's backward of both trees at the RRoI train step's rotated rois
    (chip_smoke's inputs, ``batch`` x 128), against the plain
    gradient."""
    import torch
    strides = cs.MAIN["strides"]
    gen = torch.Generator().manual_seed(1)
    feats, rrois_b, rrois, lvls, bidx = cs.rroi_train_inputs(gen, dtype,
                                                             "cuda", batch)
    shapes = [tuple(f.shape) for f in feats]
    grad_out = torch.randn(rrois.shape[0], 7, 7, cs.RTRAIN["channels"],
                           generator=gen).to(device="cuda", dtype=dtype)
    leaves = [f.detach().requires_grad_() for f in feats]
    out = mods[1].batched_rroi_align(leaves, rrois_b, 7, strides)
    ref = torch.autograd.grad(out, leaves, grad_out.reshape(out.shape))
    name = str(dtype).split(".")[-1]
    fns, errs = [], []
    for m in mods:
        def launch(m=m):
            return m.rroi_align_backward_kernel(grad_out, rrois, bidx, lvls,
                                                shapes, strides, 2, True)
        got = launch()
        torch.cuda.synchronize()
        worst = 0.0
        for g, r in zip(got, ref):
            err = float((g.float() - r.float()).abs().max())
            lim = cs.BWD_REL_TOL[name] * float(r.float().abs().max())
            if not (math.isfinite(err) and err <= lim):
                raise AssertionError(f"rroi backward {name}: {err} > {lim}")
            worst = max(worst, err)
        errs.append(worst)
        fns.append(launch)
    bound_ms, bound_by = cs.roi_align_backward_bound(
        feats, rrois, lvls, bidx, grad_out, strides,
        coords_fn=mods[1].sample_coords)
    return dict(kernel="rroi_align_backward", batch=batch,
                rois=rrois.shape[0], out_size=7, dtype=name,
                max_abs_err=errs, bound_ms=bound_ms, bound_by=bound_by,
                **timed(fns, rounds, 20, 3, bound_ms))


def profiled_ms(fn, iters, warmup):
    """ms per call of ``fn`` on the device: the summed time of the
    device's kernels and copies under `torch.profiler`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch_profile_predict import _dev_time
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(_dev_time(a, True) for a in prof.key_averages()
               if str(getattr(a, "device_type", "")).endswith("CUDA")) \
        / 1e3 / iters


def bandx_case(mods, dtype, rounds):
    """K3 of both trees at the RRoI predict's 2 x 2000 rois (chip_smoke's
    inputs), against the plain K1 version: the parent's torch chunking
    and kernel, or this tree's plan and reduction; together (what the
    path launches) and each part alone.  One JSON line per part."""
    import torch
    strides = cs.MAIN["strides"]
    b = cs.RROI["batch"]
    feats, rois_b, rois, lvls, bidx = cs.main_path_inputs(
        torch.Generator().manual_seed(2), cs.RROI, dtype, "cuda")
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    ref = mods[1].batched_multilevel_roi_align(feats, rois_b, 7, strides)
    atol = cs.ATOL_BF16 if dtype == torch.bfloat16 else cs.ATOL_F32
    parts = {"plan+reduce": [], "plan": [], "reduce": []}
    outs, errs = [], []
    for i, m in enumerate(mods):
        k3 = m.roi_align_bandx_kernel
        out = torch.empty((rois.shape[0], 7, 7, feats[0].shape[-1]),
                          dtype=dtype, device="cuda")
        if i == 0:   # the parent: torch chunking, then the kernel
            def plan(m=m):
                return m.bandx_chunks(rois, bidx, lvls, level_hw, strides,
                                      b, 7)
        else:
            def plan(k3=k3):
                return k3.plan(rois, bidx, lvls, level_hw, strides, b, 7)
        planned = plan()

        def reduce(k3=k3, planned=planned, out=out):
            k3(feats, rois, bidx, lvls, planned, out, strides, 2, True)

        def both(k3=k3, plan=plan, out=out):
            k3(feats, rois, bidx, lvls, plan(), out, strides, 2, True)
        both()
        torch.cuda.synchronize()
        errs.append(float((out.reshape(ref.shape).float() - ref.float())
                          .abs().max()))
        outs.append(out)
        for part, fn in zip(parts, (both, plan, reduce)):
            parts[part].append(fn)
    name = str(dtype).split(".")[-1]
    if not all(math.isfinite(e) and e <= atol for e in errs):
        raise AssertionError(f"roi_align_bandx {name}: errors {errs}")
    bound_ms, bound_by = cs.roi_align_bound(feats, rois, lvls, bidx,
                                            outs[1], strides)
    lines = []
    for part, fns in parts.items():
        eager = in_turns([lambda fn=fn: cs.cuda_ms(fn, 20, 3)
                          for fn in fns], rounds)
        device = in_turns([lambda fn=fn: profiled_ms(fn, 20, 3)
                           for fn in fns], rounds)
        mean = [sum(t) / len(t) for t in eager]
        d_mean = [sum(t) / len(t) for t in device]
        lines.append(dict(
            kernel="roi_align_bandx", part=part, rois=rois.shape[0],
            out_size=7, dtype=name, max_abs_err=errs, bound_ms=bound_ms,
            bound_by=bound_by, parent_ms=eager[0], ms=eager[1],
            parent_mean_ms=mean[0], mean_ms=mean[1],
            speedup=mean[0] / mean[1], parent_bound_share=bound_ms / mean[0],
            bound_share=bound_ms / mean[1], device_by="profiler",
            parent_device_ms=device[0], device_ms=device[1],
            parent_device_mean_ms=d_mean[0], device_mean_ms=d_mean[1],
            device_speedup=d_mean[0] / d_mean[1],
            parent_device_bound_share=bound_ms / d_mean[0],
            device_bound_share=bound_ms / d_mean[1],
            host_ms=[cs.host_ms(fn, 20) for fn in fns]))
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", choices=("rroi", "bandx"),
                    help="time only K4's forward and backward, or K3")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(cs.nvidia_smi_line(), flush=True)
    trees = [load_tree(args.parent.resolve(), "aidet_tpu_torch_parent"),
             tuple(importlib.import_module(f"aidet_tpu_torch.ops.{m}")
                   for m in ("roi_align", "rroi_align"))]
    mods, rotated = zip(*trees)
    print(json.dumps(dict(build=build(mods, rotated))), flush=True)
    cases = [lambda: forward_case(mods, cs.MAIN, 7, args.rounds),
             lambda: forward_case(mods, cs.MAIN, 14, args.rounds),
             lambda: forward_case(mods, cs.RROI, 7, args.rounds),
             lambda: dict(forward_case(mods, cs.TRAIN, 7, args.rounds),
                          kernel="roi_align_train_forward"),
             lambda: backward_case(mods, torch.bfloat16, args.rounds),
             lambda: backward_case(mods, torch.float32, args.rounds)]
    if args.only:
        cases = []
    if args.only != "bandx":
        cases += [lambda dtype=dtype, train=train: rroi_forward_case(
                      rotated, dtype, train, args.rounds)
                  for train in (False, True)
                  for dtype in (torch.bfloat16, torch.float32)]
        cases += [lambda dtype=dtype, batch=batch: rroi_backward_case(
                      rotated, dtype, args.rounds, batch)
                  for batch in (2, 8)
                  for dtype in (torch.bfloat16, torch.float32)]
    if args.only != "rroi":
        cases += [lambda dtype=dtype: bandx_case(mods, dtype, args.rounds)
                  for dtype in (torch.bfloat16, torch.float32)]
    for case in cases:
        lines = case()
        for line in lines if isinstance(lines, list) else [lines]:
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
