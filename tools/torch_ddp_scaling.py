"""Time the port's data-parallel train step over 1, 2 and 4 cards.

    python tools/torch_ddp_scaling.py [--procs 1 2 4] [--steps 5]
        [--per-rank 2] [--device cuda|cpu] [--small]

For each process count N it starts N processes of this script under
torchrun (one card each, NCCL; gloo with ``--device cpu``).  Each rank
builds the full flagship's training build (R50-FPN, 1024^2, bfloat16
compute, the train phase's train_cfg) from the same seed, takes its
``--per-rank`` images of a seeded global batch of N x per-rank (64 gts
an image) and runs chip_smoke's ddp phase's timed steps
(`chip_smoke.ddp_timed_steps`: 1 warm-up and ``--steps`` timed steps of
`parallel.train.make_train_step`, host clock around
``torch.cuda.synchronize``, then one step under torch.profiler for the
host ms of its ``allreduce`` span).  Rank 0 prints one JSON line per N:
ms per step (the slowest rank's mean), images/s over the global batch,
the span's ms, the all-reduce bucket's bytes, K2's launches per step,
and whether every rank ended with the same parameters; then the card's
name and power limit (nvidia-smi).  ``--small`` takes the small
flagship at 256^2 (a CPU rehearsal).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--procs", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--per-rank", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--rank-run", action="store_true",
                   help=argparse.SUPPRESS)
    return p.parse_args()


def rank_run(args) -> dict:
    """One rank's steps (under torchrun; `chip_smoke.ddp_timed_steps`);
    returns its numbers."""
    import torch
    import torch.distributed as dist

    import chip_smoke
    from aidet_tpu_torch.flagship import build_flagship, synthetic_train_batch
    from aidet_tpu_torch.parallel.dist import init_distributed
    from aidet_tpu_torch.parallel.mesh import (create_mesh, replicate,
                                               shard_batch)
    rank, world = init_distributed(device=args.device)
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device != "cpu" else torch.device("cpu"))
    img, max_gt = (256, 16) if args.small else (1024, 64)
    net = build_flagship(img, small=args.small, device=device, train=True)
    mesh = create_mesh(world)
    replicate(net, mesh)
    batch = shard_batch(synthetic_train_batch(
        args.per_rank * world, img, max_gt, 0, device), mesh)
    timed = chip_smoke.ddp_timed_steps(net, batch, rank, args.steps)
    checksum = torch.tensor(timed["param_checksum"], dtype=torch.float64,
                            device=device)
    ms = torch.tensor(timed["ms_per_step"], dtype=torch.float64,
                      device=device)
    sums = [checksum]
    if world > 1:
        sums = [torch.zeros_like(checksum) for _ in range(world)]
        dist.all_gather(sums, checksum)
        dist.all_reduce(ms, op=dist.ReduceOp.MAX)
    return dict(procs=world, backend=dist.get_backend() if world > 1
                else None, img=img, global_batch=args.per_rank * world,
                ms_per_step=float(ms), rank0_step_ms=timed["step_ms"],
                images_per_s=args.per_rank * world * 1e3 / float(ms),
                allreduce_span_ms=timed["span_ms"].get("allreduce"),
                allreduce_bytes=timed["allreduce_bytes"],
                k2_per_step=timed["launches"]["roi_align_train_forward"]
                / args.steps,
                same_parameters=len({float(s) for s in sums}) == 1,
                metrics=timed["metrics"])


def main():
    args = parse_args()
    if args.rank_run:
        out = rank_run(args)
        import torch.distributed as dist
        if int(os.environ.get("RANK", "0")) == 0:
            print("RESULT " + json.dumps(out), flush=True)
        if dist.is_initialized():
            dist.destroy_process_group()
        return
    import chip_smoke
    if args.device != "cpu":
        from aidet_tpu_torch.cuda_build import build_all
        build_all()
    for n in args.procs:
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", str(n), "--master_addr", "127.0.0.1",
               "--master_port", str(chip_smoke.free_port()),
               os.path.abspath(__file__), "--rank-run", "--steps",
               str(args.steps), "--per-rank", str(args.per_rank),
               "--device", args.device] + (["--small"] if args.small
                                           else [])
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=900)
        lines = [line for line in proc.stdout.splitlines()
                 if line.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            sys.exit(f"{n} processes exited {proc.returncode}:\n"
                     f"{(proc.stdout + proc.stderr)[-3000:]}")
        print(lines[-1][len("RESULT "):], flush=True)
    if args.device != "cpu":
        print(chip_smoke.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
