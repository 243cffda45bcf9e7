"""How far the card's float32 train step lies from float64: the small
RetinaNetOBB's (`chip_smoke.detector`, seeded weights, `retina_cls`'s
bias 0) first-step update, on the card in float32 with cuDNN, in
float32 with cuDNN off (PyTorch's own CUDA convolutions) and in
float64, and on the CPU in float32, each against the CPU's float64
update, per leaf: the leaf's largest difference over its largest
update, on the leaves whose update spans `chip_smoke.UPDATE_RESOLUTION`
float32 ulps of their largest weight.  TF32 is off.

    python tools/torch_grad_precision.py

It needs a CUDA card and prints one line per run: its name, grad_norm
against the float64 step's, and the 4 worst leaves.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def step(device, dtype):
    import torch

    import chip_smoke
    from aidet_tpu_torch.flagship import synthetic_train_batch
    from aidet_tpu_torch.parallel.train import (build_lr_schedule,
                                                build_optimizer,
                                                create_train_state,
                                                make_train_step)
    net = chip_smoke.detector("retinanet_obb", device, True, train=True)[0]
    net = net.to(dtype)
    net.compute_dtype = dtype
    params = list(net.parameters())
    before = [p.detach().double().cpu().clone() for p in params]
    opt = build_optimizer(build_lr_schedule(base_lr=0.01))
    state = create_train_state(net, opt)
    batch = synthetic_train_batch(2, 256, 8, 0, device, "thetaobb")
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
    _, metrics = make_train_step(net, opt)(
        state, batch, torch.Generator(device=device).manual_seed(0))
    return (float(metrics["grad_norm"]), before,
            [p.detach().double().cpu() for p in params],
            [n for n, _ in net.named_parameters()])


def main():
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        raise SystemExit("torch_grad_precision: no CUDA card found")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    eps = torch.finfo(torch.float32).eps
    ref = step("cpu", torch.float64)
    runs = [("cpu_f32", "cpu", torch.float32, True),
            ("card_f32_cudnn", "cuda", torch.float32, True),
            ("card_f32_no_cudnn", "cuda", torch.float32, False),
            ("card_f64", "cuda", torch.float64, True)]
    for name, device, dtype, cudnn in runs:
        with torch.backends.cudnn.flags(enabled=cudnn):
            got = step(device, dtype)
        errs = []
        for gb, ga, rb, ra, n in zip(got[1], got[2], ref[1], ref[2],
                                     ref[3]):
            d_ref = ra - rb
            big = float(d_ref.abs().max())
            if big <= chip_smoke.UPDATE_RESOLUTION * eps * float(
                    rb.abs().max()):
                continue
            errs.append((float(((ga - gb) - d_ref).abs().max()) / big, n))
        errs.sort(reverse=True)
        print(name, got[0], ref[0], errs[:4], flush=True)


if __name__ == "__main__":
    main()
