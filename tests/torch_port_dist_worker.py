"""One rank of the port's multi-process tests (tests/test_torch_port_dist.py;
the port's counterpart of tests/_dist_worker.py), and the small models
and batches those tests share with it.

    python tests/torch_port_dist_worker.py JOBS RANK WORLD STORE OUT

Each rank joins a gloo group on the CPU through
`aidet_tpu_torch.parallel.dist.init_distributed` (rendezvous at the
``file://`` STORE), runs every job of the JOBS file (`torch.save`d list
of dicts, run in order on every rank) and saves a dict of the jobs'
results, by name, to OUT/rank{RANK}.pt.  Jobs:

- ``step``: one data-parallel train step (`make_train_step` over
  `create_mesh`) of a model from its config and state_dict on this
  rank's rows (`shard_batch`) of the job's global batch, after
  `replicate` (rank 1 starts from perturbed weights, which the
  broadcast must replace); the metrics, and rank 0's parameters after;
- ``gather``: `gather_results` over the real gloo all-gather on an
  uneven and on an empty shard;
- ``infer``: `run_inference` of a model over a dataset config, sharded
  by the group (and with ``mesh``, over a `create_mesh`), gathered.

This module imports no JAX: the reference runs in the test process.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMG, G, MAX_NUM = 128, 6, 64
# the families of `__graft_entry__.dryrun_multichip` at 128^2, in the
# port's config words: ResNet-18, a 64-channel FPN, 16 classes
TINY = dict(
    backbone=dict(type="ResNet", depth=18),
    neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=64,
              num_outs=5),
    rpn_head=dict(type="RPNHead", in_channels=64, feat_channels=64,
                  num_anchors=3),
    bbox_head=dict(type="SharedFCBBoxHead", num_classes=16, in_channels=64,
                   fc_out_channels=128),
    img_size=IMG)
CENTERMAP_HEAD = dict(type="CenterMapHead", num_convs=2, in_channels=64,
                      conv_out_channels=64, num_classes=16)
FAMILIES = {
    "FasterRCNN": dict(type="FasterRCNN", **TINY),
    "RetinaNetOBB": dict(
        type="RetinaNetOBB", backbone=dict(type="ResNet", depth=18),
        neck=dict(type="FPN", in_channels=(64, 128, 256, 512),
                  out_channels=64, num_outs=5, start_level=1,
                  add_extra_convs=True),
        bbox_head=dict(type="RetinaHead", num_classes=16, in_channels=64,
                       feat_channels=64, stacked_convs=1, num_anchors=9,
                       reg_dim=5),
        rbox_encode="thetaobb", img_size=IMG,
        train_cfg=dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.4,
                                     min_pos_iou=0),
                       allowed_border=-1, pos_weight=-1),
        test_cfg=dict(nms_pre=128, score_thr=0.05, rnms_thr=0.1,
                      max_per_img=16)),
    "RBBoxRCNN": dict(
        type="RBBoxRCNN", rbbox_head=dict(
            type="RBBoxHead", num_classes=16, in_channels=64,
            fc_out_channels=128, encode="thetaobb"),
        rbbox_encode="thetaobb", **TINY),
    "RBBoxRCNNRRoI": dict(
        type="RBBoxRCNNRRoI",
        rbbox_head=dict(type="RBBoxHead", num_classes=16, in_channels=64,
                        fc_out_channels=128, encode="thetaobb"),
        rbbox_refine_head=dict(type="RBBoxHead", num_classes=16,
                               in_channels=64, fc_out_channels=128,
                               encode="rtheta"),
        **TINY),
    "CenterMapNet": dict(
        type="CenterMapNet", mask_head=CENTERMAP_HEAD,
        semantic_head=dict(type="WPSGAHead", in_channels=64, channels=64,
                           num_classes=16),
        **TINY),
    "CascadeRCNN": dict(type="CascadeRCNN", **TINY),
    "CenterMapOBB-HRNet": dict(
        TINY, type="CenterMapOBB", mask_head=CENTERMAP_HEAD,
        backbone=dict(type="HRNet", width=16, stage_modules=(1, 1, 1, 1),
                      stage_blocks=2),
        neck=dict(type="HRFPN", in_channels=(16, 32, 64, 128),
                  out_channels=64, num_outs=5)),
}
# the rest of the zoo, as chip_smoke's small kinds (`chip_smoke.hbb_model`:
# ResNet-18, a 64-channel FPN, 128^2 but SSD300): the dense detectors'
# normalisers (centerness sums, GHM's bin counts, FreeAnchor's bags,
# SSD's and GA-RetinaNet's per-image losses averaged over the images),
# GA-RPN's per-image losses, Libra's balanced L1, Mask Scoring's IoU
# loss, HTC's stages, masks and semantic loss.  Grid R-CNN is left out:
# its jitter draws from each rank's generator.
ZOO = ("fcos", "atss", "fovea", "reppoints", "free_anchor", "sepbn_ghm",
       "ga_retina", "ssd", "ga_faster", "libra", "ms", "htc")
# the zoo's gts an image: HTC's last interleaved mask sample holds up to
# 4 ZOO_G + 50 valid candidates, within its ZOO_G + MAX_NUM rows
ZOO_G = 4
# the extra inputs of each family's loss (`family_batch`)
EXTRAS = {"RetinaNetOBB": ("gt_rboxes",), "RBBoxRCNN": ("gt_rboxes",),
          "RBBoxRCNNRRoI": ("gt_rboxes",),
          "CenterMapNet": ("gt_masks", "gt_semantic", "gt_seg_weights"),
          "CenterMapOBB-HRNet": ("gt_rboxes", "gt_masks_quarter")}


def train_cfg(name):
    """Samplers that keep every candidate (the 2-rank and the 1-process
    steps draw from other generators), with the family's own train_cfg
    entries; None for the single-stage family, which samples nothing."""
    if name == "RetinaNetOBB":
        return None
    from aidet_tpu_torch.flagship import keep_every_candidate_cfg
    if name == "CascadeRCNN":
        # each stage's candidates are the gts and the previous stage's
        # sample: at most 10 proposals a level (50) keep every stage's
        # valid candidates (up to 3 G + 50) within its G + MAX_NUM rows
        proposals = dict(nms_pre=16, nms_post=10, max_num=MAX_NUM)
    else:
        proposals = dict(nms_pre=128, nms_post=MAX_NUM, max_num=MAX_NUM)
    return dict(keep_every_candidate_cfg(IMG, G, MAX_NUM),
                rpn_proposal=proposals)


def family_batch(name, seed=0, b=4):
    """A seeded global batch of ``b`` images whose halves hold unequal
    numbers of gts: the first half G valid gts per image, the second
    half one, so that the ranks of a 2-rank step count different
    positives (what a rank-local loss normaliser gets wrong).  uint8
    images for the families; for the zoo normalised float images, as
    `chip_smoke.hbb_train_batch`'s (with box masks and a semantic map
    where the kind takes them)."""
    if name in ZOO:
        return zoo_batch(name, seed, b)
    rs = np.random.RandomState(seed)
    xy = rs.uniform(8, IMG - 48, (b, G, 2))
    wh = rs.uniform(12, 40, (b, G, 2))
    theta = rs.uniform(-1.5, -0.01, (b, G, 1))
    valid = np.zeros((b, G), bool)
    valid[:b // 2] = True
    valid[b // 2:, 0] = True
    f32 = np.float32
    out = dict(
        imgs=rs.randint(0, 256, (b, IMG, IMG, 3)).astype(np.uint8),
        gt_boxes=np.concatenate([xy, xy + wh], -1).astype(f32),
        gt_valid=valid,
        gt_labels=rs.randint(1, 16, (b, G)).astype(np.int64),
        img_shapes=np.tile([[IMG, IMG]], (b, 1)).astype(f32))
    extras = EXTRAS.get(name, ())
    if "gt_rboxes" in extras:
        out["gt_rboxes"] = np.concatenate([xy + wh / 2, wh, theta],
                                          -1).astype(f32)
    for key, size in (("gt_masks", IMG), ("gt_masks_quarter", IMG // 4)):
        if key in extras:
            out["gt_masks"] = (rs.rand(b, G, size, size) * 0.7).astype(f32)
    if "gt_semantic" in extras:
        out["gt_semantic"] = rs.randint(0, 16, (b, IMG, IMG)).astype(
            np.int64)
    if "gt_seg_weights" in extras:   # the semantic loss's weighted mean
        out["gt_seg_weights"] = rs.rand(b, IMG, IMG).astype(f32)
    return out


def zoo_batch(kind, seed=0, b=4):
    import chip_smoke
    spec = chip_smoke.HBB_KINDS[kind]
    img = spec.get("img", IMG)
    rs = np.random.RandomState(seed)
    xy = rs.uniform(8, IMG - 48, (b, ZOO_G, 2)) * (img / IMG)
    wh = rs.uniform(12, 40, (b, ZOO_G, 2)) * (img / IMG)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.zeros((b, ZOO_G), bool)
    valid[:b // 2] = True
    valid[b // 2:, 0] = True
    out = dict(imgs=rs.randn(b, img, img, 3).astype(np.float32),
               gt_boxes=boxes, gt_valid=valid,
               gt_labels=rs.randint(1, 16, (b, ZOO_G)).astype(np.int64),
               img_shapes=np.full((b, 2), float(img), np.float32))
    if spec.get("masks"):       # each gt's box filled
        grid = np.arange(img, dtype=np.float32)
        bx = boxes[..., None, None]
        out["gt_masks"] = ((grid >= bx[..., 0, :, :])
                           & (grid <= bx[..., 2, :, :])
                           & (grid[:, None] >= bx[..., 1, :, :])
                           & (grid[:, None] <= bx[..., 3, :, :])
                           ).astype(np.float32)
    if kind == "htc":
        out["gt_semantic"] = rs.randint(0, 16, (b, img // 4, img // 4))
    return out


def build_family(name, seed=0):
    """The port's training build of family ``name`` (or zoo kind) on the
    CPU."""
    if name in ZOO:
        import chip_smoke
        from aidet_tpu_torch.flagship import keep_every_candidate_cfg
        spec = chip_smoke.HBB_KINDS[name]
        img = spec.get("img", IMG)
        cfg = None if spec.get("dense") else dict(
            keep_every_candidate_cfg(img, ZOO_G, MAX_NUM),
            rpn_proposal=chip_smoke.HBB_REF_PROPOSALS)
        return chip_smoke.hbb_model(name, "cpu", True, img, train=True,
                                    train_cfg=cfg, seed=seed)
    from aidet_tpu_torch.models.builder import build_detector
    return build_detector(FAMILIES[name], train_cfg=train_cfg(name),
                          device="cpu", seed=seed, train=True)


def tensors(batch):
    import torch
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def one_step(model, batch, generator):
    """One step of `make_train_step` (lr 0.02, the reference's 10-step
    warmup of `dryrun_multichip`): (metrics as floats, parameters
    after)."""
    from aidet_tpu_torch.parallel.train import (build_lr_schedule,
                                                build_optimizer,
                                                create_train_state,
                                                make_train_step)
    optimizer = build_optimizer(build_lr_schedule(0.02, warmup_iters=10))
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer)
    _, metrics = step(state, tensors(batch), generator)
    return ({k: float(v) for k, v in metrics.items()},
            [p.detach().clone() for p in model.parameters()])


def build_job_model(job):
    if job.get("flagship"):
        from aidet_tpu_torch.flagship import build_flagship
        model = build_flagship(job["img"], small=True, device="cpu",
                               train=True, train_cfg=job["train_cfg"])
    elif job.get("cfg") is not None:
        from aidet_tpu_torch.models.builder import build_detector
        model = build_detector(job["cfg"], train_cfg=job.get("train_cfg"),
                               test_cfg=job.get("test_cfg"), device="cpu",
                               train=job["kind"] == "step")
    else:
        model = build_family(job["family"])
    model.load_state_dict(job["state_dict"], strict=True)
    return model


def run_step(job, rank, world):
    import torch
    from aidet_tpu_torch.apis.train import step_seed
    from aidet_tpu_torch.parallel.mesh import (create_mesh, replicate,
                                               shard_batch)
    model = build_job_model(job)
    if rank:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    mesh = create_mesh(world)
    replicate(model, mesh)
    gen = torch.Generator().manual_seed(step_seed(0, 0, rank))
    metrics, after = one_step(model, shard_batch(job["batch"], mesh), gen)
    return dict(metrics=metrics, params=after if rank == 0 else None)


def run_gather(job, rank, world):
    from aidet_tpu_torch.parallel.dist import gather_results

    def make(i):
        return dict(boxes=np.full((3, 4), float(i), np.float32),
                    scores=np.full((3,), float(i), np.float32),
                    valid=np.arange(3) < i % 3)
    total = 5      # shards [0, 2, 4] and [1, 3]: the short one is padded
    uneven = gather_results([make(i) for i in range(rank, total, world)],
                            world, rank, total)
    example = dict(boxes=np.zeros((3, 4), np.float32),
                   scores=np.zeros((3,), np.float32),
                   valid=np.zeros((3,), bool))
    empty = gather_results([make(0)] if rank == 0 else [], world, rank, 1,
                           example=example)
    return dict(uneven=uneven, empty=empty)


def run_infer(job, rank, world):
    from aidet_tpu_torch.apis.test import run_inference
    from aidet_tpu_torch.data.builder import build_dataset
    from aidet_tpu_torch.parallel.mesh import create_mesh
    model = build_job_model(job)
    dataset = build_dataset(job["dataset"])
    done = []
    results, names = run_inference(
        model, dataset, batch_size=job["batch_size"],
        mesh=create_mesh(world) if job.get("mesh") else None,
        progress=lambda n, total: done.append((n, total)))
    return dict(results=results, names=names, progress=done)


RUNNERS = dict(step=run_step, gather=run_gather, infer=run_infer)


def main():
    jobs_path, rank, world, store, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    sys.path.insert(0, REPO)
    import time

    import torch
    torch.set_num_threads(1)
    from aidet_tpu_torch.parallel.dist import init_distributed
    got = init_distributed(rank, world, init_method=f"file://{store}",
                           device="cpu", timeout_s=100)
    assert got == (rank, world), got
    results = {}
    for job in torch.load(jobs_path, weights_only=False):
        t0 = time.perf_counter()
        results[job["name"]] = RUNNERS[job["kind"]](job, rank, world)
        results[job["name"]]["seconds"] = time.perf_counter() - t0
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    main()
