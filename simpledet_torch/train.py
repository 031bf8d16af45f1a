"""Train a detector for a few steps on synthetic data and time the steps.

Counterpart of the step loop of `detection_train.py` and `bench.py`: builds
the config's train detector (seeded random weights) with its optimizer,
schedule and frozen parameters, and trains it on synthetic uint8 images with
20 random gt boxes per image (made as `bench.py` makes them, from --seed).
Before the first step the backbone's FrozenBN buffers (and a C4 model's C5
head's) take the folded statistics of that batch
(`Trainer.fold_batch_stats`), the stand-in for a pretrained checkpoint. A Mask R-CNN config's gt boxes each get the polygon
of their inscribed ellipse (`synthetic_gt_poly`).

    python -m simpledet_torch.train --config config/faster_r50v1_fpn_1x.py \
        --shape 800 1333 --batch 2 --steps 20

Under `torchrun --nproc_per_node 1` it trains as a rank of a 1-process
group (NCCL, the model in DDP, SyncBN's sums through the group).

prints each step's losses, then ms/step and img/s over the steps after the
first two, and the forward / backward / optimizer split by CUDA events, with
the card's name and power limit. On the card it then traces 3 more steps
with torch.profiler and prints the device's idle share and its top kernels.
The trace also gives the device time of the model's profiler ranges in the
forward (`breakdown.PROFILER_RANGES`: a Mask R-CNN's mask targets, mask
RoIAlign and mask head, the deformable convs, the DCN units, SEPC).
`python -m simpledet_torch.detection_train` trains on a roidb through the
loader and writes checkpoints.
"""
import argparse
import json
import time

import numpy as np
import torch

from simpledet_torch.breakdown import device_profile
from simpledet_torch.core.train import Trainer
from simpledet_torch.infer import card_name_and_power, full_fp32, precision
from simpledet_torch.models.mask_rcnn import MaskFasterRcnn
from simpledet_torch.parallel import dist

WARMUP_STEPS = 2
PROFILED_STEPS = 3


def synthetic_gt_poly(gt, max_edges=1250):
    """Polygon edges [B, G, max_edges, 5] for gt_bbox [B, G, 5]: each valid
    box's inscribed ellipse as a 16-gon (`data/synthetic.py`), packed as
    `EncodeGtPoly` packs a record's polygons (max_edges: the mask configs'
    max_len_gt_poly 2500 // 2)."""
    from simpledet_torch.data.mask_transforms import polys_to_edges
    from simpledet_torch.data.synthetic import ellipse_polygon

    gt = np.asarray(gt)
    out = np.full(gt.shape[:2] + (max_edges, 5), -1, np.float32)
    for b, i in zip(*np.nonzero(gt[..., 4] >= 0)):
        poly = ellipse_polygon(*gt[b, i, :4]).astype(np.float32).reshape(-1)
        out[b, i] = polys_to_edges([poly], max_edges)
    return torch.from_numpy(out)


def synthetic_train_batch(batch, h, w, seed, num_gt=20, max_num_gt=100):
    """(uint8 images [B, H, W, 3], im_info [B, 3], gt_bbox [B, max_num_gt, 5])
    with num_gt random boxes per image and class -1 padding rows. The boxes
    follow `bench.py` at 800 x 1333 and shrink with a smaller image, so that
    they stay inside it."""
    rng = np.random.RandomState(seed)
    s = min(h / 800, w / 1333, 1.0)
    gt = np.full((batch, max_num_gt, 5), -1, np.float32)
    for b in range(batch):
        for i in range(num_gt):
            x1, y1 = rng.uniform(0, 600, 2)
            gt[b, i] = [s * x1, s * y1, s * (x1 + rng.uniform(30, 300)),
                        s * (y1 + rng.uniform(30, 200)), rng.randint(1, 81)]
    images = rng.randint(0, 256, (batch, h, w, 3), dtype=np.uint8)
    im_info = np.tile(np.float32([[h, w, 1.0]]), (batch, 1))
    return (torch.from_numpy(images), torch.from_numpy(im_info),
            torch.from_numpy(gt))


class PhaseTimer:
    """CUDA events at each phase end of a Trainer step; ms per phase."""

    PHASES = ("forward", "backward", "optimizer")

    def __init__(self):
        self.events = []
        self.totals = dict.fromkeys(self.PHASES, 0.0)

    def start(self):
        self.events = [("start", torch.cuda.Event(enable_timing=True))]
        self.events[0][1].record()

    def __call__(self, phase):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((phase, ev))

    def collect(self):
        """After a synchronise: add the last step's phases to the totals."""
        for (_, a), (phase, b) in zip(self.events, self.events[1:]):
            self.totals[phase] += a.elapsed_time(b)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--shape", nargs=2, type=int, default=[800, 1333])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.steps <= WARMUP_STEPS:
        ap.error(f"--steps must exceed the {WARMUP_STEPS} warm-up steps")

    full_fp32()
    device = dist.init_from_env(args.device)     # a rank under torchrun
    trainer = Trainer.from_config(args.config, device=device,
                                  seed=args.seed)
    on_card = trainer.device.type == "cuda"
    h, w = args.shape
    images, im_info, gt = synthetic_train_batch(args.batch, h, w, args.seed)
    batch = (images.to(trainer.device), im_info, gt)
    if isinstance(trainer.model, MaskFasterRcnn):
        batch += (synthetic_gt_poly(gt),)
    trainer.fold_batch_stats(*batch[:2])
    timer = PhaseTimer() if on_card else None
    trainer.timer = timer

    def sync():
        if on_card:
            torch.cuda.synchronize(trainer.device)

    t0 = None
    for i in range(args.steps):
        if i == WARMUP_STEPS:        # kernel builds and cuDNN plans are done
            sync()
            t0 = time.perf_counter()
        if timer is not None:
            timer.start()
        losses = trainer.step(*batch)
        sync()
        if timer is not None and i >= WARMUP_STEPS:
            timer.collect()
        print(f"step {i}: " + ", ".join(f"{k} {float(v):.5f}"
                                        for k, v in losses.items()),
              flush=True)
    dt = time.perf_counter() - t0
    n = args.steps - WARMUP_STEPS
    where = card_name_and_power() if on_card else "cpu"
    print(f"{dt / n * 1e3:.3f} ms/step ({n * args.batch / dt:.2f} img/s) at "
          f"{h}x{w}, batch {args.batch}, {precision(trainer.model)}, "
          f"on {where}")
    if timer is not None:
        print("per step (CUDA events, synchronised after each step): "
              + ", ".join(f"{k} {v / n:.3f} ms"
                          for k, v in timer.totals.items()))
    if on_card:
        trainer.timer = None
        traced_ms, busy_ms, top, ranges = device_profile(
            lambda: trainer.step(*batch), PROFILED_STEPS)
        print(json.dumps({
            "card": where, "traced_step_ms": traced_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / traced_ms),
            "top_kernels_ms_per_step": top,
            "ranges_device_ms_per_step": ranges}, indent=1))
    dist.destroy()


if __name__ == "__main__":
    main()
