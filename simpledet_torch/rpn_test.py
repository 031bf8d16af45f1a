"""Proposal recall of a detector's rpn_test forward (counterpart of
`rpn_test.py`).

    python -m simpledet_torch.rpn_test --config config/<name>.py \
        [--max-images N] [--device cpu]

The flow is rpn_test_net's: the config's test roidb (its first max_images),
the loader at batch 1 with the config's transforms, the checkpoint
`TestParam.model.prefix` at TestParam.model.epoch or the newest one (with a
SyncBN model's running statistics beside it), or a warning and seeded random
weights; on the device the rpn_test forward of any detector that has one
(FasterRcnn, CascadeRcnn, MaskFasterRcnn, RpnOnly, TridentFasterRcnn, whose
proposals come branch-major, [nb * B, post]: an image's row is its first
branch's, as rpn_test_net reads it); then, per image with gt,
its valid proposals divided by im_info[2] and the share of its gt boxes that
the first 100, 300 and 1000 proposals reach at IoU 0.5, 0.55, ..., 0.95.
It logs `Recall@N: IoU=0.5 r  IoU=0.5:0.95 r` for each budget and returns
{N: the mean recall at IoU 0.5}, as rpn_test_net does. Runs on the card
unless --device cpu is given.
"""
import argparse
import os

import numpy as np
import torch

from simpledet_torch.data.loader import Loader
from simpledet_torch.data.roidb import load_roidb
from simpledet_torch.data.transforms import from_config
from simpledet_torch.detection_test import restore
from simpledet_torch.infer import Detector
from simpledet_torch.logger import config_logger
from simpledet_torch.ops.bbox import bbox_overlaps

BUDGETS = (100, 300, 1000)
IOU_THRS = np.arange(0.5, 1.0, 0.05)


def recall_at(gt, proposals, iou_thr):
    """The share of gt boxes [G, 4] that some proposal [P, 4] overlaps at
    IoU >= iou_thr (legacy +1 widths); None without gt, 0 without
    proposals."""
    if len(gt) == 0:
        return None
    if len(proposals) == 0:
        return 0.0
    ov = bbox_overlaps(torch.as_tensor(np.asarray(gt, np.float32)),
                       torch.as_tensor(np.asarray(proposals, np.float32)))
    # the share in float64, as numpy's mean of the hits gives it
    return float((ov.max(dim=1).values.numpy() >= iou_thr).mean())


def rpn_test_net(config_path, max_images=None, *, device="cuda"):
    """{budget: mean recall at IoU 0.5} over the images with gt."""
    det = Detector(config_path, device=device, seed=0)
    spec = det.spec
    exp_dir = os.path.join("experiments", spec.name)
    logger = config_logger(exp_dir)
    # rpn_test_net reads the roidb as it is, without process_roidb
    roidb = load_roidb(spec.dataset.image_set,
                       spec.dataset.cache_dir or "data/cache")
    roidb = roidb[:max_images] if max_images else roidb
    for i, r in enumerate(roidb):
        r["rec_id"] = i
    logger.info(f"proposal recall on {len(roidb)} images")
    restore(det, logger)
    loader = Loader(roidb, from_config(spec.transform), 1, shuffle=False,
                    num_workers=4, keys=("data", "im_info", "im_id"),
                    pad_last=False, aspect_grouping=True)
    by_id = {r["im_id"]: r for r in roidb}

    rec = {(n, t): [] for n in BUDGETS for t in IOU_THRS}
    for batch in loader:
        props, scores = (t.cpu().numpy() for t in det.propose(
            batch["data"], batch["im_info"]))
        for b in range(len(batch["im_id"])):
            if not batch["valid"][b]:
                continue
            gt = np.asarray(by_id[int(batch["im_id"][b])].get("gt_bbox", []),
                            np.float32)
            if gt.size == 0:
                continue
            p = props[b][scores[b] > -1e9] / float(batch["im_info"][b][2])
            for n in BUDGETS:
                for t in IOU_THRS:
                    r = recall_at(gt.reshape(-1, 4), p[:n], t)
                    if r is not None:
                        rec[(n, t)].append(r)

    for n in BUDGETS:
        r50 = np.mean(rec[(n, 0.5)]) if rec[(n, 0.5)] else 0.0
        rmean = np.mean([np.mean(rec[(n, t)]) for t in IOU_THRS
                         if rec[(n, t)]])
        logger.info(f"Recall@{n}: IoU=0.5 {r50:.4f}  IoU=0.5:0.95 "
                    f"{rmean:.4f}")
    return {n: np.mean(rec[(n, 0.5)]) for n in BUDGETS if rec[(n, 0.5)]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return rpn_test_net(args.config, args.max_images, device=args.device)


if __name__ == "__main__":
    main()
