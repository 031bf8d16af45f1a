"""Evaluate a detector from a config on its roidb (counterpart of
`detection_test.py::test_net`).

    python -m simpledet_torch.detection_test --config config/<name>.py \
        [--max-images N] [--device cpu]

The flow is test_net's: the config's roidb (through TestParam.process_roidb);
the loader with the config's transforms (batch TestParam.batch_image or 4,
aspect-grouped, the tail batch masked, not padded); the checkpoint
`TestParam.model.prefix` at TestParam.model.epoch, or the newest one, or a
warning and seeded random weights; on the device the test forward and the
per-class NMS; boxes rescaled by im_info[2] and written as rows [x, y, w, h]
rounded to 0.01 px and scores to 1e-6; `experiments/<name>/<image
set>_result.json`; then the contiguous class ids mapped back to COCO's and
the in-repo COCO evaluation (bbox) against TestParam.coco.annotation. Runs on
the card unless --device cpu is given.

A SyncBN model evaluates on the running statistics saved beside its
checkpoint (`.batch_stats`). Without them it normalises with each batch's
statistics, and then, as test_net does, at batch 1 unless
TestParam.batch_image is set, so that no image's statistics mix with
another's; the log says so.

Multi-scale and flip testing, soft-NMS, set-NMS and mesh-sharded eval raise
NotImplementedError naming themselves.
"""
import argparse
import json
import os
import time

import numpy as np

from simpledet_torch.core.checkpoint import (get_latest_ckpt_epoch,
                                             load_batch_stats,
                                             load_checkpoint, params_path)
from simpledet_torch.data.loader import Loader
from simpledet_torch.data.roidb import load_roidb
from simpledet_torch.data.transforms import from_config
from simpledet_torch.eval.coco_eval import COCOEval
from simpledet_torch.infer import Detector
from simpledet_torch.logger import config_logger
from simpledet_torch.models.norm import batch_stat_names


def _refuse_unported(t):
    if t.scales:
        raise NotImplementedError("multi-scale testing (TestParam.scales) is "
                                  "not ported")
    if t.flip:
        raise NotImplementedError("flip testing (TestParam.flip) is not "
                                  "ported")
    nms_type = (t.nms.type if t.nms else None) or "nms"
    if nms_type in ("softnms", "setnms"):
        raise NotImplementedError(f"{nms_type} (TestParam.nms.type) is not "
                                  "ported")
    if os.environ.get("SIMPLEDET_EVAL_DEVICES", "1") != "1":
        raise NotImplementedError("mesh-sharded eval (SIMPLEDET_EVAL_DEVICES)"
                                  " is not ported")


def detection_rows(boxes, scores, classes, valid, batch):
    """Result rows of one batch, as test_net makes them: valid detections of
    valid images, boxes divided by im_info[2], [x, y, w, h] rounded to 0.01
    px, scores to 1e-6, contiguous class ids."""
    boxes, scores, classes, valid = (t.cpu().numpy() for t in
                                     (boxes, scores, classes, valid))
    bvalid = np.asarray(batch["valid"])
    im_ids = np.asarray(batch["im_id"]).astype(np.int64)
    scale = np.asarray(batch["im_info"])[:, 2]
    keep = valid & bvalid[:, None]
    bi, ji = np.nonzero(keep)
    bx = boxes[bi, ji] / scale[bi, None]
    rows = np.round(np.concatenate(
        [bx[:, :2], bx[:, 2:4] - bx[:, :2] + 1], axis=1), 2).tolist()
    return [{"image_id": int(im_ids[bi[n]]),
             "category_id": int(classes[bi[n], ji[n]]),
             "bbox": rows[n],
             "score": round(float(scores[bi[n], ji[n]]), 6)}
            for n in range(len(bi))]


def eval_roidb(spec, max_images=None):
    """The config's eval records: TestParam.process_roidb, the first
    max_images, rec_id numbered."""
    t = spec.test
    roidb = load_roidb(spec.dataset.image_set,
                       spec.dataset.cache_dir or "data/cache")
    roidb = t.process_roidb(roidb) if t.process_roidb else roidb
    if max_images:
        roidb = roidb[:max_images]
    for i, r in enumerate(roidb):
        r["rec_id"] = i
    return roidb


def restore(det, logger):
    """Load TestParam.model's checkpoint (its epoch, or the newest) into the
    Detector's model, and a SyncBN model's running statistics beside it;
    warn and keep the seeded weights without one. Returns (whether the model
    has SyncBN, whether its running statistics were loaded)."""
    t = det.spec.test
    prefix = t.model.prefix
    epoch = t.model.epoch or get_latest_ckpt_epoch(prefix)
    syncbn = bool(batch_stat_names(det.model))
    has_stats = False
    if epoch is not None and os.path.exists(params_path(prefix, epoch)):
        load_checkpoint(prefix, epoch, det.model)
        logger.info(f"loaded {params_path(prefix, epoch)}")
        if syncbn:
            has_stats = load_batch_stats(prefix, epoch, det.model)
            logger.info("loaded SyncBN running stats" if has_stats else
                        "WARNING: syncbn model without saved running stats; "
                        "eval uses per-batch statistics")
    else:
        logger.info("WARNING: no checkpoint found, using random params")
    return syncbn, has_stats


def test_net(config_path, max_images=None, *, device="cuda", stats=None):
    """The COCO summary dict (None without an annotation file). stats, when
    given, is a dict that gets the image count, the eval batch, seconds and
    img/s of the forward-and-NMS loop."""
    det = Detector(config_path, device=device, seed=0)
    spec, t = det.spec, det.spec.test
    _refuse_unported(t)
    exp_dir = os.path.join("experiments", spec.name)
    logger = config_logger(exp_dir)
    roidb = eval_roidb(spec, max_images)
    logger.info(f"evaluating {len(roidb)} images on {det.device}")
    syncbn, has_stats = restore(det, logger)

    eval_batch = int(t.batch_image or 4)
    if syncbn and not has_stats and not t.batch_image:
        eval_batch = 1
        logger.info("syncbn without running stats: forcing eval batch 1 "
                    "(per-batch statistics)")
    loader = Loader(roidb, from_config(spec.transform), eval_batch,
                    shuffle=False, num_workers=4,
                    keys=("data", "im_info", "im_id"), pad_last=False,
                    aspect_grouping=True)
    score_thr = t.min_det_score or 0.05
    detections, n_done = [], 0
    t0 = time.perf_counter()
    for batch in loader:
        out = det.detect(batch["data"], batch["im_info"], score_thr=score_thr)
        detections += detection_rows(*out[:4], batch)
        n_done += int(np.asarray(batch["valid"]).sum())
    dt = time.perf_counter() - t0
    logger.info(f"inference done: {n_done} images in {dt:.1f}s "
                f"({n_done / max(dt, 1e-9):.2f} img/s)")
    if stats is not None:
        stats.update(images=n_done, batch=eval_batch, seconds=dt,
                     img_per_s=n_done / max(dt, 1e-9))

    if t.process_output:
        detections = t.process_output(detections, None)
    result_json = os.path.join(exp_dir,
                               spec.dataset.image_set[0] + "_result.json")
    os.makedirs(exp_dir, exist_ok=True)
    with open(result_json, "w") as f:
        json.dump(detections, f)
    logger.info(f"wrote {result_json}")

    ann = t.coco.annotation if t.coco else None
    if ann and os.path.exists(ann):
        evaluator = COCOEval(ann, iou_type="bbox")
        cat_ids = evaluator.cat_ids     # contiguous ids back to COCO's
        for d in detections:
            d["category_id"] = cat_ids[d["category_id"] - 1]
        summary = evaluator.evaluate(detections)
        logger.info(str(summary))
        return summary
    logger.info("no annotation json; skipping COCO eval")
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return test_net(args.config, args.max_images, device=args.device)


if __name__ == "__main__":
    main()
