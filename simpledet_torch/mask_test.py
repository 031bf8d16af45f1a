"""Evaluate a Mask R-CNN from a config on its roidb, bbox and segm
(counterpart of `mask_test.py::mask_test_net`).

    python -m simpledet_torch.mask_test --config config/<name>.py \
        [--max-images N] [--device cpu]

The flow is mask_test_net's: the config's roidb (through
TestParam.process_roidb); the loader with the config's transforms (batch
TestParam.batch_image or 1, aspect-grouped, the tail batch masked); the
checkpoint as the test CLI restores it (`detection_test.restore`: SyncBN's
running statistics beside it); on the device the test forward, which runs
the per-class NMS and the mask head on the kept boxes; on the host each kept
box rescaled by im_info[2] and its class's 28 x 28 probabilities pasted into
the image at 0.5 (`eval/segm.py`); `experiments/<name>/<image
set>_segm_result.json` with each detection's mask as COCO compressed RLE;
then the gt segmentations rasterized (`data/rle.py`), the contiguous class
ids mapped back to COCO's, and the in-repo COCO evaluation, bbox then segm.
Runs on the card unless --device cpu is given. Multi-scale and flip testing,
soft-NMS, set-NMS and mesh-sharded eval (SIMPLEDET_EVAL_DEVICES) raise
NotImplementedError naming themselves, as in the test CLI.
"""
import argparse
import json
import os
import time

import numpy as np

from simpledet_torch.data.loader import Loader
from simpledet_torch.data.rle import encode_rle, segmentation_to_mask
from simpledet_torch.data.transforms import from_config
from simpledet_torch.detection_test import (_refuse_unported, eval_roidb,
                                            restore)
from simpledet_torch.eval.coco_eval import COCOEval
from simpledet_torch.eval.segm import segm_results
from simpledet_torch.infer import Detector
from simpledet_torch.logger import config_logger


def mask_rows(out, batch, roidb_by_id):
    """Detections of one batch as mask_test_net makes them: each valid
    image's kept boxes divided by im_info[2], [x, y, w, h], the score and
    contiguous class as they are, and `_mask` the pasted binary mask."""
    boxes, scores, classes, valid, masks = (t.cpu().numpy() for t in out)
    rows = []
    for b in range(len(batch["im_id"])):
        if not batch["valid"][b]:
            continue
        scale = float(batch["im_info"][b][2])
        rec = roidb_by_id[int(batch["im_id"][b])]
        keep = valid[b]
        img_boxes = boxes[b][keep] / scale
        img_masks = segm_results(img_boxes, masks[b][keep], rec["h"],
                                 rec["w"])
        for (x1, y1, x2, y2), sc, cl, mk in zip(
                img_boxes, scores[b][keep], classes[b][keep], img_masks):
            rows.append({"image_id": int(rec["im_id"]),
                         "category_id": int(cl),
                         "bbox": [float(x1), float(y1), float(x2 - x1 + 1),
                                  float(y2 - y1 + 1)],
                         "score": float(sc), "_mask": mk})
    return rows


def mask_test_net(config_path, max_images=None, *, device="cuda",
                  stats=None):
    """{"bbox": summary, "segm": summary} (None without an annotation file).
    stats, when given, is a dict that gets the image count, the eval batch,
    seconds and img/s of the forward-and-paste loop."""
    det = Detector(config_path, device=device, seed=0)
    spec, t = det.spec, det.spec.test
    if not det.has_masks:
        raise ValueError(f"{config_path}: {spec.detector} has no mask head")
    _refuse_unported(t)
    exp_dir = os.path.join("experiments", spec.name)
    logger = config_logger(exp_dir)
    roidb = eval_roidb(spec, max_images)
    logger.info(f"evaluating {len(roidb)} images (bbox + segm) on "
                f"{det.device}")
    restore(det, logger)

    eval_batch = int(t.batch_image or 1)
    loader = Loader(roidb, from_config(spec.transform), eval_batch,
                    shuffle=False, num_workers=4,
                    keys=("data", "im_info", "im_id"), pad_last=False,
                    aspect_grouping=True)
    roidb_by_id = {r["im_id"]: r for r in roidb}
    detections, n_done = [], 0
    t0 = time.perf_counter()
    for batch in loader:
        out = det.detect(batch["data"], batch["im_info"])
        detections += mask_rows(out, batch, roidb_by_id)
        n_done += int(np.asarray(batch["valid"]).sum())
    dt = time.perf_counter() - t0
    logger.info(f"inference done: {n_done} images in {dt:.1f}s "
                f"({n_done / max(dt, 1e-9):.2f} img/s)")
    if stats is not None:
        stats.update(images=n_done, batch=eval_batch, seconds=dt,
                     img_per_s=n_done / max(dt, 1e-9))

    if t.process_output:
        detections = t.process_output(detections, None)
    result_json = os.path.join(exp_dir, spec.dataset.image_set[0]
                               + "_segm_result.json")
    os.makedirs(exp_dir, exist_ok=True)
    with open(result_json, "w") as f:
        json.dump([dict({k: v for k, v in d.items() if k != "_mask"},
                        segmentation=encode_rle(d["_mask"]))
                   for d in detections], f)
    logger.info(f"wrote {result_json}")

    ann = t.coco.annotation if t.coco else None
    if not (ann and os.path.exists(ann)):
        logger.info("no annotation json; skipping COCO eval")
        return None
    with open(ann) as f:
        gt = json.load(f)
    img_hw = {im["id"]: (im["height"], im["width"]) for im in gt["images"]}
    for a in gt.get("annotations", []):
        a["_mask"] = segmentation_to_mask(a.get("segmentation"),
                                          *img_hw[a["image_id"]])
    summaries = {}
    for iou_type in ("bbox", "segm"):
        evaluator = COCOEval(gt, iou_type=iou_type)
        cat_ids = evaluator.cat_ids     # contiguous ids back to COCO's
        dets = [dict(d, category_id=cat_ids[d["category_id"] - 1])
                for d in detections]
        summaries[iou_type] = evaluator.evaluate(dets)
        logger.info(f"{iou_type}: {summaries[iou_type]}")
    return summaries


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return mask_test_net(args.config, args.max_images, device=args.device)


if __name__ == "__main__":
    main()
