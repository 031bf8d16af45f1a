"""COCO evaluation, bbox and segm: a copy of `simpledet_tpu/eval/coco_eval.py`,
kept in the port so that it imports nothing of the JAX package.

It implements the pycocotools COCOeval protocol (greedy score-ordered
matching per (image, category) at IoU thresholds .5:.05:.95, crowd
re-matching, explicit gt `ignore` flags, area-range ignores, 101-point
interpolated AP, maxDets slicing) and reports the standard 12 metrics. The
matcher is vectorized over the 10 thresholds. With iou_type="segm" the IoUs
are those of binary masks (a crowd gt's IoU is the intersection over the
detection's area) and a detection's area is its mask's.

Detections: list of dicts {image_id, category_id, bbox [x,y,w,h], score}
and, for segm, `_mask`: its [h, w] binary mask in the image. Ground truth: a
COCO-style dict or path (images/annotations/categories); for segm each
annotation carries its binary `_mask` (`data/rle.py::segmentation_to_mask`).
"""
import json

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def box_iou_xywh(dt, gt, iscrowd):
    """COCO maskUtils.iou semantics for boxes: xywh, no +1; crowd gt uses
    intersection / det area. Vectorized broadcast."""
    dt = np.asarray(dt, np.float64).reshape(-1, 4)
    gt = np.asarray(gt, np.float64).reshape(-1, 4)
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    iw = (np.minimum(dt[:, None, 0] + dt[:, None, 2],
                     gt[None, :, 0] + gt[None, :, 2])
          - np.maximum(dt[:, None, 0], gt[None, :, 0]))
    ih = (np.minimum(dt[:, None, 1] + dt[:, None, 3],
                     gt[None, :, 1] + gt[None, :, 3])
          - np.maximum(dt[:, None, 1], gt[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    darea = (dt[:, 2] * dt[:, 3])[:, None]
    garea = (gt[:, 2] * gt[:, 3])[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, darea, darea + garea - inter)
    with np.errstate(divide="ignore", invalid="ignore"):
        ious = np.where(union > 0, inter / union, 0.0)
    return ious


def mask_iou(dt_masks, gt_masks, iscrowd):
    """[D, G] IoUs of binary masks; a crowd gt's: intersection / det area."""
    ious = np.zeros((len(dt_masks), len(gt_masks)))
    if not len(dt_masks) or not len(gt_masks):
        return ious
    dt = np.asarray([m.astype(bool).ravel() for m in dt_masks])
    gt = np.asarray([m.astype(bool).ravel() for m in gt_masks])
    inter = dt.astype(np.float64) @ gt.T.astype(np.float64)
    darea = dt.sum(-1, dtype=np.float64)[:, None]
    garea = gt.sum(-1, dtype=np.float64)[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, darea, darea + garea - inter)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def _last_argmax(vals):
    """Row-wise argmax picking the LAST maximum (pycocotools traverses gts
    in order updating on iou >= best, so equal IoUs go to the later gt)."""
    g = vals.shape[1]
    rev_idx = np.argmax(vals[:, ::-1], axis=1)
    return g - 1 - rev_idx


def greedy_match(ious, g_ignore, iscrowd):
    """Vectorized pycocotools evaluateImg matching over all T thresholds.

    ious: [D, G] for dets in descending-score order and gts sorted
    ignore-last; g_ignore/iscrowd: [G] in that same order.
    Returns (dt_match [T,D] bool, dt_ignore [T,D] bool).

    Rules (cocoeval.py evaluateImg): a det matches the highest-IoU eligible
    gt (eligible = iou >= thr and not already matched unless crowd); ignored
    gts can only match when NO non-ignored gt is eligible; a det matched to
    an ignored gt is itself ignored.
    """
    D, G = ious.shape
    T = len(IOU_THRS)
    dt_match = np.zeros((T, D), bool)
    dt_ignore = np.zeros((T, D), bool)
    if G == 0 or D == 0:
        return dt_match, dt_ignore
    thr = np.minimum(IOU_THRS, 1 - 1e-10)[:, None]        # [T,1]
    ign = np.asarray(g_ignore, bool)[None, :]              # [1,G]
    crowd = np.asarray(iscrowd, bool)[None, :]
    gt_taken = np.zeros((T, G), bool)
    rows = np.arange(T)
    for di in range(D):
        iou_d = ious[di][None, :]                          # [1,G]
        elig = (iou_d >= thr) & (~gt_taken | crowd)        # [T,G]
        v1 = np.where(elig & ~ign, iou_d, -1.0)            # non-ignored tier
        i1 = _last_argmax(v1)
        h1 = v1[rows, i1] > -0.5
        v2 = np.where(elig & ign, iou_d, -1.0)             # ignored tier
        i2 = _last_argmax(v2)
        h2 = v2[rows, i2] > -0.5
        best = np.where(h1, i1, i2)
        matched = h1 | h2
        dt_match[:, di] = matched
        dt_ignore[:, di] = matched & ign[0, best]
        gt_taken[rows, best] |= matched
    return dt_match, dt_ignore


class COCOEval:
    def __init__(self, gt, iou_type="bbox"):
        """gt: COCO dict or json path; iou_type "bbox" or "segm"."""
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"COCOEval iou_type {iou_type!r}")
        if isinstance(gt, str):
            with open(gt) as f:
                gt = json.load(f)
        self.iou_type = iou_type
        self.img_ids = [im["id"] for im in gt["images"]]
        self.cat_ids = sorted(c["id"] for c in gt["categories"])
        self.gts = {}
        for a in gt.get("annotations", []):
            area = a.get("area", a["bbox"][2] * a["bbox"][3])
            self.gts.setdefault((a["image_id"], a["category_id"]), []).append({
                "bbox": a["bbox"],
                "area": area,
                "iscrowd": a.get("iscrowd", 0),
                "ignore": int(a.get("ignore", 0)),
                "_mask": a.get("_mask"),  # the binary mask, for segm
            })

    def evaluate(self, detections):
        dts = {}
        for d in detections:
            dts.setdefault((d["image_id"], d["category_id"]), []).append(d)

        T, K = len(IOU_THRS), len(self.cat_ids)
        A, M = len(AREA_RNG), len(MAX_DETS)
        max_det = max(MAX_DETS)
        area_items = list(AREA_RNG.items())

        # per-(img,cat): match ONCE per area range at maxDet=100; accumulate
        # slices columns per maxDet (identical because dets are processed in
        # score order, later dets never affect earlier matches)
        eval_imgs = {}
        for cat in self.cat_ids:
            for img in self.img_ids:
                gt = self.gts.get((img, cat), [])
                dt = sorted(dts.get((img, cat), []),
                            key=lambda x: -x["score"])[:max_det]
                if not gt and not dt:
                    continue
                iscrowd = np.array([int(g["iscrowd"]) for g in gt],
                                   dtype=np.int64)
                if self.iou_type == "bbox":
                    ious = box_iou_xywh([d["bbox"] for d in dt],
                                        [g["bbox"] for g in gt], iscrowd)
                    d_area = np.array([d["bbox"][2] * d["bbox"][3]
                                       for d in dt])
                else:
                    ious = mask_iou([d["_mask"] for d in dt],
                                    [g["_mask"] for g in gt], iscrowd)
                    d_area = np.array([d["_mask"].astype(bool).sum()
                                       for d in dt], np.float64)
                g_area = np.array([g["area"] for g in gt], dtype=np.float64)
                g_ign0 = np.array([bool(g["iscrowd"]) or bool(g["ignore"])
                                   for g in gt], dtype=bool)
                scores = np.array([d["score"] for d in dt],
                                  dtype=np.float64)
                per_area = []
                for aname, rng in area_items:
                    g_ignore = g_ign0 | (g_area < rng[0]) | (g_area > rng[1])
                    order = np.argsort(g_ignore, kind="stable")
                    dtm, dtig = greedy_match(
                        ious[:, order] if len(gt) else ious,
                        g_ignore[order], iscrowd[order])
                    d_out = (d_area < rng[0]) | (d_area > rng[1])
                    dtig = dtig | (~dtm & d_out[None, :])
                    per_area.append((dtm, dtig,
                                     int((~g_ignore).sum())))
                eval_imgs[(img, cat)] = (scores, per_area)

        # accumulate precision/recall
        precision = -np.ones((T, len(REC_THRS), K, A, M))
        recall = -np.ones((T, K, A, M))
        for k, cat in enumerate(self.cat_ids):
            recs = [eval_imgs[(img, cat)] for img in self.img_ids
                    if (img, cat) in eval_imgs]
            for a in range(A):
                for m, maxd in enumerate(MAX_DETS):
                    n_gt = sum(r[1][a][2] for r in recs)
                    if n_gt == 0:
                        continue
                    if recs:
                        scores = np.concatenate(
                            [r[0][:maxd] for r in recs])
                        order = np.argsort(-scores, kind="mergesort")
                        tps = np.concatenate(
                            [r[1][a][0][:, :maxd] for r in recs],
                            axis=1)[:, order]
                        ign = np.concatenate(
                            [r[1][a][1][:, :maxd] for r in recs],
                            axis=1)[:, order]
                    else:
                        tps = np.zeros((T, 0), bool)
                        ign = np.zeros((T, 0), bool)
                    tp = tps & ~ign
                    fp = ~tps & ~ign
                    tp_cum = np.cumsum(tp, axis=1).astype(np.float64)
                    fp_cum = np.cumsum(fp, axis=1).astype(np.float64)
                    rc_all = tp_cum / n_gt
                    with np.errstate(divide="ignore", invalid="ignore"):
                        pr_all = tp_cum / (tp_cum + fp_cum + np.spacing(1))
                    for t in range(T):
                        rc, pr = rc_all[t], pr_all[t]
                        recall[t, k, a, m] = rc[-1] if len(rc) else 0.0
                        # precision envelope (monotone decreasing),
                        # vectorized reversed running max
                        env = np.maximum.accumulate(pr[::-1])[::-1] \
                            if len(pr) else pr
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(len(REC_THRS))
                        ok = inds < len(env)
                        q[ok] = env[inds[ok]]
                        precision[t, :, k, a, m] = q

        self.precision = precision
        self.recall = recall
        return self.summarize()

    def _ap(self, iou_thr=None, area="all", max_det=100):
        a = list(AREA_RNG).index(area)
        m = MAX_DETS.index(max_det)
        p = self.precision
        if iou_thr is not None:
            t = int(np.argmin(np.abs(IOU_THRS - iou_thr)))
            p = p[t:t + 1]
        p = p[:, :, :, a, m]
        valid = p > -1
        return float(p[valid].mean()) if valid.any() else -1.0

    def _ar(self, area="all", max_det=100):
        a = list(AREA_RNG).index(area)
        m = MAX_DETS.index(max_det)
        r = self.recall[:, :, a, m]
        valid = r > -1
        return float(r[valid].mean()) if valid.any() else -1.0

    def summarize(self, logger=None):
        s = {
            "AP": self._ap(),
            "AP50": self._ap(iou_thr=0.5),
            "AP75": self._ap(iou_thr=0.75),
            "APs": self._ap(area="small"),
            "APm": self._ap(area="medium"),
            "APl": self._ap(area="large"),
            "AR1": self._ar(max_det=1),
            "AR10": self._ar(max_det=10),
            "AR100": self._ar(max_det=100),
            "ARs": self._ar(area="small"),
            "ARm": self._ar(area="medium"),
            "ARl": self._ar(area="large"),
        }
        lines = [
            f" Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ] = {s['AP']:.3f}",
            f" Average Precision  (AP) @[ IoU=0.50      | area=   all | maxDets=100 ] = {s['AP50']:.3f}",
            f" Average Precision  (AP) @[ IoU=0.75      | area=   all | maxDets=100 ] = {s['AP75']:.3f}",
            f" Average Precision  (AP) @[ IoU=0.50:0.95 | area= small | maxDets=100 ] = {s['APs']:.3f}",
            f" Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ] = {s['APm']:.3f}",
            f" Average Precision  (AP) @[ IoU=0.50:0.95 | area= large | maxDets=100 ] = {s['APl']:.3f}",
            f" Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=  1 ] = {s['AR1']:.3f}",
            f" Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets= 10 ] = {s['AR10']:.3f}",
            f" Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ] = {s['AR100']:.3f}",
            f" Average Recall     (AR) @[ IoU=0.50:0.95 | area= small | maxDets=100 ] = {s['ARs']:.3f}",
            f" Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ] = {s['ARm']:.3f}",
            f" Average Recall     (AR) @[ IoU=0.50:0.95 | area= large | maxDets=100 ] = {s['ARl']:.3f}",
        ]
        out = "\n".join(lines)
        if logger:
            logger.info("\n" + out)
        else:
            print(out)
        return s
