"""roidb creation and loading: a copy of `simpledet_tpu/data/roidb.py`
(the same pickle schema), kept in the port so that it imports nothing of the
JAX package.

A roidb is a list of dicts: {image_url, im_id, h, w, gt_class [N] (contiguous
1..80 for COCO), gt_bbox [N, 4] xyxy, gt_poly (optional), flipped}.
create_coco_roidb parses the COCO annotation json directly; append_flipped
duplicates records with flipped=True, as detection_train.py does.
"""
import json
import os
import pickle


def load_roidb(image_sets, cache_dir="data/cache"):
    roidb = []
    for s in image_sets:
        with open(os.path.join(cache_dir, s + ".roidb"), "rb") as f:
            roidb.extend(pickle.load(f))
    return roidb


def save_roidb(roidb, name, cache_dir="data/cache"):
    os.makedirs(cache_dir, exist_ok=True)
    with open(os.path.join(cache_dir, name + ".roidb"), "wb") as f:
        pickle.dump(roidb, f)


def append_flipped(roidb):
    """Duplicate records with flipped=True (detection_train.py:70-76); boxes
    are flipped at load time by the Flip transform."""
    flipped = []
    for r in roidb:
        r2 = dict(r)
        r2["flipped"] = True
        flipped.append(r2)
    return roidb + flipped


def create_coco_roidb(annotation_json, image_dir, with_poly=False,
                      include_crowd=False):
    """COCO instances json -> roidb (reference utils/create_coco_roidb.py:25-89).

    Category ids are remapped to contiguous 1..K sorted by original id;
    class 0 is background. Images without annotations are kept (filtered at
    train time like the reference's valid-image filtering).

    include_crowd: the reference drops iscrowd=1 instances entirely
    (getAnnIds(iscrowd=False), create_coco_roidb.py:38). With
    include_crowd=True, crowd boxes are kept as IGNORE regions (class -2,
    the crowdhuman convention the target assigners understand: anchors
    covering them train as neither fg nor bg, and they are excluded from
    proposal sampling). Their RLE segmentations pass through; the mask
    transforms decode them (simpledet_tpu/data/rle.py).
    """
    with open(annotation_json) as f:
        coco = json.load(f)

    cat_ids = sorted(c["id"] for c in coco["categories"])
    cat_to_contiguous = {cid: i + 1 for i, cid in enumerate(cat_ids)}

    anns_by_img = {}
    for a in coco.get("annotations", []):
        if not include_crowd and a.get("iscrowd", 0):
            continue
        anns_by_img.setdefault(a["image_id"], []).append(a)

    roidb = []
    for img in coco["images"]:
        anns = anns_by_img.get(img["id"], [])
        gt_class, gt_bbox, gt_poly = [], [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            # xywh -> xyxy, clipped (reference clips to [0, dim-1])
            x1 = min(max(x, 0), img["width"] - 1)
            y1 = min(max(y, 0), img["height"] - 1)
            x2 = min(max(x + w - 1, 0), img["width"] - 1)
            y2 = min(max(y + h - 1, 0), img["height"] - 1)
            if x2 <= x1 or y2 <= y1:
                continue
            crowd = bool(a.get("iscrowd", 0))
            gt_class.append(-2 if crowd
                            else cat_to_contiguous[a["category_id"]])
            gt_bbox.append([x1, y1, x2, y2])
            if with_poly:
                seg = a.get("segmentation")
                if isinstance(seg, (list, dict)):
                    gt_poly.append(seg)
                else:
                    gt_poly.append([])
        rec = {
            "image_url": os.path.join(image_dir, img["file_name"]),
            "im_id": img["id"],
            "h": img["height"],
            "w": img["width"],
            "gt_class": gt_class,
            "gt_bbox": gt_bbox,
            "flipped": False,
        }
        if with_poly:
            rec["gt_poly"] = gt_poly
        roidb.append(rec)
    return roidb
