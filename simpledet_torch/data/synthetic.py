"""Synthetic datasets made from a seed with numpy and cv2: the port's own
copies of `tests/fixtures.py::make_micro_dataset` (the 16-image set that
`config/converge_test.py` overfits) and
`tools/train_flagship_curve.py::make_synth_coco` (the 800 x 1200 COCO-shaped
set of `config/flagship_synth_curve.py`). Each writes JPEG images, a COCO
annotation json and roidb pickles (the port's `data/roidb.save_roidb`) under
`root`; the same seed gives the same images and records as the originals.
"""
import json
import os

import numpy as np

from simpledet_torch.data.roidb import save_roidb


def ellipse_polygon(x1, y1, x2, y2, n=16):
    """[n, 2] float64 vertices of the ellipse inscribed in the box (x1, y1,
    x2, y2), counter-clockwise in image coordinates from its right end."""
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    rx, ry = (x2 - x1) / 2.0, (y2 - y1) / 2.0
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], 1)


def make_micro_dataset(root, n_images=8, seed=0,
                       set_names=("micro_train", "micro_val"),
                       shapes="rect"):
    """Writes jpgs + roidb pickles + a COCO annotation json under `root`.
    Returns (roidb, annotation_path). Images alternate orientation.

    shapes="ellipse" paints inscribed ellipses (16-gon polygons) instead
    of filled rectangles: segm IoU(ellipse, box) ~ pi/4 ~ 0.785, so a mask
    head that merely predicts "everything inside the box is foreground"
    caps out below segm AP75 — the overfit gate then tests real mask-shape
    learning, not box-filling."""
    import cv2

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)

    images, annotations, roidb = [], [], []
    ann_id = 1
    for i in range(n_images):
        if i % 2 == 0:
            h, w = 160, 224
        else:
            h, w = 224, 160
        img = rng.randint(0, 80, (h, w, 3), np.uint8)
        boxes, classes, obj_polys = [], [], []
        for j in range(rng.randint(1, 4)):
            bw, bh = rng.randint(30, 80), rng.randint(30, 80)
            x1 = rng.randint(0, w - bw)
            y1 = rng.randint(0, h - bh)
            cls = int(rng.randint(1, 4))
            color = [(255, 64, 64), (64, 255, 64), (64, 64, 255)][cls - 1]
            x2, y2 = x1 + bw - 1, y1 + bh - 1
            if shapes == "ellipse":
                poly = ellipse_polygon(x1, y1, x2, y2)
                cv2.fillPoly(img, [np.round(poly).astype(np.int32)], color)
                obj_polys.append([float(v) for v in poly.reshape(-1)])
            else:
                cv2.rectangle(img, (x1, y1), (x1 + bw, y1 + bh), color, -1)
                obj_polys.append(None)
            boxes.append([x1, y1, x2, y2])
            classes.append(cls)
        path = os.path.join(img_dir, f"im{i}.jpg")
        cv2.imwrite(path, img[:, :, ::-1])
        images.append({"id": i + 1, "file_name": f"im{i}.jpg",
                       "height": h, "width": w})
        polys = []
        for b, c, op in zip(boxes, classes, obj_polys):
            x1, y1, x2, y2 = b
            if op is not None:
                poly = op
            else:
                # rectangle polygon matching the painted box (xy interleaved)
                poly = [float(x1), float(y1), float(x2), float(y1),
                        float(x2), float(y2), float(x1), float(y2)]
            polys.append([poly])
            annotations.append({
                "id": ann_id, "image_id": i + 1, "category_id": c,
                "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                "area": (x2 - x1 + 1) * (y2 - y1 + 1), "iscrowd": 0,
                "segmentation": [poly],
            })
            ann_id += 1
        roidb.append({
            "image_url": path, "im_id": i + 1, "h": h, "w": w,
            "gt_class": classes,
            "gt_bbox": [[float(v) for v in b] for b in boxes],
            "gt_poly": polys,
            "flipped": False,
        })

    ann = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": c, "name": f"class{c}"} for c in (1, 2, 3)],
    }
    ann_path = os.path.join(root, "annotations.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    for name in set_names:
        save_roidb(roidb, name, cache_dir=os.path.join(root, "cache"))
    return roidb, ann_path


def make_synth_coco(root, n_images=48, seed=0):
    """COCO-shaped images (800x1200 / 1200x800) with solid colored boxes;
    same roidb schema as utils/create_coco_roidb.py."""
    import cv2

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations, roidb = [], [], []
    ann_id = 1
    for i in range(n_images):
        h, w = (800, 1200) if i % 2 == 0 else (1200, 800)
        img = rng.randint(0, 60, (h, w, 3), np.uint8)
        boxes, classes = [], []
        for _ in range(rng.randint(2, 8)):
            bw, bh = rng.randint(60, 400), rng.randint(60, 400)
            x1 = rng.randint(0, w - bw)
            y1 = rng.randint(0, h - bh)
            # class is a deterministic function of color (like the micro
            # fixture, tests/fixtures.py:34-36) so the classification loss
            # CAN descend — with random colors bbox_cls plateaus at the
            # class prior and the curve proves nothing about learning
            cls = int(rng.randint(1, 81))
            color = ((37 * cls) % 200 + 55, (91 * cls) % 200 + 55,
                     (151 * cls) % 200 + 55)
            cv2.rectangle(img, (x1, y1), (x1 + bw, y1 + bh), color, -1)
            boxes.append([x1, y1, x1 + bw - 1, y1 + bh - 1])
            classes.append(cls)
        path = os.path.join(img_dir, f"im{i}.jpg")
        cv2.imwrite(path, img[:, :, ::-1])
        images.append({"id": i + 1, "file_name": f"im{i}.jpg",
                       "height": h, "width": w})
        for b, c in zip(boxes, classes):
            x1, y1, x2, y2 = b
            annotations.append({
                "id": ann_id, "image_id": i + 1, "category_id": c,
                "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                "area": (x2 - x1 + 1) * (y2 - y1 + 1), "iscrowd": 0})
            ann_id += 1
        roidb.append({"image_url": path, "im_id": i + 1, "h": h, "w": w,
                      "gt_class": classes,
                      "gt_bbox": [[float(v) for v in b] for b in boxes],
                      "flipped": False})
    with open(os.path.join(root, "annotations.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": f"c{c}"}
                                  for c in range(1, 81)]}, f)
    save_roidb(roidb, "flagship_synth", cache_dir=os.path.join(root, "cache"))
