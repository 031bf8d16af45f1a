"""Host-side polygon transforms of the mask configs: a copy of
`simpledet_tpu/data/mask_transforms.py`, kept in the port so that it imports
nothing of the JAX package.

The chain (`config/mask_r50v1_fpn_1x.py`): PreprocessGtPoly (RLE instances
decoded and traced back to polygons), Resize2DImageBboxMask,
Flip2DImageBboxMask, Pad2DImageBboxMask (polygons stay a list of arrays),
then EncodeGtPoly packs each image's polygons into the fixed edge tensor
[max_num_gt, max_len_gt_poly // 2, 5] of (xa, ya, xb, yb, seg_id) rows,
padded with seg_id = -1, that the on-device rasterizer
(`targets/mask_target.py`) reads. Images stay uint8, as in the rest of the
port's chain.
"""
import numpy as np

from simpledet_torch.data.transforms import DetectionAugmentation

NUM_SEG = 8         # segments an instance keeps (the rasterizer's one-hot)


class PreprocessGtPoly(DetectionAugmentation):
    """roidb gt_poly [[flat xy list]] -> [[float32 ndarray]]; an RLE
    segmentation is decoded and traced back to its contour polygons."""

    def apply(self, r):
        from simpledet_torch.data.rle import decode_rle, mask_to_polygons

        out = []
        for inst in r.get("gt_poly", []):
            if isinstance(inst, dict):          # RLE segmentation
                inst = mask_to_polygons(decode_rle(inst))
            out.append([np.asarray(s, np.float32) for s in (inst or [])])
        r["gt_poly"] = out
        return r


class Resize2DImageBboxMask(DetectionAugmentation):
    """Resize the image, boxes and polygons by the short/long rule."""

    def __init__(self, pResize):
        self.short = pResize.short
        self.long = pResize.long

    def apply(self, r):
        import cv2

        img = r["image"]
        h, w = img.shape[:2]
        scale = min(self.short / min(h, w), self.long / max(h, w))
        nh, nw = int(round(h * scale)), int(round(w * scale))
        r["image"] = cv2.resize(img, (nw, nh),
                                interpolation=cv2.INTER_LINEAR)
        if len(r["gt_bbox"]):
            bb = r["gt_bbox"] * scale
            bb[:, [0, 2]] = np.clip(bb[:, [0, 2]], 0, nw - 1)
            bb[:, [1, 3]] = np.clip(bb[:, [1, 3]], 0, nh - 1)
            r["gt_bbox"] = bb
        r["gt_poly"] = [[s * scale for s in inst] for inst in r["gt_poly"]]
        r["im_info"] = np.array([nh, nw, scale], np.float32)
        return r


class Flip2DImageBboxMask(DetectionAugmentation):
    """Horizontal flip of the image, boxes and polygons when
    record['flipped']."""

    def apply(self, r):
        if not r.get("flipped"):
            return r
        img = r["image"]
        w = img.shape[1]
        r["image"] = img[:, ::-1]
        if len(r["gt_bbox"]):
            bb = r["gt_bbox"].copy()
            x1 = bb[:, 0].copy()
            bb[:, 0] = w - 1 - bb[:, 2]
            bb[:, 2] = w - 1 - x1
            r["gt_bbox"] = bb

        def flip_poly(p):
            q = p.copy()
            q[0::2] = w - 1 - p[0::2]
            return q

        r["gt_poly"] = [[flip_poly(s) for s in inst] for inst in r["gt_poly"]]
        return r


class Pad2DImageBboxMask(DetectionAugmentation):
    """Pad the image to the batch's fixed shape and the gt to max_num_gt
    rows of -1 (the class in column 4); the polygons are cut to max_num_gt
    instances and stay a list (EncodeGtPoly makes the tensor)."""

    def __init__(self, pPad):
        self.short = pPad.short
        self.long = pPad.long
        self.max_num_gt = pPad.max_num_gt

    def apply(self, r):
        img = r["image"]
        h, w = img.shape[:2]
        ph, pw = (self.long, self.short) if h >= w else (self.short, self.long)
        out = np.zeros((ph, pw, 3), img.dtype)
        out[:h, :w] = img
        r["image"] = out

        gt = np.full((self.max_num_gt, 5), -1, np.float32)
        n = min(len(r["gt_bbox"]), self.max_num_gt)
        if n:
            gt[:n, :4] = r["gt_bbox"][:n]
            gt[:n, 4] = r["gt_class"][:n]
        r["gt_bbox"] = gt
        r["gt_poly"] = r["gt_poly"][:self.max_num_gt]
        return r


def polys_to_edges(instance_polys, max_edges, num_seg=NUM_SEG):
    """[ndarray (flat xy)] -> [max_edges, 5] (xa, ya, xb, yb, seg_id): each
    closed polygon of at least 3 vertices as its edges, its index as seg_id,
    the first num_seg polygons, -1 rows after the last edge."""
    rows = np.full((max_edges, 5), -1, np.float32)
    k = 0
    for sid, poly in enumerate(instance_polys[:num_seg]):
        pts = poly.reshape(-1, 2)
        n = len(pts)
        if n < 3:
            continue
        for j in range(n):
            if k >= max_edges:
                return rows
            a = pts[j]
            b = pts[(j + 1) % n]
            rows[k] = [a[0], a[1], b[0], b[1], sid]
            k += 1
    return rows


class EncodeGtPoly(DetectionAugmentation):
    """Pack each image's polygons into the edge tensor [max_num_gt,
    max_edges, 5]; max_edges is PadParam's max_poly_edges, or
    max_len_gt_poly // 2 as the reference configs set it (1000 // 2
    without either)."""

    def __init__(self, pPad, num_seg=NUM_SEG):
        self.max_num_gt = pPad.max_num_gt
        max_edges = getattr(pPad, "max_poly_edges", None)
        if not max_edges:
            max_edges = (getattr(pPad, "max_len_gt_poly", None) or 1000) // 2
        self.max_edges = int(max_edges)
        self.num_seg = num_seg

    def apply(self, r):
        out = np.full((self.max_num_gt, self.max_edges, 5), -1, np.float32)
        for i, inst in enumerate(r["gt_poly"][:self.max_num_gt]):
            out[i] = polys_to_edges(inst, self.max_edges, self.num_seg)
        r["gt_poly"] = out
        return r
