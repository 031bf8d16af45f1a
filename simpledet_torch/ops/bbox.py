"""Box geometry on tensors: legacy +1 widths, Detectron-style delta clip.

Counterpart of `simpledet_tpu/ops/bbox.py`. Boxes are [..., N, 4] in
(x1, y1, x2, y2) order; widths are x2 - x1 + 1.
"""
import math

import torch

# Detectron-convention clip on dw/dh so exp() can't overflow.
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def bbox_overlaps(boxes, query_boxes):
    """IoU matrix between boxes [..., N, 4] and query_boxes [..., K, 4]."""
    b = boxes[..., :, None, :]
    q = query_boxes[..., None, :, :]
    iw = torch.minimum(b[..., 2], q[..., 2]) - torch.maximum(b[..., 0], q[..., 0]) + 1.0
    ih = torch.minimum(b[..., 3], q[..., 3]) - torch.maximum(b[..., 1], q[..., 1]) + 1.0
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    area_q = (q[..., 2] - q[..., 0] + 1.0) * (q[..., 3] - q[..., 1] + 1.0)
    union = area_b + area_q - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _ctr_wh(boxes):
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return boxes[..., 0] + 0.5 * (w - 1.0), boxes[..., 1] + 0.5 * (h - 1.0), w, h


def encode_boxes(ex_rois, gt_rois, means=None, stds=None):
    """Regression targets from ex_rois to gt_rois, both [..., N, 4] ->
    [..., N, 4], normalised by (means, stds) when given."""
    ex_cx, ex_cy, ex_w, ex_h = _ctr_wh(ex_rois)
    gt_cx, gt_cy, gt_w, gt_h = _ctr_wh(gt_rois)
    dx = (gt_cx - ex_cx) / (ex_w + 1e-14)
    dy = (gt_cy - ex_cy) / (ex_h + 1e-14)
    dw = torch.log(gt_w.clamp(min=1e-14) / ex_w.clamp(min=1e-14))
    dh = torch.log(gt_h.clamp(min=1e-14) / ex_h.clamp(min=1e-14))
    t = torch.stack([dx, dy, dw, dh], dim=-1)
    if means is not None:
        t = t - torch.tensor(means, dtype=t.dtype, device=t.device)
    if stds is not None:
        t = t / torch.tensor(stds, dtype=t.dtype, device=t.device)
    return t


def decode_boxes(boxes, deltas, means=None, stds=None,
                 xform_clip=BBOX_XFORM_CLIP):
    """Apply deltas [..., N, 4*C] to boxes [..., N, 4] -> [..., N, 4*C]."""
    shp = deltas.shape
    d = deltas.reshape(shp[:-1] + (shp[-1] // 4, 4))
    if stds is not None:
        d = d * torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    if means is not None:
        d = d + torch.tensor(means, dtype=deltas.dtype, device=deltas.device)
    cx, cy, w, h = _ctr_wh(boxes)
    dw = d[..., 2].clamp(max=xform_clip)
    dh = d[..., 3].clamp(max=xform_clip)
    pred_cx = d[..., 0] * w[..., None] + cx[..., None]
    pred_cy = d[..., 1] * h[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * w[..., None]
    pred_h = torch.exp(dh) * h[..., None]
    out = torch.stack([
        pred_cx - 0.5 * (pred_w - 1.0),
        pred_cy - 0.5 * (pred_h - 1.0),
        pred_cx + 0.5 * (pred_w - 1.0),
        pred_cy + 0.5 * (pred_h - 1.0),
    ], dim=-1)
    return out.reshape(shp)


def clip_boxes(boxes, im_hw):
    """Clip boxes [..., 4*C] to [0, dim-1]. im_hw: [..., 2] (h, w) tensor whose
    leading dims align with the leading dims of boxes."""
    shp = boxes.shape
    b = boxes.reshape(shp[:-1] + (shp[-1] // 4, 4))
    h = im_hw[..., 0]
    w = im_hw[..., 1]
    while h.dim() < b.dim() - 1:
        h = h[..., None]
        w = w[..., None]
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    x1 = torch.minimum(torch.maximum(b[..., 0], zero), w - 1.0)
    y1 = torch.minimum(torch.maximum(b[..., 1], zero), h - 1.0)
    x2 = torch.minimum(torch.maximum(b[..., 2], zero), w - 1.0)
    y2 = torch.minimum(torch.maximum(b[..., 3], zero), h - 1.0)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(shp)
