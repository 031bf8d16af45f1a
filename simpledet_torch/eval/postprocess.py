"""Test-time per-class NMS (counterpart of
simpledet_tpu/eval/postprocess.py::per_class_nms with nms_type="nms").

Batched over images: every (image, foreground class) pair is one problem of a
single NMS call, then each image keeps its global top `max_det`. A Cascade
R-CNN's test outputs come in the same layout: its averaged probabilities as
cls_score and its class-agnostic stage-3 boxes tiled over the classes.
"""
import torch

from simpledet_torch.ops.nms import NEG_INF, nms, top_k_stable


def per_class_nms(cls_score, bbox_xyxy, *, score_thr=0.05, nms_thr=0.5,
                  max_per_class=100, max_det=100):
    """cls_score [B, R, C] (background column 0 included), bbox_xyxy
    [B, R, 4*C] -> (boxes [B, max_det, 4], scores [B, max_det], classes
    [B, max_det] int64 in 1..C-1, valid [B, max_det]), sorted by score."""
    b, r, c = cls_score.shape
    n_cls = c - 1
    fg_scores = cls_score[:, :, 1:].transpose(1, 2).reshape(b * n_cls, r)
    fg_boxes = (bbox_xyxy.reshape(b, r, c, 4)[:, :, 1:]
                .transpose(1, 2).reshape(b * n_cls, r, 4))
    ob, osc, _, ov = nms(fg_boxes, fg_scores, nms_thr, max_per_class,
                         valid=fg_scores >= score_thr)
    k = ob.shape[1]
    flat_scores = torch.where(ov, osc, torch.full_like(osc, NEG_INF))
    flat_scores = flat_scores.reshape(b, n_cls * k)
    flat_boxes = ob.reshape(b, n_cls * k, 4)
    cls_ids = torch.arange(1, c, device=cls_score.device).repeat_interleave(k)

    top_scores, idx = top_k_stable(flat_scores, max_det)
    keep = top_scores > NEG_INF / 2
    boxes = torch.gather(flat_boxes, 1, idx[..., None].expand(-1, -1, 4))
    out_boxes = torch.where(keep[..., None], boxes, torch.zeros_like(boxes))
    out_cls = torch.where(keep, cls_ids[idx], torch.zeros_like(idx))
    return (out_boxes, torch.where(keep, top_scores,
                                   torch.zeros_like(top_scores)),
            out_cls, keep)
