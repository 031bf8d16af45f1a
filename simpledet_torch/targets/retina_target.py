"""Dense RetinaNet anchor targets on the device (counterpart of
simpledet_tpu/targets/retina_target.py).

Every anchor gets a class label (0 background, k >= 1 class k, -1 ignore);
regression targets are encoded against each anchor's best gt for all
anchors, and weighted 1 only for the positives. There is no subsampling:
the losses divide by the foreground count. Anchors are the concatenated
(level, y, x, anchor) grid; gt boxes come padded to [G, 5] with class -1
rows, and class -2 marks an ignore region, which no anchor matches.
"""
import torch

from simpledet_torch.ops.bbox import bbox_overlaps, encode_boxes


def retina_anchor_target(anchors, gt_bbox, im_hw, *, allowed_border=9999,
                         neg_thr=0.4, pos_thr=0.5, min_pos_thr=0.0):
    """One image. anchors [N, 4], gt_bbox [G, 5], im_hw [2] (h, w) ->
    (label [N] float, reg_target [N, 4], reg_weight [N, 4], fg_count: the
    positives, at least 1, a float scalar)."""
    valid = ((anchors[:, 0] >= -allowed_border)
             & (anchors[:, 1] >= -allowed_border)
             & (anchors[:, 2] < im_hw[1] + allowed_border)
             & (anchors[:, 3] < im_hw[0] + allowed_border))
    gt_valid = gt_bbox[:, 4] > 0          # -1 padding, -2 ignore region
    num_gt = gt_valid.sum()

    ov = bbox_overlaps(anchors, gt_bbox[:, :4])             # [N, G]
    ov = torch.where(gt_valid[None, :] & valid[:, None], ov,
                     torch.full_like(ov, -1.0))
    max_ov, arg_ov = ov.max(dim=1)     # first of tied maxima, as jnp.argmax
    gt_max = ov.max(dim=0).values
    # an anchor that reaches a gt's best IoU takes the class of the first
    # such gt (argmax over a bool needs an integer cast; it takes the first
    # maximum, as jnp.argmax does)
    best_hits = ((ov == gt_max[None, :]) & (ov >= min_pos_thr)
                 & gt_valid[None, :])
    del ov
    is_gt_best = best_hits.any(dim=1)
    best_cls = gt_bbox[best_hits.to(torch.uint8).argmax(dim=1), 4]
    matched_cls = gt_bbox[arg_ov, 4]

    neg_one = torch.full_like(max_ov, -1.0)
    label = torch.where(max_ov < neg_thr, torch.zeros_like(max_ov), neg_one)
    label = torch.where(is_gt_best, best_cls, label)
    label = torch.where(max_ov >= pos_thr, matched_cls, label)
    label = torch.where(num_gt == 0, torch.zeros_like(label), label)
    label = torch.where(valid, label, neg_one)

    target = encode_boxes(anchors, gt_bbox[arg_ov, :4])
    target = torch.where(num_gt > 0, target, torch.zeros_like(target))
    fg = label >= 1.0
    weight = fg[:, None].float().expand(-1, 4)
    fg_count = fg.sum().clamp(min=1).float()
    return label, target, weight, fg_count


def batched_retina_anchor_target(anchors, gt_bbox, im_hw, **kw):
    """Per image of gt_bbox [B, G, 5] and im_hw [B, 2], stacked: fg_count
    is [B], each image's count at least 1 before any sum over images."""
    outs = [retina_anchor_target(anchors, g, hw, **kw)
            for g, hw in zip(gt_bbox, im_hw)]
    return tuple(torch.stack(t) for t in zip(*outs))
