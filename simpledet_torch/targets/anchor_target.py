"""RPN anchor targets on the device (counterpart of
simpledet_tpu/targets/anchor_target.py).

Anchors are the concatenated constant grid [N, 4] in (y, x, anchor) order;
gt boxes come padded to [G, 5] with class -1 rows, and class -2 marks an
ignore region. An anchor is positive if it reaches the per-gt max IoU of any
gt (the reference's gt-argmax quirk) or IoU >= pos_thr; regression targets
are computed only for the kept positives.
"""
import torch

from simpledet_torch.ops.bbox import bbox_overlaps, encode_boxes
from simpledet_torch.targets.sampling import subsample_labels


def anchor_target(gen, anchors, gt_bbox, im_hw, *, allowed_border=0,
                  neg_thr=0.3, pos_thr=0.7, min_pos_thr=0.0, image_anchor=256,
                  fg_fraction=0.5, deterministic=False, bbox_mean=None,
                  bbox_std=None, ignore_regions=True):
    """One image. anchors [N, 4], gt_bbox [G, 5], im_hw [2] (h, w) ->
    (label [N] float {-1, 0, 1}, reg_target [N, 4], reg_weight [N, 4])."""
    n = anchors.shape[0]
    valid = ((anchors[:, 0] >= -allowed_border)
             & (anchors[:, 1] >= -allowed_border)
             & (anchors[:, 2] < im_hw[1] + allowed_border)
             & (anchors[:, 3] < im_hw[0] + allowed_border))
    gt_valid = gt_bbox[:, 4] > 0
    num_gt = gt_valid.sum()

    ov = bbox_overlaps(anchors, gt_bbox[:, :4])             # [N, G]
    ov = torch.where(gt_valid[None, :] & valid[:, None], ov,
                     torch.full_like(ov, -1.0))
    max_ov, arg_ov = ov.max(dim=1)     # first of tied maxima, as jnp.argmax
    gt_max = ov.max(dim=0).values

    is_gt_best = ((ov == gt_max[None, :]) & (ov >= min_pos_thr)
                  & gt_valid[None, :]).any(dim=1)
    del ov
    one, zero = torch.ones_like(max_ov), torch.zeros_like(max_ov)
    label = torch.where(max_ov < neg_thr, zero, -one)
    label = torch.where(is_gt_best | (max_ov >= pos_thr), one, label)
    label = torch.where(num_gt == 0, zero, label)
    label = torch.where(valid, label, -one)

    if ignore_regions:
        # anchors covering an ignore region (intersection / anchor area > 0.5)
        # do not train as background
        ignore_gt = gt_bbox[:, 4] == -2
        g = gt_bbox[None, :, :4]
        iw = (torch.minimum(anchors[:, 2:3], g[..., 2])
              - torch.maximum(anchors[:, 0:1], g[..., 0]) + 1)
        ih = (torch.minimum(anchors[:, 3:4], g[..., 3])
              - torch.maximum(anchors[:, 1:2], g[..., 1]) + 1)
        inter = iw.clamp(min=0) * ih.clamp(min=0)
        a_area = ((anchors[:, 2] - anchors[:, 0] + 1)
                  * (anchors[:, 3] - anchors[:, 1] + 1))[:, None]
        iof = torch.where(ignore_gt[None, :], inter / a_area.clamp(min=1.0),
                          torch.zeros_like(inter))
        hit = iof.max(dim=1).values > 0.5
        label = torch.where(ignore_gt.any() & hit & (label == 0), -one, label)

    label, fg_idx = subsample_labels(gen, label, image_anchor, fg_fraction,
                                     deterministic=deterministic,
                                     return_fg_idx=True)

    # targets of the kept positives only; rows padded with n are dropped
    fg_idx = torch.where(num_gt > 0, fg_idx, torch.full_like(fg_idx, n))
    keep = fg_idx < n
    rows = fg_idx[keep]
    t = encode_boxes(anchors[rows], gt_bbox[arg_ov[rows], :4],
                     means=bbox_mean, stds=bbox_std)
    target = torch.zeros(n, 4, device=anchors.device)
    weight = torch.zeros(n, 4, device=anchors.device)
    target[rows] = t
    weight[rows] = 1.0
    return label, target, weight


def batched_anchor_target(gen, anchors, gt_bbox, im_hw, **kw):
    """Per image of gt_bbox [B, G, 5] and im_hw [B, 2], stacked; the images
    draw their priorities from `gen` in turn."""
    outs = [anchor_target(gen, anchors, g, hw, **kw)
            for g, hw in zip(gt_bbox, im_hw)]
    return tuple(torch.stack(t) for t in zip(*outs))
