"""RPN anchor targets on the device (counterpart of
simpledet_tpu/targets/anchor_target.py).

Anchors are the concatenated constant grid [N, 4] in (y, x, anchor) order;
gt boxes come padded to [B, G, 5] with class -1 rows, and class -2 marks an
ignore region. An anchor is positive if it reaches the per-gt max IoU of any
gt (the reference's gt-argmax quirk) or IoU >= pos_thr; regression targets
are computed only for the kept positives.
"""
import torch

from simpledet_torch.ops.bbox import bbox_overlaps, encode_boxes
from simpledet_torch.targets.sampling import subsample_labels


def batched_anchor_target(gen, anchors, gt_bbox, im_hw, *, allowed_border=0,
                          neg_thr=0.3, pos_thr=0.7, min_pos_thr=0.0,
                          image_anchor=256, fg_fraction=0.5,
                          deterministic=False, bbox_mean=None, bbox_std=None,
                          ignore_regions=True):
    """anchors [N, 4], gt_bbox [B, G, 5], im_hw [B, 2] (h, w) -> (label
    [B, N] float {-1, 0, 1}, reg_target [B, N, 4], reg_weight [B, N, 4]),
    the images in one batch of operations (no per-image loop, no host
    sync); their sampling priorities are drawn from `gen` together."""
    b, n = gt_bbox.shape[0], anchors.shape[0]
    a = anchors[None]
    valid = ((a[..., 0] >= -allowed_border)
             & (a[..., 1] >= -allowed_border)
             & (a[..., 2] < im_hw[:, 1:2] + allowed_border)
             & (a[..., 3] < im_hw[:, 0:1] + allowed_border))     # [B, N]
    gt_valid = gt_bbox[..., 4] > 0                              # [B, G]
    num_gt = gt_valid.sum(-1, keepdim=True)

    ov = bbox_overlaps(anchors, gt_bbox[..., :4])               # [B, N, G]
    ov = torch.where(gt_valid[:, None, :] & valid[..., None], ov,
                     torch.full_like(ov, -1.0))
    max_ov, arg_ov = ov.max(dim=2)     # first of tied maxima, as jnp.argmax
    gt_max = ov.max(dim=1).values

    is_gt_best = ((ov == gt_max[:, None, :]) & (ov >= min_pos_thr)
                  & gt_valid[:, None, :]).any(dim=2)
    del ov
    one, zero = torch.ones_like(max_ov), torch.zeros_like(max_ov)
    label = torch.where(max_ov < neg_thr, zero, -one)
    label = torch.where(is_gt_best | (max_ov >= pos_thr), one, label)
    label = torch.where(num_gt == 0, zero, label)
    label = torch.where(valid, label, -one)

    if ignore_regions:
        # anchors covering an ignore region (intersection / anchor area > 0.5)
        # do not train as background
        ignore_gt = gt_bbox[..., 4] == -2
        g = gt_bbox[:, None, :, :4]
        a4 = anchors[None, :, None, :]
        iw = (torch.minimum(a4[..., 2], g[..., 2])
              - torch.maximum(a4[..., 0], g[..., 0]) + 1)
        ih = (torch.minimum(a4[..., 3], g[..., 3])
              - torch.maximum(a4[..., 1], g[..., 1]) + 1)
        inter = iw.clamp(min=0) * ih.clamp(min=0)
        a_area = ((anchors[:, 2] - anchors[:, 0] + 1)
                  * (anchors[:, 3] - anchors[:, 1] + 1))[None, :, None]
        iof = torch.where(ignore_gt[:, None, :],
                          inter / a_area.clamp(min=1.0),
                          torch.zeros_like(inter))
        hit = iof.max(dim=2).values > 0.5
        label = torch.where(ignore_gt.any(-1, keepdim=True) & hit
                            & (label == 0), -one, label)

    label, fg_idx = subsample_labels(gen, label, image_anchor, fg_fraction,
                                     deterministic=deterministic,
                                     return_fg_idx=True)

    # targets of the kept positives only: fg_idx rows padded with n fall in
    # the extra column, which is dropped
    fg_idx = torch.where(num_gt > 0, fg_idx, torch.full_like(fg_idx, n))
    kept = torch.zeros(b, n + 1, dtype=torch.bool, device=anchors.device)
    kept = kept.scatter(1, fg_idx, torch.ones_like(fg_idx, dtype=torch.bool))
    kept = kept[:, :n, None]
    matched = torch.gather(gt_bbox[..., :4], 1,
                           arg_ov[..., None].expand(-1, -1, 4))
    t = encode_boxes(a.expand(b, -1, -1), matched, means=bbox_mean,
                     stds=bbox_std)
    target = torch.where(kept, t, torch.zeros_like(t))
    return label, target, kept.expand(-1, -1, 4).float()
