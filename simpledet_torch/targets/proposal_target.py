"""RoI sampling and per-class regression targets on the device (counterpart
of simpledet_tpu/targets/proposal_target.py::proposal_target).

  - padded rois are rows with y2 == 0; padded gt are rows with class -1 (and
    class -2, an ignore region, is not sampled);
  - gt boxes join the candidates unless proposal_wo_gt;
  - fg: IoU >= fg_thr, at most image_rois * fg_fraction at random; bg: IoU
    in [bg_thr_lo, bg_thr_hi), filling the rest;
  - too few candidates: the rows wrap around the non-fg pool;
  - rows come fg first; targets are per class, 4 per class, normalised by
    (mean, std).
"""
import torch

from simpledet_torch.ops.bbox import bbox_overlaps, encode_boxes
from simpledet_torch.targets.sampling import random_rank


def proposal_target(gen, rois, gt_bbox, *, image_rois, fg_fraction, fg_thr,
                    bg_thr_hi, bg_thr_lo, num_reg_class, class_agnostic=False,
                    proposal_wo_gt=False, bbox_mean=(0., 0., 0., 0.),
                    bbox_std=(0.1, 0.1, 0.2, 0.2),
                    bbox_weight=(1., 1., 1., 1.), deterministic=False,
                    output_iou=False):
    """One image. rois [R, 4] zero-padded, gt_bbox [G, 5] -> dict of rois
    [image_rois, 4], label [image_rois], bbox_target and bbox_weight
    [image_rois, 4 * num_reg_class], fg_mask, gt_index (-1 off fg) and, with
    output_iou, match_gt_iou."""
    dev = rois.device
    gt_valid = gt_bbox[:, 4] > 0
    num_gt = gt_valid.sum()
    if proposal_wo_gt:
        all_rois, all_valid = rois, rois[:, 3] > 0
    else:
        all_rois = torch.cat([rois, gt_bbox[:, :4]])
        all_valid = torch.cat([rois[:, 3] > 0, gt_valid])
    n = all_rois.shape[0]

    ov = bbox_overlaps(all_rois, gt_bbox[:, :4])
    ov = torch.where(gt_valid[None, :], ov, torch.full_like(ov, -1.0))
    max_ov, arg_ov = ov.max(dim=1)
    max_ov = torch.where(num_gt > 0, max_ov, torch.zeros_like(max_ov))
    max_ov = torch.where(all_valid, max_ov, torch.full_like(max_ov, -1.0))

    fg_num = int(image_rois * fg_fraction)
    fg_mask = all_valid & (max_ov >= fg_thr)
    bg_mask = all_valid & (max_ov >= bg_thr_lo) & (max_ov < bg_thr_hi)
    neg_mask = all_valid & ~fg_mask                         # pad pool

    fg_rank = random_rank(gen, fg_mask, deterministic)
    keep_fg = fg_mask & (fg_rank < fg_num)
    n_fg = keep_fg.sum()
    bg_rank = random_rank(gen, bg_mask, deterministic)
    keep_bg = bg_mask & (bg_rank < image_rois - n_fg)
    n_bg = keep_bg.sum()

    # selection order: kept fg by rank, kept bg, then the pad pool
    big = float(n)
    pad_rank = random_rank(gen, neg_mask, deterministic)
    prio = torch.where(
        keep_fg, fg_rank.float(), torch.where(
            keep_bg, big + bg_rank.float(), torch.where(
                neg_mask, 2 * big + pad_rank.float(),
                torch.full_like(max_ov, float("inf")))))
    order = torch.argsort(prio, stable=True)
    n_pad_pool = (neg_mask & ~keep_bg).sum()
    n_selectable = n_fg + n_bg + n_pad_pool
    pick = torch.arange(image_rois, device=dev)
    wrapped = n_fg + n_bg + torch.remainder(pick - (n_fg + n_bg),
                                            n_pad_pool.clamp(min=1))
    in_pool = pick < n_selectable
    sel = order[torch.where(in_pool, pick, wrapped)]
    fillable = in_pool | (n_pad_pool > 0)     # else the row stays zero

    sel_rois = torch.where(fillable[:, None], all_rois[sel],
                           torch.zeros_like(all_rois[sel]))
    is_fg = (pick < n_fg) & fillable
    gt_idx = arg_ov[sel]
    zero = torch.zeros(image_rois, device=dev)
    label = torch.where(is_fg & (num_gt > 0), gt_bbox[gt_idx, 4], zero)

    targets = encode_boxes(sel_rois, gt_bbox[gt_idx, :4], means=bbox_mean,
                           stds=bbox_std)
    targets = torch.where(is_fg[:, None], targets, torch.zeros_like(targets))
    reg_cls = (label.clamp(max=1.0) if class_agnostic else label).long()
    onehot = (reg_cls[:, None] == torch.arange(num_reg_class, device=dev)
              ).float()
    weight_rows = torch.where(
        is_fg[:, None], torch.tensor(bbox_weight, device=dev)[None, :],
        torch.zeros(image_rois, 4, device=dev))
    out = {
        "rois": sel_rois,
        "label": label,
        "bbox_target": (onehot[:, :, None] * targets[:, None, :]).reshape(
            image_rois, num_reg_class * 4),
        "bbox_weight": (onehot[:, :, None] * weight_rows[:, None, :]).reshape(
            image_rois, num_reg_class * 4),
        "fg_mask": is_fg,
    }
    if output_iou:
        out["match_gt_iou"] = torch.where(fillable & (num_gt > 0),
                                          max_ov[sel].clamp(min=0.0), zero)
    out["gt_index"] = torch.where(is_fg, gt_idx, torch.full_like(gt_idx, -1))
    return out


def batched_proposal_target(gen, rois, gt_bbox, **kw):
    """Per image of rois [B, R, 4] and gt_bbox [B, G, 5], stacked; the images
    draw their priorities from `gen` in turn."""
    outs = [proposal_target(gen, r, g, **kw) for r, g in zip(rois, gt_bbox)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
