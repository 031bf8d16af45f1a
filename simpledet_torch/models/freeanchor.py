"""FreeAnchor (counterpart of simpledet_tpu/models/freeanchor.py): the
learning-to-match losses on RetinaNet's subnets.

- positive loss: per gt, a bag of its pre_anchor_top_n highest-IoU anchors
  (ties to the lower anchor index, as `lax.top_k`: `top_k_stable`); each
  anchor's probability is cls_prob[anchor, gt class] x exp(-0.75 x
  smooth-L1 of its box deltas); the bag's mean-max weighting w = (1 / (1 -
  p)) / sum(1 / (1 - p)); the loss -alpha log(sum w p), over the gt count;
- negative loss: the decoded, clipped boxes' IoU with each gt, a saturated
  linear P(anchor in gt) = clip((IoU - bbox_thr) / (max IoU - bbox_thr)),
  one-hot on the class of each anchor's best gt (the first on ties),
  detached; -(p (1 - P))^gamma log(1 - p (1 - P)) summed, over gt count x
  pre_anchor_top_n, times (1 - alpha);
- test decode: the top pre_nms_top_n anchors by their largest class
  probability (torch.topk), decoded and clipped, each with its full row of
  class probabilities.
Both losses run over the batch in one set of operations. Under a process
group the gt count is summed over the group and each rank's loss scaled by
the world size, as RetinaNet's foreground count is.
"""
import math

import torch

from simpledet_torch.models.retinanet import SMOOTH_L1_SCALAR, RetinaNetHead
from simpledet_torch.ops.bbox import (bbox_overlaps, clip_boxes,
                                      decode_boxes, encode_boxes)
from simpledet_torch.ops.losses import smooth_l1
from simpledet_torch.ops.nms import top_k_stable
from simpledet_torch.parallel.dist import sum_over_group, world_size


def positive_loss(anchors, gt, cls_prob, bbox_pred, *, alpha, top_n, mean,
                  std):
    """anchors [N, 4], gt [B, G, 5], cls_prob [B, N, C-1], bbox_pred
    [B, N, 4] -> each gt's bag loss [B, G] (0 for a padded gt)."""
    b, n, c = cls_prob.shape
    gt_valid = gt[..., 4] > 0
    with torch.no_grad():
        iou = bbox_overlaps(gt[..., :4], anchors)           # [B, G, N]
        iou = torch.where(gt_valid[..., None], iou, torch.full_like(iou, -1.0))
        _, idx = top_k_stable(iou, top_n)                   # [B, G, K]
    g, k = idx.shape[1:]
    cls_idx = torch.clamp(gt[..., 4] - 1, min=0).long()     # [B, G]
    flat = (idx * c + cls_idx[..., None]).reshape(b, -1)
    matched_cls = torch.gather(cls_prob.reshape(b, -1), 1, flat).reshape(
        b, g, k)
    m_anchor = anchors[idx]                                 # [B, G, K, 4]
    m_pred = torch.gather(bbox_pred, 1, idx.reshape(b, -1, 1).expand(
        -1, -1, 4)).reshape(b, g, k, 4)
    target = encode_boxes(m_anchor, gt[..., None, :4] * torch.ones_like(
        m_anchor), means=mean, stds=std)
    bl = smooth_l1(m_pred - target, math.sqrt(1 / SMOOTH_L1_SCALAR)) * 0.75
    box_prob = torch.exp(-bl.sum(-1))                       # [B, G, K]

    p = matched_cls * box_prob
    p = torch.where(gt_valid[..., None], p, torch.ones_like(p))
    w = 1.0 / torch.clamp(1.0 - p, min=1e-12)
    w = w / w.sum(-1, keepdim=True)
    bag = (w * p).sum(-1)                                   # [B, G]
    loss = -alpha * torch.log(torch.clamp(bag, 1e-12, 1.0))
    return torch.where(gt_valid, loss, torch.zeros_like(loss))


def negative_loss(anchors, gt, cls_prob, bbox_pred, im_info, *, alpha,
                  gamma, bbox_thr, mean, std):
    """The negative loss of each image [B] (before its normalisation)."""
    nfg = cls_prob.shape[-1]
    with torch.no_grad():
        gt_valid = gt[..., 4] > 0
        pred = clip_boxes(decode_boxes(anchors, bbox_pred, means=mean,
                                       stds=std), im_info[:, :2])
        iou = bbox_overlaps(gt[..., :4], pred)              # [B, G, N]
        iou = torch.where(gt_valid[..., None], iou, torch.zeros_like(iou))
        t2 = torch.clamp(iou.amax(-1, keepdim=True), min=bbox_thr + 1e-12)
        gt_pred_prob = torch.clamp((iou - bbox_thr) / (t2 - bbox_thr),
                                   0.0, 1.0)
        best, gt_idx = gt_pred_prob.max(dim=1)              # [B, N]
        anchor_cls = torch.gather(gt[..., 4], 1, gt_idx)
        onehot = (anchor_cls.long() - 1)[..., None] == torch.arange(
            nfg, device=gt.device)
        box_prob = torch.where(onehot, best[..., None],
                               torch.zeros_like(cls_prob))
    prob = cls_prob * (1.0 - box_prob)
    prob = torch.where((anchor_cls > 0)[..., None], prob,
                       torch.zeros_like(prob))
    neg = -torch.pow(prob, gamma) * torch.log(torch.clamp(1.0 - prob, 1e-12,
                                                          1.0))
    return (1.0 - alpha) * neg.sum((1, 2))


class FreeAnchorRetinaNetHead(RetinaNetHead):
    """RetinaNet's subnets and anchors with the learning-to-match losses and
    the top-k-anchor decode."""

    def _settings(self):
        p = self.p
        return (p.head.mean or (0.0, 0.0, 0.0, 0.0),
                p.head.std or (1.0, 1.0, 1.0, 1.0))

    def loss(self, level_outputs, gt_bbox, im_info):
        """(losses, aux): freeanchor_positive_loss and
        freeanchor_negative_loss as
        `simpledet_tpu/models/freeanchor.py::FreeAnchorRetinaNetHead.loss`
        computes them."""
        p = self.p
        mean, std = self._settings()
        cls_logit, reg_delta = self.flatten_outputs(level_outputs)
        cls_prob = torch.sigmoid(cls_logit)
        anchors = torch.cat(self.level_anchors(level_outputs))
        top_n = p.anchor_assign.pre_anchor_top_n or 50
        alpha = p.focal_loss.alpha or 0.5
        pos = positive_loss(anchors, gt_bbox, cls_prob, reg_delta,
                            alpha=alpha, top_n=top_n, mean=mean, std=std)
        neg = negative_loss(anchors, gt_bbox, cls_prob, reg_delta, im_info,
                            alpha=alpha, gamma=p.focal_loss.gamma or 2.0,
                            bbox_thr=p.anchor_assign.bbox_thr or 0.6,
                            mean=mean, std=std)
        num_gt = sum_over_group((gt_bbox[..., 4] > 0).float().sum()).clamp(
            min=1.0)
        world = world_size()
        losses = {"freeanchor_positive_loss": pos.sum() * world / num_gt,
                  "freeanchor_negative_loss":
                      neg.sum() * world / (num_gt * top_n)}
        return losses, {"num_gt": num_gt}

    def prediction(self, level_outputs, im_info):
        """The top pre_nms_top_n anchors by their largest class probability,
        decoded with the head's mean and std and clipped to the image.
        Returns (cls_score [B, K, C] with column 0 zero, bbox_xyxy [B, K,
        4], valid [B, K], all true)."""
        mean, std = self._settings()
        top_n = self.p.proposal.pre_nms_top_n or 1000
        cls_logit, reg_delta = self.flatten_outputs(level_outputs)
        cls_prob = torch.sigmoid(cls_logit)                 # [B, N, C-1]
        anchors = torch.cat(self.level_anchors(level_outputs))
        _, idx = torch.topk(cls_prob.amax(-1), min(top_n, cls_prob.shape[1]),
                            dim=1)
        deltas = torch.gather(reg_delta, 1, idx[..., None].expand(-1, -1, 4))
        boxes = clip_boxes(decode_boxes(anchors[idx], deltas, means=mean,
                                        stds=std), im_info[:, :2])
        scores = torch.gather(cls_prob, 1, idx[..., None].expand(
            -1, -1, cls_prob.shape[-1]))
        scores = torch.cat([torch.zeros_like(scores[..., :1]), scores], -1)
        return scores, boxes, torch.ones_like(scores[..., 0], dtype=torch.bool)
