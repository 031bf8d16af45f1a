"""FCOS (counterpart of simpledet_tpu/models/fcos.py): anchor-free dense
detection with the location targets made on the device.

- `fcos_locations`: each level's location centers (x, y) = (i + 1/2) *
  stride, and the range of box sizes the level takes (`STAGE_BOUNDS`).
- `fcos_targets`: per location, its (l, t, r, b) offsets to each gt; a gt
  the location lies in and whose largest offset is in the level's range is
  a candidate, the smallest-area candidate wins (the first on equal areas);
  centerness sqrt(min(l, r) / max(l, r) * min(t, b) / max(t, b));
  locations on the padding ignored. One set of operations for the batch.
- `FCOSSubnets` (the Flax `FCOSHeadModule`): two 4-conv towers (`shared_*`
  for the class and centerness, `offset_*` for the box), each conv shared
  across the levels and followed by a GroupNorm of each level's own
  (`shared_gn{i}_{stride key}`, Flax's nn.GroupNorm: 32 groups, epsilon
  1e-6) and a relu; the 3x3 predictors `center_conv`, `cls_conv` (prior
  0.01) and `offset_conv`, whose output is scaled by the level's own
  `offset_scale_{stride key}` before the exp.
- `FCOSHead`: the focal loss over (positives + 1), the centerness BCE over
  the positives, the IoU loss weighted by the gt centerness; the test
  decode: per level, class probabilities above pre_nms_thresh (0.05 unset)
  scored by prob x centerness, the top pre_nms_top_n, boxes from the
  location and its offsets clipped to the image.
- `FCOS`: backbone, the P3-P7 neck with P6 from P5 (`RetinaNetNeck`'s
  p6_source "p5"), subnets and head; RetinaNet's forward.
fp32 only. Conv outputs are permuted to NHWC before every reshape, so
locations run in the JAX package's (level, y, x) order. Under a process
group the normalisers (the positive count, the centerness sums) are summed
over the group and each rank's loss scaled by the world size, as
RetinaNet's foreground count is.
"""
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from simpledet_torch.models.init import normal_
from simpledet_torch.models.norm import GroupNorm
from simpledet_torch.models.retinanet import (PRIOR_PROB, RetinaNet,
                                              sparse_detections)
from simpledet_torch.models.rpn import level_keys, to_nhwc_rows
from simpledet_torch.ops.losses import sigmoid_focal_loss
from simpledet_torch.ops.nms import NEG_INF
from simpledet_torch.parallel.dist import sum_over_group, world_size

STAGE_BOUNDS = ((-1e5, 64.), (64., 128.), (128., 256.), (256., 512.),
                (512., 1e10))
NUM_CONV = 4
# Flax's nn.GroupNorm default epsilon (the port's GroupNorm defaults to 1e-5)
GN_EPS = 1e-6


def fcos_locations(sizes, strides):
    """(xy [HW_total, 2], bounds [HW_total, 2]) in numpy, for the levels'
    feature sizes [(h, w), ...] and strides."""
    xs, lows, highs = [], [], []
    for i, ((fh, fw), s) in enumerate(zip(sizes, strides)):
        x = np.arange(fw, dtype=np.float32) * s + s / 2.0
        y = np.arange(fh, dtype=np.float32) * s + s / 2.0
        gx, gy = np.meshgrid(x, y)
        xs.append(np.stack([gx.reshape(-1), gy.reshape(-1)], 1))
        lo, hi = STAGE_BOUNDS[min(i, len(STAGE_BOUNDS) - 1)]
        lows.append(np.full(fh * fw, lo, np.float32))
        highs.append(np.full(fh * fw, hi, np.float32))
    return (np.concatenate(xs, 0),
            np.stack([np.concatenate(lows), np.concatenate(highs)], 1))


def fcos_targets(gt_bbox, im_hw, xy, bounds):
    """gt_bbox [B, G, 5] (class -1: padding), im_hw [B, 2], xy and bounds
    [HW, 2] -> (cls_label [B, HW] {-1 ignore, 0 background, k class},
    centerness [B, HW] (-1 ignore), offsets [B, HW, 4], nonignore [B, HW])."""
    gt_valid = gt_bbox[..., 4] != -1
    x, y = xy[:, 0:1], xy[:, 1:2]                       # [HW, 1]
    l = x - gt_bbox[:, None, :, 0]                      # [B, HW, G]
    t = y - gt_bbox[:, None, :, 1]
    r = gt_bbox[:, None, :, 2] - x
    b = gt_bbox[:, None, :, 3] - y
    offs = torch.stack([l, t, r, b], -1)                # [B, HW, G, 4]
    in_box = offs.amin(-1) >= 0
    max_off = offs.amax(-1)
    in_stage = (max_off >= bounds[:, 0:1]) & (max_off < bounds[:, 1:2])
    ok = in_box & in_stage & gt_valid[:, None, :]

    area = (l + r) * (t + b)
    area = torch.where(ok, area, torch.full_like(area, 1e10))
    best = area.argmin(-1)                              # [B, HW]
    has = ok.any(-1)
    sel = torch.gather(offs, 2, best[..., None, None].expand(
        -1, -1, 1, 4))[:, :, 0]
    zero = torch.zeros_like(sel)
    sel = torch.where(has[..., None], sel, zero)
    cls = torch.where(has, torch.gather(gt_bbox[..., 4], 1, best),
                      zero[..., 0])

    lr = torch.stack([sel[..., 0], sel[..., 2]], -1)
    tb = torch.stack([sel[..., 1], sel[..., 3]], -1)
    ctr = torch.sqrt(torch.clamp(
        (lr.amin(-1) * tb.amin(-1))
        / torch.clamp(lr.amax(-1) * tb.amax(-1), min=1e-10), min=0.0))
    ctr = torch.where(has, ctr, zero[..., 0])

    nonignore = ((xy[:, 0] < im_hw[:, 1:2]) & (xy[:, 1] < im_hw[:, 0:1]))
    ignore = torch.full_like(cls, -1.0)
    return (torch.where(nonignore, cls, ignore),
            torch.where(nonignore, ctr, ignore), sel, nonignore)


class FCOSSubnets(nn.Module):
    """{stride key: (center [B, 1, H, W], cls [B, C-1, H, W], offsets
    [B, 4, H, W] after the exp, image units)}."""

    def __init__(self, num_fg_class, conv_channel, in_channels,
                 strides=(8, 16, 32, 64, 128), num_group=32):
        super().__init__()
        for branch in ("shared", "offset"):
            cin = in_channels
            for i in range(1, NUM_CONV + 1):
                self.add_module(f"{branch}_conv{i}",
                                nn.Conv2d(cin, conv_channel, 3, padding=1))
                cin = conv_channel
                for s in strides:
                    self.add_module(f"{branch}_gn{i}_stride{s}", GroupNorm(
                        conv_channel, num_group, GN_EPS))
        self.center_conv = nn.Conv2d(conv_channel, 1, 3, padding=1)
        self.cls_conv = nn.Conv2d(conv_channel, num_fg_class, 3, padding=1)
        self.offset_conv = nn.Conv2d(conv_channel, 4, 3, padding=1)
        for s in strides:
            self.register_parameter(f"offset_scale_stride{s}",
                                    nn.Parameter(torch.ones(1)))

    def tower(self, branch, x, key):
        for i in range(1, NUM_CONV + 1):
            x = getattr(self, f"{branch}_conv{i}")(x)
            x = F.relu(getattr(self, f"{branch}_gn{i}_{key}")(x))
        return x

    def forward(self, pyramid):
        out = {}
        for key in level_keys(pyramid):
            c = self.tower("shared", pyramid[key], key)
            o = self.offset_conv(self.tower("offset", pyramid[key], key))
            out[key] = (self.center_conv(c), self.cls_conv(c),
                        torch.exp(o * getattr(self, f"offset_scale_{key}")))
        return out

    @torch.no_grad()
    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_(m.weight, 0.01, gen)
                m.bias.zero_()
            elif isinstance(m, GroupNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
        self.cls_conv.bias.fill_(-math.log((1.0 - PRIOR_PROB) / PRIOR_PROB))
        for name, p in self.named_parameters():
            if name.startswith("offset_scale_"):
                p.fill_(1.0)


class FCOSHead:
    """Targets, losses and decode around the subnets; `p` is the nothrow
    RpnParam of an FCOS config (FCOSParam.num_classifier foreground classes,
    FCOSParam.stride)."""

    def __init__(self, p):
        self.p = p
        self.strides = tuple(p.FCOSParam.stride)
        self.num_fg_class = p.FCOSParam.num_classifier
        self._locations = {}

    def locations(self, level_outputs):
        """(xy [HW, 2], bounds [HW, 2], level sizes) from the levels'
        actual feature sizes, made once per sizes and device."""
        keys = level_keys(level_outputs)
        sizes = tuple(tuple(level_outputs[k][0].shape[2:]) for k in keys)
        dev = level_outputs[keys[0]][0].device
        if (sizes, dev) not in self._locations:
            xy, bounds = fcos_locations(sizes, self.strides)
            self._locations[sizes, dev] = (torch.from_numpy(xy).to(dev),
                                           torch.from_numpy(bounds).to(dev),
                                           sizes)
        return self._locations[sizes, dev]

    def flatten(self, level_outputs):
        """(centerness logit [B, HW], cls logit [B, HW, C-1], offsets
        [B, HW, 4]) over the levels' locations."""
        keys = level_keys(level_outputs)
        parts = zip(*(level_outputs[k] for k in keys))
        ctr, cls, off = ([to_nhwc_rows(t, k) for t in ts] for ts, k in zip(
            parts, (1, self.num_fg_class, 4)))
        return torch.cat(ctr, 1)[..., 0], torch.cat(cls, 1), torch.cat(off, 1)

    def targets(self, level_outputs, gt_bbox, im_info):
        xy, bounds, _ = self.locations(level_outputs)
        with torch.no_grad():
            return fcos_targets(gt_bbox, im_info[:, :2], xy, bounds)

    def loss(self, level_outputs, gt_bbox, im_info):
        """(losses, aux): fcos_cls_loss, fcos_centerness_loss and
        fcos_offset_loss as `simpledet_tpu/models/fcos.py::FCOSHead.loss`
        computes them."""
        ls = self.p.loss_setting
        ctr_logit, cls_logit, off_pred = self.flatten(level_outputs)
        cls_gt, ctr_gt, off_gt, nonign = self.targets(level_outputs, gt_bbox,
                                                      im_info)
        world = world_size()
        focal = sigmoid_focal_loss(cls_logit, cls_gt,
                                   alpha=ls.focal_loss_alpha or 0.25,
                                   gamma=ls.focal_loss_gamma or 2.0)
        num_pos = sum_over_group((cls_gt >= 1.0).float().sum())
        cls_loss = focal.sum() * world / (num_pos + 1.0)

        pos = (ctr_gt > 0) & nonign
        pc = torch.clamp(torch.sigmoid(ctr_logit), 1e-5, 1.0)
        bce = -(ctr_gt * torch.log(pc) + (1 - ctr_gt) * torch.log(
            torch.clamp(1 - pc, 1e-5, 1.0)))
        zero = torch.zeros_like(bce)
        ctr_loss = torch.where(pos, bce, zero).sum() * world / (
            sum_over_group(pos.float().sum()) + 1e-30)

        w = torch.where(pos, ctr_gt, zero)
        li, ti, ri, bi = off_pred.unbind(-1)
        lg, tg, rg, bg = off_gt.unbind(-1)
        inter = ((torch.minimum(li, lg) + torch.minimum(ri, rg))
                 * (torch.minimum(ti, tg) + torch.minimum(bi, bg)))
        union = (li + ri) * (ti + bi) + (lg + rg) * (tg + bg) - inter
        iou_l = -torch.log((inter + 1.0) / (union + 1.0))
        off_loss = (iou_l * w).sum() * world / (sum_over_group(w.sum())
                                                + 1e-30)
        losses = {"fcos_cls_loss": cls_loss,
                  "fcos_centerness_loss": ctr_loss,
                  "fcos_offset_loss": off_loss}
        return losses, {"fcos_cls_label": cls_gt, "fcos_num_pos": num_pos}

    def prediction(self, level_outputs, im_info):
        """Per level and image: class probabilities above pre_nms_thresh
        (0.05 unset) scored by prob x centerness prob, the top
        pre_nms_top_n (torch.topk), each box from its location's center and
        offsets, clipped to [0, w] x [0, h]. Returns (cls_score [B, K, C],
        bbox_xyxy [B, K, 4], valid [B, K]) as RetinaNetHead.prediction."""
        p = self.p
        top_n = p.proposal.pre_nms_top_n or 1000
        thresh = p.proposal.pre_nms_thresh or 0.05
        nfg = self.num_fg_class
        xy, _, sizes = self.locations(level_outputs)
        h = im_info[:, None, 0]
        w = im_info[:, None, 1]
        start = 0
        boxes_l, scores_l, cls_l = [], [], []
        for key, (fh, fw) in zip(level_keys(level_outputs), sizes):
            ctr, cls, off = level_outputs[key]
            b, n = cls.shape[0], fh * fw
            loc = xy[start:start + n]
            start += n
            cls_prob = torch.sigmoid(to_nhwc_rows(cls, nfg))
            ctr_prob = torch.sigmoid(to_nhwc_rows(ctr, 1))
            score = cls_prob * ctr_prob
            flat = torch.where(cls_prob > thresh, score,
                               torch.full_like(score, NEG_INF)).reshape(b, -1)
            top_s, top_i = torch.topk(flat, min(top_n, flat.shape[1]), dim=1)
            loc_idx = top_i // nfg
            o = torch.gather(to_nhwc_rows(off, 4), 1,
                             loc_idx[..., None].expand(-1, -1, 4))
            x, y = loc[loc_idx, 0], loc[loc_idx, 1]
            zero = torch.zeros_like(x)
            boxes_l.append(torch.stack([
                torch.minimum(torch.maximum(x - o[..., 0], zero), w),
                torch.minimum(torch.maximum(y - o[..., 1], zero), h),
                torch.minimum(torch.maximum(x + o[..., 2], zero), w),
                torch.minimum(torch.maximum(y + o[..., 3], zero), h)], -1))
            scores_l.append(top_s)
            cls_l.append(top_i % nfg + 1)
        return sparse_detections(boxes_l, scores_l, cls_l, nfg + 1)


class FCOS(RetinaNet):
    """backbone -> neck (P6 from P5) -> head_module (FCOSSubnets) with the
    FCOSHead; RetinaNet's forward: mode "train" returns (losses, aux), mode
    "test" {"cls_score", "bbox_xyxy" (tiled over the classes),
    "det_valid"}."""
