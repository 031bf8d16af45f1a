"""RepPoints (counterpart of simpledet_tpu/models/reppoints.py): a point
set per location, refined once through deformable convolutions.

- `RepPointsSubnets` (the Flax `RepPointsHeadModule`): 3-conv cls and reg
  towers shared across the levels, the init points (`pts_init_conv` 3x3,
  `pts_init_out` 1x1: 2 * num_points y-first offsets in stride units);
  then the refine stage, two deformable convs (`ops/deform_conv.py`) on
  the towers whose offsets are the init points minus the regular grid,
  through the gradient multiplier 0.9 * detach(x) + 0.1 * x (written so,
  as the JAX package does: it is not bitwise x); their kernels are the raw
  parameters `cls_conv_kernel` and `pts_refine_conv_kernel` (HWIO leaves in
  Flax, OIHW here); `cls_out` (prior 0.01) and `pts_refine_out`, the
  refine residual on detach(init points). The refine stage runs in the
  profiler range `reppoints_refine`.
- `RepPointsHead`: the init targets by point assignment, the refine
  targets by IoU assignment on the (detached) init boxes
  (`ops/points.py`); the focal loss on the refine labels over the
  foreground count; smooth-L1 (sigma 3) of (box - gt) / (stride x scale)
  for both stages, the init one weighted 0.5; the test decode: refine
  boxes per level, class probabilities above min_det_score (0.05 unset),
  the top pre_nms_top_n.
- `RepPoints`: backbone, the FCOS neck, subnets and head, and the moment
  transform's `moment_transfer` (2 parameters, zero init) when the head's
  transform is "moment".
fp32 only. Conv outputs are permuted to NHWC before every reshape; the
offsets' channels are (tap, {y, x}) as the deformable conv reads them.
"""
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.profiler import record_function

from simpledet_torch.models.init import normal_
from simpledet_torch.models.retinanet import (PRIOR_PROB, RetinaNet,
                                              sparse_detections)
from simpledet_torch.models.rpn import level_keys, to_nhwc_rows
from simpledet_torch.ops.deform_conv import deform_conv2d
from simpledet_torch.ops.losses import sigmoid_focal_loss, smooth_l1
from simpledet_torch.ops.nms import NEG_INF
from simpledet_torch.ops.points import (gen_dcn_offsets, gen_points,
                                        iou_assign, offset_to_pts,
                                        point_assign, points2bbox)
from simpledet_torch.parallel.dist import sum_over_group, world_size

PROFILER_RANGES = ("reppoints_refine",)
NUM_CONV = 3


class RepPointsSubnets(nn.Module):
    """{stride key: (pts_init [B, 2n, H, W], pts_refine [B, 2n, H, W],
    cls [B, C-1, H, W])}."""

    def __init__(self, num_fg_class, num_points, conv_channel,
                 point_conv_channel, in_channels):
        super().__init__()
        n2 = 2 * num_points
        k = int(math.sqrt(num_points))
        for branch in ("cls", "reg"):
            cin = in_channels
            for i in range(1, NUM_CONV + 1):
                self.add_module(f"{branch}_conv{i}",
                                nn.Conv2d(cin, conv_channel, 3, padding=1))
                cin = conv_channel
        self.pts_init_conv = nn.Conv2d(conv_channel, point_conv_channel, 3,
                                       padding=1)
        self.pts_init_out = nn.Conv2d(point_conv_channel, n2, 1)
        self.cls_conv_kernel = nn.Parameter(
            torch.empty(point_conv_channel, conv_channel, k, k))
        self.cls_out = nn.Conv2d(point_conv_channel, num_fg_class, 1)
        self.pts_refine_conv_kernel = nn.Parameter(
            torch.empty(point_conv_channel, conv_channel, k, k))
        self.pts_refine_out = nn.Conv2d(point_conv_channel, n2, 1)
        self.register_buffer("dcn_base", torch.from_numpy(
            gen_dcn_offsets(k, (k - 1) // 2)).reshape(1, n2, 1, 1),
            persistent=False)

    def towers(self, pyramid):
        """{stride key: (cls tower, reg tower, pts_init)}."""
        out = {}
        for key in level_keys(pyramid):
            c = r = pyramid[key]
            for i in range(1, NUM_CONV + 1):
                c = F.relu(getattr(self, f"cls_conv{i}")(c))
                r = F.relu(getattr(self, f"reg_conv{i}")(r))
            pts_init = self.pts_init_out(F.relu(self.pts_init_conv(r)))
            out[key] = (c, r, pts_init)
        return out

    def refine(self, towers):
        """The deformable refine stage on `towers`' outputs, in the profiler
        range `reppoints_refine`."""
        out = {}
        with record_function("reppoints_refine"):
            for key, (c, r, pts_init) in towers.items():
                fixed = pts_init.detach()
                dcn_off = (0.9 * fixed + 0.1 * pts_init) - self.dcn_base
                cls_feat = F.relu(deform_conv2d(c, dcn_off,
                                                self.cls_conv_kernel))
                refine_feat = F.relu(deform_conv2d(
                    r, dcn_off, self.pts_refine_conv_kernel))
                out[key] = (pts_init,
                            self.pts_refine_out(refine_feat) + fixed,
                            self.cls_out(cls_feat))
        return out

    def forward(self, pyramid):
        return self.refine(self.towers(pyramid))

    @torch.no_grad()
    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_(m.weight, 0.01, gen)
                m.bias.zero_()
        normal_(self.cls_conv_kernel, 0.01, gen)
        normal_(self.pts_refine_conv_kernel, 0.01, gen)
        self.cls_out.bias.fill_(-math.log((1.0 - PRIOR_PROB) / PRIOR_PROB))


class RepPointsHead:
    """Targets, losses and decode around the subnets; `p` is the nothrow
    RpnParam of a RepPoints config."""

    def __init__(self, p):
        self.p = p
        g = p.point_generate
        self.strides = tuple(g.stride)
        self.num_points = g.num_points or 9
        self.transform = g.transform or "minmax"
        self.num_fg_class = p.num_class - 1
        self.needs_moment = self.transform == "moment"
        self._points = {}

    def points(self, level_outputs):
        """(points [N, 3] (x, y, stride), each point's stride [N], level
        sizes) from the levels' feature sizes, once per sizes and device."""
        keys = level_keys(level_outputs)
        sizes = tuple(tuple(level_outputs[k][0].shape[2:]) for k in keys)
        dev = level_outputs[keys[0]][0].device
        if (sizes, dev) not in self._points:
            pts = np.concatenate([gen_points(h, w, s) for (h, w), s in
                                  zip(sizes, self.strides)], 0)
            pts = torch.from_numpy(pts).to(dev)
            self._points[sizes, dev] = (pts, pts[:, 2], sizes)
        return self._points[sizes, dev]

    def flatten(self, level_outputs):
        """(pts_init [B, N, 2n], pts_refine [B, N, 2n], cls logit
        [B, N, C-1]) over the levels' points."""
        keys = level_keys(level_outputs)
        n2 = 2 * self.num_points
        parts = zip(*(level_outputs[k] for k in keys))
        return tuple(torch.cat([to_nhwc_rows(t, k) for t in ts], 1)
                     for ts, k in zip(parts, (n2, n2, self.num_fg_class)))

    def boxes(self, points, pred, stride, moment_transfer):
        return points2bbox(offset_to_pts(points, pred, stride,
                                         self.num_points),
                           self.transform, y_first=False,
                           moment_transfer=moment_transfer)

    def loss(self, level_outputs, gt_bbox, im_info, moment_transfer=None):
        """(losses, aux): reppoints_cls_loss, reppoints_init_loss and
        reppoints_refine_loss as
        `simpledet_tpu/models/reppoints.py::RepPointsHead.loss` computes
        them."""
        p = self.p
        points, strides, _ = self.points(level_outputs)
        pts_init, pts_refine, cls_logit = self.flatten(level_outputs)
        boxes_init = self.boxes(points, pts_init, strides[:, None],
                                moment_transfer)
        boxes_refine = self.boxes(points, pts_refine, strides[:, None],
                                  moment_transfer)
        ts, bt = p.point_target, p.bbox_target
        with torch.no_grad():
            lbl_init, gts_init = point_assign(points, gt_bbox,
                                              ts.target_scale or 4,
                                              ts.num_pos or 1)
            lbl_ref, gts_ref = iou_assign(boxes_init.detach(), gt_bbox,
                                          bt.pos_iou_thr or 0.5,
                                          bt.neg_iou_thr or 0.4,
                                          bt.min_pos_iou or 0.0)
        world = world_size()
        focal = sigmoid_focal_loss(cls_logit, lbl_ref,
                                   alpha=p.focal_loss.alpha or 0.25,
                                   gamma=p.focal_loss.gamma or 2.0)
        n_fg = sum_over_group((lbl_ref >= 1.0).float().sum()).clamp(min=1.0)
        cls_loss = focal.sum() * world / n_fg
        norm_term = strides[None, :, None] * (p.point_generate.scale or 4)

        def box_loss(boxes, gts, lbl):
            w = (lbl >= 1.0).float()[..., None]
            l1 = smooth_l1((boxes - gts) / norm_term, 3.0)
            return (l1 * w).sum() * world / sum_over_group(w.sum()).clamp(
                min=1.0)

        losses = {"reppoints_cls_loss": cls_loss,
                  "reppoints_init_loss": 0.5 * box_loss(boxes_init, gts_init,
                                                        lbl_init),
                  "reppoints_refine_loss": box_loss(boxes_refine, gts_ref,
                                                    lbl_ref)}
        return losses, {"reppoints_label": lbl_ref}

    def prediction(self, level_outputs, im_info, moment_transfer=None):
        """Per level and image: the refine points' boxes clipped to [0, w] x
        [0, h], class probabilities above min_det_score (0.05 unset), the
        top pre_nms_top_n (torch.topk). Returns (cls_score [B, K, C],
        bbox_xyxy [B, K, 4], valid [B, K]) as RetinaNetHead.prediction."""
        p = self.p
        top_n = p.proposal.pre_nms_top_n or 1000
        thresh = p.proposal.min_det_score or 0.05
        nfg = self.num_fg_class
        points, _, sizes = self.points(level_outputs)
        h = im_info[:, None, 0]
        w = im_info[:, None, 1]
        start = 0
        boxes_l, scores_l, cls_l = [], [], []
        for key, s, (fh, fw) in zip(level_keys(level_outputs), self.strides,
                                    sizes):
            _, refine, cls = level_outputs[key]
            b, n = cls.shape[0], fh * fw
            loc = points[start:start + n]
            start += n
            boxes = self.boxes(loc, to_nhwc_rows(refine, 2 * self.num_points),
                               s, moment_transfer)
            zero = torch.zeros_like(boxes[..., 0])
            boxes = torch.stack([
                torch.minimum(torch.maximum(boxes[..., 0], zero), w),
                torch.minimum(torch.maximum(boxes[..., 1], zero), h),
                torch.minimum(torch.maximum(boxes[..., 2], zero), w),
                torch.minimum(torch.maximum(boxes[..., 3], zero), h)], -1)
            prob = torch.sigmoid(to_nhwc_rows(cls, nfg))
            flat = torch.where(prob > thresh, prob,
                               torch.full_like(prob, NEG_INF)).reshape(b, -1)
            top_s, top_i = torch.topk(flat, min(top_n, flat.shape[1]), dim=1)
            boxes_l.append(torch.gather(boxes, 1, (top_i // nfg)[..., None]
                                        .expand(-1, -1, 4)))
            scores_l.append(top_s)
            cls_l.append(top_i % nfg + 1)
        return sparse_detections(boxes_l, scores_l, cls_l, nfg + 1)


class RepPoints(RetinaNet):
    """backbone -> neck -> head_module (RepPointsSubnets) with the
    RepPointsHead, and `moment_transfer` for the moment transform. Mode
    "train" returns (losses, aux), mode "test" {"cls_score", "bbox_xyxy"
    (tiled over the classes), "det_valid"}."""

    def __init__(self, backbone, neck, head_module, head):
        super().__init__(backbone, neck, head_module, head)
        if head.needs_moment:
            self.moment_transfer = nn.Parameter(torch.zeros(2))
        else:
            self.moment_transfer = None

    def forward(self, data, im_info, gt_bbox=None, mode="test", *,
                generator=None):
        if mode == "train":
            if gt_bbox is None:
                raise ValueError("train mode needs gt_bbox")
            return self.head.loss(self.head_module(self.pyramid(data)),
                                  gt_bbox, im_info, self.moment_transfer)
        if mode != "test":
            raise NotImplementedError(f"RepPoints mode {mode!r}")
        with torch.no_grad():
            return self.test_outputs(self.head_module(self.pyramid(data)),
                                     im_info)

    def test_outputs(self, outs, im_info):
        cls_score, boxes, valid = self.head.prediction(
            outs, im_info, self.moment_transfer)
        return {"cls_score": cls_score,
                "bbox_xyxy": boxes.repeat(1, 1, cls_score.shape[-1]),
                "det_valid": valid}

    def init_weights(self, gen):
        super().init_weights(gen)
        if self.moment_transfer is not None:
            with torch.no_grad():
                self.moment_transfer.zero_()
