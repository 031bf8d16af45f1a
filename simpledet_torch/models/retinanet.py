"""RetinaNet (counterpart of simpledet_tpu/models/retinanet.py): the P3-P7
neck, the subnets shared across levels, the focal and smooth-L1 losses over
the dense anchor targets, and the thresholded per-level top-k decode.

fp32 only: `dsl.build_detector` refuses a retina component whose param class
asks for bf16. Convolutions run NCHW in channels_last memory; the subnets'
outputs are permuted to NHWC before any reshape, so anchors run in the JAX
package's (level, y, x, anchor) order and class scores in (y, x, anchor,
class) order. Flax's SAME padding on the stride-2 P6 and P7 convs pads (0, 1)
along an even side: `models/layers.py::SameConv2d` pads as Flax does.

With a `norm` (`RetinaNetNeckWithBN`, `RetinaNetHeadWithBN`), the neck
normalises each lateral (`P*_lateral_norm`) and each output
(`P*_norm`), and the subnets normalise each tower conv's output on each
level with a norm of its own (`cls_conv{i}_{stride key}_norm`), before the
relu, as `simpledet_tpu/models/retinanet.py:37-130` does.
"""
import math

import torch
from torch import nn
from torch.nn import functional as F

from simpledet_torch.models.fpn import upsample2x_to
from simpledet_torch.models.init import fan_in_uniform_, normal_
from simpledet_torch.models.layers import SameConv2d
from simpledet_torch.models.rpn import AnchorHead, level_keys, to_nhwc_rows
from simpledet_torch.ops.bbox import clip_boxes, decode_boxes
from simpledet_torch.ops.losses import sigmoid_focal_loss, smooth_l1
from simpledet_torch.ops.nms import NEG_INF
from simpledet_torch.parallel.dist import sum_over_group, world_size
from simpledet_torch.targets.retina_target import batched_retina_anchor_target

# the reference's smooth-L1 scalar (models/retinanet/builder.py:318)
SMOOTH_L1_SCALAR = 0.11
# each tower's 3x3 convs, and the class prior of the cls_pred bias
NUM_CONV, PRIOR_PROB = 4, 0.01


class RetinaNetNeck(nn.Module):
    """{"c3", "c4", "c5"} -> {"stride8": P3, ..., "stride128": P7}: 1x1
    laterals on c3-c5 with the top-down sum (a x2 nearest repeat cropped to
    the lateral's shape), 3x3 output convs, P6 a 3x3 stride-2 conv on C5
    (p6_source "c5") or on the output P5 (p6_source "p5": FCOS's neck,
    `FCOSFPNNeck`), P7 one on relu(P6)."""

    def __init__(self, in_channels, filters, norm=None, p6_source="c5"):
        super().__init__()
        for stage, cin in zip((3, 4, 5), in_channels):
            self.add_module(f"P{stage}_lateral", nn.Conv2d(cin, filters, 1))
            self.add_module(f"P{stage}_conv",
                            nn.Conv2d(filters, filters, 3, padding=1))
        if p6_source not in ("c5", "p5"):
            raise ValueError(f"p6_source {p6_source!r}")
        self.p6_source = p6_source
        self.P6_conv = SameConv2d(
            in_channels[2] if p6_source == "c5" else filters, filters, 3,
            stride=2)
        self.P7_conv = SameConv2d(filters, filters, 3, stride=2)
        self.has_norm = norm is not None
        if self.has_norm:
            for name in ("P3_lateral", "P4_lateral", "P5_lateral", "P3",
                         "P4", "P5", "P6", "P7"):
                self.add_module(f"{name}_norm", norm(filters))

    def _norm(self, x, name):
        return getattr(self, f"{name}_norm")(x) if self.has_norm else x

    def forward(self, feats):
        c3, c4, c5 = feats["c3"], feats["c4"], feats["c5"]
        p5 = self._norm(self.P5_lateral(c5), "P5_lateral")
        p4_la = self._norm(self.P4_lateral(c4), "P4_lateral")
        p4 = upsample2x_to(p5, p4_la.shape[2:]) + p4_la
        p3_la = self._norm(self.P3_lateral(c3), "P3_lateral")
        p3 = upsample2x_to(p4, p3_la.shape[2:]) + p3_la
        p5c = self._norm(self.P5_conv(p5), "P5")
        p6 = self._norm(self.P6_conv(c5 if self.p6_source == "c5" else p5c),
                        "P6")
        return {"stride8": self._norm(self.P3_conv(p3), "P3"),
                "stride16": self._norm(self.P4_conv(p4), "P4"),
                "stride32": p5c,
                "stride64": p6,
                "stride128": self._norm(self.P7_conv(F.relu(p6)), "P7")}

    @torch.no_grad()
    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in_uniform_(m.weight, gen)
                m.bias.zero_()


class RetinaSubnets(nn.Module):
    """The cls and bbox towers (NUM_CONV 3x3 convs with relu each), shared
    by every level, and their predictors: {stride: (cls_logit [B, A*(C-1),
    H, W], bbox_delta [B, A*4, H, W])}. With a `norm`, each tower conv of
    each level (`strides`) has a norm of its own before its relu."""

    def __init__(self, num_anchor, num_fg_class, conv_channel, in_channels,
                 norm=None, strides=(8, 16, 32, 64, 128)):
        super().__init__()
        self.has_norm = norm is not None
        for branch in ("cls", "bbox"):
            cin = in_channels
            for i in range(1, NUM_CONV + 1):
                self.add_module(f"{branch}_conv{i}",
                                nn.Conv2d(cin, conv_channel, 3, padding=1))
                cin = conv_channel
                for s in strides if self.has_norm else ():
                    self.add_module(f"{branch}_conv{i}_stride{s}_norm",
                                    norm(conv_channel))
        self.cls_pred = nn.Conv2d(conv_channel, num_anchor * num_fg_class, 3,
                                  padding=1)
        self.bbox_pred = nn.Conv2d(conv_channel, num_anchor * 4, 3, padding=1)

    def tower(self, branch, x, key=None):
        for i in range(1, NUM_CONV + 1):
            x = getattr(self, f"{branch}_conv{i}")(x)
            if self.has_norm:
                x = getattr(self, f"{branch}_conv{i}_{key}_norm")(x)
            x = F.relu(x)
        return x

    def forward(self, pyramid):
        return {key: (self.cls_pred(self.tower("cls", pyramid[key], key)),
                      self.bbox_pred(self.tower("bbox", pyramid[key], key)))
                for key in level_keys(pyramid)}

    @torch.no_grad()
    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_(m.weight, 0.01, gen)
                m.bias.zero_()
        # the prior: every class starts at probability PRIOR_PROB
        self.cls_pred.bias.fill_(-math.log((1.0 - PRIOR_PROB) / PRIOR_PROB))


class RetinaNetHead(AnchorHead):
    """Targets, losses and decode around the subnets; `p` is the nothrow
    RpnParam of a RetinaNet config."""

    def __init__(self, p):
        super().__init__(p)
        self.num_fg_class = p.num_class - 1

    def level_anchors(self, level_outputs):
        """Each level's anchor grid from its actual feature shape."""
        return [self.anchors(s, level_outputs[k][0].shape[2:],
                             level_outputs[k][0].device)
                for s, k in zip(self.strides, level_keys(level_outputs))]

    def flatten_outputs(self, level_outputs):
        """(cls_logit [B, N, C-1], reg_delta [B, N, 4]) over the levels'
        anchors in (level, y, x, anchor) order."""
        keys = level_keys(level_outputs)
        return (torch.cat([to_nhwc_rows(level_outputs[k][0],
                                        self.num_fg_class) for k in keys], 1),
                torch.cat([to_nhwc_rows(level_outputs[k][1], 4)
                           for k in keys], 1))

    def targets(self, level_outputs, gt_bbox, im_info):
        """The dense targets (label [B, N], reg_target [B, N, 4],
        reg_weight [B, N, 4], fg_count [B]), without gradient."""
        a = self.p.anchor_assign
        anchors = torch.cat(self.level_anchors(level_outputs))
        with torch.no_grad():
            return batched_retina_anchor_target(
                anchors, gt_bbox, im_info[:, :2],
                allowed_border=(a.allowed_border if a and a.allowed_border
                                is not None else 9999),
                neg_thr=(a and a.neg_thr) or 0.4,
                pos_thr=(a and a.pos_thr) or 0.5,
                min_pos_thr=(a and a.min_pos_thr) or 0.0)

    def loss(self, level_outputs, gt_bbox, im_info):
        """(losses, aux): the focal loss and smooth-L1 (sigma sqrt(1 /
        0.11)), each summed and divided by the global batch's foreground
        count. JAX sums that count over the sharded batch under pjit (the
        reference's sync_loss); here it is summed over the process group,
        and since DDP averages the ranks' gradients, each rank's share is
        scaled by the world size, as the RPN's normaliser is."""
        p = self.p
        cls_logit, reg_delta = self.flatten_outputs(level_outputs)
        label, target, weight, fg_count = self.targets(level_outputs,
                                                       gt_bbox, im_info)
        total_fg = sum_over_group(fg_count.sum()).clamp(min=1.0)
        scale = world_size() / total_fg
        focal = sigmoid_focal_loss(cls_logit, label, alpha=p.focal_loss.alpha,
                                   gamma=p.focal_loss.gamma)
        reg = smooth_l1(reg_delta - target, math.sqrt(1.0 / SMOOTH_L1_SCALAR))
        losses = {"retina_cls_loss": focal.sum() * scale,
                  "retina_reg_loss": (weight * reg).sum() * scale}
        return losses, {"rpn_label": label, "rpn_fg_count": total_fg}

    def prediction(self, level_outputs, im_info):
        """Per level and image: sigmoid scores over (y, x, anchor, class),
        kept above min_det_score (0.05 unset; 0 on the coarsest level), the
        top pre_nms_top_n of them, their anchors decoded with the head's
        mean and std and clipped to the image. Returns (cls_score [B, K, C]
        with only the picked class's column set, bbox_xyxy [B, K, 4],
        valid [B, K]); K sums min(pre_nms_top_n, scores of the level) over
        the levels.

        The top-k is torch.topk: exact, as the JAX package's off the TPU.
        Its order among the rows masked to NEG_INF may differ from
        `lax.top_k`'s; those rows are invalid and never reach a detection."""
        p = self.p
        top_n = p.proposal.pre_nms_top_n
        thresh = p.proposal.min_det_score or 0.05
        mean = p.head.mean or (0.0, 0.0, 0.0, 0.0)
        std = p.head.std or (1.0, 1.0, 1.0, 1.0)
        nfg = self.num_fg_class
        max_stride = max(self.strides)
        boxes_l, scores_l, cls_l = [], [], []
        for key, anc, stride in zip(level_keys(level_outputs),
                                    self.level_anchors(level_outputs),
                                    self.strides):
            logit, delta = level_outputs[key]
            b = logit.shape[0]
            prob = torch.sigmoid(to_nhwc_rows(logit, nfg).reshape(b, -1))
            thr = 0.0 if stride == max_stride else thresh
            masked = torch.where(prob > thr, prob,
                                 torch.full_like(prob, NEG_INF))
            top_s, top_i = torch.topk(masked, min(top_n, prob.shape[1]),
                                      dim=1)
            a_idx = top_i // nfg
            deltas = torch.gather(to_nhwc_rows(delta, 4), 1,
                                  a_idx[..., None].expand(-1, -1, 4))
            boxes = decode_boxes(anc[a_idx], deltas, means=mean, stds=std)
            boxes_l.append(clip_boxes(boxes, im_info[:, None, :2]))
            scores_l.append(top_s)
            cls_l.append(top_i % nfg + 1)
        return sparse_detections(boxes_l, scores_l, cls_l, p.num_class)


def sparse_detections(boxes_l, scores_l, cls_l, num_class):
    """The levels' top candidates (boxes [B, k, 4], scores [B, k], NEG_INF
    where invalid, classes [B, k] in 1..C-1) concatenated into (cls_score
    [B, K, C] with only each row's class column set, bbox_xyxy [B, K, 4],
    valid [B, K]), the layout the per-class NMS takes."""
    boxes = torch.cat(boxes_l, 1)
    scores = torch.cat(scores_l, 1)
    ok = scores > NEG_INF / 2
    scores = torch.where(ok, scores, torch.zeros_like(scores))
    onehot = torch.cat(cls_l, 1)[..., None] == torch.arange(
        num_class, device=scores.device)
    cls_score = torch.where(onehot, scores[..., None],
                            torch.zeros_like(scores[..., None]))
    return cls_score, boxes, ok


class RetinaNet(nn.Module):
    """backbone -> neck -> head_module (the subnets' parameters); head (the
    targets, losses and decode). Mode "train" returns (losses, aux) with
    the graph kept for the backward; mode "test" returns {"cls_score" [B, K,
    C], "bbox_xyxy" [B, K, 4C] (each box tiled over the classes, as the
    per-class NMS takes them), "det_valid" [B, K]} without autograd."""

    def __init__(self, backbone, neck, head_module, head):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head_module = head_module
        self.head = head

    def pyramid(self, data):
        """[B, H, W, 3] -> {"stride8": P3, ..., "stride128": P7} NCHW."""
        return self.neck(self.backbone(data.permute(0, 3, 1, 2)))

    def forward(self, data, im_info, gt_bbox=None, mode="test", *,
                generator=None):
        """mode "train" needs gt_bbox [B, G, 5]; the dense targets draw no
        random numbers, so `generator` is not used."""
        if mode == "train":
            if gt_bbox is None:
                raise ValueError("train mode needs gt_bbox")
            return self.head.loss(self.head_module(self.pyramid(data)),
                                  gt_bbox, im_info)
        if mode != "test":
            raise NotImplementedError(f"RetinaNet mode {mode!r}")
        with torch.no_grad():
            outs = self.head_module(self.pyramid(data))
            return self.test_outputs(outs, im_info)

    def test_outputs(self, outs, im_info):
        cls_score, boxes, valid = self.head.prediction(outs, im_info)
        return {"cls_score": cls_score,
                "bbox_xyxy": boxes.repeat(1, 1, cls_score.shape[-1]),
                "det_valid": valid}

    def init_weights(self, gen):
        for m in (self.backbone, self.neck, self.head_module):
            m.init_weights(gen)
