"""FPN RPN: the shared conv head, its losses and the proposals.

Counterpart of `simpledet_tpu/models/rpn.py` (RpnConvHead and FPNRpnHead).
The shared 3x3 conv runs in the head's compute dtype (the JAX package's
`FPNRpnHead` gives `RpnConvHead` the dtype that `dsl.FPNRpnHead` sets on the
param class: bf16 for an fp16 config); its output is cast to fp32, and the
cls and reg convs run in fp32 (fp32 islands). Logits leave the convs as NCHW
[B, kA, H, W]; they are permuted to NHWC before the reshape to [B, H*W*A, k],
so anchors run in (y, x, a) order as in the JAX package.
"""
import torch
from torch import nn
from torch.nn import functional as F

from simpledet_torch.models.init import normal_
from simpledet_torch.models.layers import conv2d
from simpledet_torch.ops.anchors import generate_anchor_grid
from simpledet_torch.ops.bbox import clip_boxes, decode_boxes
from simpledet_torch.ops.losses import smooth_l1
from simpledet_torch.ops.nms import NEG_INF, nms, top_k_stable
from simpledet_torch.parallel.dist import sum_over_group, world_size
from simpledet_torch.targets.anchor_target import batched_anchor_target
from simpledet_torch.targets.proposal import top_proposals


def level_keys(level_outputs):
    return sorted(level_outputs, key=lambda s: int(s.replace("stride", "")))


def to_nhwc_rows(x, k):
    """[B, kA, H, W] -> [B, H*W*A, k]."""
    b = x.shape[0]
    return x.permute(0, 2, 3, 1).reshape(b, -1, k)


class RpnConvHead(nn.Module):
    """Shared-weight head applied to each pyramid level."""

    def __init__(self, num_anchor, conv_channel=256, in_channels=256,
                 dtype=torch.float32):
        super().__init__()
        self.rpn_conv = conv2d(in_channels, conv_channel, 3, padding=1,
                               compute_dtype=dtype)
        self.rpn_cls = nn.Conv2d(conv_channel, 2 * num_anchor, 1)
        self.rpn_reg = nn.Conv2d(conv_channel, 4 * num_anchor, 1)

    def forward(self, pyramid):
        out = {}
        for key in level_keys([k for k in pyramid if k.startswith("stride")]):
            x = F.relu(self.rpn_conv(pyramid[key])).float()
            out[key] = (self.rpn_cls(x), self.rpn_reg(x))
        return out

    @torch.no_grad()
    def init_weights(self, gen):
        for m in (self.rpn_conv, self.rpn_cls, self.rpn_reg):
            normal_(m.weight, 0.01, gen)
            m.bias.zero_()


class AnchorHead:
    """The anchors of an RpnParam's anchor_generate (strides, scales,
    ratios), each level's grid made once per feature shape and device."""

    def __init__(self, p):
        self.p = p
        gen = p.anchor_generate
        self.strides = tuple(gen.stride)
        self.scales = (tuple(gen.scale) if hasattr(gen.scale, "__len__")
                       else (gen.scale,))
        self.ratios = tuple(gen.ratio)
        self.num_anchor = len(self.scales) * len(self.ratios)
        self._anchors = {}

    def anchors(self, stride, hw, device):
        key = (stride, tuple(hw), device)
        if key not in self._anchors:
            grid = generate_anchor_grid(hw[0], hw[1], stride, self.scales,
                                        self.ratios)
            self._anchors[key] = torch.from_numpy(grid).to(device)
        return self._anchors[key]


class FPNRpnHead(AnchorHead):
    """Proposal generation from the head's outputs; `p` is the nothrow
    RpnParam of the config."""

    def loss(self, gen, level_outputs, gt_bbox, im_info, deterministic=False):
        """(losses, aux): softmax CE over the sampled anchors, divided by
        their count over the global batch (summed over the process group),
        and smooth-L1 (sigma 3) over the kept positives, divided by batch *
        image_anchor."""
        p = self.p.anchor_assign
        keys = level_keys(level_outputs)
        cls_logit = torch.cat([to_nhwc_rows(level_outputs[k][0], 2)
                               for k in keys], 1)
        reg_delta = torch.cat([to_nhwc_rows(level_outputs[k][1], 4)
                               for k in keys], 1)
        anchors = torch.cat([
            self.anchors(s, level_outputs[k][0].shape[2:], cls_logit.device)
            for s, k in zip(self.strides, keys)])
        with torch.no_grad():
            label, target, weight = batched_anchor_target(
                gen, anchors, gt_bbox, im_info[:, :2],
                allowed_border=p.allowed_border, neg_thr=p.neg_thr,
                pos_thr=p.pos_thr, min_pos_thr=p.min_pos_thr,
                image_anchor=p.image_anchor, fg_fraction=p.pos_fraction,
                deterministic=deterministic,
                ignore_regions=bool(self.p.ignore_regions))

        valid = label >= 0
        logp = torch.log_softmax(cls_logit, dim=-1)
        pick = torch.where(label == 1, logp[..., 1], logp[..., 0])
        # the JAX package divides by the valid anchors of the global batch;
        # DDP averages the ranks' gradients, so each rank's share is scaled
        # by the world size
        n_valid = sum_over_group(valid.sum()).clamp(min=1)
        cls_loss = -torch.where(valid, pick, torch.zeros_like(pick)).sum() \
            * world_size() / n_valid
        reg_loss = (weight * smooth_l1(reg_delta - target, 3.0)).sum() / (
            gt_bbox.shape[0] * p.image_anchor)
        return ({"rpn_cls_loss": cls_loss, "rpn_reg_loss": reg_loss},
                {"rpn_label": label, "rpn_cls_logit": cls_logit})

    def level_candidates(self, level_outputs, im_info):
        """Per level: softmax fg score, decode, clip, min-size filter and
        top-`pre`, padded with NEG_INF. Returns (boxes [B, L, pre, 4],
        scores [B, L, pre])."""
        pre = self.p.proposal.pre_nms_top_n
        min_size = self.p.proposal.min_bbox_side or 0
        boxes_l, scores_l = [], []
        for stride, key in zip(self.strides, level_keys(level_outputs)):
            cls, reg = level_outputs[key]
            anchors = self.anchors(stride, cls.shape[2:], cls.device)
            prob = torch.softmax(to_nhwc_rows(cls, 2), dim=-1)[..., 1]
            deltas = to_nhwc_rows(reg, 4)
            boxes = decode_boxes(anchors[None], deltas)
            boxes = clip_boxes(boxes, im_info[:, None, :2])
            ws = boxes[..., 2] - boxes[..., 0] + 1.0
            hs = boxes[..., 3] - boxes[..., 1] + 1.0
            valid = (ws >= min_size) & (hs >= min_size)
            masked = torch.where(valid, prob, torch.full_like(prob, NEG_INF))
            k = min(pre, masked.shape[1])
            top_s, top_i = top_k_stable(masked, k)
            top_b = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
            if k < pre:
                top_s = F.pad(top_s, (0, pre - k), value=NEG_INF)
                top_b = F.pad(top_b, (0, 0, 0, pre - k))
            boxes_l.append(top_b)
            scores_l.append(top_s)
        return torch.stack(boxes_l, 1), torch.stack(scores_l, 1)

    def proposals(self, level_outputs, im_info):
        """Proposals with the config's pre/post counts (the train config's
        2000/2000, the test config's 1000/1000): (boxes [B, post, 4],
        scores [B, post])."""
        boxes, scores = self.level_candidates(level_outputs, im_info)
        return self.nms_and_select(boxes, scores)

    def nms_and_select(self, boxes, scores):
        """One batched NMS over every (image, level) pool, then the
        cross-level top-`post`."""
        b, n_level, pre = scores.shape
        post = self.p.proposal.post_nms_top_n
        post_l = min(post, pre)
        ob, osc, _, ov = nms(boxes.reshape(b * n_level, pre, 4),
                             scores.reshape(b * n_level, pre),
                             self.p.proposal.nms_thr, post_l,
                             valid=scores.reshape(b * n_level, pre) > NEG_INF / 2)
        osc = torch.where(ov, osc, torch.full_like(osc, NEG_INF))
        return top_proposals(ob.reshape(b, n_level * post_l, 4),
                             osc.reshape(b, n_level * post_l), post)
