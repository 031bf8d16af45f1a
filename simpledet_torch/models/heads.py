"""2fc box head, the Double-Head box head, the loss and the test-time
prediction (counterpart of simpledet_tpu/models/heads.py::Bbox2fcHead,
BboxDualHeadSmall, bbox_head_loss and bbox_head_predict).

RoI features arrive as [B, R, P, P, C] and are flattened in HWC order, as in
the JAX package, so fc1's weight is the transposed Flax kernel. fc1 and fc2
run in the head's compute dtype; the logits and deltas run in fp32 (fp32
islands), as do the losses and the prediction.
"""
import torch
from torch import nn
from torch.nn import functional as F

from simpledet_torch.models.init import fan_in_uniform_, normal_
from simpledet_torch.models.layers import conv2d, linear
from simpledet_torch.ops.bbox import clip_boxes, decode_boxes
from simpledet_torch.ops.losses import smooth_l1


class Bbox2fcHead(nn.Module):
    """roi_feat [B, R, P, P, C] -> (cls_logit [B, R, num_class],
    bbox_delta [B, R, 4 * num_reg_class])."""

    def __init__(self, num_class, num_reg_class, in_features, hidden=1024,
                 dtype=torch.float32):
        super().__init__()
        self.fc1 = linear(in_features, hidden, compute_dtype=dtype)
        self.fc2 = linear(hidden, hidden, compute_dtype=dtype)
        self.cls_logit = nn.Linear(hidden, num_class)
        self.bbox_delta = nn.Linear(hidden, 4 * num_reg_class)

    def forward(self, roi_feat):
        b, r = roi_feat.shape[:2]
        x = roi_feat.reshape(b, r, -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x)).float()
        return self.cls_logit(x), self.bbox_delta(x)

    @torch.no_grad()
    def init_weights(self, gen):
        fan_in_uniform_(self.fc1.weight, gen)
        fan_in_uniform_(self.fc2.weight, gen)
        normal_(self.cls_logit.weight, 0.01, gen)
        normal_(self.bbox_delta.weight, 0.001, gen)
        for m in (self.fc1, self.fc2, self.cls_logit, self.bbox_delta):
            m.bias.zero_()


class BboxDualHeadSmall(nn.Module):
    """The Double-Head box head: roi_feat [B, R, P, P, C] -> (cls_logit
    [B, R, num_class] from two fc layers of 1024 on the flattened features,
    bbox_delta [B, R, 4 * num_reg_class] from num_block 3 x 3 convs of 256 on
    the roi's map, flattened into a dense layer). With a norm, each fc and
    each conv is followed by it: an fc layer's [B, R, 1024] output is normed
    as a [B, 1024, R] map, as Flax norms a dense output's last axis (batch
    statistics over B and R; GroupNorm per image over R). The layers run in
    the head's compute dtype, the logits and deltas in fp32."""

    def __init__(self, num_class, num_reg_class, in_channels=256, roi_size=7,
                 num_block=4, norm=None, dtype=torch.float32):
        super().__init__()
        hidden = 1024
        for i in (1, 2):
            self.add_module(f"cls_fc{i}", linear(
                in_channels * roi_size ** 2 if i == 1 else hidden, hidden,
                compute_dtype=dtype))
            if norm is not None:
                self.add_module(f"cls_fc{i}_norm", norm(hidden))
        self.cls_logit = nn.Linear(hidden, num_class)
        self.num_block = num_block
        for i in range(1, num_block + 1):
            self.add_module(f"reg_block{i}", conv2d(
                in_channels if i == 1 else 256, 256, 3, padding=1,
                compute_dtype=dtype))
            if norm is not None:
                self.add_module(f"reg_block{i}_norm", norm(256))
        self.bbox_delta = nn.Linear(256 * roi_size ** 2, 4 * num_reg_class)

    def _norm(self, name, x):
        norm = getattr(self, f"{name}_norm", None)
        return x if norm is None else norm(x)

    def forward(self, roi_feat):
        b, r, p, _, c = roi_feat.shape
        cls = roi_feat.reshape(b, r, -1)
        for i in (1, 2):
            cls = getattr(self, f"cls_fc{i}")(cls)
            cls = self._norm(f"cls_fc{i}", cls.transpose(1, 2)).transpose(1, 2)
            cls = F.relu(cls)
        # the NHWC rows viewed as NCHW in channels_last memory, at no cost
        reg = roi_feat.reshape(b * r, p, p, c).permute(0, 3, 1, 2)
        for i in range(1, self.num_block + 1):
            reg = F.relu(self._norm(f"reg_block{i}",
                                    getattr(self, f"reg_block{i}")(reg)))
        reg = reg.permute(0, 2, 3, 1).reshape(b, r, -1)
        return self.cls_logit(cls.float()), self.bbox_delta(reg.float())

    @torch.no_grad()
    def init_weights(self, gen):
        for i in (1, 2):
            m = getattr(self, f"cls_fc{i}")
            fan_in_uniform_(m.weight, gen)
            m.bias.zero_()
        normal_(self.cls_logit.weight, 0.01, gen)
        for i in range(1, self.num_block + 1):
            m = getattr(self, f"reg_block{i}")
            normal_(m.weight, 0.01, gen)
            m.bias.zero_()
        normal_(self.bbox_delta.weight, 0.001, gen)
        for m in (self.cls_logit, self.bbox_delta):
            m.bias.zero_()


def bbox_head_loss(cls_logit, bbox_delta, label, bbox_target, bbox_weight,
                   smooth_l1_scalar=1.0):
    """cls: softmax CE summed over the b * r rois, divided by b * r; reg:
    smooth-L1 times weight, summed, divided by b * r."""
    b, r = label.shape
    logp = torch.log_softmax(cls_logit, dim=-1)
    cls_ll = torch.gather(logp, -1, label.long()[..., None])[..., 0]
    reg = bbox_weight * smooth_l1(bbox_delta - bbox_target, smooth_l1_scalar)
    return {"bbox_cls_loss": -cls_ll.sum() / (b * r),
            "bbox_reg_loss": reg.sum() / (b * r)}


def bbox_head_predict(cls_logit, bbox_delta, rois, im_info, *, bbox_mean,
                      bbox_std, class_agnostic, num_class):
    """(cls_score [B, R, num_class], boxes [B, R, 4 * num_reg] clipped)."""
    score = torch.softmax(cls_logit, dim=-1)
    boxes = decode_boxes(rois, bbox_delta, means=bbox_mean, stds=bbox_std)
    boxes = clip_boxes(boxes, im_info[:, None, :2])
    if class_agnostic:
        boxes = boxes[..., 4:8].repeat(1, 1, num_class)
    return score, boxes
