"""2fc box head, its loss and its test-time prediction (counterpart of
simpledet_tpu/models/heads.py::Bbox2fcHead, bbox_head_loss and
bbox_head_predict).

RoI features arrive as [B, R, P, P, C] and are flattened in HWC order, as in
the JAX package, so fc1's weight is the transposed Flax kernel. fc1 and fc2
run in the head's compute dtype; the logits and deltas run in fp32 (fp32
islands), as do the losses and the prediction.
"""
import torch
from torch import nn
from torch.nn import functional as F

from simpledet_torch.models.init import fan_in_uniform_, normal_
from simpledet_torch.models.layers import linear
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
