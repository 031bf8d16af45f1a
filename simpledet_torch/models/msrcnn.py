"""Mask Scoring R-CNN (counterpart of simpledet_tpu/models/msrcnn.py):
Mask R-CNN with a MaskIoU head that regresses each mask's IoU with its
instance.

`MaskIoUHead`: the 14 x 14 mask roi features concatenated with the fg
class's mask logits max-pooled 2x (28 -> 14, one channel), three 3 x 3
convs of 256 and a 3 x 3 conv at stride 2 (padded as Flax's SAME: (0, 1)),
each with a relu, two fc layers of 1024 with relus and a fc to the classes.
Flax names `iou_head_conv_{0..3}`, `iou_head_FC1`, `iou_head_FC2`,
`iou_head_pred`, under `maskiou_head`.

Training target (`maskiou_target`): the IoU of the binarised predicted mask
with the binarised target on the roi's grid, the target's cell count taken
from the whole instance (its polygons' shoelace area over the cell's area,
at least the cells inside the roi), over the fg rois; `maskiou_loss` is half
the squared error of the row's class's prediction, averaged over the fg
rois. The predicted masks carry no gradient into the target; the head's
input logits do carry it back into the mask head, as in the JAX package.
At test time the kept boxes' predicted IoU times their scores is
`mask_score`; the eval CLI, as the JAX package's, scores the segm results by
`cls_score` and reads no `mask_score`.
Profiler range: "maskiou_head" (the head and its loss).
"""
import torch
from torch import nn
from torch.nn import functional as F
from torch.profiler import record_function

from simpledet_torch.kernels.roi_align import true_div
from simpledet_torch.models.init import fan_in_uniform_, msra_out_normal_, \
    normal_
from simpledet_torch.models.layers import SameConv2d, conv2d, linear
from simpledet_torch.models.mask_rcnn import MaskFasterRcnn, class_channel

PROFILER_RANGES = ("maskiou_head",)


def polygon_area(edges):
    """Shoelace area of packed edges [..., E, 5] (rows (xa, ya, xb, yb,
    seg_id), seg_id -1 for padding); holes are not subtracted."""
    valid = edges[..., 4] >= 0
    cross = edges[..., 0] * edges[..., 3] - edges[..., 2] * edges[..., 1]
    return 0.5 * torch.where(valid, cross, torch.zeros_like(cross)).sum(
        -1).abs()


def maskiou_target(mask_prob, mask_tgt, rois, gt_poly, gt_index, fg_mask):
    """mask_prob, mask_tgt [B, F, M, M]; rois [B, F, 4]; gt_poly
    [B, G, E, 5]; gt_index, fg_mask [B, F] -> (iou [B, F], 0 off the fg
    rows; weight [B, F], fg_mask as float)."""
    b, f, m = mask_tgt.shape[:3]
    pred = mask_prob > 0.5
    tgt = mask_tgt > 0.5
    inter = (pred & tgt).sum((2, 3)).float()
    pred_sum = pred.sum((2, 3)).float()
    tgt_sum = tgt.sum((2, 3)).float()
    w = (rois[..., 2] - rois[..., 0]).clamp(min=1.0)
    h = (rois[..., 3] - rois[..., 1]).clamp(min=1.0)
    cell = true_div(w * h, m * m)
    idx = gt_index.long().clamp(0, gt_poly.shape[1] - 1)
    img = torch.arange(b, device=rois.device)[:, None].expand(b, f)
    full_area = polygon_area(gt_poly[img, idx])
    full_cells = torch.maximum(full_area / cell.clamp(min=1e-6), tgt_sum)
    union = (full_cells + pred_sum - inter).clamp(min=1.0)
    iou = inter / union
    return torch.where(fg_mask, iou, torch.zeros_like(iou)), fg_mask.float()


class MaskIoUHead(nn.Module):
    """(mask roi features [B, F, P, P, C], the fg class's mask logits
    [B, F, 2P, 2P]) -> predicted IoU [B, F, num_class]. The convs and fc
    layers run in the head's compute dtype, the prediction in fp32."""

    def __init__(self, num_class, in_channels=256, roi_size=14,
                 conv_channel=256, dtype=torch.float32):
        super().__init__()
        for i in range(3):
            self.add_module(f"iou_head_conv_{i}", conv2d(
                in_channels + 1 if i == 0 else conv_channel, conv_channel, 3,
                padding=1, compute_dtype=dtype))
        self.iou_head_conv_3 = SameConv2d(conv_channel, conv_channel, 3,
                                          stride=2, compute_dtype=dtype)
        side = -(-roi_size // 2)
        self.iou_head_FC1 = linear(conv_channel * side * side, 1024,
                                   compute_dtype=dtype)
        self.iou_head_FC2 = linear(1024, 1024, compute_dtype=dtype)
        self.iou_head_pred = nn.Linear(1024, num_class)
        self.num_class = num_class

    def forward(self, roi_feat, fg_mask_logit):
        b, f, p, _, c = roi_feat.shape
        # the NHWC rows viewed as NCHW in channels_last memory, at no cost
        x = roi_feat.reshape(b * f, p, p, c).permute(0, 3, 1, 2)
        m = F.max_pool2d(fg_mask_logit.reshape(b * f, 1, 2 * p, 2 * p), 2, 2)
        x = torch.cat([x, m.to(x.dtype)], dim=1)
        for i in range(4):
            x = F.relu(getattr(self, f"iou_head_conv_{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(b * f, -1)
        x = F.relu(self.iou_head_FC1(x))
        x = F.relu(self.iou_head_FC2(x))
        return self.iou_head_pred(x.float()).reshape(b, f, self.num_class)

    @torch.no_grad()
    def init_weights(self, gen):
        for i in range(4):
            m = getattr(self, f"iou_head_conv_{i}")
            msra_out_normal_(m.weight, gen, m.weight.shape[0] * 9)
            m.bias.zero_()
        for m in (self.iou_head_FC1, self.iou_head_FC2):
            fan_in_uniform_(m.weight, gen)
            m.bias.zero_()
        normal_(self.iou_head_pred.weight, 0.01, gen)
        self.iou_head_pred.bias.zero_()


class MaskScoringFasterRcnn(MaskFasterRcnn):
    """MaskFasterRcnn with a MaskIoUHead (`maskiou_head`). Train mode adds
    "maskiou_loss"; test mode adds "mask_score" [B, D]."""

    def __init__(self, *args, maskiou_head, **kw):
        super().__init__(*args, **kw)
        self.maskiou_head = maskiou_head

    def train_losses(self, data, im_info, gt_bbox, gt_poly, generator):
        if gt_poly is None:
            raise ValueError("MaskScoringFasterRcnn's train mode needs "
                             "gt_poly")
        pyr, sample, losses, aux = self.box_branch(data, im_info, gt_bbox,
                                                   generator)
        rois, targets, mask_feat, logit, losses["mask_loss"] = \
            self.mask_branch(pyr, sample, gt_poly)
        nf = self.num_fg
        with torch.no_grad():
            iou_tgt, iou_w = maskiou_target(
                torch.sigmoid(logit), targets.clamp(min=0.0), rois, gt_poly,
                sample["gt_index"][:, :nf], sample["fg_mask"][:, :nf])
        with record_function("maskiou_head"):
            cls = sample["label"][:, :nf].long()
            iou_pred = self.maskiou_head(mask_feat, logit).gather(
                -1, cls[..., None])[..., 0]
            l2 = 0.5 * (iou_pred - iou_tgt) ** 2
            losses["maskiou_loss"] = (l2 * iou_w).sum() / iou_w.sum().clamp(
                min=1.0)
        aux["mask_target"] = targets
        return losses, aux

    def mask_outputs(self, pyr, det):
        """mask_prob and mask_score on the kept boxes of `det`."""
        mask_feat = self.extract_mask_rois(pyr, det["bbox_xyxy"])
        logit = class_channel(self.mask_head(mask_feat), det["cls"])
        return {"mask_prob": torch.sigmoid(logit),
                "mask_score": self.mask_scores(mask_feat, logit, det["cls"],
                                               det["cls_score"])}

    def mask_scores(self, mask_feat, logit, cls, scores):
        """The kept boxes' scores [B, D] times their class's predicted IoU,
        from their mask features and their class's mask logits."""
        iou = self.maskiou_head(mask_feat, logit).gather(
            -1, cls.long()[..., None])[..., 0]
        return scores * iou

    def init_weights(self, gen):
        super().init_weights(gen)
        self.maskiou_head.init_weights(gen)
