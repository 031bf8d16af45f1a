"""Mask R-CNN (counterpart of simpledet_tpu/models/mask_rcnn.py: MaskHead4Conv
and MaskFasterRcnn with mode "train", "test" and "rpn_test").

Faster R-CNN plus a mask branch. In training, the sampler returns its rois
foreground first, so the branch takes the first `image_roi * fg_fraction`
rows of the sample (`num_fg`, 128 at 512 rois and 25%): their mask targets
come from the on-device polygon rasterizer (`targets/mask_target.py`,
without gradient, on the edge columns that are not padding everywhere), their features from the multilevel RoIAlign at
MaskRoiParam.out_size (14) through `FasterRcnn.extract_rois`, so the same
kernel entry serves both sizes; the loss is the sigmoid cross-entropy of the
fg class's channel, averaged over the fg rows' cells. At test time the box
head's outputs go through the per-class NMS, and the mask head runs on the
max_det kept boxes an image; the output holds each kept box's predicted
class's 28 x 28 probabilities.

Profiler ranges name the branch's stages: "mask_targets", "mask_roi_align"
and "mask_head" (the head and its loss).
"""
import torch
from torch import nn
from torch.nn import functional as F
from torch.profiler import record_function

from simpledet_torch.eval.postprocess import per_class_nms
from simpledet_torch.models.faster_rcnn import FasterRcnn
from simpledet_torch.models.init import msra_out_normal_
from simpledet_torch.ops.losses import sigmoid_cross_entropy
from simpledet_torch.targets.mask_target import (batched_mask_target,
                                                  trim_padding)

PROFILER_RANGES = ("mask_targets", "mask_roi_align", "mask_head")


class MaskHead4Conv(nn.Module):
    """roi_feat [B, F, P, P, C] -> logits [B, F, 2P, 2P, num_class]: four 3x3
    convs of dim_reduced channels, each with a ReLU, a 2x2 stride-2
    transposed conv and a ReLU, then a 1x1 conv to the classes. fp32 (the
    JAX package's bf16 variant is not ported). `mask_up` holds the
    transposed conv's weight as torch does, [in, out, kh, kw]: Flax's kernel
    flipped in both spatial axes (`weights.py`)."""

    def __init__(self, num_class, in_channels=256, dim_reduced=256):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"mask_conv{i}", nn.Conv2d(
                in_channels if i == 1 else dim_reduced, dim_reduced, 3,
                padding=1))
        self.mask_up = nn.ConvTranspose2d(dim_reduced, dim_reduced, 2,
                                          stride=2)
        self.mask_fcn_logit = nn.Conv2d(dim_reduced, num_class, 1)
        self.num_class = num_class

    def forward(self, roi_feat):
        b, f, p, _, c = roi_feat.shape
        # the NHWC rows viewed as NCHW in channels_last memory, at no cost
        x = roi_feat.reshape(b * f, p, p, c).permute(0, 3, 1, 2)
        for i in range(1, 5):
            x = F.relu(getattr(self, f"mask_conv{i}")(x))
        x = F.relu(self.mask_up(x)).float()
        logit = self.mask_fcn_logit(x)
        return logit.permute(0, 2, 3, 1).reshape(b, f, 2 * p, 2 * p,
                                                 self.num_class)

    @torch.no_grad()
    def init_weights(self, gen):
        convs = [getattr(self, f"mask_conv{i}") for i in range(1, 5)]
        for m in (*convs, self.mask_up, self.mask_fcn_logit):
            w = m.weight        # [out, in, kh, kw]; mask_up [in, out, kh, kw]
            out = w.shape[1] if m is self.mask_up else w.shape[0]
            msra_out_normal_(w, gen, out * w.shape[2] * w.shape[3])
            m.bias.zero_()


def class_channel(mask, cls):
    """mask [B, D, M, M, num_class], cls [B, D] -> [B, D, M, M]: each row's
    class's channel."""
    idx = cls.long()[:, :, None, None, None].expand(*mask.shape[:4], 1)
    return torch.gather(mask, -1, idx)[..., 0]


class MaskFasterRcnn(FasterRcnn):
    """FasterRcnn with a mask branch. p_mask is the nothrow MaskParam
    (resolution), p_mask_roi the mask branch's RoiParam, p_test the
    TestParam of the config's BboxPostProcessor (score threshold, NMS
    threshold, max_det), or None for the JAX package's defaults (0.05, 0.5,
    100). fixed_proposals and deterministic_sampling as in FasterRcnn."""

    def __init__(self, backbone, neck, rpn_module, rpn, bbox_head, mask_head,
                 p_roi, p_bbox, p_mask, p_mask_roi, p_test=None, *,
                 fixed_proposals=False, deterministic_sampling=False):
        super().__init__(backbone, neck, rpn_module, rpn, bbox_head, p_roi,
                         p_bbox, fixed_proposals=fixed_proposals,
                         deterministic_sampling=deterministic_sampling)
        self.mask_head = mask_head
        self.p_mask = p_mask
        self.p_mask_roi = p_mask_roi
        self.p_test = p_test

    @property
    def mask_size(self):
        return self.p_mask.resolution or 28

    @property
    def num_fg(self):
        ps = self.rpn.p.subsample_proposal
        return int(ps.image_roi * ps.fg_fraction)

    def extract_mask_rois(self, pyramid, rois):
        """rois [B, D, 4] -> [B, D, P, P, C] at MaskRoiParam.out_size."""
        return self.extract_rois(pyramid, rois, self.p_mask_roi)

    def forward(self, data, im_info, gt_bbox=None, gt_poly=None, mode="test",
                *, generator=None, score_thr=None):
        """mode "train" needs gt_bbox [B, G, 5], gt_poly [B, G, E, 5] and a
        torch.Generator on the data's device; score_thr, at test time,
        replaces the config's score threshold."""
        if mode == "train":
            return self.train_losses(data, im_info, gt_bbox, gt_poly,
                                     generator)
        if mode not in ("test", "rpn_test"):
            raise NotImplementedError(f"MaskFasterRcnn mode {mode!r}")
        with torch.no_grad():
            return self.test_outputs(data, im_info, mode, score_thr)

    def nms_params(self, score_thr=None):
        """(score_thr, nms_thr, max_det) of the per-class NMS, read as the
        JAX package reads its TestParam."""
        t = self.p_test
        if score_thr is None:
            score_thr = (t and t.min_det_score) or 0.05
        nms_thr = (t and t.nms and t.nms.thr) or 0.5
        return score_thr, nms_thr, (t and t.max_det_per_image) or 100

    def mask_probs(self, mask_feat, cls):
        """Mask features [B, D, P, P, C] of the kept boxes and their classes
        [B, D] -> [B, D, M, M] probabilities of each box's class."""
        return torch.sigmoid(class_channel(self.mask_head(mask_feat), cls))

    def test_outputs(self, data, im_info, mode, score_thr=None):
        pyr = self.pyramid(data)
        rpn_out = self.rpn_module(pyr)
        proposals, prop_scores = self.rpn.proposals(rpn_out, im_info)
        if mode == "rpn_test":
            return {"proposal": proposals, "proposal_score": prop_scores}
        roi_feat = self.extract_rois(pyr, proposals)
        cls_logit, bbox_delta = self.bbox_head(roi_feat)
        score, boxes = self.predict(cls_logit, bbox_delta, proposals, im_info)
        thr, nms_thr, max_det = self.nms_params(score_thr)
        boxes, scores, cls, valid = per_class_nms(
            score, boxes, score_thr=thr, nms_thr=nms_thr, max_det=max_det)
        out = {"cls_score": scores, "bbox_xyxy": boxes, "cls": cls,
               "det_valid": valid}
        out.update(self.mask_outputs(pyr, out))
        return out

    def mask_outputs(self, pyr, det):
        """The mask branch's test outputs on the kept boxes of `det`
        ({"bbox_xyxy", "cls", ...}): {"mask_prob" [B, D, M, M]}."""
        mask_feat = self.extract_mask_rois(pyr, det["bbox_xyxy"])
        return {"mask_prob": self.mask_probs(mask_feat, det["cls"])}

    def train_losses(self, data, im_info, gt_bbox, gt_poly, generator):
        """(losses, aux): FasterRcnn's, plus "mask_loss" and aux
        "mask_target" [B, num_fg, M, M]."""
        if gt_poly is None:
            raise ValueError("MaskFasterRcnn's train mode needs gt_poly")
        pyr, sample, losses, aux = self.box_branch(data, im_info, gt_bbox,
                                                   generator)
        _, targets, _, _, losses["mask_loss"] = self.mask_branch(
            pyr, sample, gt_poly)
        aux["mask_target"] = targets
        return losses, aux

    def mask_branch(self, pyr, sample, gt_poly):
        """The train forward's mask branch on the sample's first num_fg
        rows: (their rois, their mask targets, their mask features, the
        logits of each row's class [B, num_fg, M, M], mask_loss)."""
        nf = self.num_fg
        rois = sample["rois"][:, :nf].contiguous()
        with torch.no_grad(), record_function("mask_targets"):
            targets = batched_mask_target(
                rois, sample["gt_index"][:, :nf], sample["fg_mask"][:, :nf],
                trim_padding(gt_poly), mask_size=self.mask_size)
        with record_function("mask_roi_align"):
            mask_feat = self.extract_mask_rois(pyr, rois)
        with record_function("mask_head"):
            logit = class_channel(self.mask_head(mask_feat),
                                  sample["label"][:, :nf])
            loss = sigmoid_cross_entropy(logit, targets)
        return rois, targets, mask_feat, logit, loss

    def init_weights(self, gen):
        super().init_weights(gen)
        self.mask_head.init_weights(gen)
