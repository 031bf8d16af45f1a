"""Faster R-CNN (counterpart of simpledet_tpu/models/faster_rcnn.py::FasterRcnn
with mode "train", "test" and "rpn_test") and the RPN-only detector
(`RpnOnly`).

Input is the normalised NHWC batch [B, H, W, 3] float32 that the JAX package
takes; it is viewed as NCHW in channels_last memory format at no cost, so
every conv runs channels_last and the pyramid's maps reach the RoIAlign kernel
as NHWC-contiguous data. Outputs keep the JAX package's keys and layouts. The
test modes run without autograd; train mode returns (losses, aux) and keeps
the graph for the backward.
"""
import torch
from torch import nn

from simpledet_torch.kernels.roi_align import multilevel_roi_align
from simpledet_torch.models.heads import bbox_head_loss, bbox_head_predict
from simpledet_torch.targets.proposal_target import batched_proposal_target


def deterministic_proposals(gt_bbox, n_prop):
    """[B, G, 5] padded gt (class -1) -> [B, n_prop, 4] proposals that depend
    only on gt: each gt box replicated through a fixed jitter table spanning
    high-IoU (fg) to low-IoU (bg) perturbations. With `fixed_proposals`, two
    implementations sample the same rois whatever ulps their convs differ
    by."""
    g = gt_bbox.shape[1]
    dev = gt_bbox.device
    idx = torch.arange(n_prop, device=dev) % g
    k = torch.arange(n_prop, device=dev) // g
    boxes = gt_bbox[:, idx, :4]
    valid = gt_bbox[:, idx, 4] >= 0
    boxes = torch.where(valid[..., None], boxes,
                        torch.tensor([0.0, 0.0, 32.0, 32.0], device=dev))
    # (dx, dy, size scale): rows 0-3 stay above fg_thr 0.5, the rest drift
    # into bg territory
    jit_tab = torch.tensor([
        [0.0, 0.0, 1.00], [2.0, -2.0, 1.00], [-3.0, 3.0, 0.92],
        [4.0, 4.0, 1.08], [12.0, -9.0, 1.30], [-18.0, 11.0, 0.65],
        [28.0, 24.0, 1.90], [-30.0, -22.0, 0.45]], device=dev)
    off = jit_tab[k % jit_tab.shape[0]]
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5 + off[:, 0]
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5 + off[:, 1]
    w = (boxes[..., 2] - boxes[..., 0] + 1.0) * off[:, 2]
    h = (boxes[..., 3] - boxes[..., 1] + 1.0) * off[:, 2]
    out = torch.stack([cx - 0.5 * (w - 1.0), cy - 0.5 * (h - 1.0),
                       cx + 0.5 * (w - 1.0), cy + 0.5 * (h - 1.0)], dim=-1)
    return out.clamp(min=0.0)


class RpnOnly(nn.Module):
    """The RPN-only detector (counterpart of
    simpledet_tpu/models/faster_rcnn.py::RpnOnly): backbone -> neck ->
    rpn_module; mode "train" returns the RPN's (losses, aux), any other
    mode {"proposal" [B, post, 4], "proposal_score" [B, post]} without
    autograd. deterministic_sampling gives the anchor sampler `arange`
    priorities (parity tests)."""

    def __init__(self, backbone, neck, rpn_module, rpn, *,
                 deterministic_sampling=False):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_module = rpn_module
        self.rpn = rpn
        self.deterministic_sampling = deterministic_sampling

    def pyramid(self, data):
        return self.neck(self.backbone(data.permute(0, 3, 1, 2)))

    def forward(self, data, im_info, gt_bbox=None, mode="test", *,
                generator=None):
        if mode == "train":
            if gt_bbox is None or generator is None:
                raise ValueError("train mode needs gt_bbox and a generator")
            rpn_out = self.rpn_module(self.pyramid(data))
            return self.rpn.loss(generator, rpn_out, gt_bbox, im_info,
                                 deterministic=self.deterministic_sampling)
        with torch.no_grad():
            rpn_out = self.rpn_module(self.pyramid(data))
            boxes, scores = self.rpn.proposals(rpn_out, im_info)
        return {"proposal": boxes, "proposal_score": scores}

    def init_weights(self, gen):
        for m in (self.backbone, self.neck, self.rpn_module):
            m.init_weights(gen)


class FasterRcnn(nn.Module):
    """backbone -> neck -> rpn_module (params) ; rpn (targets, losses and
    proposals) ; bbox_head. p_roi / p_bbox are the nothrow RoiParam /
    BboxParam.

    fixed_proposals replaces the RPN's proposals in train mode with
    `deterministic_proposals` of the gt (the JAX model's debug hook);
    deterministic_sampling gives every sampler `arange` priorities. Parity
    tests set both."""

    def __init__(self, backbone, neck, rpn_module, rpn, bbox_head, p_roi,
                 p_bbox, *, fixed_proposals=False,
                 deterministic_sampling=False):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_module = rpn_module
        self.bbox_head = bbox_head
        self.rpn = rpn
        self.p_roi = p_roi
        self.p_bbox = p_bbox
        self.fixed_proposals = fixed_proposals
        self.deterministic_sampling = deterministic_sampling

    def pyramid(self, data):
        """[B, H, W, 3] -> {"stride4": [B, 256, H/4, W/4], ...} NCHW."""
        x = data.permute(0, 3, 1, 2)            # channels_last view, no copy
        return self.neck(self.backbone(x))

    def extract_rois(self, pyramid, rois, p_roi=None):
        """rois [B, R, 4] -> [B, R, P, P, C] from the levels of p_roi (the
        box head's RoiParam unless another is given: a mask branch's); a
        C4 RoiParam gives one stride, 16."""
        p_roi = p_roi or self.p_roi
        strides = (tuple(p_roi.stride) if hasattr(p_roi.stride, "__len__")
                   else (p_roi.stride,))
        feats = [pyramid[f"stride{s}"].permute(0, 2, 3, 1).contiguous()
                 for s in strides]
        return multilevel_roi_align(
            feats, rois, strides, out_size=p_roi.out_size,
            canonical_scale=p_roi.roi_canonical_scale or 224,
            canonical_level=p_roi.roi_canonical_level or 4)

    def predict(self, cls_logit, bbox_delta, rois, im_info):
        rt = self.p_bbox.regress_target
        return bbox_head_predict(
            cls_logit, bbox_delta, rois, im_info, bbox_mean=rt.mean,
            bbox_std=rt.std, class_agnostic=rt.class_agnostic or False,
            num_class=self.p_bbox.num_class)

    def forward(self, data, im_info, gt_bbox=None, mode="test", *,
                generator=None):
        """mode "train" needs gt_bbox [B, G, 5] and a torch.Generator on the
        data's device for the samplers."""
        if mode == "train":
            return self.train_losses(data, im_info, gt_bbox, generator)
        if mode not in ("test", "rpn_test"):
            raise NotImplementedError(f"FasterRcnn mode {mode!r}")
        with torch.no_grad():
            return self.test_outputs(data, im_info, mode)

    def test_outputs(self, data, im_info, mode):
        pyr = self.pyramid(data)
        rpn_out = self.rpn_module(pyr)
        proposals, prop_scores = self.rpn.proposals(rpn_out, im_info)
        if mode == "rpn_test":
            return {"proposal": proposals, "proposal_score": prop_scores}
        roi_feat = self.extract_rois(pyr, proposals)
        cls_logit, bbox_delta = self.bbox_head(roi_feat)
        score, boxes = self.predict(cls_logit, bbox_delta, proposals, im_info)
        return {"cls_score": score, "bbox_xyxy": boxes, "rois": proposals,
                "roi_score": prop_scores}

    def train_losses(self, data, im_info, gt_bbox, generator):
        """(losses, aux) with the JAX package's keys. The anchor targets,
        proposals and sampled rois carry no gradient."""
        _, _, losses, aux = self.box_branch(data, im_info, gt_bbox, generator)
        return losses, aux

    def box_branch(self, data, im_info, gt_bbox, generator):
        """The train forward up to the box head's losses: (the pyramid, the
        proposal-target sample, losses, aux)."""
        if gt_bbox is None or generator is None:
            raise ValueError("train mode needs gt_bbox and a generator")
        pyr = self.pyramid(data)
        rpn_out = self.rpn_module(pyr)
        rpn_losses, rpn_aux = self.rpn.loss(
            generator, rpn_out, gt_bbox, im_info,
            deterministic=self.deterministic_sampling)
        sample = self.sample_rois(rpn_out, im_info, gt_bbox, generator)
        losses, aux = self.head_losses(pyr, sample, rpn_losses, rpn_aux)
        return pyr, sample, losses, aux

    @torch.no_grad()
    def sample_rois(self, rpn_out, im_info, gt_bbox, generator):
        """The train proposals (or `deterministic_proposals` of gt_bbox)
        and their proposal-target sample."""
        proposals, _ = self.rpn.proposals(rpn_out, im_info)
        if self.fixed_proposals:
            proposals = deterministic_proposals(gt_bbox, proposals.shape[1])
        ps = self.rpn.p.subsample_proposal
        pt = self.rpn.p.bbox_target
        return batched_proposal_target(
            generator, proposals, gt_bbox, image_rois=ps.image_roi,
            fg_fraction=ps.fg_fraction, fg_thr=ps.fg_thr,
            bg_thr_hi=ps.bg_thr_hi, bg_thr_lo=ps.bg_thr_lo,
            num_reg_class=pt.num_reg_class,
            class_agnostic=pt.class_agnostic or False,
            proposal_wo_gt=ps.proposal_wo_gt or False,
            bbox_mean=pt.mean, bbox_std=pt.std, bbox_weight=pt.weight,
            deterministic=self.deterministic_sampling)

    def head_losses(self, pyr, sample, rpn_losses, rpn_aux):
        """The box head on the sampled rois: (losses with the RPN's,
        aux)."""
        roi_feat = self.extract_rois(pyr, sample["rois"])
        cls_logit, bbox_delta = self.bbox_head(roi_feat)
        losses = bbox_head_loss(
            cls_logit, bbox_delta, sample["label"], sample["bbox_target"],
            sample["bbox_weight"],
            smooth_l1_scalar=self.p_bbox.regress_target.smooth_l1_scalar
            or 1.0)
        losses.update(rpn_losses)
        aux = dict(rpn_aux, bbox_label=sample["label"],
                   bbox_cls_logit=cls_logit)
        return losses, aux

    def init_weights(self, gen):
        for m in (self.backbone, self.neck, self.rpn_module, self.bbox_head):
            m.init_weights(gen)
