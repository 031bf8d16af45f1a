"""Faster R-CNN, test modes (counterpart of
simpledet_tpu/models/faster_rcnn.py::FasterRcnn with mode "test" and
"rpn_test").

Input is the normalised NHWC batch [B, H, W, 3] float32 that the JAX package
takes; it is viewed as NCHW in channels_last memory format at no cost, so
every conv runs channels_last and the pyramid's maps reach the RoIAlign kernel
as NHWC-contiguous data. Outputs keep the JAX package's keys and layouts.
"""
import torch
from torch import nn

from simpledet_torch.kernels.roi_align import multilevel_roi_align
from simpledet_torch.models.heads import bbox_head_predict


class FasterRcnn(nn.Module):
    """backbone -> neck -> rpn_module (params) ; rpn (proposal helper) ;
    bbox_head. p_roi / p_bbox are the nothrow RoiParam / BboxParam."""

    def __init__(self, backbone, neck, rpn_module, rpn, bbox_head, p_roi,
                 p_bbox):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_module = rpn_module
        self.bbox_head = bbox_head
        self.rpn = rpn
        self.p_roi = p_roi
        self.p_bbox = p_bbox

    def pyramid(self, data):
        """[B, H, W, 3] -> {"stride4": [B, 256, H/4, W/4], ...} NCHW."""
        x = data.permute(0, 3, 1, 2)            # channels_last view, no copy
        return self.neck(self.backbone(x))

    def extract_rois(self, pyramid, rois):
        """rois [B, R, 4] -> [B, R, P, P, C] from P2..P5."""
        strides = tuple(self.p_roi.stride)
        feats = [pyramid[f"stride{s}"].permute(0, 2, 3, 1).contiguous()
                 for s in strides]
        return multilevel_roi_align(
            feats, rois, strides, out_size=self.p_roi.out_size,
            canonical_scale=self.p_roi.roi_canonical_scale or 224,
            canonical_level=self.p_roi.roi_canonical_level or 4)

    def predict(self, cls_logit, bbox_delta, rois, im_info):
        rt = self.p_bbox.regress_target
        return bbox_head_predict(
            cls_logit, bbox_delta, rois, im_info, bbox_mean=rt.mean,
            bbox_std=rt.std, class_agnostic=rt.class_agnostic or False,
            num_class=self.p_bbox.num_class)

    @torch.no_grad()
    def forward(self, data, im_info, mode="test"):
        pyr = self.pyramid(data)
        rpn_out = self.rpn_module(pyr)
        proposals, prop_scores = self.rpn.proposals(rpn_out, im_info)
        if mode == "rpn_test":
            return {"proposal": proposals, "proposal_score": prop_scores}
        if mode != "test":
            raise NotImplementedError(f"FasterRcnn mode {mode!r}")
        roi_feat = self.extract_rois(pyr, proposals)
        cls_logit, bbox_delta = self.bbox_head(roi_feat)
        score, boxes = self.predict(cls_logit, bbox_delta, proposals, im_info)
        return {"cls_score": score, "bbox_xyxy": boxes, "rois": proposals,
                "roi_score": prop_scores}

    def init_weights(self, gen):
        for m in (self.backbone, self.neck, self.rpn_module, self.bbox_head):
            m.init_weights(gen)
