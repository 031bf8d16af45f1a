"""TSD, task-aware spatial disentanglement (counterpart of
simpledet_tpu/models/tsd.py): Faster R-CNN whose box head pools its
classification and its regression features apart.

`TSDBboxHead` on the sampled rois' RoIAlign features [B, R, P, P, C]:
  - a shared fc of 256 (`delta_shared_fc1`) feeds two predictors: delta_c,
    a (dx, dy) offset for each of the P x P bins (`delta_c_fc1`, `_fc2`), and
    delta_r, one (dx, dy) a roi (`delta_r_fc1`, `_fc2`);
  - rois_r are the rois shifted by delta_r * 0.1 * (w, h);
  - the classification branch pools the rois with delta_c as its bins'
    offsets, the regression branch pools rois_r with delta_r tiled over its
    bins (`ops/deform_roi_align.py`, trans_std 0.1: rois_r are shifted once
    by the head and their samples again by the pool; both shifts are the
    JAX package's), each then two fc layers (`TSD_pc_fc0/1`, `TSD_pr_fc0/1`)
    and its predictor (`tsd_cls_logit`, `tsd_reg_delta`);
  - the sibling 2fc head (`shared_fc0/1`, `bbox_cls_logit`,
    `bbox_reg_delta`) on the RoIAlign features, as Faster R-CNN's.
Training adds to Faster R-CNN's losses (the sibling's) the TSD branch's
(its regression targets re-encoded against rois_r, `tsd_reg_target`) and
the progressive constraints (`cls_pc_loss`: the TSD branch's gt-class
probability must beat the sibling's, without gradient, by a margin;
`reg_pc_loss`: its decoded box's IoU with the roi's gt must beat the
sibling's by a margin, over the fg rois). At test time the outputs are the
TSD branch's, decoded against rois_r. The two pools run under the profiler
range "tsd_pool".
"""
import torch
from torch import nn
from torch.nn import functional as F
from torch.profiler import record_function

from simpledet_torch.models.faster_rcnn import FasterRcnn
from simpledet_torch.models.heads import bbox_head_loss
from simpledet_torch.models.init import fan_in_uniform_, normal_
from simpledet_torch.models.layers import linear
from simpledet_torch.ops.bbox import bbox_overlaps, decode_boxes, \
    encode_boxes
from simpledet_torch.ops.deform_roi_align import deformable_roi_align

PROFILER_RANGES = ("tsd_pool",)


class TSDBboxHead(nn.Module):
    """(roi_feat [B, R, P, P, C], rois [B, R, 4], extract(rois,
    bin_offset [B, R, P, P, 2]) -> [B, R, P, P, C]) -> (cls_logit,
    bbox_delta, tsd_cls_logit, tsd_bbox_delta, rois_r). The fc layers of
    the three branches run in the head's compute dtype, the offset
    predictors and the logits and deltas in fp32."""

    def __init__(self, num_class, num_reg_class, in_channels=256, roi_size=7,
                 fc_channels=1024, delta_scale=0.1, dtype=torch.float32):
        super().__init__()
        flat = in_channels * roi_size ** 2
        self.roi_size = roi_size
        self.delta_scale = delta_scale
        self.delta_shared_fc1 = nn.Linear(flat, 256)
        self.delta_c_fc1 = nn.Linear(256, 256)
        self.delta_c_fc2 = nn.Linear(256, 2 * roi_size ** 2)
        self.delta_r_fc1 = nn.Linear(256, 256)
        self.delta_r_fc2 = nn.Linear(256, 2)
        for name in ("TSD_pc", "TSD_pr", "shared"):
            self.add_module(f"{name}_fc0", linear(flat, fc_channels,
                                                  compute_dtype=dtype))
            self.add_module(f"{name}_fc1", linear(fc_channels, fc_channels,
                                                  compute_dtype=dtype))
        self.tsd_cls_logit = nn.Linear(fc_channels, num_class)
        self.tsd_reg_delta = nn.Linear(fc_channels, 4 * num_reg_class)
        self.bbox_cls_logit = nn.Linear(fc_channels, num_class)
        self.bbox_reg_delta = nn.Linear(fc_channels, 4 * num_reg_class)

    def _fcs(self, x, name):
        for i in range(2):
            x = F.relu(getattr(self, f"{name}_fc{i}")(x))
        return x.float()

    def forward(self, roi_feat, rois, extract):
        b, r = roi_feat.shape[:2]
        ps = self.roi_size
        flat = roi_feat.reshape(b, r, -1).float()
        shared = F.relu(self.delta_shared_fc1(flat))
        delta_c = self.delta_c_fc2(F.relu(self.delta_c_fc1(shared)))
        delta_r = self.delta_r_fc2(F.relu(self.delta_r_fc1(shared)))
        w = rois[..., 2] - rois[..., 0]
        h = rois[..., 3] - rois[..., 1]
        shift = torch.stack([delta_r[..., 0] * self.delta_scale * w,
                             delta_r[..., 1] * self.delta_scale * h], -1)
        rois_r = rois + torch.cat([shift, shift], -1)
        tsd_cls_feat = extract(rois, delta_c.reshape(b, r, ps, ps, 2))
        tsd_reg_feat = extract(rois_r, delta_r[:, :, None, None, :].expand(
            b, r, ps, ps, 2))
        tsd_cls_x = self._fcs(tsd_cls_feat.reshape(b, r, -1), "TSD_pc")
        tsd_reg_x = self._fcs(tsd_reg_feat.reshape(b, r, -1), "TSD_pr")
        x = self._fcs(flat, "shared")
        return (self.bbox_cls_logit(x), self.bbox_reg_delta(x),
                self.tsd_cls_logit(tsd_cls_x), self.tsd_reg_delta(tsd_reg_x),
                rois_r)

    @torch.no_grad()
    def init_weights(self, gen):
        fan_in_uniform_(self.delta_shared_fc1.weight, gen)
        for name in ("TSD_pc", "TSD_pr", "shared"):
            for i in range(2):
                fan_in_uniform_(getattr(self, f"{name}_fc{i}").weight, gen)
        for m in (self.delta_c_fc1, self.delta_c_fc2, self.delta_r_fc1,
                  self.delta_r_fc2, self.tsd_cls_logit, self.tsd_reg_delta,
                  self.bbox_cls_logit):
            normal_(m.weight, 0.01, gen)
        normal_(self.bbox_reg_delta.weight, 0.001, gen)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.bias.zero_()


def _matched_gt(rois, gt_bbox):
    """[B, R, 4] rois, [B, G, 5] gt (class -1 padding) -> [B, R, 4] the gt
    box of highest IoU with each roi (the first at a tie)."""
    ov = bbox_overlaps(rois, gt_bbox[..., :4])
    ov = torch.where((gt_bbox[..., 4] != -1)[:, None, :], ov,
                     torch.full_like(ov, -1.0))
    arg = ov.argmax(-1)
    return torch.gather(gt_bbox[..., :4], 1, arg[..., None].expand(
        *arg.shape, 4))


def tsd_reg_target(rois_r, gt_bbox, label, num_reg_class, mean, std):
    """The TSD branch's regression targets [B, R, 4 * num_reg_class]: each
    roi's matched gt encoded against its shifted roi, in its label's slot,
    zero off the fg rois."""
    b, r = label.shape
    t = encode_boxes(rois_r, _matched_gt(rois_r, gt_bbox), means=mean,
                     stds=std)
    t = torch.where((label >= 1)[..., None], t, torch.zeros_like(t))
    onehot = (label.long()[..., None] == torch.arange(
        num_reg_class, device=label.device)).to(t.dtype)
    return (onehot[..., None] * t[..., None, :]).reshape(
        b, r, num_reg_class * 4)


def cls_pc_loss(logits, tsd_logits, label, margin=0.2):
    """Mean over the rois of relu(sibling p + min(1 - sibling p, margin) -
    TSD p), p each branch's probability of the roi's label; the sibling's
    without gradient."""
    idx = label.long()[..., None]
    cls_p = torch.softmax(logits, -1).gather(-1, idx)[..., 0].detach()
    tsd_p = torch.softmax(tsd_logits, -1).gather(-1, idx)[..., 0]
    m = torch.minimum(1.0 - cls_p, torch.full_like(cls_p, margin))
    return F.relu(-(tsd_p - cls_p - m)).mean()


def _pair_iou(a, b):
    return bbox_overlaps(a[..., None, :], b[..., None, :])[..., 0, 0]


def reg_pc_loss(bbox_delta, tsd_bbox_delta, rois, rois_r, gt_bbox, label,
                num_class, mean, std, margin=0.2):
    """Mean over the images of relu(sibling IoU + margin - TSD IoU) summed
    over the fg rois over their count (at least 1): each branch's box of
    the roi's label decoded against its rois (without gradient) and its
    IoU with the roi's gt; the sibling's IoU without gradient."""
    b, r = label.shape
    idx = label.long()[..., None, None].expand(b, r, 1, 4)
    d = bbox_delta.reshape(b, r, num_class, 4).gather(2, idx)[:, :, 0]
    td = tsd_bbox_delta.reshape(b, r, num_class, 4).gather(2, idx)[:, :, 0]
    boxes = decode_boxes(rois.detach(), d, means=mean, stds=std)
    tsd_boxes = decode_boxes(rois_r.detach(), td, means=mean, stds=std)
    gts = _matched_gt(rois, gt_bbox)
    iou_sib = _pair_iou(boxes, gts).detach()
    iou_tsd = _pair_iou(tsd_boxes, gts)
    fg = (label >= 1).float()
    loss = F.relu(-(iou_tsd - iou_sib - margin)) * fg
    return (loss.sum(1) / fg.sum(1).clamp(min=1.0)).mean()


class TSDFasterRcnn(FasterRcnn):
    """FasterRcnn with a TSDBboxHead. p_tsd is the nothrow TSD param class
    (BboxParam.TSD: pc_cls, pc_reg and their margins; None reads as both
    constraints on at margin 0.2)."""

    def __init__(self, *args, p_tsd=None, **kw):
        super().__init__(*args, **kw)
        self.p_tsd = p_tsd

    def extract_deform(self, pyramid, rois, bin_offset):
        """The deformable pool of rois [B, R, 4] with bin_offset
        [B, R, P, P, 2] on the box head's levels."""
        p_roi = self.p_roi
        strides = tuple(p_roi.stride)
        feats = [pyramid[f"stride{s}"].permute(0, 2, 3, 1).contiguous()
                 for s in strides]
        with record_function("tsd_pool"):
            return deformable_roi_align(
                feats, rois, bin_offset, strides, out_size=p_roi.out_size,
                canonical_scale=p_roi.roi_canonical_scale or 224,
                canonical_level=p_roi.roi_canonical_level or 4)

    def head(self, pyr, rois):
        """The TSD head on rois [B, R, 4]: (cls_logit, bbox_delta,
        tsd_cls_logit, tsd_bbox_delta, rois_r)."""
        return self.bbox_head(self.extract_rois(pyr, rois), rois,
                              lambda r, o: self.extract_deform(pyr, r, o))

    def test_outputs(self, data, im_info, mode):
        if mode == "rpn_test":
            return super().test_outputs(data, im_info, mode)
        pyr = self.pyramid(data)
        proposals, prop_scores = self.rpn.proposals(self.rpn_module(pyr),
                                                    im_info)
        _, _, tsd_cls, tsd_delta, rois_r = self.head(pyr, proposals)
        score, boxes = self.predict(tsd_cls, tsd_delta, rois_r, im_info)
        return {"cls_score": score, "bbox_xyxy": boxes, "rois": proposals,
                "roi_score": prop_scores}

    def sample_rois(self, rpn_out, im_info, gt_bbox, generator):
        """FasterRcnn's sample, with the gt boxes the TSD losses match."""
        return dict(super().sample_rois(rpn_out, im_info, gt_bbox,
                                        generator), gt_bbox=gt_bbox)

    def head_losses(self, pyr, sample, rpn_losses, rpn_aux):
        """The sibling's losses, the TSD branch's (tsd_cls_loss,
        tsd_reg_loss) and the progressive constraints (tsd_cls_pc_loss,
        tsd_reg_pc_loss), then the RPN's; aux bbox_cls_logit is the TSD
        branch's."""
        rois, label, gt = sample["rois"], sample["label"], sample["gt_bbox"]
        cls_logit, bbox_delta, tsd_cls, tsd_delta, rois_r = self.head(pyr,
                                                                      rois)
        losses = bbox_head_loss(cls_logit, bbox_delta, label,
                                sample["bbox_target"], sample["bbox_weight"])
        rt = self.p_bbox.regress_target
        with torch.no_grad():
            tsd_tgt = tsd_reg_target(rois_r, gt, label,
                                     self.rpn.p.bbox_target.num_reg_class,
                                     rt.mean, rt.std)
        tsd = bbox_head_loss(tsd_cls, tsd_delta, label, tsd_tgt,
                             sample["bbox_weight"])
        losses["tsd_cls_loss"] = tsd["bbox_cls_loss"]
        losses["tsd_reg_loss"] = tsd["bbox_reg_loss"]
        p = self.p_tsd
        if p is None or p.pc_cls is None or p.pc_cls:
            losses["tsd_cls_pc_loss"] = cls_pc_loss(
                cls_logit, tsd_cls, label,
                margin=(p and p.pc_cls_margin) or 0.2)
        if p is None or p.pc_reg is None or p.pc_reg:
            losses["tsd_reg_pc_loss"] = reg_pc_loss(
                bbox_delta, tsd_delta, rois, rois_r, gt, label,
                self.p_bbox.num_class, rt.mean, rt.std,
                margin=(p and p.pc_reg_margin) or 0.2)
        losses.update(rpn_losses)
        return losses, dict(rpn_aux, bbox_label=label,
                            bbox_cls_logit=tsd_cls)
