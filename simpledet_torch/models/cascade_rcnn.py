"""Cascade R-CNN (counterpart of simpledet_tpu/models/cascade_rcnn.py:
`decode_refined` and `CascadeRcnn` with mode "train", "test" and
"rpn_test").

Three box heads with their own parameters (`head_1st`, `head_2nd`,
`head_3rd`, the Flax names). In training, stage 1 samples the RPN's
proposals with `RpnParam.subsample_proposal` / `bbox_target`; stage k + 1
samples the boxes that stage k's class-agnostic deltas decode to, with stage
k's `BboxParam.subsample_proposal` / `bbox_target` (the IoU ladder 0.5 /
0.6 / 0.7 and the tightening target stds of the configs), and each stage's
two losses are scaled by its `loss_weight`. At test time the boxes are
refined through all three stages; the class scores are the mean of the
three heads' softmaxes, all three heads applied to the stage-3 features,
and the boxes are stage 3's decode tiled over the classes. Every stage keeps
the static roi count, so RoIAlign runs three times a step on [B, R, 4] rois.
"""
import torch

from simpledet_torch.models.faster_rcnn import (FasterRcnn,
                                                deterministic_proposals)
from simpledet_torch.models.heads import bbox_head_loss
from simpledet_torch.ops.bbox import clip_boxes, decode_boxes
from simpledet_torch.targets.proposal_target import batched_proposal_target

STAGES = ("1st", "2nd", "3rd")


def decode_refined(proposal, bbox_delta, im_info, *, mean, std,
                   class_agnostic=True):
    """Stage-k deltas [B, R, 4 * num_reg] on proposal [B, R, 4] -> the
    stage-(k+1) proposals [B, R, 4]: decoded with the stage's (mean, std),
    the foreground box (columns 4:8) when class-agnostic, clipped to
    im_info, carrying no gradient."""
    boxes = decode_boxes(proposal, bbox_delta, means=mean, stds=std)
    if class_agnostic:
        boxes = boxes[..., 4:8]
    boxes = clip_boxes(boxes, im_info[:, None, :2])
    return boxes.detach().contiguous()


def is_class_agnostic(rt):
    """A cascade head's regress_target.class_agnostic: None reads as True
    (`simpledet_tpu/dsl.py::CascadeBbox2fcHead`)."""
    return True if rt.class_agnostic is None else bool(rt.class_agnostic)


class CascadeRcnn(FasterRcnn):
    """backbone -> neck -> rpn_module (params) ; rpn (targets, losses and
    proposals) ; three stage heads. p_bboxes are the three nothrow
    BboxParams. The pyramid and RoIAlign are FasterRcnn's.

    fixed_proposals and deterministic_sampling as in FasterRcnn (stage 1's
    proposals from the gt; `arange` priorities in every stage's sampler)."""

    def __init__(self, backbone, neck, rpn_module, rpn, heads, p_roi,
                 p_bboxes, *, fixed_proposals=False,
                 deterministic_sampling=False):
        torch.nn.Module.__init__(self)
        self.backbone = backbone
        self.neck = neck
        self.rpn_module = rpn_module
        self.head_1st, self.head_2nd, self.head_3rd = heads
        self.rpn = rpn
        self.p_roi = p_roi
        self.p_bboxes = tuple(p_bboxes)
        self.fixed_proposals = fixed_proposals
        self.deterministic_sampling = deterministic_sampling

    @property
    def heads(self):
        return (self.head_1st, self.head_2nd, self.head_3rd)

    def stage_name(self, i):
        return self.p_bboxes[i].stage or f"stage{i + 1}"

    def sampling_params(self, i):
        """(subsample_proposal, bbox_target) that stage i samples with: the
        RPN's for stage 0, stage i - 1's BboxParam's after it."""
        p = self.rpn.p if i == 0 else self.p_bboxes[i - 1]
        return p.subsample_proposal, p.bbox_target

    def sample(self, generator, proposals, gt_bbox, i):
        """Stage i's proposal-target sample of proposals [B, R, 4]."""
        ps, pt = self.sampling_params(i)
        with torch.no_grad():
            return batched_proposal_target(
                generator, proposals, gt_bbox, image_rois=ps.image_roi,
                fg_fraction=ps.fg_fraction, fg_thr=ps.fg_thr,
                bg_thr_hi=ps.bg_thr_hi, bg_thr_lo=ps.bg_thr_lo,
                num_reg_class=pt.num_reg_class,
                class_agnostic=pt.class_agnostic or False,
                proposal_wo_gt=ps.proposal_wo_gt or False,
                bbox_mean=pt.mean, bbox_std=pt.std, bbox_weight=pt.weight,
                deterministic=self.deterministic_sampling)

    def refine(self, rois, bbox_delta, im_info, i):
        """Stage i's deltas on its rois -> stage i + 1's proposals."""
        rt = self.p_bboxes[i].regress_target
        return decode_refined(rois, bbox_delta, im_info, mean=rt.mean,
                              std=rt.std,
                              class_agnostic=is_class_agnostic(rt))

    def test_outputs(self, data, im_info, mode):
        pyr = self.pyramid(data)
        rpn_out = self.rpn_module(pyr)
        proposals, prop_scores = self.rpn.proposals(rpn_out, im_info)
        if mode == "rpn_test":
            return {"proposal": proposals, "proposal_score": prop_scores}
        cur, logits = proposals, []
        for i, head in enumerate(self.heads):
            roi_feat = self.extract_rois(pyr, cur)
            cls_logit, bbox_delta = head(roi_feat)
            logits.append(cls_logit)
            cur = self.refine(cur, bbox_delta, im_info, i)
        score, boxes = self.average_scores(roi_feat, logits[2], cur)
        return {"cls_score": score, "bbox_xyxy": boxes, "rois": proposals,
                "roi_score": prop_scores}

    def average_scores(self, feat3, logit3, boxes3):
        """(the mean of the three heads' softmaxes on the stage-3 features,
        stage 3's boxes tiled over the classes)."""
        s1, _ = self.head_1st(feat3)
        s2, _ = self.head_2nd(feat3)
        score = (torch.softmax(s1, -1) + torch.softmax(s2, -1)
                 + torch.softmax(logit3, -1)) / 3.0
        num_class = self.p_bboxes[2].num_class
        return score, boxes3.repeat(1, 1, num_class)

    def train_losses(self, data, im_info, gt_bbox, generator):
        """(losses, aux) with the JAX package's keys: the RPN's and each
        stage's `bbox_cls_loss_<stage>` / `bbox_reg_loss_<stage>` (times its
        loss_weight); aux `bbox_label_<stage>` / `bbox_cls_logit_<stage>`
        and, for stage 1, `bbox_label` / `bbox_cls_logit`."""
        if gt_bbox is None or generator is None:
            raise ValueError("train mode needs gt_bbox and a generator")
        pyr = self.pyramid(data)
        rpn_out = self.rpn_module(pyr)
        rpn_losses, rpn_aux = self.rpn.loss(
            generator, rpn_out, gt_bbox, im_info,
            deterministic=self.deterministic_sampling)
        with torch.no_grad():
            cur, _ = self.rpn.proposals(rpn_out, im_info)
            if self.fixed_proposals:
                cur = deterministic_proposals(gt_bbox, cur.shape[1])
        losses, aux = dict(rpn_losses), dict(rpn_aux)
        for i, (head, p) in enumerate(zip(self.heads, self.p_bboxes)):
            sample = self.sample(generator, cur, gt_bbox, i)
            roi_feat = self.extract_rois(pyr, sample["rois"])
            cls_logit, bbox_delta = head(roi_feat)
            stage = bbox_head_loss(cls_logit, bbox_delta, sample["label"],
                                   sample["bbox_target"],
                                   sample["bbox_weight"])
            w = p.loss_weight if p.loss_weight is not None else 1.0
            s = self.stage_name(i)
            losses[f"bbox_cls_loss_{s}"] = w * stage["bbox_cls_loss"]
            losses[f"bbox_reg_loss_{s}"] = w * stage["bbox_reg_loss"]
            aux[f"bbox_label_{s}"] = sample["label"]
            aux[f"bbox_cls_logit_{s}"] = cls_logit
            if i == 0:
                aux["bbox_label"] = sample["label"]
                aux["bbox_cls_logit"] = cls_logit
            if i + 1 < len(self.heads):
                cur = self.refine(sample["rois"], bbox_delta, im_info, i)
        return losses, aux

    def init_weights(self, gen):
        for m in (self.backbone, self.neck, self.rpn_module, *self.heads):
            m.init_weights(gen)
