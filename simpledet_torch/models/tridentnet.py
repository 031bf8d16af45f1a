"""TridentNet and the C4 Faster R-CNN (counterpart of
simpledet_tpu/models/tridentnet.py, its TridentFasterRcnn and the modules
it is built from).

- Trident units (`TridentBottleneckV1` for v1 / v1b, `TridentBottleneckV2`
  pre-activation): the 3 x 3 kernel is one parameter, `conv2_kernel` (the
  Flax leaf's name), applied at each call's dilation d with an explicit
  (d, d) padding, at the unit's stride (v1b, v2) or at stride 1 (v1, whose
  stride sits on conv1). Not SAME padding: at stride 2 on an even side
  Flax's SAME pads (0, 1), which would shift every value.
- `TridentResNetC4`: stem and stages 1-2 once (v1 / v1b `Bottleneck`s, or
  v2 `BottleneckV2`s, which have no stage-exit norm), stage 3 once per
  branch at its dilation on the same input, the branches concatenated along
  the batch axis, branch-major: [nb * B, 1024, H/16, W/16]. v2 then applies
  `stage3_bn` and relu once, on the concatenation (under SyncBN its
  statistics span every branch); v1 has no `stage3_bn`. A trident unit's
  norms run once per branch, so a SyncBN's running statistics take one EMA
  step per branch, in branch order, as Flax's do. Published as `c4` and
  `stride16`.
- `BboxC5Head`: stage 4 (`stage4_unit{u}`, the first at stride 2) on the
  roi features [B, R, P, P, 1024], v2 units then `stage4_bn` and relu, or
  v1 / v1b units; a spatial mean; then the cls and reg Dense layers in fp32.
- `TridentFasterRcnn`: a FasterRcnn whose image axis carries nb branches.
  im_info and gt are repeated branch-major (`repeat(nb, ...)`, the JAX
  package's `concatenate([x] * nb)`), each branch's valid range repeated B
  times (`repeat_interleave`, its `jnp.repeat`). With scale-aware training
  the gt outside a branch's range become padding (class -1) for the RPN's
  targets and the roi sampler, and the RPN's labels of anchors that
  overlap such a gt above 0.3 read -1 in the returned aux (the RpnAcc
  metric); the loss is taken before that, as in the JAX package. The
  losses then take the folded batch through the existing RPN and box
  losses (divisors nb * B * image_anchor and nb * B * image_roi). At test
  time, scale-aware scores of boxes outside their branch's range are
  zeroed, and the branches fold into the detection axis,
  [nb * B, R, ...] -> [B, nb * R, ...] (each image's branch-0 rows first),
  before the usual per-class NMS.
"""
import torch
from torch import nn
from torch.nn import functional as F

from simpledet_torch.models.faster_rcnn import FasterRcnn
from simpledet_torch.models.init import (lecun_normal_, msra_out_normal_,
                                         normal_)
from simpledet_torch.models.norm import normalizer_factory
from simpledet_torch.models.resnet import (RESNET_UNITS, Bottleneck,
                                           BottleneckV2, conv)
from simpledet_torch.ops.bbox import bbox_overlaps

C4_VARIANTS = ("v1", "v1b", "v2")


class _SharedKernel(nn.Module):
    """The unit's 3 x 3 kernel, applied at a call's dilation."""

    def _init_shared(self, filters, stride, dtype):
        self.conv2_kernel = nn.Parameter(torch.empty(filters, filters, 3, 3))
        self.conv2_stride = stride
        self.dtype = dtype

    def dilated_conv2(self, y, d):
        dt = self.dtype
        return F.conv2d(y.to(dt), self.conv2_kernel.to(dt), None,
                        self.conv2_stride, d, d)


class TridentBottleneckV1(_SharedKernel):
    """Post-activation unit (v1: stride on conv1; v1b: on the 3 x 3)."""

    def __init__(self, cin, filters, stride, dtype, norm, variant="v1"):
        super().__init__()
        s1, s3 = (stride, 1) if variant == "v1" else (1, stride)
        self.conv1 = conv(cin, filters, 1, s1, dtype=dtype)
        self.bn1 = norm(filters)
        self._init_shared(filters, s3, dtype)
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, filters * 4, 1, dtype=dtype)
        self.bn3 = norm(filters * 4)
        self.has_sc = cin != filters * 4 or stride != 1
        if self.has_sc:
            self.sc_conv = conv(cin, filters * 4, 1, stride, dtype=dtype)
            self.sc_bn = norm(filters * 4)

    def forward(self, x, dilation=1):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.dilated_conv2(y, dilation)))
        y = self.bn3(self.conv3(y))
        residual = self.sc_bn(self.sc_conv(x)) if self.has_sc else x
        return F.relu(y + residual)


class TridentBottleneckV2(_SharedKernel):
    """Pre-activation unit; the stride on the 3 x 3 and on the shortcut."""

    def __init__(self, cin, filters, stride, dtype, norm):
        super().__init__()
        self.bn0 = norm(cin)
        self.conv1 = conv(cin, filters, 1, dtype=dtype)
        self.bn1 = norm(filters)
        self._init_shared(filters, stride, dtype)
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, filters * 4, 1, dtype=dtype)
        self.has_sc = cin != filters * 4 or stride != 1
        if self.has_sc:
            self.sc_conv = conv(cin, filters * 4, 1, stride, dtype=dtype)

    def forward(self, x, dilation=1):
        pre = F.relu(self.bn0(x))
        residual = self.sc_conv(pre) if self.has_sc else x
        y = F.relu(self.bn1(self.conv1(pre)))
        y = F.relu(self.bn2(self.dilated_conv2(y, dilation)))
        return self.conv3(y) + residual


def _init_convs(module, gen):
    """Flax's inits: lecun_normal for nn.Conv kernels; the shared trident
    kernel variance_scaling(2, fan_out, truncated_normal), its fan_out the
    output channels times 3 x 3."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, gen)
        elif isinstance(m, _SharedKernel):
            msra_out_normal_(m.conv2_kernel, gen,
                             m.conv2_kernel.shape[0] * 9)


class TridentResNetC4(nn.Module):
    """NCHW in, {"c4", "stride16"}: [nb * B, 1024, H/16, W/16] out
    (counterpart of TridentResNetV1C4 (v1, v1b) and TridentResNetV2C4)."""

    def __init__(self, depth=50, variant="v2", dtype=torch.float32,
                 norm=None, num_branch=3, dilations=(1, 2, 3)):
        super().__init__()
        if variant not in C4_VARIANTS:
            raise NotImplementedError(f"trident ResNet variant {variant!r}")
        if len(dilations) < num_branch:
            raise ValueError(f"{num_branch} branches, dilations {dilations}")
        norm = norm or normalizer_factory("fixbn")
        self.dtype = dtype
        self.variant = variant
        self.dilations = tuple(dilations[:num_branch])
        self.conv0 = conv(3, 64, 7, 2, 3, dtype=dtype)
        self.bn0 = norm(64)
        units = RESNET_UNITS[depth]
        self.trunk, self.trident = [], []
        cin = 64
        for stage, filters in enumerate((64, 128, 256)):
            for unit in range(units[stage]):
                name = f"stage{stage + 1}_unit{unit + 1}"
                stride = 2 if stage > 0 and unit == 0 else 1
                if stage == 2:
                    mod = (TridentBottleneckV2(cin, filters, stride, dtype,
                                               norm) if variant == "v2" else
                           TridentBottleneckV1(cin, filters, stride, dtype,
                                               norm, variant))
                    self.trident.append(name)
                else:
                    mod = (BottleneckV2(cin, filters, stride, dtype, norm)
                           if variant == "v2" else
                           Bottleneck(cin, filters, stride, dtype, norm,
                                      variant))
                    self.trunk.append(name)
                self.add_module(name, mod)
                cin = filters * 4
        if variant == "v2":
            self.stage3_bn = norm(1024)
        self.out_channels = 1024

    def stem_and_trunk(self, x):
        """The shared part: stem and stages 1-2, [B, 512, H/8, W/8]."""
        x = F.relu(self.bn0(self.conv0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.trunk:
            x = getattr(self, name)(x)
        return x

    def branches(self, x):
        """Stage 3 at each branch's dilation, concatenated branch-major."""
        outs = []
        for d in self.dilations:
            b = x
            for name in self.trident:
                b = getattr(self, name)(b, d)
            outs.append(b)
        out = torch.cat(outs, 0)
        if self.variant == "v2":
            out = F.relu(self.stage3_bn(out))
        return out

    def forward(self, x):
        out = self.branches(self.stem_and_trunk(x))
        return {"c4": out, "stride16": out}

    def init_weights(self, gen):
        _init_convs(self, gen)


class BboxC5Head(nn.Module):
    """roi_feat [B, R, P, P, 1024] -> (cls_logit [B, R, num_class],
    bbox_delta [B, R, 4 * num_reg_class]) (counterpart of BboxC5V2Head,
    and of BboxC5V1Head for v1 / v1b)."""

    def __init__(self, num_class, num_reg_class, depth=50, variant="v2",
                 dtype=torch.float32, norm=None, in_channels=1024):
        super().__init__()
        if variant not in C4_VARIANTS:
            raise NotImplementedError(f"C5 head variant {variant!r}")
        norm = norm or normalizer_factory("fixbn")
        self.dtype = dtype
        self.variant = variant
        self.units = []
        cin = in_channels
        for unit in range(RESNET_UNITS[depth][3]):
            name = f"stage4_unit{unit + 1}"
            stride = 2 if unit == 0 else 1
            self.add_module(name, BottleneckV2(cin, 512, stride, dtype, norm)
                            if variant == "v2" else
                            Bottleneck(cin, 512, stride, dtype, norm,
                                       variant))
            self.units.append(name)
            cin = 2048
        if variant == "v2":
            self.stage4_bn = norm(2048)
        self.cls_logit = nn.Linear(2048, num_class)
        self.bbox_delta = nn.Linear(2048, 4 * num_reg_class)

    def forward(self, roi_feat):
        b, r, p, _, c = roi_feat.shape
        # NHWC rows viewed as channels_last NCHW, no copy
        x = roi_feat.reshape(b * r, p, p, c).permute(0, 3, 1, 2).to(
            self.dtype)
        for name in self.units:
            x = getattr(self, name)(x)
        if self.variant == "v2":
            x = F.relu(self.stage4_bn(x))
        x = x.mean((2, 3)).float()
        return (self.cls_logit(x).reshape(b, r, -1),
                self.bbox_delta(x).reshape(b, r, -1))

    @torch.no_grad()
    def init_weights(self, gen):
        _init_convs(self, gen)
        normal_(self.cls_logit.weight, 0.01, gen)
        normal_(self.bbox_delta.weight, 0.001, gen)
        self.cls_logit.bias.zero_()
        self.bbox_delta.bias.zero_()


def _size2(boxes):
    return ((boxes[..., 2] - boxes[..., 0] + 1.0)
            * (boxes[..., 3] - boxes[..., 1] + 1.0))


def _in_range(size2, ranges):
    """size2 [N, K], ranges [N, 2] -> [N, K] within [lo^2, hi^2]."""
    return ((size2 >= ranges[:, None, 0] ** 2)
            & (size2 <= ranges[:, None, 1] ** 2))


def filter_gt_by_range(gt_bbox, ranges):
    """gt [N, G, 5], ranges [N, 2] -> gt whose boxes outside their image's
    sqrt-area range are padding (class -1)."""
    ok = _in_range(_size2(gt_bbox), ranges)
    cls = torch.where(ok & (gt_bbox[..., 4] != -1), gt_bbox[..., 4],
                      torch.full_like(gt_bbox[..., 4], -1.0))
    return torch.cat([gt_bbox[..., :4], cls[..., None]], -1)


def ignore_anchors_near_invalid_gt(label, anchors, gt_bbox, ranges,
                                   invalid_thr=0.3):
    """label [N, A], anchors [A, 4], gt [N, G, 5] (unfiltered), ranges
    [N, 2] -> label with -1 where an anchor overlaps a real gt outside its
    image's range by more than invalid_thr."""
    invalid = ~_in_range(_size2(gt_bbox), ranges) & (gt_bbox[..., 4] != -1)
    ov = bbox_overlaps(anchors, gt_bbox[..., :4])          # [N, A, G]
    ov = torch.where(invalid[:, None, :], ov, torch.zeros_like(ov))
    hit = ov.amax(-1) > invalid_thr
    return torch.where(hit, torch.full_like(label, -1), label)


class TridentFasterRcnn(FasterRcnn):
    """FasterRcnn over nb branches folded into the image axis (see the
    module's docstring). valid_ranges: one (lo, hi) sqrt-area range a
    branch, hi -1 for none (1e5)."""

    def __init__(self, backbone, neck, rpn_module, rpn, bbox_head, p_roi,
                 p_bbox, *, num_branch=3, scaleaware=True,
                 valid_ranges=((0, 90), (30, 160), (90, -1)), **kw):
        super().__init__(backbone, neck, rpn_module, rpn, bbox_head, p_roi,
                         p_bbox, **kw)
        self.num_branch = num_branch
        self.scaleaware = bool(scaleaware)
        self.valid_ranges = tuple((float(lo), float(hi) if hi > 0 else 1e5)
                                  for lo, hi in valid_ranges)
        if self.scaleaware and len(self.valid_ranges) < num_branch:
            raise ValueError(f"{num_branch} scale-aware branches, "
                             f"{len(self.valid_ranges)} valid ranges")

    def branch_ranges(self, b, device):
        """[nb * B, 2]: branch i's range for each of its B images."""
        vr = torch.tensor(self.valid_ranges[:self.num_branch],
                          dtype=torch.float32, device=device)
        return vr.repeat_interleave(b, 0)

    def fold(self, x):
        """[B, ...] -> [nb * B, ...], branch-major."""
        return x.repeat(self.num_branch, *([1] * (x.dim() - 1)))

    def unfold(self, x, b):
        """[nb * B, R, ...] -> [B, nb * R, ...]."""
        nb, r = self.num_branch, x.shape[1]
        x = x.reshape(nb, b, r, *x.shape[2:]).transpose(0, 1)
        return x.reshape(b, nb * r, *x.shape[3:])

    def test_outputs(self, data, im_info, mode):
        b = data.shape[0]
        pyr = self.pyramid(data)
        im_info_b = self.fold(im_info)
        rpn_out = self.rpn_module(pyr)
        proposals, prop_scores = self.rpn.proposals(rpn_out, im_info_b)
        if mode == "rpn_test":
            return {"proposal": proposals, "proposal_score": prop_scores}
        roi_feat = self.extract_rois(pyr, proposals)
        cls_logit, bbox_delta = self.bbox_head(roi_feat)
        score, boxes = self.merge_branches(*self.predict(
            cls_logit, bbox_delta, proposals, im_info_b), b)
        return {"cls_score": score, "bbox_xyxy": boxes,
                "rois": self.unfold(proposals, b),
                "roi_score": self.unfold(prop_scores, b)}

    def merge_branches(self, score, boxes, b):
        """The branches' decoded detections [nb * B, R, ...] -> [B, nb * R,
        ...], scale-aware: scores of boxes outside their branch's range
        zeroed first."""
        if self.scaleaware:
            ok = _in_range(_size2(boxes[..., :4]),
                           self.branch_ranges(b, boxes.device))
            score = score * ok[..., None]
        return self.unfold(score, b), self.unfold(boxes, b)

    def box_branch(self, data, im_info, gt_bbox, generator):
        if gt_bbox is None or generator is None:
            raise ValueError("train mode needs gt_bbox and a generator")
        b = data.shape[0]
        pyr = self.pyramid(data)
        rpn_out = self.rpn_module(pyr)
        im_info_b, gt_all = self.fold(im_info), self.fold(gt_bbox)
        ranges = self.branch_ranges(b, data.device)
        gt_b = filter_gt_by_range(gt_all, ranges) if self.scaleaware \
            else gt_all
        rpn_losses, rpn_aux = self.rpn.loss(
            generator, rpn_out, gt_b, im_info_b,
            deterministic=self.deterministic_sampling)
        if self.scaleaware:
            (key,) = rpn_out
            anchors = self.rpn.anchors(self.rpn.strides[0],
                                       rpn_out[key][0].shape[2:],
                                       data.device)
            rpn_aux["rpn_label"] = ignore_anchors_near_invalid_gt(
                rpn_aux["rpn_label"], anchors, gt_all, ranges)
        sample = self.sample_rois(rpn_out, im_info_b, gt_b, generator)
        losses, aux = self.head_losses(pyr, sample, rpn_losses, rpn_aux)
        return pyr, sample, losses, aux
