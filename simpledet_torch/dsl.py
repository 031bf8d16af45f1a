"""Build the port's modules from a config's spec (counterpart of
simpledet_tpu/dsl.py, which maps the same component names onto Flax modules).

A detector or component the port does not have raises NotImplementedError
naming it. FasterRcnn takes one box head (`FPNBbox2fcHead`, class-specific
regression unless its regress_target says class_agnostic); CascadeRcnn takes
three `CascadeBbox2fcHead`s, one a stage, each class-agnostic unless its
regress_target says otherwise (`simpledet_tpu/dsl.py:371`); MaskFasterRcnn
takes a box head, a second FPNRoiAlign for its mask branch, the
`MaskFasterRcnn4ConvHead` built from its MaskParam (`dim_reduced`, fp32
only) and the box head's class count, and at test time the
BboxPostProcessor's TestParam.
Each component computes in the dtype its param class asks for (`_dtype`:
`fp16 = True` means bf16, as in the JAX package); parameters stay fp32. The
backbone is normalised as its param class's normalizer says (`_norm`:
FrozenBN when it names none); the FPN neck and the box head take no norm, as
in the JAX package (the mask template sets a normalizer on every param
class; only the backbone reads it there, and here). The backbones are the
JAX DSL's v1, v1b and v1d FPN ResNets (`BACKBONES`). A config's subclass of
a backbone (`class TinyBackbone(MSRAResNet50V1FPN): depth = 18`) builds its
base's variant at its depth.
RetinaNet takes `RetinaNetNeck` (256 wide) and `RetinaNetHead` (towers as
wide as RpnParam.head.conv_channel), fp32 only; RPN takes the flagship's
backbone, neck and RPN head and builds `RpnOnly` (with FCOS's neck and
head it builds FCOS, as the JAX package's RPN detector does).
TridentFasterRcnn (every C4 Faster R-CNN: one branch, not scale-aware)
takes a trident C4 backbone (`C4_BACKBONES`: its depth from its param
class, its branches and dilations from the param class's `trident`, as
`simpledet_tpu/dsl.py::TridentMXNetResNetV2` reads them), the identity
`Neck`, `TridentRpnHead` (the FPN RPN head on the one stride-16 level,
1024 channels in), `RoiAlign` (one level) and a C5 head (`BboxC5Head`,
v2, or `BboxC5V1Head`, whose param class's `variant` picks v1 or v1b);
its get_*_symbol keywords `num_branch`, `scaleaware` and `valid_ranges`
(the spec's `options`). RPN takes either an FPN backbone with `FPNNeck`
or a C4 one with `Neck` (`config/rpn_r50v2c4_1x.py`).
The DCN hybrids (`HYBRID_BACKBONES`, `models/dcn/builder.py`'s names): v1b
ResNets whose last `num_cX_block` units of each stage (the backbone param
class's) are DCN or DCNv2 bottlenecks, at the param class's depth (50
unset); `DCNResNetFPN` / `DCNv2ResNetFPN` on FasterRcnn, and the C4 ones
`DCNResNetC4S16` / `DCNv2ResNetC4S16` (stages 1-3, c4 published as
stride16) on TridentFasterRcnn. RetinaNet's necks: `RetinaNetNeckWithBN`
(the neck with its param class's norm), `NASFPNNeck` and
`TopDownBottomUpFPNNeck` (`dim_reduced` wide, `num_stage`, `S0_kernel`; a
norm only for a syncbn, localbn or gn normalizer, as
`simpledet_tpu/dsl.py::_NeckWrapper` gives one) and
`RetinaNetNeckWithBNWithSEPC(NeckParam, SEPCParam)` (the BN neck, then
SEPC: `Pconv_num` (4 unset), `pconv_deform`, `lcconv_deform`, `ibn`, read
from the second param class, none given reading as unset); its heads
`RetinaNetHeadWithBN` (a norm per tower conv and level) and
`RetinaNetHeadWithBNWithSEPC` (predictors on the SEPC halves), and
`FreeAnchorRetinaNetHead` (RetinaNet's subnets, the learning-to-match
losses). The dense single-stage heads, fp32 only, on the FCOS neck
(`FCOSFPNNeck`: RetinaNet's P3-P7 neck, 256 wide, P6 from the output P5,
no norm whatever its param class names, as `simpledet_tpu/dsl.py:992-1001`
builds it): RPN with an `FCOSFPNHead` builds FCOS (towers as wide as
RpnParam.head.conv_channel, FCOSParam's classes and strides), and
`RepPointsDetector` takes a `BACKBONES` or DCN FPN backbone, the FCOS neck
and a `RepPointsHead` (towers head.conv_channel wide, the deformable convs'
outputs head.point_conv_channel wide).
The two-stage FPN variants: FasterRcnn on the PAFPN and FPG necks
(`PAFPNNeck` and `PAFPNNeckP2P6`: PAFPN on P2-P6, `PAFPNNeckP3P7`;
`FPGNeck`: the grid on P3-P7, `FPGNeckP2P6`; `dim_reduced` wide (256
unset), `num_stage`, a norm only for a syncbn, localbn or gn normalizer,
as `_NeckWrapper` gives one: the FPG configs' fixbn template runs them
without one), whose width the RPN head and the box head then take, and
with the Double-Head box head `FPNBboxDualHeadSmall` (a norm only for a
syncbn or gn normalizer, `num_block` convs, 4 unset); `TSDFasterRcnn` with
a `TSDConvFCBBoxHead` (the BboxParam's `roi_size`, 7 unset; the TSD param
class's layer counts and widths are not read, as the JAX DSL reads none:
two fc layers of 1024 a branch) and the pooling param holders
`FPNRoIAlign_DeltaC` / `FPNRoIAlign_DeltaR` as its roi_extractor (an
FPNRoiAlign's param class); `MaskScoringFasterRcnn`: MaskFasterRcnn's
components and a `MaskIoUConvHead(TestParam, BboxParam, MaskParam)` (the
box head's classes, MaskParam's dtype).
"""
import torch

from simpledet_torch import resolve_device
from simpledet_torch.core.config import patch_config_as_nothrow, read_config
from simpledet_torch.models.cascade_rcnn import (CascadeRcnn,
                                                 is_class_agnostic)
from simpledet_torch.models.dcn import (C4StrideKeyAdapter, DCNBottleneck,
                                        DCNv2Bottleneck)
from simpledet_torch.models.faster_rcnn import FasterRcnn, RpnOnly
from simpledet_torch.models.fcos import FCOS, FCOSHead, FCOSSubnets
from simpledet_torch.models.fpg import LEVELS_P3P7, FPGNeck, PAFPNNeck
from simpledet_torch.models.fpn import FPNNeck, Neck
from simpledet_torch.models.freeanchor import FreeAnchorRetinaNetHead
from simpledet_torch.models.heads import Bbox2fcHead, BboxDualHeadSmall
from simpledet_torch.models.mask_rcnn import MaskFasterRcnn, MaskHead4Conv
from simpledet_torch.models.msrcnn import MaskIoUHead, MaskScoringFasterRcnn
from simpledet_torch.models.nasfpn import NASFPNNeck, TopDownBottomUpFPNNeck
from simpledet_torch.models.norm import normalizer_factory
from simpledet_torch.models.reppoints import (RepPoints, RepPointsHead,
                                              RepPointsSubnets)
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.retinanet import (RetinaNet, RetinaNetHead,
                                              RetinaNetNeck, RetinaSubnets)
from simpledet_torch.models.rpn import FPNRpnHead, RpnConvHead
from simpledet_torch.models.sepc import SEPCFPN, SEPCNeck, SEPCSubnets
from simpledet_torch.models.tridentnet import (BboxC5Head, TridentFasterRcnn,
                                               TridentResNetC4)
from simpledet_torch.models.tsd import TSDBboxHead, TSDFasterRcnn

# the JAX DSL's FPN backbone classes (`simpledet_tpu/dsl.py:50-72`):
# name -> (depth, ResNet variant)
BACKBONES = {"MSRAResNet50V1FPN": (50, "v1"),
             "MSRAResNet101V1FPN": (101, "v1"),
             "ResNet50V1bFPN": (50, "v1b"), "ResNet101V1bFPN": (101, "v1b"),
             "ResNet152V1bFPN": (152, "v1b"), "ResNet50V1dFPN": (50, "v1d")}
# the JAX DSL's trident C4 backbone classes (`simpledet_tpu/dsl.py:536-577`):
# name -> ResNet variant
C4_BACKBONES = {"TridentMXNetResNetV2": "v2", "TridentResNetV2C4": "v2",
                "TridentResNetV1C4": "v1", "TridentResNetV1bC4": "v1b"}
# the DCN hybrids (`simpledet_tpu/dsl.py:94-119` through
# `models/dcn/builder.py`): name -> (special block, stages)
HYBRID_BACKBONES = {"DCNResNetFPN": (DCNBottleneck, 4),
                    "DCNv2ResNetFPN": (DCNv2Bottleneck, 4),
                    "DCNResNetC4S16": (DCNBottleneck, 3),
                    "DCNv2ResNetC4S16": (DCNv2Bottleneck, 3)}
RETINA_NECKS = ("RetinaNetNeck", "RetinaNetNeckWithBN", "NASFPNNeck",
                "TopDownBottomUpFPNNeck", "RetinaNetNeckWithBNWithSEPC")
RETINA_HEADS = ("RetinaNetHead", "RetinaNetHeadWithBN",
                "RetinaNetHeadWithBNWithSEPC", "FreeAnchorRetinaNetHead")
FPN_HYBRIDS = ("DCNResNetFPN", "DCNv2ResNetFPN")
# the PAFPN and FPG necks (`simpledet_tpu/dsl.py:900-912`): name -> (the
# module, its levels, its num_stage unset)
FPG_NECKS = {"PAFPNNeck": (PAFPNNeck, None, 2),
             "PAFPNNeckP2P6": (PAFPNNeck, None, 2),
             "PAFPNNeckP3P7": (PAFPNNeck, LEVELS_P3P7, 2),
             "FPGNeck": (FPGNeck, LEVELS_P3P7, 5),
             "FPGNeckP2P6": (FPGNeck, None, 5)}
_COMMON = {"backbone": tuple(BACKBONES), "neck": ("FPNNeck",),
           "rpn_head": ("FPNRpnHead",), "roi_extractor": ("FPNRoiAlign",)}
_CASCADE_HEAD = ("CascadeBbox2fcHead",)
_MASK = dict(_COMMON, rpn_head=("MaskFPNRpnHead",),
             mask_roi_extractor=("FPNRoiAlign",),
             bbox_head=("FPNBbox2fcHead",),
             mask_head=("MaskFasterRcnn4ConvHead",),
             bbox_post_processor=("BboxPostProcessor",))
# detector -> role -> the component classes the port builds for it
SUPPORTED = {
    "FasterRcnn": dict(_COMMON, backbone=tuple(BACKBONES) + FPN_HYBRIDS,
        neck=("FPNNeck",) + tuple(FPG_NECKS),
        bbox_head=("FPNBbox2fcHead", "Bbox2fcHead", "FPNBboxDualHeadSmall")),
    "TSDFasterRcnn": dict(_COMMON, roi_extractor=(
        "FPNRoiAlign", "FPNRoIAlign_DeltaC", "FPNRoIAlign_DeltaR"),
        bbox_head=("TSDConvFCBBoxHead",)),
    "CascadeRcnn": dict(_COMMON, bbox_head=_CASCADE_HEAD,
                        bbox_head_2nd=_CASCADE_HEAD,
                        bbox_head_3rd=_CASCADE_HEAD),
    "MaskFasterRcnn": _MASK,
    "MaskScoringFasterRcnn": dict(_MASK, maskiou_head=("MaskIoUConvHead",)),
    "RetinaNet": {"backbone": tuple(BACKBONES), "neck": RETINA_NECKS,
                  "rpn_head": RETINA_HEADS},
    "RPN": {"backbone": tuple(BACKBONES) + tuple(C4_BACKBONES),
            "neck": ("FPNNeck", "Neck", "FCOSFPNNeck"),
            "rpn_head": ("FPNRpnHead", "TridentRpnHead", "FCOSFPNHead")},
    "RepPointsDetector": {"backbone": tuple(BACKBONES) + FPN_HYBRIDS,
                          "neck": ("FCOSFPNNeck",),
                          "rpn_head": ("RepPointsHead",)},
    "TridentFasterRcnn": {"backbone": tuple(C4_BACKBONES) + (
        "DCNResNetC4S16", "DCNv2ResNetC4S16"), "neck": ("Neck",),
                          "rpn_head": ("TridentRpnHead",),
                          "roi_extractor": ("RoiAlign",),
                          "bbox_head": ("BboxC5Head", "BboxC5V1Head")},
}
# roles that only the test symbol is given
TEST_ONLY = ("bbox_post_processor",)


def _dtype(p):
    """The compute dtype of a component: bf16 where its param class sets
    fp16 (`simpledet_tpu/dsl.py::_dtype`), else fp32."""
    return torch.bfloat16 if getattr(p, "fp16", False) else torch.float32


def _norm(p):
    """The norm factory of a component's param class
    (`simpledet_tpu/dsl.py::_norm`): its normalizer's type, fixbn without
    one."""
    n = getattr(p, "normalizer", None)
    return normalizer_factory(n.type if n is not None else "fixbn")


def _require(detector, comps):
    if detector not in SUPPORTED:
        raise NotImplementedError(f"detector {detector!r} is not ported yet")
    roles = SUPPORTED[detector]
    for role, comp in comps.items():
        if comp.name not in roles.get(role, ()):
            raise NotImplementedError(f"{role} {comp.name!r} of {detector} "
                                      "is not ported yet")
    missing = sorted(set(roles) - set(comps) - set(TEST_ONLY))
    if missing:
        raise NotImplementedError(f"{detector} without {missing}")


def _box_head(p, in_features, class_agnostic):
    num_reg = 2 if class_agnostic else p.num_class
    return Bbox2fcHead(p.num_class, num_reg, in_features, dtype=_dtype(p))


def _fpn_box_head(comp, width, roi_size):
    """The box head of a Faster R-CNN-style detector on a `width`-wide
    pyramid: Bbox2fcHead, BboxDualHeadSmall or TSDBboxHead."""
    p = comp.param
    agnostic = p.regress_target.class_agnostic or False
    num_reg = 2 if agnostic else p.num_class
    if comp.name == "FPNBboxDualHeadSmall":
        n = p.normalizer
        norm = (normalizer_factory(n.type) if n is not None and n.type in
                ("syncbn", "gn") else None)
        return BboxDualHeadSmall(p.num_class, num_reg, width, roi_size,
                                 num_block=p.num_block or 4, norm=norm,
                                 dtype=_dtype(p))
    if comp.name == "TSDConvFCBBoxHead":
        return TSDBboxHead(p.num_class, num_reg, width, p.roi_size or 7,
                           dtype=_dtype(p))
    return _box_head(p, roi_size ** 2 * width, agnostic)


def _fpn_neck(comp, in_channels):
    """(neck, its width) of a two-stage FPN detector: FPNNeck (256 wide) or
    a PAFPN / FPG neck (fp32 only)."""
    p = comp.param
    if comp.name not in FPG_NECKS:
        return FPNNeck(in_channels, 256, dtype=_dtype(p)), 256
    if _dtype(p) != torch.float32:
        raise NotImplementedError(f"the bf16 {comp.name} (NeckParam sets "
                                  "fp16) is not ported yet")
    module, levels, num_stage = FPG_NECKS[comp.name]
    n = p.normalizer
    norm = (normalizer_factory(n.type) if n is not None and n.type in
            ("syncbn", "localbn", "gn") else None)
    filters = p.dim_reduced or 256
    kw = {"levels": levels} if levels else {}
    return module(in_channels, filters, p.num_stage or num_stage, norm=norm,
                  **kw), filters


def _mask_head(comp):
    """MaskHead4Conv from MaskFasterRcnn4ConvHead(BboxParam, MaskParam,
    MaskRoiParam): BboxParam's classes, MaskParam's width."""
    p_bbox, p_mask = comp.params[:2]
    if _dtype(p_mask) != torch.float32:
        raise NotImplementedError("the bf16 mask head (MaskParam.fp16) is "
                                  "not ported yet")
    return MaskHead4Conv(p_bbox.num_class, 256, p_mask.dim_reduced or 256)


def _maskiou_head(comp, p_mask_roi):
    """MaskIoUHead from MaskIoUConvHead(TestParam, BboxParam, MaskParam):
    BboxParam's classes, MaskParam's dtype, the mask rois' size."""
    _, p_bbox, p_mask = comp.params[:3]
    return MaskIoUHead(p_bbox.num_class, 256, p_mask_roi.out_size or 14,
                       dtype=_dtype(p_mask))


def _retina_neck(comp, in_channels):
    """(neck, its output channels) of a RetinaNet neck component."""
    p = comp.param
    if comp.name == "RetinaNetNeck":
        return RetinaNetNeck(in_channels, 256), 256
    if comp.name == "RetinaNetNeckWithBN":
        return RetinaNetNeck(in_channels, 256, norm=_norm(p)), 256
    if comp.name == "RetinaNetNeckWithBNWithSEPC":
        ps = comp.params[1] if len(comp.params) > 1 else None
        sepc = SEPCFPN(256, pconv_num=(ps and ps.Pconv_num) or 4,
                       pconv_deform=bool(ps and ps.pconv_deform),
                       lcconv_deform=bool(ps and ps.lcconv_deform),
                       ibn=bool(ps and ps.ibn))
        return SEPCNeck(RetinaNetNeck(in_channels, 256, norm=_norm(p)),
                        sepc), 512
    n = p.normalizer
    norm = (normalizer_factory(n.type) if n is not None and n.type in
            ("syncbn", "localbn", "gn") else None)
    filters = p.dim_reduced or 256
    kw = {"num_stage": p.num_stage} if p.num_stage else {}
    if comp.name == "NASFPNNeck":
        if p.S0_kernel:
            kw["s0_kernel"] = p.S0_kernel
        return NASFPNNeck(in_channels, filters, norm=norm, **kw), filters
    return TopDownBottomUpFPNNeck(in_channels, filters, norm=norm,
                                  **kw), filters


def _fp32_only(detector, comps):
    for role in ("backbone", "neck", "rpn_head"):
        if _dtype(comps[role].param) != torch.float32:
            raise NotImplementedError(
                f"the bf16 {detector} ({role} {comps[role].name} sets fp16) "
                "is not ported yet")


def _retinanet(comps, backbone):
    """RetinaNet from its neck's and head's param classes; fp32 only."""
    _fp32_only("RetinaNet", comps)
    neck, width = _retina_neck(comps["neck"], backbone.out_channels[1:])
    comp = comps["rpn_head"]
    head = (FreeAnchorRetinaNetHead if comp.name == "FreeAnchorRetinaNetHead"
            else RetinaNetHead)(comp.param)
    if comp.name == "RetinaNetHeadWithBNWithSEPC":
        subnets = SEPCSubnets(head.num_anchor, head.num_fg_class, width // 2)
    else:
        norm = _norm(comp.param) if comp.name == "RetinaNetHeadWithBN" \
            else None
        subnets = RetinaSubnets(head.num_anchor, head.num_fg_class,
                                head.p.head.conv_channel or 256, width,
                                norm=norm, strides=head.strides)
    return RetinaNet(backbone, neck, subnets, head)


def _dense(detector, comps, backbone):
    """FCOS (an RPN with FCOSFPNHead) or RepPoints on the FCOS neck; fp32
    only."""
    _fp32_only(detector, comps)
    head_name = comps["rpn_head"].name
    if (comps["neck"].name == "FCOSFPNNeck") != (head_name in (
            "FCOSFPNHead", "RepPointsHead")):
        raise NotImplementedError(f"{comps['neck'].name} with {head_name}")
    neck = RetinaNetNeck(backbone.out_channels[1:], 256, p6_source="p5")
    p = comps["rpn_head"].param
    width = p.head.conv_channel or 256
    if detector == "RPN":
        head = FCOSHead(p)
        return FCOS(backbone, neck, FCOSSubnets(head.num_fg_class, width, 256,
                                                head.strides), head)
    head = RepPointsHead(p)
    return RepPoints(backbone, neck, RepPointsSubnets(
        head.num_fg_class, head.num_points, width,
        p.head.point_conv_channel or width, 256), head)


def _backbone(comp, depth):
    """The FPN ResNet, the trident C4 ResNet or the DCN hybrid of a
    backbone component."""
    p = comp.param
    if comp.name in HYBRID_BACKBONES:
        block, stages = HYBRID_BACKBONES[comp.name]
        resnet = ResNet(depth or p.depth or 50, dtype=_dtype(p),
                        norm=_norm(p), variant="v1b", num_stages=stages,
                        num_special=tuple(getattr(p, f"num_c{s}_block") or 0
                                          for s in range(2, 6)),
                        special_block=block)
        return C4StrideKeyAdapter(resnet) if stages == 3 else resnet
    if comp.name in C4_BACKBONES:
        trident = p.trident or p
        return TridentResNetC4(
            depth or comp.depth or p.depth or 50, C4_BACKBONES[comp.name],
            dtype=_dtype(p), norm=_norm(p),
            num_branch=trident.num_branch or 3,
            dilations=tuple(trident.branch_dilates or (1, 2, 3)))
    bb_depth, variant = BACKBONES[comp.name]
    return ResNet(depth or comp.depth or bb_depth, dtype=_dtype(p),
                  norm=_norm(p), variant=variant)


def _c5_head(comp, depth):
    """BboxC5Head from BboxC5Head (v2) or BboxC5V1Head (its param class's
    variant, v1 by default)."""
    p = comp.param
    num_reg = 2 if (p.regress_target.class_agnostic or False) \
        else p.num_class
    variant = "v2" if comp.name == "BboxC5Head" else (p.variant or "v1")
    return BboxC5Head(p.num_class, num_reg, depth or p.depth or 50, variant,
                      dtype=_dtype(p), norm=_norm(p))


def _trident(spec, backbone, rpn_module, rpn, depth):
    comps, opts = spec.components, spec.options or {}
    kw = {}
    if opts.get("valid_ranges") is not None:
        kw["valid_ranges"] = tuple(tuple(v) for v in opts["valid_ranges"])
    return TridentFasterRcnn(
        backbone, Neck(), rpn_module, rpn, _c5_head(comps["bbox_head"], depth),
        comps["roi_extractor"].param, comps["bbox_head"].param,
        num_branch=opts.get("num_branch", 3),
        scaleaware=opts.get("scaleaware", True), **kw)


def build_detector(spec, *, depth=None):
    """FasterRcnn, CascadeRcnn, MaskFasterRcnn, RetinaNet, RpnOnly,
    TridentFasterRcnn, FCOS or RepPoints (on the CPU, weights not yet
    initialised) from a ConfigSpec. `depth` overrides the backbone's depth,
    and a C5 head's (tests use 18)."""
    comps = spec.components
    _require(spec.detector, comps)

    backbone = _backbone(comps["backbone"], depth)
    if spec.detector == "RetinaNet":
        return _retinanet(comps, backbone)
    fcos = {comps["neck"].name, comps["rpn_head"].name} & {"FCOSFPNNeck",
                                                           "FCOSFPNHead"}
    if spec.detector == "RepPointsDetector" or fcos:
        return _dense(spec.detector, comps, backbone)
    c4 = isinstance(backbone, (TridentResNetC4, C4StrideKeyAdapter))
    if c4 != (comps["neck"].name == "Neck"):
        raise NotImplementedError(f"{comps['neck'].name} on the backbone "
                                  f"{comps['backbone'].name}")
    neck, width = ((Neck(), backbone.out_channels) if c4 else
                   _fpn_neck(comps["neck"], backbone.out_channels))
    p_rpn = comps["rpn_head"].param
    # as dsl.FPNRpnHead does: the conv head reads the dtype set here
    p_rpn.dtype = _dtype(p_rpn)
    rpn = FPNRpnHead(p_rpn)
    rpn_module = RpnConvHead(rpn.num_anchor, p_rpn.head.conv_channel or 256,
                             width, dtype=p_rpn.dtype)
    if spec.detector == "RPN":
        return RpnOnly(backbone, neck, rpn_module, rpn)
    if spec.detector == "TridentFasterRcnn":
        return _trident(spec, backbone, rpn_module, rpn, depth)
    p_roi = comps["roi_extractor"].param
    in_features = p_roi.out_size ** 2 * width
    if spec.detector == "CascadeRcnn":
        p_bboxes = [comps[r].param for r in ("bbox_head", "bbox_head_2nd",
                                             "bbox_head_3rd")]
        heads = [_box_head(p, in_features, is_class_agnostic(p.regress_target))
                 for p in p_bboxes]
        return CascadeRcnn(backbone, neck, rpn_module, rpn, heads, p_roi,
                           p_bboxes)
    p_bbox = comps["bbox_head"].param
    bbox_head = _fpn_box_head(comps["bbox_head"], width, p_roi.out_size)
    if spec.detector in ("MaskFasterRcnn", "MaskScoringFasterRcnn"):
        post = comps.get("bbox_post_processor")
        args = (backbone, neck, rpn_module, rpn, bbox_head,
                _mask_head(comps["mask_head"]), p_roi, p_bbox,
                comps["mask_head"].params[1],
                comps["mask_roi_extractor"].param, post.param if post
                else None)
        if spec.detector == "MaskFasterRcnn":
            return MaskFasterRcnn(*args)
        return MaskScoringFasterRcnn(*args, maskiou_head=_maskiou_head(
            comps["maskiou_head"], comps["mask_roi_extractor"].param))
    if spec.detector == "TSDFasterRcnn":
        p_tsd = (spec.options or {}).get("p_tsd") or p_bbox.TSD
        return TSDFasterRcnn(backbone, neck, rpn_module, rpn, bbox_head,
                             p_roi, p_bbox,
                             p_tsd=patch_config_as_nothrow(p_tsd))
    return FasterRcnn(backbone, neck, rpn_module, rpn, bbox_head, p_roi,
                      p_bbox)


def detector_from_config(path, *, device="cuda", seed=0, is_train=False):
    """(model, spec): the config's test detector (or, with is_train, its train
    detector, in train mode) with seeded random weights, channels_last, on
    `device`."""
    device = resolve_device(device)
    spec = read_config(path, is_train=is_train)
    model = build_detector(spec)
    model.init_weights(torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.train(is_train), spec
