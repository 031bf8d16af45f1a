"""Build the port's modules from a config's spec (counterpart of
simpledet_tpu/dsl.py, which maps the same component names onto Flax modules).

A component the port does not have raises NotImplementedError naming it.
"""
import torch

from simpledet_torch import resolve_device
from simpledet_torch.core.config import read_config
from simpledet_torch.models.faster_rcnn import FasterRcnn
from simpledet_torch.models.fpn import FPNNeck
from simpledet_torch.models.heads import Bbox2fcHead
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.rpn import FPNRpnHead, RpnConvHead

BACKBONES = {"MSRAResNet50V1FPN": 50}
SUPPORTED = {"detector": ("FasterRcnn",), "neck": ("FPNNeck",),
             "rpn_head": ("FPNRpnHead",), "roi_extractor": ("FPNRoiAlign",),
             "bbox_head": ("FPNBbox2fcHead", "Bbox2fcHead")}


def _require(role, name):
    ok = BACKBONES if role == "backbone" else SUPPORTED[role]
    if name not in ok:
        raise NotImplementedError(f"{role} {name!r} is not ported yet")


def build_detector(spec, *, depth=None):
    """FasterRcnn (on the CPU, weights not yet initialised) from a
    ConfigSpec. `depth` overrides the backbone's depth (tests use 18)."""
    _require("detector", spec.detector)
    comps = spec.components
    for role, comp in comps.items():
        _require(role, comp.name)
        if comp.param is not None and comp.param.fp16:
            raise NotImplementedError(f"{role} {comp.name}: fp16/bf16 "
                                      "configs are not ported yet")
    if spec.normalizers not in ((), ("fixbn",), ("fix",)):
        raise NotImplementedError(
            f"normalizer {spec.normalizers}: only fixbn is ported")

    backbone = ResNet(depth or BACKBONES[comps["backbone"].name])
    neck = FPNNeck(backbone.out_channels, 256)
    p_rpn = comps["rpn_head"].param
    rpn = FPNRpnHead(p_rpn)
    rpn_module = RpnConvHead(rpn.num_anchor, p_rpn.head.conv_channel or 256,
                             256)
    p_roi = comps["roi_extractor"].param
    p_bbox = comps["bbox_head"].param
    num_reg = 2 if (p_bbox.regress_target.class_agnostic or False) \
        else p_bbox.num_class
    bbox_head = Bbox2fcHead(p_bbox.num_class, num_reg,
                            p_roi.out_size ** 2 * 256)
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
