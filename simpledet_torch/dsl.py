"""Build the port's modules from a config's spec (counterpart of
simpledet_tpu/dsl.py, which maps the same component names onto Flax modules).

A component the port does not have raises NotImplementedError naming it.
Each component computes in the dtype its param class asks for (`_dtype`:
`fp16 = True` means bf16, as in the JAX package); parameters stay fp32. The
backbone is normalised as its param class's normalizer says (`_norm`:
FrozenBN when it names none); the FPN neck and the box head take no norm, as
in the JAX package. A config's subclass of a backbone (`class
TinyBackbone(MSRAResNet50V1FPN): depth = 18`) builds its base at its depth.
"""
import torch

from simpledet_torch import resolve_device
from simpledet_torch.core.config import read_config
from simpledet_torch.models.faster_rcnn import FasterRcnn
from simpledet_torch.models.fpn import FPNNeck
from simpledet_torch.models.heads import Bbox2fcHead
from simpledet_torch.models.norm import normalizer_factory
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.rpn import FPNRpnHead, RpnConvHead

BACKBONES = {"MSRAResNet50V1FPN": 50}
SUPPORTED = {"detector": ("FasterRcnn",), "neck": ("FPNNeck",),
             "rpn_head": ("FPNRpnHead",), "roi_extractor": ("FPNRoiAlign",),
             "bbox_head": ("FPNBbox2fcHead", "Bbox2fcHead")}


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

    bb = comps["backbone"]
    backbone = ResNet(depth or bb.depth or BACKBONES[bb.name],
                      dtype=_dtype(bb.param), norm=_norm(bb.param))
    neck = FPNNeck(backbone.out_channels, 256,
                   dtype=_dtype(comps["neck"].param))
    p_rpn = comps["rpn_head"].param
    # as dsl.FPNRpnHead does: the conv head reads the dtype set here
    p_rpn.dtype = _dtype(p_rpn)
    rpn = FPNRpnHead(p_rpn)
    rpn_module = RpnConvHead(rpn.num_anchor, p_rpn.head.conv_channel or 256,
                             256, dtype=p_rpn.dtype)
    p_roi = comps["roi_extractor"].param
    p_bbox = comps["bbox_head"].param
    num_reg = 2 if (p_bbox.regress_target.class_agnostic or False) \
        else p_bbox.num_class
    bbox_head = Bbox2fcHead(p_bbox.num_class, num_reg,
                            p_roi.out_size ** 2 * 256,
                            dtype=_dtype(p_bbox))
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
