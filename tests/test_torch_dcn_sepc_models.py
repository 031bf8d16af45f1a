"""Whole detectors of the DCN / NAS-FPN / SEPC slice in the port against the
JAX package, on the CPU.

Four detectors at depth 18 on 128 x 192 images, batch 2, built on both
sides from the same Flax params (kernels N(0, 1 / fan_in), FrozenBN folds
of order one, the RPN and predictors at Flax's inits, every offset conv
drawn so that offsets reach a few cells: Flax's zero init would make each
deformable conv a plain one):
- `sepc`: RetinaNet on the full SEPC neck (the FPN with FrozenBN, a
  deformable PConv module with iBN, deformable CConv / LConv, 64 wide)
  and its head;
- `nasfpn`: RetinaNet on a 3-cell NAS-FPN (no norm, as the fixbn configs)
  with `RetinaNetHeadWithBN`'s per-level FrozenBN;
- `dcn_fpn`: Faster R-CNN on the v1b DCN FPN backbone with every unit of
  stages 4-5 deformable, stage 5's first one strided;
- `dcnv2_c4`: the C4 Faster R-CNN (TridentFasterRcnn, one branch) on the
  DCNv2 C4 backbone and the v1b C5 head.
Held: the losses (1e-5 relative), the labels (exactly), every gradient
(1e-4 of its max; a bias that a norm cancels: zero on both sides), a
3-step SGD trajectory (parameters within 1e-4 of their scale), and the
test forward (detections within 1e-4, the per-class NMS with K3's plain
version). Sampling runs on `arange` priorities and the two-stage models'
train proposals are `deterministic_proposals` of the gt on both sides; the
JAX side runs the crop RoIAlign. Premises, asserted: no offset within
1e-5 of an integer; no RoIAlign bin max taken at other samples from the
JAX features than from the port's (`test_no_bin_max_flips`); no retina
score near the threshold or a top-k boundary. Then the two learning
recipes, config/converge_sepc.py and config/converge_nasfpn.py (SyncBN,
adam), built from the configs on both sides: 3 steps of Trainer against
make_train_step with `batch_stats`.
"""
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_tpu.core.optimizer import freeze_mask as j_freeze_mask
from simpledet_tpu.core.optimizer import make_optimizer as j_make_optimizer
from simpledet_tpu.core.schedule import warmup_multifactor as j_warmup
from simpledet_tpu.core.train import TrainState
from simpledet_tpu.eval.postprocess import per_class_nms as j_per_class_nms
from simpledet_tpu.models import dcn as jdcn
from simpledet_tpu.models import fpn as jfpn
from simpledet_tpu.models import heads as jheads
from simpledet_tpu.models import nasfpn as jnas
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models import retinanet as jretina
from simpledet_tpu.models import sepc as jsepc
from simpledet_tpu.models import tridentnet as jtri
from simpledet_tpu.models.faster_rcnn import FasterRcnn as JFasterRcnn
from simpledet_tpu.models.faster_rcnn import \
    deterministic_proposals as j_fixed_proposals
from simpledet_tpu.models.norm import normalizer_factory as j_norm
from simpledet_tpu.models.rpn import FPNRpnHead as JRpnHead
from simpledet_tpu.ops.image import device_normalize as j_normalize
from simpledet_tpu.targets import sampling as jsampling
from simpledet_torch.core import checkpoint as ckpt
from simpledet_torch.core.config import patch_config_as_nothrow, read_config
from simpledet_torch.core.schedule import warmup_multifactor
from simpledet_torch.core.train import Trainer
from simpledet_torch.dsl import build_detector
from simpledet_torch.eval.postprocess import per_class_nms
from simpledet_torch.models.dcn import (C4StrideKeyAdapter, DCNBottleneck,
                                        DCNv2Bottleneck)
from simpledet_torch.models.faster_rcnn import FasterRcnn
from simpledet_torch.models.fpn import FPNNeck, Neck
from simpledet_torch.models.heads import Bbox2fcHead
from simpledet_torch.models.nasfpn import NASFPNNeck
from simpledet_torch.models.norm import normalizer_factory
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.retinanet import (RetinaNet, RetinaNetHead,
                                              RetinaNetNeck, RetinaSubnets)
from simpledet_torch.models.rpn import FPNRpnHead, RpnConvHead
from simpledet_torch.models.sepc import SEPCFPN, SEPCNeck, SEPCSubnets
from simpledet_torch.models.tridentnet import BboxC5Head, TridentFasterRcnn
from simpledet_torch.ops.image import device_normalize
from simpledet_torch.weights import flax_leaf, flax_path, from_flax

from retina_ranks import gt_boxes as retina_gt
from retina_ranks import rpn_param as retina_rpn_param

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN, STD = (122.7717, 115.9465, 102.9801), (1.0, 1.0, 1.0)
B, H, W, FILTERS = 2, 128, 192, 64
LOSS_RTOL, GRAD_RTOL, DET_RTOL = 1e-5, 1e-4, 1e-4
SEED_KEY = jax.random.PRNGKey(3)
FIXED = ("conv0", "stage1", "scale", "bias")
KINDS = ("sepc", "nasfpn", "dcn_fpn", "dcnv2_c4")
RETINA = ("sepc", "nasfpn")
NUM_CLASS = {"sepc": 4, "nasfpn": 4, "dcn_fpn": 5, "dcnv2_c4": 5}
# images without a RoIAlign bin-max near-tie between the two packages'
# float32 features (`test_no_bin_max_flips`) and without a relu input
# within their rounding of 0 (with image 0 one in stage1_unit1 of the
# shared v1b backbone flipped, and its kernels' gradients moved 5e-4)
IMAGE_SEED = {"sepc": 1, "nasfpn": 1, "dcn_fpn": 1, "dcnv2_c4": 3}
# params without a float32 near-tie between the two packages at a relu
# input or a deformable tap's integer position (`test_offsets_premise`):
# at such a tie one gradient element jumps
PARAM_SEED = {"sepc": 5, "nasfpn": 5, "dcn_fpn": 5, "dcnv2_c4": 5}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module's tests run: the tier-1
    command runs 6 test workers on the CPU's cores, and torch's default of
    a thread a core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


# ------------------------------------------------------------ the models


def two_stage_params(kind):
    """RpnParam, RoiParam and BboxParam of the two-stage models: FPN on
    strides 4-64 with 7 x 7 rois, or C4 on stride 16."""
    fpn = kind == "dcn_fpn"

    class RpnParam:
        class anchor_generate:
            scale = (8,) if fpn else (2, 4, 8)
            ratio = (0.5, 1.0, 2.0)
            stride = (4, 8, 16, 32, 64) if fpn else (16,)

        class anchor_assign:
            allowed_border = 0
            pos_thr = 0.7
            neg_thr = 0.3
            min_pos_thr = 0.0
            image_anchor = 64
            pos_fraction = 0.5

        class head:
            conv_channel = FILTERS

        class proposal:
            pre_nms_top_n = 96
            post_nms_top_n = 48
            nms_thr = 0.7
            min_bbox_side = 0

        class subsample_proposal:
            proposal_wo_gt = False
            image_roi = 16
            fg_fraction = 0.25
            fg_thr = 0.5
            bg_thr_hi = 0.5
            bg_thr_lo = 0.0

        class bbox_target:
            num_reg_class = 2
            class_agnostic = True
            weight = (1.0, 1.0, 1.0, 1.0)
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    class RoiParam:
        out_size = 7
        stride = (4, 8, 16, 32) if fpn else 16
        roi_canonical_scale = 224
        roi_canonical_level = 4

    class BboxParam:
        num_class = NUM_CLASS[kind]

        class regress_target:
            class_agnostic = True
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    return [patch_config_as_nothrow(c) for c in (RpnParam, RoiParam,
                                                  BboxParam)]


def two_stage_gt():
    """Boxes of 2-7 cells at stride 16 (on smaller ones a C4 map's 7 x 7
    bins sample so close that float32 near-ties flip bin maxima)."""
    gt = np.full((B, 8, 5), -1, np.float32)
    gt[0, :4] = [[10, 12, 50, 52, 1], [60, 20, 170, 110, 3],
                 [100, 50, 170, 115, 2], [5, 70, 34, 105, 4]]
    gt[1, :4] = [[20, 10, 110, 80, 2], [0, 40, 60, 110, 1],
                 [130, 60, 185, 120, 3], [40, 90, 70, 120, 4]]
    return gt


class JSepcNeck(fnn.Module):
    """The JAX DSL's RetinaNetNeckWithBNWithSEPC chain at this width."""

    @fnn.compact
    def __call__(self, feats):
        fpn = jretina.RetinaNetNeck(filters=FILTERS, norm=j_norm("fixbn"),
                                    name="fpn")
        sepc = jsepc.SEPCFPN(filters=FILTERS, pconv_num=1, pconv_deform=True,
                             lcconv_deform=True, ibn=True, name="sepc")
        return sepc(fpn(feats))


def jax_model(kind, p):
    fixbn = j_norm("fixbn")
    if kind in RETINA:
        p_rpn = p[0]
        if kind == "sepc":
            jhead = jsepc.SEPCRetinaNetHead(p_rpn)
            neck = JSepcNeck(name="neck")
        else:
            jhead = jretina.RetinaNetHead(p_rpn)
            jhead.module = jretina.RetinaSubnets(
                num_anchor=jhead.num_anchor, num_fg_class=jhead.num_fg_class,
                conv_channel=FILTERS, norm=fixbn)
            neck = jnas.NASFPNNeck(filters=FILTERS, num_stage=3, name="neck")
        return jretina.RetinaNet(
            backbone=jresnet.ResNet(depth=18, variant="v1b", norm=fixbn,
                                    name="backbone"),
            neck=neck, head_module=jhead.module, head=jhead), jhead
    p_rpn, p_roi, p_bbox = p
    jrpn = JRpnHead(p_rpn)
    if kind == "dcn_fpn":
        return JFasterRcnn(
            backbone=jresnet.ResNet(depth=18, variant="v1b", norm=fixbn,
                                    num_special=(0, 0, 3, 3),
                                    special_block=jdcn.DCNBottleneck,
                                    name="backbone"),
            neck=jfpn.FPNNeck(filters=FILTERS, name="neck"),
            rpn_module=jrpn.module, rpn=jrpn,
            bbox_head=jheads.Bbox2fcHead(num_class=NUM_CLASS[kind],
                                         num_reg_class=2, name="bbox_head"),
            p_rpn=p_rpn, p_roi=p_roi, p_bbox=p_bbox,
            fixed_proposals=True), jrpn
    backbone = jdcn.C4StrideKeyAdapter(inner=jresnet.ResNet(
        depth=18, variant="v1b", norm=fixbn, num_stages=3,
        num_special=(0, 0, 3, 0), special_block=jdcn.DCNv2Bottleneck))
    return jtri.TridentFasterRcnn(
        backbone=backbone, neck=jfpn.Neck(name="neck"),
        rpn_module=jrpn.module, rpn=jrpn,
        bbox_head=jtri.BboxC5V1Head(num_class=NUM_CLASS[kind],
                                    num_reg_class=2, depth=18,
                                    variant="v1b", norm=fixbn,
                                    name="bbox_head"),
        p_rpn=p_rpn, p_roi=p_roi, p_bbox=p_bbox, num_branch=1,
        scaleaware=False), jrpn


def torch_model(s, params, train=True):
    kind, p = s["kind"], s["p"]
    fixbn = normalizer_factory("fixbn")
    if kind in RETINA:
        backbone = ResNet(18, norm=fixbn, variant="v1b")
        head = RetinaNetHead(p[0])
        if kind == "sepc":
            neck = SEPCNeck(RetinaNetNeck(backbone.out_channels[1:], FILTERS,
                                          norm=fixbn),
                            SEPCFPN(FILTERS, 1, True, True, True))
            subnets = SEPCSubnets(head.num_anchor, head.num_fg_class,
                                  FILTERS)
        else:
            neck = NASFPNNeck(backbone.out_channels[1:], FILTERS, 3)
            subnets = RetinaSubnets(head.num_anchor, head.num_fg_class,
                                    FILTERS, FILTERS, norm=fixbn,
                                    strides=head.strides)
        model = RetinaNet(backbone, neck, subnets, head)
    else:
        p_rpn, p_roi, p_bbox = p
        trpn = FPNRpnHead(p_rpn)
        kw = dict(fixed_proposals=True, deterministic_sampling=True)
        if kind == "dcn_fpn":
            backbone = ResNet(18, norm=fixbn, variant="v1b",
                              num_special=(0, 0, 3, 3),
                              special_block=DCNBottleneck)
            model = FasterRcnn(
                backbone, FPNNeck(backbone.out_channels, FILTERS),
                RpnConvHead(trpn.num_anchor, FILTERS, FILTERS), trpn,
                Bbox2fcHead(NUM_CLASS[kind], 2, 49 * FILTERS), p_roi,
                p_bbox, **kw)
        else:
            backbone = C4StrideKeyAdapter(ResNet(
                18, norm=fixbn, variant="v1b", num_stages=3,
                num_special=(0, 0, 3, 0), special_block=DCNv2Bottleneck))
            model = TridentFasterRcnn(
                backbone, Neck(), RpnConvHead(trpn.num_anchor, FILTERS,
                                              1024), trpn,
                BboxC5Head(NUM_CLASS[kind], 2, 18, "v1b", norm=fixbn),
                p_roi, p_bbox, num_branch=1, scaleaware=False, **kw)
    from_flax(params, model)
    return model.to(memory_format=torch.channels_last).train(train)


def seeded(shapes, rng):
    """Kernels N(0, 1 / fan_in) (an offset conv's: offsets of a few cells),
    biases 0 (RetinaNet's class predictor's: its prior), FrozenBN scales in [0.2, 0.6] and biases in [-0.2, 0.2]; the
    RPN's convs, the predictors and the box head's logits at Flax's inits,
    iBN's gammas 1 and betas 3 (its outputs meet a relu: betas at 3 keep
    them off 0, where float32 rounding would flip the relu's gradient, as
    tests/test_torch_syncbn.py starts SyncBN's)."""
    def leaf(path, s):
        keys = [k.key for k in path]
        name, parent = keys[-1], keys[-2] if len(keys) > 1 else ""
        if name == "scale":
            return rng.uniform(0.2, 0.6, s.shape).astype(np.float32)
        if name == "gamma":
            return np.ones(s.shape, np.float32)
        if name == "beta":
            return np.full(s.shape, 3.0, np.float32)
        if name == "bias":
            if parent.endswith("_norm") and "conv" in parent:
                # RetinaNetHeadWithBN's tower norms: a relu follows, and
                # biases of 1 keep its inputs off 0 (float32 rounding flips
                # a relu's gradient there)
                return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
            if "bn" in parent or "norm" in parent:
                return rng.uniform(-0.2, 0.2, s.shape).astype(np.float32)
            if "offset_conv" in keys:
                return (rng.randn(*s.shape) * 0.3).astype(np.float32)
            if parent == "cls_pred":        # RetinaNet's class prior, 0.01
                return np.full(s.shape, -np.log(99.0), np.float32)
            return np.zeros(s.shape, np.float32)
        std = {"rpn_conv": 0.01, "rpn_cls": 0.01, "rpn_reg": 0.01,
               "cls_pred": 0.01, "bbox_pred": 0.01, "cls_logit": 0.01,
               "bbox_delta": 0.001}.get(parent)
        if std is not None:
            return (rng.randn(*s.shape) * std).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        scale = 2.0 if "offset_conv" in keys else 1.0
        return (rng.randn(*s.shape) * scale / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_patches(s):
    """While the JAX package's functions are traced: arange priorities, the
    crop RoIAlign and, for the C4 model (whose JAX detector has no
    fixed-proposals hook), train proposals from the gt."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SIMPLEDET_ROI_ALIGN", "crop")
    mp.setattr(jsampling, "_priorities",
               lambda rng, n, deterministic: jnp.arange(n, dtype=jnp.float32))
    if s["kind"] == "dcnv2_c4":
        jrpn, real = s["jhead"], s["jhead"].proposals
        gt = jnp.asarray(s["gt"])

        def proposals(level_outputs, im_info, pad_hw, is_train):
            boxes, scores = real(level_outputs, im_info, pad_hw, is_train)
            if is_train:
                boxes = j_fixed_proposals(gt, boxes.shape[1])
            return boxes, scores

        mp.setattr(jrpn, "proposals", proposals)
    return mp


def make_setup(kind):
    if kind in RETINA:
        p_rpn = retina_rpn_param()
        p_rpn.dtype = jnp.float32
        p, gt = (p_rpn,), retina_gt()
    else:
        p, gt = two_stage_params(kind), two_stage_gt()
        p[0].dtype = jnp.float32
    jmodel, jhead = jax_model(kind, p)
    data = np.random.RandomState(IMAGE_SEED[kind]).randint(
        0, 256, (B, H, W, 3), dtype=np.uint8)
    im_info = np.float32([[H, W, 1.0], [112, 160, 1.0]])
    shapes = jax.eval_shape(
        lambda r, x, i: jmodel.init(r, x, i, mode="test"),
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros((B, H, W, 3)), jnp.asarray(im_info))["params"]
    params = seeded(shapes, np.random.RandomState(PARAM_SEED[kind]))
    return dict(kind=kind, jmodel=jmodel, jhead=jhead, p=p, gt=gt,
                data=data, im_info=im_info, params=params)


def _normalised(s):
    return j_normalize(jnp.asarray(s["data"]), jnp.asarray(s["im_info"]),
                       MEAN, STD)


@pytest.fixture(scope="module", params=KINDS)
def setup(request):
    s = make_setup(request.param)
    mp = jax_patches(s)
    data = _normalised(s)

    def loss_fn(params):
        # the pyramid and every offset conv's outputs of the same forward,
        # captured: the JAX side compiles once a kind
        kw = {} if s["kind"] in RETINA else {"rngs": {"sampling": SEED_KEY}}
        (losses, aux), inter = s["jmodel"].apply(
            {"params": params}, data, jnp.asarray(s["im_info"]),
            jnp.asarray(s["gt"]), mode="train",
            capture_intermediates=lambda mdl, _: mdl.name in (
                "neck", "offset_conv"), mutable=["intermediates"], **kw)
        return sum(losses.values()), (losses, aux, inter["intermediates"])

    s["loss_and_grad"] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (losses, aux, inter)), grads = s["loss_and_grad"](s["params"])
    s["want"] = (jax.tree.map(np.asarray, losses),
                 jax.tree.map(np.asarray, aux),
                 dict(_flat(jax.tree.map(np.asarray, grads))))
    s["captured"] = jax.tree.map(np.asarray, inter)
    yield s
    mp.undo()


def record_offsets(model):
    """{module name: [output, ...]} of every offset conv of the port, a
    list in call order (SEPC's are shared across levels); the hooks' handles
    to remove."""
    seen, handles = {}, []
    for name, m in model.named_modules():
        if name.endswith("offset_conv"):
            handles.append(m.register_forward_hook(
                lambda mod, args, out, name=name: seen.setdefault(
                    name, []).append(out.detach().permute(0, 2, 3, 1)
                                     .numpy())))
    return seen, handles


@pytest.fixture(scope="module")
def torch_step(setup):
    """The port's train forward and backward (nothing frozen), and its
    offset convs' outputs."""
    s = setup
    model = torch_model(s, s["params"])
    offsets, handles = record_offsets(model)
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    losses, aux = model(data, _t(s["im_info"]), _t(s["gt"]), mode="train",
                        generator=torch.Generator())
    for h in handles:
        h.remove()
    sum(losses.values()).backward()
    return model, losses, aux, offsets


@pytest.fixture(scope="module")
def jax_features(setup):
    """The JAX pyramid and every offset conv's outputs ({'/'-joined module
    path: (output, ...)}) on the batch, captured by the train forward of
    `setup`."""
    captured = setup["captured"]
    offsets = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "__call__":
                if path[-1] == "offset_conv":
                    offsets["/".join(path)] = tuple(v)
            else:
                walk(v, path + (k,))

    walk(captured, ())
    return captured["neck"]["__call__"][0], offsets


# ------------------------------------------------------------ train step


def test_offsets_premise(setup, torch_step, jax_features):
    """Every deformable conv sampled off its grid (offsets past two cells)
    and took the same four corners on both sides: the floor of each offset
    is the JAX package's (where a float32 difference moves an offset
    across an integer, the sampling's derivative jumps)."""
    offsets, want = torch_step[3], jax_features[1]
    # sepc: a PConv module's sepc1 and sepc2 on levels 1-4 and sepc0 on
    # 1-3, CConv and LConv on 1-4
    n = {"sepc": 11 + 2 * 4, "nasfpn": 0, "dcn_fpn": 4,
         "dcnv2_c4": 2}[setup["kind"]]
    assert sum(map(len, offsets.values())) == n
    assert {k.replace(".", "/") for k in offsets} == set(want)
    modules = dict(torch_step[0].named_modules())
    flips, largest = 0, 0.0
    for name, outs in offsets.items():
        n_off = modules[name.rsplit(".", 1)[0]].num_offset
        assert len(outs) == len(want[name.replace(".", "/")])
        for got, ref in zip(outs, want[name.replace(".", "/")]):
            assert rel_err(got, ref) <= 1e-5
            flips += int((np.floor(got[..., :n_off])
                          != np.floor(ref[..., :n_off])).sum())
            largest = max(largest, float(np.abs(got[..., :n_off]).max()))
    assert flips == 0
    assert largest > 2.0 or n == 0


def test_losses_and_labels_match(setup, torch_step):
    want, want_aux, _ = setup["want"]
    _, losses, aux, _ = torch_step
    assert set(losses) == set(want)
    for k, v in want.items():
        assert rel_err(losses[k].detach(), v) <= LOSS_RTOL, k
    np.testing.assert_array_equal(aux["rpn_label"].numpy(),
                                  want_aux["rpn_label"])
    if setup["kind"] in RETINA:
        assert float(aux["rpn_fg_count"]) == float(want_aux["rpn_fg_count"])
    else:
        label = aux["bbox_label"].numpy()
        np.testing.assert_array_equal(label, want_aux["bbox_label"])
        assert (label > 0).any(1).all()


def test_no_bin_max_flips(setup, torch_step, jax_features):
    """Premise of the two-stage gradients: on the rois the port samples,
    each 7 x 7 bin's max is taken at the same samples from the JAX features
    as from the port's (FPN), or at a sample whose value ties the other's
    (C4, below)."""
    from simpledet_torch.kernels.roi_align import multilevel_roi_align_plain

    s = setup
    if s["kind"] in RETINA:
        return
    model = torch_step[0]
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    keys = ("stride4", "stride8", "stride16", "stride32") \
        if s["kind"] == "dcn_fpn" else ("stride16",)
    strides = tuple(int(k[6:]) for k in keys)
    with torch.no_grad():
        pyr, sample, _, _ = model.box_branch(data, _t(s["im_info"]),
                                             _t(s["gt"]), torch.Generator())
    want = jax_features[0]
    port = [pyr[k].permute(0, 2, 3, 1).contiguous() for k in keys]
    ref = [_t(np.asarray(want[k])) for k in keys]
    for a, b in zip(port, ref):
        assert rel_err(a.numpy(), b.numpy()) <= 1e-5
    kw = dict(out_size=7, with_codes=True)
    if len(keys) > 1:
        kw.update(canonical_scale=224, canonical_level=4)
    (got, got_codes), (want_max, want_codes) = [
        multilevel_roi_align_plain(f, sample["rois"], strides, **kw)
        for f in (port, ref)]
    flips = (got_codes != want_codes).reshape(got.shape)
    if s["kind"] == "dcn_fpn":
        assert not flips.any()
        return
    # on the C4 map (a relu's output, every roi of an image on one map) a
    # few bins hold two samples whose values tie to float32 rounding, and
    # take their max at either: the premise is that they are ties (the
    # pooled max equal within 1e-6 of the map's scale) and rare; the
    # gradients' agreement then holds that they land where they may
    scale = float(port[0].abs().max())
    assert int(flips.sum()) <= 0.001 * flips.numel()
    assert float((got - want_max)[flips].abs().max()) <= 1e-6 * scale


def test_every_gradient_matches_jax_grad(setup, torch_step):
    """Each parameter's gradient within 1e-4 of its leaf's max |grad| of
    jax.grad; a leaf whose jax.grad is zero up to rounding (1e-6 of the
    largest |grad|: a conv bias that iBN cancels, the FPN's P4 and P5
    convs, which neither the sampled anchors nor the rois reach) within
    1e-5 of the largest |grad| on the port's side."""
    grads = setup["want"][2]
    model = torch_step[0]
    got = {flax_path(n): flax_leaf(n, p.grad.numpy())
           for n, p in model.named_parameters()}
    assert set(got) == {k for k in grads if not k.endswith("/scale") and not
                        (k.endswith("/bias") and ("bn" in k.split("/")[-2]
                                                  or "norm"
                                                  in k.split("/")[-2]))}
    largest = max(np.abs(v).max() for v in grads.values())
    zero = {k for k in got if np.abs(grads[k]).max() <= 1e-6 * largest}
    for k in zero:
        assert np.abs(got[k]).max() <= 1e-5 * largest, k
    errs = {k: rel_err(g, grads[k]) for k, g in got.items() if k not in zero}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    assert any("offset_conv" in k and np.abs(grads[k]).max() > 0
               for k in grads) == (setup["kind"] != "nasfpn")


def test_sgd_trajectory_matches(setup):
    """Three steps of Trainer against jax.grad and TrainState's update (sgd,
    momentum 0.9, wd 1e-4, gradual warmup, conv0 / stage1 / scale / bias
    frozen): each total loss within 1e-4, every parameter within 1e-4 of
    its scale, frozen ones unchanged and trained ones moved."""
    s = setup
    sched_args = dict(warmup_lr=0.01 / 3, warmup_iter=500)
    tx = j_make_optimizer(j_warmup(0.01, [60000], **sched_args),
                          momentum=0.9, wd=1e-4,
                          trainable_mask=j_freeze_mask(s["params"], FIXED))
    state = TrainState.create(apply_fn=s["jmodel"].apply,
                              params=s["params"], tx=tx)
    trainer = Trainer(torch_model(s, s["params"]), schedule=warmup_multifactor(
        0.01, [60000], **sched_args), fixed_param=FIXED, momentum=0.9,
        wd=1e-4, pixel_norm=(MEAN, STD))
    update = jax.jit(lambda st, g: st.apply_gradients(grads=g))
    for i in range(3):
        (jl, _), grads = s["loss_and_grad"](state.params)
        state = update(state, grads)
        tl = trainer.step(_t(s["data"]), _t(s["im_info"]), _t(s["gt"]))
        assert rel_err(tl["total_loss"], jl) <= 1e-4, i
    want = dict(_flat(jax.tree.map(np.asarray, state.params)))
    start = dict(_flat(s["params"]))
    moved = 0
    for name, p in trainer.model.named_parameters():
        path = flax_path(name)
        g = flax_leaf(name, p.detach().numpy())
        assert rel_err(g, want[path]) <= 1e-4, name
        if trainer.trainable[name]:
            moved += bool(np.abs(want[path] - start[path]).max() > 0)
        else:
            np.testing.assert_array_equal(g, start[path])
    assert moved > 10


# ------------------------------------------------------------- test path


# the class predictor's kernel on the test path: scores spread over
# 0.05-0.7 (sepc 5,435 above 0.05, 76 above 0.5; nasfpn 5,493 above 0.05),
# not saturated near 1, where ties would leave the top-k order to ulps
TEST_CLS_SCALE = {"sepc": 3.0, "nasfpn": 5.0}


def _test_params(s):
    """The test path's params: RetinaNet's class predictor scaled
    (TEST_CLS_SCALE) so that scores pass 0.05; the RPN's cls kernel by 30,
    so that proposal scores stand apart."""
    params = jax.tree.map(lambda v: np.array(v), s["params"])
    if s["kind"] in RETINA:
        params["head_module"]["cls_pred"]["kernel"] *= TEST_CLS_SCALE[
            s["kind"]]
    else:
        params["rpn_module"]["rpn_cls"]["kernel"] *= 30
    return params


@pytest.fixture(scope="module")
def test_outputs(setup):
    s = setup
    params = _test_params(s)
    im_info = jnp.asarray(s["im_info"])
    want = jax.tree.map(np.asarray, jax.jit(
        lambda p, x: s["jmodel"].apply({"params": p}, x, im_info,
                                       mode="test"))(params, _normalised(s)))
    model = torch_model(s, params, train=False)
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    got = model(data, _t(s["im_info"]), mode="test")
    return want, got


def test_test_forward_matches(setup, test_outputs):
    """Two-stage: scores and boxes within 1e-4 of their scale. RetinaNet:
    the same rows valid (no kept score within 1e-6 of the 0.05 threshold),
    and each image's kept scores, sorted, within 1e-4 (two scores a few
    ulps apart may leave torch.topk and lax.top_k in either order; the
    boxes are held after the NMS below)."""
    want, got = test_outputs
    for k in ("cls_score", "bbox_xyxy"):
        assert got[k].shape == want[k].shape
    if setup["kind"] not in RETINA:
        for k in ("cls_score", "bbox_xyxy"):
            assert rel_err(got[k].numpy(), want[k]) <= DET_RTOL, k
        return
    valid = want["det_valid"]
    np.testing.assert_array_equal(got["det_valid"].numpy(), valid)
    assert valid.sum() > 50
    for b in range(B):
        w = np.sort(want["cls_score"][b].max(-1)[valid[b]])
        g = np.sort(got["cls_score"][b].numpy().max(-1)[valid[b]])
        assert np.abs(w[w > 0.05] - 0.05).min() > 1e-6
        assert rel_err(g, w) <= DET_RTOL


def test_per_class_nms_matches(setup, test_outputs):
    """The per-class NMS (K3's plain version on the CPU) on each side's own
    test outputs: classes and valid rows equal, boxes and scores within
    1e-4 of their scale."""
    want, got = test_outputs
    out = per_class_nms(got["cls_score"], got["bbox_xyxy"], score_thr=0.05,
                        nms_thr=0.5, max_det=50)
    ref = jax.vmap(lambda c, b: j_per_class_nms(
        c, b, score_thr=0.05, nms_thr=0.5, max_det=50))(
        jnp.asarray(want["cls_score"]), jnp.asarray(want["bbox_xyxy"]))
    ref = [np.asarray(r) for r in ref]
    np.testing.assert_array_equal(out[3].numpy(), ref[3])
    np.testing.assert_array_equal(out[2].numpy(), ref[2])
    assert out[3].sum() > 0
    for g, w in zip(out[:2], ref[:2]):
        assert rel_err(g.numpy(), w) <= DET_RTOL


# -------------------------------------- the learning recipes: SyncBN, adam


@pytest.mark.parametrize("config", ["config/converge_sepc.py",
                                    "config/converge_nasfpn.py"])
def test_converge_recipe_syncbn_trajectory(config):
    """The config's own train detector and schedule on both sides (depth-18
    ResNet with SyncBN everywhere the DSL puts it, nothing frozen, gradual
    warmup; sgd with momentum 0.9 in place of its adam, below): from the Flax init (SyncBN betas at 3 and random
    running statistics, as tests/test_torch_syncbn.py) 3 steps of Trainer against make_train_step with its batch_stats state:
    each total loss within 1e-5 relative, every parameter and running
    statistic within 1e-4 of its scale (a running variance's: its var +
    mean^2). converge_sepc gives its
    SEPCParam on NeckParam, not as the neck's second argument: both DSLs
    read that as no SEPCParam (4 PConv modules, no deformable conv, no
    iBN)."""
    from simpledet_tpu.core.config import load_config as j_load_config
    from simpledet_tpu.core.train import make_train_step

    path = os.path.join(REPO, config)
    spec = read_config(path, is_train=True)
    model = build_detector(spec)
    jcfg = j_load_config(path).get_config(is_train=True)
    jmodel, opt = jcfg[6].train_symbol, jcfg[7]
    rng = np.random.RandomState(7)
    data = rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8)
    im_info = np.float32([[H, W, 1.0], [112, 160, 1.0]])
    gt = retina_gt()
    gt[..., 4] = np.where(gt[..., 4] > 0, np.minimum(gt[..., 4], 3),
                          gt[..., 4])
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda r, x, i: jmodel.init(r, x, i, mode="test"))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((B, H, W, 3)),
        jnp.asarray(im_info)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.full_like(v, 3.0) if path[-1].key == "beta"
        else v, variables["params"])
    bs = jax.tree.map(lambda v: rng.uniform(0.5, 1.5, v.shape).astype(
        np.float32), variables["batch_stats"])
    from_flax(params, model, bs)
    model = model.to(memory_format=torch.channels_last).train()
    assert opt.optimizer.type == "adam"
    # sgd in place of the recipe's adam: adam divides each element's moment
    # by its own RMS, so an element whose gradient is float32 noise (a conv
    # bias that SyncBN cancels) takes an lr-sized update of either sign on
    # each side (tests/test_torch_retina.py holds adam on converge_retina)
    trainer = Trainer.from_spec(model, spec, 4)
    trainer = Trainer(model, schedule=trainer.schedule, opt_type="sgd",
                      momentum=0.9, wd=opt.optimizer.wd,
                      clip_gradient=opt.optimizer.clip_gradient,
                      pixel_norm=spec.pixel_norm)
    sched = j_warmup(opt.optimizer.lr, opt.schedule.lr_iter,
                     warmup_type=opt.warmup.type, warmup_lr=opt.warmup.lr,
                     warmup_iter=opt.warmup.iter)
    tx = j_make_optimizer(sched, opt_type="sgd", momentum=0.9,
                          wd=opt.optimizer.wd,
                          clip_gradient=opt.optimizer.clip_gradient)
    state = TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx,
                              batch_stats=bs)
    step = jax.jit(make_train_step(jmodel, donate=False,
                                   pixel_norm=spec.pixel_norm))
    batch = {"data": jnp.asarray(data), "im_info": jnp.asarray(im_info),
             "gt_bbox": jnp.asarray(gt)}
    for i in range(3):
        state, jl, _ = step(state, batch, jax.random.PRNGKey(i))
        tl = trainer.step(_t(data), _t(im_info), _t(gt))
        assert rel_err(tl["total_loss"], jl["total_loss"]) <= LOSS_RTOL, i
    want = dict(_flat(jax.tree.map(np.asarray, state.params)))
    start = dict(_flat(params))
    for name, p in trainer.model.named_parameters():
        path = flax_path(name)
        got = flax_leaf(name, p.detach().numpy())
        # a bias that starts at 0 holds only the steps' updates, sums that
        # cancel (a conv bias before SyncBN: rounding noise): it is held
        # against its layer's kernel's scale
        scale = np.abs(want[path]).max()
        kernel = path.rsplit("/", 1)[0] + "/kernel"
        if path.endswith("/bias") and not np.any(start[path]) \
                and kernel in want:
            scale = max(scale, np.abs(want[kernel]).max())
        assert np.abs(got - want[path]).max() <= 1e-4 * scale, name
    want_bs = dict(_flat(jax.tree.map(np.asarray, state.batch_stats)))
    got_bs = dict(_flat(ckpt.batch_stats_to_flax(trainer.model)))
    assert set(got_bs) == set(want_bs) and len(want_bs) > 0
    # the running statistics: within 1e-4 of their scale, as the
    # parameters; a variance of E[x^2]'s (var + mean^2), the scale its
    # inputs' differences reach it at: on the coarse levels (12 values a
    # channel on P6) a variance can be small beside its mean
    for k, w in want_bs.items():
        scale = np.abs(w).max()
        if k.endswith("/var"):
            scale = (w + want_bs[k[:-3] + "mean"] ** 2).max()
        assert np.abs(got_bs[k] - w).max() <= 1e-4 * scale, k
