"""The dense single-stage heads in the port against the JAX package, on the
CPU: FCOS, RepPoints (minmax and moment, plain and DCN backbone) and
FreeAnchor.

Five detectors at depth 18 on 128 x 192 images, batch 2, neck and towers
64 wide, 4 classes, FrozenBN, built on both sides from the same Flax params
(kernels N(0, 1 / fan_in), FrozenBN folds of order one, the predictors at
Flax's inits; GroupNorm scales and biases near 1 and RepPoints' init-point
predictor at std 0.2, so that relu inputs stay off 0 and the init points
spread about a cell; FCOS's offset scales and the moment transfer drawn
off their inits, so that each level's own leaf is held):
- `fcos`: FCOS on the P3-P7 neck with P6 from P5;
- `reppoints_minmax`, `reppoints_moment`: RepPoints on the same neck;
- `reppoints_moment_dcn`: RepPoints on the v1b DCN FPN backbone (every
  unit of stages 3-5 deformable, as the DCN configs' num_c3-5_block 3);
- `freeanchor`: RetinaNet's subnets (6 anchors a position) with the
  learning-to-match losses, on RetinaNet's neck.
Held: the targets and labels (exactly), the losses (1e-5 relative), every
gradient (1e-4 of its max), a 3-step SGD trajectory (parameters within
1e-4 of their scale), the trainable set against `freeze_mask`, the test
forward and the per-class NMS after it (1e-4; K3's plain version on the
CPU), the FCOS neck's P6 on P5. Premises, asserted: no deformable tap
offset's floor differs between the two sides; no IoU near an assignment
threshold; no score near the decode threshold. Then the three learning
recipes (config/converge_{fcos,reppoints,freeanchor}.py: SyncBN) built
from the configs on both sides: 3 steps of Trainer against make_train_step
with `batch_stats`.
"""
import os

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
from simpledet_tpu.models import fcos as jfcos
from simpledet_tpu.models import freeanchor as jfa
from simpledet_tpu.models import reppoints as jrep
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models import retinanet as jretina
from simpledet_tpu.models.norm import normalizer_factory as j_norm
from simpledet_tpu.ops.bbox import bbox_overlaps as j_overlaps
from simpledet_tpu.ops.image import device_normalize as j_normalize
from simpledet_torch.core import checkpoint as ckpt
from simpledet_torch.core.config import patch_config_as_nothrow, read_config
from simpledet_torch.core.schedule import warmup_multifactor
from simpledet_torch.core.train import Trainer
from simpledet_torch.dsl import build_detector
from simpledet_torch.eval.postprocess import per_class_nms
from simpledet_torch.models.dcn import DCNBottleneck
from simpledet_torch.models.fcos import FCOS, FCOSHead, FCOSSubnets
from simpledet_torch.models.freeanchor import FreeAnchorRetinaNetHead
from simpledet_torch.models.reppoints import (RepPoints, RepPointsHead,
                                              RepPointsSubnets)
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.retinanet import (RetinaNet, RetinaNetNeck,
                                              RetinaSubnets)
from simpledet_torch.ops.bbox import bbox_overlaps
from simpledet_torch.ops.image import device_normalize
from simpledet_torch.ops.nms import top_k_stable
from simpledet_torch.weights import flax_leaf, flax_path, from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN, STD = (122.7717, 115.9465, 102.9801), (1.0, 1.0, 1.0)
B, H, W, FILTERS, NUM_CLASS = 2, 128, 192, 64, 4
STRIDES = (8, 16, 32, 64, 128)
LOSS_RTOL, GRAD_RTOL, DET_RTOL = 1e-5, 1e-4, 1e-4
FIXED = ("conv0", "stage1", "scale", "bias")
KINDS = ("fcos", "reppoints_minmax", "reppoints_moment",
         "reppoints_moment_dcn", "freeanchor")
REPPOINTS = ("reppoints_minmax", "reppoints_moment", "reppoints_moment_dcn")
# the test path's class predictor scale: scores spread past the 0.05
# threshold without saturating
TEST_CLS_SCALE = {"fcos": 40.0, "reppoints_minmax": 12.0,
                  "reppoints_moment": 12.0, "reppoints_moment_dcn": 60.0,
                  "freeanchor": 10.0}
IMAGE_SEED = 1
PARAM_SEED = 5


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


def gt_boxes():
    """Float boxes of 20-120 px, classes 1-3, padding rows (class -1)."""
    gt = np.full((B, 8, 5), -1, np.float32)
    gt[0, :4] = [[10.3, 12.6, 53.1, 61.7, 1], [60.2, 20.9, 171.5, 111.2, 3],
                 [101.7, 50.4, 173.3, 115.8, 2], [5.6, 70.1, 36.2, 105.3, 3]]
    gt[1, :3] = [[20.4, 10.2, 112.9, 81.3, 2], [0.7, 40.6, 62.2, 109.9, 1],
                 [130.8, 60.3, 185.1, 120.7, 3]]
    return gt


def rpn_param(kind):
    """The nothrow RpnParam of each head at this size."""
    if kind == "fcos":
        class RpnParam:
            class head:
                conv_channel = FILTERS

            class proposal:
                pre_nms_thresh = 0.05
                pre_nms_top_n = 100

            class loss_setting:
                focal_loss_alpha = 0.25
                focal_loss_gamma = 2.0

            class FCOSParam:
                num_classifier = NUM_CLASS - 1
                stride = STRIDES
    elif kind == "freeanchor":
        class RpnParam:
            num_class = NUM_CLASS

            class anchor_generate:
                scale = (2, 2 ** 0.5 * 2)
                ratio = (0.5, 1.0, 2.0)
                stride = STRIDES

            class anchor_assign:
                bbox_thr = 0.6
                pre_anchor_top_n = 16

            class head:
                conv_channel = FILTERS
                mean = (0.0, 0.0, 0.0, 0.0)
                std = (0.1, 0.1, 0.2, 0.2)

            class proposal:
                pre_nms_top_n = 100

            class focal_loss:
                alpha = 0.5
                gamma = 2.0
    else:
        class RpnParam:
            num_class = NUM_CLASS

            class point_generate:
                num_points = 9
                scale = 4
                stride = STRIDES

            class head:
                conv_channel = FILTERS
                point_conv_channel = FILTERS

            class proposal:
                pre_nms_top_n = 100
                min_det_score = 0.05

            class point_target:
                target_scale = 4
                num_pos = 1

            class bbox_target:
                pos_iou_thr = 0.5
                neg_iou_thr = 0.4
                min_pos_iou = 0.0

            class focal_loss:
                alpha = 0.25
                gamma = 2.0

        RpnParam.point_generate.transform = (
            "minmax" if kind == "reppoints_minmax" else "moment")
    p = patch_config_as_nothrow(RpnParam)
    p.dtype = jnp.float32
    return p


def jax_model(kind, p):
    fixbn = j_norm("fixbn")
    if kind == "reppoints_moment_dcn":
        backbone = jresnet.ResNet(depth=18, variant="v1b", norm=fixbn,
                                  num_special=(0, 3, 3, 3),
                                  special_block=jdcn.DCNBottleneck,
                                  name="backbone")
    else:
        backbone = jresnet.ResNet(depth=18, norm=fixbn, name="backbone")
    if kind == "freeanchor":
        head = jfa.FreeAnchorRetinaNetHead(p)
        return jfa.FreeAnchorRetinaNet(
            backbone=backbone, neck=jretina.RetinaNetNeck(
                filters=FILTERS, name="neck"),
            head_module=head.module, head=head), head
    neck = jretina.RetinaNetNeck(filters=FILTERS, p6_source="p5", name="neck")
    if kind == "fcos":
        head = jfcos.FCOSHead(p)
        return jfcos.FCOS(backbone=backbone, neck=neck,
                          head_module=head.module, head=head), head
    head = jrep.RepPointsHead(p)
    return jrep.RepPoints(backbone=backbone, neck=neck,
                          head_module=head.module, head=head), head


def torch_model(s, params, train=True):
    kind, p = s["kind"], s["p"]
    if kind == "reppoints_moment_dcn":
        backbone = ResNet(18, variant="v1b", num_special=(0, 3, 3, 3),
                          special_block=DCNBottleneck)
    else:
        backbone = ResNet(18)
    c345 = backbone.out_channels[1:]
    if kind == "freeanchor":
        head = FreeAnchorRetinaNetHead(p)
        model = RetinaNet(backbone, RetinaNetNeck(c345, FILTERS),
                          RetinaSubnets(head.num_anchor, head.num_fg_class,
                                        FILTERS, FILTERS), head)
    else:
        neck = RetinaNetNeck(c345, FILTERS, p6_source="p5")
        if kind == "fcos":
            head = FCOSHead(p)
            model = FCOS(backbone, neck, FCOSSubnets(
                head.num_fg_class, FILTERS, FILTERS, head.strides), head)
        else:
            head = RepPointsHead(p)
            model = RepPoints(backbone, neck, RepPointsSubnets(
                head.num_fg_class, 9, FILTERS, FILTERS, FILTERS), head)
    from_flax(params, model)
    return model.to(memory_format=torch.channels_last).train(train)


PREDICTORS = {"cls_pred": 0.01, "bbox_pred": 0.01, "center_conv": 0.01,
              "cls_conv": 0.01, "cls_out": 0.01, "pts_refine_out": 0.01,
              "pts_init_out": 0.2}
CLS_PRIOR = ("cls_pred", "cls_conv", "cls_out")


def seeded(shapes, rng):
    """Kernels N(0, 1 / fan_in); the predictors N(0, PREDICTORS' std), the
    class predictors' biases at the 0.01 prior, other biases 0; FrozenBN
    scales in [0.2, 0.6], biases in [-0.2, 0.2]; GroupNorm scales and
    biases in [0.8, 1.2] (a relu follows: a bias near 1 keeps its inputs
    off 0, where float32 rounding would flip its gradient); FCOS's offset
    scales in [0.8, 1.2], the moment transfer in [-0.2, 0.2]; a DCN unit's
    offset conv N(0, 4 / fan_in), its bias N(0, 0.09), so that taps leave
    the grid."""
    def leaf(path, s):
        keys = [k.key for k in path]
        name, parent = keys[-1], keys[-2] if len(keys) > 1 else ""
        head = keys[0] == "head_module"
        if name.startswith("offset_scale_") or "_gn" in parent:
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if name == "moment_transfer":
            return rng.uniform(-0.2, 0.2, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.2, 0.6, s.shape).astype(np.float32)
        if name == "bias":
            if "bn" in parent:
                return rng.uniform(-0.2, 0.2, s.shape).astype(np.float32)
            if head and parent in CLS_PRIOR:
                return np.full(s.shape, -np.log(99.0), np.float32)
            if "offset_conv" in keys and not head:
                return (rng.randn(*s.shape) * 0.3).astype(np.float32)
            return np.zeros(s.shape, np.float32)
        if head and parent in PREDICTORS:
            return (rng.randn(*s.shape) * PREDICTORS[parent]).astype(
                np.float32)
        if head and parent == "offset_conv":            # FCOS's box output
            return (rng.randn(*s.shape) * 0.01).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        scale = 2.0 if "offset_conv" in keys else 1.0
        return (rng.randn(*s.shape) * scale / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def make_setup(kind):
    p = rpn_param(kind)
    jmodel, jhead = jax_model(kind, p)
    data = np.random.RandomState(IMAGE_SEED).randint(0, 256, (B, H, W, 3),
                                                     dtype=np.uint8)
    im_info = np.float32([[H, W, 1.0], [112, 160, 1.0]])
    shapes = jax.eval_shape(
        lambda r, x, i: jmodel.init(r, x, i, mode="test"),
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((B, H, W, 3)),
        jnp.asarray(im_info))["params"]
    params = seeded(shapes, np.random.RandomState(PARAM_SEED))
    return dict(kind=kind, jmodel=jmodel, jhead=jhead, p=p, gt=gt_boxes(),
                data=data, im_info=im_info, params=params)


def _normalised(s):
    return j_normalize(jnp.asarray(s["data"]), jnp.asarray(s["im_info"]),
                       MEAN, STD)


@pytest.fixture(scope="module", params=KINDS)
def setup(request):
    s = make_setup(request.param)
    data = _normalised(s)

    def loss_fn(params):
        # the pyramid and the head outputs of the same forward, captured:
        # the JAX side compiles once a kind
        (losses, aux), inter = s["jmodel"].apply(
            {"params": params}, data, jnp.asarray(s["im_info"]),
            jnp.asarray(s["gt"]), mode="train",
            capture_intermediates=lambda mdl, _: mdl.name in (
                "neck", "head_module"), mutable=["intermediates"])
        inter = inter["intermediates"]
        outs = (inter["neck"]["__call__"][0],
                inter["head_module"]["__call__"][0])
        return sum(losses.values()), (losses, aux, outs)

    s["loss_and_grad"] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (losses, aux, outs)), grads = s["loss_and_grad"](s["params"])
    s["want"] = (jax.tree.map(np.asarray, losses),
                 jax.tree.map(np.asarray, aux),
                 dict(_flat(jax.tree.map(np.asarray, grads))))
    s["pyramid"], s["head_outputs"] = jax.tree.map(np.asarray, outs)
    return s


@pytest.fixture(scope="module")
def torch_step(setup):
    """The port's train forward and backward (nothing frozen), and its head
    outputs on the batch."""
    s = setup
    model = torch_model(s, s["params"])
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    losses, aux = model(data, _t(s["im_info"]), _t(s["gt"]), mode="train")
    sum(losses.values()).backward()
    with torch.no_grad():
        outs = model.head_module(model.pyramid(data))
    return model, losses, aux, outs


# ------------------------------------------------------------ train step


def test_head_outputs_match(setup, torch_step):
    """Each level's head outputs (NHWC on the JAX side) within 1e-5 of
    their scale; for RepPoints the premise of the gradients: every
    deformable tap offset (the init points minus the grid) has the JAX
    package's floor (where a float32 difference moves an offset across an
    integer, the sampling's derivative jumps), and the offsets reach past a
    cell."""
    want, got = setup["head_outputs"], torch_step[3]
    assert set(want) == set(got)
    largest = 0.0
    base = np.float32([-1, -1, -1, 0, -1, 1, 0, -1, 0, 0, 0, 1, 1, -1, 1, 0,
                       1, 1])
    for key in want:
        for g, w in zip(got[key], want[key]):
            g = g.permute(0, 2, 3, 1).numpy()
            assert g.shape == w.shape
            assert rel_err(g, w) <= 1e-5, key
        if setup["kind"] in REPPOINTS:
            g = got[key][0].permute(0, 2, 3, 1).numpy()
            w = want[key][0]
            g_off = (0.9 * g + 0.1 * g) - base
            w_off = (0.9 * w + 0.1 * w) - base
            assert (np.floor(g_off) == np.floor(w_off)).all(), key
            largest = max(largest, float(np.abs(g).max()))
    if setup["kind"] in REPPOINTS:
        assert largest > 1.0


def test_losses_and_labels_match(setup, torch_step):
    want, want_aux, _ = setup["want"]
    _, losses, aux, _ = torch_step
    assert set(losses) == set(want)
    for k, v in want.items():
        assert rel_err(losses[k].detach(), v) <= LOSS_RTOL, k
        assert float(v) > 0, k
    kind = setup["kind"]
    if kind == "fcos":
        np.testing.assert_array_equal(aux["fcos_cls_label"].numpy(),
                                      want_aux["fcos_cls_label"])
        assert float(aux["fcos_num_pos"]) == float(want_aux["fcos_num_pos"])
        assert float(want_aux["fcos_num_pos"]) > 10
    elif kind == "freeanchor":
        assert float(aux["num_gt"]) == float(want_aux["num_gt"]) == 7
    else:
        label = aux["reppoints_label"].numpy()
        np.testing.assert_array_equal(label, want_aux["reppoints_label"])
        assert (label > 0).sum() >= 7 and (label == 0).any()


def test_targets_match(setup, torch_step):
    """The targets the losses read, each against the JAX function on the
    same inputs: FCOS's location targets (labels, offsets and the ignore
    mask exactly, centerness within 1e-6), RepPoints' point assignment
    (labels and boxes exactly), FreeAnchor's bags (the pre_anchor_top_n
    anchors of each gt, ties to the lower index: anchors placed
    symmetrically about a gt tie exactly)."""
    s, model = setup, torch_step[0]
    gt = _t(s["gt"])
    outs = torch_step[3]
    if s["kind"] == "fcos":
        head = model.head
        got = head.targets(outs, gt, _t(s["im_info"]))
        xy, bounds, _ = head.locations(outs)
        want = jax.vmap(lambda g, hw: jfcos.fcos_targets(
            g, hw, jnp.asarray(xy.numpy()), jnp.asarray(bounds.numpy())))(
            jnp.asarray(s["gt"]), jnp.asarray(s["im_info"][:, :2]))
        for i, (g, w) in enumerate(zip(got, want)):
            if i == 1:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    elif s["kind"] in REPPOINTS:
        from simpledet_tpu.ops.points import point_assign as j_assign
        from simpledet_torch.ops.points import point_assign

        points = model.head.points(outs)[0]
        label, gts = point_assign(points, gt, 4, 1)
        for i in range(B):
            wl, wg = j_assign(jnp.asarray(points.numpy()),
                              jnp.asarray(s["gt"][i]), 4, 1)
            np.testing.assert_array_equal(label[i].numpy(), np.asarray(wl))
            np.testing.assert_array_equal(gts[i].numpy(), np.asarray(wg))
        assert (label > 0).sum() == 7
    else:
        anchors = torch.cat(model.head.level_anchors(outs))
        iou = bbox_overlaps(gt[..., :4], anchors)
        _, idx = top_k_stable(iou, 16)
        for i in range(B):
            jiou = j_overlaps(jnp.asarray(s["gt"][i, :, :4]),
                              jnp.asarray(anchors.numpy()))
            np.testing.assert_array_equal(iou[i].numpy(), np.asarray(jiou))
            _, jidx = jax.lax.top_k(jiou, 16)
            np.testing.assert_array_equal(idx[i].numpy(), np.asarray(jidx))
        srt = torch.sort(iou, -1, descending=True)[0][..., :17]
        assert bool((srt[..., 1:] == srt[..., :-1]).any())   # exact ties


def test_iou_assign_premise(setup, torch_step):
    """RepPoints' refine labels compare IoUs of the init boxes with 0.4,
    0.5 and each gt's best IoU exactly: no box's best IoU within 1e-5 of a
    threshold, and each gt's best box ahead of its second by 1e-6 (in
    float64 on the JAX side's init boxes)."""
    s = setup
    if s["kind"] not in REPPOINTS:
        return
    model = torch_step[0]
    outs = torch_step[3]
    points, strides, _ = model.head.points(outs)
    pts_init = model.head.flatten(outs)[0].double()
    boxes = model.head.boxes(points.double(), pts_init,
                             strides[:, None].double(),
                             None if model.moment_transfer is None else
                             model.moment_transfer.detach().double())
    for i in range(B):
        g = _t(s["gt"][i]).double()
        g = g[g[:, 4] > 0]
        iou = bbox_overlaps(boxes[i], g[:, :4], legacy_plus_one=False)
        best = iou.max(1)[0]
        assert float((best - 0.4).abs().min()) > 1e-5
        assert float((best - 0.5).abs().min()) > 1e-5
        top2 = torch.topk(iou, 2, dim=0)[0]
        assert float((top2[0] - top2[1]).min()) > 1e-6


def test_every_gradient_matches_jax_grad(setup, torch_step):
    """Each parameter's gradient within 1e-4 of its leaf's max |grad| of
    jax.grad (zero where it is zero); FrozenBN's buffers have none."""
    grads = setup["want"][2]
    model = torch_step[0]
    got = {flax_path(n): flax_leaf(n, p.grad.numpy())
           for n, p in model.named_parameters()}
    frozen_bn = {k for k in grads if "/" in k and "bn" in k.split("/")[-2]
                 and k.rsplit("/", 1)[1] in ("scale", "bias")}
    assert set(got) == set(grads) - frozen_bn
    for k, g in got.items():
        assert rel_err(g, grads[k]) <= GRAD_RTOL, (k, rel_err(g, grads[k]))
    # zero on both sides only where no target reaches: FCOS's box tower
    # norms and offset scales of the levels without a positive location
    zero = [k for k in got if not np.abs(grads[k]).any()]
    assert all("head_module/offset_" in k for k in zero), zero


def test_trainable_set_matches_freeze_mask(setup):
    """conv0 / stage1 / scale / bias frozen: the port's trainable set is
    the JAX package's freeze_mask on the same model (FCOS's offset scales,
    the GroupNorms' scales and biases and every head bias frozen; the
    moment transfer trained)."""
    s = setup
    trainer = Trainer(torch_model(s, s["params"]), schedule=lambda i: 0.01,
                      fixed_param=FIXED)
    want = dict(_flat(j_freeze_mask(s["params"], FIXED)))
    got = {flax_path(n): t for n, t in trainer.trainable.items()}
    assert got == {k: bool(v) for k, v in want.items()}
    if s["kind"] == "fcos":
        assert not got["head_module/offset_scale_stride8"]
        assert not got["head_module/shared_gn1_stride8/scale"]
    if s["kind"] == "reppoints_moment":
        assert got["moment_transfer"]
        assert got["head_module/cls_conv_kernel"]


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


def test_fcos_neck_p6_from_p5(setup, torch_step):
    """The FCOS neck's P6 is the stride-2 conv on the output P5 (64 in, not
    C5's 2048) and P7 the one on relu(P6): its levels equal the JAX neck's
    (p6_source "p5") within 1e-5; RetinaNet's neck (FreeAnchor's) takes C5."""
    s, model = setup, torch_step[0]
    neck = model.neck
    want_in = FILTERS if s["kind"] != "freeanchor" else 2048
    assert neck.P6_conv.in_channels == want_in
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    with torch.no_grad():
        got = model.pyramid(data)
    want = s["pyramid"]
    assert [tuple(got[k].shape[2:]) for k in sorted(got)] == [
        tuple(want[k].shape[1:3]) for k in sorted(want)]
    for k in want:
        assert rel_err(got[k].permute(0, 2, 3, 1).numpy(), want[k]) <= 1e-5


# ------------------------------------------------------------- test path


def _test_params(s):
    params = jax.tree.map(lambda v: np.array(v), s["params"])
    hm = params["head_module"]
    key = {"fcos": "cls_conv", "freeanchor": "cls_pred"}.get(s["kind"],
                                                             "cls_out")
    hm[key]["kernel"] *= TEST_CLS_SCALE[s["kind"]]
    if s["kind"] == "fcos":            # boxes of a few cells
        hm["offset_conv"]["bias"] += 3.0
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


def canonical_rows(out, b):
    """Image b's valid rows (class, box, score) in a canonical order: by
    class, then the box rounded to 0.01 px (two scores a few ulps apart may
    leave torch.topk and lax.top_k in either order)."""
    cls = np.asarray(out["cls_score"])[b]
    valid = np.asarray(out["det_valid"])[b]
    rows = np.concatenate([cls.argmax(1)[:, None],
                           np.asarray(out["bbox_xyxy"])[b, :, :4],
                           cls.max(1)[:, None]], 1)[valid]
    return rows[np.lexsort(np.round(rows[:, 4::-1], 2).T)]


def test_test_forward_matches(setup, test_outputs):
    """The same rows valid (no score within 1e-6 of the 0.05 threshold),
    each image's candidates the same: classes identical, boxes and scores
    within 1e-4 of their scale (in a canonical order, `canonical_rows`).
    FreeAnchor keeps every row: its top-k by max class probability, each
    with its full row of class probabilities."""
    want, got = test_outputs
    got = {k: v.numpy() for k, v in got.items()}
    for k in want:
        assert got[k].shape == want[k].shape, k
    valid = want["det_valid"]
    np.testing.assert_array_equal(got["det_valid"], valid)
    assert valid.sum() > 50
    for b in range(B):
        g, w = canonical_rows(got, b), canonical_rows(want, b)
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        assert rel_err(g[:, 1:5], w[:, 1:5]) <= DET_RTOL
        assert rel_err(g[:, 5], w[:, 5]) <= DET_RTOL
        if setup["kind"] != "freeanchor":
            assert np.abs(w[:, 5] - 0.05).min() > 1e-6
    if setup["kind"] == "freeanchor":
        assert rel_err(np.sort(got["cls_score"], 1),
                       np.sort(want["cls_score"], 1)) <= DET_RTOL


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


# ------------------------------------- the learning recipes: SyncBN


@pytest.mark.parametrize("config", ["config/converge_fcos.py",
                                    "config/converge_reppoints.py",
                                    "config/converge_freeanchor.py"])
def test_converge_recipe_syncbn_trajectory(config):
    """The config's own train detector and schedule on both sides (depth-18
    ResNet with SyncBN, nothing frozen, gradual warmup; sgd with momentum
    0.9 in place of the reppoints and freeanchor recipes' adam: adam turns
    float32 noise in a gradient that SyncBN cancels into lr-sized updates
    of either sign): from the Flax init (SyncBN betas at 3 and random
    running statistics, as tests/test_torch_syncbn.py) 3 steps of Trainer
    against make_train_step with its batch_stats state: each total loss
    within 1e-5 relative, every parameter and running statistic within 1e-4
    of its scale (a running variance's: its var + mean^2). FCOS's
    GroupNorms start at scale and bias 1: at Flax's bias 0 half their
    outputs meet the relu at 0, and float32 rounding flips those gradients
    (tests/test_torch_v1b_mask.py starts its GroupNorms so)."""
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
    gt = gt_boxes()
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda r, x, i: jmodel.init(r, x, i, mode="test"))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((B, H, W, 3)),
        jnp.asarray(im_info)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.full_like(v, 3.0) if path[-1].key == "beta"
        else np.ones_like(v) if len(path) > 1 and "_gn" in path[-2].key
        else v,
        variables["params"])
    bs = jax.tree.map(lambda v: rng.uniform(0.5, 1.5, v.shape).astype(
        np.float32), variables["batch_stats"])
    from_flax(params, model, bs)
    model = model.to(memory_format=torch.channels_last).train()
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
    for k, w in want_bs.items():
        scale = np.abs(w).max()
        if k.endswith("/var"):
            scale = (w + want_bs[k[:-3] + "mean"] ** 2).max()
        assert np.abs(got_bs[k] - w).max() <= 1e-4 * scale, k
