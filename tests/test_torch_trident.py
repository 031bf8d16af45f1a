"""TridentNet and the C4 Faster R-CNN in the port against the JAX package, on
the CPU.

- The trident units (v1, v1b, v2) at dilations 1-3 and stride 2 on even
  sides, where their explicit (d, d) padding and Flax's SAME differ; the
  three trident backbones at B = 2 (branch-major fold); both C5 heads; the
  two scale-aware helpers; the anchor grid premise.
- TridentFasterRcnn at depth 18 on 128 x 192 images, batch 2 (so a fold
  order that is wrong at B = 2 shows), 5 classes, image_roi 16, 7 x 7 rois,
  pre/post NMS 96/48, both sides built from the same Flax params:
  - one branch, v1, FrozenBN with random folded statistics (every C4
    Faster R-CNN config);
  - three branches, v2, SyncBN (betas at 3, as tests/test_torch_syncbn.py
    starts them), scale-aware with converge_trident's ranges (0, 40),
    (25, 56), (40, -1), which split this batch's gt between the branches;
  the losses, the sampled labels, the RPN labels (scale-aware: those near
  an out-of-range gt ignored), every gradient against jax.grad, and for
  the three branches a 3-step SGD trajectory against make_train_step with
  its `batch_stats` (a trident unit's norms take one EMA step a branch).
  Sampling runs on `arange` priorities on both sides, and the train
  proposals are `deterministic_proposals` of the branch-filtered gt (the
  JAX RPN helper's train proposals patched, the port's `fixed_proposals`).
  The JAX side runs the crop RoIAlign.
- The test forward of the three-branch model on its running statistics
  (scale-aware score filter and the fold into the detection axis), its
  TridentNet-Fast form (one branch at dilation 2), and rpn_test; the
  per-class NMS on both sides' outputs.

Tolerances: module outputs and losses within 1e-5 of their scale, the test
path's proposals and detections within 1e-4 of theirs (their boxes decode
the RPN's and the head's deltas through exp()), each gradient within 1e-4
of its own max |grad|, the trajectory's parameters within 1e-4
of their scale and running statistics within 1e-5; labels exactly. The
premise of the gradient comparisons, as in tests/test_torch_mask.py: no
RoIAlign bin max is taken at other samples from the JAX features than from
the port's (`test_no_bin_max_flips`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_tpu.models import fpn as jfpn
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models import tridentnet as jtri
from simpledet_tpu.models.faster_rcnn import (
    deterministic_proposals as j_fixed_proposals)
from simpledet_tpu.models.norm import normalizer_factory as j_norm
from simpledet_tpu.models.rpn import FPNRpnHead as JRpnHead
from simpledet_tpu.ops.image import device_normalize as j_normalize
from simpledet_tpu.targets import sampling as jsampling
from simpledet_torch.core.config import patch_config_as_nothrow
from simpledet_torch.models.fpn import Neck
from simpledet_torch.models.norm import SyncBN, normalizer_factory
from simpledet_torch.models.resnet import Bottleneck
from simpledet_torch.models.rpn import FPNRpnHead, RpnConvHead
from simpledet_torch.models.tridentnet import (BboxC5Head,
                                               TridentBottleneckV1,
                                               TridentBottleneckV2,
                                               TridentFasterRcnn,
                                               TridentResNetC4,
                                               filter_gt_by_range,
                                               ignore_anchors_near_invalid_gt)
from simpledet_torch.ops.image import device_normalize
from simpledet_torch.weights import flax_leaf, flax_path, from_flax

CONT, GRAD_RTOL, DET_RTOL = 1e-5, 1e-4, 1e-4
MEAN, STD = (122.7717, 115.9465, 102.9801), (1.0, 1.0, 1.0)
NUM_CLASS, B, H, W = 5, 2, 128, 192
RANGES = ((0, 56), (40, 90), (64, -1))
SEED_KEY = jax.random.PRNGKey(3)
FIXED = ("conv0", "stage1", "scale", "bias")
BETA = 3.0


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
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _flax(name, t):
    return flax_leaf(name, t.detach().numpy())


def seeded(shapes, rng, scale_range=(0.2, 0.6)):
    """Params of `jax.eval_shape`'s shapes: kernels N(0, 1 / fan_in),
    FrozenBN scales in scale_range and biases in [-0.2, 0.2] (folded
    statistics that keep activations of order one)."""
    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(*scale_range, s.shape).astype(np.float32)
        if name == "bias":
            return rng.uniform(-0.2, 0.2, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def flax_params(jmodel, rng, *args, **kw):
    shapes = jax.eval_shape(lambda *a: jmodel.init(
        jax.random.PRNGKey(0), *a, **kw), *args)["params"]
    return seeded(shapes, rng)


# ------------------------------------------------------------------ units


@pytest.mark.parametrize("dilation", [1, 2, 3])
@pytest.mark.parametrize("variant", ["v1", "v1b", "v2"])
def test_trident_unit_matches_flax(variant, dilation):
    """A strided trident unit (64 -> 16 x 4 channels, stride 2, projection
    shortcut) on a 2 x 10 x 14 batch at each dilation: within 1e-5 of the
    Flax unit's output from the same params; the shared kernel is the Flax
    leaf `conv2_kernel`, one parameter."""
    norm = j_norm("fixbn")
    if variant == "v2":
        jmod = jtri.TridentBottleneckV2(filters=16, stride=2, norm=norm)
        tmod = TridentBottleneckV2(64, 16, 2, torch.float32,
                                   normalizer_factory("fixbn"))
    else:
        jmod = jtri.TridentBottleneckV1(filters=16, stride=2, norm=norm,
                                        variant=variant)
        tmod = TridentBottleneckV1(64, 16, 2, torch.float32,
                                   normalizer_factory("fixbn"), variant)
    rng = np.random.RandomState(dilation)
    x = rng.randn(2, 10, 14, 64).astype(np.float32)
    params = flax_params(jmod, rng, jnp.asarray(x), dilation=dilation)
    assert params["conv2_kernel"].shape == (3, 3, 16, 16)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x),
                                 dilation=dilation))
    from_flax(params, tmod)
    assert [n for n, _ in tmod.named_parameters()
            if "conv2" in n] == ["conv2_kernel"]
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x), dilation))
    assert got.shape == want.shape == (2, 5, 7, 64)
    assert rel_err(got, want) <= CONT


def test_strided_trident_conv_pads_explicitly_not_same():
    """The trap: at stride 2 on an even side Flax's SAME pads (0, 1) where
    the trident unit pads (1, 1): the same kernel gives other values (the
    port's v1b `Bottleneck` pads (1, 1) explicitly too, as the JAX one)."""
    rng = np.random.RandomState(0)
    y = rng.randn(1, 10, 14, 8).astype(np.float32)
    k = rng.randn(3, 3, 8, 8).astype(np.float32)
    same = jax.lax.conv_general_dilated(
        jnp.asarray(y), jnp.asarray(k), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    explicit = jax.lax.conv_general_dilated(
        jnp.asarray(y), jnp.asarray(k), (2, 2), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    unit = TridentBottleneckV1(8, 8, 2, torch.float32,
                               normalizer_factory("fixbn"), "v1b")
    with torch.no_grad():
        unit.conv2_kernel.copy_(_t(k.transpose(3, 2, 0, 1)))
        got = _nhwc(unit.dilated_conv2(_nchw(y), 1))
    assert rel_err(got, explicit) <= CONT
    assert rel_err(got, same) > 0.1
    assert Bottleneck(8, 2, 2, torch.float32, normalizer_factory("fixbn"),
                      "v1b").conv2.padding == (1, 1)


def jax_backbone(variant, norm="fixbn", depth=18, num_branch=3,
                 dilations=(1, 2, 3)):
    if variant == "v2":
        return jtri.TridentResNetV2C4(depth=depth, norm=j_norm(norm),
                                      num_branch=num_branch,
                                      dilations=dilations, name="backbone")
    return jtri.TridentResNetV1C4(depth=depth, variant=variant,
                                  norm=j_norm(norm), num_branch=num_branch,
                                  dilations=dilations, name="backbone")


@pytest.mark.parametrize("variant", ["v1", "v1b", "v2"])
def test_trident_backbone_matches_flax(variant):
    """The three trident backbones at depth 18, 3 branches, on a 2 x 64 x 96
    batch: c4 = stride16 [6, 4, 6, 1024] within 1e-5 of their scale, the
    branches branch-major (rows 2k and 2k + 1 are branch k's two images);
    v2 has `stage3_bn`, v1 / v1b none."""
    jmod = jax_backbone(variant)
    rng = np.random.RandomState(1)
    x = rng.randn(B, 64, 96, 3).astype(np.float32)
    params = flax_params(jmod, rng, jnp.asarray(x))
    want = jmod.apply({"params": params}, jnp.asarray(x))
    model = TridentResNetC4(18, variant)
    from_flax(params, model)
    assert hasattr(model, "stage3_bn") == (variant == "v2") == \
        ("stage3_bn" in params)
    with torch.no_grad():
        got = model(_nchw(x))
        alone = model.branches(model.stem_and_trunk(_nchw(x[1:])))
    c4 = np.asarray(want["c4"])
    assert c4.shape == (3 * B, 4, 6, 1024)
    assert got["c4"] is got["stride16"]
    assert rel_err(_nhwc(got["c4"]), c4) <= CONT
    # image 1 alone gives branch k's row 2k + 1 (v1 / v1b: no batch-wide
    # norm after the fold, FrozenBN everywhere)
    assert rel_err(_nhwc(alone), c4[1::2]) <= CONT


@pytest.mark.parametrize("variant", ["v1", "v1b", "v2"])
def test_c5_head_matches_flax(variant):
    """BboxC5Head (v2: BboxC5V2Head with stage4_bn; v1 / v1b: BboxC5V1Head)
    at depth 18 on roi features [2, 3, 14, 14, 1024]: cls logits and deltas
    within 1e-5 of their scale."""
    norm = j_norm("fixbn")
    if variant == "v2":
        jmod = jtri.BboxC5V2Head(num_class=NUM_CLASS, num_reg_class=2,
                                 depth=18, norm=norm)
    else:
        jmod = jtri.BboxC5V1Head(num_class=NUM_CLASS, num_reg_class=2,
                                 depth=18, variant=variant, norm=norm)
    rng = np.random.RandomState(2)
    feat = np.maximum(rng.randn(2, 3, 14, 14, 1024), 0).astype(np.float32)
    params = flax_params(jmod, rng, jnp.asarray(feat))
    want = jmod.apply({"params": params}, jnp.asarray(feat))
    head = BboxC5Head(NUM_CLASS, 2, 18, variant)
    from_flax(params, head)
    with torch.no_grad():
        got = head(_t(feat))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_err(g.numpy(), w) <= CONT


def test_scale_aware_helpers_match_jax():
    """filter_gt_by_range and ignore_anchors_near_invalid_gt on a folded
    batch (4 images, padded gt, a range per image, boxes straddling the
    range edges) equal the JAX package's vmapped functions exactly."""
    rng = np.random.RandomState(4)
    n, g = 4, 12
    xy = rng.uniform(0, 150, (n, g, 2))
    wh = rng.uniform(8, 120, (n, g, 2))
    gt = np.concatenate([xy, xy + wh, rng.randint(1, 5, (n, g, 1))],
                        -1).astype(np.float32)
    gt[:, 9:] = -1
    ranges = np.float32([[0, 40], [25, 56], [40, 1e5], [30, 60]])
    anchors = np.float32(rng.uniform(0, 160, (300, 2)))
    anchors = np.concatenate([anchors, anchors + rng.uniform(
        10, 90, (300, 2))], -1).astype(np.float32)
    label = rng.randint(-1, 2, (n, 300)).astype(np.float32)
    want_gt = jax.vmap(jtri.filter_gt_by_range)(jnp.asarray(gt),
                                               jnp.asarray(ranges))
    want_label = jax.vmap(
        lambda lb, gg, vr: jtri.ignore_anchors_near_invalid_gt(
            lb, jnp.asarray(anchors), gg, vr))(
        jnp.asarray(label), jnp.asarray(gt), jnp.asarray(ranges))
    got_gt = filter_gt_by_range(_t(gt), _t(ranges))
    got_label = ignore_anchors_near_invalid_gt(_t(label), _t(anchors),
                                               _t(gt), _t(ranges))
    np.testing.assert_array_equal(got_gt.numpy(), np.asarray(want_gt))
    np.testing.assert_array_equal(got_label.numpy(), np.asarray(want_label))
    kept = (got_gt[..., 4] >= 0).sum().item()
    assert 0 < kept < (gt[..., 4] >= 0).sum()
    assert (got_label == -1).sum() > (_t(label) == -1).sum()


@pytest.mark.parametrize("hw", [(H, W), (800, 1333), (600, 1000),
                                (1000, 1600)])
def test_anchor_grid_premise(hw):
    """The JAX package's scale-aware ignore takes `anchors_for(pad_hw)`, a
    ceil(pad / 16) grid; the port takes the anchors of the stride-16
    feature's own shape. Premise: the trident backbone's output (v1 and
    v2, traced on the meta device) has that shape at the tested size and
    at the configs' pads, so the two grids are the same anchors."""
    p_rpn = params_classes()[0]
    jrpn = JRpnHead(p_rpn)
    for variant in ("v1", "v2"):
        model = TridentResNetC4(18, variant, num_branch=1).to("meta")
        out = model(torch.empty(1, 3, *hw, device="meta"))["stride16"]
        grid = FPNRpnHead(p_rpn).anchors(16, out.shape[2:], "cpu")
        np.testing.assert_array_equal(grid.numpy(),
                                      np.asarray(jrpn.anchors_for(hw)))


# ----------------------------------------------------------- the detector


def params_classes():
    class RpnParam:
        class anchor_generate:
            scale = (2, 4, 8)
            ratio = (0.5, 1.0, 2.0)
            stride = (16,)

        class anchor_assign:
            allowed_border = 0
            pos_thr = 0.7
            neg_thr = 0.3
            min_pos_thr = 0.0
            image_anchor = 64
            pos_fraction = 0.5

        class head:
            conv_channel = 64

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
        stride = 16

    class BboxParam:
        num_class = NUM_CLASS

        class regress_target:
            class_agnostic = True
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    return [patch_config_as_nothrow(c) for c in (RpnParam, RoiParam,
                                                  BboxParam)]


# (variant, norm, branches, scale-aware): every C4 Faster R-CNN; TridentNet
KINDS = {"c4": ("v1", "fixbn", 1, False), "trident": ("v2", "fixbn", 3, True),
         "trident_syncbn": ("v2", "syncbn", 3, True)}
IMAGE_SEED = {"c4": 1, "trident": 3, "trident_syncbn": 5}


def gt_boxes():
    """sqrt-areas 41, 100, 68, 33 and 80, 66, 58, 31: each of RANGES'
    branches gets a proper subset, and anchors near the out-of-range ones
    exist. Rois of 2-7 cells at stride 16: on smaller ones the 7 x 7 bins'
    samples lie so close that their float32 near-ties flip bin maxima."""
    gt = np.full((B, 8, 5), -1, np.float32)
    gt[0, :4] = [[10, 12, 50, 52, 1], [60, 20, 170, 110, 3],
                 [100, 50, 170, 115, 2], [5, 70, 34, 105, 4]]
    gt[1, :4] = [[20, 10, 110, 80, 2], [0, 40, 60, 110, 1],
                 [130, 60, 185, 120, 3], [40, 90, 70, 120, 4]]
    return gt


def jax_model(kind, p, num_branch=None, dilations=(1, 2, 3),
              scaleaware=None):
    variant, norm, nb, sa = KINDS[kind]
    nb = num_branch or nb
    p_rpn, p_roi, p_bbox = p
    p_rpn.dtype = jnp.float32
    jrpn = JRpnHead(p_rpn)
    if variant == "v2":
        head = jtri.BboxC5V2Head(num_class=NUM_CLASS, num_reg_class=2,
                                 depth=18, norm=j_norm(norm),
                                 name="bbox_head")
    else:
        head = jtri.BboxC5V1Head(num_class=NUM_CLASS, num_reg_class=2,
                                 depth=18, variant=variant,
                                 norm=j_norm(norm), name="bbox_head")
    return jtri.TridentFasterRcnn(
        backbone=jax_backbone(variant, norm, num_branch=nb,
                              dilations=dilations),
        neck=jfpn.Neck(name="neck"), rpn_module=jrpn.module, rpn=jrpn,
        bbox_head=head, p_rpn=p_rpn, p_roi=p_roi, p_bbox=p_bbox,
        num_branch=nb, scaleaware=sa if scaleaware is None else scaleaware,
        valid_ranges=RANGES), jrpn


def torch_model(s, train=True, num_branch=None, dilations=(1, 2, 3),
                scaleaware=None):
    variant, norm, nb, sa = KINDS[s["kind"]]
    nb = num_branch or nb
    p_rpn, p_roi, p_bbox = s["p"]
    backbone = TridentResNetC4(18, variant, norm=normalizer_factory(norm),
                               num_branch=nb, dilations=dilations)
    trpn = FPNRpnHead(p_rpn)
    model = TridentFasterRcnn(
        backbone, Neck(), RpnConvHead(trpn.num_anchor, 64, 1024), trpn,
        BboxC5Head(NUM_CLASS, 2, 18, variant, norm=normalizer_factory(norm)),
        p_roi, p_bbox, num_branch=nb,
        scaleaware=sa if scaleaware is None else scaleaware,
        valid_ranges=RANGES, fixed_proposals=True,
        deterministic_sampling=True)
    from_flax(s["params"], model, s["batch_stats"])
    return model.to(memory_format=torch.channels_last).train(train)


def make_setup(kind):
    p = params_classes()
    jmodel, jrpn = jax_model(kind, p)
    data = np.random.RandomState(IMAGE_SEED[kind]).randint(
        0, 256, (B, H, W, 3), dtype=np.uint8)
    rng = np.random.RandomState(5)
    im_info = np.float32([[H, W, 1.0], [120, 180, 1.0]])
    variables = jax.eval_shape(
        lambda r, x, i: jmodel.init(r, x, i, mode="test"),
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros((B, H, W, 3)), jnp.asarray(im_info))
    params = seeded(variables["params"], rng)
    # the RPN and the predictors at Flax's inits (normal 0.01, the deltas
    # 0.001, biases 0): deltas of order one would decode through exp() into
    # boxes whose float32 differences the ranges and the NMS amplify
    for mod, leaf, std in (("rpn_module", "rpn_conv", 0.01),
                           ("rpn_module", "rpn_cls", 0.01),
                           ("rpn_module", "rpn_reg", 0.01),
                           ("bbox_head", "cls_logit", 0.01),
                           ("bbox_head", "bbox_delta", 0.001)):
        p_ = params[mod][leaf]
        p_["kernel"] = (rng.standard_normal(p_["kernel"].shape)
                        * std).astype(np.float32)
        p_["bias"] = np.zeros_like(p_["bias"])
    batch_stats = None
    if KINDS[kind][1] == "syncbn":
        params = jax.tree_util.tree_map_with_path(
            lambda path, v: np.full_like(v, BETA) if path[-1].key == "beta"
            else np.ones_like(v) if path[-1].key == "gamma" else v, params)
        batch_stats = jax.tree.map(lambda v: rng.uniform(
            0.5, 1.5, v.shape).astype(np.float32), variables["batch_stats"])
    return dict(kind=kind, jmodel=jmodel, jrpn=jrpn, params=params,
                batch_stats=batch_stats, data=data, im_info=im_info,
                gt=gt_boxes(), p=p)


def folded_gt(s):
    """The gt each branch's RPN and sampler see: [nb * B, G, 5]."""
    _, _, nb, sa = KINDS[s["kind"]]
    gt = jnp.concatenate([jnp.asarray(s["gt"])] * nb, 0)
    if not sa:
        return gt
    ranges = jnp.repeat(jnp.asarray([[lo, hi if hi > 0 else 1e5]
                                     for lo, hi in RANGES[:nb]],
                                    jnp.float32), B, 0)
    return jax.vmap(jtri.filter_gt_by_range)(gt, ranges)


def jax_patches(s):
    """While the JAX package's functions are traced: arange priorities, the
    crop RoIAlign, and the train proposals from the branch-filtered gt."""
    jrpn, gt_b = s["jrpn"], folded_gt(s)
    real = jrpn.proposals

    def proposals(level_outputs, im_info, pad_hw, is_train):
        boxes, scores = real(level_outputs, im_info, pad_hw, is_train)
        if is_train:
            boxes = j_fixed_proposals(gt_b, boxes.shape[1])
        return boxes, scores

    mp = pytest.MonkeyPatch()
    mp.setenv("SIMPLEDET_ROI_ALIGN", "crop")
    mp.setattr(jsampling, "_priorities",
               lambda rng, n, deterministic: jnp.arange(n, dtype=jnp.float32))
    mp.setattr(jrpn, "proposals", proposals)
    return mp


def _variables(s, params):
    v = {"params": params}
    if s["batch_stats"] is not None:
        v["batch_stats"] = s["batch_stats"]
    return v


def jax_grads(s):
    """Losses, aux, gradients and the stride-16 features of one JAX step
    (the running statistics after it for SyncBN)."""
    mp = jax_patches(s)
    mutable = ["batch_stats"] if s["batch_stats"] is not None else False
    try:
        data = j_normalize(jnp.asarray(s["data"]), jnp.asarray(s["im_info"]),
                           MEAN, STD)

        def loss_fn(params):
            out = s["jmodel"].apply(
                _variables(s, params), data, jnp.asarray(s["im_info"]),
                jnp.asarray(s["gt"]), mode="train",
                rngs={"sampling": SEED_KEY}, mutable=mutable)
            (losses, aux), mut = out if mutable else (out, {})
            return sum(losses.values()), (losses, aux, mut)

        def grads_and_features(params):
            feat = s["jmodel"].apply(
                _variables(s, params), data,
                method=lambda m, d: m.backbone(d)["stride16"],
                mutable=mutable)
            feat = feat[0] if mutable else feat
            return jax.value_and_grad(loss_fn, has_aux=True)(params), feat

        ((_, (losses, aux, mut)), grads), feat = jax.jit(
            grads_and_features)(s["params"])
    finally:
        mp.undo()
    return dict(losses=jax.tree.map(np.asarray, losses),
                aux=jax.tree.map(np.asarray, aux),
                grads=dict(_flat(jax.tree.map(np.asarray, grads))),
                feat=np.asarray(feat),
                stats=dict(_flat(jax.tree.map(np.asarray,
                                              mut.get("batch_stats", {})))))


def torch_step(s):
    model = torch_model(s)
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    losses, aux = model(data, _t(s["im_info"]), _t(s["gt"]), mode="train",
                        generator=torch.Generator())
    sum(losses.values()).backward()
    return model, losses, aux


@pytest.fixture(scope="module", params=["c4", "trident"])
def step(request):
    s = make_setup(request.param)
    return s, jax_grads(s), torch_step(s)


def test_losses_and_labels_match(step):
    """The four losses within 1e-5 relative; the sampled box labels, the
    RPN labels (folded, [nb * B, anchors]) and the box logits' rows as the
    JAX package's; fg rois on every branch's images."""
    s, want, (_, losses, aux) = step
    nb = KINDS[s["kind"]][2]
    assert set(losses) == set(want["losses"]) == {
        "rpn_cls_loss", "rpn_reg_loss", "bbox_cls_loss", "bbox_reg_loss"}
    for k, v in want["losses"].items():
        assert rel_err(losses[k].detach(), v) <= CONT, k
    label = aux["bbox_label"].numpy()
    assert label.shape == (nb * B, 16)
    np.testing.assert_array_equal(label, want["aux"]["bbox_label"])
    np.testing.assert_array_equal(aux["rpn_label"].numpy(),
                                  want["aux"]["rpn_label"])
    assert (label > 0).any(1).all()
    assert rel_err(aux["bbox_cls_logit"].detach().numpy(),
                   want["aux"]["bbox_cls_logit"]) <= CONT


def test_rpn_labels_ignore_anchors_near_out_of_range_gt(step):
    """Three branches: each branch's RPN sees its own gt subset (the labels
    differ between branches of one image), and the returned RPN labels
    ignore more anchors than the loss's own targets did. One branch, not
    scale-aware: the returned labels are the loss's targets."""
    s, _, (model, _, aux) = step
    label = aux["rpn_label"].numpy()
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    with torch.no_grad():
        rpn_out = model.rpn_module(model.pyramid(data))
        gt_b = model.fold(_t(s["gt"]))
        if model.scaleaware:
            gt_b = filter_gt_by_range(gt_b, model.branch_ranges(B, "cpu"))
        _, raw = model.rpn.loss(torch.Generator(), rpn_out, gt_b,
                                model.fold(_t(s["im_info"])),
                                deterministic=True)
    raw = raw["rpn_label"].numpy()
    if model.num_branch == 1:
        np.testing.assert_array_equal(label, raw)
        return
    assert not np.array_equal(label[0], label[2 * B - 2])
    assert (label == -1).sum() > (raw == -1).sum()


def test_no_bin_max_flips(step):
    """Premise of the gradient test: on the rois the port samples, each 7 x 7
    bin's max is taken at the same samples from the JAX stride-16 features
    as from the port's."""
    from simpledet_torch.kernels.roi_align import multilevel_roi_align_plain

    s, want, (model, _, _) = step
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    with torch.no_grad():
        pyr, sample, _, _ = model.box_branch(data, _t(s["im_info"]),
                                             _t(s["gt"]), torch.Generator())
    port = pyr["stride16"].permute(0, 2, 3, 1).contiguous()
    assert rel_err(port.numpy(), want["feat"]) <= CONT
    codes = [multilevel_roi_align_plain([f], sample["rois"], (16,),
                                        out_size=7, with_codes=True)[1]
             for f in (port, _t(want["feat"]))]
    assert torch.equal(*codes)


def test_every_gradient_matches_jax_grad(step):
    """Each parameter's gradient, the shared trident kernels' (summed over
    the branches) and SyncBN's gamma and beta among them, within 1e-4 of its
    own max |grad| of jax.grad; under SyncBN the running statistics after
    the step (three EMA steps a trident norm) within 1e-5."""
    s, want, (model, _, _) = step
    grads = want["grads"]
    errs = {name: rel_err(_flax(name, p.grad), grads[flax_path(name)])
            for name, p in model.named_parameters()}
    assert len(errs) == sum(1 for k in grads
                            if not k.endswith(("/scale", "/bias"))
                            or "bn" not in k.split("/")[-2])
    assert any(k.endswith("conv2_kernel") for k in errs)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    if s["batch_stats"] is not None:
        from simpledet_torch.core.checkpoint import batch_stats_to_flax

        got = dict(_flat(batch_stats_to_flax(model)))
        assert set(got) == set(want["stats"])
        for k, v in want["stats"].items():
            assert rel_err(got[k], v) <= CONT, k


def test_syncbn_trident_sgd_trajectory_and_batch_stats():
    """Three steps of the three-branch SyncBN model: Trainer against
    make_train_step (sgd, momentum 0.9, wd 1e-4, gradual warmup, the
    templates' fixed conv0 / stage1 / scale / bias): each step's loss within
    1e-5, every parameter within 1e-4 of its scale after the third, frozen
    ones unchanged, and `batch_stats` within 1e-5."""
    from simpledet_tpu.core.optimizer import freeze_mask as j_freeze_mask
    from simpledet_tpu.core.optimizer import make_optimizer as j_make_opt
    from simpledet_tpu.core.schedule import warmup_multifactor as j_warmup
    from simpledet_tpu.core.train import TrainState, make_train_step
    from simpledet_torch.core.checkpoint import batch_stats_to_flax
    from simpledet_torch.core.schedule import warmup_multifactor
    from simpledet_torch.core.train import Trainer

    s = make_setup("trident_syncbn")
    mp = jax_patches(s)
    try:
        sched_args = dict(warmup_lr=0.02 / 3, warmup_iter=500)
        tx = j_make_opt(j_warmup(0.02, [60000], **sched_args), momentum=0.9,
                        wd=1e-4,
                        trainable_mask=j_freeze_mask(s["params"], FIXED))
        state = TrainState.create(apply_fn=s["jmodel"].apply,
                                  params=s["params"], tx=tx,
                                  batch_stats=s["batch_stats"])
        jstep = make_train_step(s["jmodel"], donate=False,
                                pixel_norm=(MEAN, STD))
        batch = {"data": jnp.asarray(s["data"]),
                 "im_info": jnp.asarray(s["im_info"]),
                 "gt_bbox": jnp.asarray(s["gt"])}
        trainer = Trainer(torch_model(s), schedule=warmup_multifactor(
            0.02, [60000], **sched_args), fixed_param=FIXED, momentum=0.9,
            wd=1e-4, pixel_norm=(MEAN, STD))
        for i in range(3):
            state, jl, _ = jstep(state, batch,
                                 jax.random.fold_in(SEED_KEY, i))
            tl = trainer.step(_t(s["data"]), _t(s["im_info"]), _t(s["gt"]))
            assert rel_err(tl["total_loss"], jl["total_loss"]) <= CONT, i
    finally:
        mp.undo()
    want = dict(_flat(jax.tree.map(np.asarray, state.params)))
    start = dict(_flat(s["params"]))
    moved = 0
    for name, p in trainer.model.named_parameters():
        path = flax_path(name)
        g = _flax(name, p)
        assert rel_err(g, want[path]) <= 1e-4, name
        if trainer.trainable[name]:
            moved += bool(np.abs(want[path] - start[path]).max() > 0)
        else:
            np.testing.assert_array_equal(g, start[path])
    assert moved > 0
    want_bs = dict(_flat(jax.tree.map(np.asarray, state.batch_stats)))
    got_bs = dict(_flat(batch_stats_to_flax(trainer.model)))
    assert set(got_bs) == set(want_bs)
    for k, v in want_bs.items():
        assert rel_err(got_bs[k], v) <= CONT, k
    assert any(isinstance(m, SyncBN) for m in
               trainer.model.backbone.stage3_unit1.modules())


# ------------------------------------------------------------- test path


TEST_FORMS = {"trident": {}, "fast": dict(num_branch=1, dilations=(2,),
                                          scaleaware=False)}


@pytest.fixture(scope="module")
def test_setup():
    """The three-branch model's params with the rpn_cls kernel scaled by
    30, so that the proposals' scores stand apart (no top-k or NMS
    near-tie), and running statistics."""
    s = make_setup("trident_syncbn")
    rpn = s["params"]["rpn_module"]
    rpn["rpn_cls"]["kernel"] = rpn["rpn_cls"]["kernel"] * 30
    return s


@pytest.fixture(scope="module", params=list(TEST_FORMS))
def test_outputs(request, test_setup):
    s, kw = test_setup, TEST_FORMS[request.param]
    jmodel, _ = jax_model(s["kind"], s["p"], **kw)
    im_info = jnp.asarray(s["im_info"])
    data = j_normalize(jnp.asarray(s["data"]), im_info, MEAN, STD)
    mp = pytest.MonkeyPatch()
    mp.setenv("SIMPLEDET_ROI_ALIGN", "crop")
    try:
        want = jax.tree.map(np.asarray, jax.jit(lambda p, x: {
            mode: jmodel.apply(_variables(s, p), x, im_info, mode=mode)
            for mode in ("test", "rpn_test")})(s["params"], data))
    finally:
        mp.undo()
    model = torch_model(s, train=False, **kw)
    tdata = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    got = {mode: model(tdata, _t(s["im_info"]), mode=mode)
           for mode in ("test", "rpn_test")}
    return request.param, want, got, model


def test_test_forward_matches(test_outputs):
    """cls_score and bbox_xyxy [B, nb * R, ...] within 1e-4 of their scale:
    the branch-range score filter (some scores zeroed, three branches) and
    the fold (each image's branch-0 rows first); the fast form runs one
    branch at dilation 2 without ranges."""
    form, want, got, model = test_outputs
    nb = model.num_branch
    out = got["test"]
    assert out["cls_score"].shape == (B, nb * 48, NUM_CLASS)
    assert out["bbox_xyxy"].shape == (B, nb * 48, 4 * NUM_CLASS)
    for k in ("cls_score", "bbox_xyxy"):
        assert rel_err(out[k].numpy(), want["test"][k]) <= DET_RTOL, k
    zeroed = (out["cls_score"].sum(-1) == 0).sum().item()
    assert (zeroed > 0) == (form == "trident")
    assert model.backbone.dilations == ((1, 2, 3) if form == "trident"
                                        else (2,))


def test_rpn_test_mode_matches(test_outputs):
    """rpn_test gives the folded proposals [nb * B, 48]: boxes and scores
    within 1e-4 of their scale."""
    _, want, got, model = test_outputs
    out = got["rpn_test"]
    assert out["proposal"].shape == (model.num_branch * B, 48, 4)
    for k in ("proposal", "proposal_score"):
        assert rel_err(out[k].numpy(), want["rpn_test"][k]) <= DET_RTOL, k


def test_per_class_nms_on_trident_outputs(test_outputs):
    """The per-class NMS on the port's folded outputs against the JAX
    package's on its own: boxes and scores within 1e-4 of their scale,
    classes and valid rows equal."""
    from simpledet_tpu.eval.postprocess import per_class_nms as j_nms
    from simpledet_torch.eval.postprocess import per_class_nms

    _, want, got, _ = test_outputs
    out = per_class_nms(got["test"]["cls_score"], got["test"]["bbox_xyxy"],
                        score_thr=0.05, nms_thr=0.5, max_det=20)
    ref = jax.vmap(lambda c, b: j_nms(c, b, score_thr=0.05, nms_thr=0.5,
                                      max_det=20))(
        jnp.asarray(want["test"]["cls_score"]),
        jnp.asarray(want["test"]["bbox_xyxy"]))
    ref = [np.asarray(r) for r in ref]
    np.testing.assert_array_equal(out[3].numpy(), ref[3])
    np.testing.assert_array_equal(out[2].numpy(), ref[2])
    assert out[3].sum() > 0
    for g, w in zip(out[:2], ref[:2]):
        assert rel_err(g.numpy(), w) <= DET_RTOL
