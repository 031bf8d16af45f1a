"""The port's Mask R-CNN against the JAX package, on the CPU.

A small Mask R-CNN (depth-18 bottleneck ResNet, FPN filters 64, 4 classes,
128 x 160 images, batch 2, pre/post NMS 256/128, image_roi 64 of which the
first 16 feed the mask branch, mask RoIAlign 14 x 14, mask head width 32,
28 x 28 targets) is built on both sides with the same Flax params, mapped by
`weights.from_flax`. Each gt box carries polygons (its inscribed ellipse;
one instance two overlapping segments, one a rectangle), packed into the
edge tensor as EncodeGtPoly packs them.

Training runs on `arange` priorities (the JAX package's `_priorities`
patched to its deterministic branch; the port's `deterministic_sampling`)
and samples `deterministic_proposals` of the gt on both sides (the JAX RPN
helper's train proposals patched; the port's `fixed_proposals`), so both
sides sample the same rois, and so rasterize the same mask targets. The JAX
side runs the crop RoIAlign, as the other parity tests do.

Tolerances: fp32 convolutions and matrix products summed in other orders
(XLA's and oneDNN's): continuous outputs and losses within 1e-5 of their
scale, each gradient within 1e-4 of its own max |grad|, a 3-step trajectory
within 1e-4 (test_torch_train.py's bounds); mask targets exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn

from simpledet_tpu.data.mask_transforms import polys_to_edges
from simpledet_tpu.models import fpn as jfpn
from simpledet_tpu.models import heads as jheads
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models.faster_rcnn import (
    deterministic_proposals as j_fixed_proposals)
from simpledet_tpu.models.mask_rcnn import MaskFasterRcnn as JMaskFasterRcnn
from simpledet_tpu.models.mask_rcnn import MaskHead4Conv as JMaskHead4Conv
from simpledet_tpu.models.norm import normalizer_factory
from simpledet_tpu.models.rpn import FPNRpnHead as JRpnHead
from simpledet_tpu.ops.image import device_normalize as j_normalize
from simpledet_tpu.targets import sampling as jsampling
from simpledet_torch.core.config import patch_config_as_nothrow
from simpledet_torch.models.fpn import FPNNeck
from simpledet_torch.models.heads import Bbox2fcHead
from simpledet_torch.models.mask_rcnn import MaskFasterRcnn, MaskHead4Conv
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.rpn import FPNRpnHead, RpnConvHead
from simpledet_torch.ops.image import device_normalize
from simpledet_torch.weights import convert_leaf, flax_path, from_flax

MEAN, STD = (122.7717, 115.9465, 102.9801), (1.0, 1.0, 1.0)
FILTERS, NUM_CLASS, B, H, W = 64, 4, 2, 128, 160
DIM, MASK, NUM_FG = 32, 28, 16
SEED_KEY = jax.random.PRNGKey(3)
# the images' seed: with seed 0, one of the 401408 tie codes of the box
# RoIAlign (a bin whose two samples differ by less than the pyramids' float32
# differences) took another sample on each side, and the backbone's
# gradients then differed by 2.8e-3 of their max; `test_no_bin_max_flips`
# holds this seed's premise
SEED = 2
FIXED = ("conv0", "stage1", "scale", "bias")
CONT = 1e-5
GRAD_RTOL = 1e-4


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _flax_layout(name, g):
    """A torch gradient or weight in its Flax leaf's layout."""
    from simpledet_torch.weights import flax_leaf
    return flax_leaf(name, np.asarray(g))


def params_classes():
    class RpnParam:
        class anchor_generate:
            scale = (8,)
            ratio = (0.5, 1.0, 2.0)
            stride = (4, 8, 16, 32, 64)

        class anchor_assign:
            allowed_border = 0
            pos_thr = 0.7
            neg_thr = 0.3
            min_pos_thr = 0.0
            image_anchor = 256
            pos_fraction = 0.5

        class head:
            conv_channel = FILTERS

        class proposal:
            pre_nms_top_n = 256
            post_nms_top_n = 128
            nms_thr = 0.7
            min_bbox_side = 0

        class subsample_proposal:
            proposal_wo_gt = False
            image_roi = 64
            fg_fraction = 0.25
            fg_thr = 0.5
            bg_thr_hi = 0.5
            bg_thr_lo = 0.0

        class bbox_target:
            num_reg_class = NUM_CLASS
            class_agnostic = False
            weight = (1.0, 1.0, 1.0, 1.0)
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    class RoiParam:
        out_size = 7
        stride = (4, 8, 16, 32)
        roi_canonical_scale = 224
        roi_canonical_level = 4

    class MaskRoiParam(RoiParam):
        out_size = 14

    class BboxParam:
        num_class = NUM_CLASS

        class regress_target:
            class_agnostic = False
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    class MaskParam:
        resolution = MASK
        dim_reduced = DIM

    class TestParam:
        min_det_score = 0.05
        max_det_per_image = 20

        class nms:
            thr = 0.5

    return tuple(patch_config_as_nothrow(p) for p in (
        RpnParam, RoiParam, BboxParam, MaskParam, MaskRoiParam, TestParam))


def ellipse(x1, y1, x2, y2, n=16):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, \
        (y2 - y1) / 2
    return np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)],
                    1).astype(np.float32).reshape(-1)


def gt_and_polys():
    """gt_bbox [B, 8, 5] and gt_poly [B, 8, 40, 5]: ellipses in the boxes,
    instance (0, 1) two overlapping rectangles, instance (1, 1) one."""
    gt = np.full((B, 8, 5), -1, np.float32)
    gt[0, :3] = [[10, 12, 60, 70, 1], [50, 20, 120, 90, 3],
                 [5, 60, 40, 120, 2]]
    gt[1, :2] = [[20, 10, 90, 60, 2], [70, 40, 150, 100, 1]]
    polys = {(b, i): [ellipse(*gt[b, i, :4])] for b in range(B)
             for i in range(8) if gt[b, i, 4] >= 0}
    polys[0, 1] = [np.float32([50, 20, 100, 20, 100, 70, 50, 70]),
                   np.float32([70, 40, 120, 40, 120, 90, 70, 90])]
    polys[1, 1] = [np.float32([70, 40, 150, 40, 150, 100, 70, 100])]
    edges = np.full((B, 8, 40, 5), -1, np.float32)
    for (b, i), p in polys.items():
        edges[b, i] = polys_to_edges(p, 40)
    return gt, edges


def torch_model(params, p, train=True):
    p_rpn, p_roi, p_bbox, p_mask, p_mask_roi, p_test = p
    backbone = ResNet(18)
    trpn = FPNRpnHead(p_rpn)
    model = MaskFasterRcnn(
        backbone, FPNNeck(backbone.out_channels, FILTERS),
        RpnConvHead(trpn.num_anchor, FILTERS, FILTERS), trpn,
        Bbox2fcHead(NUM_CLASS, NUM_CLASS, 49 * FILTERS),
        MaskHead4Conv(NUM_CLASS, FILTERS, DIM), p_roi, p_bbox, p_mask,
        p_mask_roi, p_test, fixed_proposals=train,
        deterministic_sampling=train)
    from_flax(params, model)
    return model.to(memory_format=torch.channels_last).train(train)


@pytest.fixture(scope="module")
def setup():
    p = params_classes()
    p_rpn, p_roi, p_bbox, p_mask, p_mask_roi, p_test = p
    p_rpn.dtype = jnp.float32
    jrpn = JRpnHead(p_rpn)
    jmodel = JMaskFasterRcnn(
        backbone=jresnet.ResNet(depth=18, norm=normalizer_factory("fixbn"),
                                name="backbone"),
        neck=jfpn.FPNNeck(filters=FILTERS, name="neck"),
        rpn_module=jrpn.module, rpn=jrpn,
        bbox_head=jheads.Bbox2fcHead(num_class=NUM_CLASS,
                                     num_reg_class=NUM_CLASS,
                                     name="bbox_head"),
        p_rpn=p_rpn, p_roi=p_roi, p_bbox=p_bbox,
        mask_head=JMaskHead4Conv(num_class=NUM_CLASS, dim_reduced=DIM,
                                 name="mask_head"),
        p_mask=p_mask, p_mask_roi=p_mask_roi, p_test=p_test)
    rng = np.random.RandomState(SEED)
    data = rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8)
    im_info = np.float32([[H, W, 1.0], [112, 150, 1.0]])
    gt, gt_poly = gt_and_polys()
    params = jax.jit(lambda r, x, i: jmodel.init(r, x, i, mode="test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros((B, H, W, 3)), jnp.asarray(im_info))["params"]
    params = jax.tree.map(np.asarray, params)
    # FrozenBN starts as the identity; random folded stats keep activations
    # of order one through the depth
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
                         if path[-1].key == "scale" else
                         rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
                         if path[-1].key == "bias" and v.ndim == 1
                         and "bn" in path[-2].key else v), params)
    # MSRA fan-out init of a 4-class 1x1 logit conv gives logits of tens:
    # probabilities pinned at 0 or 1, where the float32 ulps of the logits
    # decide the last digits; scaled, they spread over (0, 1)
    params["mask_head"]["mask_fcn_logit"]["kernel"] = \
        params["mask_head"]["mask_fcn_logit"]["kernel"] * 0.05
    # the test path's: the class logits scaled so that the scores spread far
    # apart (no near-tie for the NMS to break differently); in training the
    # softmax would saturate and the ulps of the logits decide its gradient
    test_params = jax.tree.map(lambda v: v, params)
    test_params["bbox_head"]["cls_logit"]["kernel"] = \
        params["bbox_head"]["cls_logit"]["kernel"] * 100.0
    return dict(jmodel=jmodel, jrpn=jrpn, params=params,
                test_params=test_params, data=data, im_info=im_info, gt=gt,
                gt_poly=gt_poly, p=p)


@pytest.fixture(scope="module")
def jax_side(setup):
    """While the JAX package's functions are traced: arange priorities, the
    crop RoIAlign, and train proposals from the gt (the JAX Mask R-CNN has
    no fixed_proposals hook of its own)."""
    jrpn, gt = setup["jrpn"], jnp.asarray(setup["gt"])
    real = jrpn.proposals

    def proposals(level_outputs, im_info, pad_hw, is_train):
        boxes, scores = real(level_outputs, im_info, pad_hw, is_train)
        if is_train:
            boxes = j_fixed_proposals(gt, boxes.shape[1])
        return boxes, scores

    mp = pytest.MonkeyPatch()
    mp.setenv("SIMPLEDET_ROI_ALIGN", "crop")
    mp.setattr(jsampling, "_priorities",
               lambda rng, n, deterministic: jnp.arange(n, dtype=jnp.float32))
    mp.setattr(jrpn, "proposals", proposals)
    yield
    mp.undo()


def _normalised(s):
    return j_normalize(jnp.asarray(s["data"]), jnp.asarray(s["im_info"]),
                       MEAN, STD)


# ------------------------------------------------------------- mask head


def test_mask_head_matches_flax():
    """MaskHead4Conv on converted weights: logits within 1e-5 of their
    scale, and the gradients of its parameters and its input against
    jax.grad within 1e-4 of their max."""
    rng = np.random.RandomState(1)
    feat = rng.randn(2, 5, 14, 14, FILTERS).astype(np.float32)
    jhead = JMaskHead4Conv(num_class=NUM_CLASS, dim_reduced=DIM)
    params = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(4),
                                                 jnp.asarray(feat))["params"])
    sel = rng.randn(2, 5, MASK, MASK, NUM_CLASS).astype(np.float32)

    def loss(p, x):
        out = jhead.apply({"params": p}, x)
        return (out * sel).sum(), out

    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        params, jnp.asarray(feat))
    head = MaskHead4Conv(NUM_CLASS, FILTERS, DIM)
    from_flax(params, head)
    x = _t(feat).requires_grad_()
    out = head(x)
    assert out.shape == (2, 5, MASK, MASK, NUM_CLASS)
    assert rel_err(out.detach(), want) <= CONT
    (out * _t(sel)).sum().backward()
    assert rel_err(x.grad, gx) <= GRAD_RTOL
    flat = dict(_flat(jax.tree.map(np.asarray, gp)))
    for name, prm in head.named_parameters():
        assert rel_err(_flax_layout(name, prm.grad), flat[flax_path(name)]) \
            <= GRAD_RTOL, name


def test_transposed_conv_weight_is_flipped():
    """mask_up (a Flax nn.ConvTranspose with as many inputs as outputs) on
    an asymmetric kernel: the converted layer equals Flax's within 1e-5,
    its torch weight is the kernel flipped in both spatial axes, the
    unflipped kernel (the plain conv rule) gives another function, and the
    weight converts back to the same Flax kernel."""
    from simpledet_torch.weights import flax_leaf

    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 6, 8).astype(np.float32)
    layer = fnn.ConvTranspose(8, (2, 2), strides=(2, 2))
    k = rng.randn(2, 2, 8, 8).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    want = np.asarray(layer.apply({"params": {"kernel": k, "bias": bias}},
                                  jnp.asarray(x)))
    name, w = convert_leaf(("mask_head", "mask_up", "kernel"), k)
    assert name == "mask_head.mask_up.weight"
    np.testing.assert_array_equal(w.numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))

    def apply(weight):
        return torch.nn.functional.conv_transpose2d(
            _t(x).permute(0, 3, 1, 2), weight, _t(bias),
            stride=2).permute(0, 2, 3, 1).numpy()

    assert rel_err(apply(w), want) <= CONT
    unflipped = _t(np.ascontiguousarray(k.transpose(2, 3, 0, 1)))
    assert rel_err(apply(unflipped), want) > 0.1
    np.testing.assert_array_equal(flax_leaf(name, w.numpy()), k)


# ------------------------------------------------------------ train step


@pytest.fixture(scope="module")
def jax_grads(setup, jax_side):
    s = setup
    data = _normalised(s)

    def loss_fn(params):
        losses, aux = s["jmodel"].apply(
            {"params": params}, data, jnp.asarray(s["im_info"]),
            jnp.asarray(s["gt"]), jnp.asarray(s["gt_poly"]), mode="train",
            rngs={"sampling": SEED_KEY})
        return sum(losses.values()), (losses, aux)

    (_, (losses, aux)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(s["params"])
    return (jax.tree.map(np.asarray, losses), jax.tree.map(np.asarray, aux),
            jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def torch_step(setup):
    s = setup
    model = torch_model(s["params"], s["p"])
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    losses, aux = model(data, _t(s["im_info"]), _t(s["gt"]),
                        _t(s["gt_poly"]), mode="train",
                        generator=torch.Generator())
    sum(losses.values()).backward()
    return model, losses, aux


def test_train_losses_labels_and_mask_targets_match(jax_grads, torch_step):
    """The five losses within 1e-5 relative; the sampled labels and the mask
    targets of the fg prefix identical, with fg rows on both images and
    both 0 and 1 cells among them (the -1 rows: test_torch_mask_data.py)."""
    want, want_aux, _ = jax_grads
    _, losses, aux = torch_step
    assert set(losses) == set(want) == {"rpn_cls_loss", "rpn_reg_loss",
                                        "bbox_cls_loss", "bbox_reg_loss",
                                        "mask_loss"}
    for k, v in want.items():
        assert rel_err(losses[k].detach(), v) <= CONT, k
    np.testing.assert_array_equal(aux["bbox_label"].numpy(),
                                  want_aux["bbox_label"])
    target = aux["mask_target"].numpy()
    assert target.shape == (B, NUM_FG, MASK, MASK)
    np.testing.assert_array_equal(target, want_aux["mask_target"])
    fg_rows = (target >= 0).all((2, 3))
    assert fg_rows.any(1).all()
    assert (target[fg_rows] == 1).any() and (target[fg_rows] == 0).any()


def test_no_bin_max_flips(setup, jax_test):
    """The premise of the gradient tests: on the rois the port samples, each
    bin's max is taken at the same samples from the JAX pyramid as from the
    port's (box RoIAlign at 7 x 7, mask RoIAlign at 14 x 14)."""
    from simpledet_torch.kernels.roi_align import multilevel_roi_align_plain

    s = setup
    model = torch_model(s["params"], s["p"])
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    with torch.no_grad():
        pyr, sample, _, _ = model.box_branch(data, _t(s["im_info"]),
                                             _t(s["gt"]), torch.Generator())
    strides = (4, 8, 16, 32)
    port = [pyr[f"stride{k}"].permute(0, 2, 3, 1).contiguous()
            for k in strides]
    jax_pyr = [_t(jax_test[2][f"stride{k}"]) for k in strides]
    for rois, p in ((sample["rois"], 7),
                    (sample["rois"][:, :NUM_FG].contiguous(), 14)):
        codes = [multilevel_roi_align_plain(f, rois, strides, out_size=p,
                                            with_codes=True)[1]
                 for f in (port, jax_pyr)]
        assert torch.equal(*codes), p


def test_every_gradient_matches_jax_grad(jax_grads, torch_step):
    """Each parameter's gradient, the mask head's among them, within 1e-4 of
    its own max |grad| of jax.grad."""
    _, _, grads = jax_grads
    model = torch_step[0]
    want = dict(_flat(grads))
    errs = {name: rel_err(_flax_layout(name, p.grad), want[flax_path(name)])
            for name, p in model.named_parameters()}
    assert len(errs) == sum(1 for k in want if not k.endswith("scale")
                            and "bn" not in k.split("/")[-2])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    assert np.abs(want["mask_head/mask_up/kernel"]).max() > 0


def test_sgd_trajectory_matches(setup, jax_side):
    """Three steps of Trainer against make_train_step (sgd, momentum 0.9,
    wd 1e-4, gradual warmup, frozen conv0/stage1/scale/bias), gt_poly in the
    batch: the losses within 1e-4 each step, every parameter within 1e-4 of
    its scale after the third and its update within 1e-3."""
    from simpledet_tpu.core.optimizer import freeze_mask as j_freeze_mask
    from simpledet_tpu.core.optimizer import make_optimizer as j_make_opt
    from simpledet_tpu.core.schedule import warmup_multifactor as j_warmup
    from simpledet_tpu.core.train import TrainState, make_train_step
    from simpledet_torch.core.schedule import warmup_multifactor
    from simpledet_torch.core.train import Trainer

    s = setup
    sched_args = dict(warmup_lr=0.02 / 3, warmup_iter=500)
    tx = j_make_opt(j_warmup(0.02, [60000, 80000], **sched_args),
                    momentum=0.9, wd=1e-4,
                    trainable_mask=j_freeze_mask(s["params"], FIXED))
    state = TrainState.create(apply_fn=s["jmodel"].apply,
                              params=s["params"], tx=tx)
    step = make_train_step(s["jmodel"], donate=False, pixel_norm=(MEAN, STD))
    batch = {"data": jnp.asarray(s["data"]),
             "im_info": jnp.asarray(s["im_info"]),
             "gt_bbox": jnp.asarray(s["gt"]),
             "gt_poly": jnp.asarray(s["gt_poly"])}
    trainer = Trainer(torch_model(s["params"], s["p"]),
                      schedule=warmup_multifactor(0.02, [60000, 80000],
                                                  **sched_args),
                      fixed_param=FIXED, momentum=0.9, wd=1e-4,
                      pixel_norm=(MEAN, STD))
    for i in range(3):
        state, jl, _ = step(state, batch, jax.random.fold_in(SEED_KEY, i))
        tl = trainer.step(_t(s["data"]), _t(s["im_info"]), _t(s["gt"]),
                          _t(s["gt_poly"]))
        assert rel_err(tl["total_loss"], jl["total_loss"]) <= 1e-4, i
        assert rel_err(tl["mask_loss"], jl["mask_loss"]) <= 1e-4, i
    want = dict(_flat(jax.tree.map(np.asarray, state.params)))
    start = dict(_flat(s["params"]))
    worst = 0.0
    for name, t in trainer.model.state_dict().items():
        path = flax_path(name)
        g = _flax_layout(name, t)
        assert rel_err(g, want[path]) <= 1e-4, name
        moved = want[path] - start[path]
        if trainer.trainable[name]:
            assert np.abs(moved).max() > 0, name
            worst = max(worst, rel_err(g - start[path], moved))
        else:
            np.testing.assert_array_equal(g, start[path])
    assert worst <= 1e-3, worst


# --------------------------------------------------------------- test path


@pytest.fixture(scope="module")
def jax_test(setup):
    """The JAX package's test and rpn_test outputs, its pyramid (crop
    RoIAlign)."""
    s, jmodel = setup, setup["jmodel"]
    im_info = jnp.asarray(s["im_info"])
    mp = pytest.MonkeyPatch()
    mp.setenv("SIMPLEDET_ROI_ALIGN", "crop")
    try:
        data = _normalised(s)
        full = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, im_info,
                                                 mode="test"))(
            s["test_params"], data)
        rpn = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, im_info,
                                                mode="rpn_test"))(
            s["test_params"], data)
        pyr = jax.jit(lambda p, x: jmodel.apply(
            {"params": p}, x, method=lambda m, d: m.pyramid(d)))(
            s["test_params"], data)
    finally:
        mp.undo()
    return (jax.tree.map(np.asarray, full), jax.tree.map(np.asarray, rpn),
            jax.tree.map(np.asarray, pyr))


@pytest.fixture(scope="module")
def torch_test(setup):
    s = setup
    model = torch_model(s["test_params"], s["p"], train=False)
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    return (model(data, _t(s["im_info"]), mode="test"),
            model(data, _t(s["im_info"]), mode="rpn_test"), model)


def test_test_forward_end_to_end(jax_test, torch_test):
    """One mode="test" forward: the same kept detections and classes, their
    boxes, scores and mask probabilities within 1e-5 of their scale; some
    detections kept on each image."""
    full, out = jax_test[0], torch_test[0]
    assert set(out) == set(full) == {"cls_score", "bbox_xyxy", "cls",
                                     "det_valid", "mask_prob"}
    assert out["mask_prob"].shape == (B, 20, MASK, MASK)
    np.testing.assert_array_equal(out["det_valid"].numpy(),
                                  full["det_valid"])
    np.testing.assert_array_equal(out["cls"].numpy(), full["cls"])
    for key in ("cls_score", "bbox_xyxy", "mask_prob"):
        assert rel_err(out[key].numpy(), full[key]) <= CONT, key
    assert full["det_valid"].any(1).all()
    probs = full["mask_prob"][full["det_valid"]]
    assert probs.min() < 0.4 and probs.max() > 0.6


def test_mask_branch_teacher_forced(jax_test, torch_test):
    """The JAX pyramid, kept boxes and classes into the port's mask RoIAlign
    and mask head: the JAX mask probabilities within 1e-5."""
    full, _, pyr = jax_test
    model = torch_test[2]
    tpyr = {k: _t(v).permute(0, 3, 1, 2) for k, v in pyr.items()}
    with torch.no_grad():
        feat = model.extract_mask_rois(tpyr, _t(full["bbox_xyxy"]))
        probs = model.mask_probs(feat, _t(full["cls"]))
    assert feat.shape[2:4] == (14, 14)
    assert rel_err(probs.numpy(), full["mask_prob"]) <= CONT


def test_rpn_test_mode(jax_test, torch_test):
    want, got = jax_test[1], torch_test[1]
    assert set(got) == set(want) == {"proposal", "proposal_score"}
    for key in want:
        assert rel_err(got[key].numpy(), want[key]) <= CONT, key


# ------------------------------------------------------------- checkpoints


def test_mask_params_cross_both_ways_bit_for_bit(setup, tmp_path):
    """The Mask R-CNN's .params, written by the port, is the file the JAX
    package writes for the same tree (mask_up's kernel flipped back); a
    JAX-written file loads into the port leaf for leaf."""
    from simpledet_tpu.core import checkpoint as jckpt
    from simpledet_torch.core import checkpoint as ckpt

    params = setup["params"]
    model = torch_model(params, setup["p"], train=False)
    ckpt.save_checkpoint(str(tmp_path / "port"), 1, model)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, params)
    assert (tmp_path / "port-0001.params").read_bytes() == \
        (tmp_path / "jax-0001.params").read_bytes()
    other = torch_model(jax.tree.map(np.zeros_like, params), setup["p"],
                        train=False)
    ckpt.load_checkpoint(str(tmp_path / "jax"), 1, other)
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    up = other.state_dict()["mask_head.mask_up.weight"].numpy()
    k = params["mask_head"]["mask_up"]["kernel"]
    np.testing.assert_array_equal(up, k[::-1, ::-1].transpose(2, 3, 0, 1))
    assert not np.array_equal(up, k.transpose(2, 3, 0, 1))
