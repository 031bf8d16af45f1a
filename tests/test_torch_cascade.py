"""The port's Cascade R-CNN against the JAX package, on the CPU.

A small cascade (depth-18 bottleneck ResNet, FPN filters 64, 5 classes,
96 x 128 images, batch 2, pre/post NMS 256/128, image_roi 64) is built on
both sides with the same Flax params, mapped by `weights.from_flax`. Its
stages sample with parameters that differ from stage to stage (fg_thr 0.5 /
0.6 / 0.7, image_roi 64 / 48 / 32, target stds tightening), so that a stage
that samples with the wrong stage's parameters is caught; stage 2's
regress_target leaves class_agnostic unset (None reads as True).

Training runs on `arange` priorities (the JAX package's `_priorities`
patched to its deterministic branch; the port's `deterministic_sampling`),
and stage 1 samples `deterministic_proposals` of the gt on both sides (the
JAX RPN helper's train proposals patched; the port's `fixed_proposals`).
Stages 2 and 3 sample the boxes that the previous stage's own deltas decode
to. Each stage is held teacher-forced (the JAX stage's proposals into the
port's sampler, the JAX stage's features into the port's head), then the
whole step end to end. The JAX side runs the crop RoIAlign, as the other
parity tests do.

The box heads keep Flax's init (regression weights of std 0.001), under which
each stage moves its boxes by pixels. Each stage's float32 differences move
the next stage's rois, and the features' sensitivity to position amplifies
them: with the regression weights scaled by 30, stage 3's outputs differed
by 6.5e-5 of their scale and head_2nd's fc1 gradient by 2.1e-3 of its max
(measured), on both sides' own arithmetic.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledet_tpu.models import fpn as jfpn
from simpledet_tpu.models import heads as jheads
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models.cascade_rcnn import CascadeRcnn as JCascadeRcnn
from simpledet_tpu.models.cascade_rcnn import decode_refined as j_decode
from simpledet_tpu.models.faster_rcnn import (
    deterministic_proposals as j_fixed_proposals)
from simpledet_tpu.models.norm import normalizer_factory
from simpledet_tpu.models.rpn import FPNRpnHead as JRpnHead
from simpledet_tpu.ops.image import device_normalize as j_normalize
from simpledet_tpu.targets import sampling as jsampling
from simpledet_torch.core.config import patch_config_as_nothrow
from simpledet_torch.models.cascade_rcnn import CascadeRcnn, decode_refined
from simpledet_torch.models.fpn import FPNNeck
from simpledet_torch.models.heads import Bbox2fcHead, bbox_head_loss
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.rpn import FPNRpnHead, RpnConvHead
from simpledet_torch.ops.image import device_normalize
from simpledet_torch.weights import flax_path, from_flax

MEAN, STD = (122.7717, 115.9465, 102.9801), (1.0, 1.0, 1.0)
FILTERS, NUM_CLASS, B, H, W = 64, 5, 2, 96, 128
SEED_KEY = jax.random.PRNGKey(3)
STAGES = ("1st", "2nd", "3rd")
FIXED = ("conv0", "stage1", "scale", "bias")

# fp32 convs and matmuls summed in other orders (XLA's and oneDNN's): the
# continuous outputs and the losses within 1e-5 of their scale, each
# gradient within 1e-4 of its own max |grad| (test_torch_train.py's bounds).
CONT = 1e-5
GRAD_RTOL = 1e-4


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _torch_layout(g):
    """A torch gradient in its Flax leaf's layout."""
    g = np.asarray(g)
    if g.ndim == 4:
        return g.transpose(2, 3, 1, 0)
    return g.T if g.ndim == 2 else g


def _sample_cls(image_roi, fg_thr):
    return type("subsample_proposal", (), dict(
        proposal_wo_gt=False, image_roi=image_roi, fg_fraction=0.25,
        fg_thr=fg_thr, bg_thr_hi=fg_thr, bg_thr_lo=0.0))


def _target_cls(std):
    return type("bbox_target", (), dict(
        num_reg_class=2, class_agnostic=True, weight=(1.0, 1.0, 1.0, 1.0),
        mean=(0.0, 0.0, 0.0, 0.0), std=std))


def _stage_cls(stage, loss_weight, reg_std, agnostic, sample=None,
               target=None):
    attrs = dict(num_class=NUM_CLASS, stage=stage, loss_weight=loss_weight,
                 regress_target=type("regress_target", (), dict(
                     class_agnostic=agnostic, mean=(0.0, 0.0, 0.0, 0.0),
                     std=reg_std)))
    if sample is not None:
        attrs.update(subsample_proposal=sample, bbox_target=target)
    return type(f"BboxParam{stage}", (), attrs)


STD1, STD2, STD3 = (0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1), \
    (0.033, 0.033, 0.067, 0.067)


def params_classes():
    """(RpnParam, RoiParam, (BboxParam 1st, 2nd, 3rd)), nothrow-patched, laid
    out as config/cascade_r50v1_fpn_1x.py lays them out: stage k + 1's
    sampling under stage k's class."""
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

        subsample_proposal = _sample_cls(64, 0.5)
        bbox_target = _target_cls(STD1)

    class RoiParam:
        out_size = 7
        stride = (4, 8, 16, 32)
        roi_canonical_scale = 224
        roi_canonical_level = 4

    stages = (_stage_cls("1st", 1.0, STD1, True, _sample_cls(48, 0.6),
                         _target_cls(STD2)),
              _stage_cls("2nd", 0.5, STD2, None, _sample_cls(32, 0.7),
                         _target_cls(STD3)),
              _stage_cls("3rd", 0.25, STD3, True))
    return (patch_config_as_nothrow(RpnParam),
            patch_config_as_nothrow(RoiParam),
            tuple(patch_config_as_nothrow(p) for p in stages))


def torch_model(params, p_rpn, p_roi, p_bboxes, train=True):
    backbone = ResNet(18)
    trpn = FPNRpnHead(p_rpn)
    heads = [Bbox2fcHead(NUM_CLASS, 2, 49 * FILTERS) for _ in STAGES]
    model = CascadeRcnn(backbone, FPNNeck(backbone.out_channels, FILTERS),
                        RpnConvHead(trpn.num_anchor, FILTERS, FILTERS), trpn,
                        heads, p_roi, p_bboxes, fixed_proposals=train,
                        deterministic_sampling=train)
    from_flax(params, model)
    return model.to(memory_format=torch.channels_last).train(train)


@pytest.fixture(scope="module")
def setup():
    p_rpn, p_roi, p_bboxes = params_classes()
    p_rpn.dtype = jnp.float32
    jrpn = JRpnHead(p_rpn)
    jmodel = JCascadeRcnn(
        backbone=jresnet.ResNet(depth=18, norm=normalizer_factory("fixbn"),
                                name="backbone"),
        neck=jfpn.FPNNeck(filters=FILTERS, name="neck"),
        rpn_module=jrpn.module, rpn=jrpn,
        head_1st=jheads.Bbox2fcHead(num_class=NUM_CLASS, num_reg_class=2,
                                    name="bbox_head_1st"),
        head_2nd=jheads.Bbox2fcHead(num_class=NUM_CLASS, num_reg_class=2,
                                    name="bbox_head_2nd"),
        head_3rd=jheads.Bbox2fcHead(num_class=NUM_CLASS, num_reg_class=2,
                                    name="bbox_head_3rd"),
        p_rpn=p_rpn, p_roi=p_roi, p_bboxes=p_bboxes)
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8)
    im_info = np.float32([[H, W, 1.0], [80, 100, 1.0]])
    gt = np.full((B, 8, 5), -1, np.float32)
    gt[0, :3] = [[10, 12, 60, 70, 1], [50, 20, 120, 90, 3], [5, 40, 40, 94, 4]]
    gt[1, :2] = [[20, 10, 90, 60, 2], [0, 30, 50, 79, 1]]
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
    return dict(jmodel=jmodel, jrpn=jrpn, params=params, data=data,
                im_info=im_info, gt=gt, p=(p_rpn, p_roi, p_bboxes))


@pytest.fixture(scope="module")
def jax_side(setup):
    """While the JAX package's functions are traced: arange priorities, the
    crop RoIAlign, and stage 1's train proposals from the gt (the JAX
    Cascade R-CNN has no fixed_proposals hook of its own)."""
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


def _stage_sampling(jmodel, i):
    """The (subsample_proposal, bbox_target) the JAX model samples stage i
    with (`simpledet_tpu/models/cascade_rcnn.py:101-107`)."""
    p = jmodel.p_rpn if i == 0 else jmodel.p_bboxes[i - 1]
    return p.subsample_proposal, p.bbox_target


@pytest.fixture(scope="module")
def jax_train_stages(setup, jax_side):
    """The JAX train path stage by stage: each stage's proposals, sample,
    roi features, head outputs; the pyramid."""
    s, jmodel = setup, setup["jmodel"]
    im_info = jnp.asarray(s["im_info"])
    gt = jnp.asarray(s["gt"])

    def run(m, data):
        pyr = m.pyramid(data)
        cur = j_fixed_proposals(gt, m.p_rpn.proposal.post_nms_top_n)
        out = []
        for i, head in enumerate(m.heads):
            ps, pt = _stage_sampling(m, i)
            sample = m._sample(SEED_KEY, cur, gt, ps, pt)
            feat = m.extract_rois(pyr, sample["rois"])
            cls, delta = head(feat)
            out.append(dict(proposals=cur, sample=sample, feat=feat, cls=cls,
                            delta=delta))
            rt = m.p_bboxes[i].regress_target
            cur = j_decode(sample["rois"], delta, im_info, mean=rt.mean,
                           std=rt.std,
                           class_agnostic=rt.class_agnostic
                           if rt.class_agnostic is not None else True)
            out[-1]["refined"] = cur
        return pyr, out

    pyr, stages = jax.jit(lambda p, d: jmodel.apply({"params": p}, d,
                                                    method=run))(
        s["params"], _normalised(s))
    return jax.tree.map(np.asarray, pyr), jax.tree.map(np.asarray, stages)


@pytest.fixture(scope="module")
def jax_grads(setup, jax_side):
    s = setup
    data = _normalised(s)

    def loss_fn(params):
        losses, aux = s["jmodel"].apply(
            {"params": params}, data, jnp.asarray(s["im_info"]),
            jnp.asarray(s["gt"]), mode="train", rngs={"sampling": SEED_KEY})
        return sum(losses.values()), (losses, aux)

    (_, (losses, aux)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(s["params"])
    return (jax.tree.map(np.asarray, losses), jax.tree.map(np.asarray, aux),
            jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def torch_step(setup):
    """The port's train-mode forward and backward (nothing frozen)."""
    s = setup
    model = torch_model(s["params"], *s["p"])
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    losses, aux = model(data, _t(s["im_info"]), _t(s["gt"]), mode="train",
                        generator=torch.Generator())
    sum(losses.values()).backward()
    return model, losses, aux


# ------------------------------------------------------------ decode_refined


@pytest.mark.parametrize("class_agnostic", [True, False])
def test_decode_refined_matches_jax(class_agnostic):
    """Random proposals and deltas (some large enough to leave the image
    and to reach the exp clip): decoded with the stage's mean and std, the
    fg columns 4:8 when class-agnostic, clipped to im_info, within 1e-6 of
    the boxes' scale; no gradient, contiguous."""
    rng = np.random.RandomState(7)
    xy = rng.uniform(0, 100, (2, 40, 2))
    props = np.concatenate([xy, xy + rng.uniform(2, 60, (2, 40, 2))],
                           -1).astype(np.float32)
    n_reg = 2 if class_agnostic else NUM_CLASS
    delta = rng.randn(2, 40, 4 * n_reg).astype(np.float32)
    delta[:, :5] *= 40.0
    im_info = np.float32([[96, 128, 1.0], [80, 100, 1.0]])
    kw = dict(mean=(0.01, -0.02, 0.0, 0.03), std=STD2,
              class_agnostic=class_agnostic)
    want = np.asarray(j_decode(jnp.asarray(props), jnp.asarray(delta),
                               jnp.asarray(im_info), **kw))
    d = _t(delta).requires_grad_()
    got = decode_refined(_t(props), d, _t(im_info), **kw)
    assert got.shape == want.shape == (2, 40, 4 if class_agnostic
                                       else 4 * NUM_CLASS)
    assert rel_err(got.numpy(), want) <= 1e-6
    assert not got.requires_grad and got.is_contiguous()
    assert (want[..., 2] <= 127).all() and (want[..., 3] <= 95).any()
    assert (want == 0).any()        # some boxes clipped at the origin


# ------------------------------------------------------ stages teacher-forced


def test_stages_sample_with_the_previous_stages_parameters(setup):
    """Stage 1 samples with RpnParam's subsample_proposal / bbox_target,
    stage k + 1 with stage k's BboxParam's; the third stage's param class
    has none (as in the configs), so a stage that read its own would
    fail."""
    p_rpn, _, p_bboxes = setup["p"]
    model = torch_model(setup["params"], *setup["p"])
    want = [(p_rpn.subsample_proposal, p_rpn.bbox_target),
            (p_bboxes[0].subsample_proposal, p_bboxes[0].bbox_target),
            (p_bboxes[1].subsample_proposal, p_bboxes[1].bbox_target)]
    for i, (ps, pt) in enumerate(want):
        got = model.sampling_params(i)
        assert got[0] is ps and got[1] is pt, i
    assert p_bboxes[2].subsample_proposal is None
    assert [p.image_roi for p, _ in want] == [64, 48, 32]
    assert [p.fg_thr for p, _ in want] == [0.5, 0.6, 0.7]


@pytest.mark.parametrize("i", [0, 1, 2], ids=STAGES)
def test_stage_sample_teacher_forced(setup, jax_train_stages, i):
    """The JAX stage's proposals into the port's sampler: the same rois and
    labels, targets within 1e-6 of their scale, the same weights; every
    stage samples foreground."""
    _, stages = jax_train_stages
    st = stages[i]
    model = torch_model(setup["params"], *setup["p"])
    got = model.sample(torch.Generator(), _t(st["proposals"]),
                       _t(setup["gt"]), i)
    want = st["sample"]
    np.testing.assert_array_equal(got["rois"].numpy(), want["rois"])
    np.testing.assert_array_equal(got["label"].numpy(), want["label"])
    np.testing.assert_array_equal(got["bbox_weight"].numpy(),
                                  want["bbox_weight"])
    assert rel_err(got["bbox_target"].numpy(), want["bbox_target"]) <= 1e-6
    assert got["label"].shape == (B, (64, 48, 32)[i])
    assert (want["label"] > 0).sum() >= 4


@pytest.mark.parametrize("i", [0, 1, 2], ids=STAGES)
def test_stage_features_head_and_refine_teacher_forced(setup,
                                                       jax_train_stages, i):
    """The JAX pyramid and sampled rois into the port's RoIAlign, the JAX
    features into the port's head, the JAX deltas into the port's refine:
    within 1e-5 of each tensor's scale (the refined boxes within 1e-6)."""
    pyr, stages = jax_train_stages
    st = stages[i]
    model = torch_model(setup["params"], *setup["p"])
    feat = model.extract_rois({k: _nchw(v) for k, v in pyr.items()},
                              _t(st["sample"]["rois"]))
    assert rel_err(feat.detach().numpy(), st["feat"]) <= CONT
    with torch.no_grad():
        cls, delta = model.heads[i](_t(st["feat"]))
    assert rel_err(cls.numpy(), st["cls"]) <= CONT
    assert rel_err(delta.numpy(), st["delta"]) <= CONT
    refined = model.refine(_t(st["sample"]["rois"]), _t(st["delta"]),
                           _t(setup["im_info"]), i)
    assert rel_err(refined.numpy(), st["refined"]) <= 1e-6
    # the deltas move the boxes by pixels (measured 53, 2.5 and 1.2): later
    # stages sample other boxes
    assert np.abs(st["refined"] - st["sample"]["rois"]).max() > 1.0


@pytest.mark.parametrize("i", [0, 1, 2], ids=STAGES)
def test_stage_loss_and_gradients_teacher_forced(setup, jax_train_stages, i):
    """A stage's two losses (times its loss_weight, smooth-L1 scalar 1.0) on
    the JAX stage's sample and features: within 1e-5 relative; the gradients
    of its head's parameters and of its roi features against jax.grad,
    within 1e-4 of each one's max |grad|."""
    _, stages = jax_train_stages
    st, s = stages[i], stages[i]["sample"]
    params = setup["params"][f"head_{STAGES[i]}"]
    weight = setup["p"][2][i].loss_weight
    jhead = jheads.Bbox2fcHead(num_class=NUM_CLASS, num_reg_class=2)

    def loss_fn(hp, feat):
        cls, delta = jhead.apply({"params": hp}, feat)
        losses = jheads.bbox_head_loss(cls, delta, s["label"],
                                       s["bbox_target"], s["bbox_weight"])
        losses = {k: weight * v for k, v in losses.items()}
        return sum(losses.values()), losses

    (_, want), (g_params, g_feat) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(st["feat"]))
    model = torch_model(setup["params"], *setup["p"])
    head = model.heads[i]
    feat = _t(st["feat"]).requires_grad_()
    cls, delta = head(feat)
    got = bbox_head_loss(cls, delta, _t(s["label"]), _t(s["bbox_target"]),
                         _t(s["bbox_weight"]))
    got = {k: weight * v for k, v in got.items()}
    sum(got.values()).backward()
    for k in want:
        assert rel_err(got[k].detach(), want[k]) <= CONT, k
    assert rel_err(feat.grad.numpy(), g_feat) <= GRAD_RTOL
    flat = dict(_flat(jax.tree.map(np.asarray, g_params)))
    for name, p in head.named_parameters():
        assert rel_err(_torch_layout(p.grad), flat[flax_path(name)]) \
            <= GRAD_RTOL, name


# --------------------------------------------------------- train end to end


def test_train_losses_and_labels_match(jax_grads, torch_step):
    """The whole train step: the RPN's two losses and the six stage losses
    within 1e-5 relative, and every stage's sampled labels identical (stages
    2 and 3 sample the boxes each side's own deltas decoded to)."""
    want, want_aux, _ = jax_grads
    _, losses, aux = torch_step
    assert set(losses) == set(want) == {
        "rpn_cls_loss", "rpn_reg_loss",
        *(f"bbox_{k}_loss_{s}" for k in ("cls", "reg") for s in STAGES)}
    for k, v in want.items():
        assert rel_err(losses[k].detach(), v) <= CONT, k
    assert set(aux) == set(want_aux)
    for s in STAGES:
        np.testing.assert_array_equal(aux[f"bbox_label_{s}"].numpy(),
                                      want_aux[f"bbox_label_{s}"])
        assert (want_aux[f"bbox_label_{s}"] > 0).any(), s
        # end to end, as test_torch_model.py holds the flagship's outputs:
        # within 1e-4 of their scale (measured 1.1e-5)
        assert rel_err(aux[f"bbox_cls_logit_{s}"].detach(),
                       want_aux[f"bbox_cls_logit_{s}"]) <= 1e-4
    np.testing.assert_array_equal(aux["bbox_label"].numpy(),
                                  want_aux["bbox_label_1st"])
    np.testing.assert_array_equal(aux["rpn_label"].numpy(),
                                  want_aux["rpn_label"])


def test_every_gradient_matches_jax_grad(jax_grads, torch_step):
    """Each parameter's gradient within 1e-4 of its own max |grad| of
    jax.grad; the three heads' gradients differ from one another."""
    _, _, grads = jax_grads
    model = torch_step[0]
    want = dict(_flat(grads))
    errs = {name: rel_err(_torch_layout(p.grad), want[flax_path(name)])
            for name, p in model.named_parameters()}
    assert len(errs) == sum(1 for k in want if not k.endswith("scale")
                            and "bn" not in k.split("/")[-2])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    fc1 = [want[f"head_{s}/fc1/kernel"] for s in STAGES]
    assert all(np.abs(g).max() > 0 for g in fc1)
    assert not np.allclose(fc1[0], fc1[1]) and not np.allclose(fc1[1], fc1[2])


def test_sgd_trajectory_matches(setup, jax_side):
    """Three steps of Trainer against make_train_step with the cascade
    config's optimizer settings (sgd, momentum 0.9, wd 1e-4, gradual warmup,
    frozen conv0/stage1/scale/bias): the bounds of test_torch_train.py."""
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
             "gt_bbox": jnp.asarray(s["gt"])}
    trainer = Trainer(torch_model(s["params"], *s["p"]),
                      schedule=warmup_multifactor(0.02, [60000, 80000],
                                                  **sched_args),
                      fixed_param=FIXED, momentum=0.9, wd=1e-4,
                      pixel_norm=(MEAN, STD))
    for i in range(3):
        state, jl, _ = step(state, batch, jax.random.fold_in(SEED_KEY, i))
        tl = trainer.step(_t(s["data"]), _t(s["im_info"]), _t(s["gt"]))
        assert rel_err(tl["total_loss"], jl["total_loss"]) <= 1e-4, i
    want = dict(_flat(jax.tree.map(np.asarray, state.params)))
    start = dict(_flat(s["params"]))
    worst = 0.0
    for name, t in trainer.model.state_dict().items():
        path = flax_path(name)
        g = _torch_layout(t)
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
    """The JAX package's test and rpn_test outputs, and its stage-3 roi
    features and logits (crop RoIAlign)."""
    s, jmodel = setup, setup["jmodel"]
    im_info = jnp.asarray(s["im_info"])
    mp = pytest.MonkeyPatch()
    mp.setenv("SIMPLEDET_ROI_ALIGN", "crop")
    try:
        data = _normalised(s)
        full = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, im_info,
                                                 mode="test"))(
            s["params"], data)
        rpn = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, im_info,
                                                mode="rpn_test"))(
            s["params"], data)

        def stage3(m, x):
            pyr = m.pyramid(x)
            cur = full["rois"]
            for i, head in enumerate(m.heads):
                feat = m.extract_rois(pyr, cur)
                cls, delta = head(feat)
                rt = m.p_bboxes[i].regress_target
                cur = j_decode(cur, delta, im_info, mean=rt.mean, std=rt.std,
                               class_agnostic=rt.class_agnostic
                               if rt.class_agnostic is not None else True)
            return feat, cls, cur

        feat3 = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                                  method=stage3))(
            s["params"], data)
    finally:
        mp.undo()
    return (jax.tree.map(np.asarray, full), jax.tree.map(np.asarray, rpn),
            jax.tree.map(np.asarray, feat3))


@pytest.fixture(scope="module")
def torch_test(setup):
    s = setup
    model = torch_model(s["params"], *s["p"], train=False)
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    return (model(data, _t(s["im_info"]), mode="test"),
            model(data, _t(s["im_info"]), mode="rpn_test"), model)


def test_test_forward_end_to_end(jax_test, torch_test):
    """One mode="test" forward from the uint8 batch: the proposals, the
    averaged class probabilities and stage 3's boxes tiled over the classes
    within 1e-5 of their scale."""
    full = jax_test[0]
    out = torch_test[0]
    assert set(out) == set(full)
    assert out["bbox_xyxy"].shape == (B, 128, 4 * NUM_CLASS)
    for key in ("rois", "roi_score", "cls_score", "bbox_xyxy"):
        assert rel_err(out[key].numpy(), full[key]) <= CONT, key
    np.testing.assert_allclose(out["cls_score"].sum(-1).numpy(), 1.0,
                               rtol=0, atol=1e-6)
    boxes = out["bbox_xyxy"].reshape(B, 128, NUM_CLASS, 4)
    assert torch.equal(boxes, boxes[:, :, :1].expand_as(boxes))


def test_rpn_test_mode(jax_test, torch_test):
    want, got = jax_test[1], torch_test[1]
    assert set(got) == set(want) == {"proposal", "proposal_score"}
    for key in want:
        assert rel_err(got[key].numpy(), want[key]) <= CONT, key


def test_score_averaging_teacher_forced(jax_test, torch_test):
    """The JAX stage-3 features, logits and boxes into the port: heads 1 and
    2 applied again to the stage-3 features (their matmuls: 1e-5) and the
    three softmaxes averaged; the boxes tiled exactly."""
    full, _, (feat3, cls3, boxes3) = jax_test
    model = torch_test[2]
    with torch.no_grad():
        score, boxes = model.average_scores(_t(feat3), _t(cls3), _t(boxes3))
    assert rel_err(score.numpy(), full["cls_score"]) <= CONT
    assert rel_err(boxes.numpy(), full["bbox_xyxy"]) <= 1e-6
    np.testing.assert_array_equal(boxes.numpy(),
                                  np.tile(boxes3, (1, 1, NUM_CLASS)))


@pytest.mark.parametrize("score_thr", [0.05, 0.0])
def test_per_class_nms_on_cascade_outputs(jax_test, score_thr):
    """The port's post-processing takes the averaged probabilities and the
    tiled class-agnostic boxes [B, R, 4 * classes]: identical detections to
    the JAX package's on the JAX outputs."""
    from simpledet_tpu.eval.postprocess import per_class_nms as j_nms
    from simpledet_torch.eval.postprocess import per_class_nms

    full = jax_test[0]
    want = jax.vmap(lambda ss, bb: j_nms(ss, bb, score_thr=score_thr,
                                         nms_thr=0.5, max_det=100))(
        full["cls_score"], full["bbox_xyxy"])
    got = per_class_nms(_t(full["cls_score"]), _t(full["bbox_xyxy"]),
                        score_thr=score_thr, nms_thr=0.5, max_det=100)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].any()


# ------------------------------------------------------ checkpoints, metrics


def test_cascade_params_cross_both_ways_bit_for_bit(setup, tmp_path):
    """The cascade's .params, written by the port, is the file the JAX
    package writes for the same tree; a JAX-written file loads into the port
    leaf for leaf."""
    from simpledet_tpu.core import checkpoint as jckpt
    from simpledet_torch.core import checkpoint as ckpt

    params = setup["params"]
    model = torch_model(params, *setup["p"], train=False)
    ckpt.save_checkpoint(str(tmp_path / "port"), 1, model)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, params)
    data = (tmp_path / "port-0001.params").read_bytes()
    assert data == (tmp_path / "jax-0001.params").read_bytes()
    other = torch_model(jax.tree.map(np.zeros_like, params), *setup["p"],
                        train=False)
    ckpt.load_checkpoint(str(tmp_path / "jax"), 1, other)
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    assert {k.split(".")[0] for k in model.state_dict()} >= {
        "head_1st", "head_2nd", "head_3rd"}


def test_cascade_metrics_read_the_stage_outputs(jax_grads, torch_step):
    """The cascade config's metric_list (RpnAcc, RcnnAcc1st on
    bbox_cls_logit_1st / bbox_label_1st, RcnnAcc3rd on the _3rd ones) reads
    the port's train aux, and gives the JAX package's metrics' values on the
    JAX aux."""
    from simpledet_tpu.core.metrics import AccWithIgnore as JAcc
    from simpledet_torch.core.config import read_config
    from simpledet_torch.core.metrics import from_config

    spec = read_config("config/cascade_r50v1_fpn_1x.py", is_train=True)
    metrics = from_config(spec.metric_list)
    assert [m.name for m in metrics.metrics] == ["RpnAcc", "RcnnAcc1st",
                                                 "RcnnAcc3rd"]
    assert metrics.metrics[2].output_names == ["bbox_cls_logit_3rd",
                                               "bbox_label_3rd"]
    metrics.update({k: v.detach().numpy() for k, v in torch_step[2].items()})
    got = dict(metrics.get())
    want_aux = jax_grads[1]
    for m in metrics.metrics:
        ref = JAcc(m.name, m.output_names, [])
        ref.update(want_aux)
        assert np.isfinite(got[m.name]) and got[m.name] == ref.get()[1], \
            m.name
