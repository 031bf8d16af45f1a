"""The port's RetinaNet against the JAX package, on the CPU.

A small RetinaNet (depth-18 bottleneck ResNet with FrozenBN, neck and
towers 64 wide, 4 classes, 9 anchors a position, 128 x 192 images, batch 2)
is built on both sides with the same Flax params, mapped by
`weights.from_flax`; the FrozenBN statistics are random folds (activations
of order one). Held: the focal loss and the dense targets on their own, the
neck and subnets teacher-forced, the whole train step (losses, labels,
every gradient against jax.grad), a 3-step SGD trajectory against the
JAX package's grad-and-update step, the test forward's candidates and the per-class NMS
after it, the foreground count summed over a 2-rank gloo group, and `.params`
both ways. Then config/converge_retina.py's own detector (SyncBN) and adam
optimizer on both sides: a 3-step trajectory against make_train_step.

The dense labels depend on IoUs only; no anchor's best IoU lies within 1e-5
(float32 IoUs differ by about 1e-7) of the 0.4 / 0.5 thresholds for these boxes (`test_no_iou_near_thresholds`
holds that premise), so float32 differences between the two packages flip no
label. For the test forward the subnets' kernels are scaled (`_test_params`)
so that scores spread past 0.05; no score lies within 1e-6 of the threshold
and no top-k boundary within 1e-6 of a tie (`test_no_score_near_ties`), so
both sides keep the same rows.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledet_tpu.core.checkpoint import load_checkpoint as j_load
from simpledet_tpu.core.checkpoint import save_checkpoint as j_save
from simpledet_tpu.core.optimizer import freeze_mask as j_freeze_mask
from simpledet_tpu.core.optimizer import make_optimizer as j_make_optimizer
from simpledet_tpu.core.schedule import warmup_multifactor as j_warmup
from simpledet_tpu.core.train import TrainState
from simpledet_tpu.eval.postprocess import per_class_nms as j_per_class_nms
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models import retinanet as jretina
from simpledet_tpu.models.norm import normalizer_factory
from simpledet_tpu.ops.image import device_normalize as j_normalize
from simpledet_tpu.ops.losses import sigmoid_focal_loss as j_focal
from simpledet_tpu.targets.retina_target import \
    retina_anchor_target as j_target
from simpledet_torch.core import checkpoint as ckpt
from simpledet_torch.core.config import read_config
from simpledet_torch.core.schedule import warmup_multifactor
from simpledet_torch.core.train import Trainer
from simpledet_torch.dsl import build_detector
from simpledet_torch.eval.postprocess import per_class_nms
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.retinanet import (RetinaNet, RetinaNetHead,
                                              RetinaNetNeck, RetinaSubnets,
                                              SameConv2d)
from simpledet_torch.ops.anchors import generate_anchor_grid
from simpledet_torch.ops.image import device_normalize
from simpledet_torch.ops.losses import sigmoid_focal_loss
from simpledet_torch.parallel import dist
from simpledet_torch.targets.retina_target import retina_anchor_target
from simpledet_torch.weights import flax_path, from_flax

from retina_ranks import (B, FILTERS, H, NUM_CLASS, RATIOS, SCALES, STRIDES,
                          W, gt_boxes, head_loss, rpn_param)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN, STD = (122.7717, 115.9465, 102.9801), (1.0, 1.0, 1.0)
FIXED = ("conv0", "stage1", "scale", "bias")
PRED_SCALE = 10.0          # the class predictor's kernel on the test path

# float32 convs summed in other orders (XLA's and oneDNN's): the losses
# within 1e-5 relative, each gradient within 1e-4 of its leaf's max |grad|,
# continuous test outputs within 1e-4 of their scale (tests/test_torch_train.py)
LOSS_RTOL, GRAD_RTOL, OUT_RTOL = 1e-5, 1e-4, 1e-4


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


def _flax_layout(t):
    g = t.detach().numpy()
    if g.ndim == 4:
        return g.transpose(2, 3, 1, 0)
    return g.T if g.ndim == 2 else g


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module's tests run: the tier-1
    command runs 6 test workers on the CPU's cores, and torch's default of
    a thread a core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def torch_model(params, p_rpn, train=True):
    backbone = ResNet(18)
    head = RetinaNetHead(p_rpn)
    model = RetinaNet(backbone, RetinaNetNeck(backbone.out_channels[1:],
                                              FILTERS),
                      RetinaSubnets(head.num_anchor, head.num_fg_class,
                                    FILTERS, FILTERS), head)
    from_flax(params, model)
    return model.to(memory_format=torch.channels_last).train(train)


@pytest.fixture(scope="module")
def setup():
    p_rpn = rpn_param()
    p_rpn.dtype = jnp.float32
    jhead = jretina.RetinaNetHead(p_rpn)
    jmodel = jretina.RetinaNet(
        backbone=jresnet.ResNet(depth=18, norm=normalizer_factory("fixbn"),
                                name="backbone"),
        neck=jretina.RetinaNetNeck(filters=FILTERS, name="neck"),
        head_module=jhead.module, head=jhead)
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8)
    im_info = np.float32([[H, W, 1.0], [112, 160, 1.0]])
    params = jax.jit(lambda r, x, i: jmodel.init(r, x, i, mode="test"))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((B, H, W, 3)),
        jnp.asarray(im_info))["params"]
    params = jax.tree.map(np.asarray, params)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
                         if path[-1].key == "scale" else
                         rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
                         if path[-1].key == "bias" and v.ndim == 1
                         and "bn" in path[-2].key else v), params)
    return dict(jmodel=jmodel, params=params, data=data, im_info=im_info,
                gt=gt_boxes(), p_rpn=p_rpn)


def _normalised(s):
    return j_normalize(jnp.asarray(s["data"]), jnp.asarray(s["im_info"]),
                       MEAN, STD)


def _test_params(params):
    """The params of the test path: the towers' kernels scaled by 4 (a
    4-conv tower at the Flax init passes a quarter of its input's scale
    on), the class predictor's by PRED_SCALE."""
    out = jax.tree.map(lambda v: v, params)
    for name, leaf in params["head_module"].items():
        scale = PRED_SCALE if name == "cls_pred" else \
            1.0 if name == "bbox_pred" else 4.0
        out["head_module"][name] = dict(leaf, kernel=leaf["kernel"] * scale)
    return out


@pytest.fixture(scope="module")
def jax_loss_and_grad(setup):
    """params -> ((total loss, (losses, aux)), grads) of the JAX train
    forward on the batch, jitted once for the module."""
    s = setup
    data = _normalised(s)

    def loss_fn(params):
        losses, aux = s["jmodel"].apply(
            {"params": params}, data, jnp.asarray(s["im_info"]),
            jnp.asarray(s["gt"]), mode="train")
        return sum(losses.values()), (losses, aux)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def jax_grads(setup, jax_loss_and_grad):
    (_, (losses, aux)), grads = jax_loss_and_grad(setup["params"])
    return (jax.tree.map(np.asarray, losses), jax.tree.map(np.asarray, aux),
            jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def jax_test(setup):
    """The JAX test forward on the scaled params: the backbone's c2-c5, the
    pyramid, the level outputs, the test outputs and their per-class NMS at
    0.05."""
    s = setup
    params = _test_params(s["params"])
    data = _normalised(s)

    def run(m, d, i):
        feats = m.backbone(d)
        pyr = m.neck(feats)
        return feats, pyr, m.head_module(pyr), m(d, i, mode="test")

    feats, pyr, outs, full = jax.jit(lambda p, d, i: s["jmodel"].apply(
        {"params": p}, d, i, method=run))(params, data,
                                          jnp.asarray(s["im_info"]))
    post = jax.vmap(lambda c, b: j_per_class_nms(
        c, b, score_thr=0.05, nms_thr=0.5, max_det=100))(
            full["cls_score"], full["bbox_xyxy"])
    return dict(params=params, feats=feats, pyr=pyr, **{
        k: jax.tree.map(np.asarray, v) for k, v in
        (("outs", outs), ("full", full), ("post", post))})


@pytest.fixture(scope="module")
def torch_step(setup):
    """The port's train forward and backward (nothing frozen)."""
    s = setup
    model = torch_model(s["params"], s["p_rpn"])
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    losses, aux = model(data, _t(s["im_info"]), _t(s["gt"]), mode="train")
    sum(losses.values()).backward()
    return model, losses, aux


# ------------------------------------------------------------ focal loss


@pytest.mark.parametrize("alpha,gamma", [(0.25, 2.0), (0.5, 1.5)])
def test_focal_loss_and_its_gradient_match_jax(alpha, gamma):
    """Logits up to +-12 (saturated sigmoids), labels background, each class
    and ignore: the per-anchor losses within 1e-6 relative (ignored rows 0
    on both sides) and the gradient of their sum within 1e-6 of its max."""
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 60, 3) * 4).astype(np.float32)
    logits[0, :3] = [[12, -12, 0], [-12, 12, 11], [0.5, -0.5, 12]]
    label = rng.randint(-1, 4, (2, 60)).astype(np.float32)
    label[0, :4] = [-1, 0, 3, 1]
    want, vjp = jax.vjp(lambda x: j_focal(x, jnp.asarray(label),
                                          alpha=alpha, gamma=gamma),
                        jnp.asarray(logits))
    (want_grad,) = vjp(jnp.ones_like(want))
    x = _t(logits).requires_grad_()
    got = sigmoid_focal_loss(x, _t(label), alpha=alpha, gamma=gamma)
    got.sum().backward()
    assert rel_err(got.detach(), want) <= 1e-6
    assert (got.detach().numpy()[label < 0] == 0).all()
    assert rel_err(x.grad, want_grad) <= 1e-6
    assert (x.grad.numpy()[label < 0] == 0).all()


# ---------------------------------------------------------------- targets


def _anchors(hw=(H, W)):
    return np.concatenate([
        generate_anchor_grid(-(-hw[0] // s), -(-hw[1] // s), s, SCALES,
                             RATIOS) for s in STRIDES])


TARGET_CASES = {
    # padding rows, an ignore region (class -2), the image as large as
    # the batch's
    "padding and ignore": (0, (H, W), {}),
    # a smaller image with allowed_border 0: anchors past its border ignored
    "allowed_border 0": (1, (112, 160), dict(allowed_border=0)),
    # every gt row padding: all valid anchors background, targets zero
    "no gt": (2, (H, W), {}),
    # the per-gt best anchors gated by min_pos_thr
    "min_pos_thr": (1, (112, 160), dict(min_pos_thr=0.3)),
}


@pytest.mark.parametrize("case", TARGET_CASES)
def test_retina_targets_match_jax(case):
    """Labels, regression weights and foreground counts identical to the
    JAX package's; regression targets within 1e-6 of their scale."""
    image, hw, kw = TARGET_CASES[case]
    gt = np.concatenate([gt_boxes(), np.full((1, 8, 5), -1, np.float32)])
    anchors = _anchors()
    want = j_target(jnp.asarray(anchors), jnp.asarray(gt[image]),
                    jnp.asarray(hw, jnp.float32), **kw)
    got = retina_anchor_target(_t(anchors), _t(gt[image]),
                               torch.tensor(hw, dtype=torch.float32), **kw)
    label, target, weight, fg = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), label)
    np.testing.assert_array_equal(got[2].numpy(), weight)
    assert float(got[3]) == float(fg)
    assert rel_err(got[1], target) <= 1e-6 if target.any() else \
        not got[1].numpy().any()
    if case == "no gt":
        assert set(np.unique(label)) <= {0.0, -1.0} and float(fg) == 1
    else:
        assert (label >= 1).sum() >= 3 and (label == -1).any()
    if case == "allowed_border 0":
        outside = (anchors[:, 2] >= 160) | (anchors[:, 3] >= 112) | \
            (anchors[:, :2] < 0).any(1)
        assert (label[outside] == -1).all() and outside.any()


def test_no_iou_near_thresholds():
    """The premise of the label comparisons: for the test boxes, no anchor's
    best IoU (float64) lies within 1e-5 of neg_thr 0.4 or pos_thr 0.5."""
    anchors = _anchors().astype(np.float64)
    for g in gt_boxes():
        g = g[g[:, 4] > 0, :4].astype(np.float64)
        iw = (np.minimum(anchors[:, None, 2], g[:, 2])
              - np.maximum(anchors[:, None, 0], g[:, 0]) + 1).clip(0)
        ih = (np.minimum(anchors[:, None, 3], g[:, 3])
              - np.maximum(anchors[:, None, 1], g[:, 1]) + 1).clip(0)
        area = lambda b: (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)  # noqa: E731,E501
        ov = iw * ih / (area(anchors)[:, None] + area(g) - iw * ih)
        best = ov.max(1)
        for thr in (0.4, 0.5):
            assert np.abs(best - thr).min() > 1e-5, thr


# --------------------------------------------------------- neck, subnets


def test_same_padding_matches_flax():
    """SameConv2d (3 x 3, stride 2) against Flax's SAME padding on even and
    odd sides: (0, 1) on an even side, (1, 1) on an odd one."""
    import flax.linen as fnn

    rng = np.random.RandomState(2)
    for h, w in ((4, 6), (5, 7), (25, 42)):
        x = rng.randn(1, h, w, 3).astype(np.float32)
        conv = fnn.Conv(2, (3, 3), strides=(2, 2))
        p = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        want = np.asarray(conv.apply({"params": p}, jnp.asarray(x)))
        tconv = SameConv2d(3, 2, 3, stride=2)
        from_flax({"c": p}, torch.nn.ModuleDict({"c": tconv}))
        with torch.no_grad():
            got = tconv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert got.shape == want.shape
        assert rel_err(got, want) <= 1e-6


def test_neck_and_subnets_match_jax(setup, jax_test):
    """The JAX backbone's c3-c5 into the port's neck (P3-P7 within 1e-5),
    the JAX pyramid into the port's subnets (each level's logits and deltas
    within 1e-5): P6 on C5, P7 on relu(P6), towers shared across the
    levels."""
    j = jax_test
    model = torch_model(j["params"], setup["p_rpn"], train=False)
    with torch.no_grad():
        got_pyr = model.neck({k: _t(v).permute(0, 3, 1, 2)
                              for k, v in j["feats"].items()})
        got_outs = model.head_module({k: _t(v).permute(0, 3, 1, 2)
                                      for k, v in j["pyr"].items()})
    assert [tuple(v.shape[2:]) for v in got_pyr.values()] == \
        [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    for k, v in j["pyr"].items():
        assert rel_err(got_pyr[k].permute(0, 2, 3, 1), v) <= 1e-5, k
    for k, (cls, reg) in j["outs"].items():
        assert cls.shape[-1] == 9 * (NUM_CLASS - 1)
        assert rel_err(got_outs[k][0].permute(0, 2, 3, 1), cls) <= 1e-5, k
        assert rel_err(got_outs[k][1].permute(0, 2, 3, 1), reg) <= 1e-5, k


# ------------------------------------------------------------- train step


def test_train_losses_and_labels_match(jax_grads, torch_step):
    """The whole train forward: both losses within 1e-5 relative, the dense
    labels identical, the global foreground count equal."""
    want, want_aux, _ = jax_grads
    _, losses, aux = torch_step
    assert set(losses) == set(want) == {"retina_cls_loss", "retina_reg_loss"}
    for k, v in want.items():
        assert rel_err(losses[k].detach(), v) <= LOSS_RTOL, k
    np.testing.assert_array_equal(aux["rpn_label"].numpy(),
                                  want_aux["rpn_label"])
    assert float(aux["rpn_fg_count"]) == float(want_aux["rpn_fg_count"])
    assert (want_aux["rpn_label"] >= 1).sum() >= 10


def test_every_gradient_matches_jax_grad(jax_grads, torch_step):
    """Each parameter's gradient within 1e-4 of its leaf's max |grad| of
    jax.grad, found through flax_path; every leaf outside FrozenBN gets
    one."""
    _, _, grads = jax_grads
    model = torch_step[0]
    want = dict(_flat(grads))
    errs = {name: rel_err(_flax_layout(p.grad), want[flax_path(name)])
            for name, p in model.named_parameters()}
    assert len(errs) == sum(1 for k in want if not k.endswith("scale")
                            and "bn" not in k.split("/")[-2])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    assert np.abs(want["neck/P6_conv/kernel"]).max() > 0


def test_sgd_trajectory_matches(setup, jax_loss_and_grad):
    """Three steps of Trainer against the JAX package's step (jax.grad of
    the summed losses, then TrainState.apply_gradients with its
    make_optimizer: sgd, momentum 0.9, wd 1e-4, gradual warmup,
    conv0/stage1/scale/bias frozen; what make_train_step does, without a
    second compile of the model): each total loss within 1e-4, every
    parameter within 1e-4 of its scale, every trained leaf's total update
    within 1e-3 of the update's scale or within one float32 ulp of the
    parameter's (warmup updates of the backbone's convs are 20-50 ulps of
    their parameters, and the two sides round them apart: measured 1/46 of
    such an update)."""
    s = setup
    sched_args = dict(warmup_lr=0.01 / 3, warmup_iter=500)
    jsched = j_warmup(0.01, [60000, 80000], **sched_args)
    tx = j_make_optimizer(jsched, momentum=0.9, wd=1e-4,
                          trainable_mask=j_freeze_mask(s["params"], FIXED))
    state = TrainState.create(apply_fn=s["jmodel"].apply,
                              params=s["params"], tx=tx)
    trainer = Trainer(torch_model(s["params"], s["p_rpn"]),
                      schedule=warmup_multifactor(0.01, [60000, 80000],
                                                  **sched_args),
                      fixed_param=FIXED, momentum=0.9, wd=1e-4,
                      pixel_norm=(MEAN, STD))
    update = jax.jit(lambda st, g: st.apply_gradients(grads=g))
    for i in range(3):
        (jl, _), grads = jax_loss_and_grad(state.params)
        state = update(state, grads)
        tl = trainer.step(_t(s["data"]), _t(s["im_info"]), _t(s["gt"]))
        assert rel_err(tl["total_loss"], jl) <= 1e-4, i
    want = dict(_flat(jax.tree.map(np.asarray, state.params)))
    start = dict(_flat(s["params"]))
    worst = 0.0
    for name, t in trainer.model.state_dict().items():
        path = flax_path(name)
        g = _flax_layout(t)
        assert rel_err(g, want[path]) <= 1e-4, name
        moved = want[path] - start[path]
        if trainer.trainable[name]:
            assert np.abs(moved).max() > 0, name
            err = np.abs((g - start[path]) - moved).max()
            # or one float32 ulp of the parameter's scale: the backbone's
            # first updates are a few ulps of their parameters
            if err > 2.0 ** -23 * np.abs(start[path]).max():
                worst = max(worst, rel_err(g - start[path], moved))
        else:
            np.testing.assert_array_equal(g, start[path])
    assert worst <= 1e-3, worst


# ------------------------------------- converge_retina's step: SyncBN, adam

CONVERGE_RETINA = os.path.join(REPO, "config", "converge_retina.py")
SYNCBN_BETA = 3.0      # tests/test_torch_syncbn.py: ReLU inputs off 0


def test_converge_retina_adam_syncbn_trajectory(setup):
    """config/converge_retina.py's own train detector and optimizer on both
    sides (depth-18 bottleneck ResNet with SyncBN, nothing frozen, towers 64
    wide, 6 anchors a position, 4 classes; adam at the config's lr, gradual
    warmup, wd 1e-5, clip 35, 4 steps an epoch): the port's Trainer against
    the JAX package's make_train_step with a batch_stats state, from the
    Flax init (SyncBN betas at 3 and random running statistics, as
    tests/test_torch_syncbn.py) on this module's batch: each of 3 steps'
    total loss within 1e-5 relative, every parameter within 1e-4 of its
    scale, the running statistics within 1e-5; each update within 5e-2 of
    its leaf's update scale, and no more than 5e-4 of the model's elements
    beyond 1e-3 of it (adam's per-element normalisation, below)."""
    from simpledet_tpu.core.config import load_config as j_load_config
    from simpledet_tpu.core.train import make_train_step

    spec = read_config(CONVERGE_RETINA, is_train=True)
    model = build_detector(spec)
    jcfg = j_load_config(CONVERGE_RETINA).get_config(is_train=True)
    jmodel, opt = jcfg[6].train_symbol, jcfg[7]
    assert type(jmodel).__name__ == "RetinaNet"
    assert opt.optimizer.type == "adam" and not spec.fixed_param
    rng = np.random.RandomState(7)
    variables = jax.jit(lambda r, x, i: jmodel.init(r, x, i, mode="test"))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((B, H, W, 3)),
        jnp.asarray(setup["im_info"]))
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    bs = jax.tree.map(lambda v: rng.uniform(0.5, 1.5, v.shape).astype(
        np.float32), to_np(variables["batch_stats"]))
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.full_like(v, SYNCBN_BETA)
        if path[-1].key == "beta" else v, to_np(variables["params"]))
    assert params["head_module"]["cls_conv1"]["kernel"].shape[-1] == 64
    assert params["head_module"]["cls_pred"]["kernel"].shape[-1] == 6 * 3
    from_flax(params, model, bs)
    model = model.to(memory_format=torch.channels_last).train()
    trainer = Trainer.from_spec(model, spec, 4)

    sched = j_warmup(opt.optimizer.lr, opt.schedule.lr_iter,
                     warmup_type=opt.warmup.type, warmup_lr=opt.warmup.lr,
                     warmup_iter=opt.warmup.iter)
    tx = j_make_optimizer(sched, opt_type="adam", wd=opt.optimizer.wd,
                          clip_gradient=opt.optimizer.clip_gradient)
    state = TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx,
                              batch_stats=bs)
    step = jax.jit(make_train_step(jmodel, donate=False,
                                   pixel_norm=spec.pixel_norm))
    batch = {"data": jnp.asarray(setup["data"]),
             "im_info": jnp.asarray(setup["im_info"]),
             "gt_bbox": jnp.asarray(setup["gt"])}
    for i in range(3):
        state, jl, _ = step(state, batch, jax.random.PRNGKey(i))
        tl = trainer.step(_t(setup["data"]), _t(setup["im_info"]),
                          _t(setup["gt"]))
        assert rel_err(tl["total_loss"], jl["total_loss"]) <= LOSS_RTOL, i
    want = dict(_flat(jax.tree.map(np.asarray, state.params)))
    start = dict(_flat(params))
    worst, beyond, n_elements = ("", 0.0), 0, 0
    for name, p in trainer.model.named_parameters():
        path = flax_path(name)
        g = _flax_layout(p)
        assert rel_err(g, want[path]) <= 1e-4, name
        moved = want[path] - start[path]
        off = np.abs((g - start[path]) - moved) / np.abs(moved).max()
        worst = max(worst, (path, off.max()), key=lambda t: t[1])
        beyond, n_elements = beyond + int((off > 1e-3).sum()), \
            n_elements + off.size
    # adam divides each element's moment by its own RMS: an element whose
    # gradients are sums that cancel to float32 noise takes an update of
    # the lr's size whose value is that noise. Measured: the worst element
    # 1.6e-2 of its leaf's update scale (head_module/bbox_pred/kernel, 1 of
    # 13,824 elements); 1,496 of the model's 22.5M elements (6.7e-5)
    # beyond 1e-3 of it
    assert worst[1] <= 5e-2, worst
    assert beyond <= 5e-4 * n_elements, (beyond, n_elements)
    want_bs = dict(_flat(jax.tree.map(np.asarray, state.batch_stats)))
    got_bs = dict(_flat(ckpt.batch_stats_to_flax(trainer.model)))
    assert set(got_bs) == set(want_bs)
    for k, w in want_bs.items():
        assert rel_err(got_bs[k], w) <= 1e-5, k


# --------------------------------------------------------------- test path


def _kept_scores(outs):
    """Per (image, level), as the JAX decode reads them (float64): the
    scores above the level's threshold, sorted descending."""
    for key, stride in zip(sorted(outs, key=lambda k: int(k[6:])), STRIDES):
        prob = 1 / (1 + np.exp(-outs[key][0].astype(np.float64)))
        thr = 0.0 if stride == max(STRIDES) else 0.05
        for b in range(prob.shape[0]):
            flat = np.sort(prob[b].reshape(-1))[::-1]
            yield flat, thr


def test_no_score_near_ties(setup, jax_test):
    """The premise of the test-forward comparison: no score lies within
    1e-6 of the 0.05 threshold, and where a level's top-k binds, the last
    score it keeps and the first it drops differ by more than 1e-6; so both
    sides keep the same rows of each (image, level)."""
    outs = jax_test["outs"]
    top_n, binds = setup["p_rpn"].proposal.pre_nms_top_n, 0
    for flat, thr in _kept_scores(outs):
        if thr > 0:
            assert np.abs(flat - thr).min() > 1e-6
        kept = flat[flat > thr]
        if len(kept) > top_n:
            binds += 1
            assert kept[top_n - 1] - kept[top_n] > 1e-6
    assert binds >= 2       # P3 of both images


def _rows(out, level_rows):
    """Per (image, level block): the valid rows (class, x1, y1, x2, y2,
    score) in a canonical order (by class, then the box rounded to 0.01
    px), since two scores a few ulps apart may leave torch.topk and
    lax.top_k in either order."""
    cls = np.asarray(out["cls_score"])
    boxes = np.asarray(out["bbox_xyxy"])[..., :4]
    valid = np.asarray(out["det_valid"])
    blocks, start = [], 0
    for n in level_rows:
        for b in range(cls.shape[0]):
            sl = slice(start, start + n)
            v = valid[b, sl]
            c = cls[b, sl][v]
            rows = np.concatenate([c.argmax(1)[:, None], boxes[b, sl][v],
                                   c.max(1)[:, None]], 1)
            order = np.lexsort(np.round(rows[:, 4::-1], 2).T)
            blocks.append(rows[order])
        start += n
    return blocks


def test_test_forward_matches_jax(setup, jax_test):
    """The test forward from the uint8 batch, the towers and predictors
    scaled on both sides so that P3's and P4's scores spread past 0.05: the
    same rows valid; per (image, level) the same candidates, their classes
    identical, scores and boxes within 1e-4 of their scale; P3's top-k
    binds (100 of its scores kept), P7 keeps all 54 (threshold 0); the other
    rows score zero in every class."""
    params, full = jax_test["params"], jax_test["full"]
    model = torch_model(params, setup["p_rpn"], train=False)
    data = device_normalize(_t(setup["data"]), _t(setup["im_info"]), MEAN,
                            STD)
    out = model(data, _t(setup["im_info"]), mode="test")
    assert set(out) == set(full)
    valid = full["det_valid"]
    level_rows = [100, 100, 100, 100, 54]
    assert valid.shape == (B, sum(level_rows))
    np.testing.assert_array_equal(out["det_valid"].numpy(), valid)
    assert valid[:, :100].all() and valid[:, -54:].all()
    assert out["cls_score"].shape == (B, valid.shape[1], NUM_CLASS)
    for got, want in zip(_rows(out, level_rows), _rows(full, level_rows)):
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        if len(want):
            assert rel_err(got[:, 1:5], want[:, 1:5]) <= OUT_RTOL
            assert rel_err(got[:, 5], want[:, 5]) <= OUT_RTOL
    np.testing.assert_array_equal(out["cls_score"].numpy()[~valid], 0)


def test_detections_after_nms_match_jax(setup, jax_test):
    """The per-class NMS at 0.05 on each side's own test outputs: the same
    detections (classes and validity identical; boxes and scores within
    1e-4)."""
    params, post = jax_test["params"], jax_test["post"]
    model = torch_model(params, setup["p_rpn"], train=False)
    data = device_normalize(_t(setup["data"]), _t(setup["im_info"]), MEAN,
                            STD)
    out = model(data, _t(setup["im_info"]), mode="test")
    got = per_class_nms(out["cls_score"], out["bbox_xyxy"], score_thr=0.05,
                        nms_thr=0.5, max_det=100)
    np.testing.assert_array_equal(got[3].numpy(), post[3])
    np.testing.assert_array_equal(got[2].numpy(), post[2])
    assert rel_err(got[0], post[0]) <= OUT_RTOL
    assert rel_err(got[1], post[1]) <= OUT_RTOL
    assert post[3].sum() >= 20


# ------------------------------------------------ fg count over a group


def test_fg_count_sums_over_a_2_rank_group(tmp_path):
    """Two gloo ranks, two images each, against one process on all four:
    each rank divides by the global foreground count (the sum over the
    group, not its own), and the ranks' losses average to the one
    process's (DDP averages the ranks' gradients)."""
    code = ("import sys; sys.path.insert(0, {!r}); import retina_ranks; "
            "retina_ranks.rank_main({!r})").format(
                os.path.join(REPO, "tests"), str(tmp_path))
    dist.launch_local(code, 2, env={"PYTHONPATH": REPO})
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    losses, aux = head_loss([0, 1, 2, 3])
    total = float(aux["rpn_fg_count"])
    assert [r["total_fg"] for r in ranks] == [total, total]
    assert sum(r["own_fg"] for r in ranks) == total
    assert ranks[0]["own_fg"] != ranks[1]["own_fg"]
    for k, v in losses.items():
        mean = sum(r["losses"][k] for r in ranks) / 2
        assert abs(mean - float(v)) <= 1e-6 * abs(float(v)), k


# ---------------------------------------------------- checkpoints, configs


def test_params_files_are_byte_identical_both_ways(setup, tmp_path):
    """A `.params` of the retina leaves written by the JAX package reads
    into the port, which writes the same bytes back; the port's file reads
    into the JAX template leaf for leaf."""
    s = setup
    j_save(str(tmp_path / "jax"), 1, s["params"])
    model = torch_model(s["params"], s["p_rpn"], train=False)
    ckpt.load_checkpoint(str(tmp_path / "jax"), 1, model)
    ckpt.save_checkpoint(str(tmp_path / "port"), 1, model)
    jbytes = (tmp_path / "jax-0001.params").read_bytes()
    assert (tmp_path / "port-0001.params").read_bytes() == jbytes
    back, _, _ = j_load(str(tmp_path / "port"), 1, s["params"])
    for (k, v), (k2, w) in zip(_flat(back), _flat(s["params"])):
        assert k == k2
        np.testing.assert_array_equal(np.asarray(v), w)
    names = {k for k, _ in _flat(s["params"])}
    assert {"neck/P6_conv/kernel", "neck/P3_lateral/bias",
            "head_module/cls_pred/bias",
            "head_module/bbox_conv4/kernel"} <= names


def test_retina_config_maps_every_leaf_of_the_jax_model():
    """config/retina_r50v1_fpn_1x.py read and built at full width: 81
    classes, 9 anchors, every leaf of the JAX model's tree mapped with its
    shape; the class predictor's bias starts at -log(99)."""
    from simpledet_tpu.core.config import load_config as j_load_config

    path = "config/retina_r50v1_fpn_1x.py"
    model = build_detector(read_config(path))
    jmodel = j_load_config(path).get_config(is_train=False)[6].test_symbol
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 128, 192, 3)),
        jnp.asarray([[128, 192, 1.0]]), mode="test"))["params"]
    params = jax.tree.map(lambda v: np.zeros(v.shape, np.float32), shapes)
    from_flax(params, model)
    assert model.head_module.cls_pred.weight.shape == (720, 256, 3, 3)
    model.head_module.init_weights(torch.Generator().manual_seed(0))
    np.testing.assert_allclose(model.head_module.cls_pred.bias.detach(),
                               -np.log(99.0), rtol=1e-6)


@pytest.mark.parametrize("path,what", [
    # (SEPC and the NAS-FPN necks and FreeAnchor's head are read and built
    # since they were ported, the PAFPN neck since the two-stage FPN
    # variants were): RetinaNet backbones the port does not have, and one
    # more component it does not have, the SE backbone
    ("config/efficientnet/efficientnet_b5_fpn_bn_scratch_400_6x.py",
     "EfficientNetB5FPN"),
    ("config/efficientnet/efficientnet_b5_fpn_bn_scratch_400_9x.py",
     "EfficientNetB5FPN"),
    ("config/se/mask_se-r50v1b_fpn_bn_scratch_2x.py", "SEResNetFPN"),
    ("config/efficientnet/retina_effb4_fpn_1x.py", "EfficientNetB4FPN"),
])
def test_unported_retina_variants_raise_naming_what_is_missing(path, what):
    with pytest.raises(NotImplementedError, match=what):
        build_detector(read_config(path))


@pytest.mark.parametrize("role", ["backbone", "neck", "rpn_head"])
def test_bf16_retina_raises(role):
    """fp16 = True on any retina component: the bf16 RetinaNet is not
    ported."""
    spec = read_config("config/retina_micro_test.py")
    spec.components[role].param.fp16 = True
    with pytest.raises(NotImplementedError, match="bf16 RetinaNet"):
        build_detector(spec)
