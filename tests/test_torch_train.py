"""The port's training slice against the JAX package on the CPU.

A small detector (depth-18 bottleneck ResNet, FPN filters 64, 5 classes,
96 x 128 images, batch 2, image_roi 64, pre/post NMS 256/128) is built on
both sides with the same Flax params, mapped by `weights.from_flax`. Sampling
runs on `arange` priorities (the JAX package's `_priorities` patched to its
deterministic branch; the port's `deterministic_sampling`), and proposals come
from `deterministic_proposals` of the gt on both sides (`fixed_proposals`),
so that ulp-level conv differences cannot flip a discrete choice. The JAX
side runs the crop RoIAlign, which applies the long-side clamp as the TPU
kernel does and splits tied gradients as the port does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledet_tpu.core.optimizer import freeze_mask as j_freeze_mask
from simpledet_tpu.core.optimizer import make_optimizer as j_make_optimizer
from simpledet_tpu.core.schedule import apply_dp_scaling as j_dp_scaling
from simpledet_tpu.core.schedule import warmup_multifactor as j_warmup
from simpledet_tpu.core.train import TrainState, make_train_step
from simpledet_tpu.models import fpn as jfpn
from simpledet_tpu.models import heads as jheads
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models.faster_rcnn import FasterRcnn as JFasterRcnn
from simpledet_tpu.models.norm import normalizer_factory
from simpledet_tpu.models.rpn import FPNRpnHead as JRpnHead
from simpledet_tpu.ops.image import device_normalize as j_normalize
from simpledet_tpu.targets import sampling as jsampling
from simpledet_torch.core.config import patch_config_as_nothrow, read_config
from simpledet_torch.core.optimizer import freeze_mask, make_optimizer
from simpledet_torch.core.schedule import apply_dp_scaling, warmup_multifactor
from simpledet_torch.core.train import Trainer
from simpledet_torch.models.faster_rcnn import FasterRcnn
from simpledet_torch.models.fpn import FPNNeck
from simpledet_torch.models.heads import Bbox2fcHead, bbox_head_loss
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.rpn import FPNRpnHead, RpnConvHead
from simpledet_torch.ops.image import device_normalize
from simpledet_torch.weights import flax_path, from_flax

FLAGSHIP = "config/faster_r50v1_fpn_1x.py"
FIXED = ("conv0", "stage1", "scale", "bias")
MEAN, STD = (122.7717, 115.9465, 102.9801), (1.0, 1.0, 1.0)
FILTERS, NUM_CLASS, B, H, W = 64, 5, 2, 96, 128
SEED_KEY = jax.random.PRNGKey(3)

# Losses: float32 convs and matmuls summed in other orders (XLA's and
# oneDNN's) move each loss by a few ulps through the depth: 1e-5 relative.
LOSS_RTOL = 1e-5
# Gradients: the same differences, carried back through the depth-18
# backbone: each leaf within 1e-4 of its own max |grad|.
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module's tests run: the tier-1
    command runs 6 test workers on the CPU's cores, and torch's default of
    a thread a core would oversubscribe them. Not two: with two threads
    oneDNN sums the convolutions in another order, and one box-head bias
    gradient moved 2.0e-3 of its max (a float32 near-tie); with one or four
    every gradient stays within 1e-4."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


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

    class BboxParam:
        num_class = NUM_CLASS

        class regress_target:
            class_agnostic = False
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    return [patch_config_as_nothrow(c) for c in (RpnParam, RoiParam,
                                                  BboxParam)]


def torch_model(params, p_rpn, p_roi, p_bbox):
    backbone = ResNet(18)
    trpn = FPNRpnHead(p_rpn)
    model = FasterRcnn(backbone, FPNNeck(backbone.out_channels, FILTERS),
                       RpnConvHead(trpn.num_anchor, FILTERS, FILTERS), trpn,
                       Bbox2fcHead(NUM_CLASS, NUM_CLASS, 49 * FILTERS),
                       p_roi, p_bbox, fixed_proposals=True,
                       deterministic_sampling=True)
    from_flax(params, model)
    return model.to(memory_format=torch.channels_last).train()


@pytest.fixture(scope="module")
def setup():
    p_rpn, p_roi, p_bbox = params_classes()
    p_rpn.dtype = jnp.float32
    jrpn = JRpnHead(p_rpn)
    jmodel = JFasterRcnn(
        backbone=jresnet.ResNet(depth=18, norm=normalizer_factory("fixbn"),
                                name="backbone"),
        neck=jfpn.FPNNeck(filters=FILTERS, name="neck"),
        rpn_module=jrpn.module, rpn=jrpn,
        bbox_head=jheads.Bbox2fcHead(num_class=NUM_CLASS,
                                     num_reg_class=NUM_CLASS,
                                     name="bbox_head"),
        p_rpn=p_rpn, p_roi=p_roi, p_bbox=p_bbox, fixed_proposals=True)
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8)
    im_info = np.float32([[H, W, 1.0], [80, 100, 1.0]])
    gt = np.full((B, 8, 5), -1, np.float32)
    gt[0, :3] = [[10, 12, 60, 70, 1], [50, 20, 120, 90, 3], [5, 40, 40, 94, 4]]
    gt[1, :2] = [[20, 10, 90, 60, 2], [0, 30, 50, 79, 1]]
    params = jmodel.init({"params": jax.random.PRNGKey(0),
                          "sampling": jax.random.PRNGKey(1)},
                         jnp.zeros((B, H, W, 3)), jnp.asarray(im_info),
                         mode="test")["params"]
    params = jax.tree.map(np.asarray, params)
    # FrozenBN starts as the identity; random folded stats keep activations
    # of order one through the depth
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
                         if path[-1].key == "scale" else
                         rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
                         if path[-1].key == "bias" and v.ndim == 1
                         and "bn" in path[-2].key else v), params)
    return dict(jmodel=jmodel, params=params, data=data, im_info=im_info,
                gt=gt, p=(p_rpn, p_roi, p_bbox))


@pytest.fixture(scope="module")
def jax_side():
    """Arange priorities and the crop RoIAlign for the JAX package, while
    its functions are traced."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SIMPLEDET_ROI_ALIGN", "crop")
    mp.setattr(jsampling, "_priorities",
               lambda rng, n, deterministic: jnp.arange(n, dtype=jnp.float32))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def jax_grads(setup, jax_side):
    s = setup
    data = j_normalize(jnp.asarray(s["data"]), jnp.asarray(s["im_info"]),
                       MEAN, STD)

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
    """The port's train-mode forward and backward (nothing frozen, so every
    parameter gets a gradient)."""
    s = setup
    model = torch_model(s["params"], *s["p"])
    data = device_normalize(torch.from_numpy(s["data"]),
                            torch.from_numpy(s["im_info"]), MEAN, STD)
    losses, aux = model(data, torch.from_numpy(s["im_info"]),
                        torch.from_numpy(s["gt"]), mode="train",
                        generator=torch.Generator())
    sum(losses.values()).backward()
    return model, losses, aux


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def test_train_losses_match(jax_grads, torch_step):
    """The whole train-mode forward with fixed proposals: the four losses
    within 1e-5 relative, the sampled labels identical."""
    want, want_aux, _ = jax_grads
    _, losses, aux = torch_step
    assert set(losses) == set(want)
    for k, v in want.items():
        assert rel_err(losses[k].detach(), v) <= LOSS_RTOL, k
    np.testing.assert_array_equal(aux["rpn_label"].numpy(),
                                  want_aux["rpn_label"])
    np.testing.assert_array_equal(aux["bbox_label"].numpy(),
                                  want_aux["bbox_label"])
    assert (want_aux["bbox_label"] > 0).any()
    assert set(aux) == set(want_aux)


def test_every_gradient_matches_jax_grad(jax_grads, torch_step):
    """Each parameter's gradient (every leaf the optimizer could train) within
    1e-4 of that leaf's max |grad| of jax.grad, found through flax_path."""
    _, _, grads = jax_grads
    model = torch_step[0]
    want = dict(_flat(grads))
    errs = {}
    for name, p in model.named_parameters():
        w = want[flax_path(name)]
        g = p.grad.numpy()
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)
        elif g.ndim == 2:
            g = g.T
        errs[name] = rel_err(g, w)
    assert len(errs) == sum(1 for k in want if not k.endswith("scale")
                            and "bn" not in k.split("/")[-2])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    # the box head's gradient reaches the neck through the RoIAlign backward
    assert np.abs(want["neck/P2_conv/kernel"]).max() > 0


def test_rpn_loss_teacher_forced(setup, jax_side):
    """The JAX head's outputs into both losses: identical labels and losses
    within 1e-6 relative."""
    s = setup
    jrpn = s["jmodel"].rpn
    rng = np.random.RandomState(4)
    outs = {}
    for st in (4, 8, 16, 32, 64):
        hw = (-(-H // st), -(-W // st))
        outs[f"stride{st}"] = (rng.randn(B, *hw, 6).astype(np.float32),
                               rng.randn(B, *hw, 12).astype(np.float32) * 0.3)
    want, want_aux = jrpn.loss(SEED_KEY, outs, jnp.asarray(s["gt"]),
                               jnp.asarray(s["im_info"]), (H, W))
    trpn = FPNRpnHead(s["p"][0])
    got, aux = trpn.loss(None, {k: (torch.from_numpy(c).permute(0, 3, 1, 2),
                                    torch.from_numpy(r).permute(0, 3, 1, 2))
                                for k, (c, r) in outs.items()},
                         torch.from_numpy(s["gt"]),
                         torch.from_numpy(s["im_info"]), deterministic=True)
    np.testing.assert_array_equal(aux["rpn_label"].numpy(),
                                  np.asarray(want_aux["rpn_label"]))
    np.testing.assert_allclose(aux["rpn_cls_logit"].numpy(),
                               np.asarray(want_aux["rpn_cls_logit"]))
    for k in want:
        assert rel_err(got[k], want[k]) <= 1e-6, k


def test_bbox_head_loss_matches():
    rng = np.random.RandomState(5)
    cls = rng.randn(2, 16, NUM_CLASS).astype(np.float32) * 2
    delta = rng.randn(2, 16, 4 * NUM_CLASS).astype(np.float32)
    label = rng.randint(0, NUM_CLASS, (2, 16)).astype(np.float32)
    target = rng.randn(2, 16, 4 * NUM_CLASS).astype(np.float32)
    weight = (rng.rand(2, 16, 4 * NUM_CLASS) > 0.7).astype(np.float32)
    for sigma in (1.0, 3.0):
        want = jheads.bbox_head_loss(cls, delta, label, target, weight,
                                     smooth_l1_scalar=sigma)
        got = bbox_head_loss(*(torch.from_numpy(x) for x in
                               (cls, delta, label, target, weight)),
                             smooth_l1_scalar=sigma)
        for k in want:
            assert rel_err(got[k], want[k]) <= 1e-6, k


def test_sgd_trajectory_matches(setup, jax_side):
    """Three steps of Trainer against make_train_step with the flagship's
    optimizer settings (sgd, momentum 0.9, wd 1e-4, gradual warmup, frozen
    conv0/stage1/scale/bias): every parameter within 1e-4 of its scale, and
    every trained leaf's total update within 1e-3 of the update's scale
    (each step's gradient is evaluated where the last step left the
    parameters, so the per-step 1e-4 gradient error compounds)."""
    s = setup
    sched_args = dict(warmup_lr=0.02 / 3, warmup_iter=500)
    jsched = j_warmup(0.02, [60000, 80000], **sched_args)
    mask = j_freeze_mask(s["params"], FIXED)
    tx = j_make_optimizer(jsched, momentum=0.9, wd=1e-4, trainable_mask=mask)
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
        tl = trainer.step(torch.from_numpy(s["data"]),
                          torch.from_numpy(s["im_info"]),
                          torch.from_numpy(s["gt"]))
        assert rel_err(tl["total_loss"], jl["total_loss"]) <= 1e-4, i
    assert trainer.step_count == 3
    want = dict(_flat(jax.tree.map(np.asarray, state.params)))
    start = dict(_flat(s["params"]))
    got = trainer.model.state_dict()
    worst = 0.0
    for name, t in got.items():
        path = flax_path(name)
        g = t.numpy()
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)
        elif g.ndim == 2:
            g = g.T
        assert rel_err(g, want[path]) <= 1e-4, name
        moved = want[path] - start[path]
        if trainer.trainable[name]:
            assert np.abs(moved).max() > 0, name
            worst = max(worst, rel_err(g - start[path], moved))
        else:
            np.testing.assert_array_equal(g, start[path])
            assert not np.abs(moved).any(), name
    assert worst <= 1e-3, worst


# ------------------------------------------------------------- optimizer


def test_freeze_mask_matches_jax_on_flagship():
    """All 189 leaves of the flagship: the port's mask (through flax_path)
    equals the JAX freeze_mask, every bias frozen included."""
    from simpledet_tpu.core.config import load_config as j_load_config
    from simpledet_torch.dsl import build_detector

    spec = read_config(FLAGSHIP, is_train=True)
    model = build_detector(spec)
    jmodel = j_load_config(FLAGSHIP).get_config(is_train=True)[6]
    shapes = jax.eval_shape(lambda: jmodel.train_symbol.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros((1, 128, 160, 3)), jnp.asarray([[128, 160, 1.0]]),
        mode="test"))["params"]
    want = dict(_flat(j_freeze_mask(shapes, jmodel.pretrain.fixed_param)))
    got = {flax_path(k): v for k, v in freeze_mask(
        model, spec.fixed_param).items()}
    assert len(want) == len(got) == 189
    assert got == want
    assert not any(v for k, v in got.items() if k.endswith("/bias"))
    assert sum(got.values()) > 50


def test_make_optimizer_freezes_and_names_unported():
    model = torch.nn.Sequential(torch.nn.Linear(3, 3), torch.nn.Linear(3, 2))
    mask = {"0.weight": False, "0.bias": True, "1.weight": True,
            "1.bias": False}
    opt = make_optimizer(model, mask, lr=0.1)
    assert [p.requires_grad for p in model.parameters()] == [False, True,
                                                            True, False]
    assert sum(len(g["params"]) for g in opt.param_groups) == 2
    with pytest.raises(ValueError, match="rmsprop"):
        make_optimizer(model, mask, lr=0.1, opt_type="rmsprop")


@pytest.mark.parametrize("kind", ["gradual", "constant"])
def test_warmup_multifactor_matches(kind):
    """The flagship's schedule at the warmup and decay boundaries, within
    1e-6 relative (the JAX package computes the warmup line in float32)."""
    spec = read_config(FLAGSHIP, is_train=True)
    opt = spec.optimize
    args = (opt.optimizer.lr, opt.schedule.lr_iter)
    kw = dict(warmup_type=kind, warmup_lr=opt.warmup.lr,
              warmup_iter=opt.warmup.iter)
    got, want = warmup_multifactor(*args, **kw), j_warmup(*args, **kw)
    steps = [0, 250, 499, 500]
    for it in opt.schedule.lr_iter:
        steps += [it - 1, it, it + 1]
    for st in steps:
        w = float(want(jnp.int32(st)))
        assert abs(got(st) - w) <= 1e-6 * w, st
    assert got(0) == pytest.approx(0.02 / 3) and got(500) == 0.02
    assert got(80000) == pytest.approx(0.02 * 0.01)


def test_apply_dp_scaling_matches():
    for args in [(0.02, [60000, 80000], 500, 1, None, False),
                 (0.02, [-2000, 80000], 500, 4, 90000, True)]:
        assert apply_dp_scaling(*args) == j_dp_scaling(*args)


# ------------------------------------------------------------- full width


def test_flagship_train_config_reads():
    spec = read_config(FLAGSHIP, is_train=True)
    rpn = spec.components["rpn_head"].param
    assert spec.is_train and spec.batch_image == 2
    assert rpn.proposal.pre_nms_top_n == rpn.proposal.post_nms_top_n == 2000
    assert rpn.subsample_proposal.image_roi == 512
    assert spec.fixed_param == FIXED
    assert spec.optimize.optimizer.lr == pytest.approx(0.02)
    assert spec.optimize.schedule.lr_iter == [60000, 80000]


def test_flagship_trainer_step_on_cpu():
    """Torch only, full width at 128 x 160, batch 1: finite losses, the
    neck's weights get a gradient, frozen parameters do not move and the
    trained ones do."""
    from simpledet_torch.train import synthetic_train_batch

    trainer = Trainer.from_config(FLAGSHIP, device="cpu", seed=0)
    model = trainer.model
    assert model.training
    images, im_info, gt = synthetic_train_batch(1, 128, 160, 0)
    trainer.fold_batch_stats(images, im_info)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses = trainer.step(images, im_info, gt)
    assert set(losses) == {"bbox_cls_loss", "bbox_reg_loss", "rpn_cls_loss",
                           "rpn_reg_loss", "total_loss"}
    assert all(torch.isfinite(v) for v in losses.values())
    assert abs(float(losses["bbox_cls_loss"]) - np.log(81)) < 0.5
    assert abs(float(losses["rpn_cls_loss"]) - np.log(2)) < 0.2
    assert model.neck.P2_conv.weight.grad.abs().max() > 0
    assert model.neck.P2_lateral.bias.grad is None        # frozen: a bias
    after = model.state_dict()
    for name, frozen_before in before.items():
        if trainer.trainable[name]:
            assert not torch.equal(after[name], frozen_before), name
        else:
            assert torch.equal(after[name], frozen_before), name


# ------------------------------------------- adam, adamw, clip and lr_mode


def _tiny_trees(rng):
    """A two-layer model's params as torch modules and as the Flax tree of
    the same values, and 5 steps of random gradients for the Flax tree."""
    model = torch.nn.Sequential(torch.nn.Linear(6, 4), torch.nn.Linear(4, 3))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    tree = {str(i): {"kernel": m.weight.detach().numpy().T.copy(),
                     "bias": m.bias.detach().numpy().copy()}
            for i, m in enumerate(model)}
    grads = [jax.tree.map(lambda v: rng.randn(*v.shape).astype(np.float32),
                          tree) for _ in range(5)]
    return model, tree, grads


@pytest.mark.parametrize("opt_type,clip", [("adam", None), ("adam", 0.5),
                                           ("adamw", None), ("adamw", 0.5),
                                           ("sgd", 0.5)])
def test_optimizer_trajectory_matches_optax(opt_type, clip):
    """Five updates of Trainer.update against the JAX package's
    make_optimizer (optax) from the same params and gradients, with wd 0.01,
    a gradual warmup and the first layer's weight frozen: every leaf within
    1e-6 of its scale for sgd (float32 steps in another order) and 1e-5 for
    adam and adamw (optax computes the bias correction 1 - b2^t in float32,
    where 0.999 rounds to 0.99900001: 1.3e-5 off at t = 1, 6.4e-6 in its
    square root, on updates of the lr's size; measured 3.3e-6), the frozen
    leaf and nothing else bit-unchanged. clip is optax.clip, element-wise."""
    import optax

    rng = np.random.RandomState(21)
    model, tree, grads = _tiny_trees(rng)
    fixed = ("0/kernel",)
    sched_kw = dict(warmup_lr=0.01, warmup_iter=3)
    mask = j_freeze_mask(tree, fixed)
    tx = j_make_optimizer(j_warmup(0.05, [4], **sched_kw), opt_type=opt_type,
                          momentum=0.9, wd=0.01, clip_gradient=clip,
                          trainable_mask=mask)
    state, params = tx.init(tree), tree
    trainer = Trainer(model, schedule=warmup_multifactor(0.05, [4],
                                                         **sched_kw),
                      fixed_param=fixed, opt_type=opt_type, momentum=0.9,
                      wd=0.01, clip_gradient=clip)
    assert not trainer.trainable["0.weight"] and trainer.trainable["0.bias"]
    tol = 1e-6 if opt_type == "sgd" else 1e-5
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        for i, m in enumerate(model):
            m.weight.grad = torch.from_numpy(g[str(i)]["kernel"].T.copy())
            m.bias.grad = torch.from_numpy(g[str(i)]["bias"].copy())
        trainer.update()
    assert trainer.step_count == 5
    for i, m in enumerate(model):
        for leaf, t in (("kernel", m.weight.detach().numpy().T),
                        ("bias", m.bias.detach().numpy())):
            want = np.asarray(params[str(i)][leaf])
            assert rel_err(t, want) <= tol, (i, leaf)
            frozen = (i, leaf) == (0, "kernel")
            assert np.array_equal(want, tree[str(i)][leaf]) == frozen
            assert np.array_equal(t, tree[str(i)][leaf]) == frozen


@pytest.mark.parametrize("mode", ["cosine", "linear", "poly"])
def test_lr_mode_schedules_match(mode):
    """The schedule detection_train.py's train_net builds for lr_mode
    (warmup, then simpledet_tpu.core.schedule.advanced over the rest of the
    run, chained by sequential) against the port's from_optimize_param, at
    the warmup and decay boundaries: within 1e-6 of the base lr (the JAX
    package computes in float32)."""
    from simpledet_tpu.core.schedule import advanced as j_advanced
    from simpledet_tpu.core.schedule import sequential as j_sequential
    from simpledet_torch.core.schedule import from_optimize_param

    class OptimizeParam:
        class optimizer:
            lr = 0.02

        class schedule:
            end_epoch = 3
            lr_iter = [150]
            lr_mode = mode

        class warmup:
            type = "gradual"
            lr = 0.02 / 3
            iter = 40

    opt = patch_config_as_nothrow(OptimizeParam)
    got = from_optimize_param(opt, iter_per_epoch=100)
    total, warm = 300, 40
    want = j_sequential([j_warmup(0.02, [], warmup_lr=0.02 / 3,
                                  warmup_iter=warm),
                         j_advanced(0.02, total - warm, mode=mode)], [warm])
    for step in (0, 1, 20, 39, 40, 41, 150, 170, 298, 299, 300, 301, 400):
        w = float(want(jnp.int32(step)))
        assert abs(got(step) - w) <= 1e-6 * 0.02, step
    assert got(0) == pytest.approx(0.02 / 3) and got(40) == 0.02
    assert got(300) == pytest.approx(0.0, abs=1e-12)


@pytest.mark.parametrize("fixed,excluded", [
    (("conv0", "stage1", "scale", "bias"), ("stage1_unit2",)),
    (("backbone",), ("bn", "conv0")),
    (("stage",), ()),
])
def test_freeze_mask_takes_excluded_param_as_jax(fixed, excluded):
    """ModelParam.pretrain.excluded_param unfreezes what fixed_param froze,
    on all 189 leaves of the flagship, as the JAX freeze_mask does; the
    train config's spec carries it to the Trainer."""
    from simpledet_tpu.core.config import load_config as j_load_config
    from simpledet_torch.dsl import build_detector

    spec = read_config(FLAGSHIP, is_train=True)
    model = build_detector(spec)
    jmodel = j_load_config(FLAGSHIP).get_config(is_train=True)[6]
    shapes = jax.eval_shape(lambda: jmodel.train_symbol.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros((1, 128, 160, 3)), jnp.asarray([[128, 160, 1.0]]),
        mode="test"))["params"]
    want = dict(_flat(j_freeze_mask(shapes, fixed, excluded)))
    got = {flax_path(k): v for k, v in freeze_mask(model, fixed,
                                                   excluded).items()}
    assert got == want
    spec.excluded_param = excluded
    spec.fixed_param = fixed
    trainer = Trainer.from_spec(model, spec, 10)
    assert {flax_path(k): v for k, v in trainer.trainable.items()} == want
    if excluded:
        assert got != {flax_path(k): v for k, v in freeze_mask(
            model, fixed).items()}
