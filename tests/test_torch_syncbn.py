"""A from-scratch SyncBN detector: the port against jax.grad on the CPU.

The detector of tests/test_torch_train.py (depth-18 bottleneck ResNet, FPN
filters 64, 5 classes, 96 x 128 images, batch 2, `arange` sampling
priorities and `deterministic_proposals` on both sides) with a SyncBN
backbone instead of FrozenBN, nothing frozen, weights and running statistics
from the Flax init through the converter. Losses, every gradient (gamma and
beta included), the running statistics after a step, a 3-step SGD
trajectory and its `batch_stats`; then `.batch_stats` files byte for byte
both ways.

SyncBN's betas start at 3 (in units of the normalised activation): the two
sides' float32 activations differ by ulps, so a ReLU input within an ulp of
0 can fall on either side of it, and under batch statistics a flipped
position's gradient enters its channel's mean and variance terms and so
every position of the batch. At the init's beta 0 that moved backbone
leaves by up to 9e-2 of their max |grad| (1.05e-2 of the backbone's
gradient norm) while the neck, RPN and head stayed within 6e-5; at beta 3 a
ReLU input lies near 0 about 90 times less often. The per-layer formulas
are held at beta 0 in tests/test_torch_norm.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_tpu.core import checkpoint as jckpt
from simpledet_tpu.core.optimizer import make_optimizer as j_make_optimizer
from simpledet_tpu.core.schedule import warmup_multifactor as j_warmup
from simpledet_tpu.core.train import TrainState, make_train_step
from simpledet_tpu.models import fpn as jfpn
from simpledet_tpu.models import heads as jheads
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models.faster_rcnn import FasterRcnn as JFasterRcnn
from simpledet_tpu.models.norm import normalizer_factory as j_norm
from simpledet_tpu.models.rpn import FPNRpnHead as JRpnHead
from simpledet_tpu.ops.image import device_normalize as j_normalize
from simpledet_torch.core import checkpoint as ckpt
from simpledet_torch.core.schedule import warmup_multifactor
from simpledet_torch.core.train import Trainer
from simpledet_torch.models.faster_rcnn import FasterRcnn
from simpledet_torch.models.fpn import FPNNeck
from simpledet_torch.models.heads import Bbox2fcHead
from simpledet_torch.models.norm import SyncBN, normalizer_factory
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.rpn import FPNRpnHead, RpnConvHead
from simpledet_torch.ops.image import device_normalize
from simpledet_torch.weights import flax_path, from_flax
from test_torch_train import (B, FILTERS, H, MEAN, NUM_CLASS, SEED_KEY, STD,
                              W, jax_side, params_classes, rel_err)

jax_side = jax_side      # the fixture, used by name below
# Losses: float32 convs and statistics summed in other orders: 1e-5
# relative. Gradients: each leaf within 1e-4 of its own max |grad| (the bound
# of the FrozenBN detector, tests/test_torch_train.py).
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
BETA = 3.0


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _leaf(t):
    g = t.detach().numpy()
    if g.ndim == 4:
        return g.transpose(2, 3, 1, 0)
    return g.T if g.ndim == 2 else g


def torch_model(params, batch_stats, p_rpn, p_roi, p_bbox):
    backbone = ResNet(18, norm=normalizer_factory("syncbn"))
    trpn = FPNRpnHead(p_rpn)
    model = FasterRcnn(backbone, FPNNeck(backbone.out_channels, FILTERS),
                       RpnConvHead(trpn.num_anchor, FILTERS, FILTERS), trpn,
                       Bbox2fcHead(NUM_CLASS, NUM_CLASS, 49 * FILTERS),
                       p_roi, p_bbox, fixed_proposals=True,
                       deterministic_sampling=True)
    from_flax(params, model, batch_stats)
    return model.to(memory_format=torch.channels_last).train()


@pytest.fixture(scope="module")
def setup():
    p_rpn, p_roi, p_bbox = params_classes()
    p_rpn.dtype = jnp.float32
    jrpn = JRpnHead(p_rpn)
    jmodel = JFasterRcnn(
        backbone=jresnet.ResNet(depth=18, norm=j_norm("syncbn"),
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
    variables = jmodel.init({"params": jax.random.PRNGKey(0),
                             "sampling": jax.random.PRNGKey(1)},
                            jnp.zeros((B, H, W, 3)), jnp.asarray(im_info),
                            mode="test")
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    # the init's own EMA step from an all-zero input leaves mean 0, var 0.9:
    # give the statistics values of their own, so that a mixed-up leaf shows
    bs = jax.tree.map(lambda v: rng.uniform(0.5, 1.5, v.shape).astype(
        np.float32), to_np(variables["batch_stats"]))
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.full_like(v, BETA) if path[-1].key == "beta"
        else v, to_np(variables["params"]))
    return dict(jmodel=jmodel, params=params,
                batch_stats=bs, data=data, im_info=im_info, gt=gt,
                p=(p_rpn, p_roi, p_bbox))


@pytest.fixture(scope="module")
def jax_grads(setup, jax_side):
    s = setup
    data = j_normalize(jnp.asarray(s["data"]), jnp.asarray(s["im_info"]),
                       MEAN, STD)

    def loss_fn(params):
        (losses, aux), mut = s["jmodel"].apply(
            {"params": params, "batch_stats": s["batch_stats"]}, data,
            jnp.asarray(s["im_info"]), jnp.asarray(s["gt"]), mode="train",
            rngs={"sampling": SEED_KEY}, mutable=["batch_stats"])
        return sum(losses.values()), (losses, aux, mut["batch_stats"])

    (_, (losses, aux, bs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(s["params"])
    return tuple(jax.tree.map(np.asarray, t)
                 for t in (losses, aux, grads, bs))


@pytest.fixture(scope="module")
def torch_step(setup):
    s = setup
    model = torch_model(s["params"], s["batch_stats"], *s["p"])
    data = device_normalize(torch.from_numpy(s["data"]),
                            torch.from_numpy(s["im_info"]), MEAN, STD)
    losses, aux = model(data, torch.from_numpy(s["im_info"]),
                        torch.from_numpy(s["gt"]), mode="train",
                        generator=torch.Generator())
    sum(losses.values()).backward()
    return model, losses, aux


def test_syncbn_detector_losses_match(jax_grads, torch_step):
    want, want_aux, _, _ = jax_grads
    _, losses, aux = torch_step
    assert set(losses) == set(want)
    for k, v in want.items():
        assert rel_err(losses[k].detach(), v) <= LOSS_RTOL, k
    np.testing.assert_array_equal(aux["rpn_label"].numpy(),
                                  want_aux["rpn_label"])
    np.testing.assert_array_equal(aux["bbox_label"].numpy(),
                                  want_aux["bbox_label"])


def test_syncbn_detector_every_gradient_matches(jax_grads, torch_step):
    """Every parameter, SyncBN's gamma and beta included, within 1e-4 of
    its leaf's max |grad|; every leaf of jax.grad has one."""
    _, _, grads, _ = jax_grads
    model = torch_step[0]
    want = dict(_flat(grads))
    got = {flax_path(n): _leaf(p.grad) for n, p in model.named_parameters()}
    assert set(got) == set(want)
    assert sum(k.endswith("/gamma") for k in got) == 29
    # bn0's beta: its output reaches the loss only through the max-pool and
    # the 1x1 convolutions into batch norms of stage1_unit1, whose input
    # gradients sum to 0 over the batch, so its gradient is 0 up to rounding
    # (2e-8 here): held in absolute terms, within 1e-6 of the largest |grad|
    scale = max(np.abs(w).max() for w in want.values())
    assert np.abs(want["backbone/bn0/beta"]).max() <= 1e-6 * scale
    assert np.abs(got["backbone/bn0/beta"]).max() <= 1e-6 * scale
    errs = {k: rel_err(got[k], w) for k, w in want.items()
            if k != "backbone/bn0/beta"}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


def test_syncbn_detector_running_stats_after_a_step(jax_grads, torch_step):
    """The EMA of the batch mean and biased variance, every layer, within
    1e-5 of each leaf's max."""
    _, _, _, bs = jax_grads
    model = torch_step[0]
    got = dict(_flat(ckpt.batch_stats_to_flax(model)))
    want = dict(_flat(bs))
    assert set(got) == set(want) and len(got) == 58
    for k, w in want.items():
        assert rel_err(got[k], w) <= 1e-5, k


def test_syncbn_sgd_trajectory_and_batch_stats(setup, jax_side, tmp_path):
    """Three steps of Trainer against make_train_step with a batch_stats
    state (sgd, momentum 0.9, wd 1e-4, gradual warmup, nothing frozen):
    each step's loss within 1e-5, every parameter within 1e-4 of its scale
    (the FrozenBN detector's bounds) and every update within 1e-2 of its
    own, the running statistics within 1e-5; then the JAX
    package's checkpoint of that state, read by the port and written again,
    is the same bytes."""
    s = setup
    sched_args = dict(warmup_lr=0.02 / 3, warmup_iter=500)
    tx = j_make_optimizer(j_warmup(0.02, [60000], **sched_args),
                          momentum=0.9, wd=1e-4)
    state = TrainState.create(apply_fn=s["jmodel"].apply, params=s["params"],
                              tx=tx, batch_stats=s["batch_stats"])
    step = make_train_step(s["jmodel"], donate=False, pixel_norm=(MEAN, STD))
    batch = {k: jnp.asarray(s[k]) for k in ("data", "im_info")}
    batch["gt_bbox"] = jnp.asarray(s["gt"])
    trainer = Trainer(torch_model(s["params"], s["batch_stats"], *s["p"]),
                      schedule=warmup_multifactor(0.02, [60000],
                                                  **sched_args),
                      momentum=0.9, wd=1e-4, pixel_norm=(MEAN, STD))
    for i in range(3):
        state, jl, _ = step(state, batch, jax.random.fold_in(SEED_KEY, i))
        tl = trainer.step(*(torch.from_numpy(s[k])
                            for k in ("data", "im_info", "gt")))
        assert rel_err(tl["total_loss"], jl["total_loss"]) <= LOSS_RTOL, i
    want = dict(_flat(jax.tree.map(np.asarray, state.params)))
    start = dict(_flat(s["params"]))
    worst = ("", 0.0)
    for name, p in trainer.model.named_parameters():
        path = flax_path(name)
        g = _leaf(p)
        assert rel_err(g, want[path]) <= 1e-4, name
        err = rel_err(g - start[path], want[path] - start[path])
        worst = max(worst, (path, err), key=lambda t: t[1])
    # a leaf that feeds a batch norm has a gradient that is a sum over the
    # batch that mostly cancels (the norm takes out its mean), so the ulp
    # differences of the parameters after a step move it more than under
    # FrozenBN (1e-3 there): 1e-2 (measured: betas up to 3.6e-3, conv0's
    # kernel 1.4e-3, every other leaf under 1e-3)
    assert worst[1] <= 1e-2, worst
    want_bs = dict(_flat(jax.tree.map(np.asarray, state.batch_stats)))
    got_bs = dict(_flat(ckpt.batch_stats_to_flax(trainer.model)))
    for k, w in want_bs.items():
        assert rel_err(got_bs[k], w) <= 1e-5, k

    jprefix = str(tmp_path / "jax" / "checkpoint")
    jckpt.save_checkpoint(jprefix, 1, state.params,
                          batch_stats=state.batch_stats)
    model = torch_model(s["params"], s["batch_stats"], *s["p"])
    ckpt.load_checkpoint(jprefix, 1, model)
    assert ckpt.load_batch_stats(jprefix, 1, model)
    assert all(m.has_stats for m in model.modules() if isinstance(m, SyncBN))
    prefix = str(tmp_path / "port" / "checkpoint")
    ckpt.save_checkpoint(prefix, 1, model)
    for suffix in (".params", ".batch_stats"):
        with open(f"{jprefix}-0001{suffix}", "rb") as a, \
                open(f"{prefix}-0001{suffix}", "rb") as b:
            assert a.read() == b.read(), suffix


def test_port_batch_stats_read_by_the_jax_package(setup, tmp_path):
    """The port's `.batch_stats` of a SyncBN model: the JAX package's
    load_batch_stats restores every leaf bit for bit into its init's
    template, and flax writes the same bytes again."""
    import flax

    s = setup
    model = torch_model(s["params"], s["batch_stats"], *s["p"])
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SyncBN):
                m.mean.normal_()
                m.var.uniform_(0.5, 2.0)
    prefix = str(tmp_path / "checkpoint")
    ckpt.save_checkpoint(prefix, 3, model)
    assert os.path.exists(prefix + "-0003.batch_stats")
    got = jckpt.load_batch_stats(prefix, 3, s["batch_stats"])
    want = dict(_flat(ckpt.batch_stats_to_flax(model)))
    flat = dict(_flat(jax.tree.map(np.asarray, got)))
    assert set(flat) == set(want)
    for k, v in want.items():
        assert flat[k].dtype == v.dtype and np.array_equal(flat[k], v), k
    with open(prefix + "-0003.batch_stats", "rb") as f:
        assert flax.serialization.to_bytes(got) == f.read()


def test_frozenbn_model_writes_no_batch_stats(tmp_path):
    model = ResNet(18)
    prefix = str(tmp_path / "c")
    ckpt.save_checkpoint(prefix, 1, model)
    assert os.path.exists(prefix + "-0001.params")
    assert not os.path.exists(prefix + "-0001.batch_stats")
    assert not ckpt.load_batch_stats(prefix, 1, model)
