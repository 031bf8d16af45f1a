"""Faster R-CNN's PAFPN and FPG necks and the Double-Head box head in the
port against the JAX package, on the CPU.

Each module runs on both sides from the same Flax params (kernels N(0,
1 / fan_in), biases N(0, 0.1), SyncBN's gammas 1 and betas 3, as in
tests/test_torch_necks.py: a relu meets every norm's output, and betas at 3
keep its inputs off 0, where float32 rounding would flip its gradient), 32
wide with 2 stages, on the c2-c5 maps of 2 images: every output within
1e-5 of its scale and, for the loss sum(out * gout), the inputs' and every
parameter's gradient within 1e-4 of its max. Necks: PAFPN on P2-P6 with
SyncBN and on P3-P7 without a norm, FPG on P2-P6 without one and on P3-P7
with SyncBN (at 256 x 384, so that SyncBN's statistics on P7 take 12
values a channel). Box head: `BboxDualHeadSmall` on 2 x 6 rois of 7 x 7 x
32, without a norm (the config's fixbn) and with SyncBN after each fc
layer and conv. Then the DSL's wrappers: the FPG configs, named syncbn,
call their template with its fixbn default, so their necks build without
a norm in both packages.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_tpu.models import fpg as jfpg
from simpledet_tpu.models import heads as jheads
from simpledet_tpu.models.norm import normalizer_factory as j_norm
from simpledet_torch.core.config import read_config
from simpledet_torch.dsl import build_detector
from simpledet_torch.models.fpg import LEVELS_P3P7, FPGNeck, PAFPNNeck
from simpledet_torch.models.heads import BboxDualHeadSmall
from simpledet_torch.models.norm import SyncBN, normalizer_factory
from simpledet_torch.weights import flax_leaf, flax_path, from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_RTOL, GRAD_RTOL = 1e-5, 1e-4
B, FILTERS, STAGES = 2, 32, 2
CIN = (16, 24, 32, 40)
SMALL = [(32, 48), (16, 24), (8, 12), (4, 6)]           # 128 x 192
LARGE = [(64, 96), (32, 48), (16, 24), (8, 12)]         # 256 x 384


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


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def seeded(shapes, rng):
    def leaf(path, s):
        name = path[-1].key
        if name == "gamma":
            return np.ones(s.shape, np.float32)
        if name == "beta":
            return np.full(s.shape, 3.0, np.float32)
        if name == "bias":
            return (rng.randn(*s.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jnorm(kind):
    return None if kind is None else j_norm(kind)


def _norm(kind):
    return None if kind is None else normalizer_factory(kind)


# name -> (flax class, port class, levels, norm, map sizes)
NECKS = {
    "pafpn_p2p6_syncbn": (jfpg.PAFPNNeckP2P6, PAFPNNeck, None, "syncbn",
                          SMALL),
    "pafpn_p3p7": (jfpg.PAFPNNeckP3P7, PAFPNNeck, LEVELS_P3P7, None, SMALL),
    "fpg_p2p6": (jfpg.FPGNeckP2P6, FPGNeck, None, None, SMALL),
    "fpg_p3p7_syncbn": (jfpg.FPGNeckP3P7, FPGNeck, LEVELS_P3P7, "syncbn",
                        LARGE),
}


def check_grads(gp, module, zero_ok=False):
    """Every parameter's gradient of `module` within 1e-4 of its Flax
    leaf's max |grad|; the Flax leaves without a port parameter are
    FrozenBN's (none here)."""
    want = dict(_flat(gp))
    got = {flax_path(n): flax_leaf(n, p.grad.numpy())
           for n, p in module.named_parameters()}
    assert set(got) == set(want)
    largest = max(np.abs(v).max() for v in want.values())
    errs = {}
    for k, g in got.items():
        if zero_ok and np.abs(want[k]).max() <= 1e-6 * largest:
            # a conv bias that SyncBN follows: the norm takes its mean out
            assert k.endswith("/bias") and np.abs(g).max() <= 1e-5 * largest
            continue
        errs[k] = rel_err(g, want[k])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


@pytest.mark.parametrize("name", sorted(NECKS))
def test_neck_matches_flax(name):
    jcls, tcls, levels, norm, sizes = NECKS[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    x = {f"c{i + 2}": rng.randn(B, h, w, c).astype(np.float32)
         for i, ((h, w), c) in enumerate(zip(sizes, CIN))}
    jmod = jcls(filters=FILTERS, num_stage=STAGES, norm=_jnorm(norm))
    xj = jax.tree.map(jnp.asarray, x)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), xj)["params"]
    params = seeded(shapes, rng)
    out_shapes = jax.eval_shape(lambda: jmod.apply({"params": params}, xj))
    gout = {k: rng.randn(*s.shape).astype(np.float32)
            for k, s in out_shapes.items()}

    def loss(p, xx):
        out = jmod.apply({"params": p}, xx)
        return sum(jnp.sum(out[k] * gout[k]) for k in out), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, xj)

    kw = {"levels": levels} if levels else {}
    tmod = tcls(CIN, FILTERS, STAGES, norm=_norm(norm), **kw)
    from_flax(params, tmod)
    tmod.train()
    tx = {k: _nchw(v).requires_grad_() for k, v in x.items()}
    got = tmod(tx)
    assert set(got) == set(want) and len(got) == 5
    first = "stride8" if levels else "stride4"
    assert first in got
    for k, w in want.items():
        assert rel_err(got[k].detach().permute(0, 2, 3, 1), w) <= OUT_RTOL, k
    sum((got[k] * _nchw(gout[k])).sum() for k in got).backward()
    for k, v in tx.items():
        if levels and k == "c2":        # P3-P7 read no c2
            assert v.grad is None
            continue
        assert rel_err(v.grad.permute(0, 2, 3, 1), gx[k]) <= GRAD_RTOL, k
    check_grads(gp, tmod, zero_ok=norm is not None)
    assert any(isinstance(m, SyncBN) for m in tmod.modules()) == bool(norm)


@pytest.mark.parametrize("norm", [None, "syncbn"])
def test_dual_head_matches_flax(norm):
    rng = np.random.RandomState(5)
    feat = rng.randn(B, 6, 7, 7, FILTERS).astype(np.float32)
    jhead = jheads.BboxDualHeadSmall(num_class=5, num_reg_class=5,
                                     num_block=2, norm=_jnorm(norm))
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0),
                            jnp.asarray(feat))["params"]
    params = seeded(shapes, rng)
    g_cls = rng.randn(B, 6, 5).astype(np.float32)
    g_reg = rng.randn(B, 6, 20).astype(np.float32)

    def loss(p, x):
        cls, reg = jhead.apply({"params": p}, x)
        return jnp.sum(cls * g_cls) + jnp.sum(reg * g_reg), (cls, reg)

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(feat))
    head = BboxDualHeadSmall(5, 5, FILTERS, 7, num_block=2, norm=_norm(norm))
    from_flax(params, head)
    head.train()
    x = torch.from_numpy(feat).requires_grad_()
    cls, reg = head(x)
    assert rel_err(cls.detach(), want[0]) <= OUT_RTOL
    assert rel_err(reg.detach(), want[1]) <= OUT_RTOL
    ((cls * torch.from_numpy(g_cls)).sum()
     + (reg * torch.from_numpy(g_reg)).sum()).backward()
    assert rel_err(x.grad, gx) <= GRAD_RTOL
    check_grads(gp, head, zero_ok=norm is not None)


@pytest.mark.parametrize("config,neck,width,stages", [
    ("config/FPG/faster_r50v1b_fpg6_256_syncbn_1x.py", FPGNeck, 256, 6),
    ("config/FPG/faster_r50v1b_fpg6_128_syncbn_1x.py", FPGNeck, 128, 6),
    ("config/FPG/faster_r50v1b_pafpn3_384_syncbn_1x.py", PAFPNNeck, 384, 3),
    ("config/FPG/faster_r50v1b_pafpn3_256_syncbn_1x.py", PAFPNNeck, 256, 3)])
def test_fpg_configs_build_without_a_neck_norm(config, neck, width, stages):
    """The config's train detector: the neck `dim_reduced` wide with
    `num_stage` stages on P2-P6 and no norm (the template's fixbn), the
    RPN head and the box head taking its width, as the JAX DSL builds
    them (`_NeckWrapper` adds a norm only for syncbn, localbn or gn)."""
    spec = read_config(os.path.join(REPO, config), is_train=True)
    assert spec.components["neck"].param.normalizer.type == "fixbn"
    with torch.device("meta"):
        model = build_detector(spec, depth=18)
    assert type(model.neck) is neck and model.neck.num_stage == stages
    assert model.neck.levels[0] == "P2"
    assert not any(isinstance(m, SyncBN) or "bn" in n.split(".")[-1]
                   for n, m in model.neck.named_modules())
    assert model.neck.S0_P3.out_channels == width
    assert model.rpn_module.rpn_conv.in_channels == width
    assert model.bbox_head.fc1.in_features == 49 * width
