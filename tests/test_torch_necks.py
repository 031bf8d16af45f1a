"""RetinaNet's NAS-FPN, top-down / bottom-up, BN and SEPC necks and the BN
and SEPC heads in the port against the JAX package, on the CPU.

Each module runs on both sides from the same Flax params (kernels N(0,
1 / fan_in), FrozenBN folds of order one, SyncBN's betas at 3 as in
tests/test_torch_syncbn.py, the offset convs drawn so that offsets reach a
few cells) at widths of 24-40 channels, on the c3-c5 maps or the P3-P7
pyramid of 2 images: every output within 1e-5 of its scale and, for the
loss sum(out * gout), the inputs' and every parameter's gradient within
1e-4 of its max. Cases: NAS-FPN at 1 and 7 merge cells (no norm, as the
fixbn configs run it; odd map sides, where `_fit_hw` edge-pads) and at 3
with SyncBN (config/converge_nasfpn.py's), the top-down / bottom-up neck
at 3 rounds, the neck with FrozenBN (`RetinaNetNeckWithBN`), the subnets
with a FrozenBN per tower conv and level (`RetinaNetHeadWithBN`), SEPC in
the configs' four forms (pconv, pconv_ibn, sepclite, sepc; 1 PConv
module here, 2 for pconv, 4 in the configs) and its head. The premise of the
deformable cases, asserted: no offset within 1e-5 of an integer, where the
sampling's derivative jumps. Then iBN: in serving it normalises with the
batch's own statistics pooled over the levels (no running statistics),
and 2 gloo ranks of 1 image each equal 1 process of 2 images.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_tpu.models import nasfpn as jnas
from simpledet_tpu.models import retinanet as jretina
from simpledet_tpu.models import sepc as jsepc
from simpledet_tpu.models.norm import normalizer_factory as j_norm
import simpledet_torch.models.dcn as tdcn
from simpledet_torch.models.nasfpn import NASFPNNeck, TopDownBottomUpFPNNeck
from simpledet_torch.models.norm import normalizer_factory
from simpledet_torch.models.retinanet import RetinaNetNeck, RetinaSubnets
from simpledet_torch.models.sepc import IntegratedBN, SEPCFPN, SEPCSubnets
from simpledet_torch.parallel import dist
from simpledet_torch.weights import flax_leaf, flax_path, from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_RTOL, GRAD_RTOL = 1e-5, 1e-4
B, FILTERS = 2, 32
CIN = (24, 32, 40)
EVEN = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]       # 128 x 192
# 256 x 384: SyncBN's statistics over 12 values a channel on P7 (over 4,
# at 128 x 192, float32 differences come out 1e-5 of the output's scale)
LARGE = [(32, 48), (16, 24), (8, 12), (4, 6), (2, 3)]
ODD = [(13, 19), (7, 10), (4, 5), (2, 3), (1, 2)]        # 100 x 152
STRIDES = (8, 16, 32, 64, 128)


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


def _leaves(out):
    """The outputs in jax.tree's order: dict keys sorted, tuples in order."""
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [x for v in out for x in _leaves(v)]
    return [out]


def c_feats(rng, shapes):
    return {f"c{i + 3}": rng.randn(B, h, w, c).astype(np.float32)
            for i, ((h, w), c) in enumerate(zip(shapes[:3], CIN))}


def pyramid(rng, shapes, channels=FILTERS):
    return {f"stride{s}": rng.randn(B, h, w, channels).astype(np.float32)
            for s, (h, w) in zip(STRIDES, shapes)}


def seeded(shapes, rng, beta=None):
    """Kernels N(0, 1 / fan_in) (an offset conv's: offsets of about 1.5
    cells), biases N(0, 0.1), FrozenBN scales in [0.5, 1.5] and biases in
    [-0.2, 0.2], SyncBN and iBN gammas 1 and betas `beta`."""
    def leaf(path, s):
        keys = [p.key for p in path]
        name = keys[-1]
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "gamma":
            return np.ones(s.shape, np.float32)
        if name == "beta":
            return np.full(s.shape, beta, np.float32)
        if name == "bias":
            if any("norm" in k or k in ("bn",) for k in keys[-2:-1]):
                return rng.uniform(-0.2, 0.2, s.shape).astype(np.float32)
            return (rng.randn(*s.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        scale = 1.5 if "offset_conv" in keys else 1.0
        return (rng.randn(*s.shape) * scale / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _norm(kind):
    return None if kind is None else normalizer_factory(kind)


def _jnorm(kind):
    return None if kind is None else j_norm(kind)


def case(name):
    """(flax module, port module, inputs (NHWC numpy tree), SyncBN / iBN
    beta)."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name.startswith("nasfpn"):
        stages, norm, shapes = {"nasfpn1": (1, None, EVEN),
                                "nasfpn7": (7, None, ODD),
                                "nasfpn3_syncbn": (3, "syncbn", LARGE)}[name]
        return (jnas.NASFPNNeck(filters=FILTERS, num_stage=stages,
                                norm=_jnorm(norm)),
                NASFPNNeck(CIN, FILTERS, stages, norm=_norm(norm)),
                c_feats(rng, shapes), 3.0)
    if name == "tdbu3":
        return (jnas.TopDownBottomUpFPNNeck(filters=FILTERS, num_stage=3),
                TopDownBottomUpFPNNeck(CIN, FILTERS, 3), c_feats(rng, ODD),
                None)
    if name == "bn_neck":
        return (jretina.RetinaNetNeck(filters=FILTERS, norm=j_norm("fixbn")),
                RetinaNetNeck(CIN, FILTERS, norm=normalizer_factory("fixbn")),
                c_feats(rng, EVEN), None)
    if name == "subnets_bn":
        return (jretina.RetinaSubnets(num_anchor=9, num_fg_class=3,
                                      conv_channel=FILTERS,
                                      norm=j_norm("fixbn")),
                RetinaSubnets(9, 3, FILTERS, FILTERS,
                              norm=normalizer_factory("fixbn")),
                pyramid(rng, EVEN), None)
    if name == "sepc_subnets":
        return (jsepc.SEPCSubnets(num_anchor=9, num_fg_class=3),
                SEPCSubnets(9, 3, FILTERS), pyramid(rng, EVEN, 2 * FILTERS),
                None)
    # the configs' forms: (pconv_deform, lcconv_deform, ibn)
    pconv_deform, lcconv_deform, ibn = {
        "sepc_pconv": (False, False, False),
        "sepc_pconv_ibn": (False, False, True),
        "sepc_sepclite": (False, True, True),
        "sepc": (True, True, True)}[name]
    n = 2 if name == "sepc_pconv" else 1
    return (jsepc.SEPCFPN(filters=FILTERS, pconv_num=n,
                          pconv_deform=pconv_deform,
                          lcconv_deform=lcconv_deform, ibn=ibn),
            SEPCFPN(FILTERS, n, pconv_deform, lcconv_deform, ibn),
            pyramid(rng, ODD if name == "sepc" else EVEN), 0.5)


CASES = ["nasfpn1", "nasfpn7", "nasfpn3_syncbn", "tdbu3", "bn_neck",
         "subnets_bn", "sepc_pconv", "sepc_pconv_ibn", "sepc_sepclite",
         "sepc", "sepc_subnets"]


def record_offsets(monkeypatch):
    """The offsets every deformable conv of the port samples with."""
    seen = []
    real = tdcn.deform_conv2d

    def recording(x, offset, *a, **kw):
        seen.append(offset.detach().numpy())
        return real(x, offset, *a, **kw)

    monkeypatch.setattr(tdcn, "deform_conv2d", recording)
    return seen


@pytest.mark.parametrize("name", CASES)
def test_module_matches_flax(name, monkeypatch):
    jmod, tmod, x, beta = case(name)
    rng = np.random.RandomState(1)
    xj = jax.tree.map(jnp.asarray, x)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), xj)
    params = seeded(shapes["params"], rng, beta)
    out_shapes = jax.eval_shape(lambda: jmod.apply({"params": params}, xj))
    gout = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32),
                        out_shapes)

    def loss(p, xx):
        out = jmod.apply({"params": p}, xx)
        return sum(jnp.sum(o * g) for o, g in zip(
            jax.tree.leaves(out), jax.tree.leaves(gout))), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, xj)

    offsets = record_offsets(monkeypatch)
    from_flax(params, tmod)
    tmod.train()
    tx = {k: _nchw(v).requires_grad_() for k, v in x.items()}
    got = tmod(tx)
    got_leaves, want_leaves = _leaves(got), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves) > 0
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == _nchw(np.asarray(w)).shape
        assert rel_err(g.detach().permute(0, 2, 3, 1), w) <= OUT_RTOL
    sum((g * _nchw(np.asarray(o))).sum()
        for g, o in zip(got_leaves, jax.tree.leaves(gout))).backward()
    for k, v in tx.items():
        assert rel_err(v.grad.permute(0, 2, 3, 1), gx[k]) <= GRAD_RTOL, k
    want_g = dict(_flat(gp))
    got_g = {flax_path(n): flax_leaf(n, p.grad.numpy())
             for n, p in tmod.named_parameters()}
    assert set(got_g) == {k for k in want_g if not k.endswith("/scale")
                          and not (k.endswith("/bias")
                                   and "norm" in k.split("/")[-2])}
    # a conv bias that a norm follows on every position it reaches (SyncBN
    # after a NAS node, iBN after SEPC's sepc1 or CConv) has a zero
    # gradient (the norm takes the mean out): where jax.grad's is zero up
    # to rounding (1e-6 of the largest |grad|), the port's is too (1e-5)
    largest = max(np.abs(v).max() for v in want_g.values())
    zero = {k for k, v in want_g.items() if k in got_g
            and np.abs(v).max() <= 1e-6 * largest}
    for k in zero:
        assert np.abs(got_g[k]).max() <= 1e-5 * largest, k
    assert all(k.endswith("/bias") for k in zero), zero
    errs = {k: rel_err(g, want_g[k]) for k, g in got_g.items()
            if k not in zero}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    deformable = name in ("sepc_sepclite", "sepc")
    assert bool(offsets) == deformable
    if deformable:
        off = np.concatenate([o.ravel() for o in offsets])
        assert np.abs(off).max() > 1.0
        assert np.abs(off - np.round(off)).min() > 1e-5


def test_sepc_holds_only_the_layers_its_levels_use():
    """As Flax's lazily made submodules: with pconv_deform, sepc2 (stride 2,
    levels 1-4) is deformable only, sepc0 (levels 0-3) and sepc1 hold both;
    without it, plain convs only."""
    full = SEPCFPN(FILTERS, 1, True, True, True)
    names = {n.rsplit(".", 1)[0] for n, _ in full.named_parameters()}
    assert {"PConv0.sepc2.dconv", "PConv0.sepc0.conv", "PConv0.sepc0.dconv",
            "CConv.conv", "CConv.dconv"} <= names
    assert "PConv0.sepc2.conv" not in names
    plain = SEPCFPN(FILTERS, 1)
    assert not [n for n, _ in plain.named_parameters() if "dconv" in n]


def test_ibn_serves_on_the_batch_statistics():
    """iBN keeps no running statistics: in eval mode as in train mode it
    normalises with the mean and biased variance pooled over every level
    and image it is given, gamma and beta applied after."""
    rng = np.random.RandomState(4)
    levels = [rng.randn(B, 8, h, w).astype(np.float32) * 3 + 1
              for h, w in EVEN]
    ibn = IntegratedBN(8)
    with torch.no_grad():
        ibn.gamma.copy_(torch.linspace(0.5, 2.0, 8))
        ibn.beta.copy_(torch.linspace(-1.0, 1.0, 8))
    assert set(ibn.state_dict()) == {"gamma", "beta"}
    flat = np.concatenate([lv.transpose(0, 2, 3, 1).reshape(-1, 8)
                           for lv in levels]).astype(np.float64)
    mean, var = flat.mean(0), flat.var(0)
    for mode in (True, False):
        ibn.train(mode)
        with torch.no_grad():
            out = ibn([torch.from_numpy(lv) for lv in levels])
        for o, lv in zip(out, levels):
            want = ((lv - mean[:, None, None]) / np.sqrt(
                var[:, None, None] + 1e-5)
                * ibn.gamma.detach().numpy()[:, None, None]
                + ibn.beta.detach().numpy()[:, None, None])
            assert rel_err(o.numpy(), want) <= 1e-5
    # one image alone gets other statistics than the batch of two
    with torch.no_grad():
        alone = ibn([torch.from_numpy(lv[:1]) for lv in levels])
    assert rel_err(alone[0].numpy(), out[0][:1].numpy()) > 1e-3


def test_ibn_sums_its_statistics_over_a_2_rank_group(tmp_path):
    """A deformable PConv module with iBN: 2 gloo ranks of 1 image each
    (`tests/ibn_ranks.py`) against 1 process of both: each rank's outputs
    and input gradients are the one process's rows (within 1e-5 and 1e-4),
    and the ranks' parameter gradients sum to the one process's (1e-4 of
    each leaf's max), iBN's gamma and beta among them."""
    import ibn_ranks

    code = ("import sys; sys.path.insert(0, {!r}); import ibn_ranks; "
            "ibn_ranks.rank_main({!r})").format(
                os.path.join(REPO, "tests"), str(tmp_path))
    dist.launch_local(code, 2, env={"PYTHONPATH": REPO})
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    single = ibn_ranks.run([0, 1])
    assert [r["world"] for r in ranks] == [2, 2]
    for r, res in enumerate(ranks):
        for got, want in zip(res["outs"], single["outs"]):
            assert rel_err(got.numpy(), want[r:r + 1].numpy()) <= 1e-5
        for got, want in zip(res["x_grads"], single["x_grads"]):
            assert rel_err(got.numpy(), want[r:r + 1].numpy()) <= 1e-4
    assert "ibn.gamma" in single["grads"]
    for name, want in single["grads"].items():
        got = ranks[0]["grads"][name] + ranks[1]["grads"][name]
        assert rel_err(got.numpy(), want.numpy()) <= 1e-4, name
    # a rank's own statistics would give other outputs
    alone = ibn_ranks.run([0])
    assert rel_err(alone["outs"][0].numpy(),
                   single["outs"][0][:1].numpy()) > 1e-3
