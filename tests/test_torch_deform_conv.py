"""The port's deformable convolution and DCN modules against the JAX package,
on the CPU.

- `ops/deform_conv.py::deform_conv2d` against `batched_deform_conv2d` at
  stride 1 and 2 on even and odd sides, 1 and 4 deformable groups, v1 and
  v2 (a post-sigmoid mask), dilation 1 and 2 (every pair of these values in
  8 cases), on random offsets of a few
  cells: the output within 1e-5 of its scale, the gradients in x, the
  offsets, the mask, the kernel and the bias within 1e-4 of their max.
  The premise, asserted: some taps sample outside the map (the zero
  padding of each corner is exercised) and no tap lies within 1e-3 of an
  integer position (where the bilinear weights' derivative jumps).
- `DeformConv` (v1, v2, with a bias) and both DCN bottlenecks at stride 1
  and 2 on even sides, where the offset conv pads as Flax's SAME, (0, 1),
  and the deformable conv (1, 1): from the same Flax params with nonzero
  offset-conv kernels (Flax's zero init hides the sampling): outputs within
  1e-5, gradients within 1e-4.
- The DCN hybrid ResNets (FPN: stage 5's first unit a strided deformable
  unit; C4: stages 1-3 under `backbone/inner`) at depth 18.
- The seeded init of the new modules against Flax's, leaf by leaf: the same
  constants, and for each drawn kernel the same family and scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_tpu.models import dcn as jdcn
from simpledet_tpu.models import nasfpn as jnas
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models import retinanet as jretina
from simpledet_tpu.models import sepc as jsepc
from simpledet_tpu.models.norm import normalizer_factory as j_norm
from simpledet_tpu.ops.deform_conv import batched_deform_conv2d
from simpledet_torch.models.dcn import (C4StrideKeyAdapter, DCNBottleneck,
                                        DCNv2Bottleneck, DeformConv)
from simpledet_torch.models.nasfpn import NASFPNNeck, TopDownBottomUpFPNNeck
from simpledet_torch.models.norm import normalizer_factory
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.retinanet import RetinaSubnets
from simpledet_torch.models.sepc import SEPCFPN, SEPCSubnets
from simpledet_torch.ops.deform_conv import deform_conv2d
from simpledet_torch.weights import flax_leaf, flax_path, from_flax

OUT_RTOL, GRAD_RTOL = 1e-5, 1e-4


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


def sample_positions(offset, h, w, oh, ow, stride, dilation, g, k=3):
    """(y, x) of every tap, as deform_conv2d computes them (float64)."""
    pad = dilation * (k - 1) // 2
    off = offset.reshape(offset.shape[0], oh, ow, g, k * k, 2)
    ky, kx = np.meshgrid(np.arange(k) * dilation, np.arange(k) * dilation,
                         indexing="ij")
    y = (np.arange(oh)[:, None, None, None] * stride - pad
         + ky.reshape(-1)) + off[..., 0]
    x = (np.arange(ow)[None, :, None, None] * stride - pad
         + kx.reshape(-1)) + off[..., 1]
    return y, x


def assert_premise(y, x, h, w):
    """Some taps outside the map; none within 1e-3 of an integer."""
    outside = (y < 0) | (y > h - 1) | (x < 0) | (x > w - 1)
    assert 0.02 < outside.mean() < 0.6
    frac = np.concatenate([np.abs(y - np.round(y)).ravel(),
                           np.abs(x - np.round(x)).ravel()])
    assert frac.min() > 1e-3


def clear_offsets(rng, shape, scale):
    """Normal offsets of `scale` cells, nudged off integer positions: the
    base grid is integral, so an offset within 2e-3 of an integer moves."""
    off = rng.randn(*shape) * scale
    near = np.abs(off - np.round(off)) < 2e-3
    return np.where(near, off + 0.01, off).astype(np.float32)


# ----------------------------------------------------------- the operator


# every pair of (stride, side, groups, v1 / v2, dilation) values in 8 cases
# (the L8 orthogonal array's first five columns)
OP_CASES = [(1, (10, 12), 1, False, 1), (1, (10, 12), 1, True, 2),
            (1, (9, 11), 4, False, 1), (1, (9, 11), 4, True, 2),
            (2, (10, 12), 4, False, 2), (2, (10, 12), 4, True, 1),
            (2, (9, 13), 1, False, 2), (2, (9, 13), 1, True, 1)]


@pytest.mark.parametrize(
    "stride,hw,groups,modulated,dilation", OP_CASES,
    ids=[f"s{s}{'odd' if hw[0] % 2 else 'even'}-g{g}-v{2 if m else 1}-d{d}"
         for s, hw, g, m, d in OP_CASES])
def test_deform_conv2d_matches_jax(stride, hw, groups, modulated, dilation):
    h, w = hw
    b, c, f, k = 2, 8, 6, 3
    pad = dilation * (k - 1) // 2
    oh = (h + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    ow = (w + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    rng = np.random.RandomState(h * 100 + w + groups + 7 * dilation)
    x = rng.randn(b, h, w, c).astype(np.float32)
    off = clear_offsets(rng, (b, oh, ow, 2 * groups * k * k), 2.5)
    y, xs = sample_positions(off, h, w, oh, ow, stride, dilation, groups)
    assert_premise(y, xs, h, w)
    mask = (rng.uniform(0.1, 0.9, (b, oh, ow, groups * k * k))
            .astype(np.float32) if modulated else None)
    wt = (rng.randn(k, k, c, f) / np.sqrt(9 * c)).astype(np.float32)
    bias = rng.randn(f).astype(np.float32)
    gout = rng.randn(b, oh, ow, f).astype(np.float32)

    def jax_loss(x_, o_, w_, b_, m_):
        out = batched_deform_conv2d(
            x_, o_, w_, stride=stride, dilation=dilation,
            num_deformable_group=groups, bias=b_,
            **({"mask": m_} if modulated else {}))
        return jnp.sum(out * gout), out

    args = [jnp.asarray(a) for a in (x, off, wt, bias)] + [
        jnp.asarray(mask) if modulated else jnp.zeros(())]
    (_, want), grads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*args)
    tx, toff = _nchw(x).requires_grad_(), _nchw(off).requires_grad_()
    tw = _t(wt.transpose(3, 2, 0, 1)).requires_grad_()
    tb = _t(bias).requires_grad_()
    tm = _nchw(mask).requires_grad_() if modulated else None
    got = deform_conv2d(tx, toff, tw, stride=stride, dilation=dilation,
                        num_deformable_group=groups, mask=tm, bias=tb)
    assert got.shape == (b, f, oh, ow)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert rel_err(_nhwc(got), want) <= OUT_RTOL
    (got * _nchw(gout)).sum().backward()
    pairs = [(tx.grad.permute(0, 2, 3, 1), grads[0]),
             (toff.grad.permute(0, 2, 3, 1), grads[1]),
             (tw.grad.permute(2, 3, 1, 0), grads[2]), (tb.grad, grads[3])]
    if modulated:
        pairs.append((tm.grad.permute(0, 2, 3, 1), grads[4]))
    for i, (g, want_g) in enumerate(pairs):
        assert rel_err(g.numpy(), want_g) <= GRAD_RTOL, i


def test_zero_offsets_are_a_plain_conv():
    """v1 with zero offsets is the symmetric-padded conv; v2 with zero mask
    logits is half of it (the sigmoid's 0.5): the layer's start at Flax's
    zero init."""
    rng = np.random.RandomState(3)
    x = _nchw(rng.randn(2, 10, 12, 8).astype(np.float32))
    wt = _t(rng.randn(6, 8, 3, 3).astype(np.float32))
    for stride in (1, 2):
        plain = torch.nn.functional.conv2d(x, wt, stride=stride, padding=1)
        off = torch.zeros(2, 18, *plain.shape[2:])
        got = deform_conv2d(x, off, wt, stride=stride)
        assert rel_err(got.numpy(), plain.numpy()) <= OUT_RTOL
        half = deform_conv2d(x, off, wt, stride=stride,
                             mask=torch.full((2, 9, *plain.shape[2:]), 0.5))
        assert rel_err(half.numpy(), 0.5 * plain.numpy()) <= OUT_RTOL


# ----------------------------------------------------------- the modules


def _nonzero_offset_convs(params, rng, scale):
    """Every `offset_conv` kernel drawn so that the offsets reach `scale`
    cells (and v2's mask logits about one): Flax's zero init would make the
    layer a plain conv."""
    def leaf(path, v):
        keys = [p.key for p in path]
        if "offset_conv" in keys and keys[-1] == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            return (rng.randn(*v.shape) * scale / np.sqrt(fan_in)).astype(
                np.float32)
        if "offset_conv" in keys and keys[-1] == "bias":
            return (rng.randn(*v.shape) * 0.3).astype(np.float32)
        return np.asarray(v)
    return jax.tree_util.tree_map_with_path(leaf, params)


def _check_grads(model, grads):
    want = dict(_flat(grads))
    errs = {n: rel_err(flax_leaf(n, p.grad.numpy()), want[flax_path(n)])
            for n, p in model.named_parameters()}
    assert set(flax_path(n) for n in errs) == {
        k for k in want if not k.endswith("/scale")
        and not (k.endswith("/bias") and "bn" in k.split("/")[-2])}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


def _compare(jmod, tmod, x, params, premise=None):
    """Outputs within 1e-5 and every parameter's and the input's gradient
    within 1e-4 of its max, for the loss sum(out * gout)."""
    rng = np.random.RandomState(11)

    def loss(p, xx):
        out = jmod.apply({"params": p}, xx)
        return jnp.sum(out * gout), out

    out_shape = jax.eval_shape(lambda: jmod.apply({"params": params},
                                                  jnp.asarray(x))).shape
    gout = rng.randn(*out_shape).astype(np.float32)
    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    from_flax(params, tmod)
    tx = _nchw(x).requires_grad_()
    got = tmod(tx)
    assert rel_err(_nhwc(got), want) <= OUT_RTOL
    (got * _nchw(gout)).sum().backward()
    assert rel_err(tx.grad.permute(0, 2, 3, 1).numpy(), gx) <= GRAD_RTOL
    _check_grads(tmod, gp)
    return tmod


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
def test_deform_conv_module_matches_flax(modulated, stride):
    """DeformConv with a bias, 4 groups, on an even 10 x 12 map: at stride
    2 the offset conv pads (0, 1) as Flax's SAME does and the deformable
    conv (1, 1), on the offset map's 5 x 6 grid."""
    jmod = jdcn.DeformConv(8, kernel=3, stride=stride,
                           num_deformable_group=4, modulated=modulated,
                           use_bias=True)
    rng = np.random.RandomState(stride + 2 * modulated)
    x = rng.randn(2, 10, 12, 16).astype(np.float32)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x))["params"])
    assert not np.any(params["offset_conv"]["kernel"])
    params = _nonzero_offset_convs(params, rng, 2.0)
    params["bias"] = rng.randn(8).astype(np.float32)
    tmod = DeformConv(16, 8, 3, stride, num_deformable_group=4,
                      modulated=modulated, use_bias=True)
    _compare(jmod, tmod, x, params)
    with torch.no_grad():
        offset, mask = tmod.offsets(_nchw(x))
    assert offset.shape == (2, 72, 10 // stride, 12 // stride)
    assert float(offset.abs().max()) > 2.0
    assert (mask is None) == (not modulated)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
def test_dcn_bottleneck_matches_flax(modulated, stride):
    """The DCN bottleneck (32 -> 16 x 4 channels, projection shortcut,
    FrozenBN with random folds) with nonzero offsets: leaves conv1 / bn1,
    conv2 (offset_conv, kernel), bn2, conv3 / bn3, sc_conv / sc_bn."""
    cls = jdcn.DCNv2Bottleneck if modulated else jdcn.DCNBottleneck
    jmod = cls(filters=16, stride=stride, norm=j_norm("fixbn"))
    rng = np.random.RandomState(5 + stride)
    x = rng.randn(2, 10, 12, 32).astype(np.float32)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x))["params"])
    params = _nonzero_offset_convs(params, rng, 2.0)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if p[-1].key == "scale" else v, params)
    assert set(params["conv2"]) == {"offset_conv", "kernel"}
    tcls = DCNv2Bottleneck if modulated else DCNBottleneck
    tmod = tcls(32, 16, stride, torch.float32, normalizer_factory("fixbn"))
    _compare(jmod, tmod, x, params)


@pytest.mark.parametrize("kind", ["fpn", "c4"])
def test_dcn_hybrid_resnet_matches_flax(kind):
    """Depth 18 (two units a stage): FPN with num_c4_block = num_c5_block =
    3, so every unit of stages 4 and 5 is deformable and stage 5's first
    one strided (config/dcn/faster_dcn_r50v1b_fpn_1x.py); C4 (DCNv2, three
    stages) under `inner`, c4 published as stride16. Features within 1e-5
    of their scale, on a 2 x 64 x 96 batch."""
    norm = j_norm("fixbn")
    if kind == "fpn":
        jmod = jresnet.ResNet(depth=18, variant="v1b", norm=norm,
                              num_special=(0, 0, 3, 3),
                              special_block=jdcn.DCNBottleneck,
                              name="backbone")
        tmod = ResNet(18, norm=normalizer_factory("fixbn"), variant="v1b",
                      num_special=(0, 0, 3, 3), special_block=DCNBottleneck)
    else:
        jmod = jdcn.C4StrideKeyAdapter(inner=jresnet.ResNet(
            depth=18, variant="v1b", norm=norm, num_stages=3,
            num_special=(0, 0, 3, 0), special_block=jdcn.DCNv2Bottleneck))
        tmod = C4StrideKeyAdapter(ResNet(
            18, norm=normalizer_factory("fixbn"), variant="v1b",
            num_stages=3, num_special=(0, 0, 3, 0),
            special_block=DCNv2Bottleneck))
    rng = np.random.RandomState(9)
    x = rng.randn(2, 64, 96, 3).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]

    def seeded(path, v):
        """Kernels N(0, 1 / fan_in), FrozenBN folds of order one."""
        if path[-1].key == "scale":
            return rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
        if path[-1].key == "bias":
            return rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
        return (rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
                ).astype(np.float32)

    params = _nonzero_offset_convs(
        jax.tree_util.tree_map_with_path(seeded, shapes), rng, 1.5)
    want = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    from_flax(params, tmod)
    with torch.no_grad():
        got = tmod(_nchw(x))
    keys = ("c2", "c3", "c4", "c5") if kind == "fpn" else ("c2", "c3", "c4",
                                                           "stride16")
    assert set(got) == set(want) == set(keys)
    for k in keys:
        assert rel_err(_nhwc(got[k]), want[k]) <= OUT_RTOL, k
    units = dict(tmod.named_modules())
    deform = sorted(n for n, m in units.items()
                    if isinstance(m, DCNBottleneck))
    if kind == "fpn":
        assert deform == ["stage3_unit1", "stage3_unit2", "stage4_unit1",
                          "stage4_unit2"]
        assert units["stage4_unit1"].conv2.stride == 2
    else:
        assert deform == ["inner.stage3_unit1", "inner.stage3_unit2"]
        assert tmod.out_channels == 1024


# ----------------------------------------------------------------- init


def _leaf_stats(v):
    """mean, std and kurtosis (3 for a normal, 2.37 for one truncated at 2
    std, 1.8 for a uniform)."""
    v = np.asarray(v, np.float64).ravel()
    std = v.std()
    return v.mean(), std, np.mean((v - v.mean()) ** 4) / std ** 4


def _init_cases():
    """(flax module, its input, the port's module) pairs at widths where a
    kernel's statistics are sharp."""
    fixbn, syncbn = j_norm("fixbn"), j_norm("syncbn")
    pyr = {f"stride{s}": np.zeros((1, n, n, 64), np.float32)
           for s, n in zip((8, 16, 32, 64, 128), (16, 8, 4, 2, 1))}
    feats = {"c3": np.zeros((1, 16, 16, 64), np.float32),
             "c4": np.zeros((1, 8, 8, 96), np.float32),
             "c5": np.zeros((1, 4, 4, 128), np.float32)}
    return {
        "deform_conv_v2": (jdcn.DeformConv(64, num_deformable_group=4,
                                           modulated=True, use_bias=True),
                           np.zeros((1, 8, 8, 64), np.float32),
                           DeformConv(64, 64, 3, modulated=True,
                                      use_bias=True)),
        "sepc": (jsepc.SEPCFPN(filters=64, pconv_num=2, pconv_deform=True,
                               lcconv_deform=True, ibn=True), pyr,
                 SEPCFPN(64, 2, True, True, True)),
        "sepc_subnets": (jsepc.SEPCSubnets(num_anchor=9, num_fg_class=80),
                         {k: np.zeros(v.shape[:3] + (128,), np.float32)
                          for k, v in pyr.items()},
                         SEPCSubnets(9, 80, 64)),
        "nasfpn": (jnas.NASFPNNeck(filters=64, num_stage=2, norm=syncbn),
                   feats, NASFPNNeck((64, 96, 128), 64, 2,
                                     norm=normalizer_factory("syncbn"))),
        "tdbu": (jnas.TopDownBottomUpFPNNeck(filters=64, num_stage=2),
                 feats, TopDownBottomUpFPNNeck((64, 96, 128), 64, 2)),
        "subnets_bn": (jretina.RetinaSubnets(num_anchor=9, num_fg_class=80,
                                             conv_channel=64, norm=fixbn),
                       pyr, RetinaSubnets(9, 80, 64, 64,
                                          norm=normalizer_factory("fixbn"))),
    }


@pytest.mark.parametrize("case", ["deform_conv_v2", "sepc", "sepc_subnets",
                                  "nasfpn", "tdbu", "subnets_bn"])
def test_seeded_init_has_flax_distributions(case):
    """Leaf by leaf against Flax's init of the same module: a constant leaf
    (zero offset convs and biases, the class prior, norms' ones and zeros)
    equal; a drawn kernel of at least 4096 values with the same mean (within
    4 standard errors), std (within 5%) and kurtosis (within 0.3: the
    family; its standard error at 4096 normal values is 0.08)."""
    jmod, x, tmod = _init_cases()[case]
    x = jax.tree.map(jnp.asarray, x)
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), x)
    want = dict(_flat(variables["params"]))
    tmod.init_weights(torch.Generator().manual_seed(0))
    got = {flax_path(n): flax_leaf(n, t.detach().numpy())
           for n, t in tmod.state_dict().items()
           if not n.endswith((".mean", ".var"))}
    assert set(got) == set(want)
    drawn = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if np.all(w == w.ravel()[0]):
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        assert w.size >= 4096, k
        (gm, gs, gr), (wm, ws, wr) = _leaf_stats(g), _leaf_stats(w)
        assert abs(gm - wm) <= 4 * ws / np.sqrt(w.size), k
        assert abs(gs / ws - 1) <= 0.05, (k, gs, ws)
        assert abs(gr - wr) <= 0.3, (k, gr, wr)
        drawn += 1
    assert drawn >= 1
