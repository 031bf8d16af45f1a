"""The port's ResNet v1b, v1d and R152 backbones against the JAX package's, on
the CPU.

- v1b and v1d at depth 50 on a 64 x 96 batch of 2 (even sides, so v1d's
  stride-2 stem conv pads (0, 1) as Flax's SAME does): c2-c5 within 1e-5 of
  their scale (`CONT`, as tests/test_torch_model.py holds the v1 backbone),
  from the same params (FrozenBN with random folded statistics, so the
  activations stay of order one through the depth);
- v1d on an odd side: both sides fail at the residual add of the first
  strided unit (the average-pool shortcut floors where the 3 x 3 / 2 main
  branch ceils);
- R152-v1b and R50-v1d at full width: the leaf names and shapes of the
  Flax module's `jax.eval_shape` init map one to one onto the port's
  (`from_flax`), and back (`checkpoint.to_flax`) to the same arrays; the
  fixed_param mask (`"conv0"` freezes v1d's three stem convs) equals the JAX
  package's; a v1d `.params` file is byte for byte the JAX package's;
- v1d at 800 x 1333 (config/resnet_v1b/faster_r50v1d_fpn_1x.py's own pad)
  fails on both sides, 800 x 1344 runs.

The Flax params come from `jax.eval_shape`'s shapes filled by numpy, and the
Flax module runs eagerly: no XLA compile of a whole backbone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_tpu.core.optimizer import freeze_mask as j_freeze_mask
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models.norm import normalizer_factory
from simpledet_torch.core.checkpoint import to_flax
from simpledet_torch.core.optimizer import freeze_mask
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.weights import flax_path, from_flax

CONT = 1e-5
B, H, W = 2, 64, 96
FIXED = ("conv0", "stage1", "scale", "bias")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module's tests run: the tier-1
    command runs 6 test workers on the CPU's cores, and torch's default of
    a thread a core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def jax_backbone(depth, variant):
    return jresnet.ResNet(depth=depth, variant=variant,
                          norm=normalizer_factory("fixbn"))


def seeded_params(jmodel, shape, seed=0):
    """Params of the Flax module's init shapes: kernels N(0, 1 / fan_in),
    FrozenBN scales in [0.2, 0.6] and biases in [-0.2, 0.2]."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros(shape))["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.2, 0.6, s.shape).astype(np.float32)
        if name == "bias":
            return rng.uniform(-0.2, 0.2, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("variant", ["v1b", "v1d"])
def test_backbone_matches_flax_at_depth_50(variant):
    """c2-c5 within 1e-5 of their scale of the Flax backbone's, from the
    same params; the port's modules are the Flax tree's, one to one."""
    jmodel = jax_backbone(50, variant)
    x = np.random.RandomState(1).randn(B, H, W, 3).astype(np.float32)
    params = seeded_params(jmodel, x.shape)
    want = jmodel.apply({"params": params}, jnp.asarray(x))
    model = ResNet(50, variant=variant)
    from_flax(params, model)
    with torch.no_grad():
        got = model(_nchw(x))
    assert set(got) == set(want) == {"c2", "c3", "c4", "c5"}
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].shape == (B, v.shape[3], v.shape[1], v.shape[2]), k
        err = np.abs(got[k].permute(0, 2, 3, 1).numpy() - v).max()
        assert err <= CONT * np.abs(v).max(), (k, err / np.abs(v).max())


def test_v1d_stem_pads_as_flax_same():
    """v1d's stride-2 stem conv alone on an even and an odd side: Flax pads
    (0, 1) on the even side and (1, 1) on the odd one; the port within 1e-5,
    and a symmetric (1, 1) padding would differ on the even side."""
    import flax.linen as fnn

    from simpledet_torch.models.layers import same_pads
    from simpledet_torch.weights import convert_leaf

    assert same_pads(64, 3, 2) == (0, 1) and same_pads(65, 3, 2) == (1, 1)
    model = ResNet(18, variant="v1d")
    rng = np.random.RandomState(2)
    k = rng.randn(3, 3, 3, 32).astype(np.float32)
    name, weight = convert_leaf(("conv0_0", "kernel"), k)
    model.load_state_dict({name: weight}, strict=False)
    layer = fnn.Conv(32, (3, 3), strides=(2, 2), use_bias=False)
    for h, w in ((64, 96), (65, 97)):
        x = rng.randn(1, h, w, 3).astype(np.float32)
        want = np.asarray(layer.apply({"params": {"kernel": k}},
                                      jnp.asarray(x)))
        with torch.no_grad():
            got = model.conv0_0(_nchw(x)).permute(0, 2, 3, 1).numpy()
            sym = torch.nn.functional.conv2d(
                _nchw(x), model.conv0_0.weight, stride=2,
                padding=1).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= CONT * np.abs(want).max()
        differs = sym.shape != want.shape or \
            np.abs(sym - want).max() > 0.1 * np.abs(want).max()
        assert differs == (h % 2 == 0), (h, w)


def test_v1d_odd_side_fails_at_the_residual_add_on_both_sides():
    """A 66 x 66 input reaches stage 2 at 17 x 17: the main branch gives
    9 x 9, the average-pool shortcut 8 x 8. Flax raises at the add; the port
    raises too (no ceil_mode makes it pass)."""
    x = np.zeros((1, 66, 66, 3), np.float32)
    jmodel = jax_backbone(18, "v1d")
    with pytest.raises(Exception):
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x))
    model = ResNet(18, variant="v1d")
    with torch.no_grad(), pytest.raises(RuntimeError, match="size"):
        model(_nchw(x))
    with torch.no_grad():
        assert model(_nchw(np.zeros((1, 64, 64, 3), np.float32)))[
            "c5"].shape == (1, 2048, 2, 2)


def test_v1d_at_800_x_1333_fails_on_both_sides():
    """config/resnet_v1b/faster_r50v1d_fpn_1x.py pads its images to 800 x
    1333: along the 1333 side stage 3's first unit meets 167 columns, and
    the shortcut's average pool gives 83 where the main branch gives 84.
    The JAX package's backbone raises there, and so does the port's (shapes
    only: JAX's eval_shape, the port on the meta device); at 800 x 1344 (a
    multiple of 32) both run."""
    jmodel = jax_backbone(50, "v1d")
    model = ResNet(50, variant="v1d").to("meta")
    for w, fails in ((1333, True), (1344, False)):
        x = jnp.zeros((1, 800, w, 3))
        if fails:
            with pytest.raises(TypeError, match="84.*83"):
                jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x)
            with pytest.raises(RuntimeError, match="83.*84"):
                model(torch.empty(1, 3, 800, w, device="meta"))
        else:
            want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x)
            got = model(torch.empty(1, 3, 800, w, device="meta"))
            assert got["c5"].shape == (1, 2048, 25, 42)
            assert want is not None


@pytest.mark.parametrize("depth,variant,n_leaves", [
    # a unit's 3 kernels and 3 norms of 2 leaves, a shortcut's 3 leaves
    (152, "v1b", 3 + 9 * 50 + 3 * 4), (50, "v1d", 9 + 9 * 16 + 3 * 4)])
def test_full_width_leaves_map_one_to_one_both_ways(depth, variant,
                                                    n_leaves):
    """Every leaf of the Flax backbone's eval_shape init lands on a port
    parameter or buffer of the same shape, none is left over on either
    side, to_flax gives the same arrays back, and the fixed_param mask
    equals the JAX package's (the stem's convs frozen, `conv0_i` included)."""
    jmodel = jax_backbone(depth, variant)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    rng = np.random.RandomState(3)
    params = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    model = ResNet(depth, variant=variant)
    from_flax(params, model)
    want = dict(_flat(params))
    back = dict(_flat(to_flax(model)))
    assert len(want) == len(back) == len(model.state_dict()) == n_leaves
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    if variant == "v1d":
        assert {k.rsplit("/", 1)[0] for k in want
                if k.startswith(("conv0", "bn0"))} == {
            "conv0_0", "conv0_1", "conv0_2", "bn0_0", "bn0_1", "bn0_2"}
    mask = {flax_path(k): v for k, v in freeze_mask(model, FIXED).items()}
    assert mask == dict(_flat(j_freeze_mask(shapes, FIXED)))
    stem = [k for k in mask if k.startswith("conv0")]
    assert stem and not any(mask[k] for k in stem)


def test_v1d_params_file_is_the_jax_packages(tmp_path):
    """The depth-18 v1d backbone's .params written by the port is the file
    the JAX package writes for the same tree, and the JAX-written file
    loads back into the port leaf for leaf (`conv0_i`, `bn0_i` and the
    stride-1 `sc_conv` behind the average pool among them)."""
    from simpledet_tpu.core import checkpoint as jckpt
    from simpledet_torch.core import checkpoint as ckpt

    jmodel = jax_backbone(18, "v1d")
    params = seeded_params(jmodel, (1, 64, 64, 3), seed=4)
    model = ResNet(18, variant="v1d")
    from_flax(params, model)
    ckpt.save_checkpoint(str(tmp_path / "port"), 1, model)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, params)
    assert (tmp_path / "port-0001.params").read_bytes() == \
        (tmp_path / "jax-0001.params").read_bytes()
    other = ResNet(18, variant="v1d")
    ckpt.load_checkpoint(str(tmp_path / "jax"), 1, other)
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    assert other.stage2_unit1.sc_conv.stride == (1, 1)
