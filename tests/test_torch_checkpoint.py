"""The port's checkpoints against the JAX package's, both ways, on the CPU.

A `.params` file is flax.serialization.to_bytes of the param tree; the port
reads and writes it with its own msgpack codec (no flax, no msgpack). Files
cross between the packages bit for bit, `load_pretrain` finds the same
leaves as the JAX package's, and the port's `.torch_states` carries its
optimizer.
"""
import os

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledet_tpu.core import checkpoint as jckpt
from simpledet_torch.core import checkpoint as ckpt
from simpledet_torch.core.config import read_config
from simpledet_torch.dsl import build_detector
from simpledet_torch.weights import from_flax
from tmp_cleanup import collect_tmp_path, module_tmp_dirs  # noqa: F401

FLAGSHIP = "config/faster_r50v1_fpn_1x.py"


@pytest.fixture(scope="module")
def flagship_params():
    """The JAX flagship's 189-leaf param tree with seeded values (numpy)."""
    from simpledet_tpu.core.config import load_config as j_load_config

    jmodel = j_load_config(FLAGSHIP).get_config(is_train=False)[6]
    shapes = jax.eval_shape(lambda: jmodel.test_symbol.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros((1, 128, 160, 3)), jnp.asarray([[128, 160, 1.0]]),
        mode="test"))["params"]
    rng = np.random.RandomState(0)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _flat(tree):
    return {"/".join(k): v for k, v in ckpt.flatten(tree).items()}


def test_jax_checkpoint_read_by_port(flagship_params, tmp_path):
    """A .params that simpledet_tpu's save_checkpoint wrote loads into the
    port's flagship as from_flax loads the same tree: equal state dicts."""
    prefix = str(tmp_path / "checkpoint")
    jckpt.save_checkpoint(prefix, 3, flagship_params)
    spec = read_config(FLAGSHIP)
    a, b = build_detector(spec), build_detector(spec)
    assert ckpt.get_latest_ckpt_epoch(prefix) == 3
    assert ckpt.load_checkpoint(prefix, 3, a) is None  # no .torch_states
    from_flax(flagship_params, b)
    sa, sb = a.state_dict(), b.state_dict()
    assert len(sa) == 189
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_port_checkpoint_read_by_jax(flagship_params, tmp_path):
    """A .params that the port wrote is byte for byte the file the JAX
    package writes for the same tree, and load_checkpoint gives the same
    leaves, bit for bit."""
    spec = read_config(FLAGSHIP)
    model = build_detector(spec)
    from_flax(flagship_params, model)
    ckpt.save_checkpoint(str(tmp_path / "port"), 1, model)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, flagship_params)
    port_bytes = (tmp_path / "port-0001.params").read_bytes()
    assert port_bytes == (tmp_path / "jax-0001.params").read_bytes()
    template = jax.tree.map(np.zeros_like, flagship_params)
    got, opt_state, step = jckpt.load_checkpoint(str(tmp_path / "port"), 1,
                                                 template)
    assert opt_state is None and step is None
    want, got = _flat(flagship_params), _flat(got)
    assert set(want) == set(got) and len(got) == 189
    for k, v in want.items():
        g = np.asarray(got[k])
        assert g.dtype == v.dtype and np.array_equal(g, v), k


def test_load_pretrain_hits_as_jax(flagship_params, tmp_path):
    """A partial pretrain (no box head, one kernel of another shape, one
    leaf the model lacks) gives the same hit count as the JAX package's
    load_pretrain; hits are copied, the rest keep their init."""
    tree = {k: v for k, v in flagship_params.items() if k != "bbox_head"}
    tree = jax.tree.map(lambda v: v, tree)
    tree["neck"] = dict(tree["neck"])
    tree["neck"]["P2_conv"] = dict(tree["neck"]["P2_conv"],
                                   kernel=np.zeros((1, 1, 256, 256),
                                                   np.float32))
    tree["extra"] = {"kernel": np.ones((2, 2), np.float32)}
    prefix = str(tmp_path / "pretrain")
    jckpt.save_checkpoint(prefix, 0, tree)
    _, want_hits = jckpt.load_pretrain(
        jax.tree.map(np.zeros_like, flagship_params), prefix, 0)
    model = build_detector(read_config(FLAGSHIP))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    hits = ckpt.load_pretrain(model, prefix, 0)
    assert hits == want_hits == 189 - 8 - 1     # 8 box-head leaves
    after = model.state_dict()
    assert torch.equal(after["neck.P2_conv.weight"],
                       before["neck.P2_conv.weight"])
    assert torch.equal(after["bbox_head.fc1.weight"],
                       before["bbox_head.fc1.weight"])
    np.testing.assert_array_equal(
        after["backbone.conv0.weight"].numpy(),
        flagship_params["backbone"]["conv0"]["kernel"].transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match="P2_conv"):
        ckpt.load_pretrain(model, prefix, 0, allow_missing=False)
    with pytest.raises(FileNotFoundError):
        ckpt.load_pretrain(model, str(tmp_path / "absent"))


def test_states_resume_the_optimizer(tmp_path):
    """`.torch_states` holds the optimizer's state and the step count; a fresh
    optimizer loads it back exactly."""
    from simpledet_torch.core.optimizer import make_optimizer

    def tiny():
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                                torch.nn.Conv2d(4, 2, 1))
        return m, make_optimizer(m, {n: True for n in m.state_dict()},
                                 lr=0.1)

    model, opt = tiny()
    model(torch.randn(1, 3, 8, 8)).sum().backward()
    opt.step()
    ckpt.save_checkpoint(str(tmp_path / "c"), 2, model, opt, step=7)
    model2, opt2 = tiny()
    assert ckpt.load_checkpoint(str(tmp_path / "c"), 2, model2, opt2) == 7
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    bufs = [opt2.state[p]["momentum_buffer"] for p in model2.parameters()]
    for p, b in zip(model.parameters(), bufs):
        assert torch.equal(opt.state[p]["momentum_buffer"], b)


def test_latest_epoch_as_jax(tmp_path):
    for name in ("checkpoint-0002.params", "checkpoint-0011.params",
                 "checkpoint-0004.states", "checkpoint-x.params",
                 "other-0099.params"):
        (tmp_path / name).write_bytes(b"")
    prefix = str(tmp_path / "checkpoint")
    assert ckpt.get_latest_ckpt_epoch(prefix) == \
        jckpt.get_latest_ckpt_epoch(prefix) == 11
    assert ckpt.get_latest_ckpt_epoch(str(tmp_path / "none" / "c")) is None


# ------------------------------------------------------------ msgpack codec

CASES = [None, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
         2 ** 64 - 1, -1, -32, -33, -128, -129, -2 ** 15 - 1, -2 ** 31 - 1,
         -2 ** 63, 1.5, -0.0, "", "x" * 31, "x" * 32, "y" * 300, "z" * 70000,
         "été", b"", b"z" * 255, b"z" * 256, b"z" * 70000,
         [1] * 15, [1] * 16, list(range(70000)),
         {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
         {"a": [None, {"b": b"\x00"}], "c": -7}]


@pytest.mark.parametrize("obj", CASES, ids=lambda o: type(o).__name__)
def test_msgpack_codec_matches_msgpack(obj):
    """packb gives msgpack-python's bytes; unpackb reads them back."""
    want = msgpack.packb(obj, use_bin_type=True)
    assert ckpt.packb(obj) == want
    assert ckpt.unpackb(want) == obj


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16, 17, 255, 256, 70000])
def test_msgpack_ext_matches_msgpack(n):
    data = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    want = msgpack.packb(msgpack.ExtType(1, data))
    assert ckpt.packb(ckpt.Ext(1, data)) == want
    got = ckpt.unpackb(want)
    assert got.code == 1 and got.data == data


@pytest.mark.parametrize("obj", [True, 1 + 2j, {1, 2}, np.float32(1.0)],
                         ids=repr)
def test_msgpack_codec_refuses_other_types(obj):
    with pytest.raises(TypeError):
        ckpt.packb(obj)


@pytest.mark.parametrize("data", [msgpack.packb(True), msgpack.packb(False),
                                  msgpack.packb(1) + b"\x00",
                                  msgpack.packb("abc")[:-1]], ids=repr)
def test_msgpack_codec_refuses_other_bytes(data):
    with pytest.raises(ValueError):
        ckpt.unpackb(data)


def test_flax_bytes_both_ways():
    """Trees of several dtypes and ranks, in insertion order, against
    flax.serialization directly."""
    import flax.serialization

    rng = np.random.RandomState(1)
    tree = {"b": {"kernel": rng.randn(3, 3, 4, 5).astype(np.float32),
                  "ints": np.arange(7, dtype=np.int32)},
            "a": {"scalar": np.full((), 2.5, np.float32),
                  "half": rng.randn(4).astype(np.float16)}}
    data = flax.serialization.to_bytes(tree)
    assert ckpt.to_bytes(tree) == data
    back = ckpt.from_bytes(data)
    assert list(back) == ["b", "a"]
    for k, v in _flat(tree).items():
        g = _flat(back)[k]
        assert g.dtype == v.dtype and g.shape == v.shape
        assert np.array_equal(g, v)
    assert os.path.basename(ckpt.params_path("x/c", 12)) == "c-0012.params"
