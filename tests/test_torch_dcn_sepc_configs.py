"""The DCN, NAS-FPN / TDBU and SEPC configs in the port, on the CPU.

- The 21 config files of this family (`config/dcn/*`, `config/NASFPN/*`,
  `config/sepc/*`, `config/converge_nasfpn.py`, `config/converge_sepc.py`)
  read and build (at depth 18, on the meta device) in both modes as the
  JAX package's reader builds them: the detector, the DCN hybrid's special
  units and their kind, the C4 adapter, the neck's kind, width, merge
  cells, S0 kernel and norm, SEPC's PConv count, deformable parts and iBN
  (the neck's Flax leaves against the port's, from `jax.eval_shape`), the
  subnets' norm and width, and the fixed parameters.
- `python -m simpledet_torch.config_coverage` counts 132 of 152 config
  files built (in a process of its own: configs read the environment).
- config/converge_sepc.py and config/converge_nasfpn.py through the port's
  train CLI (2 iterations): their `.params` and `.batch_stats` leaves are
  the JAX model's, at their shapes; then the test CLI from that checkpoint.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_torch.core.config import read_config
from simpledet_torch.dsl import build_detector
from simpledet_torch.models.dcn import (C4StrideKeyAdapter, DCNBottleneck,
                                        DCNv2Bottleneck)
from simpledet_torch.models.nasfpn import NASFPNNeck, TopDownBottomUpFPNNeck
from simpledet_torch.models.norm import FrozenBN, SyncBN
from simpledet_torch.models.retinanet import RetinaNetNeck, RetinaSubnets
from simpledet_torch.models.sepc import SEPCNeck, SEPCSubnets
from simpledet_torch.weights import flax_path
from tmp_cleanup import collect_tmp_path, module_tmp_dirs  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _family():
    out = []
    for pattern in ("config/dcn/*.py", "config/NASFPN/*.py",
                    "config/sepc/*.py"):
        out += [p for p in sorted(glob.glob(os.path.join(REPO, pattern)))
                if not p.endswith("__init__.py")]
    out += [os.path.join(REPO, "config", c) for c in ("converge_nasfpn.py",
                                                      "converge_sepc.py")]
    return [os.path.relpath(p, REPO) for p in out]


CONFIGS = _family()


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module's tests run: the tier-1
    command runs 6 test workers on the CPU's cores, and torch's default of
    a thread a core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_symbol(path, is_train):
    from simpledet_tpu.core.config import load_config

    out = load_config(os.path.join(REPO, path)).get_config(is_train=is_train)
    return getattr(out[6], "train_symbol" if is_train else "test_symbol")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), tuple(v.shape)


def _flax_shape(name, shape):
    """The Flax leaf's shape of a torch entry (HWIO kernels)."""
    if name.endswith("weight") and len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    return tuple(shape)


def test_the_family_is_21_configs():
    assert len(CONFIGS) == 21
    assert sum("/dcn/" in c for c in CONFIGS) == 7
    assert sum("/NASFPN/" in c for c in CONFIGS) == 6
    assert sum("/sepc/" in c for c in CONFIGS) == 6


def _check_backbone(jbb, bb):
    """The same variant; the DCN hybrid (v1b): the same special units (DCN
    or DCNv2) at the same places; a C4 one under the stride-16 adapter."""
    if type(jbb).__name__ == "C4StrideKeyAdapter":
        assert isinstance(bb, C4StrideKeyAdapter)
        assert bb.out_channels == 1024
        jbb, bb = jbb.inner, bb.inner
        assert jbb.num_stages == 3 and len(bb.units) == 3
    assert jbb.variant == bb.variant
    if jbb.special_block is None:
        assert not any(isinstance(m, DCNBottleneck) for m in bb.modules())
        return
    want_cls = {"DCNBottleneck": DCNBottleneck,
                "DCNv2Bottleneck": DCNv2Bottleneck}[
                    jbb.special_block.__name__]
    for stage, names in enumerate(bb.units):
        n = len(names)
        special = [u for u, name in enumerate(names)
                   if isinstance(getattr(bb, name), DCNBottleneck)]
        k = min(jbb.num_special[stage], n)
        assert special == list(range(n - k, n)), (stage, special)
        for u in special:
            assert type(getattr(bb, names[u])) is want_cls


def _norm_kind(mods):
    kinds = {type(m) for m in mods if isinstance(m, (FrozenBN, SyncBN))}
    assert len(kinds) <= 1
    return kinds.pop() if kinds else None


def _check_retina(sym, model, leaves):
    jn, neck = sym.neck, model.neck
    jname = type(jn).__name__
    if jname == "NASFPNNeck":
        assert isinstance(neck, NASFPNNeck)
        assert neck.num_stage == jn.num_stage
        assert neck.S0_P3.kernel_size == (jn.s0_kernel,) * 2
    elif jname == "TopDownBottomUpFPNNeck":
        assert isinstance(neck, TopDownBottomUpFPNNeck)
        assert neck.num_stage == jn.num_stage
    if jname in ("NASFPNNeck", "TopDownBottomUpFPNNeck"):
        first = neck.P3_lateral if hasattr(neck, "P3_lateral") \
            else neck.S0_P3
        assert first.out_channels == jn.filters
        want = {None: None, "syncbn": SyncBN}[
            getattr(jn.norm, "type", None) if jn.norm is not None else None]
        assert _norm_kind(neck.modules()) is want
        width = jn.filters
    elif jname == "RetinaNetNeck":
        assert type(neck) is RetinaNetNeck
        assert neck.has_norm == (jn.norm is not None)
        width = 256
    else:                                 # the SEPC chain
        assert isinstance(neck, SEPCNeck) and neck.fpn.has_norm
        width = 512
    if leaves and jname not in ("NASFPNNeck", "TopDownBottomUpFPNNeck",
                                "RetinaNetNeck"):
        # the SEPC neck's Flax leaves at depth 18's c3-c5 widths are the
        # port's (test mode: the train symbol's neck is the same module)
        feats = {f"c{i}": jnp.zeros((1, 128 // 2 ** i, 192 // 2 ** i, c))
                 for i, c in zip((3, 4, 5), (512, 1024, 2048))}
        shapes = jax.eval_shape(jn.init, jax.random.PRNGKey(0), feats)
        want = dict(_leaves(shapes["params"]))
        got = {flax_path(n): _flax_shape(n, t.shape)
               for n, t in neck.state_dict().items()
               if not n.endswith((".mean", ".var"))}
        assert got == want
    jsub, sub = sym.head_module, model.head_module
    if type(jsub).__name__ == "SEPCSubnets":
        assert isinstance(sub, SEPCSubnets)
        assert sub.cls_pred.in_channels == width // 2
    else:
        assert isinstance(sub, RetinaSubnets)
        assert sub.has_norm == (jsub.norm is not None)
        assert sub.cls_conv1.in_channels == width
        assert sub.cls_conv1.out_channels == jsub.conv_channel
    assert sub.cls_pred.out_channels == jsub.num_anchor * jsub.num_fg_class


@pytest.mark.parametrize("is_train", [False, True], ids=["test", "train"])
@pytest.mark.parametrize("path", CONFIGS)
def test_config_builds_what_the_jax_reader_builds(path, is_train):
    sym = jax_symbol(path, is_train)
    spec = read_config(os.path.join(REPO, path), is_train=is_train)
    with torch.device("meta"):          # the modules, not their weights
        model = build_detector(spec, depth=18)
    assert type(model).__name__ == type(sym).__name__
    _check_backbone(sym.backbone, model.backbone)
    if type(model).__name__ == "RetinaNet":
        _check_retina(sym, model, leaves=not is_train)
    else:
        assert model.bbox_head.cls_logit.out_features == \
            sym.bbox_head.num_class
    if is_train:
        want_fixed = [] if "converge" in path else ["conv0", "stage1",
                                                    "scale", "bias"]
        assert list(spec.fixed_param) == want_fixed


def test_coverage_probe_counts_110_of_152():
    """`python -m simpledet_torch.config_coverage --list`, in a process of
    its own with only PATH and PYTHONPATH set (a config reads the
    environment: `config/micro_test.py` picks its backbone from it): 132
    of the 152 config files build in both modes (110 before FCOS,
    RepPoints and FreeAnchor, 121 before the two-stage FPN variants), this
    family's 21 among them."""
    import subprocess
    import sys

    env = {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": REPO}
    out = subprocess.run(
        [sys.executable, "-m", "simpledet_torch.config_coverage", "--list"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("132 of 152 config files read and build "
                                 "in both modes"), out.stdout
    for path in CONFIGS:
        assert f" {path}\n" not in out.stdout, path


@pytest.fixture(scope="module")
def micro(tmp_path_factory, module_tmp_dirs):
    from simpledet_torch.data.synthetic import make_micro_dataset

    root = tmp_path_factory.mktemp("converge")
    module_tmp_dirs.append(root)
    make_micro_dataset(str(root), n_images=8, set_names=("converge_train",))
    return root


@pytest.mark.parametrize("name", ["converge_sepc", "converge_nasfpn"])
def test_converge_recipe_train_checkpoint_test_cli(name, micro, tmp_path,
                                                   monkeypatch):
    """The recipe at batch 1 through the port's train CLI for 2 iterations:
    finite losses, checkpoint-0001.params and .batch_stats with every leaf
    of the JAX package's model (`jax.eval_shape` of its init) at its shape;
    then the test CLI from that checkpoint on 4 images: the COCO summary,
    the running statistics loaded."""
    from simpledet_torch.core import checkpoint as ckpt
    from simpledet_torch.detection_test import test_net
    from simpledet_torch.detection_train import train_net

    config = os.path.join(REPO, "config", f"{name}.py")
    prefix_env = name.upper()
    monkeypatch.setenv("CONVERGE_DATA_ROOT", str(micro))
    monkeypatch.setenv(f"{prefix_env}_EPOCHS", "1")
    monkeypatch.setenv(f"{prefix_env}_BATCH", "1")
    monkeypatch.chdir(tmp_path)
    history = []
    train_net(config, 2, device="cpu", loss_history=history)
    assert len(history) == 2
    assert all(np.isfinite(h["total_loss"]) for h in history)
    prefix = f"experiments/{name}/checkpoint"
    params = ckpt.read_params(ckpt.params_path(prefix, 1))

    sym = jax_symbol(f"config/{name}.py", True)
    shapes = jax.eval_shape(
        lambda r: sym.init(r, jnp.zeros((1, 128, 192, 3)),
                           jnp.float32([[128, 192, 1.0]]), mode="test"),
        {"params": jax.random.PRNGKey(0)})
    assert dict(_leaves(params)) == dict(_leaves(shapes["params"]))
    with open(ckpt.batch_stats_path(prefix, 1), "rb") as f:
        stats = ckpt.from_bytes(f.read())
    assert dict(_leaves(stats)) == dict(_leaves(shapes["batch_stats"]))

    stats_out = {}
    summary = test_net(config, 4, device="cpu", stats=stats_out)
    assert stats_out["images"] == 4
    assert set(summary) >= {"AP", "AP50", "AP75"}
    log = (tmp_path / "experiments" / name / "log.txt").read_text()
    assert "loaded SyncBN running stats" in log
