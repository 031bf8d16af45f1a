"""The FCOS, RepPoints and FreeAnchor configs in the port, on the CPU.

- The 11 config files of these families (`config/fcos_r50v1_fpn_1x.py`,
  `config/RepPoints/*`, `config/FreeAnchor/*` and the three
  `config/converge_{fcos,reppoints,freeanchor}.py`) read and build (at
  depth 18, on the meta device) in both modes as the JAX package's reader
  builds them: the detector and head kind, the backbone's variant and its
  DCN units, the neck's P6 source, the head module's Flax leaves against
  the port's (from `jax.eval_shape`), the classes, strides and point
  transform, the moment transfer, the multi-scale train chain and the
  fixed parameters.
- `python -m simpledet_torch.config_coverage` counts 132 of 152 config
  files built (in a process of its own: configs read the environment).
- The three learning recipes through the port's train CLI (2 iterations):
  their `.params` and `.batch_stats` leaves are the JAX model's, at their
  shapes; then the test CLI from that checkpoint.
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
from simpledet_torch.models.dcn import DCNBottleneck, DCNv2Bottleneck
from simpledet_torch.models.fcos import FCOS
from simpledet_torch.models.freeanchor import FreeAnchorRetinaNetHead
from simpledet_torch.models.norm import FrozenBN, SyncBN
from simpledet_torch.models.reppoints import RepPoints
from simpledet_torch.models.retinanet import RetinaNet
from simpledet_torch.weights import SHARED_KERNELS, flax_path
from tmp_cleanup import collect_tmp_path, module_tmp_dirs  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIDES = (8, 16, 32, 64, 128)


def _family():
    out = [os.path.join(REPO, "config", "fcos_r50v1_fpn_1x.py")]
    for pattern in ("config/RepPoints/*.py", "config/FreeAnchor/*.py"):
        out += [p for p in sorted(glob.glob(os.path.join(REPO, pattern)))
                if not p.endswith("__init__.py")]
    out += [os.path.join(REPO, "config", f"converge_{c}.py")
            for c in ("fcos", "reppoints", "freeanchor")]
    return [os.path.relpath(p, REPO) for p in out]


CONFIGS = _family()
KIND = {"FCOS": FCOS, "RepPoints": RepPoints, "RetinaNet": RetinaNet}


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
    leaf = name.rsplit(".", 1)[-1]
    if (leaf == "weight" or leaf in SHARED_KERNELS) and len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    return tuple(shape)


def test_the_family_is_11_configs():
    assert len(CONFIGS) == 11
    assert sum("/RepPoints/" in c for c in CONFIGS) == 5
    assert sum("/FreeAnchor/" in c for c in CONFIGS) == 2


def _special_units(bb):
    return [type(m).__name__ for m in bb.modules()
            if isinstance(m, (DCNBottleneck, DCNv2Bottleneck))]


def _check_backbone(jbb, bb):
    """The same variant; the DCN hybrid's special units (DCN or DCNv2) in
    the same number, each of the JAX block's kind."""
    assert jbb.variant == bb.variant
    units = _special_units(bb)
    if jbb.special_block is None:
        assert not units
        return
    n = sum(min(k, len(names)) for k, names in zip(jbb.num_special,
                                                    bb.units))
    assert units == [jbb.special_block.__name__] * n and n > 0


@pytest.mark.parametrize("is_train", [False, True], ids=["test", "train"])
@pytest.mark.parametrize("path", CONFIGS)
def test_config_builds_what_the_jax_reader_builds(path, is_train):
    sym = jax_symbol(path, is_train)
    spec = read_config(os.path.join(REPO, path), is_train=is_train)
    with torch.device("meta"):          # the modules, not their weights
        model = build_detector(spec, depth=18)
    assert type(model) is KIND[type(sym).__name__]
    assert isinstance(model.head, FreeAnchorRetinaNetHead) == (
        type(sym.head).__name__ == "FreeAnchorRetinaNetHead")
    _check_backbone(sym.backbone, model.backbone)
    norms = {type(m) for m in model.backbone.modules()
             if isinstance(m, (FrozenBN, SyncBN))}
    assert norms == {SyncBN if "converge" in path else FrozenBN}
    assert model.neck.p6_source == sym.neck.p6_source
    assert not model.neck.has_norm and sym.neck.norm is None
    assert model.head.strides == tuple(sym.head.strides) == STRIDES
    assert model.head.num_fg_class == sym.head.num_fg_class
    if isinstance(model, RepPoints):
        assert model.head.transform == sym.head.transform
        assert (model.moment_transfer is not None) == sym.head.needs_moment
    # the head module's Flax leaves are the port's (from the neck's 256
    # channels at 128 x 192)
    pyramid = {f"stride{s}": jnp.zeros((1, -(-128 // s), -(-192 // s), 256))
               for s in STRIDES}
    shapes = jax.eval_shape(sym.head_module.init, jax.random.PRNGKey(0),
                            pyramid)
    want = dict(_leaves(shapes["params"]))
    got = {flax_path(n): _flax_shape(n, t.shape)
           for n, t in model.head_module.state_dict().items()}
    assert got == want
    names = [type(t).__name__ for t in spec.transform]
    assert ("RandResize2DImageBbox" in names) == (
        is_train and "multiscale" in path)
    if is_train:
        want_fixed = [] if "converge" in path else ["conv0", "stage1",
                                                    "scale", "bias"]
        assert list(spec.fixed_param) == want_fixed


def test_coverage_probe_counts_121_of_152():
    """`python -m simpledet_torch.config_coverage --list`, in a process of
    its own with only PATH and PYTHONPATH set (a config reads the
    environment: `config/micro_test.py` picks its backbone from it): 132
    of the 152 config files build in both modes (121 before the two-stage
    FPN variants), these 11 among them."""
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


@pytest.mark.parametrize("name", ["converge_fcos", "converge_reppoints",
                                  "converge_freeanchor"])
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
