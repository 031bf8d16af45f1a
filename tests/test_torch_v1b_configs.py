"""The ResNet v1b / v1d / R152 FPN configs and the `mask_fpn_config`
template in the port, on the CPU: each of the 19 configs reads and builds
(at depth 18) in both modes as the JAX package's reader builds it; the
configs that need a component the port lacks raise naming it; the reader
serves `simpledet_tpu.dsl` as a stand-in; and config/micro_test.py under
SIMPLEDET_MICRO_BACKBONE=v1b / v1d trains 2 iterations through the port's
train CLI (tests/test_v1b_finetune_scratch.py's checks of the JAX CLI)."""
import dataclasses
import os
import sys

import flax.linen
import numpy as np
import pytest
import torch

from simpledet_torch.core.config import read_config
from simpledet_torch.dsl import BACKBONES, build_detector
from simpledet_torch.models.norm import FrozenBN, GroupNorm, SyncBN
from tmp_cleanup import collect_tmp_path, module_tmp_dirs  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V1B = "config/resnet_v1b"
CONFIGS = (
    ["config/faster_r50v1b_fpn_1x.py", f"{V1B}/faster_r50v1d_fpn_1x.py"]
    + [f"{V1B}/{kind}_r{d}v1b_fpn_{s}.py" for kind in ("faster", "mask")
       for d in (50, 101, 152) for s in ("1x", "2x")]
    + [f"{V1B}/retina_r{d}v1b_fpn_1x.py" for d in (50, 101, 152)]
    + [f"config/scratch/mask_r50v1b_fpn_{n}_scratch_2x.py"
       for n in ("bn", "gn")])
NORMS = {"fixbn": FrozenBN, "syncbn": SyncBN, "gn": GroupNorm}


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
    """The JAX package's reader: the config's train or test symbol, a Flax
    module built by the JAX DSL."""
    from simpledet_tpu.core.config import load_config

    out = load_config(os.path.join(REPO, path)).get_config(is_train=is_train)
    return getattr(out[6], "train_symbol" if is_train else "test_symbol")


def test_the_list_is_the_nineteen_configs():
    assert len(set(CONFIGS)) == 19
    assert all(os.path.exists(os.path.join(REPO, c)) for c in CONFIGS)


@pytest.mark.parametrize("is_train", [False, True], ids=["test", "train"])
@pytest.mark.parametrize("path", CONFIGS)
def test_config_builds_what_the_jax_reader_builds(path, is_train):
    """The same detector, the same components (the Flax submodules' classes
    under their field names), the backbone's variant, depth and normalizer;
    built at depth 18, every backbone norm is the config's and nothing
    outside the backbone is normalised (the JAX DSL normalises only the
    backbone, though mask_fpn_config sets a normalizer on every param
    class)."""
    sym = jax_symbol(path, is_train)
    spec = read_config(os.path.join(REPO, path), is_train=is_train)
    model = build_detector(spec, depth=18)
    assert type(model).__name__ == type(sym).__name__ == spec.detector
    want = {f.name: type(getattr(sym, f.name)).__name__
            for f in dataclasses.fields(sym)
            if isinstance(getattr(sym, f.name, None), flax.linen.Module)}
    got = {name: type(m).__name__ for name, m in model.named_children()}
    assert got == want
    depth, variant = BACKBONES[spec.components["backbone"].name]
    assert (depth, variant) == (sym.backbone.depth, sym.backbone.variant)
    assert model.backbone.variant == variant
    assert [len(u) for u in model.backbone.units] == [2, 2, 2, 2]
    norm = NORMS[sym.backbone.norm.type]
    kinds = {type(m) for m in model.backbone.modules()
             if isinstance(m, tuple(NORMS.values()))}
    assert kinds == {norm}
    assert not [n for n, m in model.named_modules()
                if isinstance(m, tuple(NORMS.values()))
                and not n.startswith("backbone.")]
    if is_train:
        want_fixed = [] if "scratch" in path else \
            ["conv0", "stage1", "scale", "bias"]
        assert list(spec.fixed_param) == want_fixed


@pytest.mark.parametrize("path,missing", [
    ("config/se/mask_se-r50v1b_fpn_bn_scratch_2x.py", "SEResNetFPN"),
    # (Mask Scoring R-CNN and the Double-Head box head are read and built
    # since they were ported)
    ("config/crowdhuman/doublepred_r50v1b_fpn_1x_refine.py",
     "DoublePredRcnn"),
    ("config/kd/faster_r50v1b_fpn_2x_fitnet_g5.py", "FitNetFasterRcnn"),
])
def test_configs_with_an_unported_component_raise_naming_it(path, missing):
    with pytest.raises(NotImplementedError, match=missing):
        for is_train in (False, True):
            build_detector(read_config(os.path.join(REPO, path),
                                       is_train=is_train), depth=18)


@pytest.mark.parametrize("path,missing", [
    # (the FPG configs, which import it too, are read and built since the
    # PAFPN and FPG necks were ported)
    ("config/kd/faster_kd_r50v1_fpn_1x.py", "FitNetFasterRcnn"),
    ("config/kd/retina_r50v1b_fpn_2x_fitnet_g10.py", "FitNetRetinaNet"),
    ("config/kd/faster_r50v1b_fpn_1x_fitnet_g5.py", "FitNetFasterRcnn"),
    ("config/kd/retina_r50v1b_fpn_1x_fitnet_g10.py", "FitNetRetinaNet"),
    ("config/crowdhuman/faster_r50v1b_fpn_1x.py", "FPNRpnHeadwithIgnore"),
])
def test_configs_importing_the_jax_dsl_raise_on_their_component(path,
                                                                 missing):
    """The reader serves `import simpledet_tpu.dsl` as a stand-in: a config
    that imports it raises on its first unported component, not on the
    import, and no module of the JAX package is left imported by it."""
    before = {m for m in sys.modules if m.startswith("simpledet_tpu")}
    with pytest.raises(NotImplementedError, match=missing):
        build_detector(read_config(os.path.join(REPO, path), is_train=True),
                       depth=18)
    assert {m for m in sys.modules if m.startswith("simpledet_tpu")} == \
        before


def test_mask_template_refuses_a_mask_head_it_lacks(tmp_path):
    """mask_fpn_config(mask_head=...) with the SE mask head: the reader
    records it, and building raises naming it."""
    path = tmp_path / "cfg.py"
    path.write_text(
        "from simpledet_tpu.config_templates import mask_fpn_config\n\n\n"
        "def get_config(is_train):\n"
        "    from models.se.builder import MaskRcnnSe4convHead\n"
        "    return mask_fpn_config(is_train, __name__, depth=50,\n"
        "                           variant='v1b',\n"
        "                           mask_head=MaskRcnnSe4convHead)\n")
    spec = read_config(str(path), is_train=True)
    assert spec.components["mask_head"].name == "MaskRcnnSe4convHead"
    with pytest.raises(NotImplementedError, match="MaskRcnnSe4convHead"):
        build_detector(spec, depth=18)


def test_other_jax_package_modules_stay_refused(tmp_path):
    path = tmp_path / "cfg.py"
    path.write_text("from simpledet_tpu.models.resnet import ResNet\n\n\n"
                    "def get_config(is_train):\n    return ResNet\n")
    with pytest.raises(NotImplementedError, match="simpledet_tpu.models"):
        read_config(str(path))


def test_config_coverage_probe(monkeypatch):
    """`python -m simpledet_torch.config_coverage`'s probe: the 152 config
    files, a v1b mask config builds, the SE one names its backbone."""
    from simpledet_torch.config_coverage import config_files, probe

    monkeypatch.chdir(REPO)
    assert len(config_files()) == 152
    assert probe(f"{V1B}/mask_r50v1b_fpn_1x.py", 18) is None
    assert "SEResNetFPN" in probe(
        "config/se/mask_se-r50v1b_fpn_bn_scratch_2x.py", 18)


@pytest.fixture(scope="module")
def micro(tmp_path_factory, module_tmp_dirs):
    from fixtures import make_micro_dataset

    root = tmp_path_factory.mktemp("micro")
    module_tmp_dirs.append(root)
    make_micro_dataset(str(root), n_images=8)
    return root


@pytest.mark.parametrize("variant", ["v1b", "v1d"])
def test_micro_test_trains_through_the_cli(variant, micro, tmp_path,
                                           monkeypatch):
    """config/micro_test.py with SIMPLEDET_MICRO_BACKBONE=v1b / v1d (the
    backbone class imported from simpledet_tpu.dsl): 2 iterations of the
    port's train CLI, finite losses and parameters, the variant's stem in
    the model (three 3 x 3 convs for v1d, one 7 x 7 for v1b) and in the
    checkpoint's leaves."""
    from simpledet_torch.core import checkpoint as ckpt
    from simpledet_torch.detection_train import train_net

    monkeypatch.setenv("MICRO_DATA_ROOT", str(micro))
    monkeypatch.setenv("SIMPLEDET_MICRO_BACKBONE", variant)
    monkeypatch.chdir(tmp_path)
    history = []
    trainer = train_net(os.path.join(REPO, "config", "micro_test.py"), 2,
                        device="cpu", loss_history=history)
    assert len(history) == 2
    assert all(np.isfinite(h["total_loss"]) for h in history)
    backbone = trainer.model.backbone
    assert backbone.variant == variant
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())
    params = ckpt.read_params("experiments/micro_test/checkpoint-0001.params")
    stem = sorted(k for k in params["backbone"] if k.startswith("conv0"))
    if variant == "v1d":
        assert stem == ["conv0_0", "conv0_1", "conv0_2"]
        assert backbone.conv0_0.weight.shape[2:] == (3, 3)
        assert params["backbone"]["conv0_0"]["kernel"].shape[:2] == (3, 3)
    else:
        assert stem == ["conv0"]
        assert backbone.conv0.weight.shape[2:] == (7, 7)
        assert params["backbone"]["conv0"]["kernel"].shape[:2] == (7, 7)
