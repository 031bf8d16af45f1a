"""The Cascade R-CNN and R101 configs in the port, on the CPU: the config
reader keeps every component a detector is given, the configs read and
build, the R101-v1 backbone against the JAX package's at depth 101, the
full-width cascade's every Flax leaf mapped and frozen as the JAX package
freezes it, the serving breakdown's stages, and the train and test CLIs on
config/converge_cascade.py."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledet_torch.core.config import read_config
from simpledet_torch.dsl import build_detector
from simpledet_torch.models.cascade_rcnn import CascadeRcnn
from simpledet_torch.weights import flax_path, from_flax
from tmp_cleanup import collect_tmp_path, module_tmp_dirs  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASCADE = "config/cascade_r50v1_fpn_1x.py"
CASCADE_R101 = "config/cascade_r101v1_fpn_1x.py"
FASTER_R101 = "config/faster_r101v1_fpn_1x.py"
FASTER_R101_2X = "config/faster_r101v1_fpn_2x.py"
CONVERGE = "config/converge_cascade.py"
SUMMARY_KEYS = ["AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
                "AR100", "ARs", "ARm", "ARl"]


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
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


# ------------------------------------------------------------ config reader


@pytest.mark.parametrize("is_train", [False, True])
def test_reader_keeps_every_cascade_component(is_train):
    """get_train_symbol / get_test_symbol of CascadeRcnn take seven
    components; the reader keeps all seven under the JAX DSL's argument
    names, each with its own param class."""
    spec = read_config(CASCADE, is_train=is_train)
    assert spec.detector == "CascadeRcnn"
    assert list(spec.components) == [
        "backbone", "neck", "rpn_head", "roi_extractor", "bbox_head",
        "bbox_head_2nd", "bbox_head_3rd"]
    heads = [spec.components[r] for r in ("bbox_head", "bbox_head_2nd",
                                          "bbox_head_3rd")]
    assert [h.name for h in heads] == ["CascadeBbox2fcHead"] * 3
    assert [h.param.stage for h in heads] == ["1st", "2nd", "3rd"]
    assert [h.param.loss_weight for h in heads] == [1.0, 0.5, 0.25]
    assert [h.param.regress_target.std for h in heads] == [
        (0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
        (0.033, 0.033, 0.067, 0.067)]


def _write_config(path, detector, call):
    path.write_text(
        "from symbol.builder import FPNNeck, FPNRpnHead, FPNRoiAlign\n"
        "from symbol.builder import FPNBbox2fcHead, MSRAResNet50V1FPN\n"
        f"from symbol.builder import {detector} as Detector\n\n\n"
        "class P:\n    pass\n\n\n"
        "def get_config(is_train):\n"
        "    parts = [MSRAResNet50V1FPN(P), FPNNeck(P), FPNRpnHead(P),\n"
        "             FPNRoiAlign(P), FPNBbox2fcHead(P)]\n"
        f"    sym = Detector().get_test_symbol({call})\n"
        "    ModelParam = type('ModelParam', (), dict(test_symbol=sym))\n"
        "    return (P, P, P, P, P, P, ModelParam, P, P, [], [], [], [])\n")
    return str(path)


@pytest.mark.parametrize("detector,call,what", [
    # a sixth component for FasterRcnn: there is no role for it
    ("FasterRcnn", "*parts, FPNBbox2fcHead(P)", "given 6 components"),
    ("FasterRcnn", "*parts, kd_head=FPNNeck(P)", r"keyword \(kd_head\)"),
    ("FasterRcnn", "*parts[:4], bbox_head=parts[4]",
     r"keyword \(bbox_head\)"),
    ("FasterRcnn", "*parts[:4], 3", "is not a component"),
    # a detector without roles (TridentFasterRcnn has them since it was
    # ported)
    ("TridentMaskRcnn", "*parts", "TridentMaskRcnn"),
])
def test_reader_raises_on_a_component_it_cannot_place(tmp_path, detector,
                                                      call, what):
    path = _write_config(tmp_path / "cfg.py", detector, call)
    with pytest.raises(NotImplementedError, match=what):
        read_config(path)


# ---------------------------------------------------------------- building


@pytest.mark.parametrize("is_train", [False, True], ids=["test", "train"])
@pytest.mark.parametrize("path,detector,depth", [
    (CASCADE, "CascadeRcnn", 50), (CASCADE_R101, "CascadeRcnn", 101),
    (FASTER_R101, "FasterRcnn", 101), (FASTER_R101_2X, "FasterRcnn", 101),
    (CONVERGE, "CascadeRcnn", 18)])
def test_configs_read_and_build(path, detector, depth, is_train):
    """Each config reads unedited and builds the port's detector: the
    backbone's depth (block counts 3/4/23/3 at 101), three class-agnostic
    heads for a cascade, the stages' sampling parameters as the config lays
    them out."""
    from simpledet_torch.models.resnet import RESNET_UNITS

    spec = read_config(path, is_train=is_train)
    model = build_detector(spec)
    assert type(model).__name__ == detector
    assert [len(u) for u in model.backbone.units] == list(RESNET_UNITS[depth])
    if detector == "FasterRcnn":
        assert model.bbox_head.bbox_delta.out_features == 4 * 81
        return
    n_class = 4 if path == CONVERGE else 81
    for head in model.heads:
        assert head.bbox_delta.out_features == 8
        assert head.cls_logit.out_features == n_class
    assert model.heads[0].fc1.weight is not model.heads[1].fc1.weight
    fg = [model.sampling_params(i)[0].fg_thr for i in range(3)]
    assert fg == [0.5, 0.6, 0.7]
    assert model.sampling_params(2)[1].std == (0.033, 0.033, 0.067, 0.067)
    if is_train:
        assert spec.fixed_param == (() if path == CONVERGE else
                                    ("conv0", "stage1", "scale", "bias"))


def test_cascade_head_reads_unset_class_agnostic_as_true():
    """A cascade head's regress_target.class_agnostic of None means
    class-agnostic (the JAX DSL's rule), unlike the flagship head's."""
    spec = read_config(CASCADE)
    spec.components["bbox_head_2nd"].param.regress_target.class_agnostic = \
        None
    spec.components["bbox_head_3rd"].param.regress_target.class_agnostic = \
        False
    model = build_detector(spec)
    assert [h.bbox_delta.out_features for h in model.heads] == [8, 8, 324]


def test_r101_backbone_matches_jax():
    """The R101-v1 backbone at depth 101 on a 64 x 96 batch of 2: c2-c5
    within 1e-5 of their scale of the JAX package's, from the same params
    (FrozenBN with random folded statistics)."""
    from simpledet_tpu.models import resnet as jresnet
    from simpledet_tpu.models.norm import normalizer_factory
    from simpledet_torch.models.resnet import ResNet

    jmodel = jresnet.ResNet(depth=101, norm=normalizer_factory("fixbn"))
    x = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(x))["params"]
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
                         if path[-1].key == "scale" else
                         rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
                         if path[-1].key == "bias" and v.ndim == 1
                         and "bn" in path[-2].key else np.asarray(v)),
        params)
    want = jax.jit(lambda p, v: jmodel.apply({"params": p}, v))(
        params, jnp.asarray(x))
    model = ResNet(101)
    from_flax(params, model)
    assert [len(u) for u in model.units] == [3, 4, 23, 3]
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
    assert set(got) == set(want) == {"c2", "c3", "c4", "c5"}
    for k, v in want.items():
        v = np.asarray(v)
        err = np.abs(got[k].permute(0, 2, 3, 1).numpy() - v).max()
        assert err <= 1e-5 * np.abs(v).max(), k


@pytest.fixture(scope="module")
def r101_cascade():
    """(port model, JAX config module's model param, the JAX test model's
    param shapes) for config/cascade_r101v1_fpn_1x.py at full width."""
    from simpledet_tpu.core.config import load_config as j_load_config

    spec = read_config(CASCADE_R101)
    jmodel = j_load_config(CASCADE_R101).get_config(is_train=False)[6]
    shapes = jax.eval_shape(lambda: jmodel.test_symbol.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros((1, 128, 160, 3)), jnp.asarray([[128, 160, 1.0]]),
        mode="test"))["params"]
    return build_detector(spec), jmodel, shapes


def test_cascade_r101_maps_every_flax_leaf(r101_cascade):
    """from_flax maps every leaf of the full-width cascade_r101v1_fpn_1x
    model (the JAX package's, through its DSL) onto the port's, with equal
    shapes and none left over on either side; each stage head's leaves land
    on that head."""
    model, _, shapes = r101_cascade
    leaves = dict(_flat(shapes))
    assert {k.split("/")[0] for k in leaves} == {
        "backbone", "neck", "rpn_module", "head_1st", "head_2nd", "head_3rd"}
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    from_flax(params, model)
    assert len(model.state_dict()) == len(leaves) == 358
    for s in ("1st", "2nd", "3rd"):
        np.testing.assert_array_equal(
            model.state_dict()[f"head_{s}.fc1.weight"].numpy(),
            params[f"head_{s}"]["fc1"]["kernel"].T)
    with pytest.raises(KeyError):
        from_flax({**params, "head_4th": params["head_3rd"]}, model)
    smaller = dict(params)
    del smaller["head_3rd"]
    with pytest.raises(KeyError, match="head_3rd"):
        from_flax(smaller, model)


def test_cascade_freeze_mask_matches_jax(r101_cascade):
    """The config's fixed_param over every leaf: the port's mask (through
    flax_path) equals the JAX freeze_mask."""
    from simpledet_tpu.core.optimizer import freeze_mask as j_freeze_mask
    from simpledet_torch.core.optimizer import freeze_mask

    model, jmodel, shapes = r101_cascade
    fixed = jmodel.pretrain.fixed_param
    want = dict(_flat(j_freeze_mask(shapes, fixed)))
    got = {flax_path(k): v for k, v in freeze_mask(model, fixed).items()}
    assert got == want and len(got) == 358


# ------------------------------------------------ serving breakdown, CLIs


def test_breakdown_splits_the_cascade_by_stage():
    """The serving breakdown's stages of a cascade config: each stage's
    RoIAlign and head, then the score averaging; run in order they give the
    detections of Detector.detect."""
    from simpledet_torch.breakdown import stages
    from simpledet_torch.infer import Detector, synthetic_batch

    det = Detector(CONVERGE, device="cpu", seed=0)
    images, im_info = synthetic_batch(2, 128, 192, 0)
    steps = stages(det, images, im_info)
    assert [n for n, _ in steps] == [
        "normalize", "backbone_fpn", "rpn_head", "proposals",
        "roi_align_1st", "box_head_1st", "roi_align_2nd", "box_head_2nd",
        "roi_align_3rd", "box_head_3rd", "score_average", "per_class_nms"]
    with torch.no_grad():
        for _, fn in steps:
            got = fn()
    want = det.detect(images, im_info)
    assert want[3].any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture
def converge_dir(tmp_path, monkeypatch):
    """config/converge_cascade.py's data (the port's copy of the micro-set
    generator, 4 images), one epoch of batch 2, in a fresh directory."""
    from simpledet_torch.data.synthetic import make_micro_dataset

    root = tmp_path / "data"
    make_micro_dataset(str(root), n_images=4, set_names=("converge_train",))
    monkeypatch.setenv("CONVERGE_DATA_ROOT", str(root))
    monkeypatch.setenv("CONVERGE_CASCADE_EPOCHS", "1")
    monkeypatch.setenv("CONVERGE_CASCADE_BATCH", "2")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_cascade_cli_trains_and_evaluates(converge_dir):
    """The train CLI on config/converge_cascade.py for one epoch (4 images
    and their flips at batch 2: 4 steps); the config's metrics read the last
    step's aux; the checkpoint it writes holds the three heads and its
    running statistics; the test CLI evaluates on them."""
    from simpledet_torch.core import checkpoint as ckpt
    from simpledet_torch.core.metrics import from_config as \
        metrics_from_config
    from simpledet_torch.detection_test import main as test_main
    from simpledet_torch.detection_train import main as train_main

    config = os.path.join(REPO, CONVERGE)
    trainer = train_main(["--config", config, "--device", "cpu"])
    assert isinstance(trainer.model, CascadeRcnn)
    assert trainer.step_count == 4
    exp = converge_dir / "experiments" / "converge_cascade"
    metrics = metrics_from_config(read_config(config,
                                              is_train=True).metric_list)
    metrics.update({k: v.numpy() for k, v in trainer.aux.items()})
    got = dict(metrics.get())
    assert list(got) == ["RpnAcc", "RcnnAcc1st"]
    assert all(np.isfinite(v) for v in got.values())
    saved = ckpt.flatten(ckpt.read_params(str(exp / "checkpoint-0001.params")))
    assert {k[0] for k in saved} >= {"head_1st", "head_2nd", "head_3rd"}
    assert (exp / "checkpoint-0001.batch_stats").exists()
    summary = test_main(["--config", config, "--device", "cpu"])
    assert list(summary) == SUMMARY_KEYS
    assert all(np.isfinite(v) for v in summary.values())
    assert "loaded SyncBN running stats" in (exp / "log.txt").read_text()
