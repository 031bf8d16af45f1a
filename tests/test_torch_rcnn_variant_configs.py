"""The two-stage FPN variants' configs in the port, on the CPU.

- The 11 config files of this slice (`config/FPG/*`, the v1b dual head,
  the Mask Scoring R-CNN and TSD configs and their learning recipes) read
  and build (at depth 18, on the meta device) in both modes as the JAX
  package's reader builds them: the detector, the neck's kind, levels,
  width, stages and norm (none for the FPG configs, whose template keeps
  fixbn), the box head's kind and classes, the MaskIoU head, TSD's
  progressive-constraint settings.
- `simpledet_torch.config_coverage`: 132 of the 152 config files build in
  both modes, and each of the 20 left raises on its first unported
  component (knowledge distillation, CrowdHuman, EfficientNet, SE,
  cascade_c5_red_config).
- config/converge_tsd.py through the port's train CLI (2 iterations, batch
  1) and its test CLI from that checkpoint; config/converge_msrcnn.py
  through the train CLI and `simpledet_torch.mask_test` (bbox and segm).
  Each checkpoint's `.params` holds the JAX model's leaves at their shapes.
  The micro datasets, checkpoints and eval outputs live in temporary
  directories that the module removes when it ends.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_torch.config_coverage import config_files, probe
from simpledet_torch.core.config import read_config
from simpledet_torch.dsl import build_detector
from simpledet_torch.models.fpg import FPGNeck, PAFPNNeck
from simpledet_torch.models.fpn import FPNNeck
from simpledet_torch.models.heads import Bbox2fcHead, BboxDualHeadSmall
from simpledet_torch.models.msrcnn import MaskScoringFasterRcnn
from simpledet_torch.models.norm import SyncBN
from simpledet_torch.models.tsd import TSDBboxHead, TSDFasterRcnn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("config/FPG/faster_r50v1b_fpg6_128_syncbn_1x.py",
           "config/FPG/faster_r50v1b_fpg6_256_syncbn_1x.py",
           "config/FPG/faster_r50v1b_pafpn3_256_syncbn_1x.py",
           "config/FPG/faster_r50v1b_pafpn3_384_syncbn_1x.py",
           "config/resnet_v1b/faster_r50v1b_fpn_dualheadsmall_1x.py",
           "config/ms_r50v1_fpn_1x.py",
           "config/resnet_v1b/ms_r50v1b_fpn_1x.py",
           "config/converge_msrcnn.py",
           "config/TSD/tsd_r50v1_fpn_1x.py",
           "config/TSD/tsd_r50_rpn_1x.py",
           "config/converge_tsd.py")
# the config files that still raise, by the family of their first
# unported component
LEFT = {"FitNetFasterRcnn": 5, "FitNetRetinaNet": 2, "DoublePredRcnn": 4,
        "FPNRpnHeadwithIgnore": 1, "EfficientNetB5FPN": 3,
        "EfficientNetB4FPN": 1, "SEResNetFPN": 1, "MaskRcnnSe4convHead": 1,
        "cascade_c5_red_config": 2}


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


@pytest.mark.parametrize("is_train", [False, True], ids=["test", "train"])
@pytest.mark.parametrize("path", CONFIGS)
def test_config_builds_what_the_jax_reader_builds(path, is_train):
    sym = jax_symbol(path, is_train)
    spec = read_config(os.path.join(REPO, path), is_train=is_train)
    with torch.device("meta"):          # the modules, not their weights
        model = build_detector(spec, depth=18)
    assert type(model).__name__ == type(sym).__name__
    jn, neck = sym.neck, model.neck
    want_neck = {"FPNNeck": FPNNeck, "PAFPNNeckP2P6": PAFPNNeck,
                 "FPGNeckP2P6": FPGNeck}[type(jn).__name__]
    assert type(neck) is want_neck
    if want_neck is not FPNNeck:
        assert neck.levels == jn.levels and neck.num_stage == jn.num_stage
        assert neck.S0_P2.out_channels == jn.filters
        assert jn.norm is None and not any(
            isinstance(m, SyncBN) for m in neck.modules())
        assert model.rpn_module.rpn_conv.in_channels == jn.filters
    jh, head = sym.bbox_head, model.bbox_head
    assert type(head) is {"Bbox2fcHead": Bbox2fcHead,
                          "BboxDualHeadSmall": BboxDualHeadSmall,
                          "TSDBboxHead": TSDBboxHead}[type(jh).__name__]
    logit = head.cls_logit if hasattr(head, "cls_logit") else \
        head.tsd_cls_logit
    assert logit.out_features == jh.num_class
    if isinstance(head, BboxDualHeadSmall):
        assert head.num_block == jh.num_block and jh.norm is None
        assert not any(isinstance(m, SyncBN) for m in head.modules())
    if isinstance(model, MaskScoringFasterRcnn):
        jm, m = sym.maskiou_head, model.maskiou_head
        assert m.iou_head_pred.out_features == jm.num_class
        assert m.iou_head_conv_0.in_channels == 256 + 1
        assert (model.p_test is None) == is_train
    if isinstance(model, TSDFasterRcnn):
        p = model.p_tsd
        assert (p.pc_cls, p.pc_reg, p.pc_cls_margin, p.pc_reg_margin) == \
            (True, True, 0.2, 0.2)
        assert head.roi_size == 7 == model.p_roi.out_size


def test_coverage_counts_132_and_names_what_the_rest_lack():
    """Every config file under config/ probed as `python -m
    simpledet_torch.config_coverage` probes it: 132 of 152 build in both
    modes, these 11 among them; the other 20 each raise naming their first
    unported component."""
    files = config_files(os.path.join(REPO, "config"))
    errors = {os.path.relpath(p, REPO): probe(p, 18) for p in files}
    assert len(files) == 152
    assert sum(e is None for e in errors.values()) == 132
    for path in CONFIGS:
        assert errors[path] is None, (path, errors[path])
    left = {p: e for p, e in errors.items() if e is not None}
    for what, n in LEFT.items():
        assert sum(f"'{what}'" in e for e in left.values()) == n, what
    assert sum(LEFT.values()) == len(left) == 20


# ----------------------------------------------------- the learning recipes


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A directory for the CLIs' data, checkpoints and eval outputs, with a
    rectangle micro-COCO (`converge`) and an ellipse one (`ellipse`),
    removed when the module ends."""
    from simpledet_torch.data.synthetic import make_micro_dataset

    root = tmp_path_factory.mktemp("rcnn_variants")
    make_micro_dataset(str(root / "converge"), n_images=8,
                       set_names=("converge_train",))
    make_micro_dataset(str(root / "ellipse"), n_images=8,
                       set_names=("converge_train",), shapes="ellipse")
    yield root
    shutil.rmtree(root, ignore_errors=True)


def train_and_check_leaves(name, data, workdir, monkeypatch):
    """The recipe at batch 1 for 2 iterations through the train CLI in
    `workdir`: finite losses; checkpoint-0001.params with every leaf of the
    JAX package's model at its shape. Returns the loss history."""
    from simpledet_torch.core import checkpoint as ckpt
    from simpledet_torch.detection_train import train_net

    prefix_env = name.upper()
    monkeypatch.setenv("CONVERGE_DATA_ROOT", str(workdir / data))
    monkeypatch.setenv(f"{prefix_env}_EPOCHS", "1")
    monkeypatch.setenv(f"{prefix_env}_BATCH", "1")
    monkeypatch.chdir(workdir)
    history = []
    train_net(os.path.join(REPO, "config", f"{name}.py"), 2, device="cpu",
              loss_history=history)
    assert len(history) == 2
    assert all(np.isfinite(h["total_loss"]) for h in history)
    params = ckpt.read_params(ckpt.params_path(
        f"experiments/{name}/checkpoint", 1))
    sym = jax_symbol(f"config/{name}.py", True)
    shapes = jax.eval_shape(
        lambda r: sym.init(r, jnp.zeros((1, 128, 192, 3)),
                           jnp.float32([[128, 192, 1.0]]), mode="test"),
        {"params": jax.random.PRNGKey(0)})
    assert dict(_leaves(params)) == dict(_leaves(shapes["params"]))
    return history


def test_converge_tsd_train_and_test_cli(workdir, monkeypatch):
    """converge_tsd: the TSD losses in the train CLI's history; the test
    CLI on 4 images from the checkpoint: the COCO summary."""
    from simpledet_torch.detection_test import test_net

    history = train_and_check_leaves("converge_tsd", "converge", workdir,
                                     monkeypatch)
    assert {"tsd_cls_loss", "tsd_reg_loss", "tsd_cls_pc_loss",
            "tsd_reg_pc_loss"} <= set(history[0])
    stats = {}
    summary = test_net(os.path.join(REPO, "config", "converge_tsd.py"), 4,
                       device="cpu", stats=stats)
    assert stats["images"] == 4
    assert set(summary) >= {"AP", "AP50", "AP75"}


def test_converge_msrcnn_train_and_mask_test_cli(workdir, monkeypatch):
    """converge_msrcnn: maskiou_loss in the train CLI's history; mask_test
    on 4 images from the checkpoint: bbox and segm summaries and the segm
    result json."""
    from simpledet_torch.mask_test import mask_test_net

    history = train_and_check_leaves("converge_msrcnn", "ellipse", workdir,
                                     monkeypatch)
    assert "maskiou_loss" in history[0]
    stats = {}
    summaries = mask_test_net(
        os.path.join(REPO, "config", "converge_msrcnn.py"), 4, device="cpu",
        stats=stats)
    assert stats["images"] == 4
    assert set(summaries) == {"bbox", "segm"}
    assert set(summaries["segm"]) >= {"AP", "AP50", "AP75"}
    assert (workdir / "experiments" / "converge_msrcnn"
            / "converge_train_segm_result.json").exists()
