"""The C4 / TridentNet configs in the port, on the CPU: the 43 configs that
`trident_c4_config` (without a `backbone=` override: the DCN C4 configs
are tests/test_torch_dcn_sepc_configs.py's) or a direct
TridentFasterRcnn assembly give read and build (at depth 18) in both modes
as the JAX package's reader builds them; the multi-scale resize against the
JAX package's under one numpy seed; config/converge_trident.py through the
port's train CLI (2 iterations), its checkpoint's leaves those of the JAX
package's model, then the test CLI; and `python -m simpledet_torch.rpn_test`
on config/rpn_r50v2c4_1x.py (the RPN detector on the C4 v2 backbone) at the
config's 800 x 1333."""
import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_torch.core.config import read_config
from simpledet_torch.dsl import C4_BACKBONES, build_detector
from simpledet_torch.models.faster_rcnn import RpnOnly
from simpledet_torch.models.norm import FrozenBN, SyncBN
from simpledet_torch.models.tridentnet import (TridentFasterRcnn,
                                               TridentResNetC4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRECT = ("config/converge_trident.py",
          "config/faster_r50v2c4_c5_256roi_1x.py",
          "config/tridentnet_r50v2c4_c5_1x.py")


def _template_configs():
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "config", "**", "*.py"),
                                 recursive=True)):
        with open(path) as f:
            text = f.read()
        if "trident_c4_config(" in text and "backbone=" not in text \
                and "def trident_c4_config" not in text:
            out.append(os.path.relpath(path, REPO))
    return out


CONFIGS = _template_configs() + list(DIRECT)


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


def test_the_list_is_the_43_configs():
    """40 configs on the template and the three direct assemblies; the six
    DCN C4 ones pass `backbone=` and are held in
    tests/test_torch_dcn_sepc_configs.py."""
    assert len(set(CONFIGS)) == 43
    assert not [c for c in CONFIGS if "/dcn/" in c]
    assert "config/rpn_r50v2c4_1x.py" in CONFIGS
    assert "config/int8/faster_r50v1bc4_c5_512roi_1x.py" in CONFIGS


def _jax_variant(bb):
    return "v2" if type(bb).__name__ == "TridentResNetV2C4" else bb.variant


@pytest.mark.parametrize("is_train", [False, True], ids=["test", "train"])
@pytest.mark.parametrize("path", CONFIGS)
def test_config_builds_what_the_jax_reader_builds(path, is_train):
    """The same detector with the same backbone variant, branches,
    dilations, normalizer and compute dtype; a TridentFasterRcnn with the
    same scale-aware flag and ranges, C5 head variant, classes and RoI
    size; the RPN head's width; the fixed parameters."""
    sym = jax_symbol(path, is_train)
    spec = read_config(os.path.join(REPO, path), is_train=is_train)
    with torch.device("meta"):          # the modules, not their weights
        model = build_detector(spec, depth=18)
    assert type(model).__name__ == type(sym).__name__
    assert isinstance(model, (TridentFasterRcnn, RpnOnly))
    jbb, bb = sym.backbone, model.backbone
    assert spec.components["backbone"].name in C4_BACKBONES
    assert isinstance(bb, TridentResNetC4)
    assert bb.variant == _jax_variant(jbb)
    assert bb.dilations == tuple(jbb.dilations[:jbb.num_branch])
    assert bb.dtype == (torch.bfloat16 if jbb.dtype == jnp.bfloat16
                        else torch.float32)
    norm = {"fixbn": FrozenBN, "syncbn": SyncBN}[jbb.norm.type]
    kinds = {type(m) for m in model.modules()
             if isinstance(m, (FrozenBN, SyncBN))}
    assert kinds == {norm}
    assert model.rpn_module.rpn_conv.out_channels == \
        sym.rpn.p.head.conv_channel
    assert model.rpn_module.rpn_conv.in_channels == 1024
    if isinstance(model, TridentFasterRcnn):
        assert model.num_branch == sym.num_branch == len(bb.dilations)
        assert model.scaleaware == sym.scaleaware
        if model.scaleaware:
            assert model.valid_ranges == tuple(
                (lo, hi if hi > 0 else 1e5) for lo, hi in sym.valid_ranges)
        jh, head = sym.bbox_head, model.bbox_head
        assert head.variant == ("v2" if type(jh).__name__ == "BboxC5V2Head"
                                else jh.variant)
        assert head.cls_logit.out_features == jh.num_class
        assert head.bbox_delta.out_features == 4 * jh.num_reg_class
        assert head.dtype == bb.dtype
        assert model.p_roi.out_size == sym.p_roi.out_size
    if is_train:
        want_fixed = ([] if "scratch" in path or "converge" in path
                      else ["conv0", "stage1", "scale", "bias"])
        assert list(spec.fixed_param) == want_fixed


def test_other_keywords_stay_refused(tmp_path):
    """The reader reads TridentFasterRcnn's num_branch, scaleaware and
    valid_ranges, and still refuses any other keyword."""
    path = tmp_path / "cfg.py"
    with open(os.path.join(REPO, "config", "faster_r50v2c4_c5_256roi_1x.py")) \
            as f:
        text = f.read()
    key = "scaleaware=Trident.train_scaleaware"
    assert key in text
    path.write_text(text.replace(key, key + ", mask=None"))
    with pytest.raises(NotImplementedError, match="mask"):
        read_config(str(path), is_train=True)


def test_rand_resize_matches_jax_under_a_numpy_seed():
    """RandResize2DImageBbox of multiscale_transforms' three scales on six
    records of both orientations: the same picks, images, gt and im_info
    as the JAX package's under np.random.seed(3)."""
    from simpledet_tpu.data.transforms import RandResize2DImageBbox as J
    from simpledet_torch.data.transforms import RandResize2DImageBbox as T

    class P:
        short = (600, 800, 1000)
        long = (1000, 1333, 1600)

    rng = np.random.RandomState(0)
    records = []
    for i in range(6):
        h, w = (120, 160) if i % 2 else (160, 120)
        records.append(dict(
            image=rng.randint(0, 256, (h, w, 3), np.uint8),
            gt_bbox=np.float32([[5, 6, 50, 70], [20, 30, 110, 100]])))
    outs = []
    for cls in (J, T):
        np.random.seed(3)
        t = cls(P)
        outs.append([t.apply({k: v.copy() for k, v in r.items()})
                     for r in records])
    infos = {tuple(r["im_info"][:2]) for r in outs[1]}
    assert len(infos) >= 3
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["gt_bbox"], want["gt_bbox"])
        np.testing.assert_array_equal(got["im_info"], want["im_info"])


def test_multiscale_configs_take_the_rand_resize():
    """The three *multiscale* configs' train chains hold the port's
    RandResize2DImageBbox with the three scales, padded to the largest."""
    from simpledet_torch.data.transforms import (Pad2DImageBbox,
                                                 RandResize2DImageBbox,
                                                 from_config)

    paths = [c for c in CONFIGS if "multiscale" in c]
    assert len(paths) == 3
    for path in paths:
        chain = from_config(read_config(os.path.join(REPO, path),
                                        is_train=True).transform)
        (rr,) = [t for t in chain if isinstance(t, RandResize2DImageBbox)]
        assert rr.scales == [(600, 1000), (800, 1333), (1000, 1600)]
        (pad,) = [t for t in chain if isinstance(t, Pad2DImageBbox)]
        assert (pad.short, pad.long) == (1000, 1600)


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    from simpledet_torch.data.synthetic import make_micro_dataset

    root = tmp_path_factory.mktemp("converge")
    make_micro_dataset(str(root), n_images=8, set_names=("converge_train",))
    return root


def test_converge_trident_train_checkpoint_test_cli(micro, tmp_path,
                                                    monkeypatch):
    """config/converge_trident.py (three branches, SyncBN, scale-aware) at
    batch 1 through the port's train CLI for 2 iterations: finite losses,
    checkpoint-0001.params and .batch_stats with every leaf of the JAX
    package's model (`jax.eval_shape` of its init) at its shape, the shared
    kernels `conv2_kernel` HWIO; then the test CLI from that checkpoint on
    4 images: the COCO summary and the running statistics loaded."""
    from simpledet_torch.core import checkpoint as ckpt
    from simpledet_torch.detection_test import test_net
    from simpledet_torch.detection_train import train_net

    config = os.path.join(REPO, "config", "converge_trident.py")
    monkeypatch.setenv("CONVERGE_DATA_ROOT", str(micro))
    monkeypatch.setenv("CONVERGE_TRIDENT_EPOCHS", "1")
    monkeypatch.chdir(tmp_path)
    history = []
    trainer = train_net(config, 2, device="cpu", loss_history=history)
    assert len(history) == 2
    assert all(np.isfinite(h["total_loss"]) for h in history)
    assert trainer.model.num_branch == 3
    prefix = "experiments/converge_trident/checkpoint"
    params = ckpt.read_params(ckpt.params_path(prefix, 1))

    sym = jax_symbol("config/converge_trident.py", True)
    shapes = jax.eval_shape(
        lambda r: sym.init(r, jnp.zeros((1, 128, 192, 3)),
                           jnp.float32([[128, 192, 1.0]]), mode="test"),
        {"params": jax.random.PRNGKey(0),
         "sampling": jax.random.PRNGKey(1)})

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if hasattr(v, "items"):
                yield from leaves(v, prefix + (k,))
            else:
                yield "/".join(prefix + (k,)), tuple(v.shape)

    assert dict(leaves(params)) == dict(leaves(shapes["params"]))
    assert params["backbone"]["stage3_unit1"]["conv2_kernel"].shape == \
        (3, 3, 256, 256)
    with open(ckpt.batch_stats_path(prefix, 1), "rb") as f:
        stats = ckpt.from_bytes(f.read())
    assert dict(leaves(stats)) == dict(leaves(shapes["batch_stats"]))

    stats_out = {}
    summary = test_net(config, 4, device="cpu", stats=stats_out)
    assert stats_out["images"] == 4
    assert set(summary) >= {"AP", "AP50", "AP75"}
    log = (tmp_path / "experiments" / "converge_trident" /
           "log.txt").read_text()
    assert "loaded SyncBN running stats" in log


def test_rpn_test_cli_on_the_c4_rpn_config(micro, tmp_path, monkeypatch):
    """`python -m simpledet_torch.rpn_test --config config/rpn_r50v2c4_1x.py`
    on one micro-COCO image at 800 x 1333 (seeded weights: no checkpoint):
    the RPN detector on ResNet-50 v2 C4 (one branch at dilation 1, the
    1024-channel stride-16 map, 300 proposals) reports a recall for each
    budget."""
    from simpledet_torch.rpn_test import main

    os.makedirs(tmp_path / "data" / "cache")
    with open(micro / "cache" / "converge_train.roidb", "rb") as f:
        roidb = pickle.load(f)
    with open(tmp_path / "data" / "cache" / "coco_val2017.roidb", "wb") as f:
        pickle.dump(roidb[:1], f)
    monkeypatch.chdir(tmp_path)
    spec = read_config(os.path.join(REPO, "config", "rpn_r50v2c4_1x.py"))
    assert spec.detector == "RPN"
    assert spec.components["rpn_head"].param.proposal.post_nms_top_n == 300
    got = main(["--config", os.path.join(REPO, "config", "rpn_r50v2c4_1x.py"),
                "--max-images", "1", "--device", "cpu"])
    assert set(got) == {100, 300, 1000}
    assert 0.0 <= got[100] <= got[300] == got[1000] <= 1.0
    log = tmp_path / "experiments" / spec.name / "log.txt"
    assert "Recall@300" in log.read_text()
