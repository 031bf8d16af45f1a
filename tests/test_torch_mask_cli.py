"""The mask configs through the port's reader and `build_detector`, the
full-width Flax leaf map, and the port's Mask R-CNN CLIs on the CPU: the
eval CLI (`simpledet_torch.mask_test`) against the JAX package's
`mask_test.mask_test_net` from one JAX-written checkpoint, and the train
CLI writing a checkpoint that the eval CLI reads. The CLIs run
config/mask_micro_test.py with its backbone cut to depth 18 (a copy of the
config with `depth = 18` on its backbone class, as config/converge_mask.py
cuts its own) on an ellipse micro-COCO of tests/fixtures.py."""
import json
import os
import pickle

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_micro_dataset
from simpledet_tpu.core.checkpoint import save_checkpoint as j_save
from simpledet_torch.core import checkpoint as ckpt
from simpledet_torch.core.config import read_config
from simpledet_torch.data.loader import Loader
from simpledet_torch.data.roidb import load_roidb
from simpledet_torch.data.transforms import from_config
from simpledet_torch.dsl import build_detector, detector_from_config
from simpledet_torch.models.norm import fold_batch_stats
from simpledet_torch.ops.image import device_normalize
from simpledet_torch.weights import from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("config/mask_r50v1_fpn_1x.py", "config/converge_mask.py",
           "config/mask_micro_test.py")
MEAN, STD = (122.7717, 115.9465, 102.9801), (1.0, 1.0, 1.0)
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


# ------------------------------------------------------------ the configs


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("path", CONFIGS)
def test_mask_configs_read_and_build(path, is_train):
    """Each mask config, unedited: the eight components (seven in training)
    under the JAX DSL's argument names, the mask head's three param classes,
    the pixel normalisation from models.maskrcnn.input's Norm2DImage, the
    polygon label in training; a MaskFasterRcnn at the config's mask
    resolution and RoIAlign sizes, in train or eval mode, with the
    BboxPostProcessor's NMS settings at test time."""
    spec = read_config(path, is_train=is_train)
    assert spec.detector == "MaskFasterRcnn"
    assert spec.pixel_norm == (MEAN, STD)
    roles = {"backbone", "neck", "rpn_head", "roi_extractor",
             "mask_roi_extractor", "bbox_head", "mask_head"}
    assert set(spec.components) == roles | (set() if is_train else
                                            {"bbox_post_processor"})
    head = spec.components["mask_head"]
    assert head.name == "MaskFasterRcnn4ConvHead" and len(head.params) == 3
    assert head.params[2].out_size == \
        spec.components["mask_roi_extractor"].param.out_size
    assert ("gt_poly" in spec.label_name) == is_train
    model, _ = detector_from_config(path, device="cpu", is_train=is_train)
    assert model.training == is_train
    p_mask = head.params[1]
    assert model.mask_size == p_mask.resolution
    assert model.p_roi.out_size == 7
    assert model.p_mask_roi.out_size == (7 if "micro" in path else 14)
    assert model.mask_head.num_class == head.params[0].num_class
    if not is_train:
        assert model.nms_params() == (
            spec.test.min_det_score, spec.test.nms.thr,
            spec.test.max_det_per_image)


def test_full_width_leaf_map_matches_flax():
    """config/mask_r50v1_fpn_1x.py's test detector and the JAX package's
    Flax tree: every leaf maps with equal shapes, the mask head's among them
    (mask_up's kernel flipped)."""
    from simpledet_tpu.core.config import load_config as j_load_config

    path = "config/mask_r50v1_fpn_1x.py"
    model = build_detector(read_config(path))
    jmodel = j_load_config(path).get_config(is_train=False)[6].test_symbol
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros((1, 128, 160, 3)), jnp.asarray([[128, 160, 1.0]]),
        mode="test"))["params"]
    leaves = jax.tree_util.tree_leaves(shapes)
    assert len(leaves) == len(model.state_dict()) == 189 + 12
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    from_flax(params, model)
    up = params["mask_head"]["mask_up"]["kernel"]
    assert up.shape == (2, 2, 256, 256)
    np.testing.assert_array_equal(
        model.state_dict()["mask_head.mask_up.weight"].numpy(),
        up[::-1, ::-1].transpose(2, 3, 0, 1))
    assert model.state_dict()["mask_head.mask_fcn_logit.weight"].shape == \
        (81, 256, 1, 1)


# ----------------------------------------------------------------- the CLIs


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """The ellipse micro-COCO, its val set and annotations cut to the 4
    landscape images, and the depth-18 copy of config/mask_micro_test.py."""
    root = tmp_path_factory.mktemp("mask_micro")
    _, ann_path = make_micro_dataset(str(root), n_images=8, shapes="ellipse")
    with open(root / "cache" / "micro_val.roidb", "rb") as f:
        val = [r for r in pickle.load(f) if r["h"] < r["w"]]
    with open(root / "cache" / "micro_val.roidb", "wb") as f:
        pickle.dump(val, f)
    with open(ann_path) as f:
        ann = json.load(f)
    keep = {r["im_id"] for r in val}
    ann["images"] = [im for im in ann["images"] if im["id"] in keep]
    ann["annotations"] = [a for a in ann["annotations"]
                          if a["image_id"] in keep]
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    with open(os.path.join(REPO, "config", "mask_micro_test.py")) as f:
        text = f.read()
    old = "from models.maskrcnn.builder import MSRAResNet50V1FPN as Backbone\n"
    assert old in text
    text = text.replace(old, (
        "from models.maskrcnn.builder import MSRAResNet50V1FPN\n\n\n"
        "class Backbone(MSRAResNet50V1FPN):\n    depth = 18\n"))
    config = root / "mask_micro_r18.py"
    config.write_text(text)
    return root, str(config)


@pytest.fixture
def in_tmp(micro, tmp_path, monkeypatch):
    monkeypatch.setenv("MICRO_DATA_ROOT", str(micro[0]))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _jax_written_checkpoint(config):
    """experiments/mask_micro_test/checkpoint-0001.params written by the JAX
    package's save_checkpoint: the port's seeded detector with one val
    batch's statistics folded into FrozenBN, its RPN and class logits scaled
    up so that scores spread far apart (no near-tie for a top-k or NMS)."""
    spec = read_config(config)
    model = build_detector(spec)
    assert len(model.backbone.units[0]) == 2        # depth 18
    model.init_weights(torch.Generator().manual_seed(0))
    roidb = load_roidb(spec.dataset.image_set, spec.dataset.cache_dir)
    batch = next(iter(Loader(roidb, from_config(spec.transform), 4,
                             shuffle=False, num_workers=0)))
    data = device_normalize(torch.from_numpy(batch["data"]),
                            torch.from_numpy(batch["im_info"]),
                            *spec.pixel_norm)
    fold_batch_stats(model.backbone, data.permute(0, 3, 1, 2))
    with torch.no_grad():
        model.rpn_module.rpn_cls.weight.mul_(300.0)
        model.bbox_head.cls_logit.weight.mul_(300.0)
    j_save("experiments/mask_micro_test/checkpoint", 1, ckpt.to_flax(model))


def test_mask_test_matches_jax_mask_test_net(micro, in_tmp, monkeypatch):
    """From one JAX-written checkpoint, `mask_test.mask_test_net` and the
    port's eval CLI give bbox and segm summaries within 1e-6, and result
    jsons whose detections agree: classes identical, boxes within 1e-3 px,
    scores within 1e-5, every mask's COCO RLE identical (boxes that far
    apart paste the same pixels)."""
    from mask_test import mask_test_net as j_mask_test_net
    from simpledet_torch.mask_test import main

    config = micro[1]
    _jax_written_checkpoint(config)
    result = (in_tmp / "experiments" / "mask_micro_test"
              / "micro_val_segm_result.json")
    monkeypatch.setenv("SIMPLEDET_EVAL_DEVICES", "1")
    # mask_test_net's eager Flax init only makes the template that the
    # checkpoint then replaces leaf by leaf; jitted it is one compile
    orig_init = flax.linen.Module.init
    monkeypatch.setattr(flax.linen.Module, "init", lambda self, rngs, *a, **k:
                        jax.jit(lambda r, *x: orig_init(self, r, *x, **k))(
                            rngs, *a))
    want_summary = j_mask_test_net(config, max_images=4)
    want = json.loads(result.read_text())
    os.remove(result)
    got_summary = main(["--config", config, "--max-images", "4",
                        "--device", "cpu"])
    got = json.loads(result.read_text())
    assert set(got_summary) == {"bbox", "segm"}
    for kind in ("bbox", "segm"):
        assert list(got_summary[kind]) == SUMMARY_KEYS
        for k in SUMMARY_KEYS:
            assert abs(got_summary[kind][k] - want_summary[kind][k]) <= 1e-6
    assert len(got) == len(want) > 4

    def key(d):
        return (d["image_id"], d["category_id"], -d["score"])

    got, want = sorted(got, key=key), sorted(want, key=key)
    assert [(d["image_id"], d["category_id"]) for d in got] == \
        [(d["image_id"], d["category_id"]) for d in want]
    assert np.abs(np.array([d["bbox"] for d in got])
                  - np.array([d["bbox"] for d in want])).max() <= 1e-3
    np.testing.assert_allclose([d["score"] for d in got],
                               [d["score"] for d in want], rtol=0, atol=1e-5)
    assert [d["segmentation"] for d in got] == \
        [d["segmentation"] for d in want]
    assert all(isinstance(d["segmentation"]["counts"], str) for d in got)


def test_train_cli_writes_a_checkpoint_mask_test_reads(micro, in_tmp):
    """Two iterations of the train CLI on the mask config (polygons through
    the loader, the mask loss in the MaskCE metric): finite losses with a
    mask_loss, checkpoint-0001 holding the trained model bit for bit; the
    eval CLI loads it and reports both 12-key summaries."""
    from simpledet_torch.detection_train import train_net
    from simpledet_torch.mask_test import mask_test_net

    config = micro[1]
    history = []
    trainer = train_net(config, 2, device="cpu", loss_history=history)
    assert trainer.step_count == 2 and len(history) == 2
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert all(h["mask_loss"] > 0 for h in history)
    prefix = "experiments/mask_micro_test/checkpoint"
    flat = ckpt.flatten(ckpt.read_params(prefix + "-0001.params"))
    for k, v in ckpt.flatten(ckpt.to_flax(trainer.model)).items():
        assert np.array_equal(flat[k], v), k
    assert ("mask_head", "mask_up", "kernel") in flat
    log = (in_tmp / "experiments" / "mask_micro_test" / "log.txt").read_text()
    assert "MaskCE=" in log
    stats = {}
    summaries = mask_test_net(config, device="cpu", stats=stats)
    assert set(summaries) == {"bbox", "segm"} and stats["images"] == 4
    assert all(list(s) == SUMMARY_KEYS for s in summaries.values())


def test_mask_test_refuses_what_is_not_ported(micro, in_tmp, monkeypatch):
    """A config without a mask head, and mesh-sharded eval, raise."""
    from simpledet_torch.mask_test import mask_test_net

    with pytest.raises(ValueError, match="no mask head"):
        mask_test_net(os.path.join(REPO, "config", "micro_test.py"),
                      device="cpu")
    monkeypatch.setenv("SIMPLEDET_EVAL_DEVICES", "8")
    with pytest.raises(NotImplementedError, match="mesh"):
        mask_test_net(micro[1], device="cpu")
