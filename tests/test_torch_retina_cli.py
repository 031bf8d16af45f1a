"""The port's train and test CLIs on RetinaNet: config/retina_micro_test.py
(P3-P7 neck 256 wide, towers 32 wide, 4 classes, 128 x 192) with its
backbone cut to depth 18 (a copy of the config whose backbone class sets
`depth = 18`, as the converge configs' TinyBackbone does), on the synthetic
micro-COCO of tests/fixtures.py, on the CPU. The test CLI against the JAX
package's `detection_test.test_net` from one JAX-written checkpoint; the
train CLI writing a checkpoint that the test CLI reads."""
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
from simpledet_torch.dsl import build_detector
from simpledet_torch.models.norm import fold_batch_stats
from simpledet_torch.ops.image import device_normalize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO_CONFIG = os.path.join(REPO, "config", "retina_micro_test.py")
PREFIX = "experiments/retina_micro_test/checkpoint"
SUMMARY_KEYS = ["AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
                "AR100", "ARs", "ARm", "ARl"]
DEPTH18 = """    class Backbone18(Backbone):
        depth = 18

    backbone = Backbone18(BackboneParam)"""


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module's tests run: the tier-1
    command runs 6 test workers on the CPU's cores, and torch's default of
    a thread a core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """The micro-COCO; its val set and annotations cut to the 4 landscape
    images (one padded shape, so the JAX side compiles one forward)."""
    root = tmp_path_factory.mktemp("micro")
    _, ann_path = make_micro_dataset(str(root), n_images=8)
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
    with open(MICRO_CONFIG) as f:
        text = f.read()
    old = "    backbone = Backbone(BackboneParam)"
    assert old in text
    with open(root / "retina_micro_test.py", "w") as f:
        f.write(text.replace(old, DEPTH18))
    return root


@pytest.fixture
def config(micro, tmp_path, monkeypatch):
    """The depth-18 copy of the config, run from a fresh working directory
    (experiments/ lands there) with the micro data where it looks."""
    monkeypatch.setenv("MICRO_DATA_ROOT", str(micro))
    monkeypatch.chdir(tmp_path)
    return str(micro / "retina_micro_test.py")


def _jax_written_checkpoint(config):
    """checkpoint-0001.params written by the JAX package's save_checkpoint:
    the port's seeded micro RetinaNet with one val batch's statistics folded
    into FrozenBN, its class predictor's kernel scaled by 40, so that scores
    spread past min_det_score (at the Flax init every score sits near the
    0.01 prior). Scaling the towers by 4 as well (4 x 4 x 10) amplified the
    packages' float32 differences to 1.8e-5 in a score."""
    spec = read_config(config)
    model = build_detector(spec)
    assert len(model.backbone.units[0]) == 2         # depth 18
    model.init_weights(torch.Generator().manual_seed(0))
    roidb = load_roidb(spec.dataset.image_set, spec.dataset.cache_dir)
    batch = next(iter(Loader(roidb, from_config(spec.transform), 4,
                             shuffle=False, num_workers=0)))
    data = device_normalize(torch.from_numpy(batch["data"]),
                            torch.from_numpy(batch["im_info"]),
                            *spec.pixel_norm)
    fold_batch_stats(model.backbone, data.permute(0, 3, 1, 2))
    with torch.no_grad():
        model.head_module.cls_pred.weight.mul_(40.0)
    j_save(PREFIX, 1, ckpt.to_flax(model))


def _template_init():
    """Flax's Module.init as zeros of the shapes it would make
    (`jax.eval_shape` traces the model without compiling it)."""
    orig_init = flax.linen.Module.init

    def init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(
            lambda r, *x: orig_init(self, r, *x, **kwargs), rngs, *args)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    return init


def test_test_cli_matches_jax_test_net(config, tmp_path, monkeypatch):
    """From one JAX-written checkpoint, `detection_test.test_net` and the
    port's test CLI give the same detections and the same COCO summary.
    Result rows are float32 boxes rounded to 0.01 px and scores to 1e-6:
    boxes within 1e-3 px of each other before that rounding land at most
    one step apart after it, 0.01 px plus the float32 spacing of a
    coordinate under 256 (1.5e-5); scores within 1e-5."""
    from detection_test import test_net as j_test_net
    from simpledet_torch.detection_test import main

    _jax_written_checkpoint(config)
    result = tmp_path / "experiments" / "retina_micro_test" / \
        "micro_val_result.json"
    monkeypatch.setenv("SIMPLEDET_EVAL_DEVICES", "1")
    # test_net's eager Flax init only makes the template that the
    # checkpoint replaces leaf by leaf: its shapes are enough
    monkeypatch.setattr(flax.linen.Module, "init", _template_init())
    want_summary = j_test_net(config, max_images=4)
    want = json.loads(result.read_text())
    os.remove(result)
    got_summary = main(["--config", config, "--max-images", "4",
                        "--device", "cpu"])
    got = json.loads(result.read_text())
    assert list(got_summary) == SUMMARY_KEYS
    assert got_summary == want_summary
    assert len(got) == len(want) > 8

    def key(d):
        return (d["image_id"], d["category_id"], -d["score"])

    got, want = sorted(got, key=key), sorted(want, key=key)
    assert [(d["image_id"], d["category_id"]) for d in got] == \
        [(d["image_id"], d["category_id"]) for d in want]
    gb = np.array([d["bbox"] for d in got])
    wb = np.array([d["bbox"] for d in want])
    assert np.abs(gb - wb).max() <= 0.01 + 1.5e-5
    np.testing.assert_allclose([d["score"] for d in got],
                               [d["score"] for d in want], rtol=0, atol=1e-5)


def test_train_cli_writes_a_checkpoint_the_test_cli_reads(config, tmp_path):
    """Two iterations of the train CLI (the config logs every 2): finite
    focal and smooth-L1 losses, the config's Focal metric logged;
    checkpoint-0001 holds the trained model bit for bit in the JAX format
    (and .torch_states); the test CLI loads it and reports the 12-key
    summary on 2 images."""
    from simpledet_torch.detection_test import test_net
    from simpledet_torch.detection_train import train_net

    history = []
    trainer = train_net(config, 2, device="cpu", loss_history=history)
    assert trainer.step_count == 2 and len(history) == 2
    for h in history:
        assert set(h) == {"retina_cls_loss", "retina_reg_loss", "total_loss"}
        assert all(np.isfinite(v) for v in h.values())
    assert ckpt.get_latest_ckpt_epoch(PREFIX) == 1
    assert os.path.exists(PREFIX + "-0001.torch_states")
    flat = ckpt.flatten(ckpt.read_params(PREFIX + "-0001.params"))
    trained = ckpt.flatten(ckpt.to_flax(trainer.model))
    assert flat.keys() == trained.keys()
    for k, v in trained.items():
        assert np.array_equal(flat[k], v), k
    log = tmp_path / "experiments" / "retina_micro_test" / "log.txt"
    assert "Focal=" in log.read_text()
    stats = {}
    summary = test_net(config, 2, device="cpu", stats=stats)
    assert list(summary) == SUMMARY_KEYS and stats["images"] == 2
    assert f"loaded {PREFIX}-0001.params" in log.read_text()
