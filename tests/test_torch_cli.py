"""The port's train and test CLIs (`simpledet_torch.detection_train`,
`simpledet_torch.detection_test`) on config/micro_test.py and the synthetic
micro-COCO of tests/fixtures.py, on the CPU: the test CLI against the JAX
package's `detection_test.test_net` from one JAX-written checkpoint, and the
train CLI writing a checkpoint that the test CLI reads."""
import json
import os
import pickle

import flax.linen
import jax
import numpy as np
import pytest
import torch

from fixtures import make_micro_dataset
from simpledet_tpu.core.checkpoint import save_checkpoint as j_save
from simpledet_torch.core import checkpoint as ckpt
from simpledet_torch.core.config import patch_config_as_nothrow, read_config
from simpledet_torch.data.loader import Loader
from simpledet_torch.data.roidb import load_roidb
from simpledet_torch.data.transforms import from_config
from simpledet_torch.dsl import build_detector
from simpledet_torch.models.norm import fold_batch_stats
from simpledet_torch.ops.image import device_normalize
from tmp_cleanup import collect_tmp_path, module_tmp_dirs  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = os.path.join(REPO, "config", "micro_test.py")
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


@pytest.fixture(scope="module")
def micro(tmp_path_factory, module_tmp_dirs):
    """The micro-COCO; its val set and annotations cut to the 4 landscape
    images (one padded shape, so the JAX side compiles one forward)."""
    root = tmp_path_factory.mktemp("micro")
    module_tmp_dirs.append(root)
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
    return root


@pytest.fixture
def in_tmp(micro, tmp_path, monkeypatch):
    """Run in a fresh directory (experiments/ lands there), the micro data
    where the config looks for it."""
    monkeypatch.setenv("MICRO_DATA_ROOT", str(micro))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _jax_written_checkpoint():
    """experiments/micro_test/checkpoint-0001.params written by the JAX
    package's save_checkpoint: the port's seeded micro detector with one val
    batch's statistics folded into FrozenBN (activations of order one), its
    RPN and class logits scaled up so that scores spread far apart (no
    near-tie for a top-k or NMS to break differently)."""
    spec = read_config(MICRO)
    model = build_detector(spec)
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
    j_save("experiments/micro_test/checkpoint", 1, ckpt.to_flax(model))


def test_test_cli_matches_jax_test_net(in_tmp, monkeypatch):
    """From one JAX-written checkpoint, `detection_test.test_net` and the
    port's test CLI give the same detections and the same COCO summary.
    result.json rows are rounded to 0.01 px and 1e-6: boxes within 1e-3 px
    before that rounding can land one step (0.01 px) apart after it, scores
    within 1e-5."""
    from detection_test import test_net as j_test_net
    from simpledet_torch.detection_test import main

    _jax_written_checkpoint()
    result = in_tmp / "experiments" / "micro_test" / "micro_val_result.json"
    # one device, so that the JAX side also evaluates in batches of 4
    monkeypatch.setenv("SIMPLEDET_EVAL_DEVICES", "1")
    # test_net's eager Flax init only makes the template that the checkpoint
    # then replaces leaf by leaf; jitted it is one compile instead of ~650
    orig_init = flax.linen.Module.init
    monkeypatch.setattr(flax.linen.Module, "init", lambda self, rngs, *a, **k:
                        jax.jit(lambda r, *x: orig_init(self, r, *x, **k))(
                            rngs, *a))
    want_summary = j_test_net(MICRO, max_images=4)
    want = json.loads(result.read_text())
    os.remove(result)
    got_summary = main(["--config", MICRO, "--max-images", "4",
                        "--device", "cpu"])
    got = json.loads(result.read_text())
    assert list(got_summary) == SUMMARY_KEYS
    assert got_summary == want_summary
    assert len(got) == len(want) > 4

    def key(d):
        return (d["image_id"], d["category_id"], -d["score"])

    got, want = sorted(got, key=key), sorted(want, key=key)
    assert [(d["image_id"], d["category_id"]) for d in got] == \
        [(d["image_id"], d["category_id"]) for d in want]
    gb = np.array([d["bbox"] for d in got])
    wb = np.array([d["bbox"] for d in want])
    assert np.abs(gb - wb).max() <= 0.01 + 1e-6
    np.testing.assert_allclose([d["score"] for d in got],
                               [d["score"] for d in want], rtol=0, atol=1e-5)


def test_train_cli_writes_a_checkpoint_the_test_cli_reads(in_tmp):
    """Two iterations of the train CLI on the CPU: finite losses, and
    checkpoint-0001 (the JAX format, plus the port's .torch_states) holds the
    trained model bit for bit; the test CLI loads it and reports the 12-key
    summary."""
    from simpledet_torch.detection_test import test_net
    from simpledet_torch.detection_train import main

    trainer = main(["--config", MICRO, "--max-iter", "2", "--device", "cpu"])
    assert trainer.step_count == 2
    prefix = "experiments/micro_test/checkpoint"
    assert ckpt.get_latest_ckpt_epoch(prefix) == 1
    assert os.path.exists(prefix + "-0001.torch_states")
    assert not os.path.exists(prefix + "-0001.states")   # the JAX package's
    trained = trainer.model.state_dict()
    flat = ckpt.flatten(ckpt.read_params(prefix + "-0001.params"))
    assert len(flat) == len(trained)
    for k, v in ckpt.flatten(ckpt.to_flax(trainer.model)).items():
        assert np.array_equal(flat[k], v), k
    spec = read_config(MICRO)
    fresh = build_detector(spec)
    ckpt.load_checkpoint(prefix, 1, fresh)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, trained[k].cpu()), k
    stats = {}
    summary = test_net(MICRO, device="cpu", stats=stats)
    assert list(summary) == SUMMARY_KEYS and stats["images"] == 4
    log = (in_tmp / "experiments" / "micro_test" / "log.txt").read_text()
    assert "loaded experiments/micro_test/checkpoint-0001.params" in log


def test_train_cli_resumes_from_the_latest_checkpoint(in_tmp):
    """--resume continues from checkpoint-0001 with its optimizer state and
    step count (one epoch of micro_test is over, so nothing more runs)."""
    from simpledet_torch.detection_train import main

    main(["--config", MICRO, "--max-iter", "1", "--device", "cpu"])
    trainer = main(["--config", MICRO, "--resume", "--device", "cpu"])
    assert trainer.step_count == 1
    assert trainer.optimizer.state_dict()["state"]
    log = (in_tmp / "experiments" / "micro_test" / "log.txt").read_text()
    assert "resumed from epoch 1 (with optimizer state)" in log


@pytest.mark.parametrize("field,value,what", [
    ("scales", [(600, 1000)], "multi-scale"),
    ("flip", True, "flip"),
    ("nms", "softnms", "softnms"),
    ("nms", "setnms", "setnms"),
])
def test_test_cli_refuses_what_is_not_ported(field, value, what):
    from simpledet_torch.detection_test import _refuse_unported

    class TestParam:
        class nms:
            type = "nms"

    if field == "nms":
        TestParam.nms.type = value
    else:
        setattr(TestParam, field, value)
    with pytest.raises(NotImplementedError, match=what):
        _refuse_unported(patch_config_as_nothrow(TestParam))


def test_test_cli_refuses_mesh_eval(monkeypatch):
    from simpledet_torch.detection_test import _refuse_unported

    monkeypatch.setenv("SIMPLEDET_EVAL_DEVICES", "8")
    with pytest.raises(NotImplementedError, match="mesh"):
        _refuse_unported(patch_config_as_nothrow(type("TestParam", (), {})))


# ------------------------------------------- optimizer state across packages


def test_train_cli_resumes_past_the_jax_packages_states(in_tmp):
    """Beside checkpoint-0001 lies the JAX package's `.states` (a pickle of
    optax state) and no `.torch_states`: --resume loads the params, ignores
    that file with a log line, and restarts the optimizer with the schedule
    fast-forwarded to the epoch's end."""
    import optax

    from simpledet_torch.detection_train import main

    first = main(["--config", MICRO, "--max-iter", "1", "--device", "cpu"])
    prefix = "experiments/micro_test/checkpoint"
    os.remove(prefix + "-0001.torch_states")
    params = ckpt.read_params(prefix + "-0001.params")
    j_save(prefix, 1, params, optax.sgd(0.1, momentum=0.9).init(params),
           step=1)
    assert os.path.exists(prefix + "-0001.states")
    trainer = main(["--config", MICRO, "--resume", "--device", "cpu"])
    assert not trainer.optimizer.state_dict()["state"]
    # fast-forwarded to epoch 1's end: micro_test's 4 iterations an epoch,
    # as train_net does without optimizer state
    assert first.step_count == 1 and trainer.step_count == 4
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, first.model.state_dict()[k]), k
    log = (in_tmp / "experiments" / "micro_test" / "log.txt").read_text()
    assert (f"{prefix}-0001.states is the JAX package's optimizer state, "
            "not the port's: ignored; the optimizer restarts") in log
    assert "resumed from epoch 1 (fresh optimizer, schedule at step 4)" in log


def test_jax_package_resumes_beside_the_ports_checkpoint(in_tmp):
    """The JAX package's load_checkpoint in a directory the port wrote: the
    params load and no optimizer state is found (the port's is
    `.torch_states`), so train_net restarts its optimizer."""
    from simpledet_tpu.core.checkpoint import load_checkpoint as j_load
    from simpledet_torch.detection_train import main

    main(["--config", MICRO, "--max-iter", "1", "--device", "cpu"])
    prefix = "experiments/micro_test/checkpoint"
    template = ckpt.read_params(prefix + "-0001.params")
    params, opt_state, step = j_load(prefix, 1, template)
    assert opt_state is None and step is None
    for k, v in ckpt.flatten(params).items():
        np.testing.assert_array_equal(np.asarray(v),
                                      ckpt.flatten(template)[k])


# ------------------------------------------------ SyncBN eval rules


CONVERGE = os.path.join(REPO, "config", "converge_test.py")


@pytest.fixture
def converge_dir(tmp_path, monkeypatch):
    """config/converge_test.py's data (the port's copy of the micro-set
    generator, 4 images) and a checkpoint of its seeded test detector with
    running statistics of its own, written by the port at the epoch the
    config's TestParam names."""
    from simpledet_torch.data.synthetic import make_micro_dataset as p_micro
    from simpledet_torch.models.norm import SyncBN

    root = tmp_path / "data"
    p_micro(str(root), n_images=4, set_names=("converge_train",))
    monkeypatch.setenv("CONVERGE_DATA_ROOT", str(root))
    monkeypatch.setenv("CONVERGE_EPOCHS", "1")
    monkeypatch.chdir(tmp_path)
    spec = read_config(CONVERGE)
    model = build_detector(spec)
    model.init_weights(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SyncBN):
                m.mean.normal_(0.0, 0.5, generator=gen)
                m.var.uniform_(0.5, 2.0, generator=gen)
    ckpt.save_checkpoint(spec.test.model.prefix, 1, model)
    return tmp_path


def test_test_cli_evaluates_syncbn_on_saved_running_stats(converge_dir):
    """With `.batch_stats` beside the params: the statistics are loaded,
    the eval batch stays TestParam's default 4, and the detector runs on
    them."""
    from simpledet_torch.detection_test import test_net

    stats = {}
    summary = test_net(CONVERGE, device="cpu", stats=stats)
    assert list(summary) == SUMMARY_KEYS
    assert stats["batch"] == 4 and stats["images"] == 4
    log = (converge_dir / "experiments" / "converge_test" /
           "log.txt").read_text()
    assert "loaded SyncBN running stats" in log
    assert "forcing eval batch 1" not in log


def test_test_cli_without_running_stats_forces_batch_1(converge_dir):
    """Without `.batch_stats`: a warning, batch statistics, and eval at
    batch 1 (as test_net does for a legacy SyncBN checkpoint)."""
    from simpledet_torch.detection_test import test_net

    os.remove("experiments/converge_test/checkpoint-0001.batch_stats")
    stats = {}
    summary = test_net(CONVERGE, device="cpu", stats=stats)
    assert list(summary) == SUMMARY_KEYS
    assert stats["batch"] == 1 and stats["images"] == 4
    log = (converge_dir / "experiments" / "converge_test" /
           "log.txt").read_text()
    assert ("WARNING: syncbn model without saved running stats; eval uses "
            "per-batch statistics") in log
    assert ("syncbn without running stats: forcing eval batch 1 "
            "(per-batch statistics)") in log
