"""The port's roidb, transforms, loader and COCO evaluation against the JAX
package's (`simpledet_tpu.data`, `simpledet_tpu.eval.coco_eval`) on the
synthetic micro-COCO of tests/fixtures.py, on the CPU: identical records,
batches and summaries."""
import copy
import json
import pickle

import numpy as np
import pytest

from fixtures import make_micro_dataset
from simpledet_tpu.core.config import load_config as j_load_config
from simpledet_tpu.data import loader as jloader
from simpledet_tpu.data import roidb as jroidb
from simpledet_tpu.data import transforms as jtransforms
from simpledet_tpu.eval.coco_eval import COCOEval as JCOCOEval
from simpledet_torch.core.config import read_config
from simpledet_torch.data import loader, roidb
from simpledet_torch.data.transforms import (Norm2DImage, apply_transforms,
                                             from_config)
from simpledet_torch.eval.coco_eval import COCOEval

MICRO = "config/micro_test.py"


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    root = tmp_path_factory.mktemp("micro")
    records, ann = make_micro_dataset(str(root), n_images=8)
    return dict(root=root, roidb=records, ann=ann)


def chains(monkeypatch, micro, is_train):
    """(the JAX package's transforms, the port's) of config/micro_test.py,
    both read with its data under the micro root."""
    monkeypatch.setenv("MICRO_DATA_ROOT", str(micro["root"]))
    monkeypatch.delenv("SIMPLEDET_HOST_NORM", raising=False)
    want = j_load_config(MICRO).get_config(is_train=is_train)[9]
    got = from_config(read_config(MICRO, is_train=is_train).transform)
    assert [type(t).__name__ for t in got] == [type(t).__name__
                                               for t in want]
    return want, got


def test_create_coco_roidb_and_pickles_match(micro, tmp_path):
    want = jroidb.create_coco_roidb(micro["ann"], str(micro["root"]))
    got = roidb.create_coco_roidb(micro["ann"], str(micro["root"]))
    assert got == want and len(got) == 8
    roidb.save_roidb(got, "set", str(tmp_path))
    assert roidb.load_roidb(["set"], str(tmp_path)) == \
        jroidb.load_roidb(["set"], str(tmp_path)) == want
    with open(tmp_path / "set.roidb", "rb") as f:
        assert pickle.load(f) == want
    flipped = roidb.append_flipped(got)
    assert flipped == jroidb.append_flipped(want) and len(flipped) == 16
    assert [r["flipped"] for r in flipped] == [False] * 8 + [True] * 8


@pytest.mark.parametrize("is_train", [True, False])
def test_transform_chain_matches(micro, monkeypatch, is_train):
    """Every record, flipped too for training, through the config's chain:
    the same uint8 image, im_info and padded gt."""
    want_tf, got_tf = chains(monkeypatch, micro, is_train)
    records = micro["roidb"]
    if is_train:
        records = jroidb.append_flipped(records)
    for r in records:
        want = jtransforms.apply_transforms(dict(r), want_tf)
        got = apply_transforms(dict(r), got_tf)
        assert set(got) == set(want)
        assert got["data"].dtype == np.uint8
        for k in ("data", "im_info", "gt_bbox"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["data"].shape in ((128, 192, 3), (192, 128, 3))


def test_norm_normalises_float_images_as_jax():
    class P:
        mean = (122.7717, 115.9465, 102.9801)
        std = (1.0, 2.0, 4.0)

    img = np.random.RandomState(0).uniform(0, 255, (5, 7, 3)).astype(
        np.float32)
    want = jtransforms.Norm2DImage(P, host=True).apply({"image": img.copy()})
    got = Norm2DImage(P).apply({"image": img.copy()})
    np.testing.assert_array_equal(got["image"], want["image"])
    u8 = {"image": img.astype(np.uint8)}
    assert Norm2DImage(P).apply(dict(u8))["image"] is u8["image"]


def test_unported_transform_raises_naming_it():
    class Recorded:
        name, args, kwargs = "RandCrop2DImageBbox", (), {}

    with pytest.raises(NotImplementedError, match="RandCrop2DImageBbox"):
        from_config([Recorded()])


def _batches(ld, epochs):
    return [b for _ in range(epochs) for b in ld]


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_loader_batches_match(micro, monkeypatch, kind):
    """Two epochs of the training loader (flips, aspect groups, shuffle from
    seed + epoch, tail padding, 2 worker threads) and the eval loader (batch
    3, the tail masked): identical batches, keys and valid masks."""
    is_train = kind == "train"
    want_tf, got_tf = chains(monkeypatch, micro, is_train)
    records = micro["roidb"]
    if is_train:
        records = jroidb.append_flipped(records)
        kw = dict(shuffle=True, num_workers=2, keys=("data", "im_info",
                                                     "gt_bbox"))
        bs, epochs = 2, 2
    else:
        kw = dict(shuffle=False, num_workers=2, pad_last=False,
                  keys=("data", "im_info", "im_id"))
        bs, epochs = 3, 1
    want = _batches(jloader.Loader(copy.deepcopy(records), want_tf, bs,
                                   **kw), epochs)
    ld = loader.Loader(copy.deepcopy(records), got_tf, bs, **kw)
    assert len(ld) == len(want) // epochs
    got = _batches(ld, epochs)
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == set(kw["keys"]) | {"valid"}
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    valid = np.concatenate([b["valid"] for b in got])
    assert valid.all() == is_train


# --------------------------------------------------------------- COCO eval


def _detections(rng, ann, noise, n_false):
    """Detections near each gt box (xywh jitter `noise` px), a random score
    each, plus n_false random boxes per image, with COCO category ids."""
    dets = []
    for a in ann["annotations"]:
        x, y, w, h = a["bbox"]
        j = rng.normal(0, noise, 4)
        dets.append({"image_id": a["image_id"],
                     "category_id": a["category_id"],
                     "bbox": [x + j[0], y + j[1], max(w + j[2], 1),
                              max(h + j[3], 1)],
                     "score": float(rng.rand())})
    for im in ann["images"]:
        for _ in range(n_false):
            x, y = rng.uniform(0, 100, 2)
            dets.append({"image_id": im["id"],
                         "category_id": int(rng.randint(1, 4)),
                         "bbox": [x, y, *rng.uniform(5, 90, 2)],
                         "score": float(rng.rand())})
    return dets


@pytest.mark.parametrize("seed,noise,n_false", [(0, 1.0, 0), (1, 4.0, 3),
                                                (2, 12.0, 10)])
def test_coco_eval_matches(micro, seed, noise, n_false):
    """The same detections through both evaluators: identical 12-number
    summaries."""
    import json

    with open(micro["ann"]) as f:
        ann = json.load(f)
    dets = _detections(np.random.RandomState(seed), ann, noise, n_false)
    want = JCOCOEval(micro["ann"]).evaluate(copy.deepcopy(dets))
    got = COCOEval(micro["ann"]).evaluate(copy.deepcopy(dets))
    assert list(got) == ["AP", "AP50", "AP75", "APs", "APm", "APl", "AR1",
                         "AR10", "AR100", "ARs", "ARm", "ARl"]
    assert got == want
    assert 0 < got["AP"] <= 1


def test_coco_eval_refuses_segm(micro):
    """The segm evaluator (ported with Mask R-CNN) refuses detections that
    carry no mask, and an iou_type it does not know."""
    with open(micro["ann"]) as f:
        dets = _detections(np.random.RandomState(0), json.load(f), 1.0, 0)
    with pytest.raises(KeyError, match="_mask"):
        COCOEval(micro["ann"], iou_type="segm").evaluate(dets)
    with pytest.raises(ValueError, match="keypoints"):
        COCOEval(micro["ann"], iou_type="keypoints")


def _same_dataset(root_a, root_b, set_name):
    """The roidb records (image paths aside), the annotation json and every
    image file are the same in two dataset directories."""
    import json
    import os

    with open(os.path.join(root_a, "cache", set_name + ".roidb"), "rb") as f:
        a = pickle.load(f)
    with open(os.path.join(root_b, "cache", set_name + ".roidb"), "rb") as f:
        b = pickle.load(f)
    assert len(a) == len(b) > 0
    for ra, rb in zip(a, b):
        assert os.path.basename(ra.pop("image_url")) == \
            os.path.basename(rb.pop("image_url"))
        assert ra == rb
    for name in ("annotations.json",):
        with open(os.path.join(root_a, name)) as fa, \
                open(os.path.join(root_b, name)) as fb:
            assert json.load(fa) == json.load(fb)
    files = sorted(os.listdir(os.path.join(root_a, "images")))
    assert files == sorted(os.listdir(os.path.join(root_b, "images")))
    for fn in files:
        with open(os.path.join(root_a, "images", fn), "rb") as fa, \
                open(os.path.join(root_b, "images", fn), "rb") as fb:
            assert fa.read() == fb.read(), fn


@pytest.mark.parametrize("shapes", ["rect", "ellipse"])
def test_micro_generator_copy_matches_the_fixture(tmp_path, shapes):
    """data/synthetic.make_micro_dataset against
    tests/fixtures.make_micro_dataset: the same seed gives the same JPEG
    bytes, annotations and roidb records."""
    from simpledet_torch.data.synthetic import make_micro_dataset as p_micro

    make_micro_dataset(str(tmp_path / "a"), n_images=6, seed=3,
                       set_names=("converge_train",), shapes=shapes)
    p_micro(str(tmp_path / "b"), n_images=6, seed=3,
            set_names=("converge_train",), shapes=shapes)
    _same_dataset(tmp_path / "a", tmp_path / "b", "converge_train")


def test_synth_coco_copy_matches_the_tool(tmp_path):
    """data/synthetic.make_synth_coco against
    tools/train_flagship_curve.make_synth_coco (2 images of 800 x 1200)."""
    import importlib.util
    import os

    from simpledet_torch.data.synthetic import make_synth_coco

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "train_flagship_curve.py")
    spec = importlib.util.spec_from_file_location("_curve_tool", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.make_synth_coco(str(tmp_path / "a"), n_images=2, seed=1)
    make_synth_coco(str(tmp_path / "b"), n_images=2, seed=1)
    _same_dataset(tmp_path / "a", tmp_path / "b", "flagship_synth")
