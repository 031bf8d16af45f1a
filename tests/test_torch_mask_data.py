"""The port's mask data path against the JAX package's, on the CPU: the
on-device polygon rasterizer and mask targets, the polygon transforms and
edge packing, the RLE codec and gt masks, the mask loss, mask pasting and
the segm COCO evaluation. Integer-valued results (masks, targets, edges,
RLE strings, COCO summaries) are held equal; the loss within 1e-6."""
import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_micro_dataset
from models.maskrcnn.utils import segm_results as j_segm_results
from simpledet_tpu.core.config import load_config as j_load_config
from simpledet_tpu.data import mask_transforms as jmt
from simpledet_tpu.data import rle as jrle
from simpledet_tpu.data import roidb as jroidb
from simpledet_tpu.data import transforms as jtransforms
from simpledet_tpu.eval.coco_eval import COCOEval as JCOCOEval
from simpledet_tpu.ops.losses import sigmoid_cross_entropy as j_sigmoid_ce
from simpledet_tpu.targets import mask_target as jtarget
from simpledet_torch.core.config import read_config
from simpledet_torch.data import mask_transforms as mt
from simpledet_torch.data import rle
from simpledet_torch.data.transforms import apply_transforms, from_config
from simpledet_torch.eval.coco_eval import COCOEval
from simpledet_torch.eval.segm import segm_results
from simpledet_torch.ops.losses import sigmoid_cross_entropy
from simpledet_torch.targets import mask_target as target

MASK_MICRO = "config/mask_micro_test.py"


def random_instances(rng, n_inst, max_edges, lim=60.0):
    """[n_inst, max_edges, 5] edge tensors of 1-3 polygons each (up to 9
    vertices, some on half-pixel grids with horizontal edges, some
    overlapping), packed by the JAX package's polys_to_edges: padding rows
    at the end of each."""
    out = []
    for i in range(n_inst):
        polys = []
        for _ in range(rng.randint(1, 4)):
            n = rng.randint(3, 10)
            p = rng.uniform(-5, lim, (n, 2))
            if i % 2:
                p = np.round(p * 2) / 2
                p[1, 1] = p[0, 1]                    # a horizontal edge
            polys.append(p.astype(np.float32).reshape(-1))
        out.append(jmt.polys_to_edges(polys, max_edges))
    return np.stack(out)


def random_rois(rng, n, lim=60.0):
    xy = rng.uniform(-5, lim - 10, (n, 2))
    wh = rng.uniform(0.5, 40, (n, 2))
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    rois[0] = [3, 3, 3, 3]                            # collapsed: w, h -> 1
    return rois


# ----------------------------------------------------------- rasterizer


@pytest.mark.parametrize("seed,mask_size", [(0, 28), (1, 14), (2, 7)])
def test_rasterize_edges_equals_jax(seed, mask_size):
    """Random multi-segment instances (padding edges, horizontal edges,
    overlapping segments) in random rois: the same {0, 1} grid, cell for
    cell."""
    rng = np.random.RandomState(seed)
    edges = random_instances(rng, 12, 40)
    rois = random_rois(rng, 12)
    got = target.rasterize_edges(torch.from_numpy(edges),
                                 torch.from_numpy(rois), mask_size)
    for e, r, g in zip(edges, rois, got.numpy()):
        want = np.asarray(jtarget.rasterize_edges(jnp.asarray(e),
                                                  jnp.asarray(r), mask_size))
        np.testing.assert_array_equal(g, want)
    assert 0.05 < got.mean() < 0.95


def test_batched_mask_target_equals_jax_in_chunks(monkeypatch):
    """Two images, fg-first rois with gt_index -1 past the fg prefix: the
    same targets and -1 rows as the JAX package's batched and one-image
    functions; rois go through the rasterizer three at a time
    (CHUNK_ELEMENTS cut), which changes nothing."""
    rng = np.random.RandomState(3)
    b, f, g, e, m = 2, 10, 4, 30, 14
    gt_poly = np.stack([random_instances(rng, g, e) for _ in range(b)])
    rois = np.stack([random_rois(rng, f) for _ in range(b)])
    fg = np.zeros((b, f), bool)
    fg[0, :6], fg[1, :3] = True, True
    gt_index = np.where(fg, rng.randint(0, g, (b, f)), -1)
    want = np.asarray(jtarget.batched_mask_target(
        jnp.asarray(rois), jnp.asarray(gt_index), jnp.asarray(fg),
        jnp.asarray(gt_poly), mask_size=m))
    monkeypatch.setattr(target, "CHUNK_ELEMENTS", 3 * m * m * e)
    got = target.batched_mask_target(
        torch.from_numpy(rois), torch.from_numpy(gt_index),
        torch.from_numpy(fg), torch.from_numpy(gt_poly), mask_size=m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[~fg] == -1).all() and (want[fg] == 1).any()
    for i in range(b):          # the JAX package's one-image mask_target
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(
            jtarget.mask_target(*(jnp.asarray(x[i]) for x in
                                  (rois, gt_index, fg, gt_poly)),
                                mask_size=m)))


def test_trim_padding_changes_no_target():
    """Dropping the edge columns that are padding in every instance leaves
    the targets as they are; a column valid in one instance stays."""
    rng = np.random.RandomState(13)
    gt_poly = np.stack([random_instances(rng, 3, 40) for _ in range(2)])
    gt_poly[:, :, 30:] = -1
    gt_poly[1, 2, 33] = [5, 5, 30, 40, 0]         # one late edge
    rois = np.stack([random_rois(rng, 6) for _ in range(2)])
    gt_index = rng.randint(0, 3, (2, 6))
    fg = rng.rand(2, 6) < 0.8
    args = [torch.from_numpy(x) for x in (rois, gt_index, fg)]
    trimmed = target.trim_padding(torch.from_numpy(gt_poly))
    assert trimmed.shape == (2, 3, 34, 5)
    want = target.batched_mask_target(*args, torch.from_numpy(gt_poly))
    got = target.batched_mask_target(*args, trimmed)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert target.trim_padding(torch.full((1, 2, 9, 5), -1.0)).shape[2] == 1


def test_multi_segment_union():
    """tests/test_mask.py's case: two disjoint squares of one instance are
    their union; two overlapping squares as two segments stay filled where
    they overlap (an XOR over all edges would empty it)."""
    sq1 = np.array([0, 0, 10, 0, 10, 10, 0, 10], np.float32)
    sq2 = np.array([20, 20, 30, 20, 30, 30, 20, 30], np.float32)
    sq3 = np.array([5, 5, 15, 5, 15, 15, 5, 15], np.float32)
    roi = np.array([0, 0, 30, 30], np.float32)
    for polys in ([sq1, sq2], [sq1, sq3]):
        edges = mt.polys_to_edges(polys, max_edges=16)
        got = target.rasterize_edges(torch.from_numpy(edges)[None],
                                     torch.from_numpy(roi)[None], 30)[0]
        want = np.asarray(jtarget.rasterize_edges(jnp.asarray(edges),
                                                  jnp.asarray(roi), 30))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[5, 5] == 1 and got[15, 15] == 0
    assert got[8, 8] == 1 and got[12, 12] == 1      # sq1 and sq3 overlap


# ----------------------------------------------------- polygon transforms


def test_polys_to_edges_and_encode_gt_poly_equal_jax():
    """The edge rows and EncodeGtPoly's tensor byte for byte, with more
    segments than NUM_SEG, a degenerate 2-vertex polygon and an edge budget
    that cuts an instance short."""
    rng = np.random.RandomState(4)
    inst = [rng.uniform(0, 50, 2 * rng.randint(2, 9)).astype(np.float32)
            for _ in range(10)]
    for max_edges in (8, 64):
        got = mt.polys_to_edges(inst, max_edges)
        want = jmt.polys_to_edges(inst, max_edges)
        assert got.tobytes() == want.tobytes()

    class PadParam:
        max_num_gt = 4
        max_len_gt_poly = 60

    rec = {"gt_poly": [inst[:3], inst[3:5], [], inst[5:]] * 2}
    got = mt.EncodeGtPoly(PadParam).apply(copy.deepcopy(rec))["gt_poly"]
    want = jmt.EncodeGtPoly(PadParam).apply(copy.deepcopy(rec))["gt_poly"]
    assert got.shape == (4, 30, 5) and got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def ellipses(tmp_path_factory):
    root = tmp_path_factory.mktemp("ellipses")
    records, ann = make_micro_dataset(str(root), n_images=4,
                                      shapes="ellipse")
    return dict(root=root, roidb=records, ann=ann)


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
def test_mask_config_chain_equals_jax(ellipses, monkeypatch, is_train):
    """config/mask_micro_test.py's transforms, flipped records too for
    training: the same image, im_info, gt and polygon edge tensor; the test
    chain's Resize2DImageBbox and Pad2DImageBbox, which the config imports
    from the JAX package, are the port's own."""
    monkeypatch.setenv("MICRO_DATA_ROOT", str(ellipses["root"]))
    want_tf = j_load_config(MASK_MICRO).get_config(is_train=is_train)[9]
    got_tf = from_config(read_config(MASK_MICRO, is_train=is_train).transform)
    assert [type(t).__name__ for t in got_tf] == \
        [type(t).__name__ for t in want_tf]
    assert all(type(t).__module__.startswith("simpledet_torch.")
               for t in got_tf)
    records = ellipses["roidb"]
    if is_train:
        records = jroidb.append_flipped(records)
    keys = ("data", "im_info", "gt_bbox") + (("gt_poly",) if is_train
                                             else ())
    for r in records:
        want = jtransforms.apply_transforms(copy.deepcopy(r), want_tf)
        got = apply_transforms(copy.deepcopy(r), got_tf)
        for k in keys:
            np.testing.assert_array_equal(got[k], want[k])
    if is_train:
        assert got["gt_poly"].shape == (10, 50, 5)
        assert (got["gt_poly"][:, :16, 4] == 0).any()


# ------------------------------------------------------------------ RLE


def random_masks(rng):
    """Blobs, full, empty, a single pixel, thin lines; odd shapes."""
    masks = [(rng.rand(37, 53) < p).astype(np.uint8) for p in (0.1, 0.5, 0.9)]
    masks += [np.ones((9, 4), np.uint8), np.zeros((6, 11), np.uint8)]
    one = np.zeros((40, 30), np.uint8)
    one[17, 3] = 1
    masks.append(one)
    blob = np.zeros((300, 200), np.uint8)
    blob[40:260, 30:170] = 1
    blob[100:120, :] = 0
    masks.append(blob)
    return masks


def test_rle_codec_equals_jax():
    """encode_rle's compressed strings and sizes equal the JAX package's;
    decoding returns the mask; both decode each other's strings and
    uncompressed counts (run lengths past 2^5 and negative deltas)."""
    for m in random_masks(np.random.RandomState(5)):
        got, want = rle.encode_rle(m), jrle.encode_rle(m)
        assert got == want
        np.testing.assert_array_equal(rle.decode_rle(got), m)
        np.testing.assert_array_equal(rle.decode_rle(want),
                                      jrle.decode_rle(got))
        counts = jrle._string_to_counts(want["counts"])
        assert rle._string_to_counts(want["counts"]) == counts
        np.testing.assert_array_equal(
            rle.decode_rle({"size": want["size"], "counts": counts}), m)
    with pytest.raises(ValueError):
        rle.decode_rle({"size": [2, 2], "counts": [1, 2]})


def test_segmentation_to_mask_equals_the_native_fill():
    """Polygons (flat, nested, half-pixel vertices, horizontal edges,
    overlapping rings, too-short ones) against the JAX package's native
    scanline fill, which it uses here (not the cv2 fallback); RLE dicts
    decode as the JAX package decodes them."""
    from simpledet_tpu import native

    assert native.NATIVE, "the JAX package's native host ops did not load"
    rng = np.random.RandomState(6)
    for i in range(40):
        h, w = rng.randint(8, 70, 2)
        segs = []
        for _ in range(rng.randint(1, 4)):
            p = rng.uniform(-8, 75, 2 * rng.randint(3, 12))
            if i % 3 == 0:
                p = np.round(p * 2) / 2
            if i % 4 == 0:
                p[3] = p[1]
            segs.append(p.tolist())
        segs.append([1.0, 2.0, 3.0, 4.0])           # 2 vertices: skipped
        for seg in (segs, segs[0]):
            got = rle.segmentation_to_mask(seg, h, w)
            want = jrle.segmentation_to_mask(seg, h, w)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
    m = random_masks(rng)[1]
    for seg in (jrle.encode_rle(m), {"size": list(m.shape), "counts":
                                     jrle._string_to_counts(
                                         jrle.encode_rle(m)["counts"])}):
        np.testing.assert_array_equal(rle.segmentation_to_mask(seg, 0, 0), m)


def test_mask_to_polygons_round_trip():
    """A decoded mask traced back to polygons: the JAX package's polygons;
    filled again, they cover the mask's blobs up to their outlines."""
    m = random_masks(np.random.RandomState(7))[-1]
    got = rle.mask_to_polygons(rle.decode_rle(rle.encode_rle(m)))
    want = jrle.mask_to_polygons(m)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    back = rle.segmentation_to_mask([p.tolist() for p in got], *m.shape)
    inter = (back & m).sum() / m.sum()
    assert inter > 0.98 and (back & ~m.astype(bool)).sum() == 0


def test_preprocess_gt_poly_decodes_rle_instances():
    rec = {"gt_poly": [[[0, 0, 10, 0, 10, 10]],
                       jrle.encode_rle(random_masks(
                           np.random.RandomState(8))[-1]), []]}
    got = mt.PreprocessGtPoly().apply(copy.deepcopy(rec))["gt_poly"]
    want = jmt.PreprocessGtPoly().apply(copy.deepcopy(rec))["gt_poly"]
    assert [len(i) for i in got] == [len(i) for i in want] == [1, 2, 0]
    for gi, wi in zip(got, want):
        for g, w in zip(gi, wi):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)


# --------------------------------------------------- loss, paste, segm eval


def test_sigmoid_cross_entropy_equals_jax():
    """Mean over the entries whose label is not -1 (1e-6 relative), and 0
    when every entry is ignored (the denominator is at least 1)."""
    rng = np.random.RandomState(9)
    logits = (rng.randn(3, 5, 14, 14) * 4).astype(np.float32)
    label = (rng.rand(3, 5, 14, 14) < 0.4).astype(np.float32)
    label[:, 3:] = -1
    got = float(sigmoid_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(label)))
    want = float(j_sigmoid_ce(jnp.asarray(logits), jnp.asarray(label)))
    assert abs(got - want) <= 1e-6 * want
    none = float(sigmoid_cross_entropy(torch.from_numpy(logits),
                                       torch.full_like(torch.from_numpy(
                                           label), -1.0)))
    assert none == 0.0


def test_segm_results_equals_reference():
    """Boxes inside, across and outside the image, degenerate boxes: the
    same pasted masks as models/maskrcnn/utils.py."""
    rng = np.random.RandomState(10)
    xy = rng.uniform(-30, 90, (12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 60, (12, 2))], 1)
    boxes = boxes.astype(np.float32)
    masks = rng.rand(12, 28, 28).astype(np.float32)
    got = segm_results(boxes, masks, 80, 100)
    want = j_segm_results(boxes, masks, 80, 100)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sum(g.sum() for g in got) > 0


def _segm_detections(rng, ann, masks, n_false):
    dets = []
    for a in ann["annotations"]:
        m = masks[a["id"]].copy()
        ys, xs = np.nonzero(m)
        k = rng.randint(0, 4)
        m[ys[::7][:k * 20], xs[::7][:k * 20]] = 0    # drop some pixels
        m = np.roll(m, rng.randint(-3, 4), axis=1)
        x, y, w, h = a["bbox"]
        dets.append({"image_id": a["image_id"],
                     "category_id": a["category_id"],
                     "bbox": [x, y, w, h], "score": float(rng.rand()),
                     "_mask": m})
    for im in ann["images"]:
        for _ in range(n_false):
            m = np.zeros((im["height"], im["width"]), np.uint8)
            x, y = rng.randint(0, 100, 2)
            m[y:y + rng.randint(5, 60), x:x + rng.randint(5, 60)] = 1
            dets.append({"image_id": im["id"],
                         "category_id": int(rng.randint(1, 4)),
                         "bbox": [float(x), float(y), 10.0, 10.0],
                         "score": float(rng.rand()), "_mask": m})
    return dets


@pytest.mark.parametrize("seed,n_false,crowd", [(0, 0, False), (1, 3, True),
                                                (2, 8, True)])
def test_coco_eval_segm_equals_jax(ellipses, seed, n_false, crowd):
    """Mask detections (gt masks perturbed, plus false positives) through
    both segm evaluators, with one gt made a crowd region: identical
    12-number summaries; the bbox summary of the same detections too."""
    with open(ellipses["ann"]) as f:
        ann = json.load(f)
    if crowd:
        ann["annotations"][1]["iscrowd"] = 1
    hw = {im["id"]: (im["height"], im["width"]) for im in ann["images"]}
    masks = {a["id"]: rle.segmentation_to_mask(a["segmentation"],
                                               *hw[a["image_id"]])
             for a in ann["annotations"]}
    for a in ann["annotations"]:
        a["_mask"] = masks[a["id"]]
    dets = _segm_detections(np.random.RandomState(seed), ann, masks, n_false)
    for iou_type in ("segm", "bbox"):
        want = JCOCOEval(copy.deepcopy(ann), iou_type).evaluate(
            copy.deepcopy(dets))
        got = COCOEval(copy.deepcopy(ann), iou_type).evaluate(
            copy.deepcopy(dets))
        assert got == want, iou_type
    assert 0 < got["AP"] <= 1
