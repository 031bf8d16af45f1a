"""The port's RepPoints point ops (`simpledet_torch/ops/points.py`) and
`bbox_overlaps(legacy_plus_one=False)` against the JAX package's, on the
CPU, plus the reference fixtures that `tests/test_reppoints.py` holds the
JAX ops to.

Inputs are made from seeds with numpy. The assignments compare labels and
boxes exactly; their premise (`test_no_assignment_near_ties`): no gt's
level value (log2 of its size over the scale) within 1e-4 of an integer,
no two distances on a gt's level within 1e-5 of each other at a num_pos
boundary (unless equal: points placed symmetrically about its center), no
IoU within 1e-5 of a threshold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_tpu.ops import bbox as jbbox
from simpledet_tpu.ops import points as jpoints
from simpledet_torch.ops import bbox as tbbox
from simpledet_torch.ops import points as tpoints

STRIDES = (8, 16, 32, 64, 128)
H, W = 128, 192


def _t(x):
    return torch.from_numpy(np.array(x))


def all_points():
    return np.concatenate([tpoints.gen_points(-(-H // s), -(-W // s), s)
                           for s in STRIDES], 0)


def seeded_gt(seed, b=2, g=6, n_pad=2):
    """[b, g, 5] gts of random float sizes (8-120 px), the last n_pad rows
    of each image padding (class -1)."""
    rng = np.random.RandomState(seed)
    gt = np.full((b, g, 5), -1.0, np.float32)
    for i in range(b):
        for j in range(g - n_pad):
            w, h = rng.uniform(8, 120), rng.uniform(8, 100)
            x, y = rng.uniform(0, W - w), rng.uniform(0, H - h)
            gt[i, j] = [x, y, x + w, y + h, rng.randint(1, 4)]
    return gt


@pytest.mark.parametrize("k,pad", [(3, 1), (5, 2)])
def test_grid_and_points_equal_the_jax_ones(k, pad):
    np.testing.assert_array_equal(tpoints.gen_dcn_offsets(k, pad),
                                  jpoints.gen_dcn_offsets(k, pad))
    for s in STRIDES:
        np.testing.assert_array_equal(tpoints.gen_points(5, 7, s),
                                      jpoints.gen_points(5, 7, s))


@pytest.mark.parametrize("transform", ["minmax", "partial_minmax", "moment"])
def test_offsets_to_boxes_match(transform):
    rng = np.random.RandomState(1)
    pts = all_points()
    pred = rng.randn(2, len(pts), 18).astype(np.float32)
    mt = np.float32([0.3, -0.2])
    stride = pts[:, 2:3]
    got = tpoints.points2bbox(
        tpoints.offset_to_pts(_t(pts), _t(pred), _t(stride), 9), transform,
        y_first=False, moment_transfer=_t(mt))
    for i in range(2):
        want = jpoints.points2bbox(
            jpoints.offset_to_pts(jnp.asarray(pts), jnp.asarray(pred[i]),
                                  jnp.asarray(stride), 9), transform,
            y_first=False, moment_transfer=jnp.asarray(mt))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("legacy", [True, False])
def test_bbox_overlaps_matches(legacy):
    rng = np.random.RandomState(2)
    a = seeded_gt(3)[..., :4].reshape(-1, 4)
    b = np.sort(rng.uniform(0, 150, (40, 2, 2)), 1).transpose(0, 2, 1) \
        .reshape(40, 4).astype(np.float32)
    got = tbbox.bbox_overlaps(_t(b), _t(a), legacy_plus_one=legacy)
    want = jbbox.bbox_overlaps(jnp.asarray(b), jnp.asarray(a),
                               legacy_plus_one=legacy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert (got.numpy() > 0).sum() > 10


def _assign_inputs(seed):
    pts = all_points()
    gt = seeded_gt(seed)
    rng = np.random.RandomState(seed + 10)
    # boxes around the points, some near each gt
    boxes = np.concatenate([pts[:, :2] - rng.uniform(4, 60, (len(pts), 2)),
                            pts[:, :2] + rng.uniform(4, 60, (len(pts), 2))],
                           1).astype(np.float32)
    boxes = np.stack([boxes, boxes[::-1].copy()])
    return pts, gt, boxes


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("num_pos", [1, 3])
def test_point_assign_matches(seed, num_pos):
    pts, gt, _ = _assign_inputs(seed)
    label, gts = tpoints.point_assign(_t(pts), _t(gt), 4, num_pos)
    for i in range(len(gt)):
        wl, wg = jpoints.point_assign(jnp.asarray(pts), jnp.asarray(gt[i]),
                                      4, num_pos)
        np.testing.assert_array_equal(label[i].numpy(), np.asarray(wl))
        np.testing.assert_array_equal(gts[i].numpy(), np.asarray(wg))
    assert (label.numpy() > 0).sum() >= 4 * num_pos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iou_assign_matches(seed):
    _, gt, boxes = _assign_inputs(seed)
    label, gts = tpoints.iou_assign(_t(boxes), _t(gt), 0.5, 0.4, 0.0)
    for i in range(len(gt)):
        wl, wg = jpoints.iou_assign(jnp.asarray(boxes[i]),
                                    jnp.asarray(gt[i]), 0.5, 0.4, 0.0)
        np.testing.assert_array_equal(label[i].numpy(), np.asarray(wl))
        np.testing.assert_array_equal(gts[i].numpy(), np.asarray(wg))
    lab = label.numpy()
    assert (lab > 0).any() and (lab == 0).any() and (lab == -1).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_no_assignment_near_ties(seed):
    """The premise of the exact compares above, in float64."""
    pts, gt, boxes = _assign_inputs(seed)
    g = gt[gt[..., 4] > 0].astype(np.float64)
    w, h = g[:, 2] - g[:, 0], g[:, 3] - g[:, 1]
    lvl = (np.log2(w / 4) + np.log2(h / 4)) / 2
    assert np.abs(lvl - np.round(lvl)).min() > 1e-4
    for s in STRIDES:
        assert abs(np.log2(s) - round(np.log2(s))) < 1e-12
    for i in range(len(gt)):
        valid = gt[i][gt[i][:, 4] > 0].astype(np.float64)
        cx = (valid[:, 0] + valid[:, 2]) / 2
        cy = (valid[:, 1] + valid[:, 3]) / 2
        vw, vh = valid[:, 2] - valid[:, 0], valid[:, 3] - valid[:, 1]
        d = np.hypot((pts[:, 0] - cx[:, None]) / vw[:, None],
                     (pts[:, 1] - cy[:, None]) / vh[:, None])
        glvl = np.clip(np.floor((np.log2(vw / 4) + np.log2(vh / 4)) / 2),
                       3, 7)
        for row, lv in zip(d, glvl):
            # at each num_pos boundary (1 and 3): an exact tie (points placed
            # symmetrically: the same float32 value on both sides) or a gap
            srt = np.sort(row[np.log2(pts[:, 2]) == lv])
            gaps = srt[[1, 3]] - srt[[0, 2]]
            assert ((gaps == 0) | (gaps > 1e-5)).all(), gaps
        b = boxes[i].astype(np.float64)
        iw = np.clip(np.minimum(b[:, None, 2], valid[:, 2])
                     - np.maximum(b[:, None, 0], valid[:, 0]), 0, None)
        ih = np.clip(np.minimum(b[:, None, 3], valid[:, 3])
                     - np.maximum(b[:, None, 1], valid[:, 1]), 0, None)
        inter = iw * ih
        union = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[:, None] \
            + vw * vh - inter
        iou = (inter / union).max(1)
        assert np.abs(iou - 0.4).min() > 1e-5
        assert np.abs(iou - 0.5).min() > 1e-5


# ------------------------------------------- the reference's own fixtures


def test_reference_fixture_offsets_and_points():
    np.testing.assert_array_equal(
        tpoints.gen_dcn_offsets(3, 1).reshape(-1),
        np.float32([-1, -1, -1, 0, -1, 1, 0, -1, 0, 0, 0, 1, 1, -1, 1, 0,
                    1, 1]))
    np.testing.assert_array_equal(
        tpoints.gen_points(2, 3, 8),
        np.float32([[0, 0, 8], [8, 0, 8], [16, 0, 8], [0, 8, 8], [8, 8, 8],
                    [16, 8, 8]]))


def test_reference_fixture_points2bbox():
    pts = np.transpose(np.arange(36).reshape(1, 18, 2, 1).astype(np.float32),
                       (0, 2, 3, 1)).reshape(2, 18)
    got = tpoints.points2bbox(_t(pts), "minmax", y_first=True)
    np.testing.assert_array_equal(got.numpy(), np.float32([[2, 0, 34, 32],
                                                           [3, 1, 35, 33]]))


def test_reference_fixture_point_assign():
    pts = np.concatenate([tpoints.gen_points(64 // s, 128 // s, s)
                          for s in (32, 64)], 0)
    gt = np.float32([[[63, 923, 123, 1800, 2], [200, 50, 600, 120, 3],
                      [21, 456, 123, 712, 4], [325, 123, 523, 612, 5],
                      [-1, -1, 5000, 5000, 6]]])
    label, gts = tpoints.point_assign(_t(pts), _t(gt), 4, 1)
    np.testing.assert_array_equal(label[0].numpy(),
                                  [-1, -1, -1, -1, -1, -1, 4, 3, -1, 6])
    np.testing.assert_allclose(gts[0, 6].numpy(), [21, 456, 123, 712])
    np.testing.assert_allclose(gts[0, 9].numpy(), [-1, -1, 5000, 5000])


def test_reference_fixture_iou_assign():
    proposals = np.float32([[[45, 23, 452, 45], [12, 798, 45, 902],
                             [103, 563, 345, 609], [34, 452, 123, 623],
                             [12, 23, 43, 134], [341, 78, 587, 102]]])
    gt = np.float32([[[63, 923, 123, 1800, 2], [200, 50, 600, 120, 3],
                      [21, 456, 123, 712, 4]]])
    label, gts = tpoints.iou_assign(_t(proposals), _t(gt), 0.5, 0.4, 0.0)
    np.testing.assert_array_equal(label[0].numpy(), [0, 0, 0, 4, 0, 3])
    np.testing.assert_allclose(gts[0, 3].numpy(), [21, 456, 123, 712])
