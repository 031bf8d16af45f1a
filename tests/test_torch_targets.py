"""The port's training targets against the JAX package on the CPU: sampling,
anchor targets and proposal targets, under deterministic priorities (the
`arange` branch on both sides), so that every choice can be held exactly.

Labels, selections and indices must be identical. Regression targets come
from the same float32 operations on both sides; they are held to 1e-6
absolute (targets are of order 1; a wrong row or gt is off by O(1)).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledet_tpu.ops.anchors import generate_anchor_grid
from simpledet_tpu.ops.bbox import encode_boxes as j_encode
from simpledet_tpu.targets import sampling as jsampling
from simpledet_tpu.targets.anchor_target import (
    batched_anchor_target as j_batched_anchor_target)
from simpledet_tpu.targets.proposal_target import (
    batched_proposal_target as j_batched_proposal_target)
from simpledet_torch.ops.bbox import encode_boxes
from simpledet_torch.targets import sampling
from simpledet_torch.targets.anchor_target import batched_anchor_target
from simpledet_torch.targets.proposal_target import batched_proposal_target

KEY = jax.random.PRNGKey(0)
TARGET_ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def gt_boxes(rng, b, g, n_valid, h, w, classes=5):
    """[b, g, 5] gt with class -1 padding rows; n_valid[i] real boxes."""
    gt = np.full((b, g, 5), -1, np.float32)
    for i, n in enumerate(n_valid):
        xy = rng.uniform(0, [w * 0.7, h * 0.7], (n, 2))
        wh = rng.uniform(8, [w * 0.5, h * 0.5], (n, 2))
        gt[i, :n, :4] = np.concatenate([xy, np.minimum(xy + wh, [w - 1,
                                                                 h - 1])], 1)
        gt[i, :n, 4] = rng.randint(1, classes, n)
    return gt


def test_encode_boxes_matches():
    rng = np.random.RandomState(0)
    ex = rng.uniform(0, 100, (50, 4)).astype(np.float32)
    ex[:, 2:] += ex[:, :2]
    gt = rng.uniform(0, 100, (50, 4)).astype(np.float32)
    gt[:, 2:] += gt[:, :2]
    kw = dict(means=(0.0, 0.1, 0.0, -0.1), stds=(0.1, 0.1, 0.2, 0.2))
    np.testing.assert_allclose(encode_boxes(_t(ex), _t(gt), **kw).numpy(),
                               np.asarray(j_encode(ex, gt, **kw)),
                               rtol=1e-6, atol=TARGET_ATOL)


@pytest.mark.parametrize("n_set", [0, 7, 60, 200])
def test_sampling_primitives_match(n_set):
    """random_topk_mask, random_rank and subsample_labels with arange
    priorities: identical selections, ranks and labels."""
    rng = np.random.RandomState(n_set)
    n = 200
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:n_set]] = True
    for k in (1, 16, 64):
        np.testing.assert_array_equal(
            sampling.random_topk_mask(None, _t(mask), k, True).numpy(),
            np.asarray(jsampling.random_topk_mask(KEY, jnp.asarray(mask), k,
                                                  True)))
    np.testing.assert_array_equal(
        sampling.random_rank(None, _t(mask), True).numpy(),
        np.asarray(jsampling.random_rank(KEY, jnp.asarray(mask), True)))
    label = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    label[mask] = 1.0
    got, got_idx = sampling.subsample_labels(None, _t(label), 64, 0.25, True,
                                             return_fg_idx=True)
    want, want_idx = jsampling.subsample_labels(KEY, jnp.asarray(label), 64,
                                                0.25, True, return_fg_idx=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


def test_random_sampling_is_seeded_and_uniform_in_kind():
    """Random priorities: the generator decides; the counts and the fg-first
    rule are those of the deterministic mode."""
    label = torch.tensor([1.0] * 30 + [0.0] * 100 + [-1.0] * 10)
    picks = [sampling.subsample_labels(torch.Generator().manual_seed(s),
                                       label, 64, 0.25) for s in (1, 1, 2)]
    assert torch.equal(picks[0], picks[1]) and not torch.equal(picks[0],
                                                               picks[2])
    for p in picks:
        assert int((p == 1).sum()) == 16 and int((p == 0).sum()) == 48
        assert bool((p[130:] == -1).all())


ANCHOR_KW = dict(allowed_border=0, neg_thr=0.3, pos_thr=0.7, min_pos_thr=0.0,
                 image_anchor=64, fg_fraction=0.5, deterministic=True,
                 bbox_mean=None, bbox_std=None)


def anchors_for(h, w):
    return np.concatenate([generate_anchor_grid(-(-h // s), -(-w // s), s,
                                                (8,), (0.5, 1.0, 2.0))
                           for s in (4, 8, 16, 32, 64)])


@pytest.mark.parametrize("case", ["gt", "no_gt", "ignore"])
def test_anchor_target_matches(case):
    """Three images of 96 x 128: several gt with padded rows, one image
    without gt, and (case "ignore") class -2 ignore regions."""
    rng = np.random.RandomState(1)
    h, w = 96, 128
    anchors = anchors_for(h, w)
    gt = gt_boxes(rng, 3, 10, [4, 0 if case == "no_gt" else 1, 7], h, w)
    ignore = case == "ignore"
    if ignore:
        gt[0, 4] = [10, 10, 70, 60, -2]
        gt[2, 7] = [0, 0, 40, 90, -2]
    im_hw = np.float32([[h, w], [h, w - 20], [h - 10, w]])
    got = batched_anchor_target(None, _t(anchors), _t(gt), _t(im_hw),
                                ignore_regions=ignore, **ANCHOR_KW)
    want = j_batched_anchor_target(KEY, jnp.asarray(anchors), jnp.asarray(gt),
                                   jnp.asarray(im_hw), ignore_regions=ignore,
                                   **ANCHOR_KW)
    label, target, weight = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[0].numpy(), label)
    np.testing.assert_array_equal(got[2].numpy(), weight)
    np.testing.assert_allclose(got[1].numpy(), target, rtol=0,
                               atol=TARGET_ATOL)
    assert (label == 1).sum() > 0 and (label == 0).sum() > 0
    if case == "no_gt":
        assert (label[1] != 1).all() and not weight[1].any()


PT_KW = dict(image_rois=32, fg_fraction=0.25, fg_thr=0.5, bg_thr_hi=0.5,
             bg_thr_lo=0.0, num_reg_class=5, bbox_mean=(0., 0., 0., 0.),
             bbox_std=(0.1, 0.1, 0.2, 0.2), bbox_weight=(1., 1., 1., 1.),
             deterministic=True, output_iou=True)


@pytest.mark.parametrize("case", ["plenty", "few_candidates", "no_gt",
                                  "wo_gt_agnostic"])
def test_proposal_target_matches(case):
    """Two images: jittered copies of gt plus random rois, zero-padded. Case
    "few_candidates" leaves 5 live rois, so rows wrap around the non-fg
    pool; "no_gt" gives the second image no gt."""
    rng = np.random.RandomState(2)
    h, w = 96, 128
    gt = gt_boxes(rng, 2, 6, [3, 0 if case == "no_gt" else 2], h, w)
    r = 80
    rois = np.zeros((2, r, 4), np.float32)
    for i in range(2):
        base = gt[i, rng.randint(0, 2, 40), :4]
        rois[i, :40] = base + rng.normal(0, 4, (40, 4))
        xy = rng.uniform(0, [w - 20, h - 20], (30, 2))
        rois[i, 40:70] = np.concatenate([xy, xy + rng.uniform(4, 40,
                                                              (30, 2))], 1)
    rois = np.clip(rois, 0, [w - 1, h - 1, w - 1, h - 1]).astype(np.float32)
    if case == "few_candidates":
        rois[:, 5:] = 0
    kw = dict(PT_KW)
    if case == "wo_gt_agnostic":
        kw.update(proposal_wo_gt=True, class_agnostic=True, num_reg_class=2)
    got = batched_proposal_target(None, _t(rois), _t(gt), **kw)
    want = j_batched_proposal_target(KEY, jnp.asarray(rois), jnp.asarray(gt),
                                     **kw)
    assert set(got) == set(want)
    for k in want:
        if k in ("bbox_target", "match_gt_iou"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=TARGET_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
    assert got["fg_mask"][0].any()
