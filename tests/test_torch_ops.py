"""The port's box ops, anchors, image normalisation and NMS against the JAX
package, on the CPU. Inputs come from numpy with fixed seeds and go to both
sides."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpledet_tpu import ops as jops
from simpledet_tpu.kernels.nms_pallas import nms_keep_sorted_pallas
from simpledet_tpu.ops import image as jimage
from simpledet_tpu.ops import nms as jnms
from simpledet_tpu.targets.fpn_assign import fpn_roi_level as j_fpn_roi_level
from simpledet_torch.kernels import nms as knms
from simpledet_torch.ops import anchors as tanchors
from simpledet_torch.ops import bbox as tbbox
from simpledet_torch.ops import image as timage
from simpledet_torch.ops import nms as tnms
from simpledet_torch.targets.fpn_assign import fpn_roi_level

# Both sides evaluate the same float32 formulas operation by operation; XLA
# may still fuse or reorder an expression, so continuous outputs are held to
# a few float32 ulps (rtol 1e-6) and discrete ones (levels, keep sets,
# indices) must be identical.
RTOL, ATOL = 1e-6, 1e-5


def rand_boxes(n, rng, size=500):
    x1 = rng.uniform(0, size, n)
    y1 = rng.uniform(0, size, n)
    w = rng.uniform(1, 200, n)
    h = rng.uniform(1, 200, n)
    return np.stack([x1, y1, x1 + w, y1 + h], axis=1).astype(np.float32)


@pytest.mark.parametrize("shape", [(23, 17), (2, 5, 7)])
def test_bbox_overlaps(shape):
    rng = np.random.RandomState(0)
    if len(shape) == 2:
        a, b = rand_boxes(shape[0], rng), rand_boxes(shape[1], rng)
    else:
        a = np.stack([rand_boxes(shape[1], rng) for _ in range(shape[0])])
        b = np.stack([rand_boxes(shape[2], rng) for _ in range(shape[0])])
    want = np.asarray(jops.bbox_overlaps(jnp.asarray(a), jnp.asarray(b)))
    got = tbbox.bbox_overlaps(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ncls,means,stds", [
    (1, None, None), (3, None, None),
    (1, (0.0, 0.1, 0.0, -0.1), (0.1, 0.1, 0.2, 0.2)),
    (81, (0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2))])
def test_decode_and_clip(ncls, means, stds):
    rng = np.random.RandomState(3)
    boxes = rand_boxes(11, rng)
    deltas = (rng.randn(11, 4 * ncls) * 2.0).astype(np.float32)  # hits the clip
    im_hw = np.float32([[300, 400]])
    want = jops.decode_boxes(jnp.asarray(boxes), jnp.asarray(deltas),
                             means=means, stds=stds)
    want_c = np.asarray(jops.clip_boxes(want, jnp.asarray(im_hw[0])))
    got = tbbox.decode_boxes(torch.from_numpy(boxes),
                             torch.from_numpy(deltas), means=means, stds=stds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-3)
    got_c = tbbox.clip_boxes(got, torch.from_numpy(im_hw[0]))
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=RTOL, atol=1e-3)


def test_clip_boxes_batched():
    boxes = np.float32([[[-5.0, -3.0, 700.0, 900.0], [10, 10, 20, 20]],
                        [[1, 2, 3, 4], [-1, 50, 90, 700]]])
    hw = np.float32([[600, 800], [40, 60]])
    want = np.asarray(jops.clip_boxes(jnp.asarray(boxes),
                                      jnp.asarray(hw)[:, None, :]))
    got = tbbox.clip_boxes(torch.from_numpy(boxes),
                           torch.from_numpy(hw)[:, None, :])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, 0].numpy(), [0, 0, 700, 599])


def test_fpn_roi_level():
    rng = np.random.RandomState(5)
    xy = rng.uniform(0, 500, (400, 2))
    wh = np.exp(rng.uniform(np.log(1), np.log(900), (400, 2)))
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    rois[:4] = [[0, 0, 0, 0], [0, 0, 111, 111], [0, 0, 223, 223],
                [0, 0, 447, 447]]                    # exact level boundaries
    want = np.asarray(j_fpn_roi_level(jnp.asarray(rois)))
    got = fpn_roi_level(torch.from_numpy(rois))
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_normalize():
    rng = np.random.RandomState(6)
    data = rng.randint(0, 256, (2, 12, 20, 3), dtype=np.uint8)
    im_info = np.float32([[12, 20, 1.0], [7, 13, 1.0]])
    mean, std = (122.7717, 115.9465, 102.9801), (1.0, 2.0, 0.5)
    want = np.asarray(jimage.device_normalize(
        jnp.asarray(data), jnp.asarray(im_info), mean, std))
    got = timage.device_normalize(torch.from_numpy(data),
                                  torch.from_numpy(im_info), mean, std)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[1, 7:] == 0).all() and (got[1, :, 13:] == 0).all()


@pytest.mark.parametrize("stride,hw", [(4, (3, 5)), (16, (2, 3)),
                                       (64, (13, 21))])
def test_anchor_grid(stride, hw):
    from simpledet_tpu.ops.anchors import generate_anchor_grid
    args = (hw[0], hw[1], stride, (8,), (0.5, 1.0, 2.0))
    np.testing.assert_array_equal(tanchors.generate_anchor_grid(*args),
                                  generate_anchor_grid(*args))


# -------------------------------------------------------------------- NMS


def _nms_cases():
    """(boxes [N, 4], scores [N], valid [N], thr) problems: random clouds,
    suppression chains, identical boxes and tied scores."""
    rng = np.random.RandomState(7)
    cases = []
    for n in (1, 2, 17, 100, 130):
        ctr = rng.uniform(0, 200, (n, 2))
        wh = rng.uniform(5, 80, (n, 2))
        boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)
        scores = rng.rand(n)
        cases.append((boxes, scores, rng.rand(n) > 0.1,
                      float(rng.choice([0.3, 0.5, 0.7]))))
    n = 150
    xs = np.arange(n) * 4.0
    chain = np.stack([xs, np.zeros(n), xs + 10, np.full(n, 10.0)], 1)
    cases.append((chain, np.linspace(1, 0, n), np.ones(n, bool), 0.3))
    cases.append((chain, np.zeros(n), np.ones(n, bool), 0.3))   # all tied
    same = np.tile([[0, 0, 10, 10]], (64, 1))
    cases.append((same, rng.choice([0.2, 0.5], 64), np.ones(64, bool), 0.5))
    tied = rand_boxes(90, rng, size=60)
    cases.append((tied, np.round(rng.rand(90), 1), rng.rand(90) > 0.2, 0.5))
    return [(b.astype(np.float32), s.astype(np.float32), v, t)
            for b, s, v, t in cases]


@pytest.mark.parametrize("impl", ["fixpoint", "scan"])
@pytest.mark.parametrize("case", range(len(_nms_cases())))
def test_nms_matches_jax(case, impl, monkeypatch):
    """Keep sets, indices, boxes and scores identical to the JAX nms (its
    fixpoint and its serial-scan keep functions)."""
    monkeypatch.setenv("SIMPLEDET_NMS", "scan" if impl == "scan" else "")
    boxes, scores, valid, thr = _nms_cases()[case]
    n = len(scores)
    for max_out in (n // 2 + 1, n + 7):
        want = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), thr, max_out,
                        valid=jnp.asarray(valid))
        got = tnms.nms(torch.from_numpy(boxes)[None],
                       torch.from_numpy(scores)[None], thr, max_out,
                       valid=torch.from_numpy(valid)[None])
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_nms_batched_problems_are_independent():
    cases = [c for c in _nms_cases() if len(c[1]) == 150]
    boxes = torch.from_numpy(np.stack([c[0] for c in cases]))
    scores = torch.from_numpy(np.stack([c[1] for c in cases]))
    valid = torch.from_numpy(np.stack([c[2] for c in cases]))
    got = tnms.nms(boxes, scores, 0.3, 40, valid=valid)
    for i in range(len(cases)):
        one = tnms.nms(boxes[i:i + 1], scores[i:i + 1], 0.3, 40,
                       valid=valid[i:i + 1])
        for g, o in zip(got, one):
            np.testing.assert_array_equal(g[i:i + 1].numpy(), o.numpy())


@pytest.mark.parametrize("n,valid_frac,thr", [(200, 1.0, 0.5),
                                              (130, 0.7, 0.7)])
def test_keep_plain_matches_pallas_interpret(n, valid_frac, thr):
    """The plain keep mask against the Pallas NMS kernel in interpret mode,
    called as tests/test_nms_pallas.py calls it."""
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    wh = rng.uniform(5, 50, (n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)
    order = np.argsort(-rng.rand(n).astype(np.float32))
    sboxes = boxes[order]
    svalid = rng.rand(n) < valid_frac
    want = np.asarray(nms_keep_sorted_pallas(
        jnp.asarray(sboxes), jnp.asarray(svalid), thr, interpret=True))
    got = knms.nms_keep_sorted(torch.from_numpy(sboxes)[None],
                               torch.from_numpy(svalid)[None], thr)
    np.testing.assert_array_equal(got[0].numpy(), want)
