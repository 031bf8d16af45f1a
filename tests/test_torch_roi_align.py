"""The port's multilevel RoIAlign against the JAX package on the CPU: the
crop path, the Pallas kernel in interpret mode and the gather oracle."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpledet_tpu.kernels.roi_align import (_batched_crop_roi_align,
                                             batched_multilevel_roi_align)
from simpledet_tpu.kernels.roi_align_pallas import batched_roi_align_pallas
from simpledet_torch.kernels import roi_align as kroi

STRIDES = (4, 8, 16, 32)
# The port samples with the gather formula (4 weighted taps summed); the crop
# path and the Pallas kernel interpolate y then x through matrix products.
# The two orders of float32 operations differ by a few ulps of values of
# order 1-10, far inside 1e-4; a wrong tap, weight or level is off by O(1).
TOL = dict(rtol=1e-4, atol=1e-4)


def pyramid(rng, b=2, h=96, w=160, c=8):
    return [rng.randn(b, h // (2 ** i), w // (2 ** i), c).astype(np.float32)
            for i in range(4)]


def mixed_rois(rng, n=12, lim=(380, 380)):
    """The random rois of tests/test_roi_align.py's Pallas test, plus
    extreme-aspect, edge, degenerate and out-of-image rois."""
    xy = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    wh = np.exp(rng.uniform(np.log(8), np.log(300), (n, 2))).astype(np.float32)
    rois = np.concatenate([xy, np.minimum(xy + wh, lim[0])], 1)
    extra = np.float32([
        [0, 40, 630, 60],        # 630 x 20: the long-side clamp engages
        [5, 0, 25, 380],         # tall and thin
        [0, 0, 639, 383],        # the whole image
        [600, 350, 639, 383],    # bottom-right corner
        [0, 0, 3, 3],            # tiny, top-left
        [50, 50, 50, 50],        # a point
        [700, 500, 900, 650],    # beyond the map: every bin empty
        [-20, -30, 40, 35],      # starts outside
    ])
    return np.concatenate([rois, extra])


def _torch(feats, rois):
    return kroi.multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
        STRIDES, out_size=7).numpy()


def test_plain_matches_crop_and_pallas_interpret():
    rng = np.random.RandomState(3)
    feats = pyramid(rng)
    r = mixed_rois(rng)
    rois = np.stack([r, r[::-1]])
    jf, jr = [jnp.asarray(f) for f in feats], jnp.asarray(rois)
    got = _torch(feats, rois)
    crop = np.asarray(_batched_crop_roi_align(jf, jr, STRIDES, out_size=7))
    np.testing.assert_allclose(got, crop, **TOL)
    pallas = np.asarray(batched_roi_align_pallas(
        jf, jr, STRIDES, 7, 224, 4, "max", None, True))
    np.testing.assert_allclose(got, pallas, **TOL)
    assert np.abs(got).sum() > 0 and (got[0, -2] == 0).all()


def test_plain_matches_gather_oracle_on_canonical_rois():
    """Where the long-side clamp does not engage, the port equals the JAX
    package's pure-area gather oracle."""
    rng = np.random.RandomState(4)
    feats = pyramid(rng, h=64, w=96)
    xy = rng.uniform(0, 250, (2, 20, 2)).astype(np.float32)
    # crop is 32 cells at this size, so a long side under 28 * 4 px never
    # moves a roi off its area level
    wh = rng.uniform(4, 110, (2, 20, 2)).astype(np.float32)
    rois = np.concatenate([xy, xy + wh], 2)
    want = np.asarray(batched_multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), STRIDES,
        out_size=7, impl="gather"))
    np.testing.assert_allclose(_torch(feats, rois), want, **TOL)


def test_long_side_clamp_moves_the_level():
    level_hw = [(200, 334), (100, 167), (50, 84), (25, 42)]
    assert kroi.auto_crop(level_hw, STRIDES, 224, 4, 7) == 48
    rois = torch.tensor([[0, 0, 100, 100], [0, 0, 550, 30],
                         [0, 0, 1330, 30], [0, 0, 175, 30]])
    lvl = kroi.roi_level_index(rois.float(), level_hw, STRIDES, 224, 4, 7)
    # area rule alone: 2, 2, 3, 2; a long side over 44 cells moves up
    assert lvl.tolist() == [0, 2, 3, 0]
