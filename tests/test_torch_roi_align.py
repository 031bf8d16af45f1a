"""The port's multilevel RoIAlign against the JAX package on the CPU: the
crop path, the Pallas kernel in interpret mode and the gather oracle, forward
and backward."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledet_tpu.kernels.roi_align import (_batched_crop_roi_align,
                                             batched_multilevel_roi_align)
from simpledet_tpu.kernels.roi_align_pallas import (_fwd as pallas_fwd,
                                                    batched_roi_align_pallas)
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


# ---------------------------------------------------------------- backward


def tied_pyramid(rng, b=2, h=96, w=160, c=8):
    """Half the channels random; the other half non-positive with 4 x 4
    patches of exact zeros, so that many bins have samples tied at their max
    (0) in every formulation of the interpolation, while untied samples stay
    strictly below it."""
    feats = pyramid(rng, b, h, w, c)
    for f in feats:
        hh, ww = f.shape[1:3]
        zero = rng.rand(b, -(-hh // 4), -(-ww // 4)) < 0.4
        zero = np.repeat(np.repeat(zero, 4, 1), 4, 2)[:, :hh, :ww]
        f[..., c // 2:] = np.where(zero[..., None], 0.0,
                                   -np.abs(f[..., c // 2:]))
    return feats


def _rois(rng):
    r = mixed_rois(rng)
    return np.stack([r, r[::-1]])


def _plain_vjp(feats, rois, g):
    """Plain forward with codes, then the plain backward."""
    fs = [torch.from_numpy(f) for f in feats]
    _, codes = kroi.multilevel_roi_align_plain(fs, torch.from_numpy(rois),
                                               STRIDES, with_codes=True)
    grads = kroi.multilevel_roi_align_bwd_plain(
        torch.from_numpy(g), codes, torch.from_numpy(rois),
        [f.shape[1:3] for f in feats], strides=STRIDES, dtype=torch.float32)
    return [x.numpy() for x in grads], codes.numpy()


def _close_to_scale(got, want, rtol):
    for g, w in zip(got, want):
        scale = max(np.abs(w).max(), 1e-6)
        err = np.abs(g - w).max() / scale
        assert err <= rtol, f"relative error {err:.3g} > {rtol}"


# A gradient is a sum of tap shares over overlapping rois, summed in
# another order on each side: 1e-5 of each level's max |grad|. A wrong tie
# split or tap is off by a share, O(1) of that scale.
GRAD_RTOL = 1e-5


def test_plain_tie_codes_match_pallas_mask():
    """The codes' bits are the Pallas forward's sample mask (interpret mode)
    on every non-empty bin; empty bins get code 0."""
    rng = np.random.RandomState(5)
    feats, rois = tied_pyramid(rng), _rois(rng)
    _, codes = kroi.multilevel_roi_align_plain(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
        STRIDES, with_codes=True)
    codes = codes.numpy()
    _, res = pallas_fwd([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                        STRIDES, 7, 224, 4, "max", None, True)
    empty, mask = np.asarray(res[7]), np.asarray(res[8]) > 0  # [N,2,2,P,P,C]
    want = sum(mask[:, sy, sx].astype(np.uint8) << (2 * sy + sx)
               for sy in range(2) for sx in range(2))
    want = np.where(empty[..., None], 0, want)
    np.testing.assert_array_equal(codes, want)
    popcount = sum((codes >> s) & 1 for s in range(4))
    assert (popcount > 1).mean() > 0.05 and (popcount == 0).any()


def test_plain_backward_matches_pallas_and_crop_vjp():
    """On tied inputs and the mixed roi set: the plain backward against
    jax.vjp of the Pallas kernel (interpret mode) and of the crop path."""
    rng = np.random.RandomState(6)
    feats, rois = tied_pyramid(rng), _rois(rng)
    g = rng.randn(*rois.shape[:2], 7, 7, 8).astype(np.float32)
    got, _ = _plain_vjp(feats, rois, g)
    jf, jr = [jnp.asarray(f) for f in feats], jnp.asarray(rois)
    for fn in (lambda fs: batched_roi_align_pallas(fs, jr, STRIDES, 7, 224,
                                                   4, "max", None, True),
               lambda fs: _batched_crop_roi_align(fs, jr, STRIDES,
                                                  out_size=7)):
        _, vjp = jax.vjp(fn, jf)
        (want,) = vjp(jnp.asarray(g))
        _close_to_scale(got, [np.asarray(w) for w in want], GRAD_RTOL)
    assert all(np.abs(x).sum() > 0 for x in got[:3])


def test_plain_backward_equals_autograd_of_plain_forward():
    """The explicit scatter equals torch.autograd through the plain forward,
    whose amax splits tied gradients evenly."""
    rng = np.random.RandomState(7)
    feats, rois = tied_pyramid(rng), _rois(rng)
    g = rng.randn(*rois.shape[:2], 7, 7, 8).astype(np.float32)
    got, _ = _plain_vjp(feats, rois, g)
    fs = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = kroi.multilevel_roi_align_plain(fs, torch.from_numpy(rois), STRIDES)
    want = torch.autograd.grad(out, fs, torch.from_numpy(g))
    _close_to_scale(got, [w.numpy() for w in want], 1e-6)
    # and the autograd Function on CPU tensors is the plain pair
    fs = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = kroi.multilevel_roi_align(fs, torch.from_numpy(rois), STRIDES)
    via_fn = torch.autograd.grad(out, fs, torch.from_numpy(g))
    for a, b in zip(via_fn, got):
        np.testing.assert_array_equal(a.numpy(), b)


def test_empty_bins_give_zero_gradient():
    """Rois beyond the map have only empty bins: zero output, code 0 and no
    gradient anywhere; rois get no gradient."""
    rng = np.random.RandomState(8)
    feats = [torch.from_numpy(f).requires_grad_() for f in pyramid(rng)]
    rois = torch.tensor([[[700, 500, 900, 650], [1000, 900, 1200, 1000]]],
                        dtype=torch.float32).repeat(2, 1, 1).requires_grad_()
    out = kroi.multilevel_roi_align(feats, rois, STRIDES)
    assert not out.detach().any()
    out.backward(torch.ones_like(out))
    assert all(not f.grad.any() for f in feats) and rois.grad is None
