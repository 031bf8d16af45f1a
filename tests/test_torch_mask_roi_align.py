"""The port's multilevel RoIAlign at the mask branch's 14 x 14 against the JAX
package on the CPU, on 4 levels: the plain forward against the gather oracle
(the JAX package's CPU path), the crop path and the Pallas forward in
interpret mode; the tie codes against the Pallas mask; the plain backward
against jax.vjp of the Pallas kernel and of the crop path. These plain
versions are what the card holds K1 and K2 against at 14 x 14."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_tpu.kernels.roi_align import (_batched_crop_roi_align,
                                             batched_multilevel_roi_align)
from simpledet_tpu.kernels.roi_align_pallas import (_fwd as pallas_fwd,
                                                    batched_roi_align_pallas)
from simpledet_torch.kernels import roi_align as kroi
from test_torch_roi_align import (GRAD_RTOL, STRIDES, TOL, _close_to_scale,
                                  mixed_rois, pyramid, tied_pyramid)

P = 14


def fg_rois(rng, n=10):
    """Rois clustered on three boxes, as a mask branch's fg rois are (IoU
    >= 0.5 with a gt box), plus two mixed ones."""
    gts = np.float32([[40, 30, 200, 150], [300, 60, 380, 300],
                      [100, 200, 180, 260]])
    rois = gts[np.arange(n) % 3] + rng.uniform(-8, 8, (n, 4))
    return np.concatenate([rois, mixed_rois(rng, 2)[-2:]]).astype(np.float32)


def test_plain_forward_at_14_matches_gather_and_crop():
    """Canonical rois against the gather oracle; mixed and clustered rois
    (the long-side clamp engaged) against the crop path (1e-4: its
    interpolation multiplies in another order)."""
    rng = np.random.RandomState(11)
    feats = pyramid(rng, h=64, w=96)
    jf = [jnp.asarray(f) for f in feats]
    xy = rng.uniform(0, 250, (2, 12, 2)).astype(np.float32)
    rois = np.concatenate([xy, xy + rng.uniform(4, 110, (2, 12, 2))], 2)
    got = kroi.multilevel_roi_align([torch.from_numpy(f) for f in feats],
                                    torch.from_numpy(rois), STRIDES,
                                    out_size=P).numpy()
    want = np.asarray(batched_multilevel_roi_align(
        jf, jnp.asarray(rois), STRIDES, out_size=P, impl="gather"))
    assert got.shape == (2, 12, P, P, 8)
    np.testing.assert_allclose(got, want, **TOL)

    feats = pyramid(rng)
    jf = [jnp.asarray(f) for f in feats]
    r = np.concatenate([fg_rois(rng, 6), mixed_rois(rng, 2)])
    rois = np.stack([r, r[::-1]])
    got = kroi.multilevel_roi_align([torch.from_numpy(f) for f in feats],
                                    torch.from_numpy(rois), STRIDES,
                                    out_size=P).numpy()
    crop = np.asarray(_batched_crop_roi_align(jf, jnp.asarray(rois), STRIDES,
                                              out_size=P))
    np.testing.assert_allclose(got, crop, **TOL)
    assert np.abs(got).sum() > 0


def _plain_vjp(feats, rois, g):
    fs = [torch.from_numpy(f) for f in feats]
    _, codes = kroi.multilevel_roi_align_plain(
        fs, torch.from_numpy(rois), STRIDES, out_size=P, with_codes=True)
    grads = kroi.multilevel_roi_align_bwd_plain(
        torch.from_numpy(g), codes, torch.from_numpy(rois),
        [f.shape[1:3] for f in feats], strides=STRIDES, dtype=torch.float32,
        out_size=P)
    return [x.numpy() for x in grads], codes.numpy()


@pytest.fixture(scope="module")
def tied():
    rng = np.random.RandomState(12)
    feats = tied_pyramid(rng)
    r = np.concatenate([fg_rois(rng, 6), mixed_rois(rng, 2)])
    rois = np.stack([r, r[::-1]])
    g = rng.randn(*rois.shape[:2], P, P, 8).astype(np.float32)
    return feats, rois, g


def test_plain_forward_and_codes_at_14_match_pallas(tied):
    """The Pallas forward in interpret mode on clustered and mixed rois: its
    pooled output within 1e-4, its sample mask as the tie codes' bits."""
    feats, rois, g = tied
    fs = [torch.from_numpy(f) for f in feats]
    out, codes = kroi.multilevel_roi_align_plain(
        fs, torch.from_numpy(rois), STRIDES, out_size=P, with_codes=True)
    codes = codes.numpy()
    pooled, res = pallas_fwd([jnp.asarray(f) for f in feats],
                             jnp.asarray(rois), STRIDES, P, 224, 4, "max",
                             None, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pooled).reshape(
        out.shape), **TOL)
    empty, mask = np.asarray(res[7]), np.asarray(res[8]) > 0
    want = sum(mask[:, sy, sx].astype(np.uint8) << (2 * sy + sx)
               for sy in range(2) for sx in range(2))
    want = np.where(empty[..., None], 0, want)
    assert codes.shape == (rois.shape[0] * rois.shape[1], P, P, 8)
    np.testing.assert_array_equal(codes, want)
    popcount = sum((codes >> s) & 1 for s in range(4))
    assert (popcount > 1).mean() > 0.05


def test_plain_backward_at_14_matches_pallas_and_crop_vjp(tied):
    """Clustered fg rois (many rois add to the same cells) and mixed rois on
    tied inputs: within 1e-5 of each level's max |grad|; the autograd
    Function on CPU tensors gives the plain pair's result."""
    feats, rois, g = tied
    got, _ = _plain_vjp(feats, rois, g)
    jf, jr = [jnp.asarray(f) for f in feats], jnp.asarray(rois)
    for fn in (lambda fs: batched_roi_align_pallas(fs, jr, STRIDES, P, 224,
                                                   4, "max", None, True),
               lambda fs: _batched_crop_roi_align(fs, jr, STRIDES,
                                                  out_size=P)):
        _, vjp = jax.vjp(fn, jf)
        (want,) = vjp(jnp.asarray(g))
        _close_to_scale(got, [np.asarray(w) for w in want], GRAD_RTOL)
    fs = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = kroi.multilevel_roi_align(fs, torch.from_numpy(rois), STRIDES,
                                    out_size=P)
    via_fn = torch.autograd.grad(out, fs, torch.from_numpy(g))
    for a, b in zip(via_fn, got):
        np.testing.assert_array_equal(a.numpy(), b)
    assert all(np.abs(x).sum() > 0 for x in got[:3])
