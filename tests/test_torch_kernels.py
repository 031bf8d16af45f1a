"""The port's CUDA kernels against their plain versions. Torch only, so the
card tests also run where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -m cuda

On a machine without CUDA the card tests skip with their reason; the wrapper
tests that run here check that a CPU tensor takes the plain version and
counts no launch."""
import numpy as np
import pytest
import torch

from simpledet_torch.kernels import nms as knms
from simpledet_torch.kernels import roi_align as kroi

STRIDES = (4, 8, 16, 32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def random_problems(rng, p, n):
    xy = rng.uniform(0, 800, (p, n, 2))
    wh = rng.uniform(2, 300, (p, n, 2))
    boxes = np.concatenate([xy, xy + wh], 2).astype(np.float32)
    return torch.from_numpy(boxes), torch.from_numpy(rng.rand(p, n) > 0.1)


def pyramid(rng, b, h, w, c):
    return [torch.from_numpy(rng.randn(b, h // 2 ** i, w // 2 ** i, c)
                             .astype(np.float32)) for i in range(4)]


def rois_for(rng, b, n, h, w):
    xy = rng.uniform(0, [w, h], (b, n, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(max(h, w)), (b, n, 2)))
    rois = np.concatenate([xy, xy + wh], 2).astype(np.float32)
    rois[:, :2] = [[0, 40, w - 1, 60], [0, 0, w - 1, h - 1]]
    return torch.from_numpy(rois)


def test_nms_wrapper_takes_plain_on_cpu():
    boxes, valid = random_problems(np.random.RandomState(0), 3, 70)
    before = knms.launches
    keep = knms.nms_keep_sorted(boxes, valid, 0.5)
    assert knms.launches == before
    assert torch.equal(keep, knms.nms_keep_sorted_plain(boxes, valid, 0.5))
    assert not (keep & ~valid).any()


def patchy(rng, feats, patch=4):
    """Features made of constant patch x patch squares, a quarter of them 0:
    many bins then have samples tied at their max."""
    out = []
    for f in feats:
        b, h, w, c = f.shape
        v = rng.randn(b, -(-h // patch), -(-w // patch), c) * (
            rng.rand(b, -(-h // patch), -(-w // patch), 1) > 0.25)
        v = np.repeat(np.repeat(v, patch, 1), patch, 2)[:, :h, :w]
        out.append(torch.from_numpy(v.astype(np.float32)))
    return out


def test_roi_align_wrapper_takes_plain_on_cpu():
    rng = np.random.RandomState(1)
    feats = pyramid(rng, 1, 32, 48, 4)
    rois = rois_for(rng, 1, 9, 128, 192)
    before = kroi.launches
    out = kroi.multilevel_roi_align(feats, rois, STRIDES, out_size=7)
    assert kroi.launches == before and out.shape == (1, 9, 7, 7, 4)
    torch.testing.assert_close(out, kroi.multilevel_roi_align_plain(
        feats, rois, STRIDES, out_size=7), rtol=0, atol=0)


def test_roi_align_backward_takes_plain_on_cpu():
    """Features that require grad on the CPU: the plain forward with codes and
    the plain backward, no launch counted."""
    rng = np.random.RandomState(2)
    feats = [f.requires_grad_() for f in patchy(rng, pyramid(rng, 1, 32, 48,
                                                              4))]
    rois = rois_for(rng, 1, 9, 128, 192)
    before = (kroi.launches, kroi.bwd_launches)
    out = kroi.multilevel_roi_align(feats, rois, STRIDES, out_size=7)
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    grads = torch.autograd.grad(out, feats, g)
    assert (kroi.launches, kroi.bwd_launches) == before
    _, codes = kroi.multilevel_roi_align_plain(
        [f.detach() for f in feats], rois, STRIDES, with_codes=True)
    want = kroi.multilevel_roi_align_bwd_plain(
        g, codes, rois, [tuple(f.shape[1:3]) for f in feats],
        strides=STRIDES, dtype=torch.float32)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,thr", [(10, 1000, 0.7), (80, 1000, 0.5),
                                     (10, 2000, 0.7), (3, 65, 0.5)])
def test_nms_kernel_matches_plain(cuda, p, n, thr):
    """Keep masks bit-identical to the plain version, all problems in one
    launch."""
    boxes, valid = random_problems(np.random.RandomState(n + p), p, n)
    boxes, valid = boxes.to(cuda), valid.to(cuda)
    before = knms.launches
    got = knms.nms_keep_sorted(boxes, valid, thr)
    torch.cuda.synchronize()
    assert knms.launches == before + 1
    assert torch.equal(got, knms.nms_keep_sorted_plain(boxes, valid, thr))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_kernel_matches_plain(cuda, dtype):
    """fp32 within 1e-4 of the plain version (the same float32 operations in
    the same order); bf16 against the plain fp32 result rounded once to bf16,
    within one bf16 ulp (2^-7 relative, 1e-3 near zero)."""
    rng = np.random.RandomState(5)
    dt = getattr(torch, dtype)
    feats = [f.to(cuda, dt) for f in pyramid(rng, 2, 200, 336, 256)]
    rois = rois_for(rng, 2, 300, 800, 1344).to(cuda)
    before = kroi.launches
    got = kroi.multilevel_roi_align(feats, rois, STRIDES, out_size=7)
    torch.cuda.synchronize()
    assert kroi.launches == before + 1 and got.dtype == dt
    want = kroi.multilevel_roi_align_plain([f.float() for f in feats], rois,
                                           STRIDES, out_size=7)
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want.to(dt).float(),
                                   rtol=2 ** -7, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [False, True], ids=["random", "patches"])
def test_roi_align_backward_kernel_matches_plain(cuda, dtype, tied):
    """Training shapes (B=2, R=512, C=256): tie codes identical to the plain
    version's; fp32 gradients within 1e-5 of each level's max |grad| of the
    plain backward (atomics reorder the sums); bf16 within one bf16 ulp of
    the plain fp32 result rounded once."""
    rng = np.random.RandomState(6 + tied)
    dt = getattr(torch, dtype)
    feats = pyramid(rng, 2, 200, 336, 256)
    if tied:
        feats = patchy(rng, feats)
    feats = [f.to(cuda, dt) for f in feats]
    rois = rois_for(rng, 2, 512, 800, 1344).to(cuda)
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    before = (kroi.launches, kroi.bwd_launches)
    out, codes = kroi.roi_align_fwd_cuda(feats, rois, STRIDES,
                                         with_codes=True)
    want_out, want_codes = kroi.multilevel_roi_align_plain(
        [f.float() for f in feats], rois, STRIDES, with_codes=True)
    torch.cuda.synchronize()
    assert torch.equal(codes, want_codes)
    assert torch.equal(out.float(), want_out.to(dt).float())
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(cuda, dt)
    got = kroi.roi_align_bwd_cuda(g, codes, rois, level_hw, strides=STRIDES,
                                  dtype=dt)
    torch.cuda.synchronize()
    assert (kroi.launches, kroi.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    want = kroi.multilevel_roi_align_bwd_plain(
        g.float(), codes, rois, level_hw, strides=STRIDES,
        dtype=torch.float32)
    for gl, wl in zip(got, want):
        assert gl.dtype == dt
        scale = float(wl.abs().max())
        if dt == torch.float32:
            assert float((gl - wl).abs().max()) <= 1e-5 * scale
        else:
            torch.testing.assert_close(gl.float(), wl.to(dt).float(),
                                       rtol=2 ** -7, atol=1e-5 * scale)


@pytest.mark.cuda
def test_roi_align_autograd_on_card(cuda):
    """Gradients through `multilevel_roi_align` on CUDA tensors (kernel
    forward with codes, kernel backward) against torch.autograd of the plain
    forward on the same tensors."""
    rng = np.random.RandomState(8)
    feats = [f.to(cuda).requires_grad_()
             for f in patchy(rng, pyramid(rng, 2, 96, 160, 64))]
    rois = rois_for(rng, 2, 64, 384, 640).to(cuda)
    g = torch.from_numpy(rng.randn(2, 64, 7, 7, 64).astype(np.float32)).to(cuda)
    before = kroi.bwd_launches
    got = torch.autograd.grad(kroi.multilevel_roi_align(feats, rois, STRIDES),
                              feats, g)
    assert kroi.bwd_launches == before + 1
    want = torch.autograd.grad(kroi.multilevel_roi_align_plain(
        feats, rois, STRIDES), feats, g)
    assert kroi.bwd_launches == before + 1
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
