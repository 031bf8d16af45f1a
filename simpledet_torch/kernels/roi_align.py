"""Multilevel RoIAlign, forward and backward: the CUDA kernels, their plain
versions, and the autograd Function that joins them.

Replaces `simpledet_tpu/kernels/roi_align_pallas.py`: `_fwd_kernel` (pooled
output and sample mask) and `_bwd_kernel` (feature gradient). For each roi:
  - its FPN level comes from the area rule plus the long-side clamp: a roi
    whose long side spans more than `crop - 4` cells of the finest level moves
    up to the coarsest level it fits (`crop` as `auto_crop` gives it, 48 at
    800 x 1333);
  - bins are clipped to [0, dim - 1]; each bin takes samples at 1/3 and 2/3 of
    its height and width, each bilinear with edge clamping;
  - the bin value is the max over its 4 samples; an empty bin is 0.
When a feature requires grad, the forward also returns one uint8 tie code per
output value: bit 2*sy+sx is set when that sample reaches the bin max (the
Pallas mask, `roi_align_pallas.py:339-342`); empty bins get 0. The backward
splits each bin's gradient evenly over its tied samples (`g / popcount`, as
the Pallas kernel's `g / count(mask)` and as the max's own derivative in JAX
and PyTorch) and routes each share through the sample's four bilinear taps.
Rois get no gradient.

Accumulation differs from the JAX package in one respect: with bf16 features
the Pallas backward accumulates in bf16 tables, rounding at every window it
adds; the port accumulates in fp32 and rounds to bf16 once at the end.

Features are the per-level NHWC maps [B, H_l, W_l, C] (a channels_last NCHW
tensor permuted to NHWC is such a map at no cost); rois are [B, R, 4]; the
output is [B, R, P, P, C] in the features' dtype. `multilevel_roi_align` is
the entry: CPU tensors take the plain forward and the plain backward
(`multilevel_roi_align_plain`, `multilevel_roi_align_bwd_plain`); CUDA
tensors launch `csrc/roi_align.cu` or raise.
"""
import ctypes
import math

import numpy as np
import torch

from simpledet_torch.kernels import _build
from simpledet_torch.targets.fpn_assign import fpn_roi_level

launches = 0       # forward kernel launches since the caller set this to 0
bwd_launches = 0   # backward kernel launches since the caller set this to 0

MAX_LEVELS = 4
MAX_OUT_SIZE = 16


def true_div(x, number):
    """x / number rounded as true division on every device (PyTorch's CUDA
    division by a Python number multiplies by its reciprocal instead)."""
    return x / torch.tensor(float(number), dtype=x.dtype, device=x.device)


def auto_crop(level_hw, strides, canonical_scale, canonical_level, out_size):
    """Cell span that bounds every roi after the long-side clamp (the TPU
    kernel's window size, `roi_align_pallas.py::_auto_crop`)."""
    longest = max(max(h, w) * s for (h, w), s in zip(level_hw, strides))
    unclamped = 2.0 * canonical_scale / (2 ** canonical_level)
    crop = int(np.ceil(max(unclamped + 4, longest / strides[-1] + 2,
                           2 * out_size)))
    return -(-crop // 8) * 8


def roi_level_index(rois, level_hw, strides, canonical_scale,
                    canonical_level, out_size):
    """[N, 4] rois -> int64 level index in [0, L): area rule plus the long-side
    clamp."""
    min_level = int(math.log2(strides[0]))
    max_level = int(math.log2(strides[-1]))
    lvl = fpn_roi_level(rois, canonical_scale=canonical_scale,
                        canonical_level=canonical_level,
                        min_level=min_level, max_level=max_level) - min_level
    crop = auto_crop(level_hw, strides, canonical_scale, canonical_level,
                     out_size)
    long_px = torch.maximum(rois[:, 2] - rois[:, 0], rois[:, 3] - rois[:, 1])
    needed = torch.ceil(torch.log2(
        true_div(long_px, (crop - 4.0) * strides[0]).clamp(min=1e-6)))
    needed = needed.clamp(0, len(strides) - 1).to(torch.int32)
    return torch.maximum(lvl, needed).long()


def _sample_taps(rois, lvl, level_hw, strides, out_size):
    """Per roi and sample: the bilinear taps and weights, in the order of
    operations that the kernel repeats.

    Returns (yl, yh, alpha) [N, P, 2] and (xl, xh, beta) [N, P, 2] (tap
    indices as int64 and their weights), and empty [N, P, P] bool."""
    dev, dt = rois.device, rois.dtype
    heights = torch.tensor([h for h, _ in level_hw], device=dev)[lvl]
    widths = torch.tensor([w for _, w in level_hw], device=dev)[lvl]
    scales = torch.tensor([1.0 / s for s in strides], dtype=dt, device=dev)[lvl]
    p = out_size
    scale = scales[:, None]
    x1 = rois[:, 0:1] * scale
    y1 = rois[:, 1:2] * scale
    x2 = rois[:, 2:3] * scale
    y2 = rois[:, 3:4] * scale
    bin_h = true_div(y2 - y1, p)
    bin_w = true_div(x2 - x1, p)
    grid = torch.arange(p, dtype=dt, device=dev)
    hmax = (heights - 1).to(dt)[:, None]
    wmax = (widths - 1).to(dt)[:, None]
    zero = torch.zeros((), dtype=dt, device=dev)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi)

    hstart = clip(y1 + grid[None, :] * bin_h, hmax)
    hend = clip(y1 + (grid[None, :] + 1) * bin_h, hmax)
    wstart = clip(x1 + grid[None, :] * bin_w, wmax)
    wend = clip(x1 + (grid[None, :] + 1) * bin_w, wmax)
    empty = (hend <= hstart)[:, :, None] | (wend <= wstart)[:, None, :]

    fr = torch.tensor([1.0 / 3.0, 2.0 / 3.0], dtype=dt, device=dev)
    ys = hstart[:, :, None] + (hend - hstart)[:, :, None] * fr   # [N, P, 2]
    xs = wstart[:, :, None] + (wend - wstart)[:, :, None] * fr

    def taps(v, hi):
        hi = hi[:, :, None]
        lo_i = clip(torch.floor(v), hi)
        hi_i = clip(torch.ceil(v), hi)
        w = torch.where(hi_i > lo_i, v - lo_i, torch.full_like(v, 0.5))
        return lo_i.long(), hi_i.long(), w

    return taps(ys, hmax), taps(xs, wmax), empty


class _Geometry:
    """What the plain forward and backward share for one call: each sample's
    four taps as rows of the levels' concatenated [sum B*H*W, C] table, with
    their bilinear weights, all broadcast to [N, P(y), P(x), 2(sy), 2(sx)]."""

    def __init__(self, level_hw, rois, strides, out_size, canonical_scale,
                 canonical_level):
        b, r = rois.shape[:2]
        dev = rois.device
        rois_f = rois.reshape(b * r, 4).float()
        lvl = roi_level_index(rois_f, level_hw, strides, canonical_scale,
                              canonical_level, out_size)
        (yl, yh, alpha), (xl, xh, beta), self.empty = _sample_taps(
            rois_f, lvl, level_hw, strides, out_size)
        sizes = torch.tensor([h * w for h, w in level_hw], device=dev)
        self.starts = (torch.cumsum(b * sizes, 0) - b * sizes).tolist()
        img = torch.arange(b, device=dev).repeat_interleave(r)
        base = (torch.tensor(self.starts, device=dev)[lvl]
                + img * sizes[lvl])[:, None, None, None, None]
        width = torch.tensor([w for _, w in level_hw],
                             device=dev)[lvl][:, None, None, None, None]

        def by(v):
            return v[:, :, None, :, None]

        def bx(v):
            return v[:, None, :, None, :]

        def row(yy, xx):
            return base + by(yy) * width + bx(xx)

        a, bt = by(alpha)[..., None], bx(beta)[..., None]
        # (table rows, weight [.., 1]) for the taps (yl, xl), (yh, xl),
        # (yl, xh), (yh, xh): the order in which the forward sums them
        self.taps = [(row(yl, xl), (1 - a) * (1 - bt)),
                     (row(yh, xl), a * (1 - bt)),
                     (row(yl, xh), (1 - a) * bt),
                     (row(yh, xh), a * bt)]
        self.shape = (b, r, out_size)


def _tie_codes(val, out, empty):
    """uint8 [N, P, P, C]: bit 2*sy+sx set where sample (sy, sx) of
    val [N, P, P, 2, 2, C] reaches the bin max `out` [N, P, P, C]."""
    ties = val >= out[:, :, :, None, None, :]
    bits = torch.tensor([[1, 2], [4, 8]], dtype=torch.uint8,
                        device=val.device)[:, :, None]
    codes = (ties.to(torch.uint8) * bits).sum(dim=(3, 4), dtype=torch.uint8)
    return torch.where(empty[..., None], torch.zeros_like(codes), codes)


def multilevel_roi_align_plain(feats, rois, strides, *, out_size=7,
                               canonical_scale=224, canonical_level=4,
                               with_codes=False):
    """Plain PyTorch version: the gather formula of
    `simpledet_tpu/kernels/roi_align.py::_roi_align_flat` with the long-side
    level clamp. Computes in float32, returns the features' dtype; with
    `with_codes`, (out, tie codes [B*R, P, P, C] uint8)."""
    c = feats[0].shape[-1]
    geo = _Geometry([tuple(f.shape[1:3]) for f in feats], rois, strides,
                    out_size, canonical_scale, canonical_level)
    table = torch.cat([f.reshape(-1, c).float() for f in feats])
    val = None
    for rows, w in geo.taps:
        term = w * table[rows]
        val = term if val is None else val + term
    out = val.amax(dim=(3, 4))
    out = torch.where(geo.empty[..., None], torch.zeros((), device=out.device),
                      out)
    b, r, p = geo.shape
    result = out.to(feats[0].dtype).reshape(b, r, p, p, c)
    if with_codes:
        return result, _tie_codes(val, out, geo.empty)
    return result


def multilevel_roi_align_bwd_plain(grad, codes, rois, level_hw, *, strides,
                                   dtype, out_size=7, canonical_scale=224,
                                   canonical_level=4):
    """Plain backward: an explicit scatter (`index_add_`) of the forward's tap
    formula. grad [B, R, P, P, C], codes [B*R, P, P, C] from the forward ->
    per-level gradients [B, H_l, W_l, C] in `dtype`, accumulated in fp32."""
    c = grad.shape[-1]
    geo = _Geometry(level_hw, rois, strides, out_size, canonical_scale,
                    canonical_level)
    b, r, p = geo.shape
    g = grad.reshape(b * r, p, p, c).float()
    codes = codes.to(torch.int32)
    bits = torch.stack([(codes >> s) & 1 for s in range(4)], dim=3)
    count = bits.sum(dim=3).clamp(min=1)
    ginv = g / count.float()
    shares = (ginv[:, :, :, None, :] * bits.float()).reshape(
        b * r, p, p, 2, 2, c)
    table = torch.zeros(sum(b * h * w_ for h, w_ in level_hw), c,
                        dtype=torch.float32, device=grad.device)
    for rows, w in geo.taps:
        table.index_add_(0, rows.reshape(-1), (w * shares).reshape(-1, c))
    return [table[s:s + b * h * w_].reshape(b, h, w_, c).to(dtype)
            for s, (h, w_) in zip(geo.starts, level_hw)]


class _Levels(ctypes.Structure):
    _fields_ = [("feat", ctypes.c_void_p * MAX_LEVELS),
                ("height", ctypes.c_int * MAX_LEVELS),
                ("width", ctypes.c_int * MAX_LEVELS),
                ("scale", ctypes.c_float * MAX_LEVELS),
                ("n_level", ctypes.c_int),
                ("min_level", ctypes.c_int),
                ("max_level", ctypes.c_int),
                ("canonical_scale", ctypes.c_float),
                ("canonical_level", ctypes.c_float),
                ("fit_px", ctypes.c_float)]


class _GradMaps(ctypes.Structure):
    _fields_ = [("map", ctypes.c_void_p * MAX_LEVELS)]


def _levels(feats, level_hw, strides, out_size, canonical_scale,
            canonical_level):
    crop = auto_crop(level_hw, strides, canonical_scale, canonical_level,
                     out_size)
    lv = _Levels()
    for i, s in enumerate(strides):
        lv.feat[i] = feats[i].data_ptr() if feats is not None else 0
        lv.height[i], lv.width[i] = level_hw[i]
        lv.scale[i] = 1.0 / s
    lv.n_level = len(strides)
    lv.min_level = int(math.log2(strides[0]))
    lv.max_level = int(math.log2(strides[-1]))
    lv.canonical_scale = canonical_scale
    lv.canonical_level = canonical_level
    lv.fit_px = (crop - 4.0) * strides[0]
    return lv


def _check(feats, rois, strides, out_size):
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    dtype = feats[0].dtype
    if not 1 <= len(feats) <= MAX_LEVELS or len(strides) != len(feats):
        raise ValueError("multilevel_roi_align: 1 to 4 levels, one stride each")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"multilevel_roi_align: dtype {dtype}")
    if not 1 <= out_size <= MAX_OUT_SIZE:
        raise ValueError(f"multilevel_roi_align: out_size {out_size}")
    if rois.dtype != torch.float32 or rois.shape != (b, r, 4):
        raise ValueError("multilevel_roi_align: rois must be [B, R, 4] float32")
    for f in feats:
        if (f.device != rois.device or f.dtype != dtype or f.dim() != 4
                or f.shape[0] != b or f.shape[3] != c or not f.is_contiguous()):
            raise ValueError("multilevel_roi_align: every level must be a "
                             "contiguous [B, H, W, C] map on the rois' device "
                             "in one dtype")


def roi_align_fwd_cuda(feats, rois, strides, *, out_size=7,
                       canonical_scale=224, canonical_level=4,
                       with_codes=False):
    """Launch the forward kernel: out [B, R, P, P, C] in the features' dtype,
    and with `with_codes` the tie codes [B*R, P, P, C] uint8."""
    global launches
    _check(feats, rois, strides, out_size)
    b, r = rois.shape[:2]
    c, dtype, dev = feats[0].shape[-1], feats[0].dtype, rois.device
    rois = rois.contiguous()
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    lv = _levels(feats, level_hw, strides, out_size, canonical_scale,
                 canonical_level)
    out = torch.empty((b, r, out_size, out_size, c), dtype=dtype, device=dev)
    codes = (torch.empty((b * r, out_size, out_size, c), dtype=torch.uint8,
                         device=dev) if with_codes else None)
    lib = _lib()
    err = lib.simpledet_roi_align_fwd(
        ctypes.byref(lv), rois.data_ptr(), out.data_ptr(),
        codes.data_ptr() if with_codes else None, b, r, c, out_size,
        int(dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    _build.check(lib, err, "multilevel_roi_align")
    return (out, codes) if with_codes else out


def roi_align_bwd_cuda(grad, codes, rois, level_hw, *, strides, dtype,
                       out_size=7, canonical_scale=224, canonical_level=4):
    """Launch the backward kernel: per-level gradients [B, H_l, W_l, C] in
    `dtype`, accumulated by fp32 atomics into maps zeroed here."""
    global bwd_launches
    b, r = rois.shape[:2]
    c, dev = grad.shape[-1], grad.device
    p = out_size
    if grad.dtype != dtype or grad.shape != (b, r, p, p, c):
        raise ValueError("roi_align backward: grad must be [B, R, P, P, C] "
                         "in the features' dtype")
    if codes.dtype != torch.uint8 or codes.shape != (b * r, p, p, c):
        raise ValueError("roi_align backward: codes must be [B*R, P, P, C] "
                         "uint8")
    if rois.dtype != torch.float32 or rois.shape != (b, r, 4):
        raise ValueError("roi_align backward: rois must be [B, R, 4] float32")
    if not 1 <= len(level_hw) == len(strides) <= MAX_LEVELS:
        raise ValueError("roi_align backward: 1 to 4 levels, one stride each")
    if not grad.device == codes.device == rois.device:
        raise ValueError("roi_align backward: grad, codes and rois must be on "
                         "one device")
    grad, codes, rois = grad.contiguous(), codes.contiguous(), rois.contiguous()
    lv = _levels(None, level_hw, strides, out_size, canonical_scale,
                 canonical_level)
    sizes = [b * h * w * c for h, w in level_hw]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    maps = list(torch.split(flat, sizes))
    gm = _GradMaps()
    for i, m in enumerate(maps):
        gm.map[i] = m.data_ptr()
    lib = _lib()
    err = lib.simpledet_roi_align_bwd(
        ctypes.byref(lv), ctypes.byref(gm), rois.data_ptr(), grad.data_ptr(),
        codes.data_ptr(), b, r, c, p, int(dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    bwd_launches += 1
    _build.check(lib, err, "multilevel_roi_align backward")
    return [m.view(b, h, w, c).to(dtype) for m, (h, w) in zip(maps, level_hw)]


def _route(rois):
    dev = rois.device
    if dev.type == "cpu":
        return multilevel_roi_align_plain, multilevel_roi_align_bwd_plain
    if dev.type == "cuda":
        return roi_align_fwd_cuda, roi_align_bwd_cuda
    raise ValueError(f"multilevel_roi_align: unsupported device {dev}")


class _MultilevelRoIAlign(torch.autograd.Function):
    """Forward with tie codes and backward, on the rois' device's route
    (`_route`)."""

    @staticmethod
    def forward(ctx, rois, kw, *feats):
        fwd, ctx.bwd = _route(rois)
        out, codes = fwd(list(feats), rois, with_codes=True, **kw)
        ctx.save_for_backward(rois, codes)
        ctx.kw = kw
        ctx.level_hw = [tuple(f.shape[1:3]) for f in feats]
        ctx.dtype = feats[0].dtype
        return out

    @staticmethod
    def backward(ctx, grad):
        rois, codes = ctx.saved_tensors
        grads = ctx.bwd(grad, codes, rois, ctx.level_hw, dtype=ctx.dtype,
                        **ctx.kw)
        need = ctx.needs_input_grad[2:]
        return (None, None,
                *[g if n else None for g, n in zip(grads, need)])


def multilevel_roi_align(feats, rois, strides, *, out_size=7,
                         canonical_scale=224, canonical_level=4):
    """feats: list of [B, H_l, W_l, C] NHWC maps (float32 or bfloat16, finest
    first); rois [B, R, 4] float32 -> [B, R, P, P, C] in the feature dtype,
    differentiable with respect to the features. Where no feature needs a
    gradient (serving) the forward runs alone and writes no tie codes."""
    kw = dict(strides=tuple(strides), out_size=out_size,
              canonical_scale=canonical_scale, canonical_level=canonical_level)
    if torch.is_grad_enabled() and any(f.requires_grad for f in feats):
        return _MultilevelRoIAlign.apply(rois, kw, *feats)
    fwd, _ = _route(rois)
    return fwd(list(feats), rois, **kw)


def _lib():
    lib = _build.load("roi_align")
    fwd = lib.simpledet_roi_align_fwd
    fwd.argtypes = [ctypes.POINTER(_Levels), ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.simpledet_roi_align_bwd
    bwd.argtypes = [ctypes.POINTER(_Levels), ctypes.POINTER(_GradMaps),
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return lib
