"""Multilevel RoIAlign forward: the CUDA kernel and its plain version.

Replaces the pooled output of
`simpledet_tpu/kernels/roi_align_pallas.py::_fwd_kernel` (RoIAlignV2, max over
2 x 2 samples per bin). For each roi:
  - its FPN level comes from the area rule plus the long-side clamp: a roi
    whose long side spans more than `crop - 4` cells of the finest level moves
    up to the coarsest level it fits (`crop` as `auto_crop` gives it, 48 at
    800 x 1333);
  - bins are clipped to [0, dim - 1]; each bin takes samples at 1/3 and 2/3 of
    its height and width, each bilinear with edge clamping;
  - the bin value is the max over its 4 samples; an empty bin is 0.

Features are the per-level NHWC maps [B, H_l, W_l, C] (a channels_last NCHW
tensor permuted to NHWC is such a map at no cost); rois are [B, R, 4]; the
output is [B, R, P, P, C] in the features' dtype. A CPU tensor goes to
`multilevel_roi_align_plain`; a CUDA tensor launches `csrc/roi_align.cu` or
raises.
"""
import ctypes
import math

import numpy as np
import torch

from simpledet_torch.kernels import _build
from simpledet_torch.targets.fpn_assign import fpn_roi_level

launches = 0   # kernel launches since the caller last set this to 0

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


def multilevel_roi_align_plain(feats, rois, strides, *, out_size=7,
                               canonical_scale=224, canonical_level=4):
    """Plain PyTorch version: the gather formula of
    `simpledet_tpu/kernels/roi_align.py::_roi_align_flat` with the long-side
    level clamp. Computes in float32, returns the features' dtype."""
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    p = out_size
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    rois_f = rois.reshape(b * r, 4).float()
    lvl = roi_level_index(rois_f, level_hw, strides, canonical_scale,
                          canonical_level, p)
    (yl, yh, alpha), (xl, xh, beta), empty = _sample_taps(
        rois_f, lvl, level_hw, strides, p)

    table = torch.cat([f.reshape(-1, c).float() for f in feats])
    sizes = torch.tensor([h * w for h, w in level_hw], device=rois.device)
    starts = torch.cumsum(b * sizes, 0) - b * sizes
    img = torch.arange(b, device=rois.device).repeat_interleave(r)
    base = starts[lvl] + img * sizes[lvl]
    width = torch.tensor([w for _, w in level_hw], device=rois.device)[lvl]

    # broadcast to [N, P(y), P(x), 2(sy), 2(sx)]
    def by(v):
        return v[:, :, None, :, None]

    def bx(v):
        return v[:, None, :, None, :]

    def take(yy, xx):
        idx = (base[:, None, None, None, None] + by(yy)
               * width[:, None, None, None, None] + bx(xx))
        return table[idx]

    a, bt = by(alpha)[..., None], bx(beta)[..., None]
    val = ((1 - a) * (1 - bt) * take(yl, xl)
           + a * (1 - bt) * take(yh, xl)
           + (1 - a) * bt * take(yl, xh)
           + a * bt * take(yh, xh))
    out = val.amax(dim=(3, 4))
    out = torch.where(empty[..., None], torch.zeros((), device=out.device), out)
    return out.to(feats[0].dtype).reshape(b, r, p, p, c)


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


def multilevel_roi_align(feats, rois, strides, *, out_size=7,
                         canonical_scale=224, canonical_level=4):
    """feats: list of [B, H_l, W_l, C] NHWC maps (float32 or bfloat16, finest
    first); rois [B, R, 4] float32 -> [B, R, P, P, C] in the feature dtype."""
    global launches
    dev = rois.device
    if dev.type == "cpu":
        return multilevel_roi_align_plain(
            feats, rois, strides, out_size=out_size,
            canonical_scale=canonical_scale, canonical_level=canonical_level)
    if dev.type != "cuda":
        raise ValueError(f"multilevel_roi_align: unsupported device {dev}")
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
        if (f.device != dev or f.dtype != dtype or f.dim() != 4
                or f.shape[0] != b or f.shape[3] != c or not f.is_contiguous()):
            raise ValueError("multilevel_roi_align: every level must be a "
                             "contiguous [B, H, W, C] map on the rois' device "
                             "in one dtype")
    rois = rois.contiguous()
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    crop = auto_crop(level_hw, strides, canonical_scale, canonical_level,
                     out_size)
    lv = _Levels()
    for i, (f, s) in enumerate(zip(feats, strides)):
        lv.feat[i] = f.data_ptr()
        lv.height[i], lv.width[i] = level_hw[i]
        lv.scale[i] = 1.0 / s
    lv.n_level = len(feats)
    lv.min_level = int(math.log2(strides[0]))
    lv.max_level = int(math.log2(strides[-1]))
    lv.canonical_scale = canonical_scale
    lv.canonical_level = canonical_level
    lv.fit_px = (crop - 4.0) * strides[0]
    out = torch.empty((b, r, out_size, out_size, c), dtype=dtype, device=dev)
    lib = _lib()
    err = lib.simpledet_roi_align_fwd(
        ctypes.byref(lv), rois.data_ptr(), out.data_ptr(), b, r, c, out_size,
        int(dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    _build.check(lib, err, "multilevel_roi_align")
    return out


def _lib():
    lib = _build.load("roi_align")
    fn = lib.simpledet_roi_align_fwd
    fn.argtypes = [ctypes.POINTER(_Levels), ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
