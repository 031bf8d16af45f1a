"""Multilevel RoIAlign with a learned offset per bin, in plain PyTorch
(counterpart of the gather path of simpledet_tpu/kernels/roi_align.py:
`_roi_align_flat` with `bin_offset` under `multilevel_roi_align_gather`).

TSD pools twice a step with it: the classification branch's rois with an
offset per bin, the regression branch's shifted rois with one offset per roi
tiled over its bins. The JAX package runs it as a gather on every platform;
it is not one of the Pallas kernels, and the RoIAlign kernel
(`kernels/roi_align.py`) does not take it: that kernel clamps the level by
the roi's long side and gives rois no gradient, and this pool needs both
differently:
  - each roi's level is the plain FPN area rule (`fpn_roi_level`), without
    the long-side clamp;
  - it is differentiable with respect to the features, the rois and the
    offsets (TSD trains its offset predictor through both);
  - the bins are clipped to [0, dim - 1] as the plain RoIAlign clips them
    (`torch.minimum` / `torch.maximum`, which split the gradient at a tie as
    JAX's clip does); each bin's 2 x 2 samples at 1/3 and 2/3 of it then
    move by (dx * trans_std * roi_w, dy * trans_std * roi_h) in the level's
    cells and are not clipped again: only the bilinear taps are clamped to
    the map, and where a sample's two taps coincide its weight is 0.5
    (`torch.where`, so that no gradient reaches the offset there);
  - the bin value is the max of its four samples (`amax`, which splits the
    gradient evenly over tied samples as jnp.max does), 0 for an empty bin.
It computes in fp32. At 2 x 512 rois, 7 x 7 bins and 256 channels each
[N, P, P, 2, 2, C] term is 205 MB in fp32, and autograd keeps the four
gathered taps and the samples of each call for the backward.
"""
import math

import torch

from simpledet_torch.kernels.roi_align import true_div
from simpledet_torch.targets.fpn_assign import fpn_roi_level


def _clip(v, hi):
    return torch.minimum(torch.maximum(v, torch.zeros((), dtype=v.dtype,
                                                      device=v.device)), hi)


def deformable_roi_align(feats, rois, bin_offset, strides, *, out_size=7,
                         canonical_scale=224, canonical_level=4,
                         trans_std=0.1):
    """feats: the levels' NHWC maps [B, H_l, W_l, C], finest first; rois
    [B, R, 4]; bin_offset [B, R, P, P, 2] as (dx, dy) in units of
    trans_std times the roi's width and height -> [B, R, P, P, C] fp32."""
    b, r = rois.shape[:2]
    n, p, c = b * r, out_size, feats[0].shape[-1]
    dev, dt = rois.device, torch.float32
    rois_f = rois.reshape(n, 4).float()
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    lvl = (fpn_roi_level(rois_f.detach(), canonical_scale=canonical_scale,
                         canonical_level=canonical_level,
                         min_level=int(math.log2(strides[0])),
                         max_level=int(math.log2(strides[-1])))
           - int(math.log2(strides[0]))).long()
    heights = torch.tensor([h for h, _ in level_hw], device=dev)[lvl]
    widths = torch.tensor([w for _, w in level_hw], device=dev)[lvl]
    scale = torch.tensor([1.0 / s for s in strides], dtype=dt,
                         device=dev)[lvl][:, None]
    x1, y1, x2, y2 = (rois_f[:, k:k + 1] * scale for k in range(4))
    bin_h = true_div(y2 - y1, p)
    bin_w = true_div(x2 - x1, p)
    grid = torch.arange(p, dtype=dt, device=dev)
    hmax = (heights - 1).to(dt)[:, None]
    wmax = (widths - 1).to(dt)[:, None]
    hstart = _clip(y1 + grid[None, :] * bin_h, hmax)            # [N, P]
    hend = _clip(y1 + (grid[None, :] + 1) * bin_h, hmax)
    wstart = _clip(x1 + grid[None, :] * bin_w, wmax)
    wend = _clip(x1 + (grid[None, :] + 1) * bin_w, wmax)
    empty = (hend <= hstart)[:, :, None] | (wend <= wstart)[:, None, :]

    fr = torch.tensor([1.0 / 3.0, 2.0 / 3.0], dtype=dt, device=dev)
    ys = hstart[:, :, None] + (hend - hstart)[:, :, None] * fr   # [N, P, 2]
    xs = wstart[:, :, None] + (wend - wstart)[:, :, None] * fr
    off = bin_offset.reshape(n, p, p, 2).float()
    dy = off[..., 1] * trans_std * (y2 - y1)[:, :, None]          # [N, P, P]
    dx = off[..., 0] * trans_std * (x2 - x1)[:, :, None]
    # [N, P(y), P(x), 2(sy), 2(sx)]
    y = ys[:, :, None, :, None] + dy[:, :, :, None, None]
    x = xs[:, None, :, None, :] + dx[:, :, :, None, None]

    def taps(v, hi):
        hi = hi[:, :, None, None, None]
        lo_i = _clip(torch.floor(v), hi)
        hi_i = _clip(torch.ceil(v), hi)
        w = torch.where(hi_i > lo_i, v - lo_i, torch.full_like(v, 0.5))
        return lo_i.long(), hi_i.long(), w[..., None]

    yl, yh, a = taps(y, hmax)
    xl, xh, bt = taps(x, wmax)
    sizes = torch.tensor([h * w for h, w in level_hw], device=dev)
    starts = torch.cumsum(b * sizes, 0) - b * sizes
    img = torch.arange(n, device=dev) // r
    base = (starts[lvl] + img * sizes[lvl])[:, None, None, None, None]
    width = widths[:, None, None, None, None]
    table = torch.cat([f.reshape(-1, c).float() for f in feats])

    def take(yy, xx):
        rows = base + yy * width + xx                  # [N, P, P, 2, 2]
        return table.index_select(0, rows.reshape(-1)).view(*rows.shape, c)

    val = ((1 - a) * (1 - bt) * take(yl, xl) + a * (1 - bt) * take(yh, xl)
           + (1 - a) * bt * take(yl, xh) + a * bt * take(yh, xh))
    out = val.amax(dim=(3, 4))
    out = torch.where(empty[..., None], torch.zeros((), device=dev), out)
    return out.reshape(b, r, p, p, c)
