"""Deformable convolution v1 and v2 (counterpart of
simpledet_tpu/ops/deform_conv.py): a batched bilinear gather of the sampled
patches, then one matrix product with the kernel.

The JAX package computes it outside any Pallas kernel (a vmapped gather and
an einsum); so does this module, in one set of operations for the whole
batch, with no loop over the images. Its backward is torch autograd (the
gather's is a scatter-add), as the JAX package's is JAX autodiff.

Layouts, as in the JAX package (and MXNet's DeformableConvolution):
- the offsets' channels are ordered (group, tap, {y, x}), the v2 mask's
  (group, tap); the input's channels split group-major into the groups;
- a tap samples bilinearly with zeros outside the map, each of its four
  corners masked on its own; v2 multiplies the sample by its (post-sigmoid)
  mask (here folded into the corners' weights);
- the padding is symmetric, `dilation * (k - 1) // 2` unless given, and the
  output grid is the offset map's own.
The gather reads the input as NHWC rows (a view of a channels_last tensor),
so each corner fetches a contiguous run of a group's channels; all four
corners of every tap go through one gather, one product with their weights
and one sum (each op a kernel launch: few of them keep the host from
bounding it); the samples are
laid out [B, H' * W', tap, channel], which is the JAX package's order of the
contraction with the HWIO kernel, and the output [B, H', W', F] is returned
as a channels_last NCHW view.
"""
import torch


def _grid(n_out, stride, pad, k, dilation, dtype, device):
    """The input coordinate of each output position's tap 0, and each tap's
    offset from it."""
    base = torch.arange(n_out, dtype=dtype, device=device) * stride - pad
    taps = torch.arange(k, dtype=dtype, device=device) * dilation
    return base, taps


def deform_conv2d(x, offset, weight, *, stride=1, dilation=1, padding=None,
                  num_deformable_group=1, mask=None, bias=None):
    """x [B, C, H, W]; offset [B, 2 * G * K * K, H', W']; weight [F, C, K,
    K] (OIHW); mask (v2, post-sigmoid) [B, G * K * K, H', W']; bias [F].
    Returns [B, F, H', W'] (channels_last memory)."""
    b, c, h, w = x.shape
    f, _, kh, kw = weight.shape
    kk, g = kh * kw, num_deformable_group
    cg = c // g
    pad = (dilation * (kh - 1)) // 2 if padding is None else padding
    oh, ow = offset.shape[2:]
    dt, dev = x.dtype, x.device

    oy, ky = _grid(oh, stride, pad, kh, dilation, dt, dev)
    ox, kx = _grid(ow, stride, pad, kw, dilation, dt, dev)
    # tap t = (i, j) of the kernel, row-major: (ky[i], kx[j])
    base_y = oy[:, None, None] + ky[:, None].expand(kh, kw).reshape(1, 1, kk)
    base_x = ox[None, :, None] + kx[None, :].expand(kh, kw).reshape(1, 1, kk)
    off = offset.permute(0, 2, 3, 1).reshape(b, oh, ow, g, kk, 2)
    y = base_y[None, :, :, None, :] + off[..., 0]      # [B, H', W', G, KK]
    xx = base_x[None, :, :, None, :] + off[..., 1]
    # positions ordered (output position, tap, group)
    y = y.transpose(3, 4).reshape(b, -1, g)
    xx = xx.transpose(3, 4).reshape(b, -1, g)

    # the four corners of each tap, stacked on dim 2: [B, H'W' KK, 4, G]
    y0, x0 = torch.floor(y), torch.floor(xx)
    wy, wx = y - y0, xx - x0
    cy = torch.stack([y0, y0 + 1, y0, y0 + 1], 2)
    cx = torch.stack([x0, x0, x0 + 1, x0 + 1], 2)
    cw = torch.stack([(1 - wy) * (1 - wx), wy * (1 - wx), (1 - wy) * wx,
                      wy * wx], 2)
    # an outside corner (a NaN one too) reads row 0 with weight 0
    inside = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
    idx = torch.where(inside, cy * w + cx, 0).long()
    cw = torch.where(inside, cw, 0)
    if mask is not None:
        m = mask.permute(0, 2, 3, 1).reshape(b, oh * ow, g, kk)
        cw = cw * m.transpose(2, 3).reshape(b, -1, 1, g)
    n = idx.shape[1]
    rows = x.permute(0, 2, 3, 1).reshape(b, h * w, g, cg)
    v = torch.gather(rows, 1, idx.view(b, n * 4, g, 1).expand(-1, -1, -1, cg))
    samp = (v.view(b, n, 4, g, cg) * cw[..., None]).sum(2)
    # [B, H' * W', KK * C] against the HWIO kernel [KK * C, F]
    cols = samp.reshape(b, oh * ow, kk * c)
    out = torch.matmul(cols, weight.permute(2, 3, 1, 0).reshape(kk * c, f))
    if bias is not None:
        out = out + bias
    return out.reshape(b, oh, ow, f).permute(0, 3, 1, 2)
