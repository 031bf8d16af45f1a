"""Conv and dense layers with Flax's `dtype=` semantics.

A Flax `nn.Conv(dtype=bf16)` keeps its parameters in fp32, casts its input,
kernel and bias to bf16, convolves to a bf16 output and adds the bias in bf16.
`torch.autocast` differs: it recasts every matrix product, fp32 islands
included, and leaves elementwise ops in the promoted dtype. So each layer here
carries its own compute dtype, as the JAX package passes one per component.
`conv2d` and `linear` give the plain torch layers for fp32, so an fp32 model
runs exactly the modules it ran before bf16 was ported.

`SameConv2d` pads as Flax's default `padding="SAME"` does, side by side from
the input's shape: at stride 2 on an even side that is (0, 1), which no
symmetric torch padding gives (RetinaNet's P6 and P7, the v1d stem).
"""
import torch
from torch import nn
from torch.nn import functional as F


def _add_bias(y, bias, dtype, dim):
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[dim] = -1
    return y + bias.to(dtype).view(shape)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with fp32 parameters that computes in `compute_dtype`."""

    def __init__(self, *args, compute_dtype, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                     self.padding, self.dilation, self.groups)
        return _add_bias(y, self.bias, dt, 1)


class Linear(nn.Linear):
    """nn.Linear with fp32 parameters that computes in `compute_dtype`."""

    def __init__(self, *args, compute_dtype, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return _add_bias(F.linear(x.to(dt), self.weight.to(dt)), self.bias,
                         dt, -1)


def same_pads(n, k, s, d=1):
    """(before, after) padding of one side of length n under Flax's SAME
    for a k-wide kernel at stride s and dilation d (its extent (k - 1) * d
    + 1)."""
    total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """nn.Conv2d padded as Flax's SAME pads, side by side; it computes in
    `compute_dtype` as Conv2d does (fp32: nn.Conv2d's own forward)."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        (k_h, k_w), (s_h, s_w) = self.kernel_size, self.stride
        d_h, d_w = self.dilation
        top, bottom = same_pads(x.shape[2], k_h, s_h, d_h)
        left, right = same_pads(x.shape[3], k_w, s_w, d_w)
        x = F.pad(x, (left, right, top, bottom))
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                     self.padding, self.dilation, self.groups)
        return _add_bias(y, self.bias, dt, 1)


def conv2d(*args, compute_dtype=torch.float32, **kwargs):
    """nn.Conv2d(*args, **kwargs) for fp32, else Conv2d in compute_dtype."""
    if compute_dtype == torch.float32:
        return nn.Conv2d(*args, **kwargs)
    return Conv2d(*args, compute_dtype=compute_dtype, **kwargs)


def linear(*args, compute_dtype=torch.float32, **kwargs):
    """nn.Linear(*args, **kwargs) for fp32, else Linear in compute_dtype."""
    if compute_dtype == torch.float32:
        return nn.Linear(*args, **kwargs)
    return Linear(*args, compute_dtype=compute_dtype, **kwargs)
