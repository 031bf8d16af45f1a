"""Conv and dense layers with Flax's `dtype=` semantics.

A Flax `nn.Conv(dtype=bf16)` keeps its parameters in fp32, casts its input,
kernel and bias to bf16, convolves to a bf16 output and adds the bias in bf16.
`torch.autocast` differs: it recasts every matrix product, fp32 islands
included, and leaves elementwise ops in the promoted dtype. So each layer here
carries its own compute dtype, as the JAX package passes one per component.
`conv2d` and `linear` give the plain torch layers for fp32, so an fp32 model
runs exactly the modules it ran before bf16 was ported.
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
