"""FrozenBN (counterpart of simpledet_tpu/models/norm.py::FrozenBN).

y = x * scale + bias per channel, with scale and bias as buffers: a checkpoint
folds gamma, beta, mean and var into them; a fresh model is the identity.
"""
import torch
from torch import nn


class FrozenBN(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.register_buffer("scale", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x * self.scale.to(x.dtype).view(shape)
                + self.bias.to(x.dtype).view(shape))
