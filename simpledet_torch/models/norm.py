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


@torch.no_grad()
def fold_batch_stats(model, *inputs, eps=1e-5):
    """Give every FrozenBN of `model` the scale and bias that folding a
    BatchNorm with gamma 1, beta 0 and the statistics of this batch would
    give: per channel, scale = 1 / sqrt(var + eps), bias = -mean * scale,
    taken layer by layer in forward order on `model(*inputs)`.

    A stand-in for a pretrained checkpoint's folded statistics until
    checkpoint loading is ported: with seeded random convs and identity
    FrozenBN, activations grow to the scale of the normalised pixels (std ~74
    for the flagship's std-1 normalisation) and a few SGD steps diverge."""
    def fold(mod, args, out):
        x = args[0].float()
        dims = [d for d in range(x.dim()) if d != 1]
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        mod.scale.copy_(torch.rsqrt(var + eps))
        mod.bias.copy_(-mean * mod.scale)
        return FrozenBN.forward(mod, args[0])   # the output, refolded

    hooks = [m.register_forward_hook(fold) for m in model.modules()
             if isinstance(m, FrozenBN)]
    try:
        model(*inputs)
    finally:
        for h in hooks:
            h.remove()
