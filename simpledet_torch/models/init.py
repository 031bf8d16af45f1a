"""Seeded weight init with the distributions that the Flax initialisers name.

Flax's default for nn.Conv / nn.Dense kernels is lecun_normal (a normal
truncated at 2 std, with variance 1 / fan_in); the FPN and box-head layers use
variance_scaling(1, fan_in, uniform); the mask head's convs use
variance_scaling(2, fan_out, truncated_normal) (MSRA fan-out); the RPN and
the predictors use plain normals. Biases start at zero. Every draw takes the
caller's torch.Generator.
"""
import math

import torch


def fan_in(weight):
    return weight.shape[1] * math.prod(weight.shape[2:])


@torch.no_grad()
def lecun_normal_(weight, gen):
    # 0.8796... is the std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in(weight)) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                       generator=gen)


@torch.no_grad()
def msra_out_normal_(weight, gen, fan_out):
    """variance_scaling(2.0, "fan_out", "truncated_normal"): a normal
    truncated at 2 std with variance 2 / fan_out (Flax's fan_out of a conv
    kernel: its output channels times kh * kw)."""
    std = math.sqrt(2.0 / fan_out) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                       generator=gen)


@torch.no_grad()
def fan_in_uniform_(weight, gen):
    lim = math.sqrt(3.0 / fan_in(weight))
    return weight.uniform_(-lim, lim, generator=gen)


@torch.no_grad()
def normal_(weight, std, gen):
    return weight.normal_(0.0, std, generator=gen)
