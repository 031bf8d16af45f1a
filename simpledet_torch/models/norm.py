"""Normalizers (counterpart of simpledet_tpu/models/norm.py): FrozenBN,
SyncBN, GroupNorm and `normalizer_factory`, which maps a config's normalizer
type onto them.

- FrozenBN: y = x * scale + bias per channel, with scale and bias as buffers:
  a checkpoint folds gamma, beta, mean and var into them; a fresh model is
  the identity.
- SyncBN: batch norm over (N, H, W) of the global batch. Under pjit the JAX
  package's batch mean spans every device of the mesh; here the per-channel
  sums are added over the process group (`parallel/dist.py`), whenever a
  group exists, a group of one included, in the forward and in the
  backward.
  Parameters `gamma` and `beta`, running statistics in the buffers `mean`
  and `var` (the JAX package's `batch_stats` collection).
- GroupNorm: Flax's `nn.GroupNorm(num_groups=32)`, parameters `scale` and
  `bias`.
"""
import torch
from torch import nn

from simpledet_torch.parallel.dist import sum_over_group


class FrozenBN(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.register_buffer("scale", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x * self.scale.to(x.dtype).view(shape)
                + self.bias.to(x.dtype).view(shape))


def _channel_view(t, ndim):
    return t.view((1, -1) + (1,) * (ndim - 2))


class SyncBN(nn.Module):
    """Batch norm with statistics over (N, H, W) of the global batch, as the
    JAX package's SyncBN computes them:
    - the input is cast to fp32 and the output back to the input's dtype;
    - var is the biased variance, mean((x - mean)^2), in two passes;
    - in training, the running statistics are an EMA with JAX momentum 0.9
      (torch's momentum=0.1) of the batch mean and the *biased* batch
      variance (torch's BatchNorm takes the unbiased one);
    - out of training, the running statistics are used when the model has
      them (`has_stats`: trained in this process, or loaded from a
      checkpoint's `.batch_stats`); a model without them normalises with the
      batch's statistics.
    """

    def __init__(self, channels, eps=1e-5, momentum=0.9):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.eps = eps
        self.momentum = momentum
        self.has_stats = False

    def forward(self, x):
        if self.training or not self.has_stats:
            out, mean, var = _BatchNorm.apply(x, self.gamma, self.beta,
                                              self.eps)
            if self.training:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                    self.var.copy_(m * self.var + (1.0 - m) * var)
                self.has_stats = True
            return out
        scale = self.gamma / torch.sqrt(self.var + self.eps)
        out = (x.float() * _channel_view(scale, x.dim())
               + _channel_view(self.beta - self.mean * scale, x.dim()))
        return out.to(x.dtype)


class _BatchNorm(torch.autograd.Function):
    """(y, mean, var) of SyncBN on the batch's statistics, one autograd node.

    Forward, as the JAX package computes it: xf = x in fp32; mean and the
    biased var over every axis but the channels, of the global batch (the
    sums and the element count through one group sum, the squared
    deviations through a second); scale = gamma / sqrt(var + eps); y = xf *
    scale + (beta - mean * scale) in x's dtype.

    Backward, the gradient of the sum of every rank's loss (DDP then
    averages the parameters' gradients), with x_hat = (x - mean) /
    sqrt(var + eps) and S a sum over the positions of the whole group (one
    group sum of both):
      dx = scale * (g - S(g) / n - x_hat * S(g * x_hat) / n),
      dgamma = sum(g * x_hat), dbeta = sum(g) over this rank's positions.
    mean and var carry no gradient (they feed the running statistics)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        xf = x.float()
        dims = [d for d in range(x.dim()) if d != 1]
        count = xf.new_full((1,), xf.numel() // xf.shape[1])
        sums = sum_over_group(torch.cat([xf.sum(dims), count]))
        n = sums[-1]
        mean = sums[:-1] / n
        dev = xf - _channel_view(mean, x.dim())
        var = sum_over_group((dev * dev).sum(dims)) / n
        sigma = torch.sqrt(var + eps)
        scale = gamma / sigma
        out = (xf * _channel_view(scale, x.dim())
               + _channel_view(beta - mean * scale, x.dim()))
        ctx.save_for_backward(x, mean, sigma, scale, n)
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, g, _mean, _var):
        x, mean, sigma, scale, n = ctx.saved_tensors
        nd = x.dim()
        dims = [d for d in range(nd) if d != 1]
        gf = g.float()
        x_hat = (x.float() - _channel_view(mean, nd)) / _channel_view(sigma,
                                                                       nd)
        c = mean.numel()
        local = torch.cat([gf.sum(dims), (gf * x_hat).sum(dims)])
        total = sum_over_group(local) / n
        dx = (gf - _channel_view(total[:c], nd)
              - x_hat * _channel_view(total[c:], nd)) * _channel_view(scale,
                                                                      nd)
        return dx.to(x.dtype), local[c:], local[:c], None


class GroupNorm(nn.Module):
    """Flax's nn.GroupNorm (num_groups, epsilon): statistics per (image,
    group) in fp32, var = max(E[x^2] - E[x]^2, 0) (Flax's fast variance), y =
    (x - mean) * rsqrt(var + eps) * scale + bias. Like Flax with fp32
    parameters and no dtype, the output is fp32 whatever the input's
    dtype."""

    def __init__(self, channels, num_groups=32, eps=1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.num_groups = num_groups
        self.eps = eps

    def forward(self, x):
        b, c = x.shape[:2]
        xf = x.float()
        g = xf.reshape(b, self.num_groups, -1)
        mean = g.mean(-1)
        var = torch.clamp((g * g).mean(-1) - mean * mean, min=0.0)
        per_channel = (b, c) + (1,) * (x.dim() - 2)
        mean = mean.repeat_interleave(c // self.num_groups, 1).view(
            per_channel)
        var = var.repeat_interleave(c // self.num_groups, 1).view(
            per_channel)
        mul = torch.rsqrt(var + self.eps) * _channel_view(self.scale,
                                                          x.dim())
        return (xf - mean) * mul + _channel_view(self.bias, x.dim())


def normalizer_factory(type="fixbn", eps=1e-5, group=32):
    """channels -> norm module for a config's normalizer type: fixbn / fix
    -> FrozenBN, syncbn / localbn -> SyncBN, gn -> GroupNorm(group), dummy
    -> identity (`simpledet_tpu/models/norm.py::normalizer_factory`)."""
    if type not in ("fixbn", "fix", "syncbn", "localbn", "gn", "dummy"):
        raise NotImplementedError(f"normalizer {type}")

    def make(channels):
        if type in ("fixbn", "fix"):
            return FrozenBN(channels)
        if type in ("syncbn", "localbn"):
            return SyncBN(channels, eps=eps)
        if type == "gn":
            return GroupNorm(channels, group, eps)
        return nn.Identity()
    make.type = type
    return make


def batch_stat_names(model):
    """State-dict names of every SyncBN's running statistics in model: the
    JAX package's `batch_stats` collection, kept apart from its params."""
    return [f"{name}.{leaf}" if name else leaf
            for name, m in model.named_modules() if isinstance(m, SyncBN)
            for leaf in ("mean", "var")]


def set_has_stats(model, value=True):
    for m in model.modules():
        if isinstance(m, SyncBN):
            m.has_stats = value


@torch.no_grad()
def fold_batch_stats(model, *inputs, eps=1e-5, **kwargs):
    """Give every FrozenBN of `model` the scale and bias that folding a
    BatchNorm with gamma 1, beta 0 and the statistics of this batch would
    give: per channel, scale = 1 / sqrt(var + eps), bias = -mean * scale,
    taken layer by layer in forward order on `model(*inputs, **kwargs)`
    (a layer called more than once keeps its last call's).

    A stand-in for a pretrained checkpoint's folded statistics: with seeded
    random convs and identity FrozenBN, activations grow to the scale of the
    normalised pixels (std ~74 for the flagship's std-1 normalisation) and a
    few SGD steps diverge. A model without FrozenBN is left as it is."""
    def fold(mod, args, out):
        x = args[0].float()
        dims = [d for d in range(x.dim()) if d != 1]
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        mod.scale.copy_(torch.rsqrt(var + eps))
        mod.bias.copy_(-mean * mod.scale)
        return FrozenBN.forward(mod, args[0])   # the output, refolded

    hooks = [m.register_forward_hook(fold) for m in model.modules()
             if isinstance(m, FrozenBN)]
    if not hooks:
        return
    try:
        model(*inputs, **kwargs)
    finally:
        for h in hooks:
            h.remove()
