"""The NAS-FPN and top-down / bottom-up necks of RetinaNet (counterpart of
simpledet_tpu/models/nasfpn.py).

Resampling between pyramid levels is the JAX package's own, not
`F.interpolate`'s: `upsample_to` repeats by the ceiling of the size ratio
and `pool_to` max-pools (VALID) by its floor, each then cropped to the
reference's size and edge-padded where it came out short (`_fit_hw`);
`safe_pool` clamps its window to the map. `merge_gp` gates one map by the
sigmoid of the other's global max and adds that other map.

- `NASFPNNeck`: C3-C5 and two max-pools of C5 (C6, C7) reduced by the
  `S0_P*` convs, then `num_stage` merge cells of the searched wiring, each
  node a `ReluConvBN` (relu, 3 x 3 conv with bias, the norm when given);
  Flax names `S{s}_{node}/conv`, `S{s}_{node}/bn`.
- `TopDownBottomUpFPNNeck`: 1 x 1 laterals `P*_lateral`, then `num_stage`
  rounds of a top-down path (`td_P*`) and a bottom-up one (`bu_P*`), the
  rounds after the first suffixed `_s{k}`.
Both return {"stride8": P3, ..., "stride128": P7}; convs are Flax's
`nn.Conv` with SAME padding (symmetric at stride 1), kernels
variance_scaling(1, fan_avg, uniform), biases 0. The JAX DSL gives them a
norm only for a syncbn, localbn or gn normalizer (`dsl.py::_NeckWrapper`):
the fixbn configs run them without one.
"""
import math

import torch
from torch import nn
from torch.nn import functional as F

from simpledet_torch.models.layers import SameConv2d

LEVELS = ("P3", "P4", "P5", "P6", "P7")


def _fit_hw(y, ref):
    """Crop y to ref's spatial size, then edge-pad it where it is short."""
    h, w = ref.shape[2:]
    y = y[:, :, :h, :w]
    dy, dx = h - y.shape[2], w - y.shape[3]
    if dy > 0 or dx > 0:
        y = F.pad(y, (0, max(dx, 0), 0, max(dy, 0)), mode="replicate")
    return y


def repeat_hw(x, ry, rx):
    """Each value of x [B, C, H, W] repeated ry x rx times (a nearest
    upsample by integer factors)."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, ry, w, rx).reshape(
        b, c, h * ry, w * rx)


def upsample_to(x, ref):
    """Nearest upsample by the ceiling of the size ratio, fitted to ref."""
    ry = max(-(-ref.shape[2] // max(x.shape[2], 1)), 1)
    rx = max(-(-ref.shape[3] // max(x.shape[3], 1)), 1)
    return _fit_hw(repeat_hw(x, ry, rx), ref)


def pool_to(x, ref):
    """Max-pool (VALID) by the floor of the size ratio, fitted to ref."""
    ry = max(x.shape[2] // max(ref.shape[2], 1), 1)
    rx = max(x.shape[3] // max(ref.shape[3], 1), 1)
    return _fit_hw(F.max_pool2d(x, (ry, rx), (ry, rx)), ref)


def safe_pool(x, k):
    """Max-pool (VALID) by k, the window clamped to the map."""
    ky, kx = min(k, x.shape[2]), min(k, x.shape[3])
    return F.max_pool2d(x, (ky, kx), (ky, kx))


def merge_gp(f1, f2):
    """f1 + f2 * sigmoid(the global max of f1), per image and channel."""
    return f1 + f2 * torch.sigmoid(f1.amax((2, 3), keepdim=True))


def xavier_avg_uniform_(weight, gen):
    """variance_scaling(1, fan_avg, uniform) of an OIHW kernel."""
    rf = math.prod(weight.shape[2:])
    fan_avg = (weight.shape[0] + weight.shape[1]) * rf / 2.0
    lim = math.sqrt(3.0 / fan_avg)
    return weight.uniform_(-lim, lim, generator=gen)


def _conv(cin, cout, k):
    """Flax's SAME at stride 1: k // 2 on each side for an odd k."""
    if k % 2:
        return nn.Conv2d(cin, cout, k, padding=k // 2)
    return SameConv2d(cin, cout, k)


class ReluConvBN(nn.Module):
    def __init__(self, filters, norm=None):
        super().__init__()
        self.conv = _conv(filters, filters, 3)
        self.bn = norm(filters) if norm is not None else None

    def forward(self, x):
        y = self.conv(F.relu(x))
        return self.bn(y) if self.bn is not None else y


class _Neck(nn.Module):
    @torch.no_grad()
    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                xavier_avg_uniform_(m.weight, gen)
                m.bias.zero_()

    @staticmethod
    def _inputs(feats):
        c5 = feats["c5"]
        return (feats["c3"], feats["c4"], c5, safe_pool(c5, 2),
                safe_pool(c5, 4))

    @staticmethod
    def _outputs(p):
        return {f"stride{2 ** (i + 3)}": p[name]
                for i, name in enumerate(LEVELS)}


# each merge cell's nodes, in the order they are computed
NAS_NODES = ("P4_1", "P4_2", "P3_3", "P4_4", "P5_5", "P7_6", "P6_7")


class NASFPNNeck(_Neck):
    """c3-c5 -> {stride8, ..., stride128} after num_stage merge cells."""

    def __init__(self, in_channels, filters=256, num_stage=7, s0_kernel=1,
                 norm=None):
        super().__init__()
        self.num_stage = num_stage
        for name, cin in zip(LEVELS, tuple(in_channels) + (in_channels[-1],)
                             * 2):
            self.add_module(f"S0_{name}", _conv(cin, filters, s0_kernel))
        for s in range(1, num_stage + 1):
            for node in NAS_NODES:
                self.add_module(f"S{s}_{node}", ReluConvBN(filters, norm))

    def forward(self, feats):
        p = {name: getattr(self, f"S0_{name}")(c)
             for name, c in zip(LEVELS, self._inputs(feats))}
        for s in range(1, self.num_stage + 1):
            def rcb(node, x):
                return getattr(self, f"S{s}_{node}")(x)
            P3_0, P4_0, P5_0, P6_0, P7_0 = (p[k] for k in LEVELS)
            P4_1 = rcb("P4_1", merge_gp(upsample_to(P6_0, P4_0), P4_0))
            P4_2 = rcb("P4_2", P4_0 + P4_1)
            P3_3 = rcb("P3_3", upsample_to(P4_2, P3_0) + P3_0)
            P4_4 = rcb("P4_4", P4_2 + pool_to(P3_3, P4_2))
            gp54 = merge_gp(pool_to(P4_4, P5_0), pool_to(P3_3, P5_0))
            P5_5 = rcb("P5_5", gp54 + P5_0)
            gp75 = merge_gp(pool_to(P5_5, P7_0), pool_to(P4_2, P7_0))
            P7_6 = rcb("P7_6", gp75 + P7_0)
            P6_7 = rcb("P6_7", merge_gp(upsample_to(P7_6, P6_0),
                                        pool_to(P5_5, P6_0)))
            p = {"P3": P3_3, "P4": P4_4, "P5": P5_5, "P6": P6_7, "P7": P7_6}
        return self._outputs(p)


class TopDownBottomUpFPNNeck(_Neck):
    """PANet-style: the FPN top-down path then a bottom-up one, num_stage
    times."""

    def __init__(self, in_channels, filters=256, num_stage=1, norm=None):
        super().__init__()
        self.num_stage = num_stage
        for name, cin in zip(LEVELS, tuple(in_channels) + (in_channels[-1],)
                             * 2):
            self.add_module(f"{name}_lateral", _conv(cin, filters, 1))
        for stage in range(num_stage):
            sfx = "" if stage == 0 else f"_s{stage + 1}"
            for name in LEVELS[:-1]:
                self.add_module(f"td_{name}{sfx}", ReluConvBN(filters, norm))
            for name in LEVELS[1:]:
                self.add_module(f"bu_{name}{sfx}", ReluConvBN(filters, norm))

    def forward(self, feats):
        cur = {name: getattr(self, f"{name}_lateral")(c)
               for name, c in zip(LEVELS, self._inputs(feats))}
        for stage in range(self.num_stage):
            sfx = "" if stage == 0 else f"_s{stage + 1}"
            td = {"P7": cur["P7"]}
            for hi, lo in zip(LEVELS[:0:-1], LEVELS[-2::-1]):
                td[lo] = getattr(self, f"td_{lo}{sfx}")(
                    cur[lo] + upsample_to(td[hi], cur[lo]))
            bu = {"P3": td["P3"]}
            for lo, hi in zip(LEVELS[:-1], LEVELS[1:]):
                bu[hi] = getattr(self, f"bu_{hi}{sfx}")(
                    td[hi] + pool_to(bu[lo], td[hi]))
            cur = bu
        return self._outputs(cur)
