"""The PAFPN and Feature Pyramid Grids necks of Faster R-CNN (counterpart of
simpledet_tpu/models/fpg.py).

Both start from 1 x 1 laterals `S0_P*` (with bias) of C2-C5, and of two
max-pools of C5 for P6 and P7 (`safe_pool` by 2 and 4); a neck runs on five
consecutive levels, P2-P6 or P3-P7.
- `PAFPNNeck`: `num_stage` rounds of a top-down path (`S{s}_P*_td`: the
  level plus the upsampled level above) and a bottom-up one (`S{s}_P*_bu`:
  the top-down level plus the pooled level below), each node a
  `ReluConvBN` (relu, 3 x 3 conv with bias, the norm when given).
- `FPGNeck`: a grid of `num_stage` columns; each node sums up to four
  pathway convs (3 x 3 with bias, each followed by the norm when given):
  across-same (the level of the previous column), across-down (the
  previous column's level above, upsampled), across-up (the previous
  column's level below, pooled) and same-up (this column's level below,
  pooled), then a relu. Flax names `S{s}_{level}_{pathway}_conv` and
  `_bn`.
Resampling is `upsample_to` / `pool_to` of the NAS-FPN neck; kernels are
variance_scaling(1, fan_avg, uniform), biases 0. The outputs are
{"stride4": P2, ...} (or from "stride8" for P3-P7), NCHW, fp32. The JAX DSL
gives these necks a norm only for a syncbn, localbn or gn normalizer
(`simpledet_tpu/dsl.py::_NeckWrapper`).
"""
import torch
from torch import nn
from torch.nn import functional as F

from simpledet_torch.models.nasfpn import (ReluConvBN, _conv, pool_to,
                                           safe_pool, upsample_to,
                                           xavier_avg_uniform_)

LEVELS_P2P6 = ("P2", "P3", "P4", "P5", "P6")
LEVELS_P3P7 = ("P3", "P4", "P5", "P6", "P7")
STRIDE = {"P2": 4, "P3": 8, "P4": 16, "P5": 32, "P6": 64, "P7": 128}


class _NeckBase(nn.Module):
    def __init__(self, in_channels, filters, num_stage, levels):
        super().__init__()
        self.levels = levels
        self.num_stage = num_stage
        cin = dict(zip(("P2", "P3", "P4", "P5"), in_channels))
        cin["P6"] = cin["P7"] = in_channels[-1]
        for name in levels:
            self.add_module(f"S0_{name}", _conv(cin[name], filters, 1))

    def _laterals(self, feats):
        c5 = feats["c5"]
        cs = {"P2": feats.get("c2"), "P3": feats["c3"], "P4": feats["c4"],
              "P5": c5, "P6": safe_pool(c5, 2), "P7": safe_pool(c5, 4)}
        return {name: getattr(self, f"S0_{name}")(cs[name])
                for name in self.levels}

    @staticmethod
    def _strides(p):
        return {f"stride{STRIDE[k]}": v for k, v in p.items()}

    @torch.no_grad()
    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                xavier_avg_uniform_(m.weight, gen)
                m.bias.zero_()


class PAFPNNeck(_NeckBase):
    """c2-c5 -> five levels after num_stage top-down / bottom-up rounds."""

    def __init__(self, in_channels, filters=256, num_stage=2, norm=None,
                 levels=LEVELS_P2P6):
        super().__init__(in_channels, filters, num_stage, levels)
        for s in range(1, num_stage + 1):
            for name in levels[:-1]:
                self.add_module(f"S{s}_{name}_td", ReluConvBN(filters, norm))
            for name in levels[1:]:
                self.add_module(f"S{s}_{name}_bu", ReluConvBN(filters, norm))

    def forward(self, feats):
        p = self._laterals(feats)
        lv = self.levels
        for s in range(1, self.num_stage + 1):
            td = {lv[-1]: p[lv[-1]]}
            for cur, above in zip(lv[-2::-1], lv[:0:-1]):
                td[cur] = getattr(self, f"S{s}_{cur}_td")(
                    p[cur] + upsample_to(td[above], p[cur]))
            bu = {lv[0]: td[lv[0]]}
            for below, cur in zip(lv[:-1], lv[1:]):
                bu[cur] = getattr(self, f"S{s}_{cur}_bu")(
                    td[cur] + pool_to(bu[below], td[cur]))
            p = bu
        return self._strides(p)


class FPGNeck(_NeckBase):
    """c2-c5 -> five levels after a grid of num_stage columns."""

    def __init__(self, in_channels, filters=256, num_stage=5, norm=None,
                 levels=LEVELS_P2P6):
        super().__init__(in_channels, filters, num_stage, levels)
        for s in range(1, num_stage + 1):
            for i, cur in enumerate(levels):
                names = ["across_same"]
                if i + 1 < len(levels):
                    names.append("across_down")
                if i > 0:
                    names += ["across_up", "same_up"]
                for k in names:
                    self.add_module(f"S{s}_{cur}_{k}_conv",
                                    _conv(filters, filters, 3))
                    if norm is not None:
                        self.add_module(f"S{s}_{cur}_{k}_bn", norm(filters))

    def _path(self, x, s, cur, kind):
        y = getattr(self, f"S{s}_{cur}_{kind}_conv")(x)
        bn = getattr(self, f"S{s}_{cur}_{kind}_bn", None)
        return bn(y) if bn is not None else y

    def forward(self, feats):
        p = self._laterals(feats)
        lv = self.levels
        for s in range(1, self.num_stage + 1):
            new_p = {}
            for i, cur in enumerate(lv):
                total = self._path(p[cur], s, cur, "across_same")
                if i + 1 < len(lv):
                    total = total + self._path(upsample_to(p[lv[i + 1]],
                                                           p[cur]),
                                               s, cur, "across_down")
                if i > 0:
                    below = lv[i - 1]
                    total = total + self._path(pool_to(p[below], p[cur]), s,
                                               cur, "across_up")
                    total = total + self._path(pool_to(new_p[below], p[cur]),
                                               s, cur, "same_up")
                new_p[cur] = F.relu(total)
            p = new_p
        return self._strides(p)
