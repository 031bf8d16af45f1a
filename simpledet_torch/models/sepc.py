"""SEPC, scale-equalizing pyramid convolution, on RetinaNet (counterpart of
simpledet_tpu/models/sepc.py).

- `IntegratedBN` (iBN): one batch norm whose statistics pool every level of
  the batch it is given, in serving as in training; it keeps no running
  statistics. Under DDP they are summed over the process group, as the JAX
  package's global batch spans the mesh: the levels are flattened into one
  [positions, C] tensor and normalised by `models/norm.py`'s `_BatchNorm`,
  one autograd node with SyncBN's group sums. Parameters `gamma`, `beta`.
- `SEPCConvShared`: one weight set a role, shared by every level it is
  applied to: a plain 3 x 3 `conv` (Flax SAME padding, normal(0.01) kernel,
  bias 0) below `start_level` or without `part_deform`, a deformable `dconv`
  (one group, with bias, `models/dcn.py`) from `start_level` on. Like the
  Flax module, it holds only the layers its levels use.
- `PConvModule`: out[l] = sepc1(x[l]) + sepc2(x[l - 1]) (stride 2, cropped)
  + up2(sepc0(x[l + 1])) (a 2x repeat, cropped), then iBN and relu.
- `SEPCFPN`: `pconv_num` PConv modules, then the shared `CConv` / `LConv`
  with their iBNs, each level's output the channel concatenation
  [relu(cls), relu(loc)].
- `SEPCNeck`: the RetinaNet neck with its norm (`fpn`, `RetinaNetNeckWithBN`)
  then SEPCFPN (`sepc`): the JAX DSL's `RetinaNetNeckWithBNWithSEPC`.
- `SEPCSubnets`: the predictors with no towers, cls on the first half of
  each level's channels, bbox on the second (`RetinaNetHeadWithBNWithSEPC`).
"""
import math

import torch
from torch import nn
from torch.nn import functional as F
from torch.profiler import record_function

from simpledet_torch.models.dcn import DeformConv
from simpledet_torch.models.init import normal_
from simpledet_torch.models.layers import SameConv2d
from simpledet_torch.models.nasfpn import repeat_hw
from simpledet_torch.models.norm import _BatchNorm
from simpledet_torch.models.retinanet import PRIOR_PROB
from simpledet_torch.models.rpn import level_keys

NUM_LEVELS = 5          # P3-P7
PROFILER_RANGES = ("sepc",)


def _nhwc_rows(x):
    """[B, C, H, W] -> [B * H * W, C] (a view of a channels_last tensor)."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


class IntegratedBN(nn.Module):
    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, fms):
        flat = torch.cat([_nhwc_rows(f).float() for f in fms])
        out, _, _ = _BatchNorm.apply(flat, self.gamma, self.beta, self.eps)
        parts = out.split([f.numel() // f.shape[1] for f in fms])
        return [p.reshape(f.shape[0], f.shape[2], f.shape[3], -1)
                .permute(0, 3, 1, 2).to(f.dtype) for p, f in zip(parts, fms)]


class SEPCConvShared(nn.Module):
    """One role's weights, applied at `levels` (the level indices it is
    called for)."""

    def __init__(self, filters, stride=1, part_deform=False, start_level=1,
                 levels=range(NUM_LEVELS)):
        super().__init__()
        self.part_deform, self.start_level = part_deform, start_level
        if any(not self._deform(lv) for lv in levels):
            self.conv = (nn.Conv2d(filters, filters, 3, padding=1)
                         if stride == 1 else
                         SameConv2d(filters, filters, 3, stride=stride))
        if any(self._deform(lv) for lv in levels):
            self.dconv = DeformConv(filters, filters, 3, stride,
                                    num_deformable_group=1, use_bias=True)

    def _deform(self, level):
        return self.part_deform and level >= self.start_level

    def forward(self, x, level):
        if self._deform(level):
            return self.dconv(x)
        return self.conv(x)

    @torch.no_grad()
    def init_weights(self, gen):
        if hasattr(self, "conv"):
            normal_(self.conv.weight, 0.01, gen)
            self.conv.bias.zero_()
        if hasattr(self, "dconv"):
            self.dconv.init_weights(gen)


class PConvModule(nn.Module):
    def __init__(self, filters=256, part_deform=False, start_level=1,
                 ibn=False):
        super().__init__()
        n = NUM_LEVELS
        kw = dict(part_deform=part_deform, start_level=start_level)
        self.sepc0 = SEPCConvShared(filters, 1, levels=range(n - 1), **kw)
        self.sepc1 = SEPCConvShared(filters, 1, levels=range(n), **kw)
        self.sepc2 = SEPCConvShared(filters, 2, levels=range(1, n), **kw)
        self.ibn = IntegratedBN(filters) if ibn else None

    def forward(self, levels):
        out = []
        for lv, feat in enumerate(levels):
            y = self.sepc1(feat, lv)
            h, w = y.shape[2:]
            if lv > 0:
                y = y + self.sepc2(levels[lv - 1], lv)[:, :, :h, :w]
            if lv < len(levels) - 1:
                u = repeat_hw(self.sepc0(levels[lv + 1], lv), 2, 2)
                y = y + u[:, :, :h, :w]
            out.append(y)
        if self.ibn is not None:
            out = self.ibn(out)
        return [F.relu(y) for y in out]


class SEPCFPN(nn.Module):
    """{stride key: level} -> {stride key: [relu(cls), relu(loc)] (2 *
    filters channels)}."""

    def __init__(self, filters=256, pconv_num=4, pconv_deform=False,
                 lcconv_deform=False, ibn=False, start_level=1):
        super().__init__()
        self.pconv_num = pconv_num
        for i in range(pconv_num):
            self.add_module(f"PConv{i}", PConvModule(
                filters, pconv_deform, start_level, ibn))
        self.CConv = SEPCConvShared(filters, 1, lcconv_deform, start_level)
        self.LConv = SEPCConvShared(filters, 1, lcconv_deform, start_level)
        self.cconv_ibn = IntegratedBN(filters) if ibn else None
        self.lconv_ibn = IntegratedBN(filters) if ibn else None

    def forward(self, pyramid):
        keys = level_keys([k for k in pyramid if k.startswith("stride")])
        levels = [pyramid[k] for k in keys]
        for i in range(self.pconv_num):
            levels = getattr(self, f"PConv{i}")(levels)
        cls_outs = [self.CConv(f, lv) for lv, f in enumerate(levels)]
        loc_outs = [self.LConv(f, lv) for lv, f in enumerate(levels)]
        if self.cconv_ibn is not None:
            cls_outs = self.cconv_ibn(cls_outs)
            loc_outs = self.lconv_ibn(loc_outs)
        return {k: torch.cat([F.relu(c), F.relu(l)], 1)
                for k, c, l in zip(keys, cls_outs, loc_outs)}

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, SEPCConvShared):
                m.init_weights(gen)


class SEPCNeck(nn.Module):
    """The BN RetinaNet neck (`fpn`) then SEPCFPN (`sepc`); the SEPC part
    runs inside the profiler range `sepc`."""

    def __init__(self, fpn, sepc):
        super().__init__()
        self.fpn = fpn
        self.sepc = sepc

    def forward(self, feats):
        pyr = self.fpn(feats)
        with record_function("sepc"):
            return self.sepc(pyr)

    def init_weights(self, gen):
        self.fpn.init_weights(gen)
        self.sepc.init_weights(gen)


class SEPCSubnets(nn.Module):
    """{stride: [B, 2 * C, H, W]} -> {stride: (cls_logit, bbox_delta)}: the
    3 x 3 predictors on each half, no towers."""

    def __init__(self, num_anchor, num_fg_class, in_channels):
        super().__init__()
        self.cls_pred = nn.Conv2d(in_channels, num_anchor * num_fg_class, 3,
                                  padding=1)
        self.bbox_pred = nn.Conv2d(in_channels, num_anchor * 4, 3, padding=1)

    def forward(self, pyramid):
        out = {}
        for key in level_keys(pyramid):
            cls, loc = pyramid[key].float().chunk(2, 1)
            out[key] = (self.cls_pred(cls), self.bbox_pred(loc))
        return out

    @torch.no_grad()
    def init_weights(self, gen):
        for m in (self.cls_pred, self.bbox_pred):
            normal_(m.weight, 0.01, gen)
            m.bias.zero_()
        self.cls_pred.bias.fill_(-math.log((1.0 - PRIOR_PROB) / PRIOR_PROB))
