"""Deformable convolution modules and the DCN bottlenecks (counterpart of
simpledet_tpu/models/dcn.py).

- `DeformConv`: an offset conv (`offset_conv`, zero init, fp32, Flax's SAME
  padding: at stride 2 on an even side it pads (0, 1), `SameConv2d`) predicts
  2 * G * K * K offsets (and, modulated, G * K * K mask logits, through a
  sigmoid); the deformable conv itself (`ops/deform_conv.py`) pads
  symmetrically, (1, 1) for a 3 x 3, on the offset map's grid. Its kernel
  `weight` (the Flax leaf `kernel`, HWIO there, OIHW here) starts at
  variance_scaling(2, fan_out, truncated_normal), its optional `bias` at 0.
  At the zero init the offsets are 0 and the mask 0.5: a v1 layer starts as
  a plain conv.
- `DCNBottleneck` (`dcn_resnet_unit`): 1 x 1 -> deformable 3 x 3 (4 groups,
  the unit's stride on it) -> 1 x 1, the 1 x 1 projection shortcut at the
  stride; leaves `conv1` / `bn1`, `conv2` (`offset_conv`, `kernel`), `bn2`,
  `conv3` / `bn3`, `sc_conv` / `sc_bn`. `DCNv2Bottleneck` is the modulated
  form. The ResNet takes them as its `special_block` for the last units of
  a stage (`models/resnet.py`).
- `C4StrideKeyAdapter`: a C4 ResNet (stages 1-3) whose c4 the single-level
  C4 detector reads as `stride16`; the Flax tree holds the ResNet under
  `backbone/inner`, and so does this module.
Each deformable conv's forward runs inside the profiler range
`deform_conv`, each DCN unit's inside `dcn_unit` (`PROFILER_RANGES`), so a
trace gives their device time.
"""
import torch
from torch import nn
from torch.nn import functional as F
from torch.profiler import record_function

from simpledet_torch.models.init import msra_out_normal_
from simpledet_torch.models.layers import SameConv2d
from simpledet_torch.models.resnet import conv
from simpledet_torch.ops.deform_conv import deform_conv2d

PROFILER_RANGES = ("deform_conv", "dcn_unit")


class DeformConv(nn.Module):
    """x [B, C, H, W] -> [B, F, H', W'] in fp32."""

    def __init__(self, cin, filters, kernel=3, stride=1, dilation=1,
                 num_deformable_group=4, modulated=False, use_bias=False):
        super().__init__()
        kk = kernel * kernel
        self.num_group = num_deformable_group
        self.num_offset = 2 * num_deformable_group * kk
        self.modulated = modulated
        self.stride, self.dilation = stride, dilation
        n_out = self.num_offset + (num_deformable_group * kk if modulated
                                   else 0)
        self.offset_conv = SameConv2d(cin, n_out, kernel, stride=stride,
                                      dilation=dilation)
        self.weight = nn.Parameter(torch.empty(filters, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(filters)) if use_bias else None

    def offsets(self, x):
        """(offset, mask or None) predicted from x."""
        off = self.offset_conv(x.float())
        if not self.modulated:
            return off, None
        return (off[:, :self.num_offset],
                torch.sigmoid(off[:, self.num_offset:]))

    def forward(self, x):
        with record_function("deform_conv"):
            offset, mask = self.offsets(x)
            return deform_conv2d(x.float(), offset, self.weight,
                                 stride=self.stride, dilation=self.dilation,
                                 num_deformable_group=self.num_group,
                                 mask=mask, bias=self.bias)

    @torch.no_grad()
    def init_weights(self, gen):
        f, _, kh, kw = self.weight.shape
        msra_out_normal_(self.weight, gen, f * kh * kw)
        if self.bias is not None:
            self.bias.zero_()
        self.offset_conv.weight.zero_()
        self.offset_conv.bias.zero_()


class DCNBottleneck(nn.Module):
    """The bottleneck with a deformable 3 x 3 (`Bottleneck`'s signature, so
    the ResNet builds it as a special block)."""

    modulated = False

    def __init__(self, cin, filters, stride, dtype, norm, dilation=1):
        super().__init__()
        self.conv1 = conv(cin, filters, 1, dtype=dtype)
        self.bn1 = norm(filters)
        self.conv2 = DeformConv(filters, filters, 3, stride, dilation,
                                num_deformable_group=4,
                                modulated=self.modulated)
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, filters * 4, 1, dtype=dtype)
        self.bn3 = norm(filters * 4)
        self.dtype = dtype
        self.has_sc = cin != filters * 4 or stride != 1
        if self.has_sc:
            self.sc_conv = conv(cin, filters * 4, 1, stride, dtype=dtype)
            self.sc_bn = norm(filters * 4)

    def forward(self, x):
        with record_function("dcn_unit"):
            y = F.relu(self.bn1(self.conv1(x)))
            y = F.relu(self.bn2(self.conv2(y).to(self.dtype)))
            y = self.bn3(self.conv3(y))
            residual = self.sc_bn(self.sc_conv(x)) if self.has_sc else x
            return F.relu(y + residual)


class DCNv2Bottleneck(DCNBottleneck):
    """The modulated deformable bottleneck (DCNv2)."""

    modulated = True


class C4StrideKeyAdapter(nn.Module):
    """{"c2", "c3", "c4", "stride16"} from a C4 ResNet `inner`; its 1024
    channels are `out_channels`."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.out_channels = inner.out_channels[-1]
        self.dtype = inner.dtype

    def forward(self, x):
        feats = dict(self.inner(x))
        feats["stride16"] = feats["c4"]
        return feats

    def init_weights(self, gen):
        self.inner.init_weights(gen)
