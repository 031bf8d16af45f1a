"""ResNet v1, v1b and v1d backbones (counterpart of
simpledet_tpu/models/resnet.py, those variants).

- v1 (MSRA): the stride sits on the FIRST 1x1 conv of a bottleneck; the stem
  is a 7x7/2 conv with pad 3, a norm, relu, then a 3x3/2 max-pool with pad 1.
  Flax's SAME padding on the 1x1/2 convs is no padding.
- v1b: the stride sits on the 3x3 conv, which pads (1, 1) explicitly (not
  SAME, which would pad (0, 1) at stride 2 on an even side); v1's stem.
- v1d: v1b's units, but a strided shortcut is a 2x2/2 average pool (VALID:
  it floors an odd side, where the 3x3/2 main branch ceils, so the residual
  add fails there as in the JAX package) and then the 1x1 `sc_conv` at
  stride 1; the stem is three 3x3 convs `conv0_0`, `conv0_1`, `conv0_2`
  (32, 32, 64 wide, the first at stride 2) with Flax's SAME padding ((0, 1)
  at stride 2 on an even side: `SameConv2d`), each with its norm `bn0_i`
  and relu, then v1's max-pool.
- v2 (`BottleneckV2`, pre-activation): norm and relu before the convs, the
  projection shortcut on the pre-activated input, nothing after the add;
  the stride on the 3x3 conv, padded (1, 1). The TridentNet backbones and
  the C5 box head use it (`models/tridentnet.py`).
- Special blocks (the DCN hybrids, `models/dcn.py`): the last
  `num_special[s]` units of stage s + 1 are `special_block`s, built with
  `Bottleneck`'s arguments but no variant (`simpledet_tpu/models/resnet.py:
  203-213`); `num_stages` 3 stops at c4 (the C4 backbones).
Module names follow the Flax tree (`stage1_unit1.conv1`, `conv0_1`, ...), so
`weights.from_flax` maps names one to one.

`norm` makes each norm layer from its channel count
(`models/norm.py::normalizer_factory`, FrozenBN by default), as the JAX
package's backbone takes the config's normalizer. `dtype` is the compute
dtype of every conv (`models/layers.py`): the input is cast to it first, and
FrozenBN, relu, the max-pool and the residual adds run in it, as in the JAX
package; SyncBN computes in fp32 and returns the input's dtype.
"""
import torch
from torch import nn
from torch.nn import functional as F

from simpledet_torch.models.init import lecun_normal_
from simpledet_torch.models.layers import SameConv2d, conv2d
from simpledet_torch.models.norm import normalizer_factory

# depth -> per-stage unit counts
RESNET_UNITS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


def conv(cin, cout, k, stride=1, pad=0, dtype=torch.float32):
    return conv2d(cin, cout, k, stride=stride, padding=pad, bias=False,
                  compute_dtype=dtype)


VARIANTS = ("v1", "v1b", "v1d")


class Bottleneck(nn.Module):
    def __init__(self, cin, filters, stride, dtype, norm, variant="v1"):
        super().__init__()
        s1, s3 = (stride, 1) if variant == "v1" else (1, stride)
        self.conv1 = conv(cin, filters, 1, s1, dtype=dtype)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, 3, s3, 1, dtype=dtype)
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, filters * 4, 1, dtype=dtype)
        self.bn3 = norm(filters * 4)
        self.has_sc = cin != filters * 4 or stride != 1
        self.avg_down = variant == "v1d" and stride != 1
        if self.has_sc:
            self.sc_conv = conv(cin, filters * 4, 1,
                                1 if self.avg_down else stride, dtype=dtype)
            self.sc_bn = norm(filters * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.has_sc:
            if self.avg_down:
                residual = F.avg_pool2d(residual, 2, 2)
            residual = self.sc_bn(self.sc_conv(residual))
        return F.relu(y + residual)


class BottleneckV2(nn.Module):
    """The pre-activation unit (`simpledet_tpu/models/resnet.py::
    BottleneckV2`)."""

    def __init__(self, cin, filters, stride, dtype, norm):
        super().__init__()
        self.bn0 = norm(cin)
        self.conv1 = conv(cin, filters, 1, dtype=dtype)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, 3, stride, 1, dtype=dtype)
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, filters * 4, 1, dtype=dtype)
        self.has_sc = cin != filters * 4 or stride != 1
        if self.has_sc:
            self.sc_conv = conv(cin, filters * 4, 1, stride, dtype=dtype)

    def forward(self, x):
        pre = F.relu(self.bn0(x))
        residual = self.sc_conv(pre) if self.has_sc else x
        y = F.relu(self.bn1(self.conv1(pre)))
        y = F.relu(self.bn2(self.conv2(y)))
        return self.conv3(y) + residual


class ResNet(nn.Module):
    """NCHW in, {"c2": ..., "c5": ...} stage features out."""

    def __init__(self, depth=50, dtype=torch.float32, norm=None,
                 variant="v1", num_stages=4, num_special=(0, 0, 0, 0),
                 special_block=None):
        super().__init__()
        if variant not in VARIANTS:
            raise NotImplementedError(f"ResNet variant {variant!r} is not "
                                      "ported yet")
        norm = norm or normalizer_factory("fixbn")
        self.dtype = dtype
        self.variant = variant
        if variant == "v1d":
            self.stem = ("conv0_0", "conv0_1", "conv0_2")
            self.conv0_0 = SameConv2d(3, 32, 3, stride=2, bias=False,
                                      compute_dtype=dtype)
            self.conv0_1 = conv(32, 32, 3, 1, 1, dtype=dtype)
            self.conv0_2 = conv(32, 64, 3, 1, 1, dtype=dtype)
            for i, f in enumerate((32, 32, 64)):
                self.add_module(f"bn0_{i}", norm(f))
        else:
            self.stem = ("conv0",)
            self.conv0 = conv(3, 64, 7, 2, 3, dtype=dtype)
            self.bn0 = norm(64)
        self.units = []
        cin = 64
        for stage, (n_unit, filters) in enumerate(
                zip(RESNET_UNITS[depth][:num_stages], (64, 128, 256, 512))):
            names = []
            n_special = num_special[stage] if special_block else 0
            for unit in range(n_unit):
                name = f"stage{stage + 1}_unit{unit + 1}"
                stride = 2 if stage > 0 and unit == 0 else 1
                self.add_module(name, special_block(
                    cin, filters, stride, dtype, norm)
                    if unit >= n_unit - n_special else
                    Bottleneck(cin, filters, stride, dtype, norm, variant))
                cin = filters * 4
                names.append(name)
            self.units.append(names)
        self.out_channels = (256, 512, 1024, 2048)[:num_stages]

    def forward(self, x):
        for name in self.stem:                  # conv0 computes in dtype
            x = F.relu(getattr(self, name.replace("conv", "bn"))(
                getattr(self, name)(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = {}
        for stage, names in enumerate(self.units):
            for name in names:
                x = getattr(self, name)(x)
            feats[f"c{stage + 2}"] = x
        return feats

    def init_weights(self, gen):
        """Flax's inits: lecun_normal for each nn.Conv kernel; a special
        block's own layers (a deformable conv's kernel and its zero offset
        conv) as that layer initialises them."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, gen)
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(gen)
