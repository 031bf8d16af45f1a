"""ResNet v1 backbone (counterpart of simpledet_tpu/models/resnet.py, v1).

MSRA v1 conventions: the stride sits on the FIRST 1x1 conv of a bottleneck;
the stem is a 7x7/2 conv with pad 3, a norm, relu, then a 3x3/2 max-pool
with pad 1. Flax's SAME padding on the 1x1/2 convs is no padding. Module names
follow the Flax tree (`stage1_unit1.conv1`, ...), so `weights.from_flax`
maps names one to one.

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
from simpledet_torch.models.layers import conv2d
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


class Bottleneck(nn.Module):
    def __init__(self, cin, filters, stride, dtype, norm):
        super().__init__()
        self.conv1 = conv(cin, filters, 1, stride, dtype=dtype)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, 3, 1, 1, dtype=dtype)
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, filters * 4, 1, dtype=dtype)
        self.bn3 = norm(filters * 4)
        self.has_sc = cin != filters * 4 or stride != 1
        if self.has_sc:
            self.sc_conv = conv(cin, filters * 4, 1, stride, dtype=dtype)
            self.sc_bn = norm(filters * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.sc_bn(self.sc_conv(x)) if self.has_sc else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """NCHW in, {"c2": ..., "c5": ...} stage features out."""

    def __init__(self, depth=50, dtype=torch.float32, norm=None):
        super().__init__()
        norm = norm or normalizer_factory("fixbn")
        self.dtype = dtype
        self.conv0 = conv(3, 64, 7, 2, 3, dtype=dtype)
        self.bn0 = norm(64)
        self.units = []
        cin = 64
        for stage, (n_unit, filters) in enumerate(
                zip(RESNET_UNITS[depth], (64, 128, 256, 512))):
            names = []
            for unit in range(n_unit):
                name = f"stage{stage + 1}_unit{unit + 1}"
                stride = 2 if stage > 0 and unit == 0 else 1
                self.add_module(name, Bottleneck(cin, filters, stride, dtype,
                                                 norm))
                cin = filters * 4
                names.append(name)
            self.units.append(names)
        self.out_channels = (256, 512, 1024, 2048)

    def forward(self, x):
        x = F.relu(self.bn0(self.conv0(x)))     # conv0 computes in dtype
        x = F.max_pool2d(x, 3, 2, 1)
        feats = {}
        for stage, names in enumerate(self.units):
            for name in names:
                x = getattr(self, name)(x)
            feats[f"c{stage + 2}"] = x
        return feats

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, gen)
