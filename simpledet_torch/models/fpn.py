"""FPN neck, P2-P6 (counterpart of simpledet_tpu/models/fpn.py::FPNNeck).

1x1 laterals and 3x3 output convs with bias; the top-down path is a nearest
2x upsample cropped to the lateral's size; P6 = P5_conv[..., ::2, ::2].
Returns {"stride4": P2, ..., "stride64": P6}, NCHW, in the compute dtype
`dtype` of its convs; the top-down adds run in it too. `Neck` is the C4
detectors' identity neck (`simpledet_tpu/models/fpn.py::Neck`).
"""
import torch
from torch import nn
from torch.nn import functional as F

from simpledet_torch.models.init import fan_in_uniform_
from simpledet_torch.models.layers import conv2d


def upsample2x_to(x, hw):
    return F.interpolate(x, scale_factor=2, mode="nearest")[..., :hw[0], :hw[1]]


class FPNNeck(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), filters=256,
                 dtype=torch.float32):
        super().__init__()
        for stage, cin in zip(range(2, 6), in_channels):
            self.add_module(f"P{stage}_lateral",
                            conv2d(cin, filters, 1, compute_dtype=dtype))
            self.add_module(f"P{stage}_conv",
                            conv2d(filters, filters, 3, padding=1,
                                   compute_dtype=dtype))

    def forward(self, feats):
        lat = [getattr(self, f"P{s}_lateral")(feats[f"c{s}"])
               for s in range(2, 6)]
        merged = [None] * 4
        merged[3] = lat[3]
        for i in (2, 1, 0):
            merged[i] = upsample2x_to(merged[i + 1], lat[i].shape[2:]) + lat[i]
        out = {}
        for i in range(4):
            out[f"stride{2 ** (i + 2)}"] = getattr(self, f"P{i + 2}_conv")(
                merged[i])
        out["stride64"] = out["stride32"][..., ::2, ::2]
        return out

    @torch.no_grad()
    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in_uniform_(m.weight, gen)
                m.bias.zero_()


class Neck(nn.Module):
    """The identity neck: the backbone's features as they are."""

    def forward(self, feats):
        return feats

    def init_weights(self, gen):
        pass
