"""FPN RoI-to-level assignment (counterpart of simpledet_tpu/targets/fpn_assign.py).

    level = floor(canonical_level + log2(sqrt(w*h) / canonical_scale))

clamped to [min_level, max_level], with legacy +1 widths.
"""
import torch


def fpn_roi_level(rois, *, canonical_scale=224, canonical_level=4,
                  min_level=2, max_level=5):
    """rois: [..., N, 4] -> int32 level [..., N] in [min_level, max_level]."""
    w = rois[..., 2] - rois[..., 0] + 1.0
    h = rois[..., 3] - rois[..., 1] + 1.0
    scale = torch.sqrt((w * h).clamp(min=1e-6))
    # a tensor divisor: PyTorch's CUDA division by a Python number multiplies
    # by its reciprocal, which rounds unlike true division (the CPU's, XLA's
    # and the RoIAlign kernel's) and can move a roi across a level boundary
    div = torch.tensor(float(canonical_scale), dtype=scale.dtype,
                       device=scale.device)
    lvl = torch.floor(canonical_level + torch.log2(scale / div + 1e-12))
    return lvl.clamp(min_level, max_level).to(torch.int32)
