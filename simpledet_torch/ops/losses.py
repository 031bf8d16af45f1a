"""Detection loss primitives (counterpart of simpledet_tpu/ops/losses.py)."""
import torch


def smooth_l1(diff, sigma=1.0):
    """Elementwise smooth-L1 with transition point 1 / sigma^2 (the
    py-faster-rcnn convention)."""
    sigma2 = sigma * sigma
    ad = diff.abs()
    return torch.where(ad < 1.0 / sigma2, 0.5 * sigma2 * diff * diff,
                       ad - 0.5 / sigma2)
