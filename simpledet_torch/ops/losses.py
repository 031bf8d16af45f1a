"""Detection loss primitives (counterpart of simpledet_tpu/ops/losses.py)."""
import torch


def smooth_l1(diff, sigma=1.0):
    """Elementwise smooth-L1 with transition point 1 / sigma^2 (the
    py-faster-rcnn convention)."""
    sigma2 = sigma * sigma
    ad = diff.abs()
    return torch.where(ad < 1.0 / sigma2, 0.5 * sigma2 * diff * diff,
                       ad - 0.5 / sigma2)


def sigmoid_cross_entropy(logits, label, ignore_label=-1):
    """Binary cross-entropy of logits against labels in {0, 1}, summed over
    the entries whose label is not ignore_label and divided by their count
    (at least 1): the mask loss
    (`simpledet_tpu/ops/losses.py::sigmoid_cross_entropy`)."""
    valid = label != ignore_label
    ce = -(label * torch.nn.functional.logsigmoid(logits)
           + (1.0 - label) * torch.nn.functional.logsigmoid(-logits))
    n = valid.sum().clamp(min=1)
    return torch.where(valid, ce, torch.zeros_like(ce)).sum() / n
