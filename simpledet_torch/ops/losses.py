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


def sigmoid_focal_loss(logits, label, *, alpha=0.25, gamma=2.0):
    """Per-anchor sigmoid focal loss summed over the foreground classes
    (`simpledet_tpu/ops/losses.py::sigmoid_focal_loss`).

    logits [..., N, C-1] (no background column); label [..., N], integer
    valued: 0 background, k in 1..C-1 class k, -1 ignore. Returns [..., N];
    an ignored anchor's loss is 0. The target class takes
    -alpha (1-p)^gamma log(p), every other class -(1-alpha) p^gamma
    log(1-p), both through the stable log-sigmoid forms. The one-hot comes
    from a comparison: `F.one_hot` raises on the -2 of an ignored anchor's
    label - 1."""
    lbl = label.long()
    classes = torch.arange(1, logits.shape[-1] + 1, device=logits.device)
    target = lbl[..., None] == classes
    p = torch.sigmoid(logits)
    log_p = torch.nn.functional.logsigmoid(logits)
    log_1p = torch.nn.functional.logsigmoid(-logits)
    pos = -alpha * torch.pow(1.0 - p, gamma) * log_p
    neg = -(1.0 - alpha) * torch.pow(p, gamma) * log_1p
    loss = torch.where(target, pos, neg).sum(-1)
    return torch.where(label >= 0, loss, torch.zeros_like(loss))
