"""Parameter freezing and the optimizer (counterpart of
simpledet_tpu/core/optimizer.py).

Freezing goes by substring of the Flax path of each parameter
(`weights.flax_path`), as the JAX package (and the reference's DetModule)
match the '/'-joined param path: any name that contains an entry of
fixed_param is frozen.
The flagship's ["conv0", "stage1", "scale", "bias"] so freezes every bias of
the model, the FPN's, the RPN's and the box head's included, as it does in
the JAX package. FrozenBN's scale and bias are buffers here, never trained.
"""
import torch

from simpledet_torch.weights import flax_path


def freeze_mask(model, fixed_param):
    """{torch name: trainable} for every parameter and buffer of model."""
    return {name: not any(f in flax_path(name) for f in fixed_param or ())
            for name in model.state_dict()}


def make_optimizer(model, trainable_mask, *, lr, opt_type="sgd",
                   momentum=0.9, wd=1e-4):
    """SGD with momentum over the trainable parameters; frozen ones get
    requires_grad=False, so they are never decayed and never move.

    torch.optim.SGD(momentum, weight_decay=wd, dampening=0) adds wd * w to
    the gradient before the momentum (buf = momentum * buf + g + wd * w;
    w -= lr * buf, the first buf being g + wd * w): exactly optax's
    add_decayed_weights followed by sgd(momentum), as the JAX package chains
    them. The caller sets the lr of each step (`set_lr`)."""
    if opt_type in ("adam", "adamw"):
        raise NotImplementedError(f"optimizer.type {opt_type!r} is not "
                                  "ported yet")
    if opt_type != "sgd":
        raise ValueError(f"unsupported optimizer.type {opt_type!r}; "
                         "supported: sgd, adam, adamw")
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(bool(trainable_mask[name]))
        if p.requires_grad:
            params.append(p)
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=wd or 0.0, dampening=0)


def set_lr(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = lr
