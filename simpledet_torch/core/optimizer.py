"""Parameter freezing and the optimizer (counterpart of
simpledet_tpu/core/optimizer.py).

Freezing goes by substring of the Flax path of each parameter
(`weights.flax_path`), as the JAX package (and the reference's DetModule)
match the '/'-joined param path: any name that contains an entry of
fixed_param is frozen, unless it also contains an entry of excluded_param.
The flagship's ["conv0", "stage1", "scale", "bias"] so freezes every bias of
the model, the FPN's, the RPN's and the box head's included, as it does in
the JAX package. FrozenBN's scale and bias are buffers here, never trained.
"""
import torch

from simpledet_torch.models.norm import batch_stat_names
from simpledet_torch.weights import flax_path


def freeze_mask(model, fixed_param, excluded_param=()):
    """{torch name: trainable} for every parameter and buffer of model
    outside SyncBN's running statistics."""
    stats = set(batch_stat_names(model))

    def frozen(path):
        return (any(f in path for f in fixed_param or ())
                and not any(e in path for e in excluded_param or ()))
    return {name: not frozen(flax_path(name)) for name in model.state_dict()
            if name not in stats}


def make_optimizer(model, trainable_mask, *, lr, opt_type="sgd",
                   momentum=0.9, wd=1e-4):
    """The config's optimizer over the trainable parameters; frozen ones get
    requires_grad=False, so they are never decayed and never move.

    - "sgd": torch.optim.SGD(momentum, weight_decay=wd, dampening=0) adds
      wd * w to the gradient before the momentum (buf = momentum * buf + g +
      wd * w; w -= lr * buf, the first buf being g + wd * w): exactly optax's
      add_decayed_weights followed by sgd(momentum), as the JAX package
      chains them.
    - "adam": L2 added to the gradient before the update (optax's
      add_decayed_weights then adam; torch.optim.Adam's weight_decay).
    - "adamw": decoupled decay of the trainable leaves (optax's adamw with
      mask=; torch.optim.AdamW, which multiplies w by 1 - lr * wd before the
      Adam update, w - lr * (wd * w + update) as optax).
    Adam's b1 0.9, b2 0.999 and eps 1e-8 are optax's defaults. The caller
    clips the gradients (`Trainer`) and sets the lr of each step
    (`set_lr`)."""
    if opt_type not in ("sgd", "adam", "adamw"):
        raise ValueError(f"unsupported optimizer.type {opt_type!r}; "
                         "supported: sgd, adam, adamw")
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(bool(trainable_mask[name]))
        if p.requires_grad:
            params.append(p)
    if opt_type == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=wd or 0.0)
    if opt_type == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=wd or 0.0)
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=wd or 0.0, dampening=0)


def set_lr(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = lr
