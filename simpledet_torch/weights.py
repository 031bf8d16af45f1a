"""Map a Flax parameter tree onto the port's modules.

`params` is the tree as nested dicts of numpy arrays (for example
`jax.tree.map(np.asarray, variables["params"])`). Module names in the port
follow the Flax names, so a leaf `a/b/kernel` becomes `a.b.weight`:
  - a conv kernel goes from HWIO to OIHW;
  - a transposed conv's kernel (a module named in TRANSPOSED_CONVS: the
    mask head's `mask_up`) goes from HWIO to torch's [in, out, kh, kw] and is
    flipped in both spatial axes: Flax's `nn.ConvTranspose` (without
    `transpose_kernel`) applies its kernel unflipped, torch's
    `conv_transpose2d` flipped. The shapes match either way (`mask_up` has
    as many inputs as outputs), so only the values show a missing flip;
  - a Dense kernel [in, out] becomes a Linear weight [out, in];
  - a trident unit's shared 3 x 3 kernel, the leaf `conv2_kernel` (a
    `self.param` of the unit, HWIO), keeps its name and becomes OIHW; so do
    RepPoints' deformable kernels `cls_conv_kernel` and
    `pts_refine_conv_kernel`;
  - the raw parameters FCOS's `offset_scale_{stride key}` and RepPoints'
    top-level `moment_transfer` keep their names and values (RAW_PARAMS);
  - `bias` stays `bias`; FrozenBN `scale` / `bias` land on its buffers,
    SyncBN's `gamma` / `beta` and GroupNorm's `scale` / `bias` on their
    parameters.
The `batch_stats` collection (SyncBN's running `mean` and `var`) maps the
same way onto SyncBN's buffers. Every params leaf must map onto a parameter
or buffer of the model with the same shape, and every parameter and buffer
outside the running statistics must be given one. `flax_path` is the inverse
name map.
"""
import numpy as np
import torch

from simpledet_torch.models.norm import batch_stat_names, set_has_stats

LEAVES = ("bias", "scale", "gamma", "beta", "mean", "var")
# modules whose Flax kernel is an nn.ConvTranspose's
TRANSPOSED_CONVS = ("mask_up",)
# conv kernels that are a module's own parameter, under their Flax names
SHARED_KERNELS = ("conv2_kernel", "cls_conv_kernel",
                  "pts_refine_conv_kernel")
# raw parameters of a module or the model, by name prefix: kept as they are
RAW_PARAMS = ("offset_scale_", "moment_transfer")


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def convert_leaf(path, value):
    """(torch name, tensor) for one Flax leaf."""
    *mods, leaf = path
    if leaf == "kernel":
        if value.ndim == 4 and mods and mods[-1] in TRANSPOSED_CONVS:
            value = value[::-1, ::-1].transpose(2, 3, 0, 1)
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 2:
            value = value.T
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {value.ndim}")
        leaf = "weight"
    elif leaf in SHARED_KERNELS:
        value = value.transpose(3, 2, 0, 1)
    elif leaf not in LEAVES and not leaf.startswith(RAW_PARAMS):
        raise ValueError(f"{'/'.join(path)}: unknown leaf {leaf!r}")
    return ".".join(mods + [leaf]), torch.from_numpy(
        np.array(value, dtype=np.float32, order="C"))


def flax_leaf(torch_name, value):
    """The Flax layout of a torch parameter or buffer (numpy), the inverse
    of convert_leaf's."""
    *mods, leaf = torch_name.split(".")
    if leaf in SHARED_KERNELS:
        return value.transpose(2, 3, 1, 0)
    if leaf != "weight":
        return value
    if value.ndim == 4 and mods and mods[-1] in TRANSPOSED_CONVS:
        return value.transpose(2, 3, 0, 1)[::-1, ::-1]
    return value.transpose(2, 3, 1, 0) if value.ndim == 4 else value.T


def flax_path(torch_name):
    """'/'-joined Flax path of a torch parameter or buffer name:
    `a.b.weight` -> `a/b/kernel`; every other leaf keeps its name."""
    *mods, leaf = torch_name.split(".")
    return "/".join(mods + ["kernel" if leaf == "weight" else leaf])


def _converted(tree, target, kind):
    state = {}
    for path, value in _flatten(tree):
        name, tensor = convert_leaf(path, value)
        if name not in target:
            raise KeyError(f"flax {kind} leaf {'/'.join(path)} -> {name}: "
                           "not in the model")
        if tuple(tensor.shape) != tuple(target[name].shape):
            raise ValueError(f"{name}: flax shape {tuple(tensor.shape)} vs "
                             f"model {tuple(target[name].shape)}")
        state[name] = tensor
    missing = sorted(set(target) - set(state))
    if missing:
        raise KeyError(f"model entries with no flax {kind} leaf: "
                       f"{missing[:8]}{' ...' if len(missing) > 8 else ''}")
    return state


def from_flax(params, model, batch_stats=None):
    """Load the Flax tree `params` (and, when given, the `batch_stats`
    collection) into `model` (in place); returns model. Raises on a leaf the
    model lacks, a model entry left without a leaf, or a shape that differs.
    Without batch_stats the running statistics keep their values; with
    them, SyncBN evaluates on them."""
    full = model.state_dict()
    stats = set(batch_stat_names(model))
    state = _converted(params, {k: v for k, v in full.items()
                                if k not in stats}, "params")
    if batch_stats is not None:
        state.update(_converted(batch_stats, {k: full[k] for k in stats},
                                "batch_stats"))
    model.load_state_dict(state, strict=False)
    if batch_stats is not None:
        set_has_stats(model)
    return model
