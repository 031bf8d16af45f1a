"""Map a Flax parameter tree onto the port's modules.

`params` is the tree as nested dicts of numpy arrays (for example
`jax.tree.map(np.asarray, variables["params"])`). Module names in the port
follow the Flax names, so a leaf `a/b/kernel` becomes `a.b.weight`:
  - a conv kernel goes from HWIO to OIHW;
  - a Dense kernel [in, out] becomes a Linear weight [out, in];
  - `bias` stays `bias`; FrozenBN `scale` / `bias` land on its buffers.
Every leaf must map onto a parameter or buffer of the model with the same
shape, and every parameter and buffer must be given one. `flax_path` is the
inverse name map.
"""
import numpy as np
import torch


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
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 2:
            value = value.T
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {value.ndim}")
        leaf = "weight"
    elif leaf not in ("bias", "scale"):
        raise ValueError(f"{'/'.join(path)}: unknown leaf {leaf!r}")
    return ".".join(mods + [leaf]), torch.from_numpy(
        np.array(value, dtype=np.float32, order="C"))


def flax_path(torch_name):
    """'/'-joined Flax path of a torch parameter or buffer name:
    `a.b.weight` -> `a/b/kernel`; `bias` and `scale` keep their names."""
    *mods, leaf = torch_name.split(".")
    return "/".join(mods + ["kernel" if leaf == "weight" else leaf])


def from_flax(params, model):
    """Load the Flax tree `params` into `model` (in place); returns model.
    Raises on a leaf the model lacks, a model entry left without a leaf, or a
    shape that differs."""
    target = model.state_dict()
    state = {}
    for path, value in _flatten(params):
        name, tensor = convert_leaf(path, value)
        if name not in target:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {name}: not in "
                           "the model")
        if tuple(tensor.shape) != tuple(target[name].shape):
            raise ValueError(f"{name}: flax shape {tuple(tensor.shape)} vs "
                             f"model {tuple(target[name].shape)}")
        state[name] = tensor
    missing = sorted(set(target) - set(state))
    if missing:
        raise KeyError(f"model entries with no flax leaf: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    model.load_state_dict(state, strict=True)
    return model
