"""Checkpoints in the JAX package's layout and format (counterpart of
simpledet_tpu/core/checkpoint.py): `<prefix>-%04d.params` per epoch, the
newest epoch found by `get_latest_ckpt_epoch`, and pretrain bootstrapping by
Flax path and shape (`load_pretrain`).

`.params` is what `flax.serialization.to_bytes(params)` writes: a msgpack map
of nested maps (keys in the tree's order: sorted, for a tree that went
through JAX's tree functions, as the JAX package's saved trees did), each
leaf an ExtType 1 whose payload is the msgpack array (shape, dtype name,
C-order bytes). This module reads and writes that format with a small
msgpack codec of its own (`packb`, `unpackb`) for exactly the types it
holds: maps, arrays, str, bin, ext, ints, floats and nil; anything else
raises. Names go through `weights.flax_path` and layouts through
`weights.flax_leaf`: a conv kernel is HWIO there and OIHW here (the mask
head's transposed conv: flipped, [in, out, kh, kw] here), a Dense kernel
[in, out] is a Linear weight [out, in], and FrozenBN's scale and bias
(buffers here) are params there.

SyncBN's running statistics go in `<prefix>-%04d.batch_stats`, the JAX
package's `batch_stats` collection in the same format. Only rank 0 writes.

`.torch_states` holds the port's own optimizer state (`torch.save` of the
optimizer's state dict and the step count). The JAX package's `.states` is a
pickle of optax state: the port neither reads nor writes that name, so
neither package's resume meets the other's optimizer state
(`foreign_states` finds one for the caller to report).
"""
import os
import struct

import numpy as np
import torch

from simpledet_torch.models.norm import batch_stat_names
from simpledet_torch.parallel.dist import rank
from simpledet_torch.weights import (convert_leaf, flax_leaf, flax_path,
                                     from_flax)

_NDARRAY_EXT = 1     # flax.serialization's ExtType code for an ndarray


# ------------------------------------------------------------------ msgpack


class Ext:
    """A msgpack extension value: a type code and its payload bytes."""

    def __init__(self, code, data):
        self.code, self.data = code, bytes(data)


def _sized(out, n, small, fixed_base, codes):
    """Append the header of a length-n item: the fix form for n < small,
    else the 8-, 16- or 32-bit form (`codes`, None where msgpack has none)."""
    if n < small:
        out.append(fixed_base | n)
        return
    for code, fmt, lim in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack(obj, out):
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        raise TypeError("msgpack subset: bool is not supported")
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(obj)
        elif -32 <= obj < 0:
            out += struct.pack(">b", obj)
        elif obj >= 0:
            for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32),
                                   (0xCF, ">Q", 1 << 64)):
                if obj < lim:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise ValueError(f"msgpack: int {obj} too large")
        else:
            for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                   (0xD2, ">i", 1 << 31),
                                   (0xD3, ">q", 1 << 63)):
                if obj >= -lim:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise ValueError(f"msgpack: int {obj} too small")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(out, len(data), 32, 0xA0, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _sized(out, len(obj), 0, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, Ext):
        n = len(obj.data)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            out.append(fixed[n])
        else:
            _sized(out, n, 0, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", obj.code)
        out += obj.data
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), 16, 0x90, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _sized(out, len(obj), 16, 0x80, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack subset: {type(obj).__name__} is not "
                        "supported")


def packb(obj):
    """msgpack bytes of obj (None, int, float, str, bytes, Ext, list or
    tuple, dict), in the smallest encoding of each item, as msgpack-python
    packs them."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data):
        self.data, self.pos = memoryview(data), 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def num(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        t = self.num(">B")
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t < 0x90:
            return self.map(t & 0x0F)
        if 0x90 <= t < 0xA0:
            return self.array(t & 0x0F)
        if 0xA0 <= t < 0xC0:
            return str(self.take(t & 0x1F), "utf-8")
        if t == 0xC0:
            return None
        fmt = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
               0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if t in fmt:
            return self.num(fmt[t])
        width = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B",
                 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
                 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                 0xC9: ">I"}
        if t in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.num(width[t])))
        if t in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.num(width[t])), "utf-8")
        if t in (0xDC, 0xDD):
            return self.array(self.num(width[t]))
        if t in (0xDE, 0xDF):
            return self.map(self.num(width[t]))
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixed or t in (0xC7, 0xC8, 0xC9):
            n = fixed[t] if t in fixed else self.num(width[t])
            code = self.num(">b")
            return Ext(code, self.take(n))
        raise ValueError(f"msgpack subset: type byte 0x{t:02x} is not "
                         "supported")

    def array(self, n):
        return [self.read() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data):
    """The object that packb(obj) encoded (arrays come back as lists, ext
    values as Ext); raises on a type outside the subset or trailing bytes."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes")
    return obj


# ------------------------------------------------------------- flax format


def _leaf_ext(value):
    arr = np.asarray(value)
    return Ext(_NDARRAY_EXT, packb([list(arr.shape), arr.dtype.name,
                                    arr.tobytes("C")]))


def _ext_leaf(ext):
    if ext.code != _NDARRAY_EXT:
        raise ValueError(f"flax msgpack: ext type {ext.code} is not an "
                         "ndarray")
    shape, dtype, data = unpackb(ext.data)
    return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape).copy()


def to_bytes(tree):
    """flax.serialization.to_bytes of a nested dict of numpy arrays."""
    def enc(t):
        if isinstance(t, dict):
            return {str(k): enc(v) for k, v in t.items()}
        return _leaf_ext(t)
    return packb(enc(tree))


def from_bytes(data):
    """The nested dict of numpy arrays that to_bytes (or flax) wrote."""
    def dec(t):
        if isinstance(t, dict):
            if "__msgpack_chunked_array__" in t:
                raise ValueError("flax msgpack: chunked arrays (leaves over "
                                 "2**30 bytes) are not supported")
            return {k: dec(v) for k, v in t.items()}
        if isinstance(t, Ext):
            return _ext_leaf(t)
        raise ValueError(f"flax msgpack: unexpected {type(t).__name__} leaf")
    return dec(unpackb(data))


def flatten(tree, prefix=()):
    """{('a', 'b', 'kernel'): array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _tree(items):
    """Nested dict of float32 numpy arrays of (torch name, tensor) items, in
    Flax names and layouts, keys sorted as JAX orders a dict."""
    tree = {}
    for name, t in sorted(items, key=lambda kv: flax_path(kv[0]).split("/")):
        v = flax_leaf(name, t.detach().to("cpu", torch.float32).numpy())
        *mods, leaf = flax_path(name).split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(v)
    return tree


def to_flax(model):
    """The Flax param tree of a model's parameters and buffers outside
    SyncBN's running statistics, the inverse of `weights.from_flax`."""
    stats = set(batch_stat_names(model))
    return _tree((k, v) for k, v in model.state_dict().items()
                 if k not in stats)


def batch_stats_to_flax(model):
    """The Flax `batch_stats` tree of a model's SyncBN running statistics
    ({} without SyncBN)."""
    state = model.state_dict()
    return _tree((k, state[k]) for k in batch_stat_names(model))


# ---------------------------------------------------------------- files


def params_path(prefix, epoch):
    return f"{prefix}-{epoch:04d}.params"


def states_path(prefix, epoch):
    """The port's optimizer state."""
    return f"{prefix}-{epoch:04d}.torch_states"


def jax_states_path(prefix, epoch):
    """The JAX package's optimizer state (a pickle of optax state)."""
    return f"{prefix}-{epoch:04d}.states"


def batch_stats_path(prefix, epoch):
    return f"{prefix}-{epoch:04d}.batch_stats"


def save_checkpoint(prefix, epoch, model, optimizer=None, step=None):
    """On rank 0 only: write `<prefix>-%04d.params` in the JAX package's
    format, `<prefix>-%04d.batch_stats` when the model has SyncBN and, with
    an optimizer, `<prefix>-%04d.torch_states` with its state dict and the
    step."""
    if rank() != 0:
        return
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    with open(params_path(prefix, epoch), "wb") as f:
        f.write(to_bytes(to_flax(model)))
    stats = batch_stats_to_flax(model)
    if stats:
        with open(batch_stats_path(prefix, epoch), "wb") as f:
            f.write(to_bytes(stats))
    if optimizer is not None:
        torch.save({"optimizer": optimizer.state_dict(), "step": step},
                   states_path(prefix, epoch))


def read_params(path):
    with open(path, "rb") as f:
        return from_bytes(f.read())


def load_batch_stats(prefix, epoch, model):
    """Load `<prefix>-%04d.batch_stats` into the model's SyncBN running
    statistics, which it then evaluates on; returns False, changing
    nothing, when the file is absent."""
    path = batch_stats_path(prefix, epoch)
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        stats = from_bytes(f.read())
    from_flax(to_flax(model), model, batch_stats=stats)
    return True


def foreign_states(prefix, epoch):
    """The path of the JAX package's `.states` beside this checkpoint when
    the port has no optimizer state of its own there, else None: the caller
    restarts the optimizer and says so."""
    path = jax_states_path(prefix, epoch)
    if os.path.exists(path) and not os.path.exists(states_path(prefix,
                                                                epoch)):
        return path
    return None


def load_checkpoint(prefix, epoch, model, optimizer=None):
    """Load `<prefix>-%04d.params` into model (every leaf, shapes checked,
    `weights.from_flax`, which copies into the model's tensors where they
    are); with an optimizer and a `.torch_states` file, its state too.
    Returns the saved step, or None without a `.torch_states` file (a JAX
    package's `.states` is not read). SyncBN's statistics load apart
    (`load_batch_stats`)."""
    from_flax(read_params(params_path(prefix, epoch)), model)
    sp = states_path(prefix, epoch)
    if optimizer is None or not os.path.exists(sp):
        return None
    device = next(model.parameters()).device
    states = torch.load(sp, map_location=device, weights_only=True)
    optimizer.load_state_dict(states["optimizer"])
    return states["step"]


def get_latest_ckpt_epoch(prefix):
    d = os.path.dirname(prefix) or "."
    base = os.path.basename(prefix)
    best = None
    if os.path.isdir(d):
        for fn in os.listdir(d):
            if fn.startswith(base + "-") and fn.endswith(".params"):
                try:
                    e = int(fn[len(base) + 1:-len(".params")])
                    best = e if best is None else max(best, e)
                except ValueError:
                    pass
    return best


def load_pretrain(model, prefix, epoch=0, allow_missing=True):
    """Copy into `model` every leaf of a pretrain file whose Flax path and
    shape match one of its parameters or buffers; the rest keep their fresh
    init (allow_missing). Reads our `.params` format or a flat npz of
    'a/b/c' -> array. Returns the number of leaves copied."""
    path = params_path(prefix, epoch)
    if os.path.exists(path):
        loaded = {"/".join(k): v
                  for k, v in flatten(read_params(path)).items()}
    elif os.path.exists(prefix + ".npz"):
        with np.load(prefix + ".npz") as npz:
            loaded = {k: npz[k] for k in npz.files}
    else:
        raise FileNotFoundError(f"no pretrain at {prefix}")
    state = model.state_dict()
    n_hit = 0
    with torch.no_grad():
        for name, t in state.items():
            key = flax_path(name)
            if key not in loaded:
                continue
            _, value = convert_leaf(tuple(key.split("/")), loaded[key])
            if tuple(value.shape) == tuple(t.shape):
                t.copy_(value)
                n_hit += 1
            elif not allow_missing:
                raise ValueError(f"shape mismatch at {key}")
    return n_hit
