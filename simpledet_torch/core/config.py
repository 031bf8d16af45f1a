"""Read `config/*.py` without JAX.

A config file imports the repo-root shims (`symbol.builder`,
`models.FPN.builder`, `mxnext.complicate`, `core.detection_input`,
`core.detection_metric`), and those import the JAX package. While a config
runs, `read_config` serves every module under those roots as a stand-in that
only records what the config asked for: each component's class name and param
class, the normaliser type, and Norm2DImage's mean and std. It restores
`sys.modules` afterwards and returns a `ConfigSpec` that `dsl.py` builds from:
the test symbol's, or with is_train=True the train symbol's, with what the
trainer reads (the frozen-parameter patterns, OptimizeParam, batch_image).

`patch_config_as_nothrow` and `load_config` are copies of the JAX package's
(`simpledet_tpu/core/config.py`): a missing attribute on a config class reads
as None.
"""
import importlib.abc
import importlib.machinery
import importlib.util
import sys
import types
from dataclasses import dataclass
from typing import Any, Optional


class _NothrowMeta(type):
    def __getattr__(cls, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return None


def patch_config_as_nothrow(cfg):
    """Recursively rebind a config class (and nested classes) so missing
    attributes read as None instead of raising."""
    if cfg is None:
        return None
    if isinstance(cfg, type):
        if "Nothrow" in cfg.__name__ or isinstance(cfg, _NothrowMeta):
            return cfg
        patched = _NothrowMeta(cfg.__name__ + "Nothrow", (cfg,), {})
        for name in dir(cfg):
            if name.startswith("__"):
                continue
            val = getattr(cfg, name)
            if isinstance(val, type):
                setattr(patched, name, patch_config_as_nothrow(val))
        return patched
    cls = cfg.__class__
    if not isinstance(cls, _NothrowMeta) and "Nothrow" not in cls.__name__:
        cfg.__class__ = _NothrowMeta(cls.__name__ + "Nothrow", (cls,), {})
    for name in dir(cfg):
        if name.startswith("__"):
            continue
        try:
            val = getattr(cfg, name)
        except AttributeError:
            continue
        if isinstance(val, type) and not isinstance(val, _NothrowMeta):
            setattr(cfg, name, patch_config_as_nothrow(val))
        elif (not isinstance(val, type) and hasattr(val, "__dict__")
              and val.__class__.__module__ not in ("builtins",)
              and not callable(val)):
            patch_config_as_nothrow(val)
    return cfg


def load_config(path):
    """Import a config file by path. Returns the module."""
    name = path.removesuffix(".py").replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------------
# stand-ins for the root shims


class Recorded:
    """A config-side component instance: its class name and arguments. As a
    detector, its get_*_symbol record the components they are given."""

    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs

    @property
    def name(self):
        return type(self).__name__

    @property
    def param(self):
        return self.args[0] if self.args else None

    def get_train_symbol(self, *components, **kwargs):
        return Symbol(self.name, "train", components)

    def get_test_symbol(self, *components, **kwargs):
        return Symbol(self.name, "test", components)

    def get_rpn_test_symbol(self, *components, **kwargs):
        return Symbol(self.name, "rpn_test", components)


@dataclass
class Symbol:
    detector: str
    kind: str
    components: tuple


class _Normalizer:
    def __init__(self, type="fixbn", **kwargs):
        self.type = type
        self.kwargs = kwargs


class Norm2DImage(Recorded):
    def __init__(self, pNorm, *args, **kwargs):
        super().__init__(pNorm, *args, **kwargs)
        self.mean = tuple(float(v) for v in pNorm.mean)
        self.std = tuple(float(v) for v in pNorm.std)


_SHIM_ROOTS = ("symbol", "models", "mxnext", "core")
_SPECIAL = {"mxnext.complicate": {"normalizer_factory": _Normalizer},
            "core.detection_input": {"Norm2DImage": Norm2DImage}}


def _stand_in_module(modname):
    """A package whose every capitalised attribute is a Recorded subclass of
    that name, every lower-case one a stand-in submodule (or what _SPECIAL
    gives)."""
    mod = types.ModuleType(modname)
    mod.__path__ = []
    made = dict(_SPECIAL.get(modname, {}))

    def __getattr__(name):
        if name.startswith("__"):
            raise AttributeError(name)
        if name not in made:
            if name[0].islower():        # `from models.FPN import builder`
                made[name] = importlib.import_module(f"{modname}.{name}")
            else:
                made[name] = type(name, (Recorded,), {"__module__": modname})
        return made[name]

    mod.__getattr__ = __getattr__
    return mod


class _StandInFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Imports any module under the shim roots as a stand-in, and refuses the
    JAX package (configs built on its config_templates are not read yet)."""

    def find_spec(self, fullname, path=None, target=None):
        root = fullname.split(".")[0]
        if root == "simpledet_tpu":
            raise NotImplementedError(
                f"a config that imports {fullname} is not read by the port")
        if root in _SHIM_ROOTS:
            return importlib.machinery.ModuleSpec(fullname, self,
                                                  is_package=True)
        return None

    def create_module(self, spec):
        return _stand_in_module(spec.name)

    def exec_module(self, module):
        pass


def _is_hidden(name):
    return name.split(".")[0] in _SHIM_ROOTS + ("simpledet_tpu",)


# --------------------------------------------------------------------------


@dataclass
class Component:
    name: str        # config-side class name, e.g. "MSRAResNet50V1FPN"
    param: Any       # its nothrow-patched param class, e.g. BackboneParam


@dataclass
class ConfigSpec:
    """What the port builds a detector (and, for training, its optimizer)
    from."""
    detector: str
    components: dict               # role -> Component
    test: Any                      # TestParam (nothrow)
    pixel_norm: Optional[tuple]    # (mean, std) deferred to the device
    normalizers: tuple             # normaliser types the components name
    is_train: bool = False
    fixed_param: tuple = ()        # ModelParam.pretrain.fixed_param
    optimize: Any = None           # OptimizeParam (nothrow)
    batch_image: Optional[int] = None   # General.batch_image


_ROLES = ("backbone", "neck", "rpn_head", "roi_extractor", "bbox_head")


def read_config(path, is_train=False):
    """Run `config/<name>.py`'s get_config(is_train) against stand-in shims
    and return the ConfigSpec of its test symbol, or of its train symbol
    with is_train=True."""
    saved = {n: m for n, m in sys.modules.items() if _is_hidden(n)}
    for name in saved:
        del sys.modules[name]
    finder = _StandInFinder()
    sys.meta_path.insert(0, finder)
    try:
        cfg = load_config(path)
        out = cfg.get_config(is_train=is_train)
    finally:
        sys.meta_path.remove(finder)
        for name in [n for n in sys.modules if _is_hidden(n)]:
            del sys.modules[name]
        sys.modules.update(saved)
    general, model_param, optimize = (patch_config_as_nothrow(out[0]),
                                      patch_config_as_nothrow(out[6]),
                                      patch_config_as_nothrow(out[7]))
    test_param, transform = out[8], out[9]
    kind = "train" if is_train else "test"
    sym = getattr(model_param, f"{kind}_symbol")
    if not isinstance(sym, Symbol):
        raise NotImplementedError(f"{path}: no {kind} symbol")
    components = {}
    for role, comp in zip(_ROLES, sym.components):
        components[role] = Component(
            comp.name, patch_config_as_nothrow(comp.param))
    norms = tuple(sorted({
        c.param.normalizer.type for c in components.values()
        if c.param is not None
        and isinstance(c.param.normalizer, _Normalizer)}))
    pixel_norm = next(((t.mean, t.std) for t in transform or ()
                       if isinstance(t, Norm2DImage)), None)
    pretrain = model_param.pretrain
    return ConfigSpec(detector=sym.detector, components=components,
                      test=patch_config_as_nothrow(test_param),
                      pixel_norm=pixel_norm, normalizers=norms,
                      is_train=is_train,
                      fixed_param=tuple(pretrain.fixed_param or ())
                      if pretrain else (),
                      optimize=optimize, batch_image=general.batch_image)
