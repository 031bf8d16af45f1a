"""Read `config/*.py` without JAX.

A config file imports the repo-root shims (`symbol.builder`,
`models.FPN.builder`, `mxnext.complicate`, `core.detection_input`,
`core.detection_metric`), and those import the JAX package. While a config
runs, `read_config` serves every module under those roots as a stand-in that
only records what the config asked for: each component's class name (for a
config's subclass of one, the shim class and its `depth`) and param class,
the normaliser type, each transform's and metric's class name and
arguments, and Norm2DImage's mean and std. A config built on the JAX
package's config factories (`from simpledet_tpu.config_templates import
faster_fpn_config`)
gets the port's copy of that module, `simpledet_torch/config_templates.py`,
which runs against the same stand-ins; a config that imports the JAX
package's `simpledet_tpu.data.transforms` (the mask configs' test chain)
gets the port's `simpledet_torch/data/transforms.py` itself, whose transforms
it then builds as they are; a config that imports the JAX DSL's classes
(`from simpledet_tpu.dsl import ResNet50V1bFPN`, as `config/micro_test.py`
does for its v1b / v1d backbones) gets a stand-in module of the same kind
as the shims' (`_STAND_INS`), and nothing of the JAX module runs; any other
import of `simpledet_tpu` raises NotImplementedError naming the module.
`read_config` restores `sys.modules` afterwards and returns a `ConfigSpec`
that `dsl.py` builds from: the test symbol's, or with is_train=True the train symbol's, with what the
trainer, the loader and the CLIs read. The symbol's components are placed
under the names of the detector's get_*_symbol arguments in the JAX DSL
(`ROLES`: `bbox_head_2nd` and `bbox_head_3rd` for CascadeRcnn,
`mask_roi_extractor`, `mask_head` and `bbox_post_processor` for
MaskFasterRcnn, and `maskiou_head` before the last for
MaskScoringFasterRcnn; TSDFasterRcnn takes FasterRcnn's five; RetinaNet,
RPN (FCOS's detector too) and RepPointsDetector take a backbone, a neck and
an `rpn_head`), every one of them, each with every param class it was
given (`MaskFasterRcnn4ConvHead(BboxParam, MaskParam, MaskRoiParam)`); a
detector without roles there, a component that has no role, or an argument
given by keyword raises NotImplementedError, except the keywords a detector
reads (`KEYWORDS`: TridentFasterRcnn's `num_branch`, `scaleaware` and
`valid_ranges`, TSDFasterRcnn's `p_tsd`), which the spec keeps as
`options`. A config's subclass of a
stand-in detector (`config/rpn_r50v1_fpn_1x.py`'s `class
_RpnDetector(RPN)`, whose get_*_symbol call `RPN._assemble`) is recorded as
its stand-in base.

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
        """The stand-in class's name; for a config's subclass of one (the
        RPN config's `class _RpnDetector(RPN)`), its stand-in base's."""
        return _stand_in_base(type(self)).__name__

    @property
    def param(self):
        return self.args[0] if self.args else None

    def get_train_symbol(self, *components, **kwargs):
        return Symbol(self.name, "train", components, kwargs)

    def get_test_symbol(self, *components, **kwargs):
        return Symbol(self.name, "test", components, kwargs)

    def get_rpn_test_symbol(self, *components, **kwargs):
        return Symbol(self.name, "rpn_test", components, kwargs)


class DetectorRecorded(Recorded):
    """The base of the stand-in of a detector the port reads (one of
    `ROLES`): as the JAX DSL's detectors do, it has `_assemble`."""

    @classmethod
    def _assemble(cls, *components, **kwargs):
        """`Detector._assemble(backbone, neck, ...)`, which a config's
        subclass of a detector calls from its own get_*_symbol (the RPN
        config's `_RpnDetector(RPN)`): the symbol of the stand-in detector,
        its kind filled in by read_config."""
        return Symbol(_stand_in_base(cls).__name__, None, components, kwargs)


def _stand_in_base(cls):
    """The stand-in class that cls is or derives from (cls itself for a
    recorder that is no stand-in, such as Norm2DImage)."""
    return next((c for c in cls.__mro__ if "_stand_in" in c.__dict__), cls)


@dataclass
class Symbol:
    detector: str
    kind: str
    components: tuple
    named: dict      # the arguments given by keyword


class Normalizer:
    """A config's normalizer_factory(type=..., ...): its type."""

    def __init__(self, type="fixbn", **kwargs):
        self.type = type


class Norm2DImage(Recorded):
    def __init__(self, pNorm, *args, **kwargs):
        super().__init__(pNorm, *args, **kwargs)
        self.mean = tuple(float(v) for v in pNorm.mean)
        self.std = tuple(float(v) for v in pNorm.std)


_SHIM_ROOTS = ("symbol", "models", "mxnext", "core")
# the mask configs take Norm2DImage from models.maskrcnn.input: without it
# there, read_config would find no pixel normalisation
_SPECIAL = {"mxnext.complicate": {"normalizer_factory": Normalizer},
            "core.detection_input": {"Norm2DImage": Norm2DImage},
            "models.maskrcnn.input": {"Norm2DImage": Norm2DImage}}


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
                base = DetectorRecorded if name in ROLES else Recorded
                made[name] = type(name, (base,), {"__module__": modname,
                                                  "_stand_in": True})
        return made[name]

    mod.__getattr__ = __getattr__
    return mod


_TEMPLATES = "simpledet_tpu.config_templates"
# modules of the JAX package served by the port's own module of that role
_SERVED = {"simpledet_tpu.data.transforms": "simpledet_torch.data.transforms"}
_BARE = ("simpledet_tpu", "simpledet_tpu.data")   # packages of those
# modules of the JAX package served as stand-ins, as the shims are: the DSL's
# component and detector classes have the shims' names
_STAND_INS = ("simpledet_tpu.dsl",)


class _StandInFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Imports any module under the shim roots, and the JAX package's dsl,
    as a stand-in, serves the JAX package's config_templates from the port's
    copy and its data.transforms by the port's module, and refuses every
    other module of the JAX package."""

    def find_spec(self, fullname, path=None, target=None):
        root = fullname.split(".")[0]
        if fullname == _TEMPLATES:
            from simpledet_torch import config_templates
            return importlib.util.spec_from_file_location(
                fullname, config_templates.__file__)
        if fullname in _BARE or fullname in _SERVED:
            return importlib.machinery.ModuleSpec(
                fullname, self, is_package=fullname in _BARE)
        if fullname in _STAND_INS:
            return importlib.machinery.ModuleSpec(fullname, self,
                                                  is_package=True)
        if root == "simpledet_tpu":
            raise NotImplementedError(
                f"a config that imports {fullname} is not read by the port")
        if root in _SHIM_ROOTS:
            return importlib.machinery.ModuleSpec(fullname, self,
                                                  is_package=True)
        return None

    def create_module(self, spec):
        if spec.name in _SERVED:
            return importlib.import_module(_SERVED[spec.name])
        if spec.name in _BARE:             # a bare package for the copies
            mod = types.ModuleType(spec.name)
            mod.__path__ = []
            return mod
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
    depth: Optional[int] = None   # a config subclass's `depth` override
    params: tuple = ()   # every param class it was given, param first


def _component(comp):
    """The Component of a config-side instance. A class the config derives
    from a shim class (`class TinyBackbone(MSRAResNet50V1FPN): depth = 18`)
    is recorded as that shim class with its `depth`; any other override is
    not read by the port and raises."""
    mro = type(comp).__mro__
    base = _stand_in_base(type(comp))
    overrides = {}
    for c in reversed(mro[:mro.index(base)]):
        overrides.update({k: v for k, v in vars(c).items()
                          if not k.startswith("__")})
    extra = sorted(set(overrides) - {"depth"})
    if extra:
        raise NotImplementedError(f"{type(comp).__name__} overrides {extra} "
                                  f"of {base.__name__}: not ported")
    params = tuple(patch_config_as_nothrow(a) for a in comp.args)
    return Component(base.__name__, params[0] if params else None,
                     overrides.get("depth"), params)


@dataclass
class ConfigSpec:
    """What the port builds a detector (and, for training, its optimizer)
    from."""
    detector: str
    components: dict               # role -> Component
    test: Any                      # TestParam (nothrow)
    pixel_norm: Optional[tuple]    # (mean, std) deferred to the device
    is_train: bool = False
    fixed_param: tuple = ()        # ModelParam.pretrain.fixed_param
    excluded_param: tuple = ()     # ModelParam.pretrain.excluded_param
    optimize: Any = None           # OptimizeParam (nothrow)
    batch_image: Optional[int] = None   # General.batch_image
    general: Any = None            # General (nothrow): name, loader_worker
    dataset: Any = None            # DatasetParam (nothrow)
    model: Any = None              # ModelParam (nothrow): pretrain, random
    transform: tuple = ()          # the recorded transforms, in order
    label_name: tuple = ()         # the batch keys the config labels
    metric_list: tuple = ()        # the recorded core.detection_metric's
    options: Any = None            # the get_*_symbol keywords of KEYWORDS

    @property
    def name(self):
        """General.name: the experiment's directory under experiments/."""
        return self.general.name


# Each detector's get_train_symbol / get_test_symbol arguments, in order, as
# `simpledet_tpu/dsl.py` names them (get_rpn_test_symbol takes the first
# three). A detector not listed here is not read.
ROLES = {
    "FasterRcnn": ("backbone", "neck", "rpn_head", "roi_extractor",
                   "bbox_head"),
    "CascadeRcnn": ("backbone", "neck", "rpn_head", "roi_extractor",
                    "bbox_head", "bbox_head_2nd", "bbox_head_3rd"),
    # the train symbol takes the first seven, the test symbol all eight
    "MaskFasterRcnn": ("backbone", "neck", "rpn_head", "roi_extractor",
                       "mask_roi_extractor", "bbox_head", "mask_head",
                       "bbox_post_processor"),
    # the JAX DSL names RetinaNet's third argument `head`; it is the RPN
    # head's role, its param class is the config's RpnParam
    "RetinaNet": ("backbone", "neck", "rpn_head"),
    # FCOS configs build the RPN detector with an FCOSFPNNeck and an
    # FCOSFPNHead (`config/fcos_r50v1_fpn_1x.py`)
    "RPN": ("backbone", "neck", "rpn_head"),
    # the JAX DSL names the third argument `head`; its param class is the
    # config's RpnParam, as RetinaNet's
    "RepPointsDetector": ("backbone", "neck", "rpn_head"),
    "TridentFasterRcnn": ("backbone", "neck", "rpn_head", "roi_extractor",
                          "bbox_head"),
    "TSDFasterRcnn": ("backbone", "neck", "rpn_head", "roi_extractor",
                      "bbox_head"),
    # MaskFasterRcnn's, the MaskIoU head before the post processor
    # (`config/ms_r50v1_fpn_1x.py`)
    "MaskScoringFasterRcnn": ("backbone", "neck", "rpn_head", "roi_extractor",
                              "mask_roi_extractor", "bbox_head", "mask_head",
                              "maskiou_head", "bbox_post_processor"),
}
# the keyword arguments of a detector's get_*_symbol that the port reads
KEYWORDS = {"TridentFasterRcnn": ("num_branch", "scaleaware",
                                  "valid_ranges"),
            "TSDFasterRcnn": ("p_tsd",)}


def place_components(sym):
    """{role: Component} of every component a detector's get_*_symbol was
    given, under ROLES' names; raises NotImplementedError for a detector
    without roles, for an argument given by keyword that is not one of its
    KEYWORDS, and for a component that has no role or is not a config-side
    component instance."""
    roles = ROLES.get(sym.detector)
    if roles is None:
        raise NotImplementedError(f"detector {sym.detector!r}: its "
                                  "components are not read by the port")
    call = f"{sym.detector}.get_{sym.kind}_symbol"
    unread = [k for k in sym.named if k not in KEYWORDS.get(sym.detector, ())]
    if unread:
        raise NotImplementedError(f"{call}: arguments given by keyword "
                                  f"({', '.join(unread)}) are not read")
    if len(sym.components) > len(roles):
        raise NotImplementedError(
            f"{call} was given {len(sym.components)} components; the port "
            f"places {len(roles)} ({', '.join(roles)})")
    placed = dict(zip(roles, sym.components))
    for role, comp in placed.items():
        if not isinstance(comp, Recorded):
            raise NotImplementedError(
                f"{sym.detector}: {role} = {comp!r} is not a component the "
                "port reads")
    return {role: _component(comp) for role, comp in placed.items()}


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
    sym.kind = sym.kind or kind         # a symbol made by `_assemble`
    components = place_components(sym)
    pixel_norm = next(((t.mean, t.std) for t in transform or ()
                       if isinstance(t, Norm2DImage)), None)
    pretrain = model_param.pretrain
    return ConfigSpec(detector=sym.detector, components=components,
                      test=patch_config_as_nothrow(test_param),
                      pixel_norm=pixel_norm,
                      is_train=is_train,
                      fixed_param=tuple(pretrain.fixed_param or ())
                      if pretrain else (),
                      excluded_param=tuple(pretrain.excluded_param or ())
                      if pretrain else (),
                      optimize=optimize, batch_image=general.batch_image,
                      general=general, dataset=patch_config_as_nothrow(out[5]),
                      model=model_param, transform=tuple(transform or ()),
                      label_name=tuple(out[11] or ()),
                      metric_list=tuple(out[12] or ()) if len(out) > 12
                      else (), options=dict(sym.named))
