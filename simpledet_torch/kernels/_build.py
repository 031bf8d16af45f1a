"""Build the CUDA kernels in `simpledet_torch/csrc/` and load them.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` at
first use into `build/simpledet_torch/lib<name>-<hash>.so` at the repo root
(the hash is of the source and flags, so an edited source is rebuilt), then
loaded with ctypes. Flags: `-gencode arch=compute_90a,code=sm_90a -O3`, never
`--use_fast_math`; `--fmad=false` keeps every product and sum rounded on its
own, as PyTorch's plain versions round them, so a kernel can be held bit for
bit against its plain version.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "simpledet_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("nms", "roi_align")

_libs = {}


def nvcc_path():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source with the CUDA toolkit")
    return path


def _target(name):
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _nvcc(name, out):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name, proc, tmp, out):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all():
    """Compile every missing library, one nvcc per source, all at once."""
    pending = []
    for name in SOURCES:
        out = _target(name)
        if not out.exists():
            pending.append((name, *_nvcc(name, out), out))
    for name, proc, tmp, out in pending:
        _finish(name, proc, tmp, out)


def load(name):
    """ctypes handle of csrc/<name>.cu, built if needed."""
    if name not in _libs:
        out = _target(name)
        if not out.exists():
            _finish(name, *_nvcc(name, out), out)
        _libs[name] = ctypes.CDLL(str(out))
    return _libs[name]


def check(lib, err, what):
    """Raise if a C entry point of `lib` returned a CUDA error code."""
    if err != 0:
        fn = lib.simpledet_cuda_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({fn(err).decode(errors='replace')})")
