"""Which configs under config/ the port reads and builds.

    python -m simpledet_torch.config_coverage [--depth 18] [--list]

Each config file is read (`core.config.read_config`) and its detector built
(`dsl.build_detector`, the backbone at `--depth`, on the meta device: no
weights are allocated) for its test and its train symbol. A file counts as built when both modes
build. Prints the count, then each NotImplementedError (or other error)
message with the number of files that raised it, most first; `--list`
names the files under each. Runs on the CPU; nothing is trained or served.
"""
import argparse
import collections
import glob
import os

import torch

from simpledet_torch.core.config import read_config
from simpledet_torch.dsl import build_detector


def probe(path, depth):
    """None when the config builds in both modes, else the first error's
    one-line message."""
    try:
        for is_train in (False, True):
            spec = read_config(path, is_train=is_train)
            with torch.device("meta"):
                build_detector(spec, depth=depth)
    except Exception as e:         # noqa: BLE001 - every failure is counted
        kind = "" if isinstance(e, NotImplementedError) else \
            f"{type(e).__name__}: "
        return kind + str(e).splitlines()[0]
    return None


def config_files(root="config"):
    """Every config file under root (not the packages' __init__ nor the
    shared helpers, which define no get_config)."""
    out = []
    for path in sorted(glob.glob(os.path.join(root, "**", "*.py"),
                                 recursive=True)):
        with open(path) as f:
            if "def get_config" in f.read():
                out.append(path)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depth", type=int, default=18)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    files = config_files()
    errors = {path: probe(path, args.depth) for path in files}
    built = [p for p, e in errors.items() if e is None]
    print(f"{len(built)} of {len(files)} config files read and build in both "
          f"modes (backbone depth {args.depth})")
    by_message = collections.defaultdict(list)
    for path, err in errors.items():
        if err is not None:
            by_message[err].append(path)
    for msg, paths in sorted(by_message.items(), key=lambda kv: -len(kv[1])):
        print(f"{len(paths):4d}  {msg}")
        if args.list:
            for p in paths:
                print(f"        {p}")
    return len(built), len(files)


if __name__ == "__main__":
    main()
