"""Compare two checkouts of the repo on one card: runs `chip_smoke.py`,
`simpledet_torch.infer` and `simpledet_torch.train` in each, alternating
(A B, then B A, ...), and prints the median and quartiles of each reading.

    python3 alternate.py --base build/parent --runs 5
    python3 alternate.py --base build/variant --runs 3 --kinds nms

The `nms`, `fwd` and `bwd` kinds run this checkout's `chip_smoke.check_nms`,
`chip_smoke.time_fwd_sets` and `chip_smoke.time_bwd_sets` (the same inputs
and timing on both sides) against each checkout's own kernels.

`--base` is the other checkout (for example the parent commit unpacked with
`git archive` into a directory that .gitignore lists); the checkout this
script lives in is the change. Each run's output goes to `--out`.
"""
import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

CHANGE = os.path.dirname(os.path.abspath(__file__))
CFG = ["--config", "config/faster_r50v1_fpn_1x.py", "--shape", "800", "1333",
       "--batch", "2"]
# seeded random weights diverge after 13-28 steps (ROADMAP.md Queue 3): keep
# the timed window short
RUNS = {
    "smoke": ["chip_smoke.py"],
    "fwd": ["-c", "{call}", "time_fwd_sets"],
    "bwd": ["-c", "{call}", "time_bwd_sets"],
    "nms": ["-c", "{call}", "check_nms"],
    "infer": ["-m", "simpledet_torch.infer", *CFG, "--count", "20"],
    "train": ["-m", "simpledet_torch.train", *CFG, "--steps", "20"],
}
# build the kernels of the checkout in the working directory and call one
# function of this checkout's chip_smoke.py on the card
CALL = (
    "import importlib.util, sys, torch\n"
    "from simpledet_torch.kernels import _build\n"
    f"spec = importlib.util.spec_from_file_location('smoke', "
    f"{os.path.join(CHANGE, 'chip_smoke.py')!r})\n"
    "smoke = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(smoke)\n"
    "_build.build_all()\n"
    "getattr(smoke, sys.argv[1])(torch.device('cuda', 0))\n")


def readings(kind, text):
    """The numbers a run printed: kernel times (ms) for smoke, nms, fwd and
    bwd, ms per image for infer, ms per step for train."""
    if kind == "infer":
        return {"ms_per_image": float(re.search(r"([\d.]+) ms per image",
                                                text).group(1))}
    if kind == "train":
        return {"ms_per_step": float(re.search(r"([\d.]+) ms/step",
                                               text).group(1))}
    out = {}
    if kind in ("fwd", "bwd"):
        for m in re.finditer(rf"^roi_align_{kind} set (.+): kernel ([\d.]+) "
                             "ms", text, re.M):
            out[f"roi_align_{kind} set {m.group(1)}"] = float(m.group(2))
        return out
    for m in re.finditer(r"^nms (\d+x\d+@[\d.]+): .*?kernel ([\d.]+) ms",
                         text, re.M):
        out[f"nms {m.group(1)}"] = float(m.group(2))
    for m in re.finditer(r"^roi_align_bwd (float32|bfloat16) .*?kernel "
                         r"([\d.]+) ms", text, re.M):
        out[f"roi_align_bwd {m.group(1)}"] = float(m.group(2))
    for ln in text.splitlines():
        if ln.startswith('{"kernels"'):
            for k in json.loads(ln)["kernels"]:
                out[f"{k['name']} ms"] = k["ms"]
    return out


def run(tree, kind, out_dir, tag):
    cmd = [a.replace("{call}", CALL) for a in RUNS[kind]]
    proc = subprocess.run([sys.executable, *cmd], cwd=tree,
                          capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": tree})
    with open(os.path.join(out_dir, f"{kind}_{tag}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise SystemExit(f"{kind} in {tree} exited {proc.returncode}")
    return readings(kind, proc.stdout)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default="build/alternate")
    ap.add_argument("--kinds", nargs="+", default=list(RUNS), choices=RUNS)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    trees = {"base": os.path.abspath(args.base), "change": CHANGE}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    got = {}
    for i in range(args.runs):
        order = ("base", "change") if i % 2 == 0 else ("change", "base")
        for kind in args.kinds:
            for side in order:
                r = run(trees[side], kind, args.out, f"{side}_{i}")
                print(f"run {i} {kind} {side}: {json.dumps(r)}", flush=True)
                for k, v in r.items():
                    got.setdefault((k, side), []).append(v)
    print(f"card {card}; {args.runs} runs each, alternated")
    for (k, side), v in sorted(got.items()):
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        print(f"{k} {side}: median {med:.4f}, quartiles {q1:.4f}-{q3:.4f}, "
              f"runs {', '.join(f'{x:.4f}' for x in v)}")


if __name__ == "__main__":
    main()
