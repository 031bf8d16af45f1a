"""Train a from-scratch learning recipe (config/converge_*.py) several times
and print each run's loss trajectory and train-set APs: how often a recipe
diverges at a given lr.

    python -m simpledet_torch.converge_repeat --config config/converge_mask.py \
        [--runs N] [--lr LR] [--epochs E] [--batch 8] [--max-iter N] \
        [--device cpu]

Each run trains through the train CLI's train_net in a fresh temporary
directory that holds a copy of the config and 16 synthetic images (ellipses
for a config with a mask head, else rectangles), then evaluates the train
set through the test CLI (`mask_test` for a mask head). --lr, --epochs and
--batch set the recipe's <PREFIX>_LR / _EPOCHS / _BATCH overrides;
--max-iter stops each run early, as the train CLI's does. Training
on the card is not repeatable bit for bit, so the runs of one call differ.
Prints one line a run, `run {json}`: the step losses' first-20 and last-20
means, their means over each 40 steps, the largest and its step, and the
APs. Runs on the card unless --device cpu is given.
"""
import argparse
import json
import os
import re
import shutil
import tempfile
import time

import numpy as np

from simpledet_torch import detection_test, detection_train, mask_test
from simpledet_torch.core.config import read_config
from simpledet_torch.data.synthetic import make_micro_dataset
from simpledet_torch.infer import full_fp32


def env_prefix(config):
    """The recipe's override prefix: its PREFIX, else CONVERGE (as
    config/converge_test.py reads CONVERGE_LR and the like)."""
    with open(config) as f:
        m = re.search(r'^PREFIX = "(\w+)"', f.read(), re.M)
    return m.group(1) if m else "CONVERGE"


def summary(total, aps):
    """The run's line: total [steps] step losses, aps {name: AP}."""
    return dict(steps=len(total), first20=float(total[:20].mean()),
                last20=float(total[-20:].mean()),
                means40=[round(float(total[i:i + 40].mean()), 4)
                         for i in range(0, len(total), 40)],
                largest=float(total.max()), largest_at=int(total.argmax()),
                **aps)


def repeat(config, runs, *, lr=None, epochs=None, batch="8", max_iter=None,
           device="cuda"):
    """Train and evaluate `config` `runs` times; returns the runs' lines
    (`summary`'s, with the run's index, lr and seconds)."""
    config = os.path.abspath(config)
    prefix = env_prefix(config)
    masks = "mask_head" in read_config(config, is_train=True).components
    rel = os.path.join("config", os.path.basename(config))
    cwd, saved = os.getcwd(), dict(os.environ)
    tmp = tempfile.mkdtemp(prefix="converge_repeat_")
    out = []
    try:
        os.chdir(tmp)
        os.makedirs("config")
        shutil.copyfile(config, rel)
        make_micro_dataset(os.path.join(tmp, "data"), n_images=16,
                           set_names=("converge_train",),
                           shapes="ellipse" if masks else "rect")
        os.environ["CONVERGE_DATA_ROOT"] = os.path.join(tmp, "data")
        for key, v in (("LR", lr), ("EPOCHS", epochs), ("BATCH", batch)):
            if v is not None:
                os.environ[f"{prefix}_{key}"] = str(v)
        rate = read_config(rel, is_train=True).optimize.optimizer.lr
        for i in range(runs):
            shutil.rmtree("experiments", ignore_errors=True)
            history = []
            t0 = time.perf_counter()
            detection_train.train_net(rel, max_iter, device=device,
                                      loss_history=history)
            if masks:
                s = mask_test.mask_test_net(rel, device=device)
                aps = dict(box_AP=s["bbox"]["AP"], segm_AP=s["segm"]["AP"],
                           segm_AP50=s["segm"]["AP50"])
            else:
                s = detection_test.test_net(rel, device=device)
                aps = dict(AP=s["AP"], AP50=s["AP50"])
            total = np.array([h["total_loss"] for h in history])
            line = dict(run=i, lr=rate, seconds=time.perf_counter() - t0,
                        **summary(total, aps))
            print("run " + json.dumps(line), flush=True)
            out.append(line)
    finally:
        os.chdir(cwd)
        os.environ.clear()
        os.environ.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--lr", default=None)
    ap.add_argument("--epochs", default=None)
    ap.add_argument("--batch", default="8")
    ap.add_argument("--max-iter", type=int, default=None,
                    help="stop each run early (smoke tests)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    full_fp32()
    return repeat(args.config, args.runs, lr=args.lr, epochs=args.epochs,
                  batch=args.batch, max_iter=args.max_iter,
                  device=args.device)


if __name__ == "__main__":
    main()
