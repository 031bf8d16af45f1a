"""Equal step counts across data-parallel ranks, on the CPU.

Each rank loads its own shard of the roidb (the remainder of the split to
the low ranks) and groups it by aspect, so shards can differ in batch count;
a rank with a batch more would enter DDP's and SyncBN's all_reduce alone and
block. The loader computes every rank's count from the whole roidb and
runs the least of them on every rank (`data/loader.py`, which
`detection_train.train_net` uses).

- the counts: shards of 11 records on 2 ranks, of flipped roidbs on 3
  ranks; every rank's loader yields the least count;
- `train_net` on 2 gloo ranks (`parallel.dist.launch_local`) over 5 records
  at batch 1: shards of 3 and 2 records, 3 and 2 batches an epoch. With the
  flips appended, two ranks' shards would be the originals and their mirror
  images, whose counts are always equal, so the ranks train without them.
  Both ranks run 2 steps an epoch for 2 epochs, the same schedule (the
  config's lr_mode is cosine, whose length is iter_per_epoch times the
  epochs), the same SyncBN running statistics, and log how many batches
  each drops. The module imports no JAX: the ranks import it.
"""
import os
import re

import numpy as np
import pytest
import torch

from simpledet_torch.data.loader import Loader, rank_batch_counts
from simpledet_torch.parallel import dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RECORDS, EPOCHS = 5, 2


def records(n, rng):
    return [{"im_id": i, "h": 100, "w": 100 + int(rng.choice([-20, 20]))}
            for i in range(n)]


def test_rank_counts_from_the_whole_roidb():
    """11 records at batch 1 on 2 ranks give shards of 6 and 5 records;
    a flipped roidb of 7 images at batch 2 on 3 ranks gives shards of 5, 5
    and 4 records whose aspect groups round up on their own. Every rank's
    loader yields the least count, and says how many it drops."""
    rng = np.random.RandomState(0)
    roidb = records(11, rng)
    assert rank_batch_counts(roidb, 1, 2) == [6, 5]
    flipped = records(7, rng)
    flipped = flipped + [dict(r, flipped=True) for r in flipped]
    counts = rank_batch_counts(flipped, 2, 3)
    assert len(set(counts)) > 1, counts
    for rank in range(3):
        loader = Loader(list(flipped), [], 2, rank=rank, num_ranks=3,
                        num_workers=0)
        assert loader.rank_counts == counts
        assert len(loader) == min(counts) == len(loader._batches())
        assert loader.dropped == counts[rank] - min(counts)


def rank_main(workdir, config):
    """One rank: train_net over the records without their flips; torch.save
    of its step count, losses, schedule and running statistics."""
    from simpledet_torch import detection_train
    from simpledet_torch.core.checkpoint import batch_stats_to_flax

    os.chdir(workdir)
    detection_train.append_flipped = lambda roidb: roidb
    history = []
    trainer = detection_train.train_net(config, device="cpu",
                                        loss_history=history, seed=0)
    r = dist.rank()
    torch.save(dict(steps=trainer.step_count, history=history,
                    lr=[trainer.schedule(s) for s in range(8)],
                    stats=batch_stats_to_flax(trainer.model)),
               os.path.join(workdir, f"rank{r}.pt"))
    dist.destroy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results and outputs: config/converge_test.py (depth-18
    FPN, SyncBN) with a cosine lr_mode, on N_RECORDS synthetic images."""
    from simpledet_torch.data.synthetic import make_micro_dataset

    work = tmp_path_factory.mktemp("ddp_steps")
    src = open(os.path.join(REPO, "config", "converge_test.py")).read()
    marker = "            iter_per_epoch = None"
    assert marker in src
    os.makedirs(work / "config")
    config = str(work / "config" / "converge_test.py")
    with open(config, "w") as f:
        f.write(src.replace(marker, '            lr_mode = "cosine"\n'
                            + marker))
    make_micro_dataset(str(work / "data"), n_images=N_RECORDS,
                       set_names=("converge_train",))
    code = ("import sys; sys.path.insert(0, {!r}); import test_torch_ddp_steps;"
            " test_torch_ddp_steps.rank_main({!r}, {!r})").format(
                os.path.join(REPO, "tests"), str(work), config)
    outs = dist.launch_local(code, 2, timeout=300, env=dict(
        PYTHONPATH=REPO, CONVERGE_DATA_ROOT=str(work / "data"),
        CONVERGE_BATCH="1", CONVERGE_EPOCHS=str(EPOCHS),
        CONVERGE_WARMUP="2"))
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return ranks, outs


def test_ranks_with_unequal_shards_run_equal_steps(runs):
    ranks, outs = runs
    assert [r["steps"] for r in ranks] == [2 * EPOCHS] * 2
    assert [len(r["history"]) for r in ranks] == [2 * EPOCHS] * 2
    assert all(np.isfinite(h["total_loss"]) for r in ranks
               for h in r["history"])
    drops = []
    for out in outs:
        m = re.search(r"batches an epoch by rank \[(\d+), (\d+)\]: each rank "
                      r"runs (\d+), this rank drops (\d+)", out)
        assert m, out[-2000:]
        drops.append(tuple(int(v) for v in m.groups()))
    assert drops == [(3, 2, 2, 1), (3, 2, 2, 0)]
    assert outs[0].count("iter_per_epoch 2,") == 1
    assert outs[1].count("iter_per_epoch 2,") == 1


def test_ranks_share_the_schedule_and_the_statistics(runs):
    """The same lr at every step (a cosine over 2 x 2 steps: a rank that
    counted its own 3 batches would decay over 6) and the same SyncBN
    running statistics: the ranks took part in the same all_reduces."""
    (r0, r1), _ = runs
    assert r0["lr"] == r1["lr"]
    assert r0["lr"][4] == r0["lr"][7] == 0.0 < r0["lr"][3]
    stats0, stats1 = (dict(_flat(r["stats"])) for r in (r0, r1))
    assert stats0 and set(stats0) == set(stats1)
    for k, v in stats0.items():
        np.testing.assert_array_equal(v, stats1[k], err_msg=k)
    for a, b in zip(r0["history"], r1["history"]):
        assert a == b


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)
