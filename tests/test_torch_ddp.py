"""Data-parallel training on the CPU: two gloo ranks against one process.

Two ranks, launched with torchrun's environment (`parallel.dist.launch_local`)
through `init_from_env("cpu")`, train `config/converge_test.py`'s detector
(depth-18 bottleneck FPN, SyncBN) in DDP for 2 steps, each on 2 of 4
different records; one process trains the same detector on all 4. The
records differ and so do the ranks' valid-anchor counts (record 3's image is
40 x 48 inside the 128 x 192 batch), so a per-rank RPN normaliser would
differ from the global one. Sampling runs on `arange` priorities and
proposals come from the gt (`deterministic_sampling`, `fixed_proposals`), so
each record's samples do not depend on its rank.

Held: the losses (1e-5 relative), every gradient of the first step (1e-4
of its leaf's max |grad|, as for the JAX comparisons), SyncBN's running
statistics after each step (1e-5), the parameters after 2 steps (1e-4 of
each leaf's scale) and their updates (1e-2, as in
tests/test_torch_syncbn.py, or 1e-6 of the parameter's scale, where an
update is a few float32 ulps of its parameter: the betas' first updates);
that only rank 0 writes a checkpoint; that the loader's shards are disjoint
and cover the records; that 2 ranks on one host leave the lr unscaled.
SyncBN's betas start at 3 (tests/test_torch_syncbn.py says why). The
module imports no JAX: the ranks import it.
"""
import os

import numpy as np
import pytest
import torch

from simpledet_torch.parallel import dist
from tmp_cleanup import collect_tmp_path, module_tmp_dirs  # noqa: F401

CONFIG = "config/converge_test.py"
STEPS, H, W = 2, 128, 192
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def records():
    """(images [4, H, W, 3] uint8, im_info [4, 3], gt [4, 10, 5]) from a
    seed: four different images and boxes; record 3 is a 40 x 48 image."""
    rng = np.random.RandomState(7)
    images = rng.randint(0, 256, (4, H, W, 3), dtype=np.uint8)
    im_info = np.float32([[H, W, 1], [120, 180, 1], [H, W, 1], [40, 48, 1]])
    gt = np.full((4, 10, 5), -1, np.float32)
    gt[0, :2] = [[10, 12, 60, 70, 1], [80, 20, 150, 90, 3]]
    gt[1, :3] = [[20, 10, 90, 60, 2], [0, 30, 50, 79, 1],
                 [100, 50, 170, 110, 2]]
    gt[2, :1] = [[30, 30, 120, 100, 3]]
    gt[3, :1] = [[4, 6, 36, 38, 1]]
    return images, im_info, gt


def build(seed=0):
    """The converge config's train detector and its Trainer (the config's
    optimizer and schedule), seeded, SyncBN's betas at 3."""
    from simpledet_torch.core.config import read_config
    from simpledet_torch.core.train import Trainer
    from simpledet_torch.dsl import build_detector
    from simpledet_torch.models.norm import SyncBN

    spec = read_config(os.path.join(REPO, CONFIG), is_train=True)
    model = build_detector(spec)
    model.init_weights(torch.Generator().manual_seed(seed))
    model.fixed_proposals = model.deterministic_sampling = True
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SyncBN):
                m.beta.fill_(3.0)
    model = model.to(memory_format=torch.channels_last).train()
    return Trainer.from_spec(model, spec, 4), spec


def train(trainer, rows):
    """STEPS steps on the records `rows`: per step the losses, the valid
    anchors of this process and the running statistics; the gradients of the
    first step (both sides at the same parameters); the parameters after the
    last step."""
    from simpledet_torch.core.checkpoint import batch_stats_to_flax

    images, im_info, gt = records()
    model = trainer.model
    out = {"losses": [], "n_valid": [], "stats": []}
    for step in range(STEPS):
        losses = trainer.step(torch.from_numpy(images[rows]),
                              torch.from_numpy(im_info[rows]),
                              torch.from_numpy(gt[rows]))
        out["losses"].append({k: float(v) for k, v in losses.items()})
        out["n_valid"].append(int((trainer.aux["rpn_label"] >= 0).sum()))
        out["stats"].append(batch_stats_to_flax(model))
        if step == 0:
            out["grads"] = {n: p.grad.clone()
                            for n, p in model.named_parameters()}
    out["params"] = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
    return out


def rank_main(out_dir):
    """One rank: the DDP steps on its 2 records, a checkpoint, its loader
    shard and its schedule; torch.save of what it saw."""
    from simpledet_torch.core.checkpoint import save_checkpoint
    from simpledet_torch.data.loader import Loader

    dist.init_from_env("cpu")
    r, n = dist.rank(), dist.world_size()
    trainer, _ = build()
    result = train(trainer, [2 * r, 2 * r + 1])
    save_checkpoint(os.path.join(out_dir, f"rank{r}", "checkpoint"), 1,
                    trainer.model, trainer.optimizer, trainer.step_count)
    shard = Loader([{"im_id": i} for i in range(11)], [], 1, rank=r,
                   num_ranks=n, shuffle=False, num_workers=0)
    result.update(rank=r, world=n, hosts=dist.host_count(),
                  ddp=type(trainer.forward_model).__name__,
                  shard=[rec["rec_id"] for rec in shard.roidb],
                  lr=[trainer.schedule(s) for s in (0, 30, 60, 320)])
    torch.save(result, os.path.join(out_dir, f"rank{r}.pt"))
    dist.destroy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, module_tmp_dirs):
    out = tmp_path_factory.mktemp("ddp")
    module_tmp_dirs.append(out)
    code = ("import sys; sys.path.insert(0, {!r}); import test_torch_ddp; "
            "test_torch_ddp.rank_main({!r})").format(
                os.path.join(REPO, "tests"), str(out))
    dist.launch_local(code, 2, env={"PYTHONPATH": REPO})
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    trainer, _ = build()
    single = train(trainer, [0, 1, 2, 3])
    single["lr"] = [trainer.schedule(s) for s in (0, 30, 60, 320)]
    return out, ranks, single


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def test_ranks_ran_in_ddp_on_different_records(runs):
    _, ranks, single = runs
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["world"] == 2 and r["ddp"] == "DistributedDataParallel"
               for r in ranks)
    for step in range(STEPS):
        counts = [r["n_valid"][step] for r in ranks]
        assert counts[0] != counts[1], counts     # the normaliser trap shows
        assert sum(counts) == single["n_valid"][step]


def test_losses_match_one_process(runs):
    """Each rank reports the global batch's losses, the 1-process losses."""
    _, ranks, single = runs
    for step in range(STEPS):
        want = single["losses"][step]
        for r in ranks:
            assert set(r["losses"][step]) == set(want)
            for k, v in want.items():
                assert rel_err(r["losses"][step][k], v) <= 1e-5, (step, k)


def test_every_gradient_matches_one_process(runs):
    """DDP's averaged gradients of the first step, the same on both ranks,
    within 1e-4 of each leaf's max |grad| of the 1-process step (bn0's beta,
    0 up to rounding, within 1e-6 of the largest |grad|). The first step's:
    after an update the two sides' parameters differ by float32 rounding,
    and a ReLU input within it of 0 moves a batch-normalised gradient by
    1e-3 (measured 2e-3 at the second step)."""
    _, ranks, single = runs
    want = single["grads"]
    scale = max(float(g.abs().max()) for g in want.values())
    for r in ranks:
        assert set(r["grads"]) == set(want)
        for name, g in want.items():
            if name == "backbone.bn0.beta":
                assert float(r["grads"][name].abs().max()) <= 1e-6 * scale
                continue
            assert rel_err(r["grads"][name], g) <= 1e-4, name
    for name in want:
        assert torch.equal(ranks[0]["grads"][name], ranks[1]["grads"][name])


def test_syncbn_statistics_span_the_global_batch(runs):
    """After each step the running statistics equal the 1-process ones on
    4 records (not the EMA of a rank's 2), within 1e-5 of each leaf's max."""
    _, ranks, single = runs
    from simpledet_torch.core.checkpoint import flatten

    for step in range(STEPS):
        want = flatten(single["stats"][step])
        assert len(want) == 58
        for r in ranks:
            got = flatten(r["stats"][step])
            for k, v in want.items():
                assert rel_err(got[k], v) <= 1e-5, (step, k)


def test_two_step_trajectory_matches_one_process(runs):
    _, ranks, single = runs
    trainer, _ = build()
    start = {n: p.detach() for n, p in trainer.model.named_parameters()}
    for r in ranks:
        for name, want in single["params"].items():
            got = r["params"][name]
            assert rel_err(got, want) <= 1e-4, name
            moved = (want - start[name]).abs().max()
            err = ((got - want).abs().max()
                   / max(moved, 1e-4 * want.abs().max(), 1e-12))
            assert err <= 1e-2, name


def test_only_rank0_writes_a_checkpoint(runs):
    out = runs[0]
    names = sorted(os.listdir(out / "rank0"))
    assert names == ["checkpoint-0001.batch_stats", "checkpoint-0001.params",
                     "checkpoint-0001.torch_states"]
    assert not (out / "rank1").exists()


def test_loader_shards_are_disjoint_and_complete(runs):
    shards = [set(r["shard"]) for r in runs[1]]
    assert shards[0].isdisjoint(shards[1])
    assert shards[0] | shards[1] == set(range(11))
    assert sorted(len(s) for s in shards) == [5, 6]


def test_two_ranks_on_one_host_leave_the_lr_unscaled(runs):
    """The JAX package scales by processes, one per host: 2 ranks on one
    host are 1 host, so the schedule is the 1-process one."""
    _, ranks, single = runs
    for r in ranks:
        assert r["hosts"] == 1
        assert r["lr"] == single["lr"]


def test_lr_scales_by_hosts_as_the_jax_package(monkeypatch):
    """WORLD_SIZE 4 with LOCAL_WORLD_SIZE 2 is 2 hosts: the schedule is
    train_net's with apply_dp_scaling(..., 2)."""
    from simpledet_tpu.core.schedule import apply_dp_scaling as j_scaling
    from simpledet_torch.core.config import read_config
    from simpledet_torch.core.schedule import from_optimize_param

    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert dist.host_count() == 2
    opt = read_config(os.path.join(REPO, CONFIG), is_train=True).optimize
    total = 4 * opt.schedule.end_epoch
    lr, lr_iter, warm = j_scaling(opt.optimizer.lr, opt.schedule.lr_iter,
                                  opt.warmup.iter, 2, total_iter=total)
    assert (lr, lr_iter) == (2 * opt.optimizer.lr, [160, 200])
    sched = from_optimize_param(opt, 4, dist.host_count())
    assert sched(warm) == pytest.approx(lr)
    assert sched(lr_iter[0]) == pytest.approx(lr * 0.1)
    assert sched(lr_iter[0] - 1) == pytest.approx(lr)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert dist.host_count() == 1


def test_dryrun_multichip_two_ranks():
    """`dryrun_multichip(2)`: the flagship with a SyncBN backbone, full
    proposal and roi counts at 128 x 160, one DDP step a rank."""
    outs = dist.dryrun_multichip(2)
    assert len(outs) == 2 and all("total_loss" in o for o in outs)
