"""Train a detector from a config on its roidb (counterpart of
`detection_train.py::train_net`).

    python -m simpledet_torch.detection_train --config config/<name>.py \
        [--max-iter N] [--resume] [--device cpu]
    torchrun --nproc_per_node N -m simpledet_torch.detection_train \
        --config config/<name>.py [--device cpu]

The flow is train_net's: the config's roidb, keeping the images with gt and
appending their flips; the threaded loader with the config's own transforms
and label keys (a Mask R-CNN config's include gt_poly, the polygon edges),
sharded by rank, every rank running the least rank's batch count an epoch
(`data/loader.py`: a rank with a batch more would enter DDP's and SyncBN's
all_reduce alone); the pretrain (`ModelParam.pretrain.prefix`, matched by
Flax path and shape) unless the config trains from scratch, or with
--resume the newest checkpoint and its SyncBN running statistics; the
config's schedule, scaled by the number of hosts as train_net scales it by
processes; the
steps, with the config's metrics and the losses in a Speedometer line every
`General.log_frequency` steps; and `experiments/<name>/checkpoint-%04d.params`
(plus `.batch_stats` for SyncBN) at each epoch end (every
`General.checkpoint_period` epochs, always at the last one and where
--max-iter stops the run), in the JAX package's format, beside the port's
own `.torch_states`; rank 0 writes them and the log file.

Under torchrun (WORLD_SIZE in the environment) each rank joins the process
group (`parallel/dist.py`: NCCL on the card, gloo with --device cpu), drives
one device and trains in DDP on its shard of each global batch of
`General.batch_image` images a rank. Runs on the card unless --device cpu is
given.

Not ported: remat, QAT, KD teachers, iteration checkpoints, the profiler
window, summaries and the DetailSpeedometer; a config that asks for one
raises NotImplementedError naming it. `python -m simpledet_torch.train`
stays the timer on synthetic data.
"""
import argparse
import os
import time

import torch

from simpledet_torch.core.checkpoint import (foreign_states,
                                             get_latest_ckpt_epoch,
                                             load_batch_stats,
                                             load_checkpoint, load_pretrain,
                                             save_checkpoint)
from simpledet_torch.core.config import read_config
from simpledet_torch.core.metrics import from_config as metrics_from_config
from simpledet_torch.core.train import Trainer
from simpledet_torch.data.loader import Loader
from simpledet_torch.data.roidb import append_flipped, load_roidb
from simpledet_torch.data.transforms import from_config
from simpledet_torch.dsl import build_detector
from simpledet_torch.logger import config_logger
from simpledet_torch.parallel import dist

# train_net's sampling key is PRNGKey(42); the port seeds its samplers' torch
# generator with the same number
SAMPLING_SEED = 42


def _refuse_unported(spec):
    general, model = spec.general, spec.model
    for owner, attrs in ((general, ("checkpoint_iter", "profile", "summary",
                                    "detail_log")),
                         (model, ("memonger", "memonger_budget_gb",
                                  "quantize_flag", "QuantizeTrainingParam",
                                  "teacher_param"))):
        for a in attrs:
            if getattr(owner, a):
                raise NotImplementedError(f"{a} is not ported")


def train_net(config_path, max_iter_override=None, auto_resume=False, *,
              device="cuda", loss_history=None, seed=None):
    """Train as the config says; returns the Trainer. loss_history, when
    given, is a list that gets each step's losses (averaged over the
    process group) as {name: float}. seed seeds the weights' init; None
    takes train_net's rule: the time when ModelParam.random is set, else 0.
    Under torchrun's environment this process is one rank of the group."""
    device = dist.init_from_env(device)
    spec = read_config(config_path, is_train=True)
    _refuse_unported(spec)
    general, model_p, opt = spec.general, spec.model, spec.optimize
    exp_dir = os.path.join("experiments", spec.name)
    logger = config_logger(exp_dir if dist.rank() == 0 else None)
    logger.info(f"config: {config_path}")
    n_rank = dist.world_size()
    global_batch = general.batch_image * n_rank
    logger.info(f"rank {dist.rank()} of {n_rank} ({dist.host_count()} "
                f"host(s)), global batch {global_batch}")

    roidb = load_roidb(spec.dataset.image_set,
                       spec.dataset.cache_dir or "data/cache")
    roidb = [r for r in roidb if len(r.get("gt_bbox", []))]
    roidb = append_flipped(roidb)
    logger.info(f"{len(roidb)} records (with flips)")
    keys = tuple(dict.fromkeys(["data", "im_info", "gt_bbox"]
                               + list(spec.label_name)))
    loader = Loader(roidb, from_config(spec.transform), general.batch_image,
                    shuffle=True, num_workers=general.loader_worker or 8,
                    rank=dist.rank(), num_ranks=n_rank, keys=keys)
    if n_rank > 1:
        logger.info(f"batches an epoch by rank {loader.rank_counts}: each "
                    f"rank runs {len(loader)}, this rank drops "
                    f"{loader.dropped}")

    if seed is None:
        seed = int(time.time()) if model_p.random else 0
    model = build_detector(spec)
    model.init_weights(torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"{n_params / 1e6:.1f}M params, {device}")

    begin_epoch = opt.schedule.begin_epoch or 0
    end_epoch = opt.schedule.end_epoch
    prefix = os.path.join(exp_dir, "checkpoint")
    if auto_resume:
        latest = get_latest_ckpt_epoch(prefix)
        if latest is not None:
            begin_epoch = max(begin_epoch, latest)
    iter_per_epoch = opt.schedule.iter_per_epoch or max(len(loader), 1)
    trainer = Trainer.from_spec(model, spec, iter_per_epoch,
                                seed=SAMPLING_SEED)
    if begin_epoch > 0:
        step = load_checkpoint(prefix, begin_epoch, model, trainer.optimizer)
        if load_batch_stats(prefix, begin_epoch, model):
            logger.info("restored SyncBN running statistics")
        jax_states = foreign_states(prefix, begin_epoch)
        if jax_states:
            logger.info(f"{jax_states} is the JAX package's optimizer state, "
                        "not the port's: ignored; the optimizer restarts")
        # without saved optimizer state: a fresh optimizer, the schedule
        # fast-forwarded so that warmup is not replayed
        trainer.step_count = (step if step is not None
                              else begin_epoch * iter_per_epoch)
        logger.info(f"resumed from epoch {begin_epoch}"
                    + (" (with optimizer state)" if step is not None else
                       f" (fresh optimizer, schedule at step "
                       f"{trainer.step_count})"))
    elif not model_p.from_scratch:
        try:
            n_hit = load_pretrain(model, model_p.pretrain.prefix,
                                  model_p.pretrain.epoch or 0)
            logger.info(f"loaded pretrain ({n_hit} tensors)")
        except FileNotFoundError:
            logger.info("no pretrain found, training from random init")
    logger.info(f"iter_per_epoch {iter_per_epoch}, lr at step "
                f"{trainer.step_count} {trainer.schedule(trainer.step_count)}")

    log_freq = general.log_frequency or 10
    period = general.checkpoint_period or 1
    metrics = metrics_from_config(spec.metric_list)
    steps_this_run = 0
    tic = time.perf_counter()

    def stop():
        return bool(max_iter_override) and steps_this_run >= max_iter_override

    for epoch in range(begin_epoch, end_epoch):
        logger.info(f"starting epoch {epoch}")
        for batch in loader:
            losses = trainer.step(batch["data"], batch["im_info"],
                                  batch["gt_bbox"], batch.get("gt_poly"))
            steps_this_run += 1
            # the metrics read the aux and the losses (ScalarLoss reads
            # mask_loss), as train_net's do
            metrics.update({k: v.cpu().numpy() for k, v in
                            {**trainer.aux, **losses}.items()})
            if loss_history is not None:
                loss_history.append({k: float(v) for k, v in losses.items()})
            if trainer.step_count % log_freq == 0:
                # train_net's Speedometer line: samples/s of the global
                # batch, the lr of the last step, the metrics since the
                # last line, then the losses
                speed = log_freq * global_batch / (time.perf_counter() - tic)
                lr = trainer.schedule(trainer.step_count - 1)
                logger.info(
                    f"Epoch[{epoch}] Batch [{trainer.step_count}]\t"
                    f"Speed: {speed:.2f} samples/sec\tlr: {lr:.6f}\t"
                    + "\t".join(f"{k}={v:.5f}" for k, v in metrics.get())
                    + "\t" + "\t".join(f"{k}={float(v):.5f}"
                                        for k, v in losses.items()))
                metrics.reset()
                tic = time.perf_counter()
            if stop():
                break
        if (epoch + 1) % period == 0 or epoch + 1 == end_epoch or stop():
            save_checkpoint(prefix, epoch + 1, model, trainer.optimizer,
                            trainer.step_count)
            logger.info(f"saved checkpoint epoch {epoch + 1}")
        if stop():
            break
    logger.info("training done")
    return trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--max-iter", type=int, default=None,
                    help="stop early (smoke tests)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in experiments/")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        return train_net(args.config, args.max_iter,
                         auto_resume=args.resume, device=args.device)
    finally:
        dist.destroy()


if __name__ == "__main__":
    main()
