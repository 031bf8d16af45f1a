"""Learning-rate schedules (counterpart of simpledet_tpu/core/schedule.py):
multi-factor step decay with constant or gradual warmup, `sequential`
chaining, the `advanced` cosine, linear and poly decays with optax's
formulas, the chain that `detection_train.py` builds from a config
(`from_optimize_param`), and the reference's multi-worker scaling rules.

A schedule is a function of the step count before the update, as optax reads
it: the first step runs at schedule(0).
"""
import math


def apply_dp_scaling(lr, lr_iter, warmup_iter, num_workers, total_iter=None,
                     warmup_in_pct=False):
    """The reference's multi-worker linear-scaling rules: base lr times
    num_workers; negative lr_iter entries count back from total_iter;
    lr_iter // num_workers; warmup iter // num_workers when warmup.in_pct is
    set. Returns (scaled_lr, scaled_lr_iter, scaled_warmup_iter)."""
    num_workers = max(int(num_workers), 1)
    lr_iter = list(lr_iter or [])
    if total_iter is not None:
        lr_iter = [total_iter + it if it < 0 else it for it in lr_iter]
    lr_iter = [it // num_workers for it in lr_iter]
    if warmup_in_pct and warmup_iter:
        warmup_iter = warmup_iter // num_workers
    return lr * num_workers, lr_iter, warmup_iter


def warmup_multifactor(base_lr, lr_iters, factor=0.1, warmup_type="gradual",
                       warmup_lr=None, warmup_iter=0):
    """step -> lr: base_lr times factor at each of lr_iters; before
    warmup_iter, warmup_lr (constant) or a line from warmup_lr to base_lr
    (gradual). warmup_lr defaults to base_lr / 3."""
    def sched(step):
        lr = base_lr
        for it in lr_iters:
            if step >= it:
                lr = lr * factor
        if warmup_iter > 0 and step < warmup_iter:
            wlr = warmup_lr if warmup_lr is not None else base_lr / 3.0
            if warmup_type == "constant":
                return wlr
            return wlr + (base_lr - wlr) * (step / max(warmup_iter, 1))
        return lr
    return sched


def sequential(schedules, boundaries):
    """Chain schedules: from boundaries[i] on, schedules[i + 1] of the steps
    since that boundary."""
    def sched(step):
        lr = schedules[0](step)
        for s, b in zip(schedules[1:], boundaries):
            if step >= b:
                lr = s(step - b)
        return lr
    return sched


def advanced(base_lr, total_iter, mode="cosine"):
    """Decay from base_lr over max(total_iter, 1) steps, then hold: optax's
    cosine_decay_schedule (alpha 0), linear_schedule to 0, or
    polynomial_schedule to 0 with power 2."""
    n = max(total_iter, 1)
    if mode == "cosine":
        return lambda step: base_lr * (
            0.5 * (1 + math.cos(math.pi * min(step, n) / n)))
    power = {"linear": 1, "poly": 2.0}.get(mode)
    if power is None:
        raise NotImplementedError(mode)
    return lambda step: base_lr * (1 - min(max(step, 0), n) / n) ** power


def from_optimize_param(opt, iter_per_epoch, num_hosts=1):
    """The schedule `detection_train.py::train_net` builds from a config's
    OptimizeParam (nothrow): dp scaling by the number of hosts (train_net
    scales by jax.process_count(), one process per host; the port runs one
    process per device, so the caller passes `parallel.dist.host_count()`),
    then either warmup followed by the `lr_mode` decay over the rest of the
    run, or warmup with multi-factor steps."""
    total_iter = iter_per_epoch * (opt.schedule.end_epoch or 1)
    base_lr, lr_iter, warm_iter = apply_dp_scaling(
        opt.optimizer.lr, opt.schedule.lr_iter or [], opt.warmup.iter or 0,
        num_hosts, total_iter=total_iter,
        warmup_in_pct=bool(opt.warmup.in_pct))
    warm = dict(warmup_type=opt.warmup.type or "gradual",
                warmup_lr=opt.warmup.lr, warmup_iter=warm_iter)
    if opt.schedule.lr_mode:
        return sequential(
            [warmup_multifactor(base_lr, [], **warm),
             advanced(base_lr, max(total_iter - warm_iter, 1),
                      mode=opt.schedule.lr_mode)], [warm_iter])
    return warmup_multifactor(base_lr, lr_iter, **warm)
