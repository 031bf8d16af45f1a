"""Learning-rate schedules (counterpart of simpledet_tpu/core/schedule.py):
multi-factor step decay with constant or gradual warmup, and the
reference's multi-worker scaling rules.

A schedule is a function of the step count before the update, as optax reads
it: the first step runs at schedule(0).
"""


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
