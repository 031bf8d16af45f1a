"""Static-shape random subsampling (counterpart of
simpledet_tpu/targets/sampling.py).

"Choose k of the set bits at random" is a top-k over masked random
priorities. Priorities come from `torch.rand` on the caller's generator (the
JAX package draws them from jax.random, so the two never give the same
choice from one seed); `deterministic=True` gives `arange` priorities instead,
which keep the highest-indexed candidates as the JAX package's deterministic
mode does. Every sort whose ties can change a choice is stable, as
`jnp.argsort` and `lax.top_k` are.
"""
import torch

from simpledet_torch.ops.nms import top_k_stable


def _priorities(gen, n, deterministic, device):
    if deterministic:
        return torch.arange(n, dtype=torch.float32, device=device)
    return torch.rand(n, generator=gen, device=device)


def _masked_priorities(gen, mask, deterministic):
    prio = _priorities(gen, mask.shape[0], deterministic, mask.device)
    return torch.where(mask, prio, torch.full_like(prio, -float("inf")))


def _scatter(n, idx, values):
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    out[idx] = values
    return out


def random_topk_mask(gen, mask, k, deterministic=False):
    """Select min(k, sum(mask)) elements of `mask` uniformly at random;
    returns a bool mask of the selected elements."""
    n = mask.shape[0]
    _, idx = top_k_stable(_masked_priorities(gen, mask, deterministic), k)
    return _scatter(n, idx, torch.ones_like(idx, dtype=torch.bool)) & mask


def random_rank(gen, mask, deterministic=False):
    """Random rank (0 = first chosen) of each set element of mask; unset
    elements get rank n."""
    n = mask.shape[0]
    order = torch.argsort(-_masked_priorities(gen, mask, deterministic),
                          stable=True)
    rank = _scatter(n, order, torch.arange(n, dtype=torch.int64,
                                           device=mask.device))
    return torch.where(mask, rank, torch.full_like(rank, n))


def subsample_labels(gen, label, num_sample, fg_fraction, deterministic=False,
                     return_fg_idx=False):
    """label [N] in {1: fg, 0: bg, -1: ignore}: keep at most
    int(fg_fraction * num_sample) positives at random (the rest -> -1), then
    at most num_sample - kept_fg backgrounds. With return_fg_idx, also the
    kept positives' indices [num_fg], padded with N."""
    num_fg = int(fg_fraction * num_sample)
    n = label.shape[0]
    neg1 = torch.full_like(label, -1.0)

    fg_mask = label == 1
    vals_fg, idx_fg = top_k_stable(
        _masked_priorities(gen, fg_mask, deterministic), num_fg)
    sel_fg = torch.isfinite(vals_fg)
    keep_fg = _scatter(n, idx_fg, sel_fg) & fg_mask
    label = torch.where(fg_mask & ~keep_fg, neg1, label)

    num_bg = num_sample - (label == 1).sum()
    bg_mask = label == 0
    vals, idx = top_k_stable(_masked_priorities(gen, bg_mask, deterministic),
                             num_sample)
    pos = torch.arange(num_sample, device=label.device)
    keep_bg = _scatter(n, idx, (pos < num_bg) & torch.isfinite(vals))
    label = torch.where(bg_mask & ~keep_bg, neg1, label)
    if return_fg_idx:
        return label, torch.where(sel_fg, idx_fg, torch.full_like(idx_fg, n))
    return label
