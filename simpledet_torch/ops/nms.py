"""Greedy NMS on statically shaped, batched tensors.

Counterpart of `simpledet_tpu/ops/nms.py::nms`, batched over a leading
problem axis so that every problem of a call shares one kernel launch. The
order is a stable descending sort (as `jnp.argsort(-s)` is stable), the keep
mask comes from `kernels/nms.py`, and kept rows are compacted to the front.
Padded outputs carry score NEG_INF, index -1 and zero boxes.
"""
import torch

from simpledet_torch.kernels.nms import nms_keep_sorted

NEG_INF = -1e10


def top_k_stable(x, k):
    """(values, indices) of the k largest entries along the last axis, ties
    broken by the lower index as `lax.top_k` breaks them."""
    idx = torch.argsort(x, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(x, -1, idx), idx


def nms(boxes, scores, thr, max_out, valid=None):
    """boxes [P, N, 4], scores [P, N], valid [P, N] bool ->
    (boxes [P, max_out, 4], scores [P, max_out], idx [P, max_out] into the
    input, valid_out [P, max_out]), each problem ordered by score."""
    p, n = scores.shape
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    neg = torch.full_like(scores, NEG_INF)
    masked = torch.where(valid, scores, neg)
    order = torch.argsort(-masked, dim=1, stable=True)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(p, n, 4))
    svalid = torch.gather(valid, 1, order)
    keep = nms_keep_sorted(sboxes, svalid, thr)

    kept_scores = torch.where(keep, torch.gather(masked, 1, order), neg)
    if max_out > n:
        pad = max_out - n
        kept_scores = torch.nn.functional.pad(kept_scores, (0, pad),
                                              value=NEG_INF)
        sboxes = torch.nn.functional.pad(sboxes, (0, 0, 0, pad))
        order = torch.nn.functional.pad(order, (0, pad), value=-1)
    take = torch.argsort(-kept_scores, dim=1, stable=True)[:, :max_out]
    out_boxes = torch.gather(sboxes, 1, take[..., None].expand(p, max_out, 4))
    out_scores = torch.gather(kept_scores, 1, take)
    out_valid = out_scores > NEG_INF / 2
    out_idx = torch.where(out_valid, torch.gather(order, 1, take),
                          torch.full_like(take, -1))
    out_boxes = torch.where(out_valid[..., None], out_boxes,
                            torch.zeros_like(out_boxes))
    in_scores = torch.gather(scores, 1, out_idx.clamp(min=0))
    return (out_boxes, torch.where(out_valid, in_scores,
                                   torch.full_like(in_scores, NEG_INF)),
            out_idx, out_valid)
