"""Cross-level proposal selection (counterpart of
simpledet_tpu/targets/proposal.py::top_proposals)."""
import torch

from simpledet_torch.ops.nms import NEG_INF, top_k_stable


def top_proposals(boxes, scores, top_n):
    """boxes [B, K, 4], scores [B, K] (padding carries NEG_INF) ->
    (boxes [B, top_n, 4], scores [B, top_n]); padding rows get zero boxes."""
    top_scores, idx = top_k_stable(scores, top_n)
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    ok = top_scores > NEG_INF / 2
    return torch.where(ok[..., None], top_boxes,
                       torch.zeros_like(top_boxes)), top_scores
