"""RepPoints point-set ops (counterpart of simpledet_tpu/ops/points.py).

The regular grid of a deformable conv's taps, the per-level location
points, offsets to points, points to boxes (minmax, partial_minmax,
moment), and the two target assignments: `point_assign` (each gt's nearest
points on the level its size picks) and `iou_assign` (IoU against the gts,
without the legacy +1). Both assignments run over a batch of images in one
set of operations: gt_boxes [B, G, 5] -> [B, N] labels and [B, N, 4] boxes.

Ties are broken as the JAX package breaks them: a stable argsort, then the
first index of a minimum or maximum. log2 is log(x) / log(2), as jnp.log2
computes it.
"""
import numpy as np
import torch

from simpledet_torch.ops.bbox import bbox_overlaps

INF = 1e10


def gen_dcn_offsets(dcn_kernel=3, dcn_pad=1):
    """[1, 1, 2*K*K] base (y, x) offsets of the regular conv grid."""
    base = np.arange(-dcn_pad, dcn_pad + 1, dtype=np.float32)
    yy = np.repeat(base, dcn_kernel)
    xx = np.tile(base, dcn_kernel)
    return np.stack([yy, xx], 1).reshape(1, 1, -1)


def gen_points(fh, fw, stride):
    """[fh*fw, 3] (x, y, stride) location points, each a cell's top-left
    corner (the reference's _gen_points)."""
    x = np.arange(fw, dtype=np.float32) * stride
    y = np.arange(fh, dtype=np.float32) * stride
    gx, gy = np.meshgrid(x, y)
    s = np.full_like(gx.reshape(-1), stride)
    return np.stack([gx.reshape(-1), gy.reshape(-1), s], 1)


def offset_to_pts(center, pred, stride, num_points):
    """center [N, 3], pred [..., N, 2*num_points] (y-first pairs), stride a
    number or [N, 1] -> pts [..., N, 2*num_points] (x-first pairs) in image
    coordinates."""
    xy = center[:, :2].repeat(1, num_points)
    p = pred.reshape(pred.shape[:-1] + (num_points, 2)).flip(-1)
    return p.reshape(pred.shape) * stride + xy


def points2bbox(pts, transform="minmax", y_first=True, moment_transfer=None):
    """pts [..., 2*n] -> boxes [..., 4]: minmax, partial_minmax (the first 4
    points) or moment (the points' mean and std, the std scaled by
    exp(moment_transfer))."""
    p = pts.reshape(pts.shape[:-1] + (pts.shape[-1] // 2, 2))
    if y_first:
        py, px = p[..., 0], p[..., 1]
    else:
        px, py = p[..., 0], p[..., 1]
    if transform in ("minmax", "partial_minmax"):
        if transform == "partial_minmax":
            px, py = px[..., :4], py[..., :4]
        return torch.stack([px.amin(-1), py.amin(-1), px.amax(-1),
                            py.amax(-1)], -1)
    if transform == "moment":
        mx = px.mean(-1)
        my = py.mean(-1)
        sx = torch.sqrt(((px - mx[..., None]) ** 2).mean(-1))
        sy = torch.sqrt(((py - my[..., None]) ** 2).mean(-1))
        half_w = sx * torch.exp(moment_transfer[0])
        half_h = sy * torch.exp(moment_transfer[1])
        return torch.stack([mx - half_w, my - half_h, mx + half_w,
                            my + half_h], -1)
    raise NotImplementedError(transform)


def _log2(x):
    """jnp.log2's log(x) / log(2), divided by a 0-dim tensor (a division by
    a Python number multiplies by its reciprocal on the card)."""
    return torch.log(x) / torch.log(torch.tensor(2.0, dtype=x.dtype,
                                                 device=x.device))


def point_assign(points, gt_boxes, scale, num_pos):
    """The reference's _point_assign: each gt takes its num_pos nearest
    points (distance over its width and height) on the pyramid level that
    its size picks; each point the nearest gt that took it.

    points [N, 3] (x, y, stride); gt_boxes [B, G, 5] (class <= 0 invalid).
    Returns (label [B, N] {-1 unassigned, k class}, gts [B, N, 4])."""
    px, py, pstride = points[:, 0], points[:, 1], points[:, 2]
    plvl = torch.floor(_log2(pstride))
    lvl_min, lvl_max = plvl.min(), plvl.max()
    gl, gt_, gr, gb, gcls = gt_boxes.unbind(-1)
    gx = (gl + gr) / 2.0
    gy = (gt_ + gb) / 2.0
    gw = torch.clamp(gr - gl, min=1e-6)
    gh = torch.clamp(gb - gt_, min=1e-6)
    glvl = torch.floor((_log2(gw / scale) + _log2(gh / scale)) / 2.0)
    glvl = torch.minimum(torch.maximum(glvl, lvl_min), lvl_max)

    dx = (px - gx[..., None]) / gw[..., None]
    dy = (py - gy[..., None]) / gh[..., None]
    dist = torch.sqrt(dx * dx + dy * dy)                   # [B, G, N]
    ok = (glvl[..., None] == plvl) & (gcls > 0)[..., None]
    inf = torch.full_like(dist, INF)
    dist = torch.where(ok, dist, inf)
    # each gt keeps its num_pos nearest points: rank by a stable sort
    order = torch.argsort(dist, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(dist.shape[-1], device=dist.device)
        .expand_as(order))
    dist = torch.where(rank < num_pos, dist, inf)

    min_dist, min_idx = dist.min(dim=1)                    # [B, N]
    hit = min_dist < INF
    label = torch.where(hit, torch.gather(gcls, 1, min_idx),
                        torch.full_like(min_dist, -1.0))
    gts = torch.gather(gt_boxes[..., :4], 1,
                       min_idx[..., None].expand(-1, -1, 4))
    return label, torch.where(hit[..., None], gts, torch.zeros_like(gts))


def iou_assign(p_boxes, gt_boxes, pos_iou_thr, neg_iou_thr, min_pos_iou):
    """The reference's _iou_assign: a box is background under neg_iou_thr of
    its best gt, foreground at pos_iou_thr or where it is a gt's best box
    (above min_pos_iou), ignored between.

    p_boxes [B, N, 4], gt_boxes [B, G, 5]. Returns (label [B, N] {-1 ignore,
    0 background, k class}, gts [B, N, 4])."""
    gcls = gt_boxes[..., 4]
    gt_valid = gcls > 0
    iou = bbox_overlaps(p_boxes, gt_boxes[..., :4], legacy_plus_one=False)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    max_iou, arg = iou.max(dim=2)                          # [B, N]
    max_p = iou.amax(dim=1)                                # [B, G]

    assigned = torch.full_like(max_iou, -1.0)
    assigned = torch.where(max_iou < neg_iou_thr, 0.0, assigned)
    best_hit = ((iou == max_p[:, None, :])
                & ((max_p > min_pos_iou) & gt_valid)[:, None, :]).any(2)
    assigned = torch.where(best_hit, 1.0, assigned)
    assigned = torch.where(max_iou >= pos_iou_thr, 1.0, assigned)

    pos = assigned > 0
    label = torch.where(pos, torch.gather(gcls, 1, arg), assigned)
    gts = torch.gather(gt_boxes[..., :4], 1, arg[..., None].expand(-1, -1, 4))
    return label, torch.where(pos[..., None], gts, torch.zeros_like(gts))
