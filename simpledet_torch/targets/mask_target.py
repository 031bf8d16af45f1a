"""Mask targets on the device: polygon rasterization of each foreground roi's
gt (counterpart of simpledet_tpu/targets/mask_target.py).

For each fg roi, the polygons of its matched gt are rasterized into a
mask_size x mask_size grid spanning the roi: a cell is inside when a ray from
its centre towards +x crosses an odd number of one segment's edges (even-odd
per segment), and the instance is the union over its segments (COCO's
rleMerge), not the XOR over all edges. Rows that are not fg are -1 (ignored
by the loss). Polygons arrive as the edge tensor of
`data/mask_transforms.py::EncodeGtPoly`: gt_poly [B, G, E, 5] rows of
(xa, ya, xb, yb, seg_id), seg_id = -1 for padding.

The JAX package forms [F, P, E] crossings per image and reduces them with a
float matmul against a one-hot of the segments, which XLA fuses. Eagerly
each [F, P, E] intermediate is materialised (at full width F = 128 rois,
P = 784 cells, E = 1250 edges: 125 M elements per intermediate), so here the
rois go in chunks whose intermediates stay under `CHUNK_ELEMENTS`, and the
crossings are counted per segment as integers (a scatter-add over the
segment index), whose parity is exact. The model first drops the edge
columns that are padding in every instance (`trim_padding`): a 16-gon
instance has 16 edges of the 1250 a full-width config packs.
"""
import torch

NUM_SEG = 8
CHUNK_ELEMENTS = 1 << 25      # [rois, cells, edges] elements a chunk forms


def rasterize_edges(edges, rois, mask_size, num_seg=NUM_SEG):
    """edges [N, E, 5], rois [N, 4] xyxy in the same coordinates ->
    [N, mask_size, mask_size] float32 {0, 1}."""
    n = rois.shape[0]
    dev = rois.device
    x1, y1, x2, y2 = rois.float().unbind(-1)
    w = torch.clamp(x2 - x1, min=1.0)
    h = torch.clamp(y2 - y1, min=1.0)
    grid = (torch.arange(mask_size, dtype=torch.float32, device=dev) + 0.5) \
        / torch.tensor(float(mask_size), device=dev)
    ys = y1[:, None] + grid[None] * h[:, None]                    # [N, M]
    xs = x1[:, None] + grid[None] * w[:, None]
    py = ys[:, :, None].expand(n, mask_size, mask_size).reshape(n, -1, 1)
    px = xs[:, None, :].expand(n, mask_size, mask_size).reshape(n, -1, 1)

    xa, ya, xb, yb, seg = (edges[..., k][:, None, :] for k in range(5))
    valid = seg >= 0
    straddles = (ya <= py) != (yb <= py)                          # [N, P, E]
    t = (py - ya) / torch.where(yb == ya, torch.ones_like(yb), yb - ya)
    x_cross = xa + t * (xb - xa)
    cross = straddles & (px < x_cross) & valid
    # crossings per segment in slots 1..num_seg; slot 0 takes padding and
    # seg_ids past num_seg, which the JAX package's one-hot drops
    seg = seg.long()
    sid = torch.where((seg >= 0) & (seg < num_seg), seg + 1,
                      torch.zeros_like(seg)).expand_as(cross)
    counts = torch.zeros(n, cross.shape[1], num_seg + 1, dtype=torch.int32,
                         device=dev)
    counts.scatter_add_(2, sid, cross.to(torch.int32))
    inside = (counts[..., 1:] % 2 == 1).any(-1)
    return inside.float().reshape(n, mask_size, mask_size)


def batched_mask_target(rois, gt_index, fg_mask, gt_poly, *, mask_size=28,
                        num_seg=NUM_SEG):
    """rois [B, F, 4] (the fg-first prefix of the sampled rois), gt_index
    [B, F] (the matched gt, -1 where not fg), fg_mask [B, F] bool, gt_poly
    [B, G, E, 5] -> [B, F, mask_size, mask_size] float32 targets in {0, 1},
    -1 on the rows that are not fg. Rois go in chunks of at most
    CHUNK_ELEMENTS // (cells * edges) (at least one)."""
    b, f = rois.shape[:2]
    g, e = gt_poly.shape[1:3]
    idx = gt_index.long().clamp(0, g - 1)
    img = torch.arange(b, device=rois.device)[:, None].expand(b, f)
    edges = gt_poly[img.reshape(-1), idx.reshape(-1)]            # [B*F, E, 5]
    flat = rois.reshape(b * f, 4)
    step = max(1, CHUNK_ELEMENTS // (mask_size * mask_size * e))
    masks = torch.cat([rasterize_edges(edges[i:i + step], flat[i:i + step],
                                       mask_size, num_seg)
                       for i in range(0, b * f, step)])
    masks = masks.reshape(b, f, mask_size, mask_size)
    return torch.where(fg_mask[:, :, None, None], masks,
                       torch.full_like(masks, -1.0))


def trim_padding(gt_poly):
    """gt_poly [B, G, E, 5] cut to its first E' edge columns, E' one past the
    last column that holds a valid edge (seg_id >= 0) in any instance (at
    least 1). The columns after it are padding in every instance, which the
    rasterizer counts as nothing: the targets do not change, and its work
    falls from E (1250 at full width) to the longest instance's edge count
    (`EncodeGtPoly` packs each instance's edges first). Reads E' on the
    host: one synchronisation."""
    valid = (gt_poly[..., 4] >= 0).any(1).any(0)                   # [E]
    col = torch.arange(1, valid.shape[0] + 1, device=valid.device)
    n = int(torch.where(valid, col, torch.ones_like(col)).max())
    return gt_poly[:, :, :n]

