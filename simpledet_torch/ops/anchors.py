"""Anchor generation with exact parity to the reference's rounding.

Copy of `simpledet_tpu/ops/anchors.py` (generate_base_anchors,
generate_anchor_grid): the base anchor is the stride x stride square at the
origin, aspect widths are np.round'ed BEFORE scaling (a quirk kept for mAP
parity), and the grid is enumerated in (y, x, anchor) order.
"""
import numpy as np


def generate_base_anchors(stride, scales, aspects):
    """[A, 4] base anchors for one stride, aspect-major, scale-minor."""
    scales = np.array(scales, dtype=np.float64).reshape(-1)
    aspects = np.array(aspects, dtype=np.float64).reshape(-1)

    base = np.array([0, 0, stride - 1, stride - 1], dtype=np.float64)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    x_ctr = base[0] + 0.5 * (w - 1)
    y_ctr = base[1] + 0.5 * (h - 1)

    w_ratios = np.round(np.sqrt(w * h / aspects))
    h_ratios = np.round(w_ratios * aspects)
    ws = np.outer(w_ratios, scales).reshape(-1)
    hs = np.outer(h_ratios, scales).reshape(-1)

    anchors = np.stack(
        [x_ctr - 0.5 * (ws - 1),
         y_ctr - 0.5 * (hs - 1),
         x_ctr + 0.5 * (ws - 1),
         y_ctr + 0.5 * (hs - 1)],
        axis=1)
    return anchors.astype(np.float32)


def generate_anchor_grid(height, width, stride, scales, aspects):
    """Full anchor grid [H*W*A, 4] in row-major (y, x, anchor) order."""
    base = generate_base_anchors(stride, scales, aspects)
    shift_x = np.arange(0, width, dtype=np.float32) * stride
    shift_y = np.arange(0, height, dtype=np.float32) * stride
    grid_x, grid_y = np.meshgrid(shift_x, shift_y)
    grid = np.stack([grid_x.reshape(-1), grid_y.reshape(-1),
                     grid_x.reshape(-1), grid_y.reshape(-1)], axis=1)
    all_anchors = grid[:, None, :] + base[None, :, :]
    return all_anchors.reshape(-1, 4).astype(np.float32)
