"""The small RetinaNet case of tests/test_torch_retina.py that needs no JAX:
its RpnParam, its gt boxes, the level outputs of the foreground-count test,
and one gloo rank of that test (`rank_main`), which the test starts in
subprocesses (they import this module, not the test's, so they load no
JAX)."""
import os

import numpy as np
import torch

from simpledet_torch.core.config import patch_config_as_nothrow
from simpledet_torch.models.retinanet import RetinaNetHead
from simpledet_torch.parallel import dist

FILTERS, NUM_CLASS, B, H, W = 64, 4, 2, 128, 192
STRIDES = (8, 16, 32, 64, 128)
SCALES = (4 * 2 ** 0, 4 * 2 ** (1.0 / 3.0), 4 * 2 ** (2.0 / 3.0))
RATIOS = (0.5, 1.0, 2.0)


def rpn_param(pre_nms_top_n=100):
    class RpnParam:
        num_class = NUM_CLASS

        class anchor_generate:
            scale = SCALES
            ratio = RATIOS
            stride = STRIDES

        class anchor_assign:
            allowed_border = 9999
            pos_thr = 0.5
            neg_thr = 0.4
            min_pos_thr = 0.0

        class head:
            conv_channel = FILTERS

        class proposal:
            min_det_score = 0.05

        class focal_loss:
            alpha = 0.25
            gamma = 2.0

    RpnParam.proposal.pre_nms_top_n = pre_nms_top_n
    return patch_config_as_nothrow(RpnParam)


def gt_boxes():
    """Image 0: three boxes, an ignore region (class -2) and padding; image
    1 (112 x 160 inside the batch): two boxes."""
    gt = np.full((B, 8, 5), -1, np.float32)
    gt[0, :4] = [[10, 12, 60, 70, 1], [50, 20, 150, 90, 3],
                 [5, 40, 40, 120, 2], [120, 60, 180, 120, -2]]
    gt[1, :2] = [[20, 10, 90, 60, 2], [70, 30, 150, 100, 1]]
    return gt


def fg_case():
    """Level outputs of 4 images (seeded normals), their gt and im_info."""
    rng = np.random.RandomState(5)
    shapes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    outs = {f"stride{s}": (rng.randn(4, 9 * 3, h, w).astype(np.float32),
                           rng.randn(4, 36, h, w).astype(np.float32) * 0.1)
            for s, (h, w) in zip(STRIDES, shapes)}
    gt = np.concatenate([gt_boxes(), gt_boxes()[::-1]])
    gt[3, 2:] = -1
    gt[3, 0] = [30, 30, 40, 38, 1]           # a small box: few positives
    im_info = np.float32([[H, W, 1], [112, 160, 1], [H, W, 1], [96, 96, 1]])
    return outs, gt, im_info


def head_loss(rows):
    """RetinaNetHead.loss on the fg_case images `rows`."""
    outs, gt, im_info = fg_case()
    return RetinaNetHead(rpn_param()).loss(
        {k: (torch.from_numpy(c[rows]), torch.from_numpy(g[rows]))
         for k, (c, g) in outs.items()},
        torch.from_numpy(gt[rows]), torch.from_numpy(im_info[rows]))


def rank_main(out_dir):
    """One rank of the gloo group: the head's losses on its 2 images."""
    dist.init_from_env("cpu")
    r = dist.rank()
    losses, aux = head_loss([2 * r, 2 * r + 1])
    torch.save({"losses": {k: float(v) for k, v in losses.items()},
                "total_fg": float(aux["rpn_fg_count"]),
                "own_fg": int((aux["rpn_label"] >= 1).sum())},
               os.path.join(out_dir, f"rank{r}.pt"))
    dist.destroy()
