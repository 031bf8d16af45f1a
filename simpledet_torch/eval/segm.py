"""Mask pasting for eval: a copy of `models/maskrcnn/utils.py` (the Detectron
convention of the reference's segm_results), kept in the port so that it
imports nothing of the JAX package's tree.

Each box is expanded by (M + 2) / M, its M x M probabilities are zero-padded
by one cell, resized (bilinear) to the expanded box, thresholded at 0.5 and
pasted into the image. Binary uint8 masks come out; COCOEval reads them from
a detection's `_mask`.
"""
import numpy as np


def expand_boxes(boxes, scale):
    w_half = (boxes[:, 2] - boxes[:, 0]) * 0.5 * scale
    h_half = (boxes[:, 3] - boxes[:, 1]) * 0.5 * scale
    x_c = (boxes[:, 2] + boxes[:, 0]) * 0.5
    y_c = (boxes[:, 3] + boxes[:, 1]) * 0.5
    out = np.zeros(boxes.shape)
    out[:, 0] = x_c - w_half
    out[:, 2] = x_c + w_half
    out[:, 1] = y_c - h_half
    out[:, 3] = y_c + h_half
    return out


def segm_results(bbox_xyxy, masks, im_h, im_w):
    """bbox_xyxy [D, 4] in image coordinates, masks [D, M, M] probabilities
    of each box's class -> list of D [im_h, im_w] uint8 binary masks."""
    import cv2

    im_h, im_w = int(im_h), int(im_w)
    m = masks.shape[-1]
    scale = (m + 2.0) / m
    ref_boxes = expand_boxes(np.asarray(bbox_xyxy), scale).astype(np.int32)
    padded = np.zeros((m + 2, m + 2), np.float32)

    out = []
    for box, prob in zip(ref_boxes, np.asarray(masks)):
        padded[1:-1, 1:-1] = prob
        w = max(box[2] - box[0] + 1, 1)
        h = max(box[3] - box[1] + 1, 1)
        mask = (cv2.resize(padded, (w, h)) > 0.5).astype(np.uint8)
        im_mask = np.zeros((im_h, im_w), np.uint8)
        x0, x1 = max(box[0], 0), min(box[2] + 1, im_w)
        y0, y1 = max(box[1], 0), min(box[3] + 1, im_h)
        if x1 > x0 and y1 > y0:
            im_mask[y0:y1, x0:x1] = mask[y0 - box[1]:y1 - box[1],
                                         x0 - box[0]:x1 - box[0]]
        out.append(im_mask)
    return out
