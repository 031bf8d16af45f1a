"""A Python transcription of the port's NMS kernel (`simpledet_torch/csrc/
nms.cu`), run on the CPU where the kernel cannot run: the triangular tile index
and packed stripes of the mask launch, and the scan's block-wise resolution
(ffs over each block's candidates against its diagonal words, the kept rows'
words OR-ed into `removed` by four row groups). Keep flags must be identical to
`nms_keep_sorted_plain` and to the JAX package's Pallas kernel run in interpret
mode.

The suppression bits come from the plain version's `pair_suppression`: the IoU
arithmetic is held on the card (`tests/test_torch_kernels.py`), the word
bookkeeping here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from simpledet_tpu.kernels.nms_pallas import nms_keep_sorted_pallas
from simpledet_torch.kernels import nms as knms

BLOCK = 64


def tri_tiles(col_blocks):
    return col_blocks * (col_blocks + 1) // 2


def stripe_base(rb, col_blocks):
    return BLOCK * (rb * col_blocks - rb * (rb - 1) // 2)


def mask_launch(sup, n):
    """The packed words nms_mask_kernel writes for one problem; a word it
    does not write stays None, so reading one fails."""
    col_blocks = -(-n // BLOCK)
    padded = np.zeros((n, col_blocks * BLOCK), bool)
    padded[:, :n] = sup
    bits = padded.reshape(n, col_blocks, BLOCK)

    def word(i, cb):
        return sum(1 << int(k) for k in np.nonzero(bits[i, cb])[0])
    out = [None] * (BLOCK * tri_tiles(col_blocks))
    for tile in range(tri_tiles(col_blocks)):
        rb, rem = 0, tile
        while rem >= col_blocks - rb:
            rem -= col_blocks - rb
            rb += 1
        cb, width = rb + rem, col_blocks - rb
        for t in range(min(n - rb * BLOCK, BLOCK)):
            out[stripe_base(rb, col_blocks) + t * width + (cb - rb)] = word(
                rb * BLOCK + t, cb)
    return out


def scan_launch(words, valid, n):
    """nms_scan_kernel for one problem: keep flags [n] bool."""
    col_blocks = -(-n // BLOCK)
    removed = [0] * col_blocks
    vbits = [sum(1 << k for k in range(BLOCK)
                 if b * BLOCK + k < n and valid[b * BLOCK + k])
             for b in range(col_blocks)]
    kbits = []
    for b in range(col_blocks):
        width = col_blocks - b
        s = words[stripe_base(b, col_blocks):][:BLOCK * width]
        cand, kept = vbits[b] & ~removed[b], 0
        while cand:
            i = (cand & -cand).bit_length() - 1            # __ffsll - 1
            kept |= 1 << i
            cand &= cand - 1
            cand &= ~s[i * width]
        kbits.append(kept)
        for warp in range(4):
            rows = (kept >> (16 * warp)) & 0xFFFF
            for w in range(1, width):
                acc, m = 0, rows
                while m:
                    acc |= s[(16 * warp + (m & -m).bit_length() - 1) * width
                             + w]
                    m &= m - 1
                removed[b + w] |= acc
    return np.array([(kbits[i >> 6] >> (i & 63)) & 1 for i in range(n)],
                    bool)


def nms_cases():
    cases = dict(chip_smoke.nms_edge_cases())
    rng = np.random.RandomState(11)
    for p, n, thr in ((3, 300, 0.7), (3, 200, 0.5), (2, 130, 0.3)):
        cases[f"clustered {p}x{n}@{thr}"] = (*chip_smoke.nms_problems(
            rng, p, n), thr)
    return cases


@pytest.mark.parametrize("name", list(nms_cases()))
def test_nms_block_resolution(name):
    """Identical keep flags: transcription, plain version, Pallas (interpret)."""
    boxes, valid, thr = nms_cases()[name]
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    sup = knms.pair_suppression(tb, tv, thr).numpy()
    plain = knms.nms_keep_sorted_plain(tb, tv, thr).numpy()
    for i in range(boxes.shape[0]):
        n = boxes.shape[1]
        got = scan_launch(mask_launch(sup[i], n), valid[i], n)
        np.testing.assert_array_equal(got, plain[i])
        pallas = np.asarray(nms_keep_sorted_pallas(
            jnp.asarray(boxes[i]), jnp.asarray(valid[i]), thr,
            interpret=True))
        np.testing.assert_array_equal(got, pallas)
