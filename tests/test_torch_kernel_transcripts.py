"""Python transcriptions of the port's kernels, run on the CPU where the
kernels cannot run.

NMS (`simpledet_torch/csrc/nms.cu`): the triangular tile index and packed
stripes of the mask launch, and the scan's block-wise resolution (ffs over each
block's candidates against its diagonal words, the kept rows' words OR-ed into
`removed` by four row groups). Keep flags must be identical to
`nms_keep_sorted_plain` and to the JAX package's Pallas kernel run in interpret
mode. The suppression bits come from the plain version's `pair_suppression`:
the IoU arithmetic is held on the card (`tests/test_torch_kernels.py`), the
word bookkeeping here.

RoIAlign forward (`roi_align_fwd_kernel` in `csrc/roi_align.cu`): each bin
row's walk along x with its two column slots and its deduplicated tap rows,
and which slot and row each of a sample's four taps reads. Outputs and tie
codes must be identical to `multilevel_roi_align_plain`, and the cells it
loads per roi are counted against `chip_smoke.fwd_traffic`. The taps and
weights come from the plain version's `_sample_taps` (the prologue's
arithmetic is held on the card).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from simpledet_tpu.kernels.nms_pallas import nms_keep_sorted_pallas
from simpledet_torch.kernels import nms as knms
from simpledet_torch.kernels import roi_align as kroi

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


# ------------------------------------------------------- RoIAlign forward

P = 7
STRIDES = chip_smoke.STRIDES


def fwd_bin_row(fmap, rows, alpha, cols, beta, empty):
    """One bin row of roi_align_fwd_kernel, all channels at once.

    fmap [H, W, C] float32 (the roi's level and image); rows = the 4 tap rows
    (lo, hi of sample row 0, lo, hi of sample row 1), alpha their 2 weights;
    cols [P, 2, 2] (bin, sample, lo/hi) tap columns, beta [P, 2]; empty [P].
    Returns out [P, C], codes [P, C] uint8 and the cells loaded."""
    one = np.float32(1.0)
    c = fmap.shape[-1]
    out, codes = np.zeros((P, c), np.float32), np.zeros((P, c), np.uint8)
    loads = 0
    # the first earlier slot holding the same row: that row is not reloaded
    same = [next((j for j in range(k) if rows[j] == rows[k]), None)
            for k in range(4)]

    def column(x):
        nonlocal loads
        f = []
        for k in range(4):
            if same[k] is None:
                f.append(fmap[rows[k], x])
                loads += 1
            else:
                f.append(f[same[k]])
        return f

    slots, held = [None, None], [-1, -1]   # two column slots, their columns
    for px in range(P):
        if empty[px]:
            continue
        val = {}
        for sx in range(2):
            xl, xh = cols[px, sx]
            b = beta[px, sx]
            lo_slot = held.index(xl) if xl in held else None
            if lo_slot is None:      # into the slot the hi tap does not need
                lo_slot = 1 if xh == held[0] else 0
                slots[lo_slot], held[lo_slot] = column(xl), xl
            if xh == xl:
                hi_slot = lo_slot
            elif xh in held:
                hi_slot = held.index(xh)
            else:
                hi_slot = 1 - lo_slot
                slots[hi_slot], held[hi_slot] = column(xh), xh
            lo, hi = slots[lo_slot], slots[hi_slot]
            for sy in range(2):
                a = alpha[sy]
                val[sy, sx] = ((one - a) * (one - b) * lo[2 * sy]
                               + a * (one - b) * lo[2 * sy + 1]
                               + (one - a) * b * hi[2 * sy]
                               + a * b * hi[2 * sy + 1])
        m = np.full(c, -np.inf, np.float32)
        for v in val.values():
            m = np.maximum(m, v)
        out[px] = m
        codes[px] = sum((val[sy, sx] >= m).astype(np.uint8) << (2 * sy + sx)
                        for sy in range(2) for sx in range(2))
    return out, codes, loads


def fwd_launch(feats, rois):
    """roi_align_fwd_kernel over every roi: out [B, R, P, P, C], codes
    [B*R, P, P, C] and the cells each roi loads [B*R]."""
    b, r = rois.shape[:2]
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    rois_f = rois.reshape(-1, 4)
    lvl = kroi.roi_level_index(rois_f, level_hw, STRIDES, 224, 4, P)
    (yl, yh, alpha), (xl, xh, beta), empty = (
        [t.numpy() for t in grp] if isinstance(grp, tuple) else grp.numpy()
        for grp in kroi._sample_taps(rois_f, lvl, level_hw, STRIDES, P))
    cols = np.stack([xl, xh], 3)                    # [N, P, 2, 2]
    maps = [f.numpy() for f in feats]
    c = maps[0].shape[-1]
    out = np.zeros((b * r, P, P, c), np.float32)
    codes = np.zeros((b * r, P, P, c), np.uint8)
    loads = np.zeros(b * r, np.int64)
    for n in range(b * r):
        fmap = maps[int(lvl[n])][n // r]
        for py in range(P):
            rows = (yl[n, py, 0], yh[n, py, 0], yl[n, py, 1], yh[n, py, 1])
            out[n, py], codes[n, py], k = fwd_bin_row(
                fmap, rows, alpha[n, py], cols[n], beta[n], empty[n, py])
            loads[n] += k
    return out.reshape(b, r, P, P, c), codes, loads



def fwd_cases():
    """Mixed rois and each edge-case set on the main path's pyramid, with
    C=8 and 24 rois per image; random features and 4 x 4 patches (ties)."""
    rng = np.random.RandomState(12)
    feats = [torch.from_numpy(rng.randn(2, h, w, 8).astype(np.float32))
             for h, w in chip_smoke.LEVEL_HW]
    sets = {"mixed": chip_smoke.mixed_rois(rng, "cpu", 24)}
    sets.update({k: torch.from_numpy(v) for k, v in
                 chip_smoke.roi_edge_cases(rng, 24).items()})
    return {"random": feats, "patches": chip_smoke.patches(rng, feats)}, sets


@pytest.mark.parametrize("kind", ["random", "patches"])
@pytest.mark.parametrize("roi_set", ["mixed", "identical", "wide", "edges",
                                     "collapsed"])
def test_roi_align_fwd_traversal(roi_set, kind):
    """Outputs and codes identical to the plain version; each roi loads each
    distinct tap row of a bin row once per distinct tap column
    (`chip_smoke.fwd_traffic`, which sizes the kernel's traffic), never more
    than its tap reads and never fewer than its distinct cells."""
    feats_by_kind, sets = fwd_cases()
    feats, rois = feats_by_kind[kind], sets[roi_set]
    out, codes, loads = fwd_launch(feats, rois)
    want, want_codes = kroi.multilevel_roi_align_plain(feats, rois, STRIDES,
                                                       with_codes=True)
    np.testing.assert_array_equal(out, want.numpy())
    np.testing.assert_array_equal(codes, want_codes.numpy())
    taps, planned, cells = (t.numpy() for t in chip_smoke.fwd_traffic(
        kroi, rois))
    np.testing.assert_array_equal(loads, planned)
    assert (cells <= loads).all() and (loads <= taps).all()
    print(f"{roi_set}: tap reads {taps.sum()}, loads {loads.sum()}, "
          f"distinct per roi {cells.sum()} cells")
