"""COCO RLE codec and segmentation helpers: a copy of
`simpledet_tpu/data/rle.py`, kept in the port so that it imports nothing of
the JAX package, with the JAX package's native polygon fill
(`simpledet_tpu/native/host_ops.cpp::rasterize_polygons`) written out in
numpy (`rasterize_polygons`).

The COCO RLE wire format: counts are run lengths over the mask flattened in
column-major (Fortran) order, alternating background and foreground and
starting with background; the compressed string packs each count
little-endian in 5-bit chunks offset by 48 into printable ASCII, bit 0x20
marking continuation; counts from index 3 on are delta-encoded against the
count two positions back, and a negative delta is sign-extended from bit
0x10 of its last chunk.

`segmentation_to_mask` takes every COCO segmentation flavour (polygons,
uncompressed and compressed RLE); `mask_to_polygons` turns a decoded mask
back into polygons, so that crowd and RLE records go through the same
transforms and on-device edge rasterization as polygons.
"""
import numpy as np


def _string_to_counts(s):
    if isinstance(s, bytes):
        s = s.decode("ascii")
    cnts = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def _counts_to_string(cnts):
    out = []
    for i in range(len(cnts)):
        x = int(cnts[i])
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def decode_rle(rle):
    """COCO RLE dict {'size': [h, w], 'counts': str | bytes | list} ->
    [h, w] uint8 binary mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _string_to_counts(counts)
    counts = np.asarray(counts, np.int64)
    if counts.sum() != h * w:
        raise ValueError(f"RLE counts sum {counts.sum()} != h*w {h * w}")
    vals = (np.arange(len(counts)) % 2).astype(np.uint8)
    flat = np.repeat(vals, counts)
    return flat.reshape((w, h)).T  # column-major layout


def encode_rle(mask):
    """[h, w] binary mask -> COCO compressed RLE dict."""
    m = np.asarray(mask)
    h, w = m.shape
    flat = (m.T.reshape(-1) > 0).astype(np.uint8)  # column-major
    if flat.size == 0:
        return {"size": [h, w], "counts": ""}
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [int(h), int(w)], "counts": _counts_to_string(counts)}


def rasterize_polygons(polys, h, w):
    """[h, w] uint8 union of the polygons (each a flat float64 [x0, y0, x1,
    y1, ...] of at least 3 vertices), filled as the JAX package's native
    scanline fill fills them: a cell is inside a polygon when its centre
    (column + 0.5, row + 0.5) lies between an even-odd pair of the row's
    edge crossings, the span running from ceil(x_a - 0.5) to
    floor(x_b - 0.5); polygons are unioned. Row by row, in float64 with the
    native code's order of operations."""
    m = np.zeros((h, w), np.uint8)
    py = (np.arange(h, dtype=np.float64) + 0.5)[:, None]        # [h, 1]
    for poly in polys:
        xy = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(xy) < 3:
            continue
        x0, y0 = xy[:, 0], xy[:, 1]
        x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
        hit = (y0 <= py) != (y1 <= py)                               # [h, E]
        with np.errstate(divide="ignore", invalid="ignore"):
            xs = x0 + (py - y0) / (y1 - y0) * (x1 - x0)
        xs = np.sort(np.where(hit, xs, np.inf), axis=1)
        n = hit.sum(1)[:, None]
        pair = np.arange(xs.shape[1] // 2)[None]                     # [1, K]
        on = 2 * pair + 1 < n
        c0 = np.ceil(np.where(on, xs[:, 0::2][:, :pair.shape[1]], 0) - 0.5)
        c1 = np.floor(np.where(on, xs[:, 1::2], 0) - 0.5)
        c0 = np.maximum(c0, 0).astype(np.int64)
        c1 = np.minimum(c1, w - 1).astype(np.int64)
        on &= c1 >= c0
        # spans of one row do not overlap (sorted crossings): mark each
        # span's start and end + 1, and a running sum over the row fills it
        diff = np.zeros((h, w + 1), np.int32)
        rows = np.broadcast_to(np.arange(h)[:, None], on.shape)
        np.add.at(diff, (rows[on], c0[on]), 1)
        np.add.at(diff, (rows[on], c1[on] + 1), -1)
        m |= (np.cumsum(diff[:, :w], axis=1) > 0).astype(np.uint8)
    return m


def segmentation_to_mask(seg, h, w):
    """Any COCO segmentation -> [h, w] uint8 mask.

    list of polygons -> rasterized union (`rasterize_polygons`); dict with
    list counts (uncompressed RLE) or str / bytes counts (compressed RLE)
    -> decoded.
    """
    if isinstance(seg, dict):
        return decode_rle(seg)
    if isinstance(seg, list) and len(seg) \
            and not isinstance(seg[0], (list, np.ndarray)):
        seg = [seg]  # single flat polygon
    polys = [np.asarray(p, np.float64) for p in (seg or [])
             if len(np.asarray(p).ravel()) >= 6]
    if not polys:
        return np.zeros((int(h), int(w)), np.uint8)
    return rasterize_polygons(polys, int(h), int(w))


def mask_to_polygons(mask):
    """[h, w] binary mask -> list of flat [x0, y0, x1, y1, ...] float32
    polygons (external contours). Lossy for masks with holes: fine for the
    crowd and ignore path, where only coarse coverage matters."""
    import cv2

    m = np.ascontiguousarray((np.asarray(mask) > 0).astype(np.uint8))
    contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    polys = []
    for c in contours:
        c = c.reshape(-1, 2).astype(np.float32)
        if len(c) >= 3:
            polys.append(c.reshape(-1))
    return polys
