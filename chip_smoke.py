"""Drive the PyTorch port's serving path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on error:
  1. environment: torch and CUDA versions, nvcc, the card's name and power
     limit; TF32 off for convolutions and matrix products;
  2. build both CUDA kernels from `simpledet_torch/csrc/` (one nvcc each, in
     parallel);
  3. hold each kernel against its plain PyTorch version at the main path's
     shapes and time both with CUDA events beside the kernel's bound;
  4. serve requests of 2 synthetic uint8 800 x 1333 images through
     `simpledet_torch.infer.Detector` built from config/faster_r50v1_fpn_1x.py
     (full width, seeded random weights), one of them with score_thr=0 so the
     per-class NMS sees 1000 live boxes per class; check the outputs, the
     kernels' launch counts on that run, and the detections against the same
     path with both kernels replaced by their plain versions;
  5. print the `kernels` JSON line, the card's line, and {"ok": true, ...}.

Exits non-zero, printing no result, without CUDA or outside the repo.
"""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "config", "faster_r50v1_fpn_1x.py")
B, H, W, R, C = 2, 800, 1333, 1000, 256
LEVEL_HW = [(200, 334), (100, 167), (50, 84), (25, 42)]
STRIDES = (4, 8, 16, 32)

# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s; float32 outside the
# tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float operations a kernel must do: NMS per box pair (iw, ih: 2 min, 2 max,
# 2 sub, 2 add; inter: 2 max, 1 mul; union: 1 add, 1 sub, 1 max; 1 div;
# 1 compare) and per box (its area: 2 sub, 2 add, 1 mul); RoIAlign per output
# value (4 samples x (4 mul + 3 add) + 3 max).
NMS_OPS_PER_PAIR, NMS_OPS_PER_BOX, ROI_OPS_PER_OUT = 16, 5, 31


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds per call on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------- phase 1


def environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from simpledet_torch.infer import card_name_and_power, full_fp32

    full_fp32()
    smi = card_name_and_power()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    release = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    release = [ln for ln in release.splitlines() if "release" in ln]
    log(f"nvcc {nvcc}: {release[0] if release else 'release not printed'}")
    log(f"card {smi}")
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return smi


# ---------------------------------------------------------------- phase 3


def nms_problems(rng, p, n, dev):
    """p score-sorted pools of n boxes in an 800 x 1333 image, clustered so
    that suppression chains form, 90% valid."""
    pick = rng.randint(0, 40, n)
    ctr = rng.uniform([0, 0], [W, H], (p, 40, 2))[:, pick]
    wh = np.exp(rng.uniform(np.log(8), np.log(400), (p, 40, 2)))[:, pick]
    ctr = ctr + rng.normal(0, 0.1, (p, n, 2)) * wh
    wh = wh * np.exp(rng.normal(0, 0.1, (p, n, 2)))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], 2).astype(np.float32)
    valid = rng.rand(p, n) < 0.9
    return (torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev))


def check_nms(dev):
    from simpledet_torch.kernels import nms as knms

    rng = np.random.RandomState(0)
    tot = dict(ms=0.0, plain_ms=0.0, ops=0.0, nbytes=0.0)
    # per forward at batch 2: proposals (B x 5 pools of 1000 at 0.7) and the
    # per-class NMS (B x 80 classes of 1000 at 0.5); training pools last
    for p, n, thr, on_path in ((B * 5, 1000, 0.7, True),
                               (B * 80, 1000, 0.5, True),
                               (B * 5, 2000, 0.7, False)):
        boxes, valid = nms_problems(rng, p, n, dev)
        got = knms.nms_keep_sorted(boxes, valid, thr)
        torch.cuda.synchronize()
        want = knms.nms_keep_sorted_plain(boxes, valid, thr)
        diff = int((got != want).sum())
        if diff:
            raise AssertionError(f"NMS {p}x{n}@{thr}: {diff} keep flags "
                                 "differ from the plain version")
        ms = cuda_ms(lambda: knms.nms_keep_sorted(boxes, valid, thr), 20)
        plain_ms = cuda_ms(lambda: knms.nms_keep_sorted_plain(boxes, valid,
                                                              thr), 3, 1)
        nv = valid.sum(1).double()
        ops = float((NMS_OPS_PER_PAIR * nv * (nv - 1) / 2
                     + NMS_OPS_PER_BOX * nv).sum())
        nbytes = p * n * (16 + 1 + 1)
        bms, by = bound_ms(nbytes, ops)
        log(f"nms {p}x{n}@{thr}: identical keep ({int(got.sum())} kept); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.6f} ms"
            f" ({by})")
        if on_path:
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("ops", ops),
                         ("nbytes", nbytes)):
                tot[k] += v
    bms, by = bound_ms(tot["nbytes"], tot["ops"])
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bms,
                bound_by=by, max_abs_err=0.0)


def mixed_rois(rng, dev):
    """R rois per image, log-uniform sizes over the image, plus
    extreme-aspect, edge and out-of-image rois."""
    xy = rng.uniform(0, [W, H], (B, R, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(1000), (B, R, 2)))
    rois = np.concatenate([xy, np.minimum(xy + wh, [W - 1, H - 1])], 2)
    rois[:, :6] = [[0, 300, 1332, 330], [600, 0, 620, 799],
                   [0, 0, 1332, 799], [1300, 780, 1332, 799], [0, 0, 2, 2],
                   [1400, 900, 1500, 950]]
    return torch.from_numpy(rois.astype(np.float32)).to(dev)


def touched_bytes(kroi, rois, itemsize):
    """Bytes of the distinct feature cells these rois' bilinear taps read."""
    rois_f = rois.reshape(-1, 4)
    lvl = kroi.roi_level_index(rois_f, LEVEL_HW, STRIDES, 224, 4, 7)
    (yl, yh, _), (xl, xh, _), _ = kroi._sample_taps(rois_f, lvl, LEVEL_HW,
                                                    STRIDES, 7)
    img = torch.arange(B, device=rois.device).repeat_interleave(R)
    hw = torch.tensor(LEVEL_HW, device=rois.device)
    base = (lvl * B + img) * int(hw.prod(1).max())
    ys = torch.cat([yl, yh], 2).reshape(len(lvl), -1)
    xs = torch.cat([xl, xh], 2).reshape(len(lvl), -1)
    cells = (base[:, None, None] + ys[:, :, None] * hw[lvl, 1][:, None, None]
             + xs[:, None, :])
    return int(torch.unique(cells).numel()) * C * itemsize


def check_roi_align(dev):
    from simpledet_torch.kernels import roi_align as kroi

    rng = np.random.RandomState(1)
    feats32 = [torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32))
               .to(dev) for h, w in LEVEL_HW]
    rois = mixed_rois(rng, dev)
    out = {}
    for dt, tol in ((torch.float32, dict(rtol=1e-4, atol=1e-4)),
                    # bf16: the plain fp32 result rounded once to bf16;
                    # one bf16 ulp is 2^-7 relative (1e-3 near zero)
                    (torch.bfloat16, dict(rtol=2 ** -7, atol=1e-3))):
        feats = [f.to(dt) for f in feats32]
        got = kroi.multilevel_roi_align(feats, rois, STRIDES, out_size=7)
        torch.cuda.synchronize()
        want = kroi.multilevel_roi_align_plain([f.float() for f in feats],
                                               rois, STRIDES, out_size=7)
        ref = want.to(dt).float() if dt == torch.bfloat16 else want
        torch.testing.assert_close(got.float(), ref, **tol)
        err = float((got.float() - ref).abs().max())
        ms = cuda_ms(lambda: kroi.multilevel_roi_align(feats, rois, STRIDES,
                                                       out_size=7), 20)
        plain_ms = cuda_ms(lambda: kroi.multilevel_roi_align_plain(
            feats, rois, STRIDES, out_size=7), 3, 1)
        isz = feats[0].element_size()
        nbytes = (touched_bytes(kroi, rois, isz) + rois.numel() * 4
                  + got.numel() * isz)
        bms, by = bound_ms(nbytes, ROI_OPS_PER_OUT * got.numel())
        name = str(dt).split(".")[-1]
        log(f"roi_align {name} B={B} R={R} C={C}: max_abs_err {err:.3g}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.6f} ms "
            f"({by}, {nbytes / 1e6:.1f} MB)")
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         max_abs_err=err)
    return out


# ---------------------------------------------------------------- phase 4


def serve(dev, smi):
    from simpledet_torch.infer import Detector, synthetic_batch
    from simpledet_torch.kernels import nms as knms
    from simpledet_torch.kernels import roi_align as kroi

    det = Detector(CONFIG, device=dev, seed=0)
    requests = [synthetic_batch(B, H, W, seed) for seed in range(4)]
    requests = [(x.to(dev), i) for x, i in requests]
    det.detect(*requests[0])                       # warm-up: cuDNN plans
    torch.cuda.synchronize()

    knms.launches = 0
    kroi.launches = 0
    t0 = time.perf_counter()
    results = [det.detect(x, i) for x, i in requests[1:]]
    torch.cuda.synchronize()
    ms_img = (time.perf_counter() - t0) * 1e3 / (B * (len(requests) - 1))
    live = det.detect(*requests[0], score_thr=0.0)
    torch.cuda.synchronize()
    counts = {"nms": knms.launches, "roi_align": kroi.launches}
    log(f"main path launches {counts}")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")

    for boxes, scores, classes, valid in results + [live]:
        assert boxes.shape == (B, det.max_det, 4), boxes.shape
        assert scores.shape == classes.shape == valid.shape == (B, det.max_det)
        assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()
        v = valid
        assert ((classes[v] >= 1) & (classes[v] < 81)).all()
        assert (boxes[v] >= 0).all() and (boxes[v][:, 2] <= W - 1).all()
        assert (boxes[v][:, 3] <= H - 1).all()
    assert bool(live[3].all()), "score_thr=0 request should fill max_det"
    log(f"serving: {ms_img:.3f} ms per image at {H}x{W}, batch {B}, incl. "
        f"per-class NMS, on {smi}; {int(results[0][3].sum())} detections "
        "in the first timed request")

    # the same requests with both kernels replaced by their plain versions
    import simpledet_torch.models.faster_rcnn as frcnn
    import simpledet_torch.ops.nms as onms
    saved = (onms.nms_keep_sorted, frcnn.multilevel_roi_align)
    onms.nms_keep_sorted = knms.nms_keep_sorted_plain
    frcnn.multilevel_roi_align = kroi.multilevel_roi_align_plain
    try:
        ref = det.detect(*requests[1])
        ref_live = det.detect(*requests[0], score_thr=0.0)
    finally:
        onms.nms_keep_sorted, frcnn.multilevel_roi_align = saved
    for got, want in ((results[0], ref), (live, ref_live)):
        assert torch.equal(got[3], want[3]) and torch.equal(got[2], want[2])
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-3)
    log("detections agree with the plain-version path")
    return counts, ms_img


def main():
    smi = environment()
    dev = torch.device("cuda", 0)
    from simpledet_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {', '.join(_build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")

    nms = check_nms(dev)
    roi = check_roi_align(dev)
    counts, ms_img = serve(dev, smi)

    kernels = [
        dict(name="nms", route="cuda", source="simpledet_torch/csrc/nms.cu",
             replaces="simpledet_tpu/kernels/nms_pallas.py:31",
             launches=counts["nms"], max_abs_err=nms["max_abs_err"],
             ms=nms["ms"], plain_ms=nms["plain_ms"],
             bound_ms=nms["bound_ms"], bound_by=nms["bound_by"],
             library_ms=None),
        dict(name="roi_align_fwd", route="cuda",
             source="simpledet_torch/csrc/roi_align.cu",
             replaces="simpledet_tpu/kernels/roi_align_pallas.py:267",
             launches=counts["roi_align"],
             max_abs_err=roi["float32"]["max_abs_err"],
             ms=roi["float32"]["ms"], plain_ms=roi["float32"]["plain_ms"],
             bound_ms=roi["float32"]["bound_ms"],
             bound_by=roi["float32"]["bound_by"], library_ms=None,
             bf16=roi["bfloat16"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
