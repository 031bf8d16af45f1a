"""Drive the PyTorch port's serving and training paths on one NVIDIA card and
check them.

    python3 chip_smoke.py

Phases, each fatal on error:
  1. environment: torch and CUDA versions, nvcc, the card's name and power
     limit; TF32 off for convolutions and matrix products;
  2. build the CUDA kernels from `simpledet_torch/csrc/` (one nvcc each, in
     parallel);
  3. hold the NMS and RoIAlign-forward kernels against their plain PyTorch
     versions at the serving path's shapes and time both with CUDA events
     beside the kernel's bound;
  3b. the RoIAlign forward with tie codes and the RoIAlign backward at the
     training shapes (B=2, R=512, C=256), fp32 and bf16, on random features
     and on features of constant 4 x 4 patches (many tied bins): codes
     identical to the plain version's, gradients against the plain backward;
     times beside bounds;
  4. serve requests of 2 synthetic uint8 800 x 1333 images through
     `simpledet_torch.infer.Detector` built from config/faster_r50v1_fpn_1x.py
     (full width, seeded random weights), one of them with score_thr=0 so the
     per-class NMS sees 1000 live boxes per class; check the outputs, the
     kernels' launch counts on that run, and the detections against the same
     path with both kernels replaced by their plain versions;
  5. train the same config at full width (batch 2, 800 x 1333, seeded
     weights, synthetic data): the box head's loss against the mean
     cross-entropy of its logits; 2 warm-up steps, 5 timed steps with finite
     losses, launch counts on the timed steps, frozen parameters unchanged
     and trained ones moved; then one step from a copied state with the
     kernels and one with the plain versions, losses and gradients compared;
  6. print the `kernels` JSON line, the card's line, and {"ok": true, ...}.

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
R_TRAIN = 512                  # sampled rois per image in the training step
LEVEL_HW = [(200, 334), (100, 167), (50, 84), (25, 42)]
STRIDES = (4, 8, 16, 32)

# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s; float32 outside the
# tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float operations a kernel must do: NMS per box pair (iw, ih: 2 min, 2 max,
# 2 sub, 2 add; inter: 2 max, 1 mul; union: 1 add, 1 sub, 1 max; 1 div;
# 1 compare) and per box (its area: 2 sub, 2 add, 1 mul); RoIAlign forward
# per output value (4 samples x (4 mul + 3 add) + 3 max); RoIAlign backward
# per output value (1 div) and per tied sample (4 taps x (weight x share:
# 1 mul; accumulate: 1 add)).
NMS_OPS_PER_PAIR, NMS_OPS_PER_BOX, ROI_OPS_PER_OUT = 16, 5, 31
BWD_OPS_PER_OUT, BWD_OPS_PER_TIED_SAMPLE = 1, 8


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
    # max_abs_err: the number of keep flags that differ from the plain version
    tot = dict(ms=0.0, plain_ms=0.0, ops=0.0, nbytes=0.0, diff=0)
    # the serving forward at batch 2: proposals (B x 5 pools of 1000 at 0.7)
    # and the per-class NMS (B x 80 classes of 1000 at 0.5); then the
    # training step's proposals (B x 5 pools of 2000 at 0.7)
    for p, n, thr, serving in ((B * 5, 1000, 0.7, True),
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
        if serving:
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("ops", ops),
                         ("nbytes", nbytes), ("diff", diff)):
                tot[k] += v
        else:
            train = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         max_abs_err=float(diff))
    bms, by = bound_ms(tot["nbytes"], tot["ops"])
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bms,
                bound_by=by, max_abs_err=float(tot["diff"]), train=train)


def mixed_rois(rng, dev, r=R):
    """r rois per image, log-uniform sizes over the image, plus
    extreme-aspect, edge and out-of-image rois."""
    xy = rng.uniform(0, [W, H], (B, r, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(1000), (B, r, 2)))
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
    img = torch.arange(B, device=rois.device).repeat_interleave(
        rois.shape[1])
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


# --------------------------------------------------------------- phase 3b


def patches(rng, feats, size=4):
    """Features of constant size x size patches, a quarter of them 0: many
    bins then have tied samples."""
    out = []
    for f in feats:
        b, h, w, c = f.shape
        v = rng.randn(b, -(-h // size), -(-w // size), c) * (
            rng.rand(b, -(-h // size), -(-w // size), 1) > 0.25)
        v = np.repeat(np.repeat(v, size, 1), size, 2)[:, :h, :w]
        out.append(torch.from_numpy(v.astype(np.float32)).to(f.device))
    return out


def check_roi_align_train(dev):
    """Forward with tie codes and backward at the training shapes. Codes and
    (rounded) outputs identical to the plain version; fp32 gradients within
    1e-5 of each level's max |grad| of the plain backward (atomics reorder
    the sums); bf16 within one bf16 ulp of the plain fp32 result rounded
    once. Times on the random input."""
    from simpledet_torch.kernels import roi_align as kroi

    rng = np.random.RandomState(2)
    rand32 = [torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32))
              .to(dev) for h, w in LEVEL_HW]
    rois = mixed_rois(rng, dev, R_TRAIN)
    inputs = {"random": rand32, "patches": patches(rng, rand32)}
    fwd, bwd = {}, {}
    for (kind, feats32), dt in [(i, d) for i in inputs.items()
                                for d in (torch.float32, torch.bfloat16)]:
        name = str(dt).split(".")[-1]
        feats = [f.to(dt) for f in feats32]
        out, codes = kroi.roi_align_fwd_cuda(feats, rois, STRIDES,
                                             with_codes=True)
        torch.cuda.synchronize()
        want_out, want_codes = kroi.multilevel_roi_align_plain(
            [f.float() for f in feats], rois, STRIDES, with_codes=True)
        if not torch.equal(codes, want_codes):
            raise AssertionError(f"tie codes {kind} {name}: "
                                 f"{int((codes != want_codes).sum())} differ")
        fwd_err = float((out.float() - want_out.to(dt).float()).abs().max())
        if fwd_err:
            raise AssertionError(f"roi_align forward {kind} {name} differs "
                                 f"by up to {fwd_err:.3g}")
        g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(
            dev, dt)
        got = kroi.roi_align_bwd_cuda(g, codes, rois, LEVEL_HW,
                                      strides=STRIDES, dtype=dt)
        torch.cuda.synchronize()
        want = kroi.multilevel_roi_align_bwd_plain(
            g.float(), codes, rois, LEVEL_HW, strides=STRIDES,
            dtype=torch.float32)
        err = rel = 0.0
        for gl, wl in zip(got, want):
            ref = wl.to(dt).float()
            scale = float(wl.abs().max())
            if dt == torch.float32:
                tol = dict(rtol=0, atol=1e-5 * scale)
            else:
                tol = dict(rtol=2 ** -7, atol=1e-5 * scale)
            torch.testing.assert_close(gl.float(), ref, **tol)
            err = max(err, float((gl.float() - ref).abs().max()))
            rel = max(rel, float((gl.float() - ref).abs().max())
                      / max(scale, 1e-30))
        popcount = sum((codes.int() >> s) & 1 for s in range(4))
        tied = float((popcount > 1).float().mean())
        log(f"roi_align train {kind} {name}: codes identical ({tied:.1%} of "
            f"values tied), backward max_abs_err {err:.3g} "
            f"({rel:.3g} of the level's max |grad|)")
        if kind != "random":
            continue
        isz = feats[0].element_size()
        touched = touched_bytes(kroi, rois, isz)
        ms = cuda_ms(lambda: kroi.roi_align_fwd_cuda(
            feats, rois, STRIDES, with_codes=True), 20)
        ms_nocodes = cuda_ms(lambda: kroi.roi_align_fwd_cuda(
            feats, rois, STRIDES), 20)
        plain_ms = cuda_ms(lambda: kroi.multilevel_roi_align_plain(
            feats, rois, STRIDES, with_codes=True), 3, 1)
        nbytes = touched + rois.numel() * 4 + out.numel() * isz + codes.numel()
        bms, by = bound_ms(nbytes, ROI_OPS_PER_OUT * out.numel())
        log(f"roi_align_fwd with codes {name} B={B} R={R_TRAIN} C={C}: "
            f"kernel {ms:.4f} ms (without codes {ms_nocodes:.4f}), plain "
            f"{plain_ms:.4f} ms, bound {bms:.6f} ms ({by}, "
            f"{nbytes / 1e6:.1f} MB)")
        fwd[name] = dict(ms=ms, ms_without_codes=ms_nocodes,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         max_abs_err=fwd_err)
        ms = cuda_ms(lambda: kroi.roi_align_bwd_cuda(
            g, codes, rois, LEVEL_HW, strides=STRIDES, dtype=dt), 20)
        plain_ms = cuda_ms(lambda: kroi.multilevel_roi_align_bwd_plain(
            g, codes, rois, LEVEL_HW, strides=STRIDES, dtype=dt), 3, 1)
        # the function reads g, the codes and the rois and writes every
        # level's gradient map, each once, in the features' dtype
        maps = sum(B * h * w * C for h, w in LEVEL_HW) * isz
        nbytes = g.numel() * isz + codes.numel() + rois.numel() * 4 + maps
        ops = (BWD_OPS_PER_OUT * out.numel()
               + BWD_OPS_PER_TIED_SAMPLE * float(popcount.sum()))
        bms, by = bound_ms(nbytes, ops)
        # not in the bound: this design's fp32 atomics read and write each
        # touched gradient cell
        atomic_bytes = 2 * touched_bytes(kroi, rois, 4)
        log(f"roi_align_bwd {name} B={B} R={R_TRAIN} C={C}: kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, bound {bms:.6f} ms ({by}, "
            f"{nbytes / 1e6:.1f} MB); the atomics' read-modify-write spans "
            f"{atomic_bytes / 1e6:.1f} MB of touched fp32 cells")
        bwd[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         max_abs_err=err, atomic_rmw_bytes=atomic_bytes)
    return fwd, bwd


# ---------------------------------------------------------------- phase 4


def zero_counts():
    from simpledet_torch.kernels import nms as knms
    from simpledet_torch.kernels import roi_align as kroi

    knms.launches = kroi.launches = kroi.bwd_launches = 0


def read_counts(path, required):
    """The launch counts since zero_counts(); each kernel of `required`
    must have been launched."""
    from simpledet_torch.kernels import nms as knms
    from simpledet_torch.kernels import roi_align as kroi

    counts = {"nms": knms.launches, "roi_align_fwd": kroi.launches,
              "roi_align_bwd": kroi.bwd_launches}
    log(f"{path} path launches {counts}")
    for name in required:
        if counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path} path")
    return counts


def serve(dev, smi):
    from simpledet_torch.infer import Detector, synthetic_batch
    from simpledet_torch.kernels import nms as knms
    from simpledet_torch.kernels import roi_align as kroi

    det = Detector(CONFIG, device=dev, seed=0)
    requests = [synthetic_batch(B, H, W, seed) for seed in range(4)]
    requests = [(x.to(dev), i) for x, i in requests]
    det.detect(*requests[0])                       # warm-up: cuDNN plans
    torch.cuda.synchronize()

    zero_counts()
    t0 = time.perf_counter()
    results = [det.detect(x, i) for x, i in requests[1:]]
    torch.cuda.synchronize()
    ms_img = (time.perf_counter() - t0) * 1e3 / (B * (len(requests) - 1))
    live = det.detect(*requests[0], score_thr=0.0)
    torch.cuda.synchronize()
    counts = read_counts("serving", ("nms", "roi_align_fwd"))
    if counts["roi_align_bwd"]:
        raise AssertionError("serving launched the RoIAlign backward")

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


# ---------------------------------------------------------------- phase 5

TRAIN_WARMUP, TRAIN_TIMED = 2, 5
LOSSES = ("bbox_cls_loss", "bbox_reg_loss", "rpn_cls_loss", "rpn_reg_loss",
          "total_loss")


def plain_kernels():
    """Context: the training path with the NMS and RoIAlign kernels replaced
    by their plain versions (the RoIAlign backward by torch.autograd of the
    plain forward)."""
    import contextlib

    import simpledet_torch.models.faster_rcnn as frcnn
    import simpledet_torch.ops.nms as onms
    from simpledet_torch.kernels import nms as knms
    from simpledet_torch.kernels import roi_align as kroi

    @contextlib.contextmanager
    def swapped():
        saved = (onms.nms_keep_sorted, frcnn.multilevel_roi_align)
        onms.nms_keep_sorted = knms.nms_keep_sorted_plain
        frcnn.multilevel_roi_align = kroi.multilevel_roi_align_plain
        try:
            yield
        finally:
            onms.nms_keep_sorted, frcnn.multilevel_roi_align = saved
    return swapped()


def train(dev, smi):
    import copy

    from simpledet_torch.core.train import Trainer
    from simpledet_torch.train import PhaseTimer, synthetic_train_batch

    trainer = Trainer.from_config(CONFIG, device=dev, seed=0)
    model = trainer.model
    images, im_info, gt = synthetic_train_batch(B, H, W, 0)
    images = images.to(dev)
    trainer.fold_batch_stats(images, im_info)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def check(i, losses):
        vals = {k: float(losses[k]) for k in LOSSES}
        log(f"train step {i}: " + ", ".join(f"{k} {v:.5f}"
                                            for k, v in vals.items()))
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"train step {i}: a loss is not finite")
        return vals

    # the box head's loss against the definition of its cross-entropy (the
    # mean over the b * r rois of logsumexp(logits) - logit[label]), in
    # float64 on the logits and labels of one train forward without grad
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        data, info = trainer._inputs(images, im_info)
        losses, aux = model(data, info, torch.as_tensor(gt).to(dev),
                            mode="train", generator=gen)
    z = aux["bbox_cls_logit"].double()
    label = aux["bbox_label"].long()[..., None]
    want = float((torch.logsumexp(z, -1) - z.gather(-1, label)[..., 0]).mean())
    got = float(losses["bbox_cls_loss"])
    if abs(got - want) > 1e-5 * want:
        raise AssertionError(f"bbox_cls_loss {got} is not the mean "
                             f"cross-entropy of its logits, {want}")
    log(f"bbox_cls_loss {got:.6f} equals the rois' mean cross-entropy "
        f"{want:.6f} within 1e-5")

    first = check(0, trainer.step(images, im_info, gt))
    # gross checks only: seeded heads give near-uniform softmaxes, CE about
    # log(classes) plus half the logits' variance (which this check does not
    # measure); a wrong normalisation is off by orders of magnitude
    for k, want, tol in (("bbox_cls_loss", np.log(81), 1.0),
                         ("rpn_cls_loss", np.log(2), 0.2)):
        if abs(first[k] - want) > tol:
            raise AssertionError(f"step 0 {k} {first[k]:.4f} is not near "
                                 f"{want:.4f}")
    for i in range(1, TRAIN_WARMUP):
        check(i, trainer.step(images, im_info, gt))
    torch.cuda.synchronize()

    timer = PhaseTimer()
    trainer.timer = timer
    zero_counts()
    step_s = []
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_TIMED):
        t0 = time.perf_counter()
        timer.start()
        losses = trainer.step(images, im_info, gt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        timer.collect()
        check(i, losses)
    counts = read_counts("training", ("nms", "roi_align_fwd",
                                      "roi_align_bwd"))
    trainer.timer = None
    ms_step = 1e3 * sum(step_s) / len(step_s)
    split = {k: v / TRAIN_TIMED for k, v in timer.totals.items()}
    log(f"training: {ms_step:.3f} ms/step ({B * 1e3 / ms_step:.2f} img/s) at "
        f"{H}x{W}, batch {B}, fp32 without TF32, on {smi}; per step "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))

    after = model.state_dict()
    for name, before in start.items():
        same = torch.equal(after[name], before)
        if trainer.trainable[name] == same:
            raise AssertionError(f"{name}: {'trainable but unchanged' if same else 'frozen but moved'}")
    n_frozen = sum(not t for t in trainer.trainable.values())
    log(f"{n_frozen} frozen parameters and buffers bit-unchanged, "
        f"{len(start) - n_frozen} trained ones moved")

    # one step from a copied state, with the kernels and with plain versions
    saved = (copy.deepcopy(model.state_dict()),
             copy.deepcopy(trainer.optimizer.state_dict()), trainer.step_count)

    def one_step():
        model.load_state_dict(saved[0])
        trainer.optimizer.load_state_dict(copy.deepcopy(saved[1]))
        trainer.step_count = saved[2]
        trainer.generator.manual_seed(1234)
        zero_counts()
        losses = trainer.step(images, im_info, gt)
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return losses, grads

    k_losses, k_grads = one_step()
    read_counts("kernel step", ("nms", "roi_align_fwd", "roi_align_bwd"))
    with plain_kernels():
        p_losses, p_grads = one_step()
    if any(read_counts("plain step", ()).values()):
        raise AssertionError("the plain step launched a kernel")
    for k in LOSSES:
        a, b = float(k_losses[k]), float(p_losses[k])
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"{k}: kernels {a} vs plain {b}")
    worst = ("", 0.0)
    for n, g in p_grads.items():
        err = float((k_grads[n] - g).abs().max()) / max(
            float(g.abs().max()), 1e-30)
        worst = max(worst, (n, err), key=lambda t: t[1])
    if worst[1] > 1e-4 or set(k_grads) != set(p_grads):
        raise AssertionError(f"gradient {worst[0]}: kernels vs plain "
                             f"{worst[1]:.3g} of its max |grad|")
    log(f"kernel step agrees with the plain step: losses within 1e-5, "
        f"{len(p_grads)} gradients within {worst[1]:.3g} of their max |grad| "
        f"(worst {worst[0]})")
    return counts, ms_step, split


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
    fwd_train, bwd = check_roi_align_train(dev)
    serve_counts, ms_img = serve(dev, smi)
    train_counts, ms_step, split = train(dev, smi)

    def launches(name):
        return dict(launches=serve_counts[name] + train_counts[name],
                    launches_by_path={"serving": serve_counts[name],
                                      "training": train_counts[name]})

    source = "simpledet_torch/csrc/roi_align.cu"
    kernels = [
        dict(name="nms", route="cuda", source="simpledet_torch/csrc/nms.cu",
             replaces="simpledet_tpu/kernels/nms_pallas.py:31",
             **launches("nms"), max_abs_err=nms["max_abs_err"],
             ms=nms["ms"], plain_ms=nms["plain_ms"],
             bound_ms=nms["bound_ms"], bound_by=nms["bound_by"],
             library_ms=None, training=nms["train"]),
        dict(name="roi_align_fwd", route="cuda", source=source,
             replaces="simpledet_tpu/kernels/roi_align_pallas.py:267",
             **launches("roi_align_fwd"),
             max_abs_err=roi["float32"]["max_abs_err"],
             ms=roi["float32"]["ms"], plain_ms=roi["float32"]["plain_ms"],
             bound_ms=roi["float32"]["bound_ms"],
             bound_by=roi["float32"]["bound_by"], library_ms=None,
             bf16=roi["bfloat16"], with_codes=fwd_train),
        dict(name="roi_align_bwd", route="cuda", source=source,
             replaces="simpledet_tpu/kernels/roi_align_pallas.py:351",
             **launches("roi_align_bwd"),
             max_abs_err=bwd["float32"]["max_abs_err"],
             ms=bwd["float32"]["ms"], plain_ms=bwd["float32"]["plain_ms"],
             bound_ms=bwd["float32"]["bound_ms"],
             bound_by=bwd["float32"]["bound_by"], library_ms=None,
             bf16=bwd["bfloat16"]),
    ]
    log(json.dumps({"serving_ms_per_image": ms_img,
                    "training_ms_per_step": ms_step,
                    "training_img_per_s": B * 1e3 / ms_step,
                    "training_split_ms": split, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
