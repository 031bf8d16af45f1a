"""Where a serving request's time goes on the card.

    python -m simpledet_torch.breakdown --config config/faster_r50v1_fpn_1x.py \
        --shape 800 1333 --batch 2 --count 20

Runs the test path stage by stage (normalise, backbone + FPN, RPN head,
proposals, RoIAlign, box head + decode, per-class NMS), timing each stage with
CUDA events over `count` requests, then traces `count` whole requests with
torch.profiler for the device's busy share and the top kernels by device time.
Prints one JSON object with the card's name and power limit. fp32 without
TF32, as the infer CLI and chip_smoke.py run.
"""
import argparse
import json
import time

import torch

from simpledet_torch.eval.postprocess import per_class_nms
from simpledet_torch.infer import (Detector, card_name_and_power, full_fp32,
                                   synthetic_batch)
from simpledet_torch.ops.image import device_normalize


def stages(det, images, im_info):
    """The request as (name, thunk) pairs, each thunk reading the previous
    stage's result from `st`."""
    m, st = det.model, {}
    mean_std = det.spec.pixel_norm

    def norm():
        st["x"] = device_normalize(images, im_info, *mean_std)

    def pyramid():
        st["pyr"] = m.pyramid(st["x"])

    def rpn_head():
        st["rpn"] = m.rpn_module(st["pyr"])

    def proposals():
        st["props"], _ = m.rpn.proposals(st["rpn"], im_info)

    def roi_align():
        st["feat"] = m.extract_rois(st["pyr"], st["props"])

    def head():
        cls, delta = m.bbox_head(st["feat"])
        st["score"], st["boxes"] = m.predict(cls, delta, st["props"], im_info)

    def nms():
        per_class_nms(st["score"], st["boxes"], score_thr=det.score_thr,
                      nms_thr=det.nms_thr, max_det=det.max_det)

    return [("normalize", norm), ("backbone_fpn", pyramid),
            ("rpn_head", rpn_head), ("proposals", proposals),
            ("roi_align", roi_align), ("box_head", head),
            ("per_class_nms", nms)]


def device_profile(fn, count, top=15):
    """Trace `count` calls of fn with torch.profiler: (host ms per call,
    device busy ms per call, {kernel: device ms per call} of the `top`
    kernels). Device-side events only (kernels, copies): an operator's row
    repeats the device time of the kernels it launched."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / count
    kernels = sorted(
        (e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / count
    return traced_ms, busy_ms, {
        e.key[:80]: e.self_device_time_total / 1e3 / count
        for e in kernels[:top]}


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--shape", nargs=2, type=int, default=[800, 1333])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--count", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    full_fp32()
    det = Detector(args.config, device="cuda", seed=args.seed)
    h, w = args.shape
    images, im_info = synthetic_batch(args.batch, h, w, args.seed)
    images, im_info = images.to(det.device), im_info.to(det.device)
    steps = stages(det, images, im_info)
    for _, fn in steps:                  # warm-up: kernel build, cuDNN plans
        fn()
    torch.cuda.synchronize()

    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in steps]
    total = {name: 0.0 for name, _ in steps}
    t0 = time.perf_counter()
    for _ in range(args.count):
        for (name, fn), (a, b) in zip(steps, events):
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        for (name, _), (a, b) in zip(steps, events):
            total[name] += a.elapsed_time(b)
    wall = (time.perf_counter() - t0) * 1e3 / args.count
    stage_ms = {k: v / args.count for k, v in total.items()}

    traced_ms, busy_ms, top = device_profile(
        lambda: det.detect(images, im_info), args.count)
    print(json.dumps({
        "card": card_name_and_power(), "shape": [h, w], "batch": args.batch,
        "count": args.count,
        "stage_ms_per_request": stage_ms,
        "stages_wall_ms_per_request": wall,
        "traced_request_ms": traced_ms,
        "device_busy_ms_per_request": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / traced_ms),
        "top_kernels_ms_per_request": top,
    }, indent=1))


if __name__ == "__main__":
    main()
