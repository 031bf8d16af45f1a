"""Where a serving request's time goes on the card.

    python -m simpledet_torch.breakdown --config config/faster_r50v1_fpn_1x.py \
        --shape 800 1333 --batch 2 --count 20

Runs the test path stage by stage (normalise, backbone + FPN, RPN head,
proposals, RoIAlign, box head + decode, per-class NMS; for a Cascade R-CNN
config, RoIAlign and box head + refine of each of its three stages, then the
score averaging over the three heads; for a Mask R-CNN config, then the mask
RoIAlign on the kept boxes and the mask head with its sigmoid; pasting the
masks into the image is eval work, outside the request; for a RetinaNet
config (FCOS and FreeAnchor too): normalise, backbone, neck, subnets,
decode and top-k, per-class NMS (a RepPoints config splits its subnets into
the towers with the init points and the deformable refine stage, profiler
range `reppoints_refine`); for an RPN-only config the stages up to the
proposals; for a C4 / TridentNet config: normalise, trunk (stem and stages 1-2), trident stage
(stage 3 on every branch), RPN head, proposals, RoIAlign, C5 head, then the
decode, the branches' merge and the per-class NMS; a DCN C4 config's
backbone is one stage; a SEPC RetinaNet's neck splits into its FPN and its
SEPC part; a PAFPN or FPG Faster R-CNN splits its backbone and its neck; a
TSD config's box head stage is the TSD head with its two deformable pools
(profiler range `tsd_pool`) and the decode against rois_r; a Mask Scoring
R-CNN config adds the MaskIoU head and the mask scores after the mask
head), timing each stage with CUDA events over `count` requests, then
traces `count` whole requests with torch.profiler for the device's busy
share, the top kernels by device time and the device time of the profiler
ranges the request entered (`PROFILER_RANGES`: the deformable convs'
`deform_conv`, the DCN units' `dcn_unit`, SEPC's `sepc`, RepPoints'
`reppoints_refine`, the mask branch's, TSD's `tsd_pool`, the MaskIoU
head's).
Prints one JSON object with the card's name and power limit and how the
config computes (fp32 without TF32, or bf16 with fp32 islands), as the infer
CLI and chip_smoke.py run.
"""
import argparse
import json
import time

import torch

from simpledet_torch.eval.postprocess import per_class_nms
from simpledet_torch.infer import (Detector, card_name_and_power, full_fp32,
                                   precision, synthetic_batch)
from simpledet_torch.models import (dcn, mask_rcnn, msrcnn, reppoints, sepc,
                                    tsd)
from simpledet_torch.models.cascade_rcnn import STAGES, CascadeRcnn
from simpledet_torch.models.faster_rcnn import RpnOnly
from simpledet_torch.models.fpg import FPGNeck, PAFPNNeck
from simpledet_torch.models.mask_rcnn import MaskFasterRcnn, class_channel
from simpledet_torch.models.msrcnn import MaskScoringFasterRcnn
from simpledet_torch.models.reppoints import RepPoints
from simpledet_torch.models.retinanet import RetinaNet
from simpledet_torch.models.tridentnet import TridentFasterRcnn
from simpledet_torch.models.tsd import TSDFasterRcnn
from simpledet_torch.ops.image import device_normalize

# the models' torch.profiler ranges, each a span over the kernels launched
# inside it
PROFILER_RANGES = (mask_rcnn.PROFILER_RANGES + dcn.PROFILER_RANGES
                   + sepc.PROFILER_RANGES + reppoints.PROFILER_RANGES
                   + tsd.PROFILER_RANGES + msrcnn.PROFILER_RANGES)


def cascade_stages(m, st, im_info):
    """The three stages and the score averaging of a CascadeRcnn's test
    path, as (name, thunk) pairs from st["props"] to st["score"] and
    st["boxes"]."""
    out = []

    def roi_align(i):
        def fn():
            st["feat"] = m.extract_rois(st["pyr"], st["cur"] if i else
                                        st["props"])
        return fn

    def head(i):
        def fn():
            st["cls"], delta = m.heads[i](st["feat"])
            st["cur"] = m.refine(st["cur"] if i else st["props"], delta,
                                 im_info, i)
        return fn

    for i, s in enumerate(STAGES):
        out += [(f"roi_align_{s}", roi_align(i)), (f"box_head_{s}", head(i))]

    def average():
        st["score"], st["boxes"] = m.average_scores(st["feat"], st["cls"],
                                                    st["cur"])

    return out + [("score_average", average)]


def trident_stages(m, st, im_info, norm, nms):
    """A TridentFasterRcnn's test path, its backbone split into the shared
    trunk and the trident stage, the RoIAlign and the C5 head on the
    branches folded into the image axis, the decode and the branches' merge
    with the per-class NMS."""
    b = im_info.shape[0]
    im_info_b = m.fold(im_info)

    def trunk():
        st["trunk"] = m.backbone.stem_and_trunk(st["x"].permute(0, 3, 1, 2))

    def trident_stage():
        c4 = m.backbone.branches(st["trunk"])
        st["pyr"] = m.neck({"c4": c4, "stride16": c4})

    def backbone():                     # a C4 ResNet without branches
        st["pyr"] = m.pyramid(st["x"])

    split = ([("trunk", trunk), ("trident_stage", trident_stage)]
             if hasattr(m.backbone, "stem_and_trunk")
             else [("backbone", backbone)])

    def rpn_head():
        st["rpn"] = m.rpn_module(st["pyr"])

    def proposals():
        st["props"], _ = m.rpn.proposals(st["rpn"], im_info_b)

    def roi_align():
        st["feat"] = m.extract_rois(st["pyr"], st["props"])

    def c5_head():
        st["head"] = m.bbox_head(st["feat"])

    def decode_nms():
        st["score"], st["boxes"] = m.merge_branches(
            *m.predict(*st["head"], st["props"], im_info_b), b)
        return nms()

    return [("normalize", norm), *split, ("rpn_head", rpn_head),
            ("proposals", proposals), ("roi_align", roi_align),
            ("c5_head", c5_head), ("decode_nms", decode_nms)]


def stages(det, images, im_info):
    """The request as (name, thunk) pairs, each thunk reading the previous
    stage's result from `st`; the last one returns the detections."""
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
        st["post"] = per_class_nms(st["score"], st["boxes"],
                                   score_thr=det.score_thr,
                                   nms_thr=det.nms_thr, max_det=det.max_det)
        return st["post"]

    if isinstance(m, RetinaNet):
        def backbone():
            st["feats"] = m.backbone(st["x"].permute(0, 3, 1, 2))

        def neck():
            st["pyr"] = m.neck(st["feats"])

        def fpn():
            st["fpn"] = m.neck.fpn(st["feats"])

        def sepc_part():
            st["pyr"] = m.neck.sepc(st["fpn"])

        necks = ([("neck_fpn", fpn), ("neck_sepc", sepc_part)]
                 if isinstance(m.neck, sepc.SEPCNeck) else [("neck", neck)])

        def subnets():
            st["outs"] = m.head_module(st["pyr"])

        def towers():
            st["towers"] = m.head_module.towers(st["pyr"])

        def refine():
            st["outs"] = m.head_module.refine(st["towers"])

        heads = ([("towers", towers), ("refine", refine)]
                 if isinstance(m, RepPoints) else [("subnets", subnets)])

        def decode():
            out = m.test_outputs(st["outs"], im_info)
            st["score"], st["boxes"] = out["cls_score"], out["bbox_xyxy"]

        return [("normalize", norm), ("backbone", backbone), *necks,
                *heads, ("decode_topk", decode),
                ("per_class_nms", nms)]
    if isinstance(m, TridentFasterRcnn):
        return trident_stages(m, st, im_info, norm, nms)
    if isinstance(m, RpnOnly):
        def last_proposals():
            proposals()
            return st["props"]

        return [("normalize", norm), ("backbone_fpn", pyramid),
                ("rpn_head", rpn_head), ("proposals", last_proposals)]

    def backbone():
        st["feats"] = m.backbone(st["x"].permute(0, 3, 1, 2))

    def neck():
        st["pyr"] = m.neck(st["feats"])

    def tsd_head():
        _, _, cls, delta, rois_r = m.head(st["pyr"], st["props"])
        st["score"], st["boxes"] = m.predict(cls, delta, rois_r, im_info)

    def mask_roi_align():
        st["mask_feat"] = m.extract_mask_rois(st["pyr"], st["post"][0])

    def mask_head():
        st["mask_logit"] = class_channel(m.mask_head(st["mask_feat"]),
                                         st["post"][2])
        return (*st["post"], torch.sigmoid(st["mask_logit"]))

    def maskiou_head():
        return (*st["post"], torch.sigmoid(st["mask_logit"]),
                m.mask_scores(st["mask_feat"], st["mask_logit"],
                              st["post"][2], st["post"][1]))

    if isinstance(m.neck, (PAFPNNeck, FPGNeck)):
        front = [("backbone", backbone), ("neck", neck)]
    else:
        front = [("backbone_fpn", pyramid)]
    if isinstance(m, CascadeRcnn):
        middle = cascade_stages(m, st, im_info)
    elif isinstance(m, TSDFasterRcnn):
        # the TSD head with its two deformable pools, decoded on rois_r
        middle = [("roi_align", roi_align), ("tsd_head", tsd_head)]
    else:
        middle = [("roi_align", roi_align), ("box_head", head)]
    masks = ([("mask_roi_align", mask_roi_align), ("mask_head", mask_head)]
             if isinstance(m, MaskFasterRcnn) else [])
    if isinstance(m, MaskScoringFasterRcnn):
        masks.append(("maskiou_head", maskiou_head))
    return [("normalize", norm), *front, ("rpn_head", rpn_head),
            ("proposals", proposals), *middle, ("per_class_nms", nms),
            *masks]


def stage_times(steps, count):
    """({stage: ms per request}, wall ms per request) of the (name, thunk)
    pairs of `stages`: one warm-up request (kernel builds, cuDNN plans),
    then `count` requests with CUDA events around each stage."""
    for _, fn in steps:
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in steps]
    total = {name: 0.0 for name, _ in steps}
    t0 = time.perf_counter()
    for _ in range(count):
        for (name, fn), (a, b) in zip(steps, events):
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        for (name, _), (a, b) in zip(steps, events):
            total[name] += a.elapsed_time(b)
    wall = (time.perf_counter() - t0) * 1e3 / count
    return {k: v / count for k, v in total.items()}, wall


def device_profile(fn, count, top=15):
    """Trace `count` calls of fn with torch.profiler: (host ms per call,
    device busy ms per call, {kernel: device ms per call} of the `top`
    kernels, {profiler range: device ms per call of the kernels launched
    inside it} for the model's ranges that the calls entered
    (`PROFILER_RANGES`; a training step's: its forward's)). Device-side
    events only (kernels, copies): an operator's row repeats the device
    time of the kernels it launched."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / count
    # a profiler range also shows as a device-side span over its kernels:
    # not a kernel
    kernels = sorted(
        (e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.key not in PROFILER_RANGES),
        key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / count
    ranges = {e.key: e.device_time_total / 1e3 / count
              for e in prof.key_averages() if e.key in PROFILER_RANGES
              and e.device_type == torch.autograd.DeviceType.CPU}
    return traced_ms, busy_ms, {
        e.key[:80]: e.self_device_time_total / 1e3 / count
        for e in kernels[:top]}, ranges


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
    stage_ms, wall = stage_times(stages(det, images, im_info), args.count)
    traced_ms, busy_ms, top, ranges = device_profile(
        lambda: det.serve(images, im_info), args.count)
    print(json.dumps({
        "card": card_name_and_power(), "shape": [h, w], "batch": args.batch,
        "count": args.count, "precision": precision(det.model),
        "stage_ms_per_request": stage_ms,
        "stages_wall_ms_per_request": wall,
        "traced_request_ms": traced_ms,
        "device_busy_ms_per_request": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / traced_ms),
        "top_kernels_ms_per_request": top,
        "ranges_device_ms_per_request": ranges,
    }, indent=1))


if __name__ == "__main__":
    main()
