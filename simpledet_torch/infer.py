"""Serve a detector: uint8 image batches in, per-image detections out.

Counterpart of `detection_infer_speed.py --include-nms`: builds the test
detector from a config (seeded random weights), normalises uint8 NHWC batches
on the device, runs the test forward and the per-class NMS, and returns
boxes, scores and classes per image; a Mask R-CNN runs its NMS inside its
test forward and adds each kept box's class's mask probabilities (pasting
them into the image is eval work: `eval/segm.py`). A RetinaNet's test
forward (FCOS's and RepPoints' too) gives the top candidates of each
level, FreeAnchor's its top anchors with their full class rows, which the
per-class NMS takes as it takes a Faster R-CNN's rois. An RPN-only config
(`config/rpn_r50v1_fpn_1x.py`) serves proposals (`Detector.propose`), which
this CLI then times.

    python -m simpledet_torch.infer --config config/faster_r50v1_fpn_1x.py \
        --shape 800 1333 --batch 2 --count 20

prints ms/image with the card's name and power limit.
"""
import argparse
import subprocess
import time

import numpy as np
import torch

from simpledet_torch.dsl import detector_from_config
from simpledet_torch.eval.postprocess import per_class_nms
from simpledet_torch.models.faster_rcnn import RpnOnly
from simpledet_torch.models.mask_rcnn import MaskFasterRcnn
from simpledet_torch.ops.image import device_normalize


class Detector:
    """The config's test path on one device."""

    def __init__(self, config, *, device="cuda", seed=0):
        self.model, self.spec = detector_from_config(config, device=device,
                                                     seed=seed)
        self.device = next(self.model.parameters()).device
        t = self.spec.test
        # the JAX package's CLIs read `min_det_score or 0.05`: 0 means 0.05
        self.score_thr = t.min_det_score or 0.05
        self.nms_thr = (t.nms.thr if t.nms else None) or 0.5
        self.max_det = t.max_det_per_image or 100
        self.has_masks = isinstance(self.model, MaskFasterRcnn)
        self.proposals_only = isinstance(self.model, RpnOnly)

    def _inputs(self, images, im_info):
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        im_info = torch.as_tensor(im_info, dtype=torch.float32).to(
            self.device, non_blocking=True)
        if self.spec.pixel_norm is not None:
            images = device_normalize(images, im_info, *self.spec.pixel_norm)
        return images, im_info

    @torch.no_grad()
    def propose(self, images, im_info):
        """The rpn_test forward (a two-stage detector's or an RpnOnly's):
        (proposal [B, post, 4], proposal_score [B, post]), padded rows
        scored NEG_INF."""
        images, im_info = self._inputs(images, im_info)
        out = self.model(images.float(), im_info, mode="rpn_test")
        return out["proposal"], out["proposal_score"]

    @torch.no_grad()
    def detect(self, images, im_info, *, score_thr=None):
        """images [B, H, W, 3] uint8, im_info [B, 3] = (h', w', scale) ->
        (boxes [B, max_det, 4], scores, classes, valid), padded rows
        marked by valid = False; a Mask R-CNN adds mask_prob [B, max_det,
        M, M]. An RPN-only model has no detections: `propose`."""
        if self.proposals_only:
            raise NotImplementedError("an RPN-only model serves proposals: "
                                      "Detector.propose")
        images, im_info = self._inputs(images, im_info)
        thr = self.score_thr if score_thr is None else score_thr
        if self.has_masks:
            out = self.model(images.float(), im_info, mode="test",
                             score_thr=thr)
            return (out["bbox_xyxy"], out["cls_score"], out["cls"],
                    out["det_valid"], out["mask_prob"])
        out = self.model(images.float(), im_info, mode="test")
        return per_class_nms(out["cls_score"], out["bbox_xyxy"],
                             score_thr=thr, nms_thr=self.nms_thr,
                             max_det=self.max_det)

    def serve(self, images, im_info):
        """One request as the config serves it: an RPN-only model's
        proposals (`propose`), any other model's detections (`detect`)."""
        if self.proposals_only:
            return self.propose(images, im_info)
        return self.detect(images, im_info)

    def __call__(self, images, im_info, **kw):
        """List of per-image dicts {"boxes", "scores", "classes"} and, for a
        Mask R-CNN, "masks" (valid rows only, on the device)."""
        out = self.detect(images, im_info, **kw)
        valid = out[3]
        names = ("boxes", "scores", "classes", None, "masks")
        return [{n: t[i][valid[i]] for n, t in zip(names, out) if n}
                for i in range(len(valid))]


def full_fp32():
    """fp32 runs in true fp32: no TF32 in cuDNN convolutions (PyTorch's
    default allows it) nor in matrix products, so an fp32 config and a bf16
    config's fp32 islands both compute in fp32. bf16 matrix products keep
    fp32 accumulation throughout (no reduced-precision split-K reduction), as
    XLA accumulates them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def precision(model):
    """How a model computes, for the lines that report a time."""
    if any(getattr(m, "compute_dtype", None) == torch.bfloat16
           for m in model.modules()):
        return "bf16 with fp32 islands, TF32 off"
    return "fp32 without TF32"


def card_name_and_power():
    """nvidia-smi's `name, power.limit` line for card 0."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def synthetic_batch(batch, h, w, seed):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (batch, h, w, 3), dtype=np.uint8)
    im_info = np.tile(np.float32([[h, w, 1.0]]), (batch, 1))
    return torch.from_numpy(images), torch.from_numpy(im_info)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--shape", nargs=2, type=int, default=[800, 1333])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--count", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    full_fp32()
    det = Detector(args.config, device=args.device, seed=args.seed)
    h, w = args.shape
    images, im_info = synthetic_batch(args.batch, h, w, args.seed)
    images = images.to(det.device)

    def sync():
        if det.device.type == "cuda":
            torch.cuda.synchronize(det.device)

    det.serve(images, im_info)      # warm-up: kernel build, cuDNN plans
    sync()
    t0 = time.perf_counter()
    for _ in range(args.count):
        det.serve(images, im_info)
    sync()
    dt = time.perf_counter() - t0
    n_img = args.count * args.batch
    where = card_name_and_power() if det.device.type == "cuda" else "cpu"
    what = ("proposals" if det.proposals_only else "per-class NMS"
            + (" and the mask head" if det.has_masks else ""))
    print(f"{dt / n_img * 1000:.3f} ms per image ({n_img / dt:.2f} img/s) "
          f"at {h}x{w}, batch {args.batch}, incl. {what}, "
          f"{precision(det.model)}, on {where}")


if __name__ == "__main__":
    main()
