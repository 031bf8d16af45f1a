"""Drive the PyTorch port's serving, training and CLI paths on one NVIDIA card
and check them.

    python3 chip_smoke.py

Phases, each fatal on error:
  1. environment: torch and CUDA versions, nvcc, the card's name and power
     limit; TF32 off for convolutions and matrix products;
  2. build the CUDA kernels from `simpledet_torch/csrc/` (one nvcc each, in
     parallel);
  3. hold the NMS and RoIAlign-forward kernels against their plain PyTorch
     versions at the serving path's shapes and time both with CUDA events
     beside the kernel's bound; the RoIAlign forward bit for bit (bf16: the
     plain fp32 result rounded once) on mixed rois and on each edge-case
     roi set below;
     NMS edge cases (n = 1, 63, 64, 65, 2000, a suppression chain across
     every block boundary, all invalid, all identical, no overlaps) give
     keep flags identical to the plain version's; kept rows per problem
     printed (the scan's chain length);
  3b. the RoIAlign forward with tie codes and the RoIAlign backward at the
     training shapes (B=2, R=512, C=256), fp32 and bf16, on random features
     and on features of constant 4 x 4 patches (many tied bins), with mixed,
     identical, whole-image/extreme-aspect, edge and collapsed rois: codes
     and outputs identical to the plain version's, gradients against the
     plain backward; times beside bounds, and the forward's (serving and
     training) and the backward's time on each roi set;
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
  6. phase 4 on config/faster_r50v1_fpn_bf16_1x.py: bf16 with fp32 islands,
     so the RoIAlign forward runs on bf16 features;
  7. phase 5 on the bf16 config: the RoIAlign forward and backward in bf16,
     the kernel step against the plain step at a bf16 tolerance;
  8. in a fresh temporary directory: a synthetic micro-COCO of 8 images at
     800 x 1333 (roidb pickles and an annotation json under the paths the
     configs name), a ResNet-50 pretrain at the config's
     ModelParam.pretrain.prefix (seeded weights, one loader batch's
     statistics folded in), then `simpledet_torch.detection_train` on the
     bf16 config for 4 iterations: the pretrain's leaves loaded, finite
     losses, checkpoint-0001.params read back equal to the trained state bit
     for bit;
  9. `simpledet_torch.detection_test` on the fp32 config over the same
     images from that checkpoint: result.json and the 12-key COCO summary,
     img/s;
  then, in a fresh temporary directory with copies of the two configs and
  their synthetic data (`simpledet_torch/data/synthetic.py`):
  A. config/flagship_synth_curve.py (R50-FPN, bf16, SyncBN, nothing frozen)
     at full width in a 1-rank NCCL process group with the model in DDP, on
     a batch of its synthetic data: phase 5's checks (2 warm-up and 5 timed
     steps, launches, the kernel step against the plain step at the bf16
     tolerance), every running statistic moved; ms/step beside phase 7's
     FrozenBN bf16 step;
  B. `torchrun --nproc_per_node 1` of this script's `--train-cli-rank`
     mode: detection_train's train_net on that config for one epoch (4
     iterations) over NCCL and DDP, writing .params and .batch_stats; then
     detection_test on them, which must report the running statistics
     loaded;
  C. config/converge_test.py (depth-18 FPN, SyncBN) from scratch at batch 8
     for 400 steps through the train CLI, the three kernels held against
     their plain versions at its shapes on the trained model's pyramid, then
     the test CLI on the train set: the loss, AP and AP50 gates of the JAX
     package's tests/test_convergence.py, AP beside the JAX record;
  D. serve config/cascade_r50v1_fpn_1x.py (Cascade R-CNN, R50v1-FPN, 81
     classes, fp32 without TF32) as phase 4 does: 3 RoIAlign launches a
     request; then each kernel call of one request (the three stages'
     RoIAlign, the proposals' and the per-class NMS) held against its plain
     version on that request's own inputs;
  E. train it as phase 5 does (3 RoIAlign forwards and backwards a step;
     stage 1's cross-entropy checked as the flagship's box loss), with the
     device's idle share of 3 traced steps; one more step recorded;
  F. K1 with codes and K2 on each stage's rois of that recorded step,
     against their plain versions; K2's time per stage and how many rois
     meet its busiest 4 x 4-cell tile, beside phase 3b's mixed and
     identical roi sets;
  G. phase D on config/cascade_r101v1_fpn_1x.py (R101v1-FPN);
  I. serve config/mask_r50v1_fpn_1x.py (Mask R-CNN, R50v1-FPN, 81 classes,
     fp32 without TF32) as phase 4 does: 2 RoIAlign launches a request (7 x
     7 on the proposals, 14 x 14 on the kept boxes), detections and
     mask_prob against the plain-version path (1e-4); the kernels on one
     request's own inputs;
  J. train it as phase 5 does, each gt box with its inscribed ellipse's
     16-gon (edge tensor [100, 1250, 5]): 2 RoIAlign forwards and
     backwards a step; the device's idle share and the mask branch's
     profiler ranges over 3 traced steps; on one more recorded step the
     mask targets' time and memory, K1 with codes and K2 at 7 x 7 (512
     rois) and at 14 x 14 (the 128 fg rois an image) against their plain
     versions, K2's busiest 4 x 4-cell tile, K1 and K2 at 14 x 14 beside
     their bounds;
  K. in a fresh temporary directory: an ellipse-polygon micro-COCO through
     the train CLI on config/converge_mask.py (20 iterations) and
     `simpledet_torch.mask_test`: bbox and segm summaries, the result json
     in COCO RLE;
  M. serve config/retina_r50v1_fpn_1x.py (RetinaNet, R50v1-FPN P3-P7, 81
     classes, 256-wide neck and towers, fp32 without TF32) as phase 4 does:
     no RoIAlign, one NMS launch a request (the per-class NMS over the 5
     levels' top 1000 candidates: 160 problems of 5000 boxes at batch 2);
     one request at score_thr=0, so every box of those problems is live;
     detections against the same path with the NMS's plain version (in
     chunks of problems) within 1e-4; K3 on that request's own 160 x 5000
     call against the plain version, chunked, its largest keep-flag
     difference (none), time, bound and suppression mask; the request's
     breakdown (backbone, neck, subnets, decode and top-k, per-class NMS)
     and the device's idle share; ms per image beside phase 4's; then
     config/retina_r101v1_fpn_1x.py served, one line;
  N. train config/retina_r50v1_fpn_1x.py at full width (batch 2, 800 x
     1333, 20 gt boxes an image: about 201,600 anchors an image through the
     dense targets and the focal loss): the focal loss against its float64
     definition, the dense targets' time, 2 warm-up and 5 timed steps with
     finite losses, frozen parameters unchanged and trained ones moved,
     ms/step and the idle share of 3 traced steps beside phase 5's step;
     this path launches no counterpart of a TPU kernel, and says so;
  O. in a fresh temporary directory: config/retina_micro_test.py through
     the train CLI (8 iterations on the synthetic micro-COCO), then
     `simpledet_torch.detection_test` on its checkpoint (COCO eval);
  then, beside phases A-C (H and Z in child processes side by side with
  phase C, V in one side by side with phase L; learning runs are bound by
  the host, the card mostly idle):
  H. config/converge_cascade.py (depth-18 FPN, SyncBN, 3 stages) from
     scratch at batch 8 for 480 steps through the train CLI, the three
     kernels at its shapes, phase F's readings on one more step of the
     trained model (whose rois cluster on the gt boxes), the test CLI: the
     gates of the JAX package's tests/test_converge_cascade.py, AP beside
     the JAX record;
  L. config/converge_mask.py (depth-18 FPN, SyncBN, the mask branch) from
     scratch on 16 ellipse images at batch 8 for 480 steps, at half the
     recipe's lr (CONVERGE_MASK_LR: at its own, 2 of 12 card runs
     diverged), through the train CLI, the kernels at its shapes, K1 and K2
     at 14 x 14 on one more step of the trained model, then
     `simpledet_torch.mask_test`: the gates of the JAX package's
     tests/test_converge_mask.py (box AP >= 0.6, segm AP >= 0.6, segm AP50
     >= 0.95), beside the JAX record (at lr 0.005);
  P. config/converge_retina.py (depth-18 FPN, SyncBN, a 64-wide head, adam)
     from scratch on phase C's images at batch 8 for 640 steps through the
     train CLI, then the test CLI on the train set: the gates of the JAX
     package's tests/test_converge_retina.py (last-20 mean loss under half
     the first-20, AP >= 0.6, AP50 >= 0.8) beside the JAX record; K3 on
     the eval's per-class NMS calls against the plain version;
  Q. serve config/rpn_r50v1_fpn_1x.py (the RPN-only detector) at full width
     through Detector.propose: 1000 proposals an image, one NMS launch a
     request, proposals against the plain-NMS path, K3 on a request's own
     call, the breakdown; train it as phase N does; then
     `simpledet_torch.rpn_test` on phase C's checkpoint: best Recall@N at
     IoU 0.5 >= 0.95 (the JAX package's tests/test_convergence.py gate);
  then, each beside the flagship's serving and training numbers of the same
  call (phases 4 and 5):
  R. config/resnet_v1b/mask_r50v1b_fpn_1x.py (Mask R-CNN on ResNet-50 v1b)
     served as phase I serves, FrozenBN folded from one request, with the
     request's breakdown and the device's idle share; trained as phase J
     trains (idle share of 3 traced steps); K1 with codes and K2 at 7 x 7
     and 14 x 14 on one more step's rois and K3 on its proposals' NMS calls,
     against their plain versions;
  S. config/resnet_v1b/faster_r50v1d_fpn_1x.py (the v1d deep stem and
     average-pool shortcut) served and trained as phases 4 and 5, FrozenBN
     folded, at 800 x 1344: at the config's own 800 x 1333 the average-pool
     shortcut floors 167 columns to 83 where the main branch gives 84, in
     the JAX package as in the port;
  T. config/resnet_v1b/faster_r152v1b_fpn_1x.py and retina_r152v1b_fpn_1x.py
     served as phases 4 and M, FrozenBN folded, with the timed requests'
     peak device memory;
  U. one training step (after a warm-up step) at full width of
     config/scratch/mask_r50v1b_fpn_gn_scratch_2x.py (GroupNorm in every
     backbone norm) and, under `torchrun --nproc_per_node 1` (this script's
     --scratch-rank mode, a 1-rank NCCL group, DDP), of
     mask_r50v1b_fpn_bn_scratch_2x.py (SyncBN): finite losses, the kernels
     launched, no norm outside the backbone;
  V. (beside phase L) in a fresh temporary directory:
     config/converge_mask.py's recipe with
     its TinyBackbone's base swapped for ResNet50V1dFPN (depth 18), written
     there, at half its lr (CONVERGE_MASK_LR: at its own, half the card
     runs diverged), 480 steps at batch 8 on 16 ellipse images through the
     train CLI and `simpledet_torch.mask_test`: phase L's gates; the JAX
     package has no record for this recipe;
  then, each beside the flagship's serving and training numbers of the same
  call:
  W. config/tridentnet_r50v2c4_c5_1x.py (TridentNet R50-v2 C4: three
     weight-shared dilated branches folded into the image axis, scale-aware,
     the C5 head, 81 classes, fp32 without TF32) at full width and batch 1,
     FrozenBN folded from one batch (the C5 head's on its roi features):
     served as phase 4 serves (3 timed requests; detections against the
     plain-version path; the peak memory of the timed requests), the
     kernels on one request's own inputs (K1 at 14 x 14 on the 3 x 300
     proposals of the one stride-16 map [3, 50, 84, 1024], K3 on the 3 x
     6000-box proposal problems and the 80 x 900 per-class NMS), the
     request's breakdown (trunk, trident stage, RPN head, proposals,
     RoIAlign, C5 head, decode and NMS) and the device's idle share; trained
     as phase 5 trains (2 warm-up and 5 timed steps, the kernel step against
     the plain step, the idle share of 3 traced steps, the phase's peak
     memory); K1 with codes and K2 on one more step's 3 x 128 rois beside
     their bounds, with the busiest 4 x 4-cell tile's roi count, and K3 on
     its 3 x 12000-box proposal problems;
  X. the same on config/faster_r50v1c4_c5_512roi_1x.py (one branch, v1, batch
     2, 512 rois an image), and its `_fp16` twin served and trained without
     the breakdown and the readings (K1 and K2 in bf16, the kernel step
     against the plain step at the bf16 tolerance);
  Y. in a fresh temporary directory: phase 8's micro-COCO, the train CLI on
     the TridentNet config (4 iterations at batch 1 from a pretrain it
     writes, the checkpoint read back bit for bit), the test CLI on it, and
     `simpledet_torch.rpn_test` on config/rpn_r50v2c4_1x.py (the RPN
     detector on ResNet-50 v2 C4, seeded weights) over the 8 images;
  Z. beside phases A-C (side by side with phases C and H):
     config/converge_trident.py (depth-18 trident, SyncBN,
     4 classes, 7 x 7 rois) from scratch at batch 8 for 480 steps through
     the train CLI, the kernels at its shapes ([24, 8, 12, 1024]), the test
     CLI on the train set: the gates of the JAX package's
     tests/test_converge_trident.py, AP beside the JAX record;
  then, each beside the flagship's serving and training numbers of the same
  call, with every deformable conv's offset conv redrawn on the card
  (`perturb_offsets`: Flax's zero init would make each a plain conv), its
  offsets' range, the share of taps outside the map, v2's mask range and
  the deformable convs' own time (forward a request, forward and backward
  a step) logged:
  AA. config/sepc/retina_r50v1b_fpn_sepc_1x.py (RetinaNet R50-v1b, the BN
     neck, 4 deformable PConv modules, deformable CConv / LConv, iBN) at
     800 x 1333, FrozenBN folded from one request: served as phase M
     serves (the breakdown splits the neck's FPN and SEPC parts), then 2
     warm-up and 5 timed training steps at a tenth of its lr as phase N
     trains;
  AB. config/NASFPN/retina_r50v1b_nasfpn_640_7@256_25epoch.py (7 merge
     cells) at 640 x 640, served and trained the same way;
     retina_r50v1b_tdbu_640_3@384_25epoch.py served;
  AC. config/dcn/faster_dcnv2_r50v1bc4_c5_512roi_1x.py (DCNv2 C4, batch 2)
     and faster_dcn_r50v1b_fpn_1x.py (DCN v1 FPN, stage 5's first unit a
     strided deformable one) as phase X: served, trained at a tenth of
     their lr, K1, K2 and K3 on their own inputs against their plain
     versions;
  AD. in a fresh temporary directory: phase 8's micro-COCO, the train CLI
     on the SEPC config (4 iterations from a pretrain it writes, the
     checkpoint read back bit for bit, its `.params` holding `dconv`
     leaves), the test CLI on it;
  then, at full width, fp32 without TF32, seeded weights, FrozenBN folded:
  AF. config/fcos_r50v1_fpn_1x.py: served as phase M serves (3 timed
     requests of 2 images, detections against the plain-version path; the
     logged score_thr=0 request at a decode threshold of 1e-12, so that K3
     meets the 160 x 5000 real candidates, held against its plain version
     flag for flag; the breakdown), then trained as phase N (the focal
     term against its float64 definition, 2 + 5 steps, peak memory, no
     kernel launched);
  AG. config/RepPoints/reppoints_moment_r50v1_fpn_1x.py the same (the
     breakdown splits the towers and the deformable refine stage), and
     reppoints_moment_dcn_r101v1b_fpn_multiscale_2x.py served with its DCN
     units' offset convs redrawn;
  AH. config/FreeAnchor/free_anchor_r50v1_fpn_1x.py the same (K3 at 160 x
     1000; the focal-style negative loss against its float64 evaluation);
  AI. in a fresh temporary directory: phase 8's micro-COCO, the train CLI
     on the RepPoints config (4 iterations from a pretrain it writes, its
     `.params` holding the deformable kernels and the moment transfer), the
     test CLI on it;
  AE and AI's learning runs, in a fresh temporary directory on phase C's
     images, side by side (converge_nasfpn here, the others in child
     processes): config/converge_nasfpn.py, converge_sepc.py,
     converge_reppoints.py and converge_freeanchor.py for 640 steps and
     converge_fcos.py for 480 at batch 8 from scratch, then the test CLI:
     the gates of tests/test_converge_{nasfpn,sepc,fcos,reppoints,
     freeanchor}.py (last-20 mean loss under 0.6 x the first-20, FCOS 0.5
     x; AP >= 0.6; AP50 >= 0.9, FCOS 0.95) beside the JAX records;
  then, at full width (800 x 1333, batch 2), fp32 without TF32, seeded
  weights, FrozenBN folded, each served and trained as phase X serves and
  trains (3 timed requests, detections against the plain-version path,
  the kernels on a request's and a step's own inputs against their plain
  versions, the breakdown, the idle share, peak memory, the kernel step
  against the plain step):
  AJ. config/FPG/faster_r50v1b_fpg6_256_syncbn_1x.py (the FPG neck, 6
     stages, 256 wide, no norm: the template's fixbn; trained at
     FPG_LR_SCALE of its lr) and faster_r50v1b_pafpn3_384_syncbn_1x.py
     (PAFPN, 3 stages, 384 wide): the neck timed alone with its memory
     (`neck_reading`), the breakdown's backbone and neck stages;
  AK. config/resnet_v1b/faster_r50v1b_fpn_dualheadsmall_1x.py (the
     Double-Head box head);
  AL. config/TSD/tsd_r50v1_fpn_1x.py: the two deformable pools (plain
     PyTorch) timed alone on a request's and a step's own inputs with
     their memory (`tsd_pool_reading`); the TSD branch's cross-entropy
     checked as the box head's is; then in a fresh temporary directory
     phase 8's micro-COCO, the train CLI on it (4 iterations from a
     pretrain it writes) and the test CLI;
  AM. config/ms_r50v1_fpn_1x.py served as phase I serves (7 x 7 and 14 x
     14, the MaskIoU head on the kept boxes' 14 x 14 features, mask_score
     finite) and trained as phase J trains, K1 and K2 at 7 x 7
     and 14 x 14 on one more step; then phase K's CLIs on
     config/converge_msrcnn.py (20 iterations, mask_test with bbox and
     segm);
  AN. (converge_tsd beside C, H and Z; converge_msrcnn beside L and V; each
     in a child process and a temporary directory of its own)
     config/converge_tsd.py and config/converge_msrcnn.py from scratch at
     batch 8 for 480 steps through the train CLI, the kernels at their
     shapes, then the test CLI / mask_test on the train set: the gates of
     tests/test_converge_tsd.py (last-20 mean loss under 0.6 x the
     first-20, AP >= 0.6, AP50 >= 0.9) and test_converge_msrcnn.py (under
     0.5 x, maskiou_loss in every step, box AP and segm AP >= 0.6) beside
     the JAX records;
  10. print each phase's wall time as it ends, the `kernels` JSON line
     (launches per path: serving, training, serving_bf16, training_bf16,
     train_cli, eval_cli, serving_cascade, training_cascade,
     serving_cascade_r101, serving_mask, training_mask, train_cli_mask,
     mask_test_cli, serving_retina, serving_retina_r101, training_retina,
     retina_cli, training_syncbn, train_cli_syncbn, eval_cli_syncbn,
     converge, converge_eval, converge_cascade, converge_cascade_eval,
     converge_mask, converge_mask_eval, converge_retina, serving_rpn_only,
     training_rpn_only, rpn_test, serving_mask_v1b, training_mask_v1b,
     serving_faster_v1d, training_faster_v1d, serving_faster_r152,
     serving_retina_r152, training_mask_gn_scratch, training_mask_bn_scratch,
     converge_mask_v1d, converge_mask_v1d_eval, serving_trident,
     training_trident, serving_c4, training_c4, serving_c4_bf16,
     training_c4_bf16, train_cli_trident, eval_cli_trident, rpn_test_c4,
     converge_trident, converge_trident_eval, serving_sepc, training_sepc,
     serving_nasfpn, training_nasfpn, serving_tdbu, serving_dcnv2_c4,
     training_dcnv2_c4, serving_dcn_fpn, training_dcn_fpn, train_cli_sepc,
     eval_cli_sepc, converge_nasfpn, converge_sepc, serving_fcos,
     training_fcos, serving_reppoints, training_reppoints,
     serving_reppoints_dcn, serving_freeanchor, training_freeanchor,
     train_cli_reppoints, eval_cli_reppoints, converge_fcos,
     converge_reppoints, converge_freeanchor, serving_fpg, training_fpg,
     serving_pafpn, training_pafpn, serving_dualhead, training_dualhead,
     serving_tsd, training_tsd, train_cli_tsd, eval_cli_tsd,
     serving_msrcnn, training_msrcnn, train_cli_msrcnn,
     mask_test_cli_msrcnn, converge_tsd, converge_tsd_eval,
     converge_msrcnn, converge_msrcnn_eval; times at converge_test's
     shapes, on the cascade's, the Mask R-CNN's, RetinaNet's (160 x 5000),
     converge_retina's, the RPN-only detector's, the v1b Mask R-CNN's,
     converge_mask_v1d's, the C4 paths', converge_trident's, the DCN
     paths', the SEPC / NAS-FPN / TDBU, FCOS, RepPoints and FreeAnchor
     requests' and the five recipes' evals' inputs, the two-stage FPN
     variants' requests and steps, converge_tsd's and converge_msrcnn's),
     the card's line, and
     {"ok": true, ...}.

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
CONFIG_BF16 = os.path.join(REPO, "config", "faster_r50v1_fpn_bf16_1x.py")
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


class phase:
    """Context: logs a phase's wall time when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        log(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s"
            + (" (failed)" if exc[0] else ""))


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


def nms_problems(rng, p, n):
    """p score-sorted pools of n boxes in an 800 x 1333 image, clustered so
    that suppression chains form, 90% valid (numpy)."""
    pick = rng.randint(0, 40, n)
    ctr = rng.uniform([0, 0], [W, H], (p, 40, 2))[:, pick]
    wh = np.exp(rng.uniform(np.log(8), np.log(400), (p, 40, 2)))[:, pick]
    ctr = ctr + rng.normal(0, 0.1, (p, n, 2)) * wh
    wh = wh * np.exp(rng.normal(0, 0.1, (p, n, 2)))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], 2).astype(np.float32)
    return boxes, rng.rand(p, n) < 0.9


def nms_edge_cases():
    """{name: (boxes [P, n, 4] f32, valid [P, n] bool, thr)}, numpy problems
    at the edges of the block-wise scan (blocks of 64 rows)."""
    rng = np.random.RandomState(3)
    cases = {f"clustered n={n}": (*nms_problems(rng, 2, n), 0.5)
             for n in (1, 63, 64, 65, 2000)}
    # each box suppresses only the next (IoU 0.47 with it, 0.16 with the one
    # after); in the second problem box 0 stands apart, so the kept rows are
    # the odd ones and row 64k-1 removes row 64k across every block boundary
    n = 2000
    x = np.arange(n, dtype=np.float32) * 4
    chain = np.stack([x, 0 * x, x + 10, 0 * x + 10], 1)
    apart = chain.copy()
    apart[0] = [1e4, 0, 1e4 + 10, 10]
    cases["chain across blocks"] = (np.stack([chain, apart]),
                                    np.ones((2, n), bool), 0.3)
    boxes, _ = nms_problems(rng, 2, 130)
    cases["all invalid"] = (boxes, np.zeros((2, 130), bool), 0.5)
    cases["all identical"] = (np.tile(np.float32([10, 20, 60, 90]),
                                      (2, 130, 1)),
                              np.ones((2, 130), bool), 0.5)
    i = np.arange(200, dtype=np.float32)
    grid = np.stack([i % 20 * 20, i // 20 * 20, i % 20 * 20 + 10,
                     i // 20 * 20 + 10], 1)          # 11 px boxes 20 apart
    cases["no overlaps"] = (grid[None], np.ones((1, 200), bool), 0.0)
    return cases


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
        boxes, valid = (torch.from_numpy(a).to(dev)
                        for a in nms_problems(rng, p, n))
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
        kept = got.sum(1)
        log(f"nms {p}x{n}@{thr}: identical keep ({int(kept.sum())} kept; "
            f"kept rows per problem, the scan's chain: mean "
            f"{float(kept.float().mean()):.1f}, min {int(kept.min())}, max "
            f"{int(kept.max())}; {-(-n // 64)} blocks); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bms:.6f} ms ({by})")
        if serving:
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("ops", ops),
                         ("nbytes", nbytes), ("diff", diff)):
                tot[k] += v
        else:
            train = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         max_abs_err=float(diff))
    for name, (boxes, valid, thr) in nms_edge_cases().items():
        boxes, valid = torch.from_numpy(boxes).to(dev), torch.from_numpy(
            valid).to(dev)
        got = knms.nms_keep_sorted(boxes, valid, thr)
        torch.cuda.synchronize()
        if not torch.equal(got, knms.nms_keep_sorted_plain(boxes, valid,
                                                           thr)):
            raise AssertionError(f"NMS edge case {name}: keep flags differ "
                                 "from the plain version")
        log(f"nms edge case {name} ({boxes.shape[0]}x{boxes.shape[1]}@{thr})"
            f": identical keep, kept rows per problem {got.sum(1).tolist()}")
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


def touched_bytes(kroi, rois, itemsize, out_size=7, level_hw=None, c=C,
                  strides=STRIDES):
    """Bytes of the distinct feature cells these rois' bilinear taps read
    (on the main path's levels unless others are given)."""
    level_hw = level_hw or LEVEL_HW
    b = rois.shape[0]
    rois_f = rois.reshape(-1, 4)
    lvl = kroi.roi_level_index(rois_f, level_hw, strides, 224, 4, out_size)
    (yl, yh, _), (xl, xh, _), _ = kroi._sample_taps(rois_f, lvl, level_hw,
                                                    strides, out_size)
    img = torch.arange(b, device=rois.device).repeat_interleave(
        rois.shape[1])
    hw = torch.tensor(level_hw, device=rois.device)
    base = (lvl * b + img) * int(hw.prod(1).max())
    ys = torch.cat([yl, yh], 2).reshape(len(lvl), -1)
    xs = torch.cat([xl, xh], 2).reshape(len(lvl), -1)
    cells = (base[:, None, None] + ys[:, :, None] * hw[lvl, 1][:, None, None]
             + xs[:, None, :])
    return int(torch.unique(cells).numel()) * c * itemsize


def fwd_traffic(kroi, rois):
    """Per roi, in feature cells ([N] int64 each): the tap reads of the
    bilinear formula (16 per non-empty bin), the cells roi_align_fwd_kernel
    loads (each distinct tap row of a bin row once per distinct tap column
    of the roi's non-empty bins), and the roi's distinct tap cells."""
    rois_f = rois.reshape(-1, 4)
    lvl = kroi.roi_level_index(rois_f, LEVEL_HW, STRIDES, 224, 4, 7)
    (yl, yh, _), (xl, xh, _), empty = kroi._sample_taps(rois_f, lvl, LEVEL_HW,
                                                        STRIDES, 7)
    n, p = yl.shape[:2]
    # a bin is empty when its row's or its column's extent is (roi_setup's
    # per-axis flags): the non-empty bins are a grid of rows x columns
    rows_on, cols_on = ~empty.all(2), ~empty.all(1)

    def distinct(v, keep):
        v = torch.where(keep, v, torch.full_like(v, -1)).sort(1).values
        new = torch.ones_like(keep)
        new[:, 1:] = v[:, 1:] != v[:, :-1]
        return (new & (v >= 0)).sum(1)

    ys = torch.cat([yl, yh], 2)                                   # [N, P, 4]
    on4 = rows_on[:, :, None].expand(n, p, 4)
    ncol = distinct(torch.cat([xl, xh], 2).reshape(n, -1),
                    cols_on[:, :, None].expand(n, p, 4).reshape(n, -1))
    per_row = distinct(ys.reshape(n * p, 4), on4.reshape(n * p, 4))
    loads = per_row.reshape(n, p).sum(1) * ncol
    cells = distinct(ys.reshape(n, -1), on4.reshape(n, -1)) * ncol
    taps = 16 * rows_on.sum(1) * cols_on.sum(1)
    return taps, loads, cells


def traffic_line(kroi, rois, itemsize):
    """K1's feature reads at these rois, in MB: the formula's tap reads, the
    kernel's loads, the sum of the rois' distinct cells, and the call's
    distinct cells."""
    mb = C * itemsize / 1e6
    taps, loads, cells = (float(t.sum()) * mb for t in fwd_traffic(kroi, rois))
    return (f"tap reads {taps:.1f} MB, kernel loads {loads:.1f} MB, per-roi "
            f"distinct {cells:.1f} MB, whole call distinct "
            f"{touched_bytes(kroi, rois, itemsize) / 1e6:.1f} MB")


def check_roi_align(dev):
    """The serving forward (R=1000, no codes) bit for bit: fp32 identical to
    the plain version, bf16 identical to the plain fp32 result rounded once
    to bf16, on the mixed rois and on each set of `roi_edge_cases`. Times
    on the mixed rois."""
    from simpledet_torch.kernels import roi_align as kroi

    rng = np.random.RandomState(1)
    feats32 = [torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32))
               .to(dev) for h, w in LEVEL_HW]
    rois = mixed_rois(rng, dev)
    roi_sets = {"mixed": rois}
    roi_sets.update({k: torch.from_numpy(v).to(dev)
                     for k, v in roi_edge_cases(rng, R).items()})
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        feats = [f.to(dt) for f in feats32]
        err = 0.0
        for rname, rs in roi_sets.items():
            got = kroi.multilevel_roi_align(feats, rs, STRIDES, out_size=7)
            torch.cuda.synchronize()
            want = kroi.multilevel_roi_align_plain(
                [f.float() for f in feats], rs, STRIDES, out_size=7).to(dt)
            diff = float((got.float() - want.float()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"roi_align {name} {rname} rois: "
                                     f"differs from the plain version by up "
                                     f"to {diff:.3g}")
            err = max(err, diff)
            log(f"roi_align {name} {rname} rois B={B} R={R}: identical to "
                "the plain version")
        ms = cuda_ms(lambda: kroi.multilevel_roi_align(feats, rois, STRIDES,
                                                       out_size=7), 20)
        plain_ms = cuda_ms(lambda: kroi.multilevel_roi_align_plain(
            feats, rois, STRIDES, out_size=7), 3, 1)
        isz = feats[0].element_size()
        nbytes = (touched_bytes(kroi, rois, isz) + rois.numel() * 4
                  + got.numel() * isz)
        bms, by = bound_ms(nbytes, ROI_OPS_PER_OUT * got.numel())
        log(f"roi_align {name} B={B} R={R} C={C}: max_abs_err {err:.3g}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.6f} ms "
            f"({by}, {nbytes / 1e6:.1f} MB); "
            f"{traffic_line(kroi, rois, isz)}")
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


def roi_edge_cases(rng, r=R_TRAIN, b=B, h=H, w=W):
    """{name: [b, r, 4] f32 numpy rois} at the edges of the backward's design:
    identical rois (every roi adds to the same cells), whole-image and
    extreme-aspect rois (the most distinct taps, 4P per axis), rois on and
    past the maps' edges, and collapsed rois (points and lines on the image's
    border, as a diverged step's proposals clip to: every bin empty)."""
    def tiled(rows, jitter):
        rows = np.asarray(rows, np.float32)
        out = rows[np.arange(b * r) % len(rows)].reshape(b, r, 4)
        return (out + rng.uniform(-jitter, jitter, out.shape)).astype(
            np.float32)

    return {
        "identical": tiled([[96, 160, 150, 210]], 0),
        "wide": tiled([[0, 0, w - 1, h - 1], [0, 300, w - 1, 330],
                       [600, 0, 620, h - 1], [0, 0, w - 1, 40],
                       [10, 0, 50, h - 1], [200, 100, 1200, 700]], 2),
        "edges": tiled([[0, 0, 3, 3], [w - 4, h - 4, w - 1, h - 1],
                        [0, h - 4, 3, h - 1], [w - 4, 0, w - 1, 3],
                        [-20, -20, 10, 10], [w - 10, h - 10, w + 50, h + 50],
                        [0, 0, w - 1, 8], [w + 60, h + 60, w + 90, h + 90],
                        [0, 100, 30, 400], [w - 31, 200, w - 1, 500]], 1),
        "collapsed": tiled([[0, 0, 0, 0], [w - 1, h - 1, w - 1, h - 1],
                            [0, 200, 0, 600], [100, h - 1, 900, h - 1]], 0),
    }


def time_fwd_sets(dev):
    """{"<roi set> <path> <dtype>": ms} of the RoIAlign forward kernel on
    random features, for the mixed rois and each set of `roi_edge_cases`, on
    the serving path (R=1000, no codes) and the training path (R=512, tie
    codes): where the forward's time depends on the rois. Uses only the
    wrapper's signature that every version of the port shares, so
    `alternate.py` runs it against another checkout's kernels."""
    from simpledet_torch.kernels import roi_align as kroi

    rng = np.random.RandomState(4)
    feats32 = [torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32))
               .to(dev) for h, w in LEVEL_HW]
    by_dtype = {dt: [f.to(dt) for f in feats32]
                for dt in (torch.float32, torch.bfloat16)}
    out = {}
    for path, r, codes in (("serving", R, False),
                           ("training", R_TRAIN, True)):
        sets = {"mixed": mixed_rois(rng, dev, r)}
        sets.update({k: torch.from_numpy(v).to(dev)
                     for k, v in roi_edge_cases(rng, r).items()})
        for rname, rois in sets.items():
            for dt, feats in by_dtype.items():
                name = f"{rname} {path} {str(dt).split('.')[-1]}"
                out[name] = cuda_ms(lambda: kroi.roi_align_fwd_cuda(
                    feats, rois, STRIDES, with_codes=codes), 20)
                log(f"roi_align_fwd set {name}: kernel {out[name]:.4f} ms")
    return out


def time_bwd_sets(dev):
    """{"<roi set> <dtype>": ms} of the RoIAlign backward kernel at the
    training shapes (B=2, R=512, C=256) on random features, for the mixed rois
    and each set of `roi_edge_cases`: where the backward's time depends on
    the rois. Uses only wrappers whose signatures every version of the port
    shares, so `alternate.py` runs it against another checkout's kernels."""
    from simpledet_torch.kernels import roi_align as kroi

    rng = np.random.RandomState(5)
    feats32 = [torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32))
               .to(dev) for h, w in LEVEL_HW]
    sets = {"mixed": mixed_rois(rng, dev, R_TRAIN)}
    sets.update({k: torch.from_numpy(v).to(dev)
                 for k, v in roi_edge_cases(rng).items()})
    out = {}
    for rname, rois in sets.items():
        for dt in (torch.float32, torch.bfloat16):
            feats = [f.to(dt) for f in feats32]
            pooled, codes = kroi.roi_align_fwd_cuda(feats, rois, STRIDES,
                                                    with_codes=True)
            g = torch.from_numpy(rng.randn(*pooled.shape).astype(
                np.float32)).to(dev, dt)
            name = f"{rname} {str(dt).split('.')[-1]}"
            out[name] = cuda_ms(lambda: kroi.roi_align_bwd_cuda(
                g, codes, rois, LEVEL_HW, strides=STRIDES, dtype=dt), 10)
            log(f"roi_align_bwd set {name}: kernel {out[name]:.4f} ms")
    return out


def check_roi_align_train(dev):
    """Forward with tie codes and backward at the training shapes, on mixed
    rois and on the edge cases of `roi_edge_cases`, with random and patchy
    (tied) features. Codes and (rounded) outputs identical to the plain
    version's; fp32 gradients within 1e-5 of each level's max |grad| of the
    plain backward (the sums run in another order); bf16 within one bf16 ulp of
    the plain fp32 result rounded once. Times on the mixed rois and random
    features."""
    from simpledet_torch.kernels import roi_align as kroi

    rng = np.random.RandomState(2)
    rand32 = [torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32))
              .to(dev) for h, w in LEVEL_HW]
    roi_sets = {"mixed": mixed_rois(rng, dev, R_TRAIN)}
    inputs = {"random": rand32, "patches": patches(rng, rand32)}
    roi_sets.update({k: torch.from_numpy(v).to(dev)
                     for k, v in roi_edge_cases(rng).items()})
    fwd, bwd = {}, {}
    for rname, rois in roi_sets.items():
        for (kind, feats32), dt in [(i, d) for i in inputs.items()
                                    for d in (torch.float32, torch.bfloat16)]:
            name = str(dt).split(".")[-1]
            case = f"{rname} rois, {kind} {name}"
            feats = [f.to(dt) for f in feats32]
            out, codes = kroi.roi_align_fwd_cuda(feats, rois, STRIDES,
                                                 with_codes=True)
            torch.cuda.synchronize()
            want_out, want_codes = kroi.multilevel_roi_align_plain(
                [f.float() for f in feats], rois, STRIDES, with_codes=True)
            if not torch.equal(codes, want_codes):
                raise AssertionError(f"tie codes {case}: "
                                     f"{int((codes != want_codes).sum())} "
                                     "differ")
            fwd_err = float((out.float() - want_out.to(dt).float()).abs()
                            .max())
            if fwd_err:
                raise AssertionError(f"roi_align forward {case} differs by "
                                     f"up to {fwd_err:.3g}")
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
            log(f"roi_align train {case}: codes identical ({tied:.1%} of "
                f"values tied), backward max_abs_err {err:.3g} ({rel:.3g} of "
                f"the level's max |grad|)")
            if (rname, kind) != ("mixed", "random"):
                continue
            isz = feats[0].element_size()
            touched = touched_bytes(kroi, rois, isz)
            ms = cuda_ms(lambda: kroi.roi_align_fwd_cuda(
                feats, rois, STRIDES, with_codes=True), 20)
            ms_nocodes = cuda_ms(lambda: kroi.roi_align_fwd_cuda(
                feats, rois, STRIDES), 20)
            plain_ms = cuda_ms(lambda: kroi.multilevel_roi_align_plain(
                feats, rois, STRIDES, with_codes=True), 3, 1)
            nbytes = (touched + rois.numel() * 4 + out.numel() * isz
                      + codes.numel())
            bms, by = bound_ms(nbytes, ROI_OPS_PER_OUT * out.numel())
            log(f"roi_align_fwd with codes {name} B={B} R={R_TRAIN} C={C}: "
                f"kernel {ms:.4f} ms (without codes {ms_nocodes:.4f}), plain "
                f"{plain_ms:.4f} ms, bound {bms:.6f} ms ({by}, "
                f"{nbytes / 1e6:.1f} MB); {traffic_line(kroi, rois, isz)}")
            fwd[name] = dict(ms=ms, ms_without_codes=ms_nocodes,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             max_abs_err=fwd_err)
            ms = cuda_ms(lambda: kroi.roi_align_bwd_cuda(
                g, codes, rois, LEVEL_HW, strides=STRIDES, dtype=dt), 20)
            plain_ms = cuda_ms(lambda: kroi.multilevel_roi_align_bwd_plain(
                g, codes, rois, LEVEL_HW, strides=STRIDES, dtype=dt), 3, 1)
            # the function reads g, the codes and the rois and writes every
            # level's gradient map, each once, in the features' dtype; the
            # kernels issue no global atomics (each output tile is summed in
            # shared memory and written once)
            maps = sum(B * h * w * C for h, w in LEVEL_HW) * isz
            nbytes = g.numel() * isz + codes.numel() + rois.numel() * 4 + maps
            ops = (BWD_OPS_PER_OUT * out.numel()
                   + BWD_OPS_PER_TIED_SAMPLE * float(popcount.sum()))
            bms, by = bound_ms(nbytes, ops)
            log(f"roi_align_bwd {name} B={B} R={R_TRAIN} C={C}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.6f} ms "
                f"({by}, {nbytes / 1e6:.1f} MB); 0 global atomics")
            bwd[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by, max_abs_err=err)
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


def stage_count(model):
    """RoIAlign launches a request or step: one a box-head stage (3 for a
    Cascade R-CNN), one more for a mask branch; none for a RetinaNet or an
    RPN-only model."""
    if not hasattr(model, "extract_rois"):
        return 0
    return len(getattr(model, "heads", (model,))) + int(
        hasattr(model, "mask_head"))


def plain_nms(boxes, valid, thr):
    """The plain NMS keep flags in chunks of problems: its [P, n, n]
    intermediates at a RetinaNet request's 160 x 5000 would take about 16
    GB each; a chunk holds at most 1e8 pairs."""
    from simpledet_torch.kernels import nms as knms

    n = boxes.shape[1]
    step = max(1, int(1e8 // max(n * n, 1)))
    return torch.cat([knms.nms_keep_sorted_plain(boxes[i:i + step],
                                                 valid[i:i + step], thr)
                      for i in range(0, boxes.shape[0], step)])


def serve(dev, smi, config=CONFIG, path="serving", fold=False, stats=None,
          prepare=None):
    """Requests through the config's Detector (phase 4's checks); `prepare`,
    when given, is called with the model first (`perturb_offsets`); with
    `fold`, the first request's statistics folded into the model's
    FrozenBN then (`core/train.py::fold_detector_stats`); `stats`, when
    given, gets the peak device memory of the timed requests (peak_gib).
    Returns (launch counts, ms per image, the Detector)."""
    from simpledet_torch.core.train import fold_detector_stats
    from simpledet_torch.infer import Detector, precision, synthetic_batch
    from simpledet_torch.kernels import roi_align as kroi

    det = Detector(config, device=dev, seed=0)
    how = precision(det.model)
    if prepare is not None:
        prepare(det.model)
    requests = [synthetic_batch(B, H, W, seed) for seed in range(4)]
    requests = [(x.to(dev), i) for x, i in requests]
    if fold:
        data, info = det._inputs(*requests[0])
        with torch.no_grad():
            fold_detector_stats(det.model, data.float(), info)
        how += ", FrozenBN folded from one request"
    det.detect(*requests[0])                       # warm-up: cuDNN plans
    torch.cuda.synchronize()

    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    results = [det.detect(x, i) for x, i in requests[1:]]
    torch.cuda.synchronize()
    ms_img = (time.perf_counter() - t0) * 1e3 / (B * (len(requests) - 1))
    if stats is not None:
        stats["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log(f"{path}: peak {stats['peak_gib']:.2f} GiB allocated over the "
            "timed requests")
    live = det.detect(*requests[0], score_thr=0.0)
    torch.cuda.synchronize()
    per_request = stage_count(det.model)
    counts = read_counts(path, ("nms", "roi_align_fwd") if per_request
                         else ("nms",))
    if counts["roi_align_bwd"]:
        raise AssertionError(f"{path} launched the RoIAlign backward")
    if counts["roi_align_fwd"] != per_request * len(requests):
        raise AssertionError(f"{path}: {counts['roi_align_fwd']} RoIAlign "
                             f"launches for {len(requests)} requests, want "
                             f"{per_request} a request")
    # one NMS launch for the proposals (two-stage models), one for the
    # per-class NMS
    nms_per_request = 1 + int(hasattr(det.model, "rpn"))
    if counts["nms"] != nms_per_request * len(requests):
        raise AssertionError(f"{path}: {counts['nms']} NMS launches for "
                             f"{len(requests)} requests, want "
                             f"{nms_per_request} a request")
    check_feature_dtype(det.model, requests[1][0], requests[1][1],
                        det.spec.pixel_norm)

    # FCOS and RepPoints clip their boxes to [0, w] x [0, h], the others to
    # [0, w - 1] x [0, h - 1], as the JAX package's models do
    edge = 0 if type(det.model).__name__ in ("FCOS", "RepPoints") else 1
    for out in results + [live]:
        boxes, scores, classes, valid = out[:4]
        assert boxes.shape == (B, det.max_det, 4), boxes.shape
        assert scores.shape == classes.shape == valid.shape == (B, det.max_det)
        assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()
        v = valid
        assert ((classes[v] >= 1) & (classes[v] < 81)).all()
        assert (boxes[v] >= 0).all() and (boxes[v][:, 2] <= W - edge).all()
        assert (boxes[v][:, 3] <= H - edge).all()
        if det.has_masks:
            m = out[4]
            assert m.shape == (B, det.max_det, 28, 28), m.shape
            assert torch.isfinite(m).all() and ((m >= 0) & (m <= 1)).all()
    assert bool(live[3].all()), "score_thr=0 request should fill max_det"
    log(f"{path}: {ms_img:.3f} ms per image at {H}x{W}, batch {B}, incl. "
        f"per-class NMS{' and the mask head' if det.has_masks else ''}, "
        f"{how}, on {smi}; {int(results[0][3].sum())} detections in the "
        "first timed request")

    # the same requests with both kernels replaced by their plain versions
    # (the NMS's in chunks of problems: a RetinaNet request at score_thr=0
    # gives it 160 problems of 5000 live boxes)
    import simpledet_torch.models.faster_rcnn as frcnn
    import simpledet_torch.ops.nms as onms
    saved = (onms.nms_keep_sorted, frcnn.multilevel_roi_align)
    onms.nms_keep_sorted = plain_nms
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
        if det.has_masks:
            torch.testing.assert_close(got[4], want[4], rtol=0, atol=1e-4)
    log(f"{path}: detections{' and mask_prob' if det.has_masks else ''} "
        "agree with the plain-version path")
    return counts, ms_img, det


def check_feature_dtype(model, images, im_info, pixel_norm):
    """The pyramid reaches RoIAlign in the backbone's compute dtype (bf16 for
    the bf16 config, so the kernels run in bf16 on its paths)."""
    from simpledet_torch.ops.image import device_normalize

    with torch.no_grad():
        data = device_normalize(images, im_info.to(images.device),
                                *pixel_norm).float()
        pyr = model.pyramid(data)
    want = model.backbone.dtype
    got = {k: v.dtype for k, v in pyr.items()}
    if set(got.values()) != {want}:
        raise AssertionError(f"pyramid dtypes {got}, want {want}")
    log(f"RoIAlign's features are {want} on this path")


# ---------------------------------------------------------------- phase 5

TRAIN_WARMUP, TRAIN_TIMED = 2, 5
PROFILED_STEPS = 3


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


def recording():
    """Context: every call the model makes to the RoIAlign and NMS wrappers,
    passed on to them and recorded in {"roi_align": [(feats, rois, kw)],
    "nms": [(sorted boxes, sorted valid, thr)], "mask_target": [(args,
    kw)]} (features detached; the last: a mask branch's target calls)."""
    import contextlib

    import simpledet_torch.models.faster_rcnn as frcnn
    import simpledet_torch.models.mask_rcnn as mrcnn
    import simpledet_torch.ops.nms as onms

    calls = {"roi_align": [], "nms": [], "mask_target": []}

    @contextlib.contextmanager
    def recorded():
        saved = (onms.nms_keep_sorted, frcnn.multilevel_roi_align,
                 mrcnn.batched_mask_target)

        def nms(boxes, valid, thr):
            calls["nms"].append((boxes, valid, thr))
            return saved[0](boxes, valid, thr)

        def roi_align(feats, rois, strides, **kw):
            calls["roi_align"].append(([f.detach() for f in feats], rois,
                                       dict(strides=strides, **kw)))
            return saved[1](feats, rois, strides, **kw)

        def mask_target(*args, **kw):
            calls["mask_target"].append((args, kw))
            return saved[2](*args, **kw)

        (onms.nms_keep_sorted, frcnn.multilevel_roi_align,
         mrcnn.batched_mask_target) = nms, roi_align, mask_target
        try:
            yield calls
        finally:
            (onms.nms_keep_sorted, frcnn.multilevel_roi_align,
             mrcnn.batched_mask_target) = saved
    return recorded()


def term_scales(model):
    """Context: for one step of a model with SyncBN, {parameter name: the
    sum over the batch's positions of the absolute terms its gradient adds}
    for every conv's weight and bias and every SyncBN's gamma and beta (a
    conv weight's: the weight gradient of |input| and |output gradient|;
    gamma's: sum |g * x_hat|; a bias's and beta's: sum |g|). Under batch
    statistics each of these gradients feeds, or is, a batch norm, whose
    backward takes out the mean: the sum mostly cancels, and bf16 roundings
    of its terms, not of the result, bound its error. Empty for a model
    without SyncBN."""
    import contextlib

    from torch.nn.grad import conv2d_weight

    from simpledet_torch.models.norm import SyncBN

    scales, handles = {}, []

    def dims_of(t):
        return [d for d in range(t.dim()) if d != 1]

    def conv_hook(name):
        def fwd(mod, args, out):
            x = args[0].detach()

            def bwd(g):
                g = g.float().abs()
                scales[name + ".weight"] = conv2d_weight(
                    x.float().abs(), mod.weight.shape, g, mod.stride,
                    mod.padding, mod.dilation, mod.groups)
                if mod.bias is not None:
                    scales[name + ".bias"] = g.sum(dims_of(g))
            out.register_hook(bwd)
        return fwd

    def bn_hook(name):
        def fwd(mod, args, out):
            x = args[0].detach().float()
            dims = dims_of(x)
            dev = x - x.mean(dims, keepdim=True)
            x_hat = dev * torch.rsqrt((dev * dev).mean(dims, keepdim=True)
                                      + mod.eps)

            def bwd(g):
                g = g.float().abs()
                scales[name + ".gamma"] = (g * x_hat.abs()).sum(dims)
                scales[name + ".beta"] = g.sum(dims)
            out.register_hook(bwd)
        return fwd

    @contextlib.contextmanager
    def collecting():
        if any(isinstance(m, SyncBN) for m in model.modules()):
            for name, m in model.named_modules():
                if isinstance(m, torch.nn.Conv2d):
                    handles.append(m.register_forward_hook(conv_hook(name)))
                elif isinstance(m, SyncBN):
                    handles.append(m.register_forward_hook(bn_hook(name)))
        try:
            yield scales
        finally:
            for h in handles:
                h.remove()
    return collecting()


# a kernel step against a plain step, relative to each gradient's max |grad|:
# fp32 sums in other orders. In bf16 the two backwards round the feature
# gradients to bf16 where their fp32 sums fall on either side of a rounding
# boundary, and every bf16 layer below rounds its gradients again (each
# rounding is at most 2^-8 of a value); runs on an NVIDIA H100 80GB HBM3 at
# 700 W measured 0.0063 to 0.0161.
# 2^-5 is 8 such roundings of the largest value. Under SyncBN the
# backbone's gradients are sums that cancel (`term_scales`): the convs' and
# SyncBN's gradients are held against their sums of absolute terms, 8
# roundings of each term; against their own max they reached 0.021-0.032
# on runs of phase A.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}


def loss_check(path):
    """check(i, losses): the losses as floats, each logged; raises where
    one is not finite."""

    def check(i, losses):
        vals = {k: float(v) for k, v in losses.items()}
        log(f"{path} step {i}: " + ", ".join(f"{k} {v:.5f}"
                                            for k, v in vals.items()))
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{path} step {i}: a loss is not finite")
        return vals

    return check


def timed_steps(trainer, batch, path, smi, check, warm_from=0):
    """Warm-up steps warm_from .. TRAIN_WARMUP - 1, then TRAIN_TIMED timed
    ones, the kernels' counts set to 0 just before them; the caller reads
    the counts just after. Returns (ms a step, its phase split)."""
    from simpledet_torch.infer import precision
    from simpledet_torch.train import PhaseTimer

    for i in range(warm_from, TRAIN_WARMUP):
        check(i, trainer.step(*batch))
    torch.cuda.synchronize()
    timer = PhaseTimer()
    trainer.timer = timer
    zero_counts()
    step_s = []
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_TIMED):
        t0 = time.perf_counter()
        timer.start()
        losses = trainer.step(*batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        timer.collect()
        check(i, losses)
    trainer.timer = None
    ms_step = 1e3 * sum(step_s) / len(step_s)
    split = {k: v / TRAIN_TIMED for k, v in timer.totals.items()}
    log(f"{path}: {ms_step:.3f} ms/step ({B * 1e3 / ms_step:.2f} img/s) at "
        f"{H}x{W}, batch {B}, {precision(trainer.model)}, on {smi}; per "
        "step " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    return ms_step, split


def step_profile(trainer, batch, path):
    """The device's busy and idle share of PROFILED_STEPS traced steps
    (torch.profiler), its top kernels and profiler ranges."""
    from simpledet_torch.breakdown import device_profile

    traced_ms, busy_ms, top, ranges = device_profile(
        lambda: trainer.step(*batch), PROFILED_STEPS)
    out = dict(traced_step_ms=traced_ms, device_busy_ms=busy_ms,
               device_idle_share=max(0.0, 1.0 - busy_ms / traced_ms),
               top_kernels_ms=top, ranges_device_ms=ranges)
    log(f"{path}: {PROFILED_STEPS} traced steps (torch.profiler): "
        f"{traced_ms:.3f} ms a step, device busy {busy_ms:.3f} ms, idle "
        f"{out['device_idle_share']:.1%}; top kernels "
        + json.dumps({k: round(v, 3) for k, v in list(top.items())[:6]})
        + (f"; profiler ranges (device ms a step) {json.dumps(ranges)}"
           if ranges else ""))
    return out


def check_trained(trainer, start, path):
    """Against the state dict `start`: frozen parameters and buffers
    bit-unchanged, trained ones moved, SyncBN's running statistics moved
    and finite."""
    from simpledet_torch.models.norm import batch_stat_names

    after = trainer.model.state_dict()
    for name, trainable in trainer.trainable.items():
        same = torch.equal(after[name], start[name])
        if trainable == same:
            raise AssertionError(f"{path}: {name}: {'trainable but unchanged' if same else 'frozen but moved'}")
    stats = batch_stat_names(trainer.model)
    for name in stats:
        if torch.equal(after[name], start[name]) or not torch.isfinite(
                after[name]).all():
            raise AssertionError(f"{path}: running statistics {name} did "
                                 "not move or are not finite")
    n_frozen = sum(not t for t in trainer.trainable.values())
    log(f"{path}: {n_frozen} frozen parameters and buffers bit-unchanged, "
        f"{len(trainer.trainable) - n_frozen} trained ones moved, "
        f"{len(stats)} running statistics moved and finite")


def train(dev, smi, config=CONFIG, path="training", trainer=None,
          batch=None, profile=False, record=False, prepare=None,
          inspect=None, lr_scale=1.0):
    """The config's seeded train detector on a synthetic batch (a mask
    config's: with the gt boxes' ellipse polygons), its FrozenBN folded; or,
    given them, `trainer` on `batch` (images, im_info, gt[, gt_poly]). A
    step launches the RoIAlign forward and backward once a stage and once
    for a mask branch (`stage_count`). Returns (launch counts, ms per step, its forward /
    backward / optimizer split, extra): extra holds, with `profile`, the
    device's busy and idle share of traced steps, and with `record`, the
    kernels' calls of one more step (`recording`), and what `inspect`
    returns, when given, called with the trainer and the batch before the
    checked steps; `prepare`, when given, is called with the new trainer's
    model before its FrozenBN are folded; the schedule's lr times
    `lr_scale`."""
    import copy

    from simpledet_torch.core.train import Trainer
    from simpledet_torch.train import synthetic_gt_poly, synthetic_train_batch

    if trainer is None:
        trainer = Trainer.from_config(config, device=dev, seed=0)
        if lr_scale != 1.0:
            schedule = trainer.schedule
            trainer.schedule = lambda step: lr_scale * schedule(step)
        if prepare is not None:
            prepare(trainer.model)
        images, im_info, gt = synthetic_train_batch(B, H, W, 0)
        batch = (images.to(dev), im_info, gt)
        if hasattr(trainer.model, "mask_head"):
            batch += (synthetic_gt_poly(gt),)
        trainer.fold_batch_stats(*batch[:2])
    images, im_info = batch[:2]
    model = trainer.model
    check_feature_dtype(model, images, im_info, trainer.pixel_norm)
    extra = {}
    if inspect is not None:
        extra.update(inspect(trainer, batch))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    check = loss_check(path)

    # the box head's loss against the definition of its cross-entropy (the
    # mean over the b * r rois of logsumexp(logits) - logit[label]), in
    # float64 on the logits and labels of one train forward without grad;
    # a cascade's first stage: its loss_weight times that
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        data, info = trainer._inputs(images, im_info)
        losses, aux = model(data, info,
                            *[torch.as_tensor(x).to(dev) for x in batch[2:]],
                            mode="train", generator=gen)
    cls_key, weight = "bbox_cls_loss", 1.0
    if cls_key not in losses:
        cls_key, weight = "bbox_cls_loss_1st", model.p_bboxes[0].loss_weight
    if "tsd_cls_loss" in losses:        # aux holds the TSD branch's logits
        cls_key = "tsd_cls_loss"
    z = aux["bbox_cls_logit"].double()
    label = aux["bbox_label"].long()[..., None]
    want = weight * float((torch.logsumexp(z, -1)
                           - z.gather(-1, label)[..., 0]).mean())
    got = float(losses[cls_key])
    if abs(got - want) > 1e-5 * want:
        raise AssertionError(f"{cls_key} {got} is not {weight} x the mean "
                             f"cross-entropy of its logits, {want}")
    log(f"{cls_key} {got:.6f} equals {weight} x the rois' mean "
        f"cross-entropy {want:.6f} within 1e-5")
    # the mean cross-entropy of the RPN's logits over its valid anchors (the
    # definition of its cls loss; a TridentNet's loss also leaves out the
    # anchors near an out-of-range gt: 0.6767 against 0.6776 on an H100)
    zr = aux["rpn_cls_logit"].double()
    rl = aux["rpn_label"].long()
    ce = torch.logsumexp(zr, -1) - zr.gather(-1, rl.clamp(min=0)[..., None])[
        ..., 0]
    want_rpn = float(ce[rl >= 0].mean())
    log(f"rpn_cls_loss {float(losses['rpn_cls_loss']):.6f}; the valid "
        f"anchors' mean cross-entropy of its logits {want_rpn:.6f}")

    # the step's own loss (other sampled rois of the same weights) near the
    # cross-entropy of the forward above: not log(classes) plus half the
    # logits' variance over the classes, which holds for the FPN heads' near
    # uniform softmaxes but not for a C4 v1 C5 head, whose pooled features
    # share a large positive mean, so that every roi's logits carry the same
    # class offsets and the bg-heavy labels sit below it (on an H100:
    # 3.33 against 4.55)
    first = check(0, trainer.step(*batch))
    # gross checks only: a wrong normalisation is off by orders of magnitude;
    # the RPN's near the cross-entropy of the forward above (log 2 for the
    # FPN's seeded RPN, whose logits sit near 0; more where the seeded
    # pyramid is larger, as the FPG neck's, whose maps are 10x the FPN's)
    for k, want, tol in ((cls_key, want, 1.0),
                         ("rpn_cls_loss", want_rpn, 0.2)):
        if abs(first[k] - want) > tol:
            raise AssertionError(f"step 0 {k} {first[k]:.4f} is not near "
                                 f"{want:.4f}")
    ms_step, split = timed_steps(trainer, batch, path, smi, check,
                                 warm_from=1)
    counts = read_counts(path, ("nms", "roi_align_fwd", "roi_align_bwd"))
    per_step = stage_count(model)
    for name in ("roi_align_fwd", "roi_align_bwd"):
        if counts[name] != per_step * TRAIN_TIMED:
            raise AssertionError(f"{path}: {counts[name]} {name} launches in "
                                 f"{TRAIN_TIMED} steps, want {per_step} a "
                                 "step")
    if record:
        with recording() as calls:
            trainer.step(*batch)
        torch.cuda.synchronize()
        extra["calls"] = calls
    if profile:
        extra.update(step_profile(trainer, batch, path))
    check_trained(trainer, start, path)

    # one step from a copied state, with the kernels and with plain versions
    saved = (copy.deepcopy(model.state_dict()),
             copy.deepcopy(trainer.optimizer.state_dict()), trainer.step_count)

    def one_step():
        model.load_state_dict(saved[0])
        trainer.optimizer.load_state_dict(copy.deepcopy(saved[1]))
        trainer.step_count = saved[2]
        trainer.generator.manual_seed(1234)
        zero_counts()
        losses = trainer.step(*batch)
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return losses, grads

    k_losses, k_grads = one_step()
    read_counts("kernel step", ("nms", "roi_align_fwd", "roi_align_bwd"))
    with plain_kernels():
        with term_scales(model) as terms:
            p_losses, p_grads = one_step()
        p2_losses, p2_grads = one_step()      # the step's own nondeterminism
    if any(read_counts("plain step", ()).values()):
        raise AssertionError("the plain step launched a kernel")
    for k in k_losses:
        a, b = float(k_losses[k]), float(p_losses[k])
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"{k}: kernels {a} vs plain {b}")

    def worst_of(grads, by_terms=True):
        """(name, error) of the gradient that differs most from the plain
        step's, relative to its max |grad|, or, where `term_scales` gave
        one (and by_terms), to the largest sum of absolute terms of its
        elements."""
        worst = ("", 0.0)
        for n, g in p_grads.items():
            scale = terms[n] if by_terms and n in terms else g.abs()
            err = float((grads[n] - g).abs().max()) / max(
                float(scale.max()), 1e-30)
            worst = max(worst, (n, err), key=lambda t: t[1])
        return worst

    worst, noise = worst_of(k_grads), worst_of(p2_grads)
    tol = GRAD_TOL[model.backbone.dtype]
    if worst[1] > tol or set(k_grads) != set(p_grads):
        raise AssertionError(f"gradient {worst[0]}: kernels vs plain "
                             f"{worst[1]:.3g} > {tol}")
    by_max = worst_of(k_grads, by_terms=False)
    log(f"{path}: kernel step agrees with the plain step: losses within "
        f"1e-5, {len(p_grads)} gradients within {worst[1]:.3g} of their max "
        f"|grad|" + (f" ({len(terms)}, the convs' and SyncBN's, against "
                     f"their sums of absolute terms; each against its own "
                     f"max |grad|, all are within {by_max[1]:.3g}, worst "
                     f"{by_max[0]})" if terms else "")
        + f" (tolerance {tol}; worst {worst[0]}); two plain steps "
        f"differ by {noise[1]:.3g} ({noise[0]})")
    return counts, ms_step, split, extra


# ------------------------------------------------------------ phases 8, 9

N_CLI_IMAGES, CLI_TRAIN_ITERS = 8, 4


def write_micro_coco(n=N_CLI_IMAGES, seed=0):
    """A synthetic micro-COCO under the paths the flagship configs name
    (relative to the working directory): n JPEG images of uniform noise, as
    phase 5 trains on, landscape 800 x 1333 and portrait 1333 x 800 in turn,
    each with 1-4 boxes of the 80 classes tinted into the noise;
    data/coco/annotations/instances_val2017.json; and the roidb pickles
    data/cache/coco_{train,val}2017.roidb made from it by the port's
    create_coco_roidb. Made from a seed with numpy."""
    import cv2

    from simpledet_torch.data.roidb import create_coco_roidb, save_roidb

    rng = np.random.RandomState(seed)
    img_dir = os.path.join("data", "coco", "images")
    ann_dir = os.path.join("data", "coco", "annotations")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    images, anns = [], []
    for i in range(n):
        h, w = (H, W) if i % 2 == 0 else (W, H)
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        for _ in range(rng.randint(1, 5)):
            bw, bh = rng.randint(min(h, w) // 12, min(h, w) // 2, 2)
            x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
            cat = int(rng.randint(1, 81))
            tint = np.uint8([3 * cat, 255 - 3 * cat, 128])
            box = img[y1:y1 + bh, x1:x1 + bw]
            box[:] = box // 2 + tint // 2
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=cat, bbox=[int(x1), int(y1),
                                                    int(bw), int(bh)],
                             area=int(bw * bh), iscrowd=0))
        name = f"{i + 1:012d}.jpg"
        cv2.imwrite(os.path.join(img_dir, name), img[:, :, ::-1])
        images.append(dict(id=i + 1, file_name=name, height=h, width=w))
    ann_path = os.path.join(ann_dir, "instances_val2017.json")
    with open(ann_path, "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=[
            dict(id=c, name=f"class{c}") for c in range(1, 81)]), f)
    roidb = create_coco_roidb(ann_path, img_dir)
    for name in ("coco_train2017", "coco_val2017"):
        save_roidb(roidb, name)
    log(f"micro-COCO: {n} images, {len(anns)} boxes")


def write_pretrain(dev, spec, config=CONFIG_BF16):
    """`<ModelParam.pretrain.prefix>-0000.params`, the backbone leaves of a
    ResNet-50 checkpoint (of `config`'s backbone): seeded weights with the
    statistics of the first training batch (the config's loader and
    transforms) folded into FrozenBN, written by the port's writer. Returns
    the leaf count."""
    from simpledet_torch.core import checkpoint as ckpt
    from simpledet_torch.data.loader import Loader
    from simpledet_torch.data.roidb import load_roidb
    from simpledet_torch.data.transforms import from_config
    from simpledet_torch.dsl import detector_from_config
    from simpledet_torch.models.norm import fold_batch_stats
    from simpledet_torch.ops.image import device_normalize

    model, _ = detector_from_config(config, device=dev, seed=1,
                                    is_train=True)
    roidb = load_roidb(spec.dataset.image_set, "data/cache")
    batch = next(iter(Loader(roidb, from_config(spec.transform),
                             spec.batch_image, num_workers=0)))
    im_info = torch.from_numpy(batch["im_info"]).to(dev)
    data = device_normalize(torch.from_numpy(batch["data"]).to(dev), im_info,
                            *spec.pixel_norm)
    fold_batch_stats(model.backbone, data.permute(0, 3, 1, 2))
    tree = {"backbone": ckpt.to_flax(model.backbone)}
    path = ckpt.params_path(spec.model.pretrain.prefix, 0)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(ckpt.to_bytes(tree))
    return len(ckpt.flatten(tree))


def train_cli(dev, smi, config=CONFIG_BF16, path="train_cli",
              required=("nms", "roi_align_fwd", "roi_align_bwd")):
    """Phase 8: simpledet_torch.detection_train on the bf16 flagship for
    CLI_TRAIN_ITERS iterations from the pretrain; its checkpoint-0001 read
    back equals the trained state bit for bit. Phase Y: the same on a
    TridentNet config; phase AD on a SEPC RetinaNet (`required`: the
    kernels the path launches)."""
    from simpledet_torch import detection_train
    from simpledet_torch.core import checkpoint as ckpt
    from simpledet_torch.core.config import read_config

    spec = read_config(config, is_train=True)
    n_leaves = write_pretrain(dev, spec, config)
    history = []
    zero_counts()
    t0 = time.perf_counter()
    # seed 0 (the config asks for a time-seeded init) so that the run
    # repeats: a smoke run must not depend on the clock
    trainer = detection_train.train_net(config, CLI_TRAIN_ITERS,
                                        device=dev, loss_history=history,
                                        seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(path, required)
    # the first step's losses come from the loaded weights and must be
    # finite; later ones are reported (seeded heads can leave their basin)
    if len(history) != CLI_TRAIN_ITERS or not all(
            np.isfinite(v) for v in history[0].values()):
        raise AssertionError(f"{path} losses: {history}")
    finite = sum(all(np.isfinite(v) for v in h.values()) for h in history)
    exp_dir = os.path.join("experiments", spec.name)
    with open(os.path.join(exp_dir, "log.txt")) as f:
        if f"loaded pretrain ({n_leaves} tensors)" not in f.read():
            raise AssertionError(f"the train CLI did not load the {n_leaves}"
                                 "-leaf pretrain")
    ckpt_path = ckpt.params_path(os.path.join(exp_dir, "checkpoint"), 1)
    saved = ckpt.flatten(ckpt.read_params(ckpt_path))
    want = ckpt.flatten(ckpt.to_flax(trainer.model))
    if set(saved) != set(want) or not all(
            saved[k].dtype == v.dtype and saved[k].shape == v.shape
            and saved[k].tobytes() == v.tobytes() for k, v in want.items()):
        raise AssertionError(f"{ckpt_path} does not hold the trained state")
    log(f"{path}: pretrain loaded ({n_leaves} leaves), "
        f"{CLI_TRAIN_ITERS} iterations in {seconds:.1f} s incl. building "
        f"the model, total losses {[h['total_loss'] for h in history]} "
        f"({finite} of {CLI_TRAIN_ITERS} finite); {ckpt_path} "
        f"({len(saved)} leaves) equals the trained state bit for bit")
    return counts, ckpt_path


def eval_cli(dev, smi, checkpoint, config=CONFIG, path="eval_cli",
             required=("nms", "roi_align_fwd")):
    """Phase 9: simpledet_torch.detection_test on the fp32 flagship over the
    micro-COCO from the train CLI's checkpoint (its file holds fp32 params),
    copied to where the fp32 config looks for it. Phase Y: the same on a
    TridentNet config's own checkpoint."""
    from simpledet_torch import detection_test
    from simpledet_torch.core import checkpoint as ckpt
    from simpledet_torch.core.config import read_config

    spec = read_config(config)
    dst = ckpt.params_path(spec.test.model.prefix, spec.test.model.epoch)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copyfile(checkpoint, dst)
    stats = {}
    zero_counts()
    summary = detection_test.test_net(config, device=dev, stats=stats)
    torch.cuda.synchronize()
    counts = read_counts(path, required)
    keys = ["AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
            "AR100", "ARs", "ARm", "ARl"]
    if summary is None or list(summary) != keys or not all(
            np.isfinite(v) for v in summary.values()):
        raise AssertionError(f"{path} summary {summary}")
    result = os.path.join("experiments", spec.name,
                          spec.dataset.image_set[0] + "_result.json")
    with open(result) as f:
        n_det = len(json.load(f))
    log(f"{path}: {stats['images']} images at {stats['img_per_s']:.2f} "
        f"img/s (loader, forward and per-class NMS, fp32 without TF32, "
        f"batch {spec.test.batch_image or 4}) on {smi}; {n_det} detections "
        f"in {result}; summary {json.dumps(summary)}")
    return counts, stats


def cli_phases(dev, smi):
    """Phases 8 and 9 in a fresh temporary directory, removed afterwards."""
    import tempfile

    cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    os.chdir(tmp)
    try:
        write_micro_coco()
        train_counts, checkpoint = train_cli(dev, smi)
        eval_counts, stats = eval_cli(dev, smi, checkpoint)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return train_counts, eval_counts, stats


# ------------------------------------------------- phases D, E, F and G

CONFIG_CASCADE = os.path.join(REPO, "config", "cascade_r50v1_fpn_1x.py")
CONFIG_CASCADE_R101 = os.path.join(REPO, "config",
                                   "cascade_r101v1_fpn_1x.py")
CASCADE_STAGES = ("1st", "2nd", "3rd")
K_TILE = 4          # roi_align.cu's kTile: the backward sums 4 x 4-cell tiles


def nms_bound(boxes, valid):
    """(bound ms, what bounds it) of one NMS call over sorted boxes
    [P, n, 4] with their valid flags."""
    nv = valid.sum(1).double()
    ops = float((NMS_OPS_PER_PAIR * nv * (nv - 1) / 2
                 + NMS_OPS_PER_BOX * nv).sum())
    return bound_ms(boxes.shape[0] * boxes.shape[1] * (16 + 1 + 1), ops)


def check_serving_calls(calls, path):
    """The kernels on a serving request's own inputs (recorded by
    `recording`): each RoIAlign forward (one a stage, one for a mask
    branch) bit for bit against the plain version, each NMS call's keep
    flags against the plain version's. Times the last RoIAlign forward (a
    cascade's stage 3, a Mask R-CNN's mask RoIAlign) and the per-class NMS
    (the largest NMS call) beside their bounds and plain versions."""
    from simpledet_torch.kernels import nms as knms
    from simpledet_torch.kernels import roi_align as kroi

    out = {}
    for i, (feats, rois, kw) in enumerate(calls["roi_align"]):
        got = kroi.roi_align_fwd_cuda(feats, rois, **kw)
        torch.cuda.synchronize()
        want = kroi.multilevel_roi_align_plain(feats, rois, **kw)
        if not torch.equal(got, want):
            raise AssertionError(f"{path}: RoIAlign forward of stage {i + 1}"
                                 " differs from the plain version")
    feats, rois, kw = calls["roi_align"][-1]
    isz = feats[0].element_size()
    nbytes = (touched_bytes(kroi, rois, isz, kw["out_size"],
                            [tuple(f.shape[1:3]) for f in feats],
                            feats[0].shape[-1], kw["strides"])
              + rois.numel() * 4 + got.numel() * isz)
    bms, by = bound_ms(nbytes, ROI_OPS_PER_OUT * got.numel())
    out["roi_align_fwd"] = dict(
        ms=cuda_ms(lambda: kroi.roi_align_fwd_cuda(feats, rois, **kw), 20),
        plain_ms=cuda_ms(lambda: kroi.multilevel_roi_align_plain(
            feats, rois, **kw), 3, 1),
        bound_ms=bms, bound_by=by, max_abs_err=0.0,
        shape=list(rois.shape))
    for boxes, valid, thr in calls["nms"]:
        got = knms.nms_keep_sorted(boxes, valid, thr)
        torch.cuda.synchronize()
        if not torch.equal(got, knms.nms_keep_sorted_plain(boxes, valid,
                                                           thr)):
            raise AssertionError(f"{path}: NMS {tuple(boxes.shape[:2])}@"
                                 f"{thr}: keep flags differ")
    boxes, valid, thr = max(calls["nms"], key=lambda c: c[0].shape[0])
    bms, by = nms_bound(boxes, valid)
    out["nms"] = dict(
        ms=cuda_ms(lambda: knms.nms_keep_sorted(boxes, valid, thr), 20),
        plain_ms=cuda_ms(lambda: knms.nms_keep_sorted_plain(
            boxes, valid, thr), 3, 1),
        bound_ms=bms, bound_by=by, max_abs_err=0.0,
        shape=list(boxes.shape[:2]))
    for name, v in out.items():
        log(f"{path}: {name} on the request's own inputs {v['shape']}"
            + (f" at {kw['out_size']}x{kw['out_size']}"
               if name == "roi_align_fwd" else "") + ": "
            f"identical to the plain version ({len(calls['roi_align'])} "
            f"RoIAlign and {len(calls['nms'])} NMS calls); kernel "
            f"{v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, bound "
            f"{v['bound_ms']:.6f} ms ({v['bound_by']})")
    return out


def serve_cascade(dev, smi, config, path):
    """Phases D and G: phase 4 on a Cascade R-CNN config (3 RoIAlign
    launches a request), then the kernels on one request's own inputs."""
    from simpledet_torch.infer import synthetic_batch

    counts, ms_img, det = serve(dev, smi, config, path)
    images, im_info = synthetic_batch(B, H, W, 1)
    with recording() as calls:
        det.detect(images.to(dev), im_info)
    torch.cuda.synchronize()
    if len(calls["roi_align"]) != 3:
        raise AssertionError(f"{path}: {len(calls['roi_align'])} RoIAlign "
                             "calls a request")
    return counts, ms_img, check_serving_calls(calls, path)


def tile_load(kroi, rois, level_hw, strides=STRIDES, out_size=7):
    """How many of these rois [B, R, 4] meet each of the backward's
    kTile x kTile-cell tiles: a roi meets a tile of its level and image when
    the tap window of its non-empty bins overlaps it, as roi_taps_kernel
    decides. Returns (the busiest tile's count, the mean count over the
    tiles met, the number of tiles met)."""
    b, r = rois.shape[:2]
    rois_f = rois.reshape(-1, 4)
    lvl = kroi.roi_level_index(rois_f, level_hw, strides, 224, 4, out_size)
    (yl, yh, _), (xl, xh, _), empty = kroi._sample_taps(
        rois_f, lvl, level_hw, strides, out_size)
    rows_on, cols_on = ~empty.all(2), ~empty.all(1)

    def window(lo, hi, on):
        on = on[:, :, None].expand_as(lo)
        return (torch.where(on, lo, torch.full_like(lo, 1 << 30)).amin((1, 2)),
                torch.where(on, hi, torch.full_like(hi, -1)).amax((1, 2)))

    (y0, y1), (x0, x1) = window(yl, yh, rows_on), window(xl, xh, cols_on)
    has = rows_on.any(1) & cols_on.any(1)
    img = torch.arange(b, device=rois.device).repeat_interleave(r)
    counts = []
    for lv, (h, w) in enumerate(level_hw):
        th, tw = -(-h // K_TILE), -(-w // K_TILE)
        sel = has & (lvl == lv)
        i = img[sel]
        ty0, ty1 = y0[sel] // K_TILE, y1[sel] // K_TILE + 1
        tx0, tx1 = x0[sel] // K_TILE, x1[sel] // K_TILE + 1
        diff = torch.zeros(b, th + 1, tw + 1, dtype=torch.int64,
                           device=rois.device)
        one = torch.ones_like(i)
        for ty, tx, v in ((ty0, tx0, one), (ty0, tx1, -one),
                          (ty1, tx0, -one), (ty1, tx1, one)):
            diff.index_put_((i, ty, tx), v, accumulate=True)
        counts.append(diff.cumsum(1).cumsum(2)[:, :th, :tw].reshape(-1))
    c = torch.cat(counts)
    met = c[c > 0]
    return int(c.max()), float(met.double().mean()), int(met.numel())


def roi_reading(dev, feats, rois, kw, label, rng):
    """K1 with tie codes and K2 on one recorded RoIAlign call (`recording`):
    K1 bit for bit against the plain version, K2 against the plain backward
    (1e-5 of each level's max |grad|) on a random output gradient; K2's time
    and how many rois meet its busiest tiles. Returns (reading, (codes,
    grad))."""
    from simpledet_torch.kernels import roi_align as kroi

    level_hw = [tuple(f.shape[1:3]) for f in feats]
    out, codes = kroi.roi_align_fwd_cuda(feats, rois, **kw, with_codes=True)
    torch.cuda.synchronize()
    want, want_codes = kroi.multilevel_roi_align_plain(feats, rois, **kw,
                                                       with_codes=True)
    if not (torch.equal(codes, want_codes) and torch.equal(out, want)):
        raise AssertionError(f"{label}: RoIAlign forward with codes differs "
                             "from the plain version")
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(
        dev, out.dtype)
    got = kroi.roi_align_bwd_cuda(g, codes, rois, level_hw, dtype=out.dtype,
                                  **kw)
    torch.cuda.synchronize()
    ref = kroi.multilevel_roi_align_bwd_plain(g, codes, rois, level_hw,
                                              dtype=out.dtype, **kw)
    err = 0.0
    for gl, wl in zip(got, ref):
        scale = float(wl.abs().max())
        torch.testing.assert_close(gl, wl, rtol=0, atol=1e-5 * scale)
        err = max(err, float((gl - wl).abs().max()))
    ms = cuda_ms(lambda: kroi.roi_align_bwd_cuda(
        g, codes, rois, level_hw, dtype=out.dtype, **kw), 20)
    p = kw["out_size"]
    busiest, mean, met = tile_load(kroi, rois, level_hw, kw["strides"], p)
    reading = dict(ms=ms, busiest_tile_rois=busiest, mean_tile_rois=mean,
                   tiles_met=met, max_abs_err=err,
                   shape=[*rois.shape[:2], p])
    log(f"{label} (B={rois.shape[0]}, R={rois.shape[1]}, P={p}, levels "
        f"{level_hw}): K1 with codes identical to the plain version; K2 "
        f"{ms:.4f} ms (max_abs_err {err:.3g}); rois a {K_TILE}x{K_TILE}-cell"
        f" tile: busiest {busiest}, mean {mean:.2f} over {met} tiles met")
    return reading, (codes, g)


def stage_readings(dev, calls, path):
    """`roi_reading` on each stage's features and rois of one recorded
    training step of a cascade. Returns ({stage: reading}, the last stage's
    (feats, rois, kw, codes, grad))."""
    rng = np.random.RandomState(7)
    by_stage = {}
    for s, (feats, rois, kw) in zip(CASCADE_STAGES, calls["roi_align"]):
        by_stage[s], (codes, g) = roi_reading(dev, feats, rois, kw,
                                              f"{path} stage {s}", rng)
    return by_stage, (feats, rois, kw, codes, g)


def roi_bounds(feats, rois, kw, codes, g, k2):
    """K1 with codes and K2 on one call's inputs beside their bounds and
    plain versions (K2's time and error: `k2`, a `roi_reading`). Returns
    (K1's, K2's) {ms, plain_ms, bound_ms, bound_by, max_abs_err}."""
    from simpledet_torch.kernels import roi_align as kroi

    isz = feats[0].element_size()
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    b, c = rois.shape[0], feats[0].shape[-1]
    n_out = codes.numel()
    nbytes = (touched_bytes(kroi, rois, isz, kw["out_size"], level_hw, c,
                            kw["strides"])
              + rois.numel() * 4 + n_out * isz + n_out)
    bms, by = bound_ms(nbytes, ROI_OPS_PER_OUT * n_out)
    k1 = dict(ms=cuda_ms(lambda: kroi.roi_align_fwd_cuda(
        feats, rois, **kw, with_codes=True), 20),
        plain_ms=cuda_ms(lambda: kroi.multilevel_roi_align_plain(
            feats, rois, **kw, with_codes=True), 3, 1),
        bound_ms=bms, bound_by=by, max_abs_err=0.0)
    maps = sum(b * h * w * c for h, w in level_hw) * isz
    popcount = sum((codes.int() >> st) & 1 for st in range(4))
    bms, by = bound_ms(g.numel() * isz + codes.numel() + rois.numel() * 4
                       + maps, BWD_OPS_PER_OUT * n_out
                       + BWD_OPS_PER_TIED_SAMPLE * float(popcount.sum()))
    k2 = dict(ms=k2["ms"],
              plain_ms=cuda_ms(lambda: kroi.multilevel_roi_align_bwd_plain(
                  g, codes, rois, level_hw, dtype=g.dtype, **kw), 3, 1),
              bound_ms=bms, bound_by=by, max_abs_err=k2["max_abs_err"])
    return k1, k2


def cascade_roi_kernels(dev, calls, bwd_sets):
    """Phase F: `stage_readings` on the full-width cascade's recorded
    training step, beside time_bwd_sets' mixed and identical rois of the
    same call; K1 with codes and K2 on the stage-3 rois beside their bounds
    and plain versions. Returns ({stage: K2's reading}, K1 at stage 3, K2
    at stage 3)."""
    from simpledet_torch.kernels import roi_align as kroi

    feats = calls["roi_align"][0][0]
    if [tuple(f.shape[1:3]) for f in feats] != LEVEL_HW or \
            feats[0].dtype != torch.float32:
        raise AssertionError("phase F runs on the fp32 full-width levels")
    by_stage, (feats, rois, kw, codes, g) = stage_readings(
        dev, calls, "training_cascade")
    mixed, alike = (bwd_sets[k] for k in ("mixed float32",
                                          "identical float32"))
    mb = tile_load(kroi, mixed_rois(np.random.RandomState(5), dev, R_TRAIN),
                   LEVEL_HW)
    log(f"K2 by stage (fp32, B={B}, R={R_TRAIN}): "
        + ", ".join(f"{s} {v['ms']:.4f} ms" for s, v in by_stage.items())
        + f"; time_bwd_sets in this call: mixed rois {mixed:.4f} ms (busiest"
        f" tile {mb[0]} rois, mean {mb[1]:.2f}), 512 identical rois "
        f"{alike:.4f} ms (every roi meets the same tiles)")
    k1, k2 = roi_bounds(feats, rois, kw, codes, g, by_stage["3rd"])
    log(f"stage-3 rois: K1 with codes {k1['ms']:.4f} ms (plain "
        f"{k1['plain_ms']:.4f}, bound {k1['bound_ms']:.6f}, {k1['bound_by']});"
        f" K2 {k2['ms']:.4f} ms (plain {k2['plain_ms']:.4f}, bound "
        f"{k2['bound_ms']:.6f}, {k2['bound_by']})")
    return by_stage, k1, k2


def cascade_phases(dev, smi, bwd_sets):
    """Phases D to G: serve and train config/cascade_r50v1_fpn_1x.py at full
    width (fp32, TF32 off), K2 per stage on the training step's rois, serve
    config/cascade_r101v1_fpn_1x.py."""
    out = {}
    with phase("D serving_cascade"):
        out["serving"] = serve_cascade(dev, smi, CONFIG_CASCADE,
                                       "serving_cascade")
    with phase("E training_cascade"):
        out["training"] = train(dev, smi, CONFIG_CASCADE, "training_cascade",
                                profile=True, record=True)
    with phase("F K2 by stage"):
        out["by_stage"] = cascade_roi_kernels(
            dev, out["training"][3].pop("calls"), bwd_sets)
    with phase("G serving_cascade_r101"):
        out["serving_r101"] = serve_cascade(dev, smi, CONFIG_CASCADE_R101,
                                            "serving_cascade_r101")
    return out


# ------------------------------------------------- phases I, J and K

CONFIG_MASK = os.path.join(REPO, "config", "mask_r50v1_fpn_1x.py")
# after 4 steps the box head scores every roi background (no detection
# passes 0.05); after 20 it detects
CLI_MASK_EPOCHS = 10


def by_size(calls):
    """{"roi_align_fwd_<P>": RoIAlign calls at P x P, "nms": NMS calls} of
    one recorded request or step."""
    out = {}
    for _, _, kw in calls["roi_align"]:
        k = f"roi_align_fwd_{kw['out_size']}"
        out[k] = out.get(k, 0) + 1
    out["nms"] = len(calls["nms"])
    return out


def serve_mask(dev, smi, config=CONFIG_MASK, path="serving_mask",
               fold=False, breakdown=False):
    """Phase I: phase 4 on config/mask_r50v1_fpn_1x.py (2 RoIAlign launches
    a request, at 7 x 7 and at 14 x 14 on the kept boxes; detections and
    mask_prob against the plain-version path), then the kernels on one
    request's own inputs. Returns (launch counts, ms per image, the
    request's calls by size, readings on its inputs), and with `breakdown`
    the request's `request_breakdown`. Phase R: the same on the v1b config,
    FrozenBN folded (`serve`'s fold), with the breakdown."""
    from simpledet_torch.infer import synthetic_batch

    counts, ms_img, det = serve(dev, smi, config, path, fold=fold)
    images, im_info = synthetic_batch(B, H, W, 1)
    images = images.to(dev)
    with recording() as calls:
        det.detect(images, im_info)
    torch.cuda.synchronize()
    sizes = by_size(calls)
    log(f"{path}: one request's kernel calls {sizes}")
    if sizes != {"roi_align_fwd_7": 1, "roi_align_fwd_14": 1, "nms": 2}:
        raise AssertionError(f"{path}: kernel calls {sizes}")
    out = (counts, ms_img, sizes, check_serving_calls(calls, path))
    if breakdown:
        out += (request_breakdown(det, path, images, im_info),)
    return out


def mask_target_reading(calls, gt_poly):
    """The mask-target stage of one recorded step (`recording`), on the
    edge columns the model kept (`trim_padding`) and on the whole edge
    tensor gt_poly [B, G, E, 5] of the step's batch: their times (CUDA
    events) and the device memory each allocates beyond what was allocated
    before it (max_memory_allocated); both give the same targets."""
    from simpledet_torch.targets.mask_target import batched_mask_target

    args, kw = calls["mask_target"][0]
    out = {}
    for name, a in (("trimmed", args), ("whole", args[:3] + (gt_poly,))):
        ms = cuda_ms(lambda: batched_mask_target(*a, **kw), 5)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        targets = batched_mask_target(*a, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        out[name] = dict(ms=ms, peak_bytes=int(peak), rois=list(a[0].shape),
                         gt_poly=list(a[3].shape))
        out[name + "_targets"] = targets
        log(f"mask targets, {name} edge tensor (rois {list(a[0].shape)}, "
            f"gt_poly {list(a[3].shape)}, {kw.get('mask_size')} x "
            f"{kw.get('mask_size')}): {ms:.3f} ms, {peak / 2 ** 20:.1f} MiB "
            "above the step's allocation")
    if not torch.equal(out.pop("trimmed_targets"), out.pop("whole_targets")):
        raise AssertionError("mask targets differ on the trimmed edges")
    fg = (args[2].sum(1)).tolist()
    log(f"mask targets: identical on both; {fg} fg rois of "
        f"{args[0].shape[1]} an image")
    out["fg_rois_per_image"] = fg
    return out


def mask_roi_kernels(dev, calls, bwd_sets, path):
    """K1 with codes and K2 on one recorded Mask R-CNN training step's 7 x 7
    (box) and 14 x 14 (mask, fg rois) calls (`roi_reading`), beside
    time_bwd_sets' mixed and identical rois of the same call; K1 and K2 at
    14 x 14 beside their bounds and plain versions. Returns ({"7": reading,
    "14": reading}, K1 at 14, K2 at 14)."""
    rng = np.random.RandomState(8)
    readings, last = {}, None
    for feats, rois, kw in calls["roi_align"]:
        p = kw["out_size"]
        readings[str(p)], (codes, g) = roi_reading(
            dev, feats, rois, kw, f"{path} RoIAlign {p}x{p}", rng)
        if p == 14:
            last = (feats, rois, kw, codes, g)
    if set(readings) != {"7", "14"}:
        raise AssertionError(f"{path}: RoIAlign calls {sorted(readings)}")
    k1, k2 = roi_bounds(*last, readings["14"])
    line = (f"{path}: K2 at 14x14 on {readings['14']['shape'][1]} fg rois an "
            f"image {readings['14']['ms']:.4f} ms (busiest tile "
            f"{readings['14']['busiest_tile_rois']} rois, mean "
            f"{readings['14']['mean_tile_rois']:.2f}), at 7x7 on the step's "
            f"{readings['7']['shape'][1]} rois {readings['7']['ms']:.4f} ms "
            f"(busiest {readings['7']['busiest_tile_rois']})")
    if bwd_sets:
        line += (f"; time_bwd_sets in this call: mixed "
                 f"{bwd_sets['mixed float32']:.4f} ms, identical "
                 f"{bwd_sets['identical float32']:.4f} ms")
    log(line)
    log(f"{path} 14x14: K1 with codes {k1['ms']:.4f} ms (plain "
        f"{k1['plain_ms']:.4f}, bound {k1['bound_ms']:.6f}, {k1['bound_by']});"
        f" K2 {k2['ms']:.4f} ms (plain {k2['plain_ms']:.4f}, bound "
        f"{k2['bound_ms']:.6f}, {k2['bound_by']})")
    return readings, k1, k2


def mask_phases(dev, smi, bwd_sets):
    """Phases I and J: serve and train config/mask_r50v1_fpn_1x.py at full
    width (fp32, TF32 off); the mask targets, K1 and K2 at 14 x 14 on the
    training step's own inputs."""
    out = {}
    with phase("I serving_mask"):
        out["serving"] = serve_mask(dev, smi)
    with phase("J training_mask"):
        out["training"] = train(dev, smi, CONFIG_MASK, "training_mask",
                                profile=True, record=True)
        calls = out["training"][3].pop("calls")
        log(f"training_mask: one step's kernel calls {by_size(calls)}")
        from simpledet_torch.train import (synthetic_gt_poly,
                                           synthetic_train_batch)

        gt_poly = synthetic_gt_poly(synthetic_train_batch(B, H, W, 0)[2])
        out["targets"] = mask_target_reading(calls, gt_poly.to(dev))
        out["roi"] = mask_roi_kernels(dev, calls, bwd_sets, "training_mask")
    return out


def check_segm_json(path, roidb):
    """The eval CLI's result json: each detection's segmentation a COCO
    compressed RLE of its image's size. Returns the detection count."""
    from simpledet_torch.data.rle import decode_rle

    hw = {r["im_id"]: (r["h"], r["w"]) for r in roidb}
    with open(path) as f:
        dets = json.load(f)
    for d in dets:
        seg = d["segmentation"]
        if not isinstance(seg["counts"], str) or \
                decode_rle(seg).shape != hw[d["image_id"]]:
            raise AssertionError(f"{path}: {seg['size']} is not COCO RLE of "
                                 f"image {d['image_id']}")
    return len(dets)


def mask_cli_phase(dev, smi, config=None, prefix="CONVERGE_MASK",
                   paths=("train_cli_mask", "mask_test_cli")):
    """Phase K, in a fresh temporary directory: an ellipse-polygon
    micro-COCO (`data/synthetic.py`, 8 images) through the train CLI on
    config/converge_mask.py (SyncBN from scratch: CLI_MASK_EPOCHS epochs of
    its 8 images and their flips at batch 8, 2 an epoch, polygons through
    the loader) and
    simpledet_torch.mask_test on its checkpoint and running statistics:
    finite losses with a mask loss, bbox and segm summaries of 12 finite
    numbers, detections in the result json as COCO RLE. (The FrozenBN
    config/mask_micro_test.py diverges from seeded weights within three
    steps, as the flagship's micro config does without a pretrain.) Phase
    AM: the same on config/converge_msrcnn.py (env prefix CONVERGE_MSRCNN,
    a maskiou_loss in every step)."""
    import tempfile

    from simpledet_torch import detection_train, mask_test
    from simpledet_torch.core.config import read_config
    from simpledet_torch.data.roidb import load_roidb
    from simpledet_torch.data.synthetic import make_micro_dataset

    config = config or CONFIG_CONVERGE_MASK
    cwd, saved = os.getcwd(), dict(os.environ)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mask_cli_")
    try:
        os.chdir(tmp)
        os.makedirs("config")
        shutil.copyfile(os.path.join(REPO, config), config)
        make_micro_dataset(os.path.join(tmp, "ellipse"), n_images=8,
                           set_names=("converge_train",), shapes="ellipse")
        os.environ.update({"CONVERGE_DATA_ROOT": os.path.join(tmp, "ellipse"),
                           prefix + "_BATCH": "8",
                           prefix + "_EPOCHS": str(CLI_MASK_EPOCHS)})
        history = []
        zero_counts()
        trainer = detection_train.train_net(config, device=dev,
                                            loss_history=history, seed=0)
        torch.cuda.synchronize()
        train_counts = read_counts(paths[0], (
            "nms", "roi_align_fwd", "roi_align_bwd"))
        keys = ("mask_loss",) + (("maskiou_loss",) if hasattr(
            trainer.model, "maskiou_head") else ())
        if len(history) != 2 * CLI_MASK_EPOCHS or not all(
                set(keys) <= set(h) and np.isfinite(list(h.values())).all()
                for h in history):
            raise AssertionError(f"mask train CLI losses: {history}")
        stats = {}
        zero_counts()
        summaries = mask_test.mask_test_net(config, device=dev, stats=stats)
        torch.cuda.synchronize()
        eval_counts = read_counts(paths[1], ("nms", "roi_align_fwd"))
        if summaries is None or any(
                list(v) != SUMMARY_KEYS or not all(np.isfinite(list(
                    v.values()))) for v in summaries.values()):
            raise AssertionError(f"mask_test summaries {summaries}")
        spec = read_config(config)
        roidb = load_roidb(spec.dataset.image_set, spec.dataset.cache_dir)
        n_det = check_segm_json(os.path.join(
            "experiments", spec.name,
            spec.dataset.image_set[0] + "_segm_result.json"), roidb)
        if not n_det:
            raise AssertionError("mask_test wrote no detections")
        log(f"{paths[0]} and {paths[1]} on {config}: {len(history)} train "
            "iterations, total losses "
            f"{[round(h['total_loss'], 4) for h in history]}; mask_test "
            f"{stats['images']} images at {stats['img_per_s']:.2f} img/s on "
            f"{smi}, {n_det} detections in COCO RLE; bbox "
            f"{json.dumps(summaries['bbox'])}; segm "
            f"{json.dumps(summaries['segm'])}")
    finally:
        os.chdir(cwd)
        os.environ.clear()
        os.environ.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    return train_counts, eval_counts, stats


# ----------------------------------------------- phases M, N, O, P and Q

CONFIG_RETINA = os.path.join(REPO, "config", "retina_r50v1_fpn_1x.py")
CONFIG_RETINA_R101 = os.path.join(REPO, "config", "retina_r101v1_fpn_1x.py")
CONFIG_RETINA_MICRO = os.path.join(REPO, "config", "retina_micro_test.py")
CONFIG_RPN = os.path.join(REPO, "config", "rpn_r50v1_fpn_1x.py")
CONFIG_CONVERGE_RETINA = "config/converge_retina.py"
CONVERGE_RETINA_EPOCHS = 160        # the config's: 640 steps at batch 8
# experiments/chip/converge_retina/{log.txt,losses.jsonl}: 640 steps at
# batch 8 on one TPU chip, and the means of its first and last 20 losses
JAX_CONVERGE_RETINA = dict(AP=0.903, AP50=0.985, AP75=0.886, first20=1.4201,
                           last20=0.00035, chip="one TPU chip")
BREAKDOWN_COUNT = 5


def nms_reading(calls, path):
    """Each recorded NMS call's keep flags against the plain version's (in
    chunks of problems, `plain_nms`); the largest call timed beside its
    bound and its plain version, with its suppression mask's size
    (`simpledet_nms_mask_words`). max_abs_err counts the flags that
    differ over all the calls (0 or the phase fails)."""
    from simpledet_torch.kernels import nms as knms

    for boxes, valid, thr in calls["nms"]:
        got = knms.nms_keep_sorted(boxes, valid, thr)
        torch.cuda.synchronize()
        diff = int((got != plain_nms(boxes, valid, thr)).sum())
        if diff:
            raise AssertionError(f"{path}: NMS {tuple(boxes.shape[:2])}@"
                                 f"{thr}: {diff} keep flags differ")
    boxes, valid, thr = max(calls["nms"],
                            key=lambda c: c[0].shape[0] * c[0].shape[1])
    p, n = valid.shape
    bms, by = nms_bound(boxes, valid)
    out = dict(ms=cuda_ms(lambda: knms.nms_keep_sorted(boxes, valid, thr), 20),
               plain_ms=cuda_ms(lambda: plain_nms(boxes, valid, thr), 1, 1),
               bound_ms=bms, bound_by=by, max_abs_err=0.0, shape=[p, n],
               live=int(valid.sum()), kept=int(knms.nms_keep_sorted(
                   boxes, valid, thr).sum()),
               mask_mb=p * knms._lib().simpledet_nms_mask_words(n) * 8 / 2**20)
    log(f"{path}: NMS on the path's own inputs ({len(calls['nms'])} calls, "
        f"largest {p}x{n}@{thr}, {out['live']} live boxes, {out['kept']} "
        f"kept, suppression mask {out['mask_mb']:.1f} MiB): keep flags "
        f"identical to the plain version's; kernel {out['ms']:.4f} ms, "
        f"plain {out['plain_ms']:.4f} ms, bound {bms:.6f} ms ({by})")
    return out


def request_breakdown(det, path, images, im_info):
    """`simpledet_torch.breakdown`'s stages of one request, each timed with
    CUDA events over BREAKDOWN_COUNT requests, and the device's idle share
    of as many traced requests."""
    from simpledet_torch.breakdown import device_profile, stage_times, stages

    im_info = im_info.to(det.device)
    with torch.no_grad():
        stage_ms, _ = stage_times(stages(det, images, im_info),
                                  BREAKDOWN_COUNT)
    traced_ms, busy_ms, top, ranges = device_profile(
        lambda: det.serve(images, im_info), BREAKDOWN_COUNT)
    out = dict(stage_ms=stage_ms, traced_request_ms=traced_ms,
               device_busy_ms=busy_ms,
               device_idle_share=max(0.0, 1.0 - busy_ms / traced_ms),
               top_kernels_ms=dict(list(top.items())[:6]))
    if ranges:
        out["ranges_device_ms"] = ranges
    log(f"{path} breakdown (ms a request of {B} images): "
        + json.dumps({k: round(v, 3) for k, v in stage_ms.items()})
        + f"; traced {traced_ms:.3f} ms, device idle "
        f"{out['device_idle_share']:.1%}; top kernels "
        + json.dumps({k: round(v, 3) for k, v in out["top_kernels_ms"].items()})
        + (f"; profiler ranges (device ms a request) {json.dumps(ranges)}"
           if ranges else ""))
    return out


def serve_retina(dev, smi, config=CONFIG_RETINA, path="serving_retina"):
    """Phase M: phase 4 on a RetinaNet config (`serve_dense`, seeded
    weights as they are). Returns (launch counts, ms per image, the K3
    reading, the breakdown)."""
    out = serve_dense(dev, smi, config, path, fold=False)
    return out["counts"], out["ms_per_image"], out["nms"], out["breakdown"]


# the decode threshold of FCOS's and RepPoints' logged score_thr=0 request
LIVE_THRESHOLD = 1e-12


def dense_candidates(head):
    """The candidates a dense head's decode gives an image: pre_nms_top_n
    on each level (RetinaNet, FCOS, RepPoints: every level at 800 x 1333
    has more (location, class) scores than that), FreeAnchor's one
    top-k."""
    top_n = head.p.proposal.pre_nms_top_n or 1000
    if type(head).__name__ == "FreeAnchorRetinaNetHead":
        return top_n
    return len(head.strides) * top_n


def serve_dense(dev, smi, config, path, prepare=None, inspect=None,
                fold=True):
    """Phase 4 on a RetinaNet, FCOS or RepPoints config (no RoIAlign; one
    NMS launch a request, the per-class NMS over the 5 levels' top
    candidates, so 160 problems of 5000 boxes at batch 2, FreeAnchor's
    160 x 1000; at score_thr=0 every box is live),
    `prepare` first and, with `fold`, FrozenBN folded from one request;
    detections against the plain-NMS path within 1e-4. Then K3 on a
    score_thr=0 request's own call against the plain version, chunked, the
    request's breakdown (a SEPC neck's FPN and SEPC parts apart) and what
    `inspect` reads. Returns a dict."""
    from simpledet_torch.infer import synthetic_batch

    counts, ms_img, det = serve(dev, smi, config, path, fold=fold,
                                prepare=prepare)
    images, im_info = synthetic_batch(B, H, W, 1)
    images = images.to(dev)
    head = det.model.head
    # FCOS's and RepPoints' decode keeps only class probabilities above
    # their threshold, which no seeded score passes (the 0.01 prior): for
    # this request the threshold is LIVE_THRESHOLD, so that the per-class
    # NMS meets the decode's real candidates (a threshold of 0 reads as
    # the default 0.05, `or 0.05`, as in the JAX package)
    key = {"FCOSHead": "pre_nms_thresh", "RepPointsHead":
           "min_det_score"}.get(type(head).__name__)
    saved = key and getattr(head.p.proposal, key)
    if key:
        setattr(head.p.proposal, key, LIVE_THRESHOLD)
    try:
        with recording() as calls:
            det.detect(images, im_info, score_thr=0.0)
            with torch.no_grad():
                data, info = det._inputs(images, im_info)
                decoded = int(det.model(data.float(), info, mode="test")[
                    "det_valid"].sum())
        torch.cuda.synchronize()
    finally:
        if key:
            setattr(head.p.proposal, key, saved)
    (boxes, valid, _), = calls["nms"]
    want = (B * head.num_fg_class, dense_candidates(head))
    if tuple(valid.shape) != want or not bool(valid.all()) or (
            key and decoded != want[1] * B):
        raise AssertionError(f"{path}: the score_thr=0 request's per-class "
                             f"NMS is {tuple(valid.shape)}, "
                             f"{int(valid.sum())} live, {decoded} decoded "
                             f"candidates, want {want} live")
    log(f"{path}: the score_thr=0 request decodes {decoded} valid "
        f"candidates" + (f" ({key} {LIVE_THRESHOLD})" if key else ""))
    out = dict(counts=counts, ms_per_image=ms_img,
               nms=nms_reading(calls, path),
               breakdown=request_breakdown(det, path, images, im_info))
    if inspect is not None:
        out.update(inspect(det, (images, im_info)))
    return out


def focal64(logits, label, alpha, gamma):
    """The sigmoid focal loss's definition summed, in float64: alpha
    (1-p)^gamma -log p on the label's column, (1-alpha) p^gamma -log(1-p)
    on the others, rows labelled below 0 ignored."""
    z = logits.double()
    label = label.long()
    target = label[..., None] == torch.arange(1, z.shape[-1] + 1,
                                              device=z.device)
    prob = torch.sigmoid(z)
    pos = -alpha * (1 - prob) ** gamma * torch.log(prob)
    neg = -(1 - alpha) * prob ** gamma * torch.log1p(-prob)
    per = torch.where(target, pos, neg).sum(-1)
    return torch.where(label >= 0, per, 0.0).sum()


def dense_definition(model, batch, pixel_norm, dev, path):
    """One train forward without grad of FCOS, RepPoints or FreeAnchor: its
    focal term against the definition in float64 within 1e-5 (FCOS's over
    its positives + 1, RepPoints' over its foreground count; FreeAnchor's
    focal-style negative loss against the same loss evaluated in float64
    from the float32 forward's outputs); the head's loss, targets included,
    timed (CUDA events). RetinaNet: `focal_definition`."""
    from simpledet_torch.models import freeanchor
    from simpledet_torch.ops.image import device_normalize

    head = model.head
    kind = type(head).__name__
    if kind == "RetinaNetHead":
        return focal_definition(model, batch, pixel_norm, dev, path)
    images, im_info, gt = batch
    gt = gt.to(dev)
    mt = getattr(model, "moment_transfer", None)

    def loss():
        if kind == "RepPointsHead":
            return head.loss(outs, gt, info, mt)
        return head.loss(outs, gt, info)

    with torch.no_grad():
        info = im_info.to(dev)
        data = device_normalize(images, info, *pixel_norm).float()
        outs = model.head_module(model.pyramid(data))
        losses, aux = loss()
        p = head.p
        if kind == "FreeAnchorRetinaNetHead":
            logits, deltas = head.flatten_outputs(outs)
            anchors = torch.cat(head.level_anchors(outs))
            top_n = p.anchor_assign.pre_anchor_top_n or 50
            key, rows = "freeanchor_negative_loss", anchors.shape[0]
            want = float(freeanchor.negative_loss(
                anchors.double(), gt.double(), torch.sigmoid(logits.double()),
                deltas.double(), info.double(),
                alpha=p.focal_loss.alpha or 0.5,
                gamma=p.focal_loss.gamma or 2.0,
                bbox_thr=p.anchor_assign.bbox_thr or 0.6,
                mean=p.head.mean, std=p.head.std).sum()
                / (aux["num_gt"].double() * top_n))
            count = float(aux["num_gt"])
        else:
            if kind == "FCOSHead":
                logits, label = head.flatten(outs)[1], aux["fcos_cls_label"]
                ls = p.loss_setting
                alpha, gamma = ls.focal_loss_alpha, ls.focal_loss_gamma
                count = float((label >= 1).sum())
                norm, key = count + 1.0, "fcos_cls_loss"
            else:
                logits, label = head.flatten(outs)[2], aux["reppoints_label"]
                alpha, gamma = p.focal_loss.alpha, p.focal_loss.gamma
                count = float((label >= 1).sum())
                norm, key = max(count, 1.0), "reppoints_cls_loss"
            rows = label.shape[1]
            want = float(focal64(logits, label, alpha or 0.25, gamma or 2.0)
                         / norm)
        got = float(losses[key])
        if abs(got - want) > 1e-5 * abs(want):
            raise AssertionError(f"{path}: {key} {got} is not its float64 "
                                 f"definition {want}")
        ms_loss = cuda_ms(loss, 3, 1)
    log(f"{path}: {key} {got:.6f} equals its float64 definition "
        f"({want:.6f}) within 1e-5, over {rows} rows x {logits.shape[-1]} "
        f"classes an image, {count:.0f} "
        + ("gt boxes" if kind == "FreeAnchorRetinaNetHead" else "positives")
        + f"; the head's loss with its targets {ms_loss:.3f} ms a step "
        "(CUDA events)")
    return dict(rows_per_image=rows, positives=count, loss_ms=ms_loss)


def focal_definition(model, batch, pixel_norm, dev, path):
    """The focal loss of one train forward without grad against its
    definition in float64 (alpha (1-p)^gamma -log p on the label's column,
    (1-alpha) p^gamma -log(1-p) on the others, ignored anchors 0, over the
    global foreground count): within 1e-5. The dense targets' time (CUDA
    events)."""
    from simpledet_torch.ops.image import device_normalize

    images, im_info, gt = batch
    with torch.no_grad():
        info = im_info.to(dev)
        data = device_normalize(images, info, *pixel_norm).float()
        outs = model.head_module(model.pyramid(data))
        losses, aux = model.head.loss(outs, gt.to(dev), info)
        logits, _ = model.head.flatten_outputs(outs)
    p_focal = model.head.p.focal_loss
    label = aux["rpn_label"]
    want = float(focal64(logits, label, p_focal.alpha, p_focal.gamma)
                 / aux["rpn_fg_count"].double())
    got = float(losses["retina_cls_loss"])
    if abs(got - want) > 1e-5 * want:
        raise AssertionError(f"{path}: retina_cls_loss {got} is not the "
                             f"float64 focal sum over the fg count {want}")
    n_anchor = label.shape[1]
    gt_d = gt.to(dev)
    ms_targets = cuda_ms(lambda: model.head.targets(outs, gt_d, info), 3, 1)
    log(f"{path}: retina_cls_loss {got:.6f} equals the float64 focal sum "
        f"over {n_anchor} anchors x {logits.shape[-1]} classes an image / fg "
        f"count {float(aux['rpn_fg_count']):.0f} ({want:.6f}) within 1e-5; "
        f"dense targets {ms_targets:.3f} ms a step (CUDA events)")
    return dict(anchors_per_image=n_anchor,
                fg_count=float(aux["rpn_fg_count"]), targets_ms=ms_targets)


def train_dense(dev, smi, config, path, prepare=None, inspect=None,
                lr_scale=1.0):
    """Phase N (and the RPN-only training of phase Q): the config's seeded
    train detector at full width on a synthetic batch (20 gt boxes an
    image), its FrozenBN folded; a RetinaNet's focal loss against its
    definition (`focal_definition`); 2 warm-up and 5 timed steps with
    finite losses; the launches of the timed steps (none: this path runs no
    counterpart of a TPU kernel; an RPN-only model's train forward makes no
    proposals); frozen parameters bit-unchanged and trained ones moved; the
    device's idle share of 3 traced steps; `prepare` and `inspect` as
    `train` takes them; the schedule's lr times `lr_scale`. Returns (launch
    counts, ms per step, its split, extra)."""
    from simpledet_torch.core.train import Trainer
    from simpledet_torch.train import synthetic_train_batch

    trainer = Trainer.from_config(config, device=dev, seed=0)
    if lr_scale != 1.0:
        schedule = trainer.schedule
        trainer.schedule = lambda step: lr_scale * schedule(step)
    if prepare is not None:
        prepare(trainer.model)
    images, im_info, gt = synthetic_train_batch(B, H, W, 0)
    batch = (images.to(dev), im_info, gt)
    trainer.fold_batch_stats(*batch[:2])
    model = trainer.model
    extra = {}
    if hasattr(model, "head_module"):
        extra.update(dense_definition(model, batch, trainer.pixel_norm, dev,
                                      path))
    if inspect is not None:
        extra.update(inspect(trainer, batch))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats(dev)
    ms_step, split = timed_steps(trainer, batch, path, smi, loss_check(path))
    counts = read_counts(path, ())
    if any(counts.values()):
        raise AssertionError(f"{path} launched a kernel: {counts}")
    log(f"{path}: no counterpart of a TPU kernel runs on this path (0 "
        "launches of NMS and RoIAlign in the timed steps)")
    extra["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"{path}: peak {extra['peak_gib']:.2f} GiB allocated")
    extra.update(step_profile(trainer, batch, path))
    check_trained(trainer, start, path)
    return counts, ms_step, split, extra


def retina_cli_phase(dev, smi):
    """Phase O, in a fresh temporary directory: the synthetic micro-COCO
    (`data/synthetic.py`, 8 images) through the train CLI on
    config/retina_micro_test.py (ResNet-50 FPN from scratch, FrozenBN, one
    epoch: its 8 images and their flips, 8 iterations at batch 2) and
    simpledet_torch.detection_test on
    its checkpoint: finite losses at the first step, the config's Focal
    metric logged, the 12-key COCO summary of finite numbers."""
    import tempfile

    from simpledet_torch import detection_test, detection_train
    from simpledet_torch.data.synthetic import make_micro_dataset

    cwd, saved = os.getcwd(), dict(os.environ)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_retina_cli_")
    try:
        os.chdir(tmp)
        make_micro_dataset(os.path.join(tmp, "micro"), n_images=8)
        os.environ["MICRO_DATA_ROOT"] = os.path.join(tmp, "micro")
        history = []
        zero_counts()
        detection_train.train_net(CONFIG_RETINA_MICRO, device=dev,
                                  loss_history=history, seed=0)
        torch.cuda.synchronize()
        train_counts = read_counts("retina_cli (train)", ())
        if len(history) != 8 or not all(
                np.isfinite(v) for v in history[0].values()):
            raise AssertionError(f"retina train CLI losses: {history}")
        with open(os.path.join("experiments", "retina_micro_test",
                               "log.txt")) as f:
            if "Focal=" not in f.read():
                raise AssertionError("the train CLI logged no Focal metric")
        stats = {}
        zero_counts()
        summary = detection_test.test_net(CONFIG_RETINA_MICRO, device=dev,
                                          stats=stats)
        torch.cuda.synchronize()
        eval_counts = read_counts("retina_cli (eval)", ("nms",))
        if summary is None or list(summary) != SUMMARY_KEYS or not all(
                np.isfinite(list(summary.values()))):
            raise AssertionError(f"retina test CLI summary {summary}")
        log(f"retina CLIs: {len(history)} train iterations, total losses "
            f"{[round(h['total_loss'], 4) for h in history]}; detection_test "
            f"{stats['images']} images at {stats['img_per_s']:.2f} img/s on "
            f"{smi}; summary {json.dumps(summary)}")
    finally:
        os.chdir(cwd)
        os.environ.clear()
        os.environ.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    return {k: train_counts[k] + eval_counts[k] for k in train_counts}, stats


def retina_phases(dev, smi):
    """Phases M, N and O."""
    out = {}
    with phase("M serving_retina"):
        out["serving"] = serve_retina(dev, smi)
        out["serving_r101"] = serve(dev, smi, CONFIG_RETINA_R101,
                                    "serving_retina_r101")[:2]
    with phase("N training_retina"):
        out["training"] = train_dense(dev, smi, CONFIG_RETINA,
                                      "training_retina")
    with phase("O retina_cli"):
        out["cli"] = retina_cli_phase(dev, smi)
    return out


def check_gates(path, gates, total, **readings):
    """Raise if a learning run missed a gate, with what the gates read
    (the APs, the step losses' means over each 40 steps and their
    largest) in the message: a failure shows on the standard error."""
    if all(gates.values()):
        return
    means = [round(float(total[i:i + 40].mean()), 4)
             for i in range(0, len(total), 40)]
    raise AssertionError(
        f"{path} gates failed: {gates}; "
        + ", ".join(f"{k} {v:.4f}" for k, v in readings.items())
        + f"; total loss by 40 steps {means}, largest {total.max():.4g} at "
        f"step {int(total.argmax())}")


def converge_retina(dev, smi):
    """Phase P: config/converge_retina.py (depth-18 FPN, SyncBN, a 64-wide
    head, adam) from scratch at batch 8 for CONVERGE_RETINA_EPOCHS epochs
    (640 steps) on phase C's 16 images and their flips through the train
    CLI, then the test CLI on the train set; the gates of the JAX package's
    tests/test_converge_retina.py (last-20 mean loss under half the
    first-20, AP >= 0.6, AP50 >= 0.8) beside its record; K3 on one eval
    batch's per-class NMS against the plain version."""
    return converge_dense(dev, smi, CONFIG_CONVERGE_RETINA, "converge_retina",
                          CONVERGE_RETINA_EPOCHS, JAX_CONVERGE_RETINA)


def converge_dense(dev, smi, config, path, epochs, record, ap50=0.8,
                   ratio=0.5):
    """A one-stage learning recipe (phases P and AE) from scratch at batch 8
    for `epochs` epochs of 4 steps through the train CLI, then the test CLI
    on the train set: the last-20 mean loss under `ratio` times the
    first-20, AP >= 0.6, AP50 >= `ap50`, beside the JAX record; K3 on the
    eval's per-class NMS calls against the plain version. Returns (launch
    counts, the K3 reading, the result)."""
    from simpledet_torch import detection_test, detection_train

    history = []
    zero_counts()
    t0 = time.perf_counter()
    detection_train.train_net(config, device=dev, loss_history=history)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    train_counts = read_counts(path, ())
    total = np.array([h["total_loss"] for h in history])
    first, last = float(total[:20].mean()), float(total[-20:].mean())
    log(f"{path}: {len(total)} steps at batch 8 in {seconds:.1f} s "
        f"(incl. start-up, loader and logging) on {smi}; mean total loss "
        f"first 20 {first:.4f}, last 20 {last:.6f}" + (
            f" (the JAX record: {record['first20']:.4f}, "
            f"{record['last20']:.5f})" if record["first20"] else
            " (the JAX record keeps no losses)"))
    if len(total) != 4 * epochs or not np.isfinite(total).all():
        raise AssertionError(f"{path}: {len(total)} steps, finite "
                             f"{bool(np.isfinite(total).all())}")
    stats = {}
    zero_counts()
    with recording() as calls:
        summary = detection_test.test_net(config, device=dev, stats=stats)
    torch.cuda.synchronize()
    eval_counts = read_counts(f"{path}_eval", ("nms",))
    at_converge = nms_reading(calls, f"{path} (trained, eval)")
    log(f"{path} eval: {stats['images']} images at batch "
        f"{stats['batch']}; AP {summary['AP']:.3f}, AP50 "
        f"{summary['AP50']:.3f}, AP75 {summary['AP75']:.3f} (the JAX "
        f"package's record, {record['chip']}, {4 * epochs} steps at batch "
        f"8: AP {record['AP']:.3f}, AP50 {record['AP50']:.3f}"
        + (f", AP75 {record['AP75']:.3f})" if record["AP75"] is not None
           else ")"))
    gates = {f"last 20 < first 20 * {ratio}": last < ratio * first,
             "AP >= 0.6": summary["AP"] >= 0.6,
             f"AP50 >= {ap50}": summary["AP50"] >= ap50}
    check_gates(path, gates, total,
                **{k: summary[k] for k in ("AP", "AP50", "AP75")})
    result = dict(steps=len(total), first20=first, last20=last,
                  seconds=seconds, **{k: summary[k] for k in
                                      ("AP", "AP50", "AP75")})
    return ({k: train_counts[k] + eval_counts[k] for k in train_counts},
            at_converge, result)


def serve_rpn_only(dev, smi):
    """Phase Q, serving: config/rpn_r50v1_fpn_1x.py at full width through
    Detector.propose, 1000 proposals an image; one NMS launch a request
    (every image's 5 levels in one call); the proposals against the
    plain-NMS path (the same rows valid, boxes within 1e-3 px, scores 1e-4);
    K3 on one request's own call."""
    import simpledet_torch.ops.nms as onms
    from simpledet_torch.infer import (Detector, precision,
                                       synthetic_batch)

    det = Detector(CONFIG_RPN, device=dev, seed=0)
    requests = [synthetic_batch(B, H, W, seed) for seed in range(4)]
    requests = [(x.to(dev), i) for x, i in requests]
    det.propose(*requests[0])
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    results = [det.propose(x, i) for x, i in requests]
    torch.cuda.synchronize()
    ms_img = (time.perf_counter() - t0) * 1e3 / (B * len(requests))
    counts = read_counts("serving_rpn_only", ("nms",))
    if counts["nms"] != len(requests) or counts["roi_align_fwd"]:
        raise AssertionError(f"serving_rpn_only: {counts} for "
                             f"{len(requests)} requests")
    for boxes, scores in results:
        valid = scores > -1e9
        assert boxes.shape == (B, 1000, 4) and scores.shape == (B, 1000)
        assert torch.isfinite(boxes).all() and bool(valid[:, :100].all())
        assert (boxes[valid] >= 0).all() and (boxes[valid][:, 2] <= W - 1).all()
    saved = onms.nms_keep_sorted
    onms.nms_keep_sorted = plain_nms
    try:
        ref = det.propose(*requests[1])
    finally:
        onms.nms_keep_sorted = saved
    got = results[1]
    if not torch.equal(got[1] > -1e9, ref[1] > -1e9):
        raise AssertionError("serving_rpn_only: valid proposals differ from "
                             "the plain path's")
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=1e-6)
    log(f"serving_rpn_only: {ms_img:.3f} ms per image at {H}x{W}, batch {B},"
        f" proposals only, {precision(det.model)}, on {smi}; "
        f"{int((got[1] > -1e9).sum())} proposals in the second request, "
        "equal to the plain-NMS path's")
    with recording() as calls:
        det.propose(*requests[2])
    torch.cuda.synchronize()
    return counts, ms_img, nms_reading(calls, "serving_rpn_only"), \
        request_breakdown(det, "serving_rpn_only", *requests[2])


def rpn_test_phase(dev, smi):
    """Phase Q, recall: `simpledet_torch.rpn_test`'s main with `--config
    config/converge_test.py` on phase C's trained checkpoint (its SyncBN
    statistics beside it): the gate of the JAX package's
    tests/test_convergence.py, best Recall@N at IoU 0.5 >= 0.95; K3 launched
    once a test image (batch 1)."""
    from simpledet_torch import rpn_test

    zero_counts()
    t0 = time.perf_counter()
    recalls = rpn_test.main(["--config", CONFIG_CONVERGE, "--device",
                             str(dev)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts("rpn_test", ("nms",))
    with open(os.path.join("experiments", "converge_test", "log.txt")) as f:
        lines = f.read().splitlines()
    start = max(i for i, ln in enumerate(lines) if "proposal recall on" in ln)
    lines = [ln.split(" ", 2)[2] for ln in lines[start:]]
    best = max(recalls.values())
    log(f"rpn_test on converge_test's checkpoint: {seconds:.1f} s on {smi}; "
        + "; ".join(ln for ln in lines if "Recall@" in ln or "loaded" in ln))
    if "loaded SyncBN running stats" not in lines:
        raise AssertionError("rpn_test did not load phase C's running "
                             "statistics")
    if best < 0.95:
        raise AssertionError(f"rpn_test gate: best recall at IoU 0.5 {best} "
                             "< 0.95")
    return counts, dict({str(k): float(v) for k, v in recalls.items()},
                        seconds=seconds)


def rpn_only_phase(dev, smi):
    """Phase Q: serve and train config/rpn_r50v1_fpn_1x.py at full width,
    then the proposal-recall CLI on phase C's checkpoint."""
    serving = serve_rpn_only(dev, smi)
    training = train_dense(dev, smi, CONFIG_RPN, "training_rpn_only")
    return serving, training, rpn_test_phase(dev, smi)


# ---------------------------------------------------- phases A, B and C

CONFIG_SYNC = "config/flagship_synth_curve.py"
CONFIG_CONVERGE = "config/converge_test.py"
CONFIG_CONVERGE_CASCADE = "config/converge_cascade.py"
CONFIG_CONVERGE_MASK = "config/converge_mask.py"
N_SYNTH_IMAGES = 4          # 800 x 1200 and 1200 x 800 in turn
CONVERGE_EPOCHS = 100       # 16 images and their flips at batch 8: 4 an epoch
CONVERGE_CASCADE_EPOCHS = 120                   # 480 steps, the JAX record's
CONVERGE_MASK_EPOCHS = 120                      # 480 steps, the JAX record's
# phases L and V train the mask recipe at half its lr (its CONVERGE_MASK_LR
# override). At its own 0.005 the recipe sits within a factor of 2 of
# divergence (`python -m simpledet_torch.converge_repeat`, on an H100): at
# 0.01 3 of 3 runs diverged (step losses above 1e14, then AP 0), as the JAX
# package's run does on the CPU mesh; at 0.005 2 of 12 diverged (losses
# above 1e14 by steps 65 and 108; the last-20 loss still fell under half
# the first-20, the AP gates failed), and so did one whole run of this
# script; at 0.0025 6 of 6 passed, and on v1d 3 of 3 (3 of 6 diverged at
# 0.005). Training on the card is not repeatable bit for bit (the first-20
# means of one call's runs differ), so each run draws its own trajectory.
CONVERGE_MASK_LR = "0.0025"
# the JAX package's records (the cascade's: experiments/converge_curve.md:65)
JAX_CONVERGE = dict(AP=0.937, AP50=1.000, AP75=1.000, chip="one TPU v5e chip")
JAX_CONVERGE_CASCADE = dict(AP=1.000, AP50=1.000, AP75=1.000, first20=1.94,
                            last20=0.10, chip="one TPU chip")
# experiments/converge_curve.md:66 (480 steps, ellipse masks)
JAX_CONVERGE_MASK = dict(bbox_AP=0.960, segm_AP=0.934, segm_AP75=1.000,
                         first20=2.57, last20=0.09, chip="one TPU chip",
                         lr="0.005")
SUMMARY_KEYS = ["AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
                "AR100", "ARs", "ARm", "ARl"]


def in_workdir(root):
    """The configs' relative paths (data/, experiments/ and the config
    names that General.name comes from) resolved under `root`: a copy of
    the configs there, and the synthetic data they read."""
    from simpledet_torch.data.synthetic import (make_micro_dataset,
                                                make_synth_coco)

    os.makedirs(os.path.join(root, "config"))
    for cfg in (CONFIG_SYNC, CONFIG_CONVERGE, CONFIG_CONVERGE_CASCADE,
                CONFIG_CONVERGE_MASK, CONFIG_CONVERGE_RETINA,
                CONFIG_CONVERGE_TRIDENT):
        shutil.copyfile(os.path.join(REPO, cfg), os.path.join(root, cfg))
    make_synth_coco(os.path.join(root, "synth"), n_images=N_SYNTH_IMAGES)
    make_micro_dataset(os.path.join(root, "converge"), n_images=16,
                       set_names=("converge_train",))
    # converge_mask reads CONVERGE_DATA_ROOT too: phase L points it here
    make_micro_dataset(os.path.join(root, "converge_ellipse"), n_images=16,
                       set_names=("converge_train",), shapes="ellipse")
    os.environ.update(FLAGSHIP_SYNTH_ROOT=os.path.join(root, "synth"),
                      FLAGSHIP_CURVE_EPOCHS="1",
                      CONVERGE_DATA_ROOT=os.path.join(root, "converge"),
                      CONVERGE_BATCH="8",
                      CONVERGE_EPOCHS=str(CONVERGE_EPOCHS),
                      CONVERGE_CASCADE_BATCH="8",
                      CONVERGE_CASCADE_EPOCHS=str(CONVERGE_CASCADE_EPOCHS),
                      CONVERGE_MASK_BATCH="8",
                      CONVERGE_MASK_EPOCHS=str(CONVERGE_MASK_EPOCHS),
                      CONVERGE_MASK_LR=CONVERGE_MASK_LR,
                      CONVERGE_RETINA_BATCH="8",
                      CONVERGE_RETINA_EPOCHS=str(CONVERGE_RETINA_EPOCHS),
                      CONVERGE_TRIDENT_BATCH="8",
                      CONVERGE_TRIDENT_EPOCHS=str(CONVERGE_TRIDENT_EPOCHS))
    os.chdir(root)
    log(f"synthetic data: {N_SYNTH_IMAGES} COCO-shaped images for "
        f"{CONFIG_SYNC}, 16 micro images for {CONFIG_CONVERGE}, "
        f"{CONFIG_CONVERGE_CASCADE}, {CONFIG_CONVERGE_RETINA} and "
        f"{CONFIG_CONVERGE_TRIDENT}, 16 ellipse "
        f"images for {CONFIG_CONVERGE_MASK}")


def train_syncbn(dev, smi):
    """Phase A: config/flagship_synth_curve.py (R50-FPN, bf16, SyncBN,
    nothing frozen) at full width in a 1-rank NCCL group with the model in
    DDP, on a batch of its synthetic data through the loader; then the
    group is left."""
    from simpledet_torch.core.config import read_config
    from simpledet_torch.core.train import Trainer
    from simpledet_torch.data.loader import Loader
    from simpledet_torch.data.roidb import load_roidb
    from simpledet_torch.data.transforms import from_config
    from simpledet_torch.dsl import build_detector
    from simpledet_torch.models.norm import SyncBN
    from simpledet_torch.parallel import dist

    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                      LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(dist.free_port()))
    try:
        dev = dist.init_from_env("cuda")
        backend = torch.distributed.get_backend()
        spec = read_config(CONFIG_SYNC, is_train=True)
        model = build_detector(spec)
        model.init_weights(torch.Generator().manual_seed(0))
        model = model.to(device=dev, memory_format=torch.channels_last)
        n_sync = sum(isinstance(m, SyncBN) for m in model.modules())
        trainer = Trainer.from_spec(model.train(), spec, 1, seed=0)
        roidb = load_roidb(spec.dataset.image_set, spec.dataset.cache_dir)
        batch = next(iter(Loader(roidb, from_config(spec.transform),
                                 spec.batch_image, shuffle=False,
                                 num_workers=0)))
        images = torch.from_numpy(batch["data"]).to(dev)
        log(f"training_syncbn: {n_sync} SyncBN layers, "
            f"{type(trainer.forward_model).__name__} in a {backend} group "
            f"of {dist.world_size()}, batch {tuple(images.shape)}, "
            f"{int((batch['gt_bbox'][..., 4] >= 0).sum())} gt boxes")
        if backend != "nccl" or n_sync != 53 or \
                type(trainer.forward_model).__name__ != \
                "DistributedDataParallel":
            raise AssertionError("phase A must train SyncBN in DDP over NCCL")
        return train(dev, smi, CONFIG_SYNC, "training_syncbn", trainer,
                     (images, torch.from_numpy(batch["im_info"]),
                      torch.from_numpy(batch["gt_bbox"])))
    finally:
        dist.destroy()
        for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)


def train_cli_rank(out):
    """One torchrun rank of phase B: detection_train's train_net on the
    SyncBN flagship (it joins the group from torchrun's environment); the
    kernels' launches and the losses into the json file `out`."""
    from simpledet_torch import detection_train

    history = []
    zero_counts()
    trainer = detection_train.train_net(CONFIG_SYNC, device="cuda",
                                        loss_history=history)
    torch.cuda.synchronize()
    from simpledet_torch.kernels import nms as knms
    from simpledet_torch.kernels import roi_align as kroi
    from simpledet_torch.parallel import dist
    with open(out, "w") as f:
        json.dump(dict(counts={"nms": knms.launches,
                               "roi_align_fwd": kroi.launches,
                               "roi_align_bwd": kroi.bwd_launches},
                       losses=history, steps=trainer.step_count,
                       ddp=type(trainer.forward_model).__name__,
                       backend=torch.distributed.get_backend()), f)
    dist.destroy()


def cli_syncbn(dev, smi):
    """Phase B: `torchrun --nproc_per_node 1` of the train CLI on the SyncBN
    flagship for one epoch (its 4 images and their flips, 4 iterations);
    it writes .params and .batch_stats; the test CLI evaluates on them."""
    from simpledet_torch import detection_test
    from simpledet_torch.core import checkpoint as ckpt
    from simpledet_torch.core.config import read_config
    from simpledet_torch.parallel.dist import free_port

    out = os.path.abspath("train_cli_rank.json")
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "1", "--master_port", str(free_port()),
         os.path.join(REPO, "chip_smoke.py"), "--train-cli-rank", out],
        env=env, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"torchrun train CLI exited {run.returncode}:"
                             f"\n{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    with open(out) as f:
        rank = json.load(f)
    counts = rank["counts"]
    log(f"train_cli_syncbn path launches {counts}")
    for name in ("nms", "roi_align_fwd", "roi_align_bwd"):
        if counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "torchrun train CLI")
    losses = [h["total_loss"] for h in rank["losses"]]
    if rank["ddp"] != "DistributedDataParallel" or rank["backend"] != \
            "nccl" or not np.isfinite(losses).all():
        raise AssertionError(f"torchrun train CLI: {rank}")
    spec = read_config(CONFIG_SYNC)
    prefix, epoch = spec.test.model.prefix, spec.test.model.epoch
    for path in (ckpt.params_path(prefix, epoch),
                 ckpt.batch_stats_path(prefix, epoch)):
        if not os.path.exists(path):
            raise AssertionError(f"the train CLI did not write {path}")
    stats = ckpt.flatten(ckpt.read_params(ckpt.batch_stats_path(prefix,
                                                                epoch)))
    if len(stats) != 106 or not all(np.isfinite(v).all()
                                    for v in stats.values()):
        raise AssertionError(f"{len(stats)} running statistics in the file")
    log(f"train CLI under torchrun: {rank['steps']} iterations in "
        f"{seconds:.1f} s incl. start-up, NCCL, DDP, total losses "
        f"{losses}; wrote {ckpt.params_path(prefix, epoch)} and "
        f"{ckpt.batch_stats_path(prefix, epoch)} ({len(stats)} leaves)")

    eval_stats = {}
    zero_counts()
    summary = detection_test.test_net(CONFIG_SYNC, device=dev,
                                      stats=eval_stats)
    torch.cuda.synchronize()
    eval_counts = read_counts("eval_cli_syncbn", ("nms", "roi_align_fwd"))
    with open(os.path.join("experiments", spec.name, "log.txt")) as f:
        text = f.read()
    if "loaded SyncBN running stats" not in text or summary is None or \
            list(summary) != SUMMARY_KEYS:
        raise AssertionError(f"the test CLI did not evaluate on the saved "
                             f"running statistics: {summary}")
    log(f"eval CLI (SyncBN, running statistics from .batch_stats): "
        f"{eval_stats['images']} images at batch {eval_stats['batch']}, "
        f"{eval_stats['img_per_s']:.2f} img/s on {smi}; summary "
        f"{json.dumps(summary)}")
    return counts, eval_counts


def converge_kernels(dev, trainer, batch):
    """K1, K2 and K3 at converge_test's shapes (B=8, 128 x 192, P2-P5 of
    32 x 48 down to 4 x 6, C=256, fp32; converge_trident's: the stride-16
    map of 3 branches [24, 8, 12, 1024], its RoiParam's 7 x 7) on the
    trained model's SyncBN pyramid: the RoIAlign forward with tie codes on
    its proposals (32 a image, the train config's image_roi) bit for bit,
    the backward against the plain backward (1e-5 of each level's max
    |grad|), and the NMS of its proposal pools (8 x 5 of 128 at 0.7) flag
    for flag. Times beside each function's bound."""
    from simpledet_torch.kernels import nms as knms
    from simpledet_torch.kernels import roi_align as kroi
    from simpledet_torch.ops.nms import NEG_INF

    model = trainer.model
    with torch.no_grad():
        data, im_info = trainer._inputs(batch["data"], batch["im_info"])
        pyr = model.pyramid(data)
        rpn_out = model.rpn_module(pyr)
        if hasattr(model, "fold"):      # a TridentNet's branches
            im_info = model.fold(im_info)
        boxes, scores = model.rpn.level_candidates(rpn_out, im_info)
        props, _ = model.rpn.nms_and_select(boxes, scores)
    stride = model.p_roi.stride
    strides = tuple(stride) if hasattr(stride, "__len__") else (stride,)
    feats = [pyr[f"stride{st}"].permute(0, 2, 3, 1).contiguous()
             for st in strides]
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    rois = props[:, :32].contiguous()
    b, r = rois.shape[:2]
    c = feats[0].shape[3]
    out = {}
    p = model.p_roi.out_size
    pooled, codes = kroi.roi_align_fwd_cuda(feats, rois, strides,
                                            out_size=p, with_codes=True)
    torch.cuda.synchronize()
    want, want_codes = kroi.multilevel_roi_align_plain(
        feats, rois, strides, out_size=p, with_codes=True)
    if not (torch.equal(codes, want_codes) and torch.equal(pooled, want)):
        raise AssertionError("converge shapes: RoIAlign forward differs")
    isz = feats[0].element_size()
    maps = sum(b * h * w * c for h, w in level_hw) * isz
    nbytes = maps + rois.numel() * 4 + pooled.numel() * isz + codes.numel()
    bms, by = bound_ms(nbytes, ROI_OPS_PER_OUT * pooled.numel())
    out["roi_align_fwd"] = dict(
        ms=cuda_ms(lambda: kroi.roi_align_fwd_cuda(
            feats, rois, strides, out_size=p, with_codes=True), 20),
        plain_ms=cuda_ms(lambda: kroi.multilevel_roi_align_plain(
            feats, rois, strides, out_size=p, with_codes=True), 3, 1),
        bound_ms=bms, bound_by=by, max_abs_err=0.0)
    g = torch.from_numpy(np.random.RandomState(6).randn(
        *pooled.shape).astype(np.float32)).to(dev)
    got = kroi.roi_align_bwd_cuda(g, codes, rois, level_hw, strides=strides,
                                  dtype=torch.float32, out_size=p)
    torch.cuda.synchronize()
    ref = kroi.multilevel_roi_align_bwd_plain(g, codes, rois, level_hw,
                                              strides=strides,
                                              dtype=torch.float32, out_size=p)
    err = 0.0
    for gl, wl in zip(got, ref):
        scale = float(wl.abs().max())
        torch.testing.assert_close(gl, wl, rtol=0, atol=1e-5 * scale)
        err = max(err, float((gl - wl).abs().max()))
    popcount = sum((codes.int() >> st) & 1 for st in range(4))
    nbytes = g.numel() * 4 + codes.numel() + rois.numel() * 4 + maps
    bms, by = bound_ms(nbytes, BWD_OPS_PER_OUT * pooled.numel()
                       + BWD_OPS_PER_TIED_SAMPLE * float(popcount.sum()))
    out["roi_align_bwd"] = dict(
        ms=cuda_ms(lambda: kroi.roi_align_bwd_cuda(
            g, codes, rois, level_hw, strides=strides, dtype=torch.float32,
            out_size=p), 20),
        plain_ms=cuda_ms(lambda: kroi.multilevel_roi_align_bwd_plain(
            g, codes, rois, level_hw, strides=strides, dtype=torch.float32,
            out_size=p), 3, 1),
        bound_ms=bms, bound_by=by, max_abs_err=err)
    n_level, pre = scores.shape[1:]
    pool_boxes = boxes.reshape(b * n_level, pre, 4).contiguous()
    valid = (scores > NEG_INF / 2).reshape(b * n_level, pre)
    thr = float(model.rpn.p.proposal.nms_thr)
    keep = knms.nms_keep_sorted(pool_boxes, valid, thr)
    torch.cuda.synchronize()
    diff = int((keep != knms.nms_keep_sorted_plain(pool_boxes, valid,
                                                   thr)).sum())
    if diff:
        raise AssertionError(f"converge shapes: {diff} NMS flags differ")
    nv = valid.sum(1).double()
    bms, by = bound_ms(pool_boxes.numel() * 4 + 2 * valid.numel(),
                       float((NMS_OPS_PER_PAIR * nv * (nv - 1) / 2
                              + NMS_OPS_PER_BOX * nv).sum()))
    out["nms"] = dict(
        ms=cuda_ms(lambda: knms.nms_keep_sorted(pool_boxes, valid, thr), 20),
        plain_ms=cuda_ms(lambda: knms.nms_keep_sorted_plain(
            pool_boxes, valid, thr), 3, 1),
        bound_ms=bms, bound_by=by, max_abs_err=0.0)
    for name, v in out.items():
        log(f"{name} at converge shapes (B={b}, R={r}, C={c}, levels "
            f"{level_hw}; NMS {b * n_level}x{pre}@{thr}): kernel "
            f"{v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, bound "
            f"{v['bound_ms']:.6f} ms ({v['bound_by']}), max_abs_err "
            f"{v['max_abs_err']:.3g}")
    return out


def converge(dev, smi, config=CONFIG_CONVERGE, path="converge",
             epochs=CONVERGE_EPOCHS, record=JAX_CONVERGE, ratio=0.5,
             ap50=0.95):
    """Phase C: config/converge_test.py from scratch at batch 8 for
    CONVERGE_EPOCHS epochs (400 steps) through the train CLI's train_net,
    then its test CLI on the train set; the gates of the JAX package's
    tests/test_convergence.py (last 20 steps' mean loss under half the
    first 20's, AP >= 0.6, AP50 >= 0.95), AP beside the JAX record. Phase
    H: the same on config/converge_cascade.py for CONVERGE_CASCADE_EPOCHS
    epochs (480 steps), the gates of tests/test_converge_cascade.py (the
    same three), and `stage_readings` on one more step of the trained
    cascade, whose stages sample rois that cluster on the gt boxes. Phase
    Z: the same on config/converge_trident.py (three branches, SyncBN,
    scale-aware) for CONVERGE_TRIDENT_EPOCHS epochs (480 steps), the gates
    of tests/test_converge_trident.py (the same three). Phase AN: the same
    on config/converge_tsd.py (480 steps), the gates of
    tests/test_converge_tsd.py (`ratio` 0.6, `ap50` 0.9)."""
    from simpledet_torch import detection_test, detection_train
    from simpledet_torch.core.config import read_config
    from simpledet_torch.data.loader import Loader
    from simpledet_torch.data.roidb import load_roidb
    from simpledet_torch.data.transforms import from_config

    history = []
    zero_counts()
    t0 = time.perf_counter()
    trainer = detection_train.train_net(config, device=dev,
                                        loss_history=history)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    train_counts = read_counts(path, ("nms", "roi_align_fwd",
                                      "roi_align_bwd"))
    total = np.array([h["total_loss"] for h in history])
    first, last = float(total[:20].mean()), float(total[-20:].mean())
    log(f"{path}: {len(total)} steps at batch 8 in {seconds:.1f} s "
        f"(incl. start-up, loader and logging) on {smi}; mean total loss "
        f"first 20 {first:.4f}, last 20 {last:.4f}"
        + (f" (the JAX record: {record['first20']:.2f}, "
           f"{record['last20']:.2f})" if "first20" in record else ""))
    if len(total) != 4 * epochs or not np.isfinite(total).all():
        raise AssertionError(f"{path}: {len(total)} steps, finite "
                             f"{bool(np.isfinite(total).all())}")

    spec = read_config(config, is_train=True)
    roidb = load_roidb(spec.dataset.image_set, spec.dataset.cache_dir)
    batch = next(iter(Loader(roidb, from_config(spec.transform), 8,
                             shuffle=False, num_workers=0)))
    kernels = converge_kernels(dev, trainer, batch)
    cascade = hasattr(trainer.model, "heads")
    if cascade:
        # the checkpoint on disk is what the test CLI evaluates
        with recording() as calls:
            trainer.step(batch["data"], batch["im_info"], batch["gt_bbox"])
        torch.cuda.synchronize()
        kernels["roi_align_bwd"]["trained_by_stage"] = stage_readings(
            dev, calls, f"{path} (trained)")[0]

    stats = {}
    zero_counts()
    summary = detection_test.test_net(config, device=dev, stats=stats)
    torch.cuda.synchronize()
    eval_counts = read_counts(f"{path}_eval", ("nms", "roi_align_fwd"))
    log(f"{path} eval: {stats['images']} images at batch "
        f"{stats['batch']}; AP {summary['AP']:.3f}, AP50 "
        f"{summary['AP50']:.3f}, AP75 {summary['AP75']:.3f} (the JAX "
        f"package's record, {record['chip']}, {4 * epochs} steps at batch 8:"
        f" AP {record['AP']:.3f}, AP50 {record['AP50']:.3f}, AP75 "
        f"{record['AP75']:.3f})"
        + ("" if cascade or path != "converge" else
           "; RPN recall gate: phase Q"))
    gates = {f"last 20 < first 20 * {ratio}": last < ratio * first,
             "AP >= 0.6": summary["AP"] >= 0.6,
             f"AP50 >= {ap50}": summary["AP50"] >= ap50}
    check_gates(path, gates, total,
                **{k: summary[k] for k in ("AP", "AP50", "AP75")})
    result = dict(steps=len(total), first20=first, last20=last,
                  seconds=seconds, **{k: summary[k] for k in
                                      ("AP", "AP50", "AP75")})
    return train_counts, eval_counts, kernels, result


def converge_mask(dev, smi, bwd_sets, config=CONFIG_CONVERGE_MASK,
                  path="converge_mask", record=JAX_CONVERGE_MASK,
                  prefix="CONVERGE_MASK", segm_ap50=0.95):
    """Phase L: config/converge_mask.py (depth-18 FPN, SyncBN, 4 classes,
    the mask branch at 14 x 14 / 28 x 28) from scratch at batch 8 and lr
    CONVERGE_MASK_LR for CONVERGE_MASK_EPOCHS epochs (480 steps) on 16
    ellipse images and their
    flips through the train CLI's train_net; the box RoIAlign and NMS at its
    shapes (`converge_kernels`); K1 and K2 at 7 x 7 and 14 x 14 on one more
    step of the trained model, whose fg rois cluster on the gt boxes
    (`mask_roi_kernels`); then simpledet_torch.mask_test on the train set.
    The gates of the JAX package's tests/test_converge_mask.py: finite
    losses, last-20 mean under half the first-20, box AP >= 0.6, segm AP >=
    0.6, segm AP50 >= 0.95; read beside the JAX record. Phase V: the same
    on `config` (the recipe on a v1d backbone, for which the JAX package has
    no record: `record` None). Phase AN: config/converge_msrcnn.py (env
    prefix CONVERGE_MSRCNN), the gates of tests/test_converge_msrcnn.py
    (no segm AP50 gate: `segm_ap50` None; maskiou_loss in every step)."""
    from simpledet_torch import detection_train, mask_test
    from simpledet_torch.core.config import read_config
    from simpledet_torch.data.loader import Loader
    from simpledet_torch.data.roidb import load_roidb
    from simpledet_torch.data.transforms import from_config

    history = []
    zero_counts()
    t0 = time.perf_counter()
    trainer = detection_train.train_net(config, device=dev,
                                        loss_history=history)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    train_counts = read_counts(path, (
        "nms", "roi_align_fwd", "roi_align_bwd"))
    total = np.array([h["total_loss"] for h in history])
    first, last = float(total[:20].mean()), float(total[-20:].mean())
    jax_line = (f"the JAX record at lr {record['lr']}: "
                f"{record['first20']:.2f}, {record['last20']:.2f}" if record
                else "the JAX package has no record for this recipe")
    log(f"{path}: {len(total)} steps at batch 8 and lr "
        f"{os.environ[prefix + '_LR']} in {seconds:.1f} s "
        f"(incl. start-up, loader and logging) on {smi}; mean total loss "
        f"first 20 {first:.4f}, last 20 {last:.4f} ({jax_line}); mask loss first "
        f"20 {np.mean([h['mask_loss'] for h in history[:20]]):.4f}, last 20 "
        f"{np.mean([h['mask_loss'] for h in history[-20:]]):.4f}")
    if len(total) != 4 * int(os.environ[prefix + "_EPOCHS"]) or \
            not np.isfinite(total).all():
        raise AssertionError(f"{path}: {len(total)} steps, finite "
                             f"{bool(np.isfinite(total).all())}")
    if hasattr(trainer.model, "maskiou_head") and not all(
            "maskiou_loss" in h for h in history):
        raise AssertionError(f"{path}: a step without maskiou_loss")

    spec = read_config(config, is_train=True)
    roidb = load_roidb(spec.dataset.image_set, spec.dataset.cache_dir)
    batch = next(iter(Loader(roidb, from_config(spec.transform), 8,
                             shuffle=False, num_workers=0,
                             keys=("data", "im_info", "gt_bbox",
                                   "gt_poly"))))
    kernels = converge_kernels(dev, trainer, batch)
    # the checkpoint on disk is what mask_test evaluates
    with recording() as calls:
        trainer.step(batch["data"], batch["im_info"], batch["gt_bbox"],
                     batch["gt_poly"])
    torch.cuda.synchronize()
    readings, k1, k2 = mask_roi_kernels(dev, calls, bwd_sets,
                                        f"{path} (trained)")
    kernels["roi_align_fwd"]["trained_14"] = k1
    kernels["roi_align_bwd"]["trained_14"] = dict(k2, **{
        k: readings["14"][k] for k in ("busiest_tile_rois", "mean_tile_rois",
                                       "tiles_met", "shape")})
    kernels["roi_align_bwd"]["trained_7"] = readings["7"]

    stats = {}
    zero_counts()
    summaries = mask_test.mask_test_net(config, device=dev,
                                        stats=stats)
    torch.cuda.synchronize()
    eval_counts = read_counts(f"{path}_eval", ("nms", "roi_align_fwd"))
    box, segm = summaries["bbox"], summaries["segm"]
    log(f"{path} eval: {stats['images']} images at batch "
        f"{stats['batch']}; box AP {box['AP']:.3f}, segm AP "
        f"{segm['AP']:.3f}, AP50 {segm['AP50']:.3f}, AP75 {segm['AP75']:.3f}"
        + (f" (the JAX package's record, {record['chip']}, 480 steps at lr "
           f"{record['lr']}: box AP"
           f" {record['bbox_AP']:.3f}, segm AP {record['segm_AP']:.3f}, segm"
           f" AP75 {record['segm_AP75']:.3f})" if record else
           " (the JAX package has no record for this recipe)"))
    gates = {"last 20 < first 20 / 2": last < 0.5 * first,
             "box AP >= 0.6": box["AP"] >= 0.6,
             "segm AP >= 0.6": segm["AP"] >= 0.6}
    if segm_ap50 is not None:
        gates[f"segm AP50 >= {segm_ap50}"] = segm["AP50"] >= segm_ap50
    check_gates(path, gates, total, box_AP=box["AP"], segm_AP=segm["AP"],
                segm_AP50=segm["AP50"], first20=first, last20=last)
    result = dict(steps=len(total), first20=first, last20=last,
                  seconds=seconds, bbox_AP=box["AP"], segm_AP=segm["AP"],
                  segm_AP50=segm["AP50"], segm_AP75=segm["AP75"])
    return train_counts, eval_counts, kernels, result


def syncbn_phases(dev, smi, bwd_sets):
    """Phases A, B, C, H, L, P, Q, V, Z and AN in a fresh temporary
    directory, removed afterwards (Q's recall reads phase C's checkpoint
    there); C, H, Z and AN's converge_tsd side by side, all but C in child
    processes; L, V and AN's converge_msrcnn side by side, V and
    converge_msrcnn in child processes (each in a directory of its
    own)."""
    import tempfile

    cwd = os.getcwd()
    saved = dict(os.environ)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_syncbn_")
    try:
        in_workdir(tmp)
        with phase("A training_syncbn"):
            out = {"training_syncbn": train_syncbn(dev, smi)}
        with phase("B train and test CLIs under torchrun"):
            out["cli"] = cli_syncbn(dev, smi)
        with phase("C converge, H converge_cascade, Z converge_trident and "
                   "AN converge_tsd, side by side"):
            out["converge"], children = side_by_side(
                lambda: converge(dev, smi),
                ("converge_cascade", "converge_trident", "converge_tsd"))
            out.update(children)
        with phase("L converge_mask, V converge_mask_v1d and AN "
                   "converge_msrcnn, side by side"):
            os.environ["CONVERGE_DATA_ROOT"] = os.path.join(
                tmp, "converge_ellipse")
            out["converge_mask"], children = side_by_side(
                lambda: converge_mask(dev, smi, bwd_sets),
                ("converge_mask_v1d", "converge_msrcnn"))
            out.update(children)
        os.environ["CONVERGE_DATA_ROOT"] = os.path.join(tmp, "converge")
        with phase("P converge_retina"):
            out["converge_retina"] = converge_retina(dev, smi)
        with phase("Q rpn_only"):
            out["rpn_only"] = rpn_only_phase(dev, smi)
    finally:
        os.chdir(cwd)
        os.environ.clear()
        os.environ.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ------------------------------------------- phases R, S, T, U and V

V1B = os.path.join(REPO, "config", "resnet_v1b")
CONFIG_MASK_V1B = os.path.join(V1B, "mask_r50v1b_fpn_1x.py")
CONFIG_FASTER_V1D = os.path.join(V1B, "faster_r50v1d_fpn_1x.py")
CONFIG_FASTER_R152 = os.path.join(V1B, "faster_r152v1b_fpn_1x.py")
CONFIG_RETINA_R152 = os.path.join(V1B, "retina_r152v1b_fpn_1x.py")
CONFIG_MASK_GN = os.path.join(REPO, "config", "scratch",
                              "mask_r50v1b_fpn_gn_scratch_2x.py")
CONFIG_MASK_BN = os.path.join(REPO, "config", "scratch",
                              "mask_r50v1b_fpn_bn_scratch_2x.py")
# phase V's recipe: config/converge_mask.py with its TinyBackbone's base
# swapped for the v1d backbone, written into the phase's directory
CONFIG_CONVERGE_MASK_V1D = "config/converge_mask_v1d.py"
# ... at phase L's lr, CONVERGE_MASK_LR: at the recipe's 0.005, 3 of 6
# runs on an H100 diverged between steps 80 and 120 (losses above 1e10,
# then AP 0) and 3 passed the gates; at 0.0025 all 3 passed


def check_variant(model, variant, path):
    """The backbone is the variant the config names: v1d's three 3 x 3
    stem convs and its average-pool shortcuts, v1b's stride on conv2."""
    bb = model.backbone
    unit = bb.stage2_unit1
    stem = [tuple(getattr(bb, n).weight.shape[2:]) for n in bb.stem]
    want = [(3, 3)] * 3 if variant == "v1d" else [(7, 7)]
    if bb.variant != variant or stem != want or unit.conv2.stride != (2, 2) \
            or unit.avg_down != (variant == "v1d"):
        raise AssertionError(f"{path}: backbone {bb.variant}, stem {stem}")
    log(f"{path}: ResNet-{variant}, stem {bb.stem} {stem}, stride on conv2"
        + (", average-pool shortcuts" if variant == "v1d" else ""))


def mask_v1b_phase(dev, smi):
    """Phase R: config/resnet_v1b/mask_r50v1b_fpn_1x.py served (phase I's
    checks, FrozenBN folded from one request, the request's breakdown and
    the device's idle share) and trained (phase J's checks: 2 warm-up and 5
    timed steps, the kernel step against the plain step, the idle share of
    3 traced steps); K1 with codes and K2 at 7 x 7 and 14 x 14 on one more
    recorded step's rois, K3 on its proposals' NMS calls, each against its
    plain version."""
    out = {"serving": serve_mask(dev, smi, CONFIG_MASK_V1B,
                                 "serving_mask_v1b", fold=True,
                                 breakdown=True)}
    out["training"] = train(dev, smi, CONFIG_MASK_V1B, "training_mask_v1b",
                            profile=True, record=True)
    calls = out["training"][3].pop("calls")
    log(f"training_mask_v1b: one step's kernel calls {by_size(calls)}")
    out["roi"] = mask_roi_kernels(dev, calls, None, "training_mask_v1b")
    out["nms"] = nms_reading(calls, "training_mask_v1b")
    return out


# v1d's average-pool shortcut floors an odd side where the 3 x 3 / 2 main
# branch ceils: along the config's own 1333-wide pad, stage 3's first unit
# meets 167 columns (83 against 84), and the JAX package's backbone fails
# there as the port's does (tests/test_torch_resnet_variants.py). Phase S
# runs at 1333 rounded up to a multiple of 32.
V1D_W = 1344


def faster_v1d_phase(dev, smi):
    """Phase S: config/resnet_v1b/faster_r50v1d_fpn_1x.py (the deep stem and
    the average-pool shortcut) served and trained as phases 4 and 5 are,
    FrozenBN folded from one batch, at H x V1D_W."""
    global W
    saved, W = W, V1D_W
    try:
        counts, ms_img, det = serve(dev, smi, CONFIG_FASTER_V1D,
                                    "serving_faster_v1d", fold=True)
        check_variant(det.model, "v1d", "serving_faster_v1d")
        del det
        return (counts, ms_img), train(dev, smi, CONFIG_FASTER_V1D,
                                       "training_faster_v1d")
    finally:
        W = saved


def r152_phase(dev, smi):
    """Phase T: config/resnet_v1b/faster_r152v1b_fpn_1x.py and
    retina_r152v1b_fpn_1x.py served as phase 4 serves, FrozenBN folded from
    one request, with the peak device memory of the timed requests.
    Returns {path: (launch counts, ms per image, peak GiB)}."""
    out = {}
    for config, path in ((CONFIG_FASTER_R152, "serving_faster_r152"),
                         (CONFIG_RETINA_R152, "serving_retina_r152")):
        torch.cuda.empty_cache()
        stats = {}
        counts, ms_img, det = serve(dev, smi, config, path, fold=True,
                                    stats=stats)
        if [len(u) for u in det.model.backbone.units] != [3, 8, 36, 3]:
            raise AssertionError(f"{path}: not an R152")
        check_variant(det.model, "v1b", path)
        out[path] = (counts, ms_img, stats["peak_gib"])
        del det
    return out


def scratch_step(dev, smi, config, path):
    """One training step of a from-scratch Mask R-CNN config at full width
    (batch 2, 800 x 1333, 20 gt boxes an image with their ellipses) after a
    warm-up step: finite losses, the kernels launched, every backbone norm
    the config's (GroupNorm or SyncBN) and no norm outside the backbone,
    nothing frozen. Returns (launch counts, ms of the step, its losses,
    norm layers)."""
    from simpledet_torch.core.train import Trainer
    from simpledet_torch.models.norm import GroupNorm, SyncBN
    from simpledet_torch.train import synthetic_gt_poly, synthetic_train_batch

    trainer = Trainer.from_config(config, device=dev, seed=0)
    model = trainer.model
    norms = [n for n, m in model.named_modules()
             if isinstance(m, (GroupNorm, SyncBN))]
    kinds = {type(m).__name__ for m in model.modules()
             if isinstance(m, (GroupNorm, SyncBN))}
    if not norms or any(not n.startswith("backbone.") for n in norms) or \
            len(kinds) != 1 or not all(trainer.trainable.values()):
        raise AssertionError(f"{path}: norms {kinds} at {norms[:3]}..., "
                             f"{sum(not t for t in trainer.trainable.values())}"
                             " frozen")
    images, im_info, gt = synthetic_train_batch(B, H, W, 0)
    batch = (images.to(dev), im_info, gt, synthetic_gt_poly(gt))
    check = loss_check(path)
    check(0, trainer.step(*batch))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    losses = check(1, trainer.step(*batch))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts(path, ("nms", "roi_align_fwd", "roi_align_bwd"))
    log(f"{path}: {len(norms)} {kinds.pop()} layers, all in the backbone, "
        f"nothing frozen; step 1 {ms:.3f} ms at {H}x{W}, batch {B}, fp32 "
        f"without TF32, on {smi}")
    return counts, ms, losses, len(norms)


def scratch_rank(out):
    """One torchrun rank of phase U: `scratch_step` on the SyncBN scratch
    config in the process group that torchrun's environment describes (a
    1-rank NCCL group, the model in DDP); its result into the json file
    `out`."""
    from simpledet_torch.parallel import dist

    dev = dist.init_from_env("cuda")
    smi = environment()
    try:
        counts, ms, losses, n_norm = scratch_step(
            dev, smi, CONFIG_MASK_BN, "training_mask_bn_scratch")
        with open(out, "w") as f:
            json.dump(dict(counts=counts, ms=ms, losses=losses, norms=n_norm,
                           backend=torch.distributed.get_backend(),
                           world=dist.world_size()), f)
    finally:
        dist.destroy()


def scratch_phase(dev, smi):
    """Phase U: `scratch_step` on config/scratch/mask_r50v1b_fpn_gn_scratch_2x.py
    (GroupNorm in every backbone norm) in this process, and on
    mask_r50v1b_fpn_bn_scratch_2x.py (SyncBN) under `torchrun
    --nproc_per_node 1` (this script's --scratch-rank mode). Returns
    {path: (launch counts, ms, losses)}."""
    import tempfile

    from simpledet_torch.parallel.dist import free_port

    gn = scratch_step(dev, smi, CONFIG_MASK_GN, "training_mask_gn_scratch")
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scratch_")
    out = os.path.join(tmp, "scratch_rank.json")
    try:
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", "1", "--master_port", str(free_port()),
             os.path.join(REPO, "chip_smoke.py"), "--scratch-rank", out],
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=600)
        if run.returncode != 0:
            raise AssertionError(f"torchrun scratch step exited "
                                 f"{run.returncode}:\n{run.stdout[-3000:]}\n"
                                 f"{run.stderr[-3000:]}")
        with open(out) as f:
            rank = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if rank["backend"] != "nccl" or rank["world"] != 1:
        raise AssertionError(f"the SyncBN scratch step ran in {rank}")
    log(f"training_mask_bn_scratch (torchrun, {rank['backend']} group of "
        f"{rank['world']}): {rank['norms']} SyncBN layers, step 1 "
        f"{rank['ms']:.3f} ms, launches {rank['counts']}, losses "
        + ", ".join(f"{k} {v:.5f}" for k, v in rank["losses"].items()))
    return {"training_mask_gn_scratch": gn[:3],
            "training_mask_bn_scratch": (rank["counts"], rank["ms"],
                                         rank["losses"])}


def converge_v1d_phase(dev, smi):
    """Phase V, in a fresh temporary directory: config/converge_mask.py's
    recipe with its TinyBackbone's base swapped for ResNet50V1dFPN (depth
    18; the stride on the 3 x 3 conv, the deep stem, the average-pool
    shortcut), written there as CONFIG_CONVERGE_MASK_V1D, at lr
    CONVERGE_MASK_LR, on 16 ellipse images at batch 8 for 480 steps
    through the train CLI, then simpledet_torch.mask_test: phase L's gates
    (`converge_mask`). The JAX package has no record for this recipe."""
    import tempfile

    from simpledet_torch.data.synthetic import make_micro_dataset

    src = open(os.path.join(REPO, CONFIG_CONVERGE_MASK)).read()
    swaps = (("from models.maskrcnn.builder import MSRAResNet50V1FPN",
              "from models.FPN.builder import ResNet50V1dFPN"),
             ("class TinyBackbone(MSRAResNet50V1FPN):",
              "class TinyBackbone(ResNet50V1dFPN):"),
             ('"converge_mask"', '"converge_mask_v1d"'))
    for old, new in swaps:
        if old not in src:
            raise AssertionError(f"{CONFIG_CONVERGE_MASK} has no {old!r}")
        src = src.replace(old, new)
    cwd, saved = os.getcwd(), dict(os.environ)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_converge_v1d_")
    try:
        os.chdir(tmp)
        os.makedirs("config")
        with open(CONFIG_CONVERGE_MASK_V1D, "w") as f:
            f.write(src)
        make_micro_dataset(os.path.join(tmp, "ellipse"), n_images=16,
                           set_names=("converge_train",), shapes="ellipse")
        os.environ.update(CONVERGE_DATA_ROOT=os.path.join(tmp, "ellipse"),
                          CONVERGE_MASK_BATCH="8",
                          CONVERGE_MASK_EPOCHS=str(CONVERGE_MASK_EPOCHS),
                          CONVERGE_MASK_LR=CONVERGE_MASK_LR)
        log(f"converge_mask_v1d: lr {CONVERGE_MASK_LR} (the recipe's "
            "0.005 diverged in 3 of 6 card runs)")
        from simpledet_torch.core.config import read_config
        from simpledet_torch.dsl import build_detector
        check_variant(build_detector(read_config(CONFIG_CONVERGE_MASK_V1D,
                                                 is_train=True)),
                      "v1d", "converge_mask_v1d")
        return converge_mask(dev, smi, None, CONFIG_CONVERGE_MASK_V1D,
                             "converge_mask_v1d", None)
    finally:
        os.chdir(cwd)
        os.environ.clear()
        os.environ.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)


def backbone_phases(dev, smi):
    """Phases R, S, T and U (V: `syncbn_phases`)."""
    out = {}
    with phase("R mask_v1b"):
        out["mask_v1b"] = mask_v1b_phase(dev, smi)
    with phase("S faster_v1d"):
        out["faster_v1d"] = faster_v1d_phase(dev, smi)
    with phase("T serving_r152"):
        out["r152"] = r152_phase(dev, smi)
    with phase("U mask scratch steps"):
        out["scratch"] = scratch_phase(dev, smi)
    return out


# ------------------------------------------------ phases W, X, Y and Z

CONFIG_TRIDENT = os.path.join(REPO, "config", "tridentnet_r50v2c4_c5_1x.py")
CONFIG_C4 = os.path.join(REPO, "config", "faster_r50v1c4_c5_512roi_1x.py")
CONFIG_C4_BF16 = os.path.join(REPO, "config",
                              "faster_r50v1c4_c5_512roi_1x_fp16.py")
CONFIG_RPN_C4 = os.path.join(REPO, "config", "rpn_r50v2c4_1x.py")
CONFIG_CONVERGE_TRIDENT = "config/converge_trident.py"
CONVERGE_TRIDENT_EPOCHS = 120                   # 480 steps, the JAX record's
# experiments/chip/converge_trident/ (tests/test_converge_trident.py's
# docstring; first20 and last20 from its losses.jsonl, 480 steps)
JAX_CONVERGE_TRIDENT = dict(AP=0.711, AP50=0.995, AP75=0.912, first20=1.556,
                            last20=0.159, chip="one TPU chip")


def c4_kernels(dev, calls, path):
    """K1 with codes and K2 on a recorded C4 training step's one RoIAlign
    call (`roi_reading`: every roi of an image on its one stride-16 map,
    the busiest 4 x 4-cell tile's roi count) beside their bounds and plain
    versions; K3 on the step's proposal NMS calls (`nms_reading`)."""
    if len(calls["roi_align"]) != 1:
        raise AssertionError(f"{path}: {len(calls['roi_align'])} RoIAlign "
                             "calls a step")
    ((feats, rois, kw),) = calls["roi_align"]
    reading, (codes, g) = roi_reading(dev, feats, rois, kw,
                                      f"{path} RoIAlign",
                                      np.random.RandomState(9))
    k1, k2 = roi_bounds(feats, rois, kw, codes, g, reading)
    k2.update({k: reading[k] for k in ("busiest_tile_rois", "mean_tile_rois",
                                       "tiles_met", "shape")})
    k1["shape"] = reading["shape"]
    log(f"{path}: K1 with codes {k1['ms']:.4f} ms (plain "
        f"{k1['plain_ms']:.4f}, bound {k1['bound_ms']:.6f}, {k1['bound_by']});"
        f" K2 {k2['ms']:.4f} ms (plain {k2['plain_ms']:.4f}, bound "
        f"{k2['bound_ms']:.6f}, {k2['bound_by']}, busiest tile "
        f"{k2['busiest_tile_rois']} rois) on {list(feats[0].shape)} "
        f"{feats[0].dtype}")
    return dict(roi_align_fwd=k1, roi_align_bwd=k2,
                nms=nms_reading(calls, path))


def c4_phase(dev, smi, config, path, batch, full=True, prepare=None,
             inspect=None, lr_scale=1.0):
    """Phases W and X: a C4 config at full width (800 x 1333, `batch` images
    a request and a step, FrozenBN folded from one batch) served as phase 4
    serves (3 timed requests; detections against the plain-version path),
    with the peak memory of the timed requests, the kernels on one
    request's own inputs and, with `full`, the request's breakdown (trunk,
    trident stage, RPN head, proposals, RoIAlign, C5 head, decode and NMS)
    and the device's idle share; then trained as phase 5 trains (2 warm-up
    and 5 timed steps, the kernel step against the plain step) with the
    phase's peak memory, and with `full` the idle share of 3 traced steps
    and `c4_kernels` on one more recorded step. Phase AC: the same on the
    DCN configs, `prepare` (`perturb_offsets`) given to both models,
    `inspect` (`deform_reading`) to the request's and the step's, trained
    at `lr_scale` times the config's lr. Phases AJ-AL: the same on the
    PAFPN / FPG, dual-head and TSD configs (`inspect`: `neck_reading`,
    `tsd_pool_reading`)."""
    from simpledet_torch.infer import synthetic_batch

    global B
    saved, B = B, batch
    try:
        torch.cuda.empty_cache()
        stats, out = {}, {}
        counts, ms_img, det = serve(dev, smi, config, f"serving_{path}",
                                    fold=True, stats=stats, prepare=prepare)
        images, im_info = synthetic_batch(B, H, W, 1)
        images = images.to(dev)
        with recording() as calls:
            det.detect(images, im_info)
        torch.cuda.synchronize()
        out["serving"] = dict(counts=counts, ms_per_image=ms_img,
                              peak_gib=stats["peak_gib"],
                              kernels=check_serving_calls(
                                  calls, f"serving_{path}"))
        if full:
            out["serving"]["breakdown"] = request_breakdown(
                det, f"serving_{path}", images, im_info)
        if inspect is not None:
            out["serving"].update(inspect(det, (images, im_info)))
        del det, calls
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        counts, ms_step, split, extra = train(
            dev, smi, config, f"training_{path}", profile=full, record=full,
            prepare=prepare, inspect=inspect, lr_scale=lr_scale)
        calls = extra.pop("calls", None)
        out["training"] = dict(
            counts=counts, ms_per_step=ms_step, split_ms=split,
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30, **extra)
        log(f"training_{path}: peak {out['training']['peak_gib']:.2f} GiB "
            "allocated over the phase's steps (the plain steps included)")
        if calls is not None:
            out["kernels"] = c4_kernels(dev, calls, f"training_{path}")
    finally:
        B = saved
    return out


def c4_cli_phase(dev, smi):
    """Phase Y, in a fresh temporary directory removed afterwards: phase
    8's micro-COCO; detection_train on config/tridentnet_r50v2c4_c5_1x.py
    (batch 1, three branches) for CLI_TRAIN_ITERS iterations from a pretrain
    it writes, the checkpoint read back bit for bit; detection_test on it;
    then `simpledet_torch.rpn_test` on config/rpn_r50v2c4_1x.py (the RPN
    detector on ResNet-50 v2 C4, seeded weights: no checkpoint) over the 8
    images: a recall for each budget and K3 launched once an image."""
    import tempfile

    from simpledet_torch import rpn_test

    cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_c4_cli_")
    os.chdir(tmp)
    try:
        write_micro_coco()
        train_counts, checkpoint = train_cli(dev, smi, CONFIG_TRIDENT,
                                             "train_cli_trident")
        eval_counts, stats = eval_cli(dev, smi, checkpoint, CONFIG_TRIDENT,
                                      "eval_cli_trident")
        zero_counts()
        t0 = time.perf_counter()
        recalls = rpn_test.main(["--config", CONFIG_RPN_C4, "--device",
                                 str(dev)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rpn_counts = read_counts("rpn_test_c4", ("nms",))
        if rpn_counts["nms"] != N_CLI_IMAGES or set(recalls) != {
                100, 300, 1000} or not all(0 <= v <= 1
                                           for v in recalls.values()):
            raise AssertionError(f"rpn_test on {CONFIG_RPN_C4}: recalls "
                                 f"{recalls}, counts {rpn_counts}")
        log(f"rpn_test_c4: {N_CLI_IMAGES} images in {seconds:.1f} s on "
            f"{smi}; seeded weights, recall at IoU 0.5 "
            + json.dumps({str(k): float(v) for k, v in recalls.items()}))
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(train_cli_trident=train_counts,
                eval_cli_trident=eval_counts,
                rpn_test_c4=rpn_counts), stats, {
                    str(k): float(v) for k, v in recalls.items()}


def c4_phases(dev, smi):
    """Phases W, X and Y."""
    out = {}
    with phase("W trident"):
        out["trident"] = c4_phase(dev, smi, CONFIG_TRIDENT, "trident", 1)
    with phase("X faster_c4"):
        out["c4"] = c4_phase(dev, smi, CONFIG_C4, "c4", 2)
    with phase("X faster_c4_bf16"):
        out["c4_bf16"] = c4_phase(dev, smi, CONFIG_C4_BF16, "c4_bf16", 2,
                                  full=False)
    with phase("Y C4 CLIs"):
        out["cli"] = c4_cli_phase(dev, smi)
    return out


# ------------------------------------------ a learning run in a child process

def converge_cascade(dev, smi):
    """config/converge_cascade.py's learning run of phase H (`converge`)."""
    return converge(dev, smi, CONFIG_CONVERGE_CASCADE, "converge_cascade",
                    CONVERGE_CASCADE_EPOCHS, JAX_CONVERGE_CASCADE)


def converge_trident(dev, smi):
    """config/converge_trident.py's learning run of phase Z (`converge`)."""
    return converge(dev, smi, CONFIG_CONVERGE_TRIDENT, "converge_trident",
                    CONVERGE_TRIDENT_EPOCHS, JAX_CONVERGE_TRIDENT)


def converge_sepc(dev, smi):
    """config/converge_sepc.py's learning run of phase AE
    (`converge_dense`)."""
    return converge_dense(dev, smi, CONFIG_CONVERGE_SEPC, "converge_sepc",
                          CONVERGE_FAMILY_EPOCHS, JAX_CONVERGE_SEPC,
                          ap50=0.9, ratio=0.6)


def child_main(name, out):
    """`--converge-child name out`: the learning run `name` (a key of
    CHILD_RECIPES) on card 0 in the working directory and environment its
    parent set up, its result into the json file `out`; the kernels' builds
    are the parent's (in `build/`)."""
    from simpledet_torch.infer import card_name_and_power, full_fp32

    full_fp32()
    result = CHILD_RECIPES[name](torch.device("cuda", 0),
                                 card_name_and_power())
    with open(out, "w") as f:
        json.dump(result, f)


def start_child(name):
    """This script's `--converge-child name` in a process of its own, in the
    working directory and environment of now: (the process, its result
    file). Learning runs are bound by the host (a step of batch 8 at 128 x
    192 leaves the card mostly idle), so two or three of them side by side
    take little more than one."""
    out = os.path.abspath(f"{name}.child.json")
    proc = subprocess.Popen([sys.executable, os.path.join(REPO,
                                                          "chip_smoke.py"),
                             "--converge-child", name, out])
    return proc, out


def stop_child(child):
    """End the child's process if it still runs."""
    proc = child[0]
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def join_child(child, timeout=900):
    """The child's result (`converge_dense`'s, lists for tuples); raises
    if it failed. The process is ended in every case."""
    proc, out = child
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        stop_child(child)
    if rc != 0:
        raise AssertionError(f"child phase {out} exited {rc}")
    with open(out) as f:
        return json.load(f)


def side_by_side(parent, names):
    """parent() in this process while each learning run of `names` (keys of
    CHILD_RECIPES) runs in a child process, in the working directory and
    environment of now: (parent()'s result, {name: the child's result}).
    Raises, once every child has ended, if any failed."""
    children = {name: start_child(name) for name in names}
    try:
        result = parent()
    except BaseException:
        for child in children.values():
            stop_child(child)
        raise
    out, errors = {}, []
    for name, child in children.items():
        try:
            out[name] = tuple(join_child(child))
        except AssertionError as e:
            errors.append(str(e))
    if errors:
        raise AssertionError("; ".join(errors))
    return result, out


# ------------------------------------------- phases AA, AB, AC, AD and AE

CONFIG_SEPC = os.path.join(REPO, "config", "sepc",
                           "retina_r50v1b_fpn_sepc_1x.py")
CONFIG_NASFPN = os.path.join(REPO, "config", "NASFPN",
                             "retina_r50v1b_nasfpn_640_7@256_25epoch.py")
CONFIG_TDBU = os.path.join(REPO, "config", "NASFPN",
                           "retina_r50v1b_tdbu_640_3@384_25epoch.py")
CONFIG_DCNV2_C4 = os.path.join(REPO, "config", "dcn",
                               "faster_dcnv2_r50v1bc4_c5_512roi_1x.py")
CONFIG_DCN_FPN = os.path.join(REPO, "config", "dcn",
                              "faster_dcn_r50v1b_fpn_1x.py")
CONFIG_CONVERGE_NASFPN = "config/converge_nasfpn.py"
CONFIG_CONVERGE_SEPC = "config/converge_sepc.py"
CONVERGE_FAMILY_EPOCHS = 160            # 640 steps at batch 8, the records'
NAS_HW = (640, 640)                     # the NAS-FPN configs' fixed input
# phases AA-AC train at a tenth of the configs' lr: from seeded weights
# (FrozenBN folded from one batch) NAS-FPN's unnormalised merge cells
# diverged at the config's own lr (loss 4.5e9 at step 4, NaN at step 5, on
# an NVIDIA H100 80GB HBM3 at 700 W), so did the DCN FPN Faster R-CNN with
# its redrawn offset convs (NaN by step 6), and under SEPC's
# scale-invariant iBN the backbone's activations grow step by step
# (offsets of 1.7e31 cells after 12 steps) while its loss stays finite
FAMILY_LR_SCALE = 0.1
# the offset convs' kernels are redrawn N(0, OFFSET_SCALE^2 / fan_in): at
# the folded models' inputs, offsets of up to about two cells (and v2's
# masks in about [0.2, 0.8]); at twice this scale the DCN FPN Faster R-CNN
# diverged by step 7 even at a tenth of its lr (losses 1.9e6, then NaN),
# at this scale it trained 12 steps (an NVIDIA H100 80GB HBM3 at 700 W)
OFFSET_SCALE = 0.5
# the JAX package's records (experiments/chip/converge_{nasfpn,sepc}/:
# log.txt's summary, losses.jsonl's first and last 20 steps; 640 steps at
# batch 8)
JAX_CONVERGE_NASFPN = dict(AP=0.884, AP50=0.997, AP75=0.810, first20=1.5773,
                           last20=0.00469, chip="one TPU chip")
JAX_CONVERGE_SEPC = dict(AP=0.969, AP50=0.977, AP75=0.977, first20=1.2180,
                         last20=0.00147, chip="one TPU chip")


def perturb_offsets(seed=0):
    """A `prepare` hook for serve / train: every deformable conv's offset
    conv redrawn on the card, its kernel N(0, OFFSET_SCALE^2 / fan_in), its
    bias N(0, 0.25). With Flax's zero init the offsets are 0 and v2's masks
    0.5: each deformable conv would be a plain one (v2's at half scale), and
    nothing of the sampling would run."""
    import math

    from simpledet_torch.models.dcn import DeformConv

    def prepare(model):
        dev = next(model.parameters()).device
        gen = torch.Generator(device=dev).manual_seed(seed)
        convs = [m for m in model.modules() if isinstance(m, DeformConv)]
        if not convs:
            raise AssertionError("no deformable conv to perturb")
        with torch.no_grad():
            for m in convs:
                w = m.offset_conv.weight
                w.normal_(0.0, OFFSET_SCALE / math.sqrt(w[0].numel()),
                          generator=gen)
                m.offset_conv.bias.normal_(0.0, 0.5, generator=gen)
    return prepare


def offset_ranges(model, run, path):
    """What the deformable convs sample with in `run()`: the offsets' range,
    the share of taps outside the map (sampled as zeros), v2's mask range,
    over every call. Fails unless the offsets reach past a cell and some
    taps leave the map (the sampling, each corner's zero padding, runs)."""
    from simpledet_torch.models.dcn import DeformConv

    seen, handles = [], []

    def hook(mod, args, out):
        x = args[0]
        with torch.no_grad():
            off, mask = mod.offsets(x)
            b, _, oh, ow = off.shape
            h, w = x.shape[2:]
            o = off.view(b, mod.num_group, 9, 2, oh, ow)
            taps = torch.arange(3, device=x.device) * mod.dilation
            ys = (torch.arange(oh, device=x.device) * mod.stride
                  - mod.dilation)
            xs = (torch.arange(ow, device=x.device) * mod.stride
                  - mod.dilation)
            y = (ys.view(1, 1, 1, oh, 1) + taps.repeat_interleave(3).view(
                1, 1, 9, 1, 1) + o[:, :, :, 0])
            xx = (xs.view(1, 1, 1, 1, ow) + taps.repeat(3).view(
                1, 1, 9, 1, 1) + o[:, :, :, 1])
            outside = (y <= -1) | (y >= h) | (xx <= -1) | (xx >= w)
            seen.append((float(off.min()), float(off.max()),
                         float(outside.float().mean()),
                         None if mask is None else (float(mask.min()),
                                                    float(mask.max()))))

    for m in model.modules():
        if isinstance(m, DeformConv):
            handles.append(m.register_forward_hook(hook))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    masks = [s[3] for s in seen if s[3] is not None]
    out = dict(calls=len(seen), offset_min=min(s[0] for s in seen),
               offset_max=max(s[1] for s in seen),
               outside_share=float(np.mean([s[2] for s in seen])),
               mask_range=[min(m[0] for m in masks),
                           max(m[1] for m in masks)] if masks else None)
    log(f"{path}: {out['calls']} deformable conv calls, offsets in "
        f"[{out['offset_min']:.3f}, {out['offset_max']:.3f}] cells, "
        f"{out['outside_share']:.2%} of the taps wholly outside the map"
        + (f", masks in [{out['mask_range'][0]:.3f}, "
           f"{out['mask_range'][1]:.3f}]" if masks else ""))
    if max(-out["offset_min"], out["offset_max"]) < 1.0 \
            or out["outside_share"] <= 0:
        raise AssertionError(f"{path}: the offsets do not exercise the "
                             "sampling")
    return out


def deform_timing(model, run, backward):
    """The deformable convs of one `run()` timed on the inputs they got
    there (CUDA events, summed over the calls): each DeformConv's forward
    (offset conv, sampling, product) and, with `backward`, its forward and
    backward (the gradients of its input and parameters). Returns
    (calls, ms)."""
    from simpledet_torch.models.dcn import DeformConv

    calls, handles = [], []
    for m in model.modules():
        if isinstance(m, DeformConv):
            handles.append(m.register_forward_hook(
                lambda mod, args, out: calls.append(
                    (mod, args[0].detach(), out.shape))))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    grads = [torch.ones(shape, device=x.device) for _, x, shape in calls]

    def fwd():
        with torch.no_grad():
            for mod, x, _ in calls:
                mod(x)

    def fwd_bwd():
        for (mod, x, _), g in zip(calls, grads):
            xx = x.requires_grad_()
            torch.autograd.grad(mod(xx), [xx] + [
                p for p in mod.parameters() if p.requires_grad], g)

    return len(calls), cuda_ms(fwd_bwd if backward else fwd, 3, 1)


def deform_reading(path):
    """An `inspect` hook for serve_dense / c4_phase (a request: (det,
    (images, im_info))) and train_dense / train (a step: (trainer, batch),
    read on a train forward without update): the offsets' ranges
    (`offset_ranges`) and the deformable convs' time (`deform_timing`),
    forward for a request, forward and backward for a step."""
    def inspect(obj, batch):
        if hasattr(obj, "detect"):
            images, im_info = batch
            run = lambda: obj.detect(images, im_info)   # noqa: E731
            model, kind, backward = obj.model, "serving", False
        else:
            def run():                  # a train forward, no update
                data, info = obj._inputs(*batch[:2])
                gt = torch.as_tensor(batch[2], dtype=torch.float32).to(dev)
                with torch.no_grad():
                    obj.model(data, info, gt, mode="train",
                              generator=obj.generator)
            model, kind, backward = obj.model, "training", True
            dev = obj.device
        out = {"offsets": offset_ranges(model, run, f"{kind}_{path}")}
        n, ms = deform_timing(model, run, backward)
        out["deform_conv"] = dict(calls=n, ms=ms, backward=backward)
        log(f"{kind}_{path}: the {n} deformable convs of a "
            f"{'step' if backward else 'request'} take {ms:.3f} ms "
            f"({'forward and backward' if backward else 'forward'}, timed "
            "alone on their own inputs)")
        return out
    return inspect


def with_shape(hw, fn, *args, **kw):
    """fn(*args, **kw) at the global H, W = hw, restored after."""
    global H, W
    saved = H, W
    H, W = hw
    try:
        return fn(*args, **kw)
    finally:
        H, W = saved


def family_cli_phase(dev, smi):
    """Phase AD, in a fresh temporary directory removed afterwards: phase
    8's micro-COCO; detection_train on config/sepc/retina_r50v1b_fpn_sepc_1x.py
    for CLI_TRAIN_ITERS iterations from a pretrain it writes (the
    checkpoint read back bit for bit, its `.params` holding the deformable
    convs' `dconv` leaves); detection_test on it."""
    import tempfile

    from simpledet_torch.core import checkpoint as ckpt

    cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sepc_cli_")
    os.chdir(tmp)
    try:
        write_micro_coco()
        train_counts, checkpoint = train_cli(dev, smi, CONFIG_SEPC,
                                             "train_cli_sepc", required=())
        dconv = ["/".join(k) for k in ckpt.flatten(
            ckpt.read_params(checkpoint)) if "dconv" in k]
        if not dconv:
            raise AssertionError(f"{checkpoint} holds no dconv leaf")
        log(f"train_cli_sepc: {len(dconv)} dconv leaves in {checkpoint}, "
            f"e.g. {dconv[0]}")
        eval_counts, stats = eval_cli(dev, smi, checkpoint, CONFIG_SEPC,
                                      "eval_cli_sepc", required=("nms",))
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(train_cli_sepc=train_counts, eval_cli_sepc=eval_counts), stats


def family_phases(dev, smi):
    """Phases AA-AD: the deformable convolution, NAS-FPN / TDBU and SEPC
    (AE's learning runs: `learning_phase`)."""
    out = {}
    with phase("AA sepc"):
        prepare = perturb_offsets()
        out["sepc"] = dict(
            serving=serve_dense(dev, smi, CONFIG_SEPC, "serving_sepc",
                                prepare, deform_reading("sepc")),
            training=train_dense(dev, smi, CONFIG_SEPC, "training_sepc",
                                 prepare, deform_reading("sepc"),
                                 FAMILY_LR_SCALE))
    with phase("AB nasfpn and tdbu"):
        out["nasfpn"] = dict(
            serving=with_shape(NAS_HW, serve_dense, dev, smi, CONFIG_NASFPN,
                               "serving_nasfpn"),
            training=with_shape(NAS_HW, train_dense, dev, smi,
                                CONFIG_NASFPN, "training_nasfpn",
                                lr_scale=FAMILY_LR_SCALE))
        out["tdbu"] = dict(serving=with_shape(
            NAS_HW, serve_dense, dev, smi, CONFIG_TDBU, "serving_tdbu"))
    with phase("AC dcnv2_c4"):
        out["dcnv2_c4"] = c4_phase(dev, smi, CONFIG_DCNV2_C4, "dcnv2_c4", 2,
                                   prepare=perturb_offsets(),
                                   inspect=deform_reading("dcnv2_c4"),
                                   lr_scale=FAMILY_LR_SCALE)
    with phase("AC dcn_fpn"):
        out["dcn_fpn"] = c4_phase(dev, smi, CONFIG_DCN_FPN, "dcn_fpn", 2,
                                  prepare=perturb_offsets(),
                                  inspect=deform_reading("dcn_fpn"),
                                  lr_scale=FAMILY_LR_SCALE)
    with phase("AD sepc CLIs"):
        out["cli"] = family_cli_phase(dev, smi)
    return out


# ------------------------------------------- phases AF, AG, AH and AI

CONFIG_FCOS = os.path.join(REPO, "config", "fcos_r50v1_fpn_1x.py")
CONFIG_REPPOINTS = os.path.join(REPO, "config", "RepPoints",
                                "reppoints_moment_r50v1_fpn_1x.py")
CONFIG_REPPOINTS_DCN = os.path.join(
    REPO, "config", "RepPoints",
    "reppoints_moment_dcn_r101v1b_fpn_multiscale_2x.py")
CONFIG_FREEANCHOR = os.path.join(REPO, "config", "FreeAnchor",
                                 "free_anchor_r50v1_fpn_1x.py")
# the JAX package's records of its recipes at batch 8 on one TPU chip:
# converge_fcos's in tests/test_converge_fcos.py's docstring (480 steps, no
# losses kept), the others' in experiments/chip/converge_{reppoints,
# freeanchor}/ (640 steps: log.txt's summary, losses.jsonl's first and last
# 20 steps)
JAX_CONVERGE_FCOS = dict(AP=0.857, AP50=1.000, AP75=None, first20=None,
                         last20=None, chip="one TPU chip")
JAX_CONVERGE_REPPOINTS = dict(AP=0.934, AP50=1.000, AP75=1.000,
                              first20=3.6457, last20=0.05342,
                              chip="one TPU chip")
JAX_CONVERGE_FREEANCHOR = dict(AP=0.958, AP50=1.000, AP75=1.000,
                               first20=3.8289, last20=0.06373,
                               chip="one TPU chip")
# name -> (config, env prefix, epochs of 4 steps at batch 8, JAX record,
# AP50 gate, loss ratio gate): the gates of the JAX package's
# tests/test_converge_{fcos,reppoints,freeanchor}.py
DENSE_RECIPES = {
    "converge_fcos": ("config/converge_fcos.py", "CONVERGE_FCOS", 120,
                      JAX_CONVERGE_FCOS, 0.95, 0.5),
    "converge_reppoints": ("config/converge_reppoints.py",
                           "CONVERGE_REPPOINTS", 160, JAX_CONVERGE_REPPOINTS,
                           0.9, 0.6),
    "converge_freeanchor": ("config/converge_freeanchor.py",
                            "CONVERGE_FREEANCHOR", 160,
                            JAX_CONVERGE_FREEANCHOR, 0.9, 0.6),
}


def dense_recipe(name):
    """A learning run of DENSE_RECIPES through `converge_dense`."""
    config, _, epochs, record, ap50, ratio = DENSE_RECIPES[name]

    def run(dev, smi):
        return converge_dense(dev, smi, config, name, epochs, record,
                              ap50=ap50, ratio=ratio)
    return run


# the learning runs a child process runs (`--converge-child name out`)
CHILD_RECIPES = {"converge_sepc": converge_sepc,
                 "converge_cascade": converge_cascade,
                 "converge_trident": converge_trident,
                 "converge_mask_v1d": converge_v1d_phase,
                 **{name: dense_recipe(name) for name in DENSE_RECIPES}}


def dense_cli_phase(dev, smi):
    """Phase AI, CLIs, in a fresh temporary directory removed afterwards:
    phase 8's micro-COCO; detection_train on
    config/RepPoints/reppoints_moment_r50v1_fpn_1x.py for CLI_TRAIN_ITERS
    iterations from a pretrain it writes (the checkpoint read back bit for
    bit, its `.params` holding the deformable kernels and the moment
    transfer); detection_test on it (K3 once an eval batch)."""
    import tempfile

    from simpledet_torch.core import checkpoint as ckpt

    cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_reppoints_cli_")
    os.chdir(tmp)
    try:
        write_micro_coco()
        train_counts, checkpoint = train_cli(dev, smi, CONFIG_REPPOINTS,
                                             "train_cli_reppoints",
                                             required=())
        leaves = {"/".join(k) for k in ckpt.flatten(
            ckpt.read_params(checkpoint))}
        want = {"head_module/cls_conv_kernel",
                "head_module/pts_refine_conv_kernel", "moment_transfer"}
        if not want <= leaves:
            raise AssertionError(f"{checkpoint} lacks {want - leaves}")
        log(f"train_cli_reppoints: {checkpoint} holds {sorted(want)}")
        eval_counts, stats = eval_cli(dev, smi, checkpoint, CONFIG_REPPOINTS,
                                      "eval_cli_reppoints",
                                      required=("nms",))
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(train_cli_reppoints=train_counts,
                eval_cli_reppoints=eval_counts), stats


def learning_phase(dev, smi):
    """The learning runs of phases AE and AI side by side, in a fresh
    temporary directory removed afterwards, on phase C's 16 micro images
    and their flips: config/converge_nasfpn.py in this process,
    config/converge_sepc.py, converge_fcos, converge_reppoints and
    converge_freeanchor each in a child process (depth-18 FPN, SyncBN,
    64-wide heads; 640 steps each but converge_fcos's 480), from scratch at
    batch 8 through the train CLI, then the test CLI on the train set: the
    gates of the JAX package's tests/test_converge_{nasfpn,sepc,fcos,
    reppoints,freeanchor}.py beside its records. Returns {name: (launch
    counts, the K3 reading, the result)}."""
    import tempfile

    from simpledet_torch.data.synthetic import make_micro_dataset

    recipes = {"converge_nasfpn": (CONFIG_CONVERGE_NASFPN, "CONVERGE_NASFPN",
                                   CONVERGE_FAMILY_EPOCHS),
               "converge_sepc": (CONFIG_CONVERGE_SEPC, "CONVERGE_SEPC",
                                 CONVERGE_FAMILY_EPOCHS),
               **{k: v[:3] for k, v in DENSE_RECIPES.items()}}
    cwd, saved = os.getcwd(), dict(os.environ)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_learning_")
    out = {}
    try:
        os.makedirs(os.path.join(tmp, "config"))
        for config, prefix, epochs in recipes.values():
            shutil.copyfile(os.path.join(REPO, config),
                            os.path.join(tmp, config))
            os.environ[f"{prefix}_BATCH"] = "8"
            os.environ[f"{prefix}_EPOCHS"] = str(epochs)
        make_micro_dataset(os.path.join(tmp, "converge"), n_images=16,
                           set_names=("converge_train",))
        os.environ.update(CONVERGE_DATA_ROOT=os.path.join(tmp, "converge"))
        os.chdir(tmp)
        with phase("AE and AI learning runs, side by side: "
                   + ", ".join(recipes)):
            out["converge_nasfpn"], children = side_by_side(
                lambda: converge_dense(
                    dev, smi, CONFIG_CONVERGE_NASFPN, "converge_nasfpn",
                    CONVERGE_FAMILY_EPOCHS, JAX_CONVERGE_NASFPN, ap50=0.9,
                    ratio=0.6),
                [name for name in recipes if name != "converge_nasfpn"])
            out.update(children)
    finally:
        os.chdir(cwd)
        os.environ.clear()
        os.environ.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def dense_phases(dev, smi):
    """Phases AF-AI: FCOS, RepPoints (and its DCN R101 served) and
    FreeAnchor at full width (serving 3 requests of 2 images, 2 + 5
    training steps, the focal terms against their float64 definitions, K3
    on each model's own per-class NMS), then the RepPoints CLIs (AI's
    learning runs: `learning_phase`)."""
    out = {}
    with phase("AF fcos"):
        out["fcos"] = dict(
            serving=serve_dense(dev, smi, CONFIG_FCOS, "serving_fcos"),
            training=train_dense(dev, smi, CONFIG_FCOS, "training_fcos"))
    with phase("AG reppoints"):
        out["reppoints"] = dict(
            serving=serve_dense(dev, smi, CONFIG_REPPOINTS,
                                "serving_reppoints"),
            training=train_dense(dev, smi, CONFIG_REPPOINTS,
                                 "training_reppoints"))
        out["reppoints_dcn"] = dict(serving=serve_dense(
            dev, smi, CONFIG_REPPOINTS_DCN, "serving_reppoints_dcn",
            perturb_offsets(), deform_reading("reppoints_dcn")))
    with phase("AH freeanchor"):
        out["freeanchor"] = dict(
            serving=serve_dense(dev, smi, CONFIG_FREEANCHOR,
                                "serving_freeanchor"),
            training=train_dense(dev, smi, CONFIG_FREEANCHOR,
                                 "training_freeanchor"))
    with phase("AI reppoints CLIs"):
        out["cli"] = dense_cli_phase(dev, smi)
    return out


# ------------------------------------------- phases AJ, AK, AL, AM and AN

CONFIG_FPG = os.path.join(REPO, "config", "FPG",
                          "faster_r50v1b_fpg6_256_syncbn_1x.py")
CONFIG_PAFPN = os.path.join(REPO, "config", "FPG",
                            "faster_r50v1b_pafpn3_384_syncbn_1x.py")
CONFIG_DUALHEAD = os.path.join(V1B, "faster_r50v1b_fpn_dualheadsmall_1x.py")
CONFIG_TSD = os.path.join(REPO, "config", "TSD", "tsd_r50v1_fpn_1x.py")
CONFIG_MSRCNN = os.path.join(REPO, "config", "ms_r50v1_fpn_1x.py")
CONFIG_CONVERGE_TSD = "config/converge_tsd.py"
CONFIG_CONVERGE_MSRCNN = "config/converge_msrcnn.py"
CONVERGE_RCNN_EPOCHS = 120              # 480 steps at batch 8, the records'
# phase AJ trains the FPG config at FAMILY_LR_SCALE of its lr: its seeded,
# unnormalised grid of 6 stages gives a pyramid 10x the FPN's (std 10-34
# against 1.4-3.5 at 128 x 192 on the CPU), and at the config's own lr a
# 256 x 384 step on the CPU went NaN by step 4 (finite at a tenth)
FPG_LR_SCALE = FAMILY_LR_SCALE
# the JAX package's records (experiments/chip/converge_{tsd,msrcnn}/:
# log.txt's summaries, losses.jsonl's first and last 20 steps; 480 steps at
# batch 8, lr 0.005)
JAX_CONVERGE_TSD = dict(AP=0.968, AP50=1.000, AP75=1.000, first20=2.3221,
                        last20=0.2936, chip="one TPU chip")
JAX_CONVERGE_MSRCNN = dict(bbox_AP=0.961, segm_AP=0.940, segm_AP75=1.000,
                           first20=2.80, last20=0.08, chip="one TPU chip",
                           lr="0.005")
# the lr that phase AN trains converge_msrcnn at (its recipe's own)
CONVERGE_MSRCNN_LR = "0.005"


def neck_reading(path):
    """An `inspect` hook for c4_phase / train on a PAFPN or FPG Faster
    R-CNN: the neck timed alone on its own c2-c5 inputs (CUDA events) and
    the device memory it allocates beyond what was allocated before it;
    forward for a request, forward and backward (the gradients of its
    inputs and parameters) for a step."""
    def inspect(obj, batch):
        model = obj.model
        if hasattr(obj, "detect"):
            data, _ = obj._inputs(*batch)
            backward, kind = False, "serving"
        else:
            data, _ = obj._inputs(*batch[:2])
            backward, kind = True, "training"
        with torch.no_grad():
            feats = model.backbone(data.float().permute(0, 3, 1, 2))

        def fwd():
            with torch.no_grad():
                return model.neck(feats)

        def fwd_bwd():
            xs = {k: v.detach().requires_grad_() for k, v in feats.items()}
            out = model.neck(xs)
            params = [p for p in model.neck.parameters() if p.requires_grad]
            torch.autograd.grad(list(out.values()),
                                [xs[k] for k in sorted(xs)] + params,
                                [torch.ones_like(v) for v in out.values()],
                                allow_unused=True)

        run = fwd_bwd if backward else fwd
        ms = cuda_ms(run, 3, 1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        name = type(model.neck).__name__
        log(f"{kind}_{path}: the {name} ({model.neck.num_stage} stages, "
            f"{model.neck.S0_P3.out_channels} wide) alone on its own inputs "
            f"{ms:.3f} ms ({'forward and backward' if backward else 'forward'})"
            f", {peak:.2f} GiB above the allocation before it")
        return {"neck": dict(ms=ms, peak_gib=peak, backward=backward)}
    return inspect


def tsd_pool_reading(obj, batch):
    """An `inspect` hook for c4_phase / train on TSD: the two deformable
    pools (plain PyTorch, `ops/deform_roi_align.py`) of a request or of a
    step (a train forward without update), recorded on their own inputs
    and each timed alone (CUDA events; a step's: forward and backward, the
    gradients of the features, the rois and the offsets), with the device
    memory each allocates beyond what was allocated before it, and the
    offsets' range in bins."""
    from simpledet_torch.ops.deform_roi_align import deformable_roi_align

    model = obj.model
    calls = []
    real = model.extract_deform

    def recorded(pyr, rois, bin_offset):
        calls.append(({k: v.detach() for k, v in pyr.items()}, rois.detach(),
                      bin_offset.detach()))
        return real(pyr, rois, bin_offset)

    if hasattr(obj, "detect"):
        backward, kind = False, "serving"

        def run():
            obj.detect(*batch)
    else:
        backward, kind = True, "training"

        def run():
            data, info = obj._inputs(*batch[:2])
            gt = torch.as_tensor(batch[2], dtype=torch.float32).to(obj.device)
            with torch.no_grad():
                obj.model(data, info, gt, mode="train",
                          generator=obj.generator)
    model.extract_deform = recorded
    try:
        run()
        torch.cuda.synchronize()
    finally:
        del model.extract_deform
    if len(calls) != 2:
        raise AssertionError(f"{kind}_tsd: {len(calls)} deformable pools")
    p_roi = model.p_roi
    strides = tuple(p_roi.stride)
    kw = dict(out_size=p_roi.out_size,
              canonical_scale=p_roi.roi_canonical_scale or 224,
              canonical_level=p_roi.roi_canonical_level or 4)
    out = []
    for (pyr, rois, off), name in zip(calls, ("delta_c", "delta_r")):
        feats = [pyr[f"stride{st}"].permute(0, 2, 3, 1).contiguous()
                 for st in strides]

        def fwd():
            with torch.no_grad():
                return deformable_roi_align(feats, rois, off, strides, **kw)

        def fwd_bwd():
            xs = [f.detach().requires_grad_() for f in feats]
            r, o = rois.clone().requires_grad_(), off.clone().requires_grad_()
            y = deformable_roi_align(xs, r, o, strides, **kw)
            torch.autograd.grad(y, xs + [r, o], torch.ones_like(y))

        run_one = fwd_bwd if backward else fwd
        ms = cuda_ms(run_one, 3, 1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run_one()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        reach = float(off.abs().max()) * 0.1 * p_roi.out_size
        out.append(dict(offsets=name, rois=list(rois.shape), ms=ms,
                        peak_gib=peak, offset_reach_bins=reach))
        log(f"{kind}_tsd: the {name} pool on {list(rois.shape[:2])} rois, "
            f"{list(feats[0].shape)} at stride {strides[0]}: {ms:.3f} ms "
            f"({'forward and backward' if backward else 'forward'}, alone), "
            f"{peak:.2f} GiB above the allocation before it; its offsets "
            f"move samples up to {reach:.3f} bins")
    return {"tsd_pools": out}


def tsd_cli_phase(dev, smi):
    """Phase AL's CLIs, in a fresh temporary directory removed afterwards:
    phase 8's micro-COCO; detection_train on config/TSD/tsd_r50v1_fpn_1x.py
    for CLI_TRAIN_ITERS iterations from a pretrain it writes (the
    checkpoint read back bit for bit, its `.params` holding the TSD head's
    offset predictors); detection_test on it."""
    import tempfile

    from simpledet_torch.core import checkpoint as ckpt

    cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tsd_cli_")
    os.chdir(tmp)
    try:
        write_micro_coco()
        train_counts, checkpoint = train_cli(dev, smi, CONFIG_TSD,
                                             "train_cli_tsd")
        leaves = {"/".join(k) for k in ckpt.flatten(
            ckpt.read_params(checkpoint))}
        want = {f"bbox_head/{m}/kernel" for m in (
            "delta_c_fc2", "delta_r_fc2", "TSD_pc_fc0", "TSD_pr_fc0")}
        if not want <= leaves:
            raise AssertionError(f"{checkpoint} lacks {want - leaves}")
        eval_counts, stats = eval_cli(dev, smi, checkpoint, CONFIG_TSD,
                                      "eval_cli_tsd")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(train_cli_tsd=train_counts, eval_cli_tsd=eval_counts), stats


def msrcnn_phase(dev, smi, bwd_sets):
    """Phase AM: config/ms_r50v1_fpn_1x.py at full width, FrozenBN folded:
    served as phase I serves (2 RoIAlign launches a request, at 7 x 7 and
    at 14 x 14 on the kept boxes, whose features the mask head and the
    MaskIoU head take; detections and mask_prob against the plain-version
    path), mask_score of a score_thr=0 request finite;
    the request's breakdown; trained as phase J trains (maskiou_loss in
    every step), and K1 and K2 at 7 x 7 and 14 x 14 on one more step's own
    inputs against their plain versions (`mask_roi_kernels`)."""
    from simpledet_torch.infer import synthetic_batch

    torch.cuda.empty_cache()
    counts, ms_img, sizes, kernels, breakdown = serve_mask(
        dev, smi, CONFIG_MSRCNN, "serving_msrcnn", fold=True, breakdown=True)
    out = {"serving": dict(counts=counts, ms_per_image=ms_img,
                           kernels=kernels, breakdown=breakdown)}
    from simpledet_torch.core.train import fold_detector_stats
    from simpledet_torch.infer import Detector

    det = Detector(CONFIG_MSRCNN, device=dev, seed=0)
    data, info = det._inputs(*synthetic_batch(B, H, W, 1))
    with torch.no_grad():
        fold_detector_stats(det.model, data.float(), info)
        test = det.model(data.float(), info, mode="test", score_thr=0.0)
    score, valid = test["mask_score"], test["det_valid"]
    if score.shape != valid.shape or not torch.isfinite(score).all() or \
            not valid.any():
        raise AssertionError(f"serving_msrcnn: mask_score {score.shape}, "
                             f"finite {bool(torch.isfinite(score).all())}")
    log(f"serving_msrcnn: mask_score of {int(valid.sum())} kept boxes in "
        f"[{float(score[valid].min()):.4f}, {float(score[valid].max()):.4f}] "
        "(score x predicted IoU at seeded weights)")
    del det, test
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    counts, ms_step, split, extra = train(
        dev, smi, CONFIG_MSRCNN, "training_msrcnn", profile=True, record=True)
    calls = extra.pop("calls")
    log(f"training_msrcnn: one step's kernel calls {by_size(calls)}")
    out["training"] = dict(counts=counts, ms_per_step=ms_step,
                           split_ms=split,
                           peak_gib=torch.cuda.max_memory_allocated(dev)
                           / 2 ** 30, **extra)
    readings, k1, k2 = mask_roi_kernels(dev, calls, bwd_sets,
                                        "training_msrcnn")
    out["roi"] = dict(readings=readings, k1_14=k1, k2_14=k2)
    return out


def _recipe_workdir(name, config, prefix, shapes, extra_env=()):
    """A learning run of phase AN in a fresh temporary directory: the
    config copied there, 16 micro images (`shapes`) at CONVERGE_DATA_ROOT,
    the recipe's env at batch 8 for CONVERGE_RCNN_EPOCHS epochs. Returns
    (the directory, the working directory and the environment before it)
    for `_leave_workdir`."""
    import tempfile

    from simpledet_torch.data.synthetic import make_micro_dataset

    cwd, saved = os.getcwd(), dict(os.environ)
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    os.chdir(tmp)
    os.makedirs("config")
    shutil.copyfile(os.path.join(REPO, config), config)
    make_micro_dataset(os.path.join(tmp, "data"), n_images=16,
                       set_names=("converge_train",), shapes=shapes)
    os.environ.update({"CONVERGE_DATA_ROOT": os.path.join(tmp, "data"),
                       prefix + "_BATCH": "8",
                       prefix + "_EPOCHS": str(CONVERGE_RCNN_EPOCHS),
                       **dict(extra_env)})
    return tmp, cwd, saved


def _leave_workdir(tmp, cwd, saved):
    os.chdir(cwd)
    os.environ.clear()
    os.environ.update(saved)
    shutil.rmtree(tmp, ignore_errors=True)


def converge_tsd(dev, smi):
    """Phase AN: config/converge_tsd.py (depth-18 FPN, SyncBN, the TSD head)
    from scratch on 16 rectangle micro images at batch 8 for 480 steps
    through the train CLI, the kernels at its shapes, the test CLI on the
    train set: the gates of tests/test_converge_tsd.py (`converge`), beside
    the JAX record."""
    where = _recipe_workdir("converge_tsd", CONFIG_CONVERGE_TSD,
                            "CONVERGE_TSD", "rect")
    try:
        return converge(dev, smi, CONFIG_CONVERGE_TSD, "converge_tsd",
                        CONVERGE_RCNN_EPOCHS, JAX_CONVERGE_TSD, ratio=0.6,
                        ap50=0.9)
    finally:
        _leave_workdir(*where)


def converge_msrcnn(dev, smi):
    """Phase AN: config/converge_msrcnn.py (depth-18 FPN, SyncBN, the mask
    branch and the MaskIoU head) from scratch on 16 ellipse micro images at
    batch 8 and lr CONVERGE_MSRCNN_LR for 480 steps through the train CLI,
    then simpledet_torch.mask_test: the gates of
    tests/test_converge_msrcnn.py (`converge_mask`), beside the JAX
    record."""
    where = _recipe_workdir("converge_msrcnn", CONFIG_CONVERGE_MSRCNN,
                            "CONVERGE_MSRCNN", "ellipse",
                            {"CONVERGE_MSRCNN_LR": CONVERGE_MSRCNN_LR})
    try:
        return converge_mask(dev, smi, None, CONFIG_CONVERGE_MSRCNN,
                             "converge_msrcnn", JAX_CONVERGE_MSRCNN,
                             prefix="CONVERGE_MSRCNN", segm_ap50=None)
    finally:
        _leave_workdir(*where)


CHILD_RECIPES.update(converge_tsd=converge_tsd,
                     converge_msrcnn=converge_msrcnn)


def rcnn_variant_phases(dev, smi, bwd_sets):
    """Phases AJ-AM: the two-stage FPN variants at full width (800 x 1333,
    batch 2, fp32 without TF32, seeded weights, FrozenBN folded), each
    served and trained as phase X serves and trains (`c4_phase`: 3 timed
    requests, detections against the plain-version path, the kernels on a
    request's and a step's own inputs, the breakdown, the idle share, peak
    memory, the kernel step against the plain step), then the TSD and MS
    R-CNN CLIs (AN's learning runs: `syncbn_phases`)."""
    out = {}
    with phase("AJ fpg and pafpn"):
        out["fpg"] = c4_phase(dev, smi, CONFIG_FPG, "fpg", 2,
                              inspect=neck_reading("fpg"),
                              lr_scale=FPG_LR_SCALE)
        out["pafpn"] = c4_phase(dev, smi, CONFIG_PAFPN, "pafpn", 2,
                                inspect=neck_reading("pafpn"))
    with phase("AK dualhead"):
        out["dualhead"] = c4_phase(dev, smi, CONFIG_DUALHEAD, "dualhead", 2)
    with phase("AL tsd"):
        out["tsd"] = c4_phase(dev, smi, CONFIG_TSD, "tsd", 2,
                              inspect=tsd_pool_reading)
    with phase("AL tsd CLIs"):
        out["tsd_cli"] = tsd_cli_phase(dev, smi)
    with phase("AM msrcnn"):
        out["msrcnn"] = msrcnn_phase(dev, smi, bwd_sets)
    with phase("AM msrcnn CLIs"):
        out["msrcnn_cli"] = mask_cli_phase(
            dev, smi, CONFIG_CONVERGE_MSRCNN, "CONVERGE_MSRCNN",
            ("train_cli_msrcnn", "mask_test_cli_msrcnn"))
    return out


def main():
    if sys.argv[1:2] == ["--train-cli-rank"]:
        return train_cli_rank(sys.argv[2])
    if sys.argv[1:2] == ["--converge-child"]:
        return child_main(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--scratch-rank"]:
        return scratch_rank(sys.argv[2])
    smi = environment()
    dev = torch.device("cuda", 0)
    from simpledet_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {', '.join(_build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")

    with phase("3 NMS and RoIAlign-forward kernels"):
        nms = check_nms(dev)
        roi = check_roi_align(dev)
    with phase("3b RoIAlign with codes and backward"):
        fwd_train, bwd = check_roi_align_train(dev)
        time_fwd_sets(dev)
        bwd_sets = time_bwd_sets(dev)
    paths = {}
    with phase("4 serving"):
        paths["serving"], ms_img, _ = serve(dev, smi)
    with phase("5 training"):
        paths["training"], ms_step, split, _ = train(dev, smi)
    with phase("6 serving_bf16"):
        paths["serving_bf16"], ms_img_bf16, _ = serve(
            dev, smi, CONFIG_BF16, "serving_bf16")
    with phase("7 training_bf16"):
        paths["training_bf16"], ms_step_bf16, split_bf16, _ = train(
            dev, smi, CONFIG_BF16, "training_bf16")
    with phase("8-9 train and eval CLIs"):
        paths["train_cli"], paths["eval_cli"], eval_stats = cli_phases(
            dev, smi)
    cascade = cascade_phases(dev, smi, bwd_sets)
    paths["serving_cascade"], ms_img_cascade, at_cascade_serving = \
        cascade["serving"]
    (paths["training_cascade"], ms_step_cascade, split_cascade,
     profile_cascade) = cascade["training"]
    k2_by_stage, k1_stage3, k2_stage3 = cascade["by_stage"]
    paths["serving_cascade_r101"], ms_img_r101, at_r101 = \
        cascade["serving_r101"]
    log(f"training_cascade: {ms_step_cascade:.3f} ms/step against the "
        f"flagship fp32 step of this call {ms_step:.3f} ms/step "
        f"({ms_step_cascade / ms_step:.2f}x); serving_cascade "
        f"{ms_img_cascade:.3f} ms/image against {ms_img:.3f} "
        f"({ms_img_cascade / ms_img:.2f}x), serving_cascade_r101 "
        f"{ms_img_r101:.3f} ms/image; on {smi}")
    mask = mask_phases(dev, smi, bwd_sets)
    (paths["serving_mask"], ms_img_mask, mask_request,
     at_mask_serving) = mask["serving"]
    (paths["training_mask"], ms_step_mask, split_mask,
     profile_mask) = mask["training"]
    k2_mask_sizes, k1_mask14, k2_mask14 = mask["roi"]
    log(f"training_mask: {ms_step_mask:.3f} ms/step against the flagship "
        f"fp32 step of this call {ms_step:.3f} ms/step "
        f"({ms_step_mask / ms_step:.2f}x); serving_mask {ms_img_mask:.3f} "
        f"ms/image against {ms_img:.3f} ({ms_img_mask / ms_img:.2f}x); "
        f"on {smi}")
    with phase("K mask train and eval CLIs"):
        paths["train_cli_mask"], paths["mask_test_cli"], mask_eval_stats = \
            mask_cli_phase(dev, smi)
    retina = retina_phases(dev, smi)
    (paths["serving_retina"], ms_img_retina, at_retina_serving,
     retina_breakdown) = retina["serving"]
    paths["serving_retina_r101"], ms_img_retina_r101 = retina["serving_r101"]
    (paths["training_retina"], ms_step_retina, split_retina,
     profile_retina) = retina["training"]
    paths["retina_cli"], retina_eval_stats = retina["cli"]
    log(f"serving_retina: {ms_img_retina:.3f} ms/image against the "
        f"flagship's {ms_img:.3f} in this call "
        f"({ms_img_retina / ms_img:.2f}x), serving_retina_r101 "
        f"{ms_img_retina_r101:.3f}; training_retina {ms_step_retina:.3f} "
        f"ms/step against the flagship fp32 step of this call {ms_step:.3f} "
        f"({ms_step_retina / ms_step:.2f}x), idle "
        f"{profile_retina['device_idle_share']:.1%}; on {smi}")
    sync = syncbn_phases(dev, smi, bwd_sets)
    paths["training_syncbn"], ms_step_sync, split_sync, _ = \
        sync["training_syncbn"]
    paths["train_cli_syncbn"], paths["eval_cli_syncbn"] = sync["cli"]
    (paths["converge"], paths["converge_eval"], at_converge,
     converge_result) = sync["converge"]
    (paths["converge_cascade"], paths["converge_cascade_eval"],
     at_converge_cascade, converge_cascade_result) = sync["converge_cascade"]
    (paths["converge_mask"], paths["converge_mask_eval"], at_converge_mask,
     converge_mask_result) = sync["converge_mask"]
    paths["converge_retina"], at_converge_retina, converge_retina_result = \
        sync["converge_retina"]
    rpn_serving, rpn_training, rpn_recall = sync["rpn_only"]
    (paths["serving_rpn_only"], ms_img_rpn, at_rpn_serving,
     rpn_breakdown) = rpn_serving
    paths["training_rpn_only"], ms_step_rpn, split_rpn, profile_rpn = \
        rpn_training
    paths["rpn_test"], rpn_recalls = rpn_recall
    log(f"training_syncbn: {ms_step_sync:.3f} ms/step "
        f"({B * 1e3 / ms_step_sync:.2f} img/s) against the FrozenBN bf16 "
        f"step of this call {ms_step_bf16:.3f} ms/step "
        f"({B * 1e3 / ms_step_bf16:.2f} img/s), on {smi}")
    bb = backbone_phases(dev, smi)
    mask_v1b = bb["mask_v1b"]
    (paths["serving_mask_v1b"], ms_img_mask_v1b, _, at_mask_v1b_serving,
     mask_v1b_breakdown) = mask_v1b["serving"]
    (paths["training_mask_v1b"], ms_step_mask_v1b, split_mask_v1b,
     profile_mask_v1b) = mask_v1b["training"]
    k2_mask_v1b_sizes, k1_mask_v1b_14, k2_mask_v1b_14 = mask_v1b["roi"]
    (paths["serving_faster_v1d"], ms_img_v1d), (
        paths["training_faster_v1d"], ms_step_v1d, split_v1d, _) = \
        bb["faster_v1d"]
    for path, (counts, _, _) in list(bb["r152"].items()) + list(
            bb["scratch"].items()):
        paths[path] = counts
    (paths["converge_mask_v1d"], paths["converge_mask_v1d_eval"],
     at_converge_v1d, converge_v1d_result) = sync["converge_mask_v1d"]
    log(f"serving_mask_v1b: {ms_img_mask_v1b:.3f} ms/image, idle "
        f"{mask_v1b_breakdown['device_idle_share']:.1%} of a traced request;"
        f" training_mask_v1b {ms_step_mask_v1b:.3f} ms/step, idle "
        f"{profile_mask_v1b['device_idle_share']:.1%}; serving_faster_v1d "
        f"{ms_img_v1d:.3f} ms/image, training_faster_v1d {ms_step_v1d:.3f} "
        f"ms/step (at {H}x{V1D_W}); " + "; ".join(
            f"{p} {ms:.3f} ms/image, peak {peak:.2f} GiB"
            for p, (_, ms, peak) in bb["r152"].items()) + "; " + "; ".join(
            f"{p} one step {ms:.3f} ms" for p, (_, ms, _) in
            bb["scratch"].items())
        + f" -- beside the flagship of this call: serving {ms_img:.3f} "
        f"ms/image, training {ms_step:.3f} ms/step (fp32 without TF32); on "
        f"{smi}")

    c4 = c4_phases(dev, smi)
    for key in ("trident", "c4", "c4_bf16"):
        for kind in ("serving", "training"):
            paths[f"{kind}_{key}"] = c4[key][kind]["counts"]
    c4_cli_counts, trident_eval_stats, rpn_c4_recalls = c4["cli"]
    paths.update(c4_cli_counts)
    (paths["converge_trident"], paths["converge_trident_eval"],
     at_converge_trident, converge_trident_result) = sync["converge_trident"]
    c4_summary = {key: dict(
        serving_ms_per_image=c4[key]["serving"]["ms_per_image"],
        serving_peak_gib=c4[key]["serving"]["peak_gib"],
        training_ms_per_step=c4[key]["training"]["ms_per_step"],
        training_split_ms=c4[key]["training"]["split_ms"],
        training_peak_gib=c4[key]["training"]["peak_gib"],
        **({"serving_breakdown": c4[key]["serving"]["breakdown"],
            "training_idle_share":
                c4[key]["training"]["device_idle_share"]}
           if "breakdown" in c4[key]["serving"] else {}))
        for key in ("trident", "c4", "c4_bf16")}
    log("C4 and TridentNet against the flagship of this call (serving "
        f"{ms_img:.3f} ms/image, training {ms_step:.3f} ms/step at batch "
        f"{B}): " + "; ".join(
            f"{k} serving {v['serving_ms_per_image']:.3f} ms/image, training "
            f"{v['training_ms_per_step']:.3f} ms/step" for k, v in
            c4_summary.items()) + f"; on {smi}")

    def at_c4(kernel):
        """A kernel's readings on the C4 paths' own inputs."""
        out = {}
        for key in ("trident", "c4"):
            served = c4[key]["serving"]["kernels"]
            if kernel in served:
                out[f"{key}_serving"] = served[kernel]
            out[f"{key}_training"] = c4[key]["kernels"][kernel]
        out["converge_trident"] = at_converge_trident[kernel]
        return out

    fam = family_phases(dev, smi)
    dense = dense_phases(dev, smi)
    rv = rcnn_variant_phases(dev, smi, bwd_sets)
    learned = learning_phase(dev, smi)
    fam["converge"] = {k: learned[k] for k in ("converge_nasfpn",
                                               "converge_sepc")}
    dense["converge"] = {k: learned[k] for k in DENSE_RECIPES}
    for key in ("sepc", "nasfpn"):
        counts, ms_step_f, split_f, extra_f = fam[key]["training"]
        paths[f"training_{key}"] = counts
        fam[key]["training"] = dict(counts=counts, ms_per_step=ms_step_f,
                                    split_ms=split_f, **extra_f)
    for key in ("sepc", "nasfpn", "tdbu"):
        paths[f"serving_{key}"] = fam[key]["serving"]["counts"]
    for key in ("dcnv2_c4", "dcn_fpn"):
        for kind in ("serving", "training"):
            paths[f"{kind}_{key}"] = fam[key][kind]["counts"]
    fam_cli_counts, sepc_eval_stats = fam["cli"]
    paths.update(fam_cli_counts)
    for key, (counts, _, _) in fam["converge"].items():
        paths[key] = counts
    fam_summary = {}
    for key in ("sepc", "nasfpn", "tdbu", "dcnv2_c4", "dcn_fpn"):
        fam_summary[key] = {
            f"{kind}_{k}": v for kind in ("serving", "training")
            if kind in fam[key] for k, v in fam[key][kind].items()
            if k not in ("counts", "kernels", "nms")}
    log("DCN, NAS-FPN / TDBU and SEPC against the flagship of this call "
        f"(serving {ms_img:.3f} ms/image, training {ms_step:.3f} ms/step at "
        f"800 x 1333, batch 2): " + "; ".join(
            f"{k} serving {v['serving_ms_per_image']:.3f} ms/image"
            + (f", training {v['training_ms_per_step']:.3f} ms/step"
               if "training_ms_per_step" in v else "")
            for k, v in fam_summary.items())
        + f" (NAS-FPN and TDBU at {NAS_HW[0]} x {NAS_HW[1]}); on {smi}")

    def at_family(kernel):
        """A kernel's readings on the DCN / SEPC / NAS-FPN paths' own
        inputs."""
        out = {}
        for key in ("dcnv2_c4", "dcn_fpn"):
            served = fam[key]["serving"]["kernels"]
            if kernel in served:
                out[f"{key}_serving"] = served[kernel]
            out[f"{key}_training"] = fam[key]["kernels"][kernel]
        if kernel == "nms":
            for key in ("sepc", "nasfpn", "tdbu"):
                out[f"{key}_serving_score0"] = fam[key]["serving"]["nms"]
            for key, (_, at, _) in fam["converge"].items():
                out[key] = at
        return out

    dense_summary = {}
    for key in ("fcos", "reppoints", "reppoints_dcn", "freeanchor"):
        served = dense[key]["serving"]
        paths[f"serving_{key}"] = served["counts"]
        dense_summary[key] = {f"serving_{k}": v for k, v in served.items()
                              if k not in ("counts", "nms")}
        if "training" in dense[key]:
            counts, ms_step_d, split_d, extra_d = dense[key]["training"]
            paths[f"training_{key}"] = counts
            dense_summary[key].update(training_ms_per_step=ms_step_d,
                                      training_split_ms=split_d,
                                      **{f"training_{k}": v
                                         for k, v in extra_d.items()})
    dense_cli_counts, reppoints_eval_stats = dense["cli"]
    paths.update(dense_cli_counts)
    for key, (counts, _, _) in dense["converge"].items():
        paths[key] = counts
    log("FCOS, RepPoints and FreeAnchor against the flagship of this call "
        f"(serving {ms_img:.3f} ms/image, training {ms_step:.3f} ms/step at "
        "800 x 1333, batch 2): " + "; ".join(
            f"{k} serving {v['serving_ms_per_image']:.3f} ms/image"
            + (f", training {v['training_ms_per_step']:.3f} ms/step, peak "
               f"{v['training_peak_gib']:.2f} GiB"
               if "training_ms_per_step" in v else "")
            for k, v in dense_summary.items()) + f"; on {smi}")

    def at_dense(kernel):
        """K3's readings on the dense heads' own per-class NMS calls."""
        out = {f"{key}_serving_score0": dense[key]["serving"]["nms"]
               for key in ("fcos", "reppoints", "reppoints_dcn",
                           "freeanchor")}
        for key, (_, at, _) in dense["converge"].items():
            out[key] = at
        return out if kernel == "nms" else {}

    rv_summary = {}
    for key in ("fpg", "pafpn", "dualhead", "tsd", "msrcnn"):
        for kind in ("serving", "training"):
            paths[f"{kind}_{key}"] = rv[key][kind]["counts"]
        rv_summary[key] = {
            f"{kind}_{k}": v for kind in ("serving", "training")
            for k, v in rv[key][kind].items()
            if k not in ("counts", "kernels", "calls")}
    tsd_cli_counts, tsd_eval_stats = rv["tsd_cli"]
    paths.update(tsd_cli_counts)
    (paths["train_cli_msrcnn"], paths["mask_test_cli_msrcnn"],
     msrcnn_eval_stats) = rv["msrcnn_cli"]
    (paths["converge_tsd"], paths["converge_tsd_eval"], at_converge_tsd,
     converge_tsd_result) = sync["converge_tsd"]
    (paths["converge_msrcnn"], paths["converge_msrcnn_eval"],
     at_converge_msrcnn, converge_msrcnn_result) = sync["converge_msrcnn"]
    log("The two-stage FPN variants against the flagship of this call "
        f"(serving {ms_img:.3f} ms/image, training {ms_step:.3f} ms/step at "
        "800 x 1333, batch 2): " + "; ".join(
            f"{k} serving {v['serving_ms_per_image']:.3f} ms/image, training "
            f"{v['training_ms_per_step']:.3f} ms/step, peak "
            f"{v['training_peak_gib']:.2f} GiB" for k, v in rv_summary.items())
        + f"; on {smi}")

    def at_rv(kernel):
        """A kernel's readings on the two-stage FPN variants' own inputs
        (the MS R-CNN's RoIAlign at 14 x 14)."""
        out = {}
        for key in ("fpg", "pafpn", "dualhead", "tsd", "msrcnn"):
            served = rv[key]["serving"]["kernels"]
            if kernel in served:
                out[f"{key}_serving"] = served[kernel]
        for key in ("fpg", "pafpn", "dualhead", "tsd"):
            out[f"{key}_training"] = rv[key]["kernels"][kernel]
        ms_roi = rv["msrcnn"]["roi"]
        if kernel != "nms":
            out["msrcnn_training_14"] = ms_roi[
                "k1_14" if kernel == "roi_align_fwd" else "k2_14"]
        out["converge_tsd"] = at_converge_tsd[kernel]
        out["converge_msrcnn"] = at_converge_msrcnn[kernel]
        return out

    def launches(name):
        by_path = {k: v[name] for k, v in paths.items()}
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    source = "simpledet_torch/csrc/roi_align.cu"
    kernels = [
        dict(name="nms", route="cuda", source="simpledet_torch/csrc/nms.cu",
             replaces="simpledet_tpu/kernels/nms_pallas.py:31",
             **launches("nms"), max_abs_err=nms["max_abs_err"],
             ms=nms["ms"], plain_ms=nms["plain_ms"],
             bound_ms=nms["bound_ms"], bound_by=nms["bound_by"],
             library_ms=None, training=nms["train"],
             converge=at_converge["nms"],
             cascade_serving=at_cascade_serving["nms"],
             cascade_r101_serving=at_r101["nms"],
             converge_cascade=at_converge_cascade["nms"],
             mask_serving=at_mask_serving["nms"],
             converge_mask=at_converge_mask["nms"],
             retina_serving_score0=at_retina_serving,
             converge_retina=at_converge_retina,
             rpn_only_serving=at_rpn_serving,
             mask_v1b_serving=at_mask_v1b_serving["nms"],
             mask_v1b_training=mask_v1b["nms"],
             converge_mask_v1d=at_converge_v1d["nms"], **at_c4("nms"),
             **at_family("nms"), **at_dense("nms"), **at_rv("nms")),
        dict(name="roi_align_fwd", route="cuda", source=source,
             replaces="simpledet_tpu/kernels/roi_align_pallas.py:267",
             **launches("roi_align_fwd"),
             max_abs_err=roi["float32"]["max_abs_err"],
             ms=roi["float32"]["ms"], plain_ms=roi["float32"]["plain_ms"],
             bound_ms=roi["float32"]["bound_ms"],
             bound_by=roi["float32"]["bound_by"], library_ms=None,
             bf16=roi["bfloat16"], with_codes=fwd_train,
             converge=at_converge["roi_align_fwd"],
             cascade_serving_stage3=at_cascade_serving["roi_align_fwd"],
             cascade_training_stage3=k1_stage3,
             converge_cascade=at_converge_cascade["roi_align_fwd"],
             mask_serving_14=at_mask_serving["roi_align_fwd"],
             mask_training_14=k1_mask14,
             mask_launches_a_request=mask_request,
             converge_mask=at_converge_mask["roi_align_fwd"],
             mask_v1b_serving_14=at_mask_v1b_serving["roi_align_fwd"],
             mask_v1b_training_14=k1_mask_v1b_14,
             converge_mask_v1d=at_converge_v1d["roi_align_fwd"],
             **at_c4("roi_align_fwd"), **at_family("roi_align_fwd"),
             **at_rv("roi_align_fwd")),
        dict(name="roi_align_bwd", route="cuda", source=source,
             replaces="simpledet_tpu/kernels/roi_align_pallas.py:351",
             **launches("roi_align_bwd"),
             max_abs_err=bwd["float32"]["max_abs_err"],
             ms=bwd["float32"]["ms"], plain_ms=bwd["float32"]["plain_ms"],
             bound_ms=bwd["float32"]["bound_ms"],
             bound_by=bwd["float32"]["bound_by"], library_ms=None,
             bf16=bwd["bfloat16"], converge=at_converge["roi_align_bwd"],
             cascade_training_stage3=k2_stage3,
             cascade_training_by_stage=k2_by_stage,
             converge_cascade=at_converge_cascade["roi_align_bwd"],
             mask_training_14=dict(k2_mask14, **{
                 k: k2_mask_sizes["14"][k] for k in (
                     "busiest_tile_rois", "mean_tile_rois", "tiles_met",
                     "shape")}),
             mask_training_7=k2_mask_sizes["7"],
             converge_mask=at_converge_mask["roi_align_bwd"],
             mask_v1b_training_14=dict(k2_mask_v1b_14, **{
                 k: k2_mask_v1b_sizes["14"][k] for k in (
                     "busiest_tile_rois", "mean_tile_rois", "tiles_met",
                     "shape")}),
             mask_v1b_training_7=k2_mask_v1b_sizes["7"],
             converge_mask_v1d=at_converge_v1d["roi_align_bwd"],
             **at_c4("roi_align_bwd"), **at_family("roi_align_bwd"),
             **at_rv("roi_align_bwd")),
    ]
    log(json.dumps({"serving_ms_per_image": ms_img,
                    "training_ms_per_step": ms_step,
                    "training_img_per_s": B * 1e3 / ms_step,
                    "training_split_ms": split,
                    "serving_bf16_ms_per_image": ms_img_bf16,
                    "training_bf16_ms_per_step": ms_step_bf16,
                    "training_bf16_img_per_s": B * 1e3 / ms_step_bf16,
                    "training_bf16_split_ms": split_bf16,
                    "eval_cli_img_per_s": eval_stats["img_per_s"],
                    "training_syncbn_ms_per_step": ms_step_sync,
                    "training_syncbn_img_per_s": B * 1e3 / ms_step_sync,
                    "training_syncbn_split_ms": split_sync,
                    "converge": converge_result,
                    "converge_jax_record": JAX_CONVERGE,
                    "serving_cascade_ms_per_image": ms_img_cascade,
                    "training_cascade_ms_per_step": ms_step_cascade,
                    "training_cascade_img_per_s": B * 1e3 / ms_step_cascade,
                    "training_cascade_split_ms": split_cascade,
                    "training_cascade_profile": profile_cascade,
                    "serving_cascade_r101_ms_per_image": ms_img_r101,
                    "converge_cascade": converge_cascade_result,
                    "converge_cascade_jax_record": JAX_CONVERGE_CASCADE,
                    "serving_mask_ms_per_image": ms_img_mask,
                    "training_mask_ms_per_step": ms_step_mask,
                    "training_mask_img_per_s": B * 1e3 / ms_step_mask,
                    "training_mask_split_ms": split_mask,
                    "training_mask_profile": profile_mask,
                    "training_mask_targets": mask["targets"],
                    "mask_test_cli_img_per_s": mask_eval_stats["img_per_s"],
                    "converge_mask": converge_mask_result,
                    "converge_mask_jax_record": JAX_CONVERGE_MASK,
                    "serving_retina_ms_per_image": ms_img_retina,
                    "serving_retina_breakdown": retina_breakdown,
                    "serving_retina_r101_ms_per_image": ms_img_retina_r101,
                    "training_retina_ms_per_step": ms_step_retina,
                    "training_retina_img_per_s": B * 1e3 / ms_step_retina,
                    "training_retina_split_ms": split_retina,
                    "training_retina_profile": profile_retina,
                    "retina_cli_eval_img_per_s":
                        retina_eval_stats["img_per_s"],
                    "converge_retina": converge_retina_result,
                    "converge_retina_jax_record": JAX_CONVERGE_RETINA,
                    "serving_rpn_only_ms_per_image": ms_img_rpn,
                    "serving_rpn_only_breakdown": rpn_breakdown,
                    "training_rpn_only_ms_per_step": ms_step_rpn,
                    "training_rpn_only_split_ms": split_rpn,
                    "training_rpn_only_profile": profile_rpn,
                    "rpn_test_recalls": rpn_recalls,
                    "serving_mask_v1b_ms_per_image": ms_img_mask_v1b,
                    "serving_mask_v1b_breakdown": mask_v1b_breakdown,
                    "training_mask_v1b_ms_per_step": ms_step_mask_v1b,
                    "training_mask_v1b_split_ms": split_mask_v1b,
                    "training_mask_v1b_profile": profile_mask_v1b,
                    "serving_faster_v1d_ms_per_image": ms_img_v1d,
                    "training_faster_v1d_ms_per_step": ms_step_v1d,
                    "training_faster_v1d_split_ms": split_v1d,
                    "serving_r152": {p: dict(ms_per_image=ms, peak_gib=peak)
                                     for p, (_, ms, peak) in
                                     bb["r152"].items()},
                    "scratch_steps": {p: dict(ms=ms, losses=losses)
                                      for p, (_, ms, losses) in
                                      bb["scratch"].items()},
                    "converge_mask_v1d": converge_v1d_result,
                    "converge_mask_v1d_jax_record": None,
                    "c4": c4_summary,
                    "eval_cli_trident_img_per_s":
                        trident_eval_stats["img_per_s"],
                    "rpn_test_c4_recalls": rpn_c4_recalls,
                    "converge_trident": converge_trident_result,
                    "converge_trident_jax_record": JAX_CONVERGE_TRIDENT,
                    "family": fam_summary,
                    "eval_cli_sepc_img_per_s": sepc_eval_stats["img_per_s"],
                    "converge_nasfpn": fam["converge"]["converge_nasfpn"][2],
                    "converge_nasfpn_jax_record": JAX_CONVERGE_NASFPN,
                    "converge_sepc": fam["converge"]["converge_sepc"][2],
                    "converge_sepc_jax_record": JAX_CONVERGE_SEPC,
                    "dense": dense_summary,
                    "eval_cli_reppoints_img_per_s":
                        reppoints_eval_stats["img_per_s"],
                    **{key: dense["converge"][key][2] for key in
                       DENSE_RECIPES},
                    **{f"{key}_jax_record": DENSE_RECIPES[key][3]
                       for key in DENSE_RECIPES},
                    "rcnn_variants": rv_summary,
                    "eval_cli_tsd_img_per_s": tsd_eval_stats["img_per_s"],
                    "mask_test_cli_msrcnn_img_per_s":
                        msrcnn_eval_stats["img_per_s"],
                    "converge_tsd": converge_tsd_result,
                    "converge_tsd_jax_record": JAX_CONVERGE_TSD,
                    "converge_msrcnn": converge_msrcnn_result,
                    "converge_msrcnn_jax_record": JAX_CONVERGE_MSRCNN,
                    "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
