"""One training step (counterpart of simpledet_tpu/core/train.py: TrainState
and make_train_step).

A step normalises a uint8 batch on the device, runs the detector in train
mode, sums its losses, backpropagates, and takes the optimizer step at the
schedule's lr for the step count before the update.

Data parallel: when a process group exists (`parallel/dist.py`), the
detector trains in DistributedDataParallel, one rank a device, each on its
shard of the global batch. The JAX package averages the loss over the global
batch; DDP averages the ranks' gradients, so each rank's loss is its share
of the global mean: the box head's and the RPN regression's divisors are
constants per image, the RPN classification's count of valid anchors and
RetinaNet's foreground count (the reference's sync_loss) are summed over
the group (`models/rpn.py`, `models/retinanet.py`; FCOS's positive count
and centerness sums, RepPoints' foreground counts and FreeAnchor's gt count
likewise). SyncBN sums its statistics over the
group, so its running statistics are the same on every rank: DDP does not
broadcast buffers. The losses a step returns are averaged over the group,
the global batch's losses. Remat and QAT are not ported yet.
"""
import torch

from simpledet_torch import resolve_device
from simpledet_torch.core.optimizer import freeze_mask, make_optimizer, set_lr
from simpledet_torch.core.schedule import from_optimize_param
from simpledet_torch.dsl import detector_from_config
from simpledet_torch.models.norm import fold_batch_stats
from simpledet_torch.ops.image import device_normalize
from simpledet_torch.parallel import dist


def fold_detector_stats(model, data, im_info):
    """Fold one batch's statistics into every FrozenBN of a detector
    (`models/norm.py::fold_batch_stats`), layer by layer in the order of its
    test forward on the normalised batch data [B, H, W, 3]: the backbone's
    on the batch, then each later one on what reaches it through the layers
    folded before it (a BN neck's laterals and outputs, RetinaNetHeadWithBN's
    per-level norms, a C4 model's C5 head on the rois of its proposals). The
    forward runs in eval mode, so that no SyncBN takes a step of its running
    statistics; a detector without FrozenBN is left as it is."""
    was_training = model.training
    model.eval()
    try:
        fold_batch_stats(model, data, im_info, mode="test")
    finally:
        model.train(was_training)


class Trainer:
    """A detector, its optimizer, its schedule and the samplers' generator.

    model: a FasterRcnn, CascadeRcnn, MaskFasterRcnn, RetinaNet (FreeAnchor
    too), FCOS, RepPoints or RpnOnly; schedule: step ->
    lr; fixed_param and excluded_param: the freezing substrings; pixel_norm:
    (mean, std) for uint8 batches; seed: the samplers' torch.Generator seed (plus the rank).
    `timer`, when set, is called with "forward", "backward" and "optimizer"
    as each phase of a step ends. `aux` holds the last step's detached aux
    outputs, for the metrics."""

    def __init__(self, model, *, schedule, fixed_param=(), excluded_param=(),
                 opt_type="sgd", momentum=0.9, wd=1e-4, clip_gradient=None,
                 pixel_norm=None, seed=0):
        self.model = model
        self.device = next(model.parameters()).device
        self.schedule = schedule
        self.trainable = freeze_mask(model, fixed_param, excluded_param)
        self.optimizer = make_optimizer(model, self.trainable,
                                        lr=schedule(0), opt_type=opt_type,
                                        momentum=momentum, wd=wd)
        self.forward_model = model
        if dist.is_initialized():
            self.forward_model = dist.data_parallel(model, self.device)
        self.clip_gradient = clip_gradient
        self.pixel_norm = pixel_norm
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + dist.rank())
        self.step_count = 0
        self.timer = None
        self.aux = None

    @classmethod
    def from_config(cls, path, *, device="cuda", seed=0):
        """The config's train detector (seeded random weights) with its
        optimizer, schedule and frozen parameters, on `device`."""
        device = resolve_device(device)
        model, spec = detector_from_config(path, device=device, seed=seed,
                                           is_train=True)
        opt = spec.optimize
        return cls.from_spec(model, spec,
                             opt.schedule.iter_per_epoch or 1, seed=seed)

    @classmethod
    def from_spec(cls, model, spec, iter_per_epoch, *, seed=0):
        """A Trainer for `model` with the optimizer, schedule (over
        iter_per_epoch steps an epoch) and frozen parameters of a train
        ConfigSpec."""
        opt = spec.optimize
        sched = from_optimize_param(opt, iter_per_epoch, dist.host_count())
        return cls(model, schedule=sched, fixed_param=spec.fixed_param,
                   excluded_param=spec.excluded_param,
                   opt_type=opt.optimizer.type or "sgd",
                   momentum=opt.optimizer.momentum or 0.9,
                   wd=opt.optimizer.wd or 0.0,
                   clip_gradient=opt.optimizer.clip_gradient,
                   pixel_norm=spec.pixel_norm, seed=seed)

    def _inputs(self, images, im_info):
        """The normalised float batch and im_info on the device."""
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        im_info = torch.as_tensor(im_info, dtype=torch.float32).to(self.device)
        if self.pixel_norm is not None:
            images = device_normalize(images, im_info, *self.pixel_norm)
        return images.float(), im_info

    def fold_batch_stats(self, images, im_info):
        """Fold this batch's statistics into the model's FrozenBN buffers
        (`fold_detector_stats`): the stand-in for a pretrained checkpoint
        that seeded random weights need before they train."""
        fold_detector_stats(self.model, *self._inputs(images, im_info))

    def _mark(self, phase):
        if self.timer is not None:
            self.timer(phase)

    def step(self, images, im_info, gt_bbox, gt_poly=None):
        """images [B, H, W, 3] (uint8, or float already normalised),
        im_info [B, 3], gt_bbox [B, G, 5] and, for a Mask R-CNN, the polygon
        edges gt_poly [B, G, E, 5] -> {loss name: detached scalar tensor}
        with "total_loss", averaged over the process group; the gradients
        stay in each parameter's .grad until the next step."""
        data, im_info = self._inputs(images, im_info)
        gt_bbox = torch.as_tensor(gt_bbox, dtype=torch.float32).to(
            self.device)
        kw = {}
        if gt_poly is not None:
            kw["gt_poly"] = torch.as_tensor(gt_poly, dtype=torch.float32).to(
                self.device)
        self.optimizer.zero_grad(set_to_none=True)
        losses, aux = self.forward_model(data, im_info, gt_bbox, mode="train",
                                         generator=self.generator, **kw)
        self.aux = {k: v.detach() for k, v in aux.items()}
        total = sum(v.float() for v in losses.values())
        self._mark("forward")
        total.backward()
        self._mark("backward")
        self.update()
        self._mark("optimizer")
        out = {k: v.detach() for k, v in losses.items()}
        out["total_loss"] = total.detach()
        return dist.mean_over_group(out)

    def update(self):
        """The optimizer step from the gradients in each parameter's .grad:
        clip, then the update at the schedule's lr for the step count."""
        if self.clip_gradient:
            # optax.clip: each gradient value clamped to [-c, c]
            params = [p for g in self.optimizer.param_groups
                      for p in g["params"]]
            torch.nn.utils.clip_grad_value_(params, self.clip_gradient)
        set_lr(self.optimizer, self.schedule(self.step_count))
        self.optimizer.step()
        self.step_count += 1
