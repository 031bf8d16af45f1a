"""One training step on one device (counterpart of simpledet_tpu/core/train.py:
TrainState and make_train_step without a mesh).

A step normalises a uint8 batch on the device, runs the detector in train
mode, sums its losses, backpropagates, and takes the optimizer step at the
schedule's lr for the step count before the update. DDP, SyncBN, remat and
QAT are not ported yet.
"""
import torch

from simpledet_torch import resolve_device
from simpledet_torch.core.optimizer import freeze_mask, make_optimizer, set_lr
from simpledet_torch.core.schedule import apply_dp_scaling, warmup_multifactor
from simpledet_torch.dsl import detector_from_config
from simpledet_torch.models.norm import fold_batch_stats
from simpledet_torch.ops.image import device_normalize


class Trainer:
    """A detector, its optimizer, its schedule and the samplers' generator.

    model: a FasterRcnn; schedule: step -> lr; fixed_param: the freezing
    substrings; pixel_norm: (mean, std) for uint8 batches;
    seed: the samplers' torch.Generator seed. `timer`, when set, is called
    with "forward", "backward" and "optimizer" as each phase of a step
    ends."""

    def __init__(self, model, *, schedule, fixed_param=(), opt_type="sgd",
                 momentum=0.9, wd=1e-4, clip_gradient=None, pixel_norm=None,
                 seed=0):
        self.model = model
        self.device = next(model.parameters()).device
        self.schedule = schedule
        self.trainable = freeze_mask(model, fixed_param)
        self.optimizer = make_optimizer(model, self.trainable,
                                        lr=schedule(0), opt_type=opt_type,
                                        momentum=momentum, wd=wd)
        self.clip_gradient = clip_gradient
        self.pixel_norm = pixel_norm
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step_count = 0
        self.timer = None

    @classmethod
    def from_config(cls, path, *, device="cuda", seed=0):
        """The config's train detector (seeded random weights) with its
        optimizer, schedule and frozen parameters, on `device`."""
        device = resolve_device(device)
        model, spec = detector_from_config(path, device=device, seed=seed,
                                           is_train=True)
        opt = spec.optimize
        if opt.schedule.lr_mode:
            raise NotImplementedError(f"lr_mode {opt.schedule.lr_mode!r} is "
                                      "not ported yet")
        total_iter = (opt.schedule.iter_per_epoch or 1) * (
            opt.schedule.end_epoch or 1)
        base_lr, lr_iter, warm_iter = apply_dp_scaling(
            opt.optimizer.lr, opt.schedule.lr_iter or [], opt.warmup.iter or 0,
            1, total_iter=total_iter, warmup_in_pct=bool(opt.warmup.in_pct))
        sched = warmup_multifactor(
            base_lr, lr_iter, warmup_type=opt.warmup.type or "gradual",
            warmup_lr=opt.warmup.lr, warmup_iter=warm_iter)
        return cls(model, schedule=sched, fixed_param=spec.fixed_param,
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
        """Fold this batch's statistics into the backbone's FrozenBN buffers
        (`models/norm.py::fold_batch_stats`): the stand-in for a pretrained
        checkpoint that seeded random weights need before they train."""
        data, _ = self._inputs(images, im_info)
        fold_batch_stats(self.model.backbone, data.permute(0, 3, 1, 2))

    def _mark(self, phase):
        if self.timer is not None:
            self.timer(phase)

    def step(self, images, im_info, gt_bbox):
        """images [B, H, W, 3] (uint8, or float already normalised),
        im_info [B, 3], gt_bbox [B, G, 5] -> {loss name: detached scalar
        tensor} with "total_loss"; the gradients stay in each parameter's
        .grad until the next step."""
        data, im_info = self._inputs(images, im_info)
        gt_bbox = torch.as_tensor(gt_bbox, dtype=torch.float32).to(
            self.device)
        self.optimizer.zero_grad(set_to_none=True)
        losses, _ = self.model(data, im_info, gt_bbox, mode="train",
                               generator=self.generator)
        total = sum(v.float() for v in losses.values())
        self._mark("forward")
        total.backward()
        self._mark("backward")
        if self.clip_gradient:
            # optax.clip: each gradient value clamped to [-c, c]
            params = [p for g in self.optimizer.param_groups
                      for p in g["params"]]
            torch.nn.utils.clip_grad_value_(params, self.clip_gradient)
        set_lr(self.optimizer, self.schedule(self.step_count))
        self.optimizer.step()
        self.step_count += 1
        self._mark("optimizer")
        out = {k: v.detach() for k, v in losses.items()}
        out["total_loss"] = total.detach()
        return out
