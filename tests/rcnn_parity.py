"""What the TSD and Mask Scoring R-CNN parity tests share: the small two-stage
setting (depth-18 bottleneck ResNet, FPN 32 wide, 4 classes, 128 x 160
images, batch 2, 64 sampled rois an image), its param classes, seeded Flax
params, the gt boxes with their polygons, and the patches under which the
JAX package's train forward samples what the port's does (`arange`
priorities, train proposals from the gt, the crop RoIAlign).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_tpu.data.mask_transforms import polys_to_edges
from simpledet_tpu.models.faster_rcnn import \
    deterministic_proposals as j_fixed_proposals
from simpledet_tpu.ops.image import device_normalize as j_normalize
from simpledet_tpu.targets import sampling as jsampling
from simpledet_torch.core.config import patch_config_as_nothrow
from simpledet_torch.ops.image import device_normalize

MEAN, STD = (122.7717, 115.9465, 102.9801), (1.0, 1.0, 1.0)
FILTERS, NUM_CLASS, B, H, W = 32, 4, 2, 128, 160
IMAGE_ROI = 64
FIXED = ("conv0", "stage1", "scale", "bias")
SEED_KEY = jax.random.PRNGKey(3)
LOSS_RTOL, GRAD_RTOL, DET_RTOL = 1e-5, 1e-4, 1e-4


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def t(x):
    return torch.from_numpy(np.array(x))


def flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def param_classes(image_roi=IMAGE_ROI):
    """Nothrow RpnParam, RoiParam, BboxParam, MaskParam, MaskRoiParam and
    TestParam; image_roi rois sampled an image, a quarter of them fg."""
    class RpnParam:
        class anchor_generate:
            scale = (8,)
            ratio = (0.5, 1.0, 2.0)
            stride = (4, 8, 16, 32, 64)

        class anchor_assign:
            allowed_border = 0
            pos_thr = 0.7
            neg_thr = 0.3
            min_pos_thr = 0.0
            image_anchor = 256
            pos_fraction = 0.5

        class head:
            conv_channel = FILTERS

        class proposal:
            pre_nms_top_n = 256
            post_nms_top_n = 128
            nms_thr = 0.7
            min_bbox_side = 0

        class subsample_proposal:
            proposal_wo_gt = False
            fg_fraction = 0.25
            fg_thr = 0.5
            bg_thr_hi = 0.5
            bg_thr_lo = 0.0

        class bbox_target:
            num_reg_class = NUM_CLASS
            class_agnostic = False
            weight = (1.0, 1.0, 1.0, 1.0)
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    class RoiParam:
        out_size = 7
        stride = (4, 8, 16, 32)
        roi_canonical_scale = 224
        roi_canonical_level = 4

    class MaskRoiParam(RoiParam):
        out_size = 14

    class BboxParam:
        num_class = NUM_CLASS

        class regress_target:
            class_agnostic = False
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    class MaskParam:
        resolution = 28
        dim_reduced = FILTERS

    class TestParam:
        min_det_score = 0.05
        max_det_per_image = 20

        class nms:
            thr = 0.5

    RpnParam.subsample_proposal.image_roi = image_roi
    out = tuple(patch_config_as_nothrow(p) for p in (
        RpnParam, RoiParam, BboxParam, MaskParam, MaskRoiParam, TestParam))
    out[0].dtype = jnp.float32
    return out


def ellipse(x1, y1, x2, y2, n=16):
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, \
        (y2 - y1) / 2
    return np.stack([cx + rx * np.cos(a), cy + ry * np.sin(a)],
                    1).astype(np.float32).reshape(-1)


def gt_and_polys():
    """gt_bbox [B, 8, 5] (one box on each image's left edge) and gt_poly
    [B, 8, 40, 5]: each box's inscribed ellipse; instance (0, 1) two
    overlapping rectangles."""
    gt = np.full((B, 8, 5), -1, np.float32)
    gt[0, :3] = [[0, 12, 60, 70, 1], [50, 20, 120, 90, 3],
                 [5, 60, 40, 120, 2]]
    gt[1, :3] = [[20, 10, 90, 60, 2], [70, 40, 150, 100, 1],
                 [0, 70, 44, 110, 3]]
    polys = {(b, i): [ellipse(*gt[b, i, :4])] for b in range(B)
             for i in range(8) if gt[b, i, 4] >= 0}
    polys[0, 1] = [np.float32([50, 20, 100, 20, 100, 70, 50, 70]),
                   np.float32([70, 40, 120, 40, 120, 90, 70, 90])]
    edges = np.full((B, 8, 40, 5), -1, np.float32)
    for (b, i), p in polys.items():
        edges[b, i] = polys_to_edges(p, 40)
    return gt, edges


def images(seed):
    data = np.random.RandomState(seed).randint(0, 256, (B, H, W, 3),
                                               dtype=np.uint8)
    return data, np.float32([[H, W, 1.0], [112, 150, 1.0]])


def normalised_jax(data, im_info):
    return j_normalize(jnp.asarray(data), jnp.asarray(im_info), MEAN, STD)


def normalised_torch(data, im_info):
    return device_normalize(t(data), t(im_info), MEAN, STD)


def seeded(shapes, rng, stds=None):
    """Kernels N(0, 1 / fan_in), biases 0, FrozenBN scales in [0.2, 0.6]
    and biases in [-0.2, 0.2]; the RPN's convs and the layers of `stds`
    (by module name) at N(0, std^2), as Flax's inits draw them."""
    stds = dict({"rpn_conv": 0.01, "rpn_cls": 0.01, "rpn_reg": 0.01},
                **(stds or {}))

    def leaf(path, s):
        keys = [k.key for k in path]
        name, parent = keys[-1], keys[-2] if len(keys) > 1 else ""
        if name == "scale":
            return rng.uniform(0.2, 0.6, s.shape).astype(np.float32)
        if name == "bias":
            if "bn" in parent:
                return rng.uniform(-0.2, 0.2, s.shape).astype(np.float32)
            return np.zeros(s.shape, np.float32)
        if parent in stds:
            return (rng.randn(*s.shape) * stds[parent]).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_sampling_patches(jrpn, gt):
    """A MonkeyPatch under which the JAX package samples on `arange`
    priorities, takes `deterministic_proposals` of gt as its train
    proposals (its TSD and Mask Scoring detectors have no hook of their
    own) and runs the crop RoIAlign; undo() when done."""
    gt = jnp.asarray(gt)
    real = jrpn.proposals

    def proposals(level_outputs, im_info, pad_hw, is_train):
        boxes, scores = real(level_outputs, im_info, pad_hw, is_train)
        if is_train:
            boxes = j_fixed_proposals(gt, boxes.shape[1])
        return boxes, scores

    mp = pytest.MonkeyPatch()
    mp.setenv("SIMPLEDET_ROI_ALIGN", "crop")
    mp.setattr(jsampling, "_priorities",
               lambda rng, n, deterministic: jnp.arange(n, dtype=jnp.float32))
    mp.setattr(jrpn, "proposals", proposals)
    return mp


def neck_filter(mdl, _):
    """capture_intermediates' filter: the neck's output (the pyramid)."""
    return mdl.name == "neck"


def check_gradients(grads, model, leaf):
    """Each parameter's gradient within GRAD_RTOL of its Flax leaf's max
    |grad| (grads: {'/'-joined path: array}; `leaf(name, grad)` the Flax
    layout); FrozenBN's leaves have no port parameter."""
    from simpledet_torch.weights import flax_path

    got = {flax_path(n): leaf(n, p.grad.numpy())
           for n, p in model.named_parameters()}
    assert set(got) == {k for k in grads if not k.endswith("/scale")
                        and not (k.endswith("/bias") and "bn"
                                 in k.split("/")[-2])}
    errs = {k: rel_err(g, grads[k]) for k, g in got.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    return got


def schedule(lr):
    """The port's schedule of `trajectory`."""
    from simpledet_torch.core.schedule import warmup_multifactor
    return warmup_multifactor(lr, [60000], warmup_lr=lr / 3, warmup_iter=500)


def trajectory(jax_loss_and_grad, params, trainer, batch, lr, steps=3):
    """`steps` steps of Trainer (built with `schedule(lr)`) against
    jax.value_and_grad and TrainState.apply_gradients (make_train_step's two
    halves: sgd, momentum 0.9, wd 1e-4, gradual warmup from lr / 3, FIXED
    frozen): each total loss within 1e-4, then every parameter within 1e-4
    of its scale, frozen ones unchanged and trained ones moved."""
    from simpledet_tpu.core.optimizer import freeze_mask as j_freeze_mask
    from simpledet_tpu.core.optimizer import make_optimizer as j_make_opt
    from simpledet_tpu.core.schedule import warmup_multifactor as j_warmup
    from simpledet_tpu.core.train import TrainState
    from simpledet_torch.weights import flax_leaf, flax_path

    tx = j_make_opt(j_warmup(lr, [60000], warmup_lr=lr / 3,
                             warmup_iter=500),
                    momentum=0.9, wd=1e-4,
                    trainable_mask=j_freeze_mask(params, FIXED))
    state = TrainState.create(apply_fn=None, params=params, tx=tx)
    update = jax.jit(lambda st, g: st.apply_gradients(grads=g))
    for i in range(steps):
        (jl, _), grads = jax_loss_and_grad(state.params)
        state = update(state, grads)
        tl = trainer.step(*batch)
        assert rel_err(tl["total_loss"], jl) <= 1e-4, i
    want = dict(flat(jax.tree.map(np.asarray, state.params)))
    start = dict(flat(params))
    moved = 0
    for name, p in trainer.model.named_parameters():
        path = flax_path(name)
        got = flax_leaf(name, p.detach().numpy())
        assert rel_err(got, want[path]) <= 1e-4, name
        if trainer.trainable[name]:
            moved += bool(np.abs(want[path] - start[path]).max() > 0)
        else:
            np.testing.assert_array_equal(got, start[path])
    assert moved > 20
