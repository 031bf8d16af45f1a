"""The port's bf16 path against the JAX package's, stage by stage, on the CPU.

Both packages give each component a compute dtype (`fp16 = True` means
bf16) and keep the parameters in fp32: every conv and dense layer casts its
input, kernel and bias to bf16 and returns bf16; FrozenBN, relu, the max-pool,
the residual and top-down adds run in bf16; the RPN's cls and reg convs, the
box head's logits and deltas, and the losses are fp32 islands.

The stages are fed the JAX stage before them (teacher-forced), each held
relative to its max |value| at a tolerance in units of bf16's rounding error
EPS = 2^-8 (bf16 keeps 8 significant bits: one rounding moves a value by at
most 2^-8 of it, one ulp is 2^-8 to 2^-7 of it): XLA-CPU and oneDNN round
bf16 conv outputs at other places (a bias added in bf16 on both sides, but
sums accumulated in other orders and, in XLA, elementwise chains kept in
fp32 between ops). Discrete stages (top-k,
NMS, sampling) are teacher-forced as in tests/test_torch_train.py: fixed
proposals and arange priorities on both sides.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledet_tpu.core.optimizer import freeze_mask as j_freeze_mask
from simpledet_tpu.core.optimizer import make_optimizer as j_make_optimizer
from simpledet_tpu.core.schedule import warmup_multifactor as j_warmup
from simpledet_tpu.core.train import TrainState, make_train_step
from simpledet_tpu.kernels.roi_align_pallas import batched_roi_align_pallas
from simpledet_tpu.models import fpn as jfpn
from simpledet_tpu.models import heads as jheads
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models.faster_rcnn import FasterRcnn as JFasterRcnn
from simpledet_tpu.models.norm import normalizer_factory
from simpledet_tpu.models.rpn import FPNRpnHead as JRpnHead
from simpledet_tpu.targets import sampling as jsampling
from simpledet_torch.core.config import patch_config_as_nothrow
from simpledet_torch.core.schedule import warmup_multifactor
from simpledet_torch.core.train import Trainer
from simpledet_torch.kernels import roi_align as kroi
from simpledet_torch.models.faster_rcnn import FasterRcnn
from simpledet_torch.models.fpn import FPNNeck
from simpledet_torch.models.heads import Bbox2fcHead
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.rpn import FPNRpnHead, RpnConvHead
from simpledet_torch.weights import flax_path, from_flax

BF16, EPS = torch.bfloat16, 2.0 ** -8
MEAN, STD = (122.7717, 115.9465, 102.9801), (1.0, 1.0, 1.0)
STRIDES = (4, 8, 16, 32)


def rel_err(got, want):
    got = np.asarray(torch.as_tensor(got).float() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _np(x):
    """A JAX array (bf16 included) as float32 numpy."""
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x, dtype=None):
    t = torch.from_numpy(_np(x))
    return t.to(dtype) if dtype is not None else t


def _nchw(x, dtype=BF16):
    return _t(x, dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def fill(rng):
    """Seeded params for a Flax shape tree: FrozenBN scale in [0.2, 0.6] and
    bias in [-0.2, 0.2] (folded statistics keep activations of order one),
    kernels normal with variance 1 / fan-in, other biases small."""
    def leaf(path, s):
        key, parent = path[-1].key, path[-2].key if len(path) > 1 else ""
        if key == "scale":
            return rng.uniform(0.2, 0.6, s.shape).astype(np.float32)
        if key == "bias" and "bn" in parent:
            return rng.uniform(-0.2, 0.2, s.shape).astype(np.float32)
        if key == "bias":
            return rng.uniform(-0.05, 0.05, s.shape).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        return (rng.randn(*s.shape) / np.sqrt(fan)).astype(np.float32)
    return lambda tree: jax.tree_util.tree_map_with_path(leaf, tree)


# ------------------------------------------------------- stage by stage

B, H, W = 2, 128, 192      # ResNet-50 at 128 x 192, the flagship's widths


@pytest.fixture(scope="module")
def stages():
    """The JAX package's bf16 stages: ResNet-50, FPN (256), the RPN head,
    the box head (81 classes), with their params."""
    rng = np.random.RandomState(0)
    bb = jresnet.ResNet(depth=50, norm=normalizer_factory("fixbn"),
                        dtype=jnp.bfloat16)
    neck = jfpn.FPNNeck(dtype=jnp.bfloat16)
    head = jheads.Bbox2fcHead(num_class=81, num_reg_class=81,
                              dtype=jnp.bfloat16)
    x = (rng.randn(B, H, W, 3) * 50).astype(np.float32)
    p_bb = fill(rng)(jax.eval_shape(lambda: bb.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))))["params"])
    c = jax.jit(lambda p, x: bb.apply({"params": p}, x))(p_bb, x)
    p_neck = fill(rng)(jax.eval_shape(lambda: neck.init(
        jax.random.PRNGKey(0), c))["params"])
    pyr = jax.jit(lambda p, c: neck.apply({"params": p}, c))(p_neck, c)

    class RpnParam:
        class anchor_generate:
            scale = (8,)
            ratio = (0.5, 1.0, 2.0)
            stride = (4, 8, 16, 32, 64)

        class head:
            conv_channel = 256

    p_rpn = patch_config_as_nothrow(RpnParam)
    p_rpn.dtype = jnp.bfloat16       # as simpledet_tpu.dsl.FPNRpnHead sets it
    jrpn = JRpnHead(p_rpn)
    p_head_rpn = fill(rng)(jax.eval_shape(lambda: jrpn.module.init(
        jax.random.PRNGKey(0), pyr))["params"])
    rpn = jax.jit(lambda p, f: jrpn.module.apply({"params": p}, f))(
        p_head_rpn, pyr)
    feat = jnp.asarray(rng.randn(B, 64, 7, 7, 256).astype(np.float32),
                       jnp.bfloat16)
    p_head = fill(rng)(jax.eval_shape(lambda: head.init(
        jax.random.PRNGKey(0), feat))["params"])
    out = jax.jit(lambda p, f: head.apply({"params": p}, f))(p_head, feat)
    return dict(x=x, c=c, pyr=pyr, rpn=rpn, feat=feat, head=out,
                params=dict(backbone=p_bb, neck=p_neck, rpn=p_head_rpn,
                            head=p_head))


# ResNet-50's 53 bf16 convs, each output rounded on both sides in other
# places: c5 measured 2.0 EPS of its max; 4 EPS
BACKBONE_TOL = 4 * EPS
# one or two bf16 layers fed the same bf16 input: 2 EPS
LAYER_TOL = 2 * EPS


def test_backbone_bf16(stages):
    model = ResNet(50, dtype=BF16)
    from_flax(stages["params"]["backbone"], model)
    model = model.to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = model(torch.from_numpy(stages["x"]).permute(0, 3, 1, 2))
    assert model.conv0.weight.dtype == torch.float32
    for k, want in stages["c"].items():
        assert want.dtype == jnp.bfloat16 and got[k].dtype == BF16, k
        assert rel_err(got[k].permute(0, 2, 3, 1), _np(want)) <= \
            BACKBONE_TOL, k


def test_fpn_bf16(stages):
    neck = FPNNeck(dtype=BF16)
    from_flax(stages["params"]["neck"], neck)
    with torch.no_grad():
        got = neck({k: _nchw(v) for k, v in stages["c"].items()})
    assert set(got) == set(stages["pyr"])
    for k, want in stages["pyr"].items():
        assert want.dtype == jnp.bfloat16 and got[k].dtype == BF16, k
        assert rel_err(got[k].permute(0, 2, 3, 1), _np(want)) <= \
            LAYER_TOL, k


def test_rpn_head_fp32_islands(stages):
    """rpn_conv in bf16, its output cast to fp32, cls and reg in fp32."""
    head = RpnConvHead(3, 256, 256, dtype=BF16)
    from_flax(stages["params"]["rpn"], head)
    seen = []
    head.rpn_conv.register_forward_hook(lambda m, a, o: seen.append(o.dtype))
    with torch.no_grad():
        got = head({k: _nchw(v) for k, v in stages["pyr"].items()})
    assert seen and set(seen) == {BF16}
    for k, (cls, reg) in stages["rpn"].items():
        assert cls.dtype == reg.dtype == jnp.float32
        assert got[k][0].dtype == got[k][1].dtype == torch.float32
        assert rel_err(got[k][0].permute(0, 2, 3, 1), _np(cls)) <= LAYER_TOL
        assert rel_err(got[k][1].permute(0, 2, 3, 1), _np(reg)) <= LAYER_TOL


def test_box_head_fp32_logits(stages):
    head = Bbox2fcHead(81, 81, 49 * 256, dtype=BF16)
    from_flax(stages["params"]["head"], head)
    seen = []
    head.fc2.register_forward_hook(lambda m, a, o: seen.append(o.dtype))
    with torch.no_grad():
        cls, delta = head(_t(stages["feat"], BF16))
    assert seen == [BF16]
    want_cls, want_delta = stages["head"]
    assert want_cls.dtype == want_delta.dtype == jnp.float32
    assert cls.dtype == delta.dtype == torch.float32
    assert rel_err(cls, _np(want_cls)) <= LAYER_TOL
    assert rel_err(delta, _np(want_delta)) <= LAYER_TOL


# ------------------------------------------------------------- RoIAlign


def _rois(rng, b=2, n=6, h=64, w=96):
    xy = rng.uniform(0, [w * 4 - 40, h * 4 - 40], (b, n, 2))
    wh = np.exp(rng.uniform(np.log(8), np.log(300), (b, n, 2)))
    return np.concatenate([xy, xy + wh], 2).astype(np.float32)


def _pyramid(rng, b=2, h=64, w=96, c=8):
    return [jnp.asarray(rng.randn(b, h // 2 ** i, w // 2 ** i, c)
                        .astype(np.float32), jnp.bfloat16) for i in range(4)]


@pytest.fixture(scope="module")
def roi_case():
    """bf16 features and rois, and the Pallas kernel's bf16 forward and vjp
    (bf16 window tables) in interpret mode."""
    rng = np.random.RandomState(11)
    feats, rois = _pyramid(rng), _rois(rng)
    g = jnp.asarray(rng.randn(*rois.shape[:2], 7, 7, 8).astype(np.float32),
                    jnp.bfloat16)
    jr = jnp.asarray(rois)
    fwd, vjp = jax.vjp(lambda fs: batched_roi_align_pallas(
        fs, jr, STRIDES, 7, 224, 4, "max", None, True), feats)
    (grads,) = vjp(g)
    return dict(feats=feats, rois=rois, g=g, pallas=(fwd, grads))


def _port_roi(case, dtype):
    fs = [_t(f, dtype).requires_grad_() for f in case["feats"]]
    out = kroi.multilevel_roi_align(fs, torch.from_numpy(case["rois"]),
                                    STRIDES)
    grads = torch.autograd.grad(out, fs, _t(case["g"], dtype))
    return out.detach(), grads


def test_roi_align_forward_bf16_plain_vs_pallas(roi_case):
    """The port's bf16 forward is its fp32 result rounded once to bf16 (as
    the CUDA kernel's); the Pallas kernel rounds its window products in bf16,
    so the two differ by a few EPS of the output's max |value| (measured 1.3
    EPS; the Pallas bf16 result is 0.86 EPS from its own fp32 result): 2
    EPS."""
    got, _ = _port_roi(roi_case, BF16)
    got32, _ = _port_roi(roi_case, torch.float32)
    assert got.dtype == BF16
    assert torch.equal(got, got32.to(BF16))
    want = roi_case["pallas"][0]
    assert want.dtype == jnp.bfloat16
    assert rel_err(got, _np(want)) <= 2 * EPS


def test_roi_align_backward_bf16_plain_vs_pallas(roi_case):
    """The port's bf16 backward sums in fp32 and rounds once (as the CUDA
    kernel): it equals its fp32 backward on the same bf16 values rounded to
    bf16 (the fp32 backward is held against the Pallas fp32 vjp in
    tests/test_torch_roi_align.py). The Pallas bf16 vjp accumulates its
    window tables in bf16 (`roi_align_pallas.py`'s tab_dt), rounding at
    every add: on these inputs the port differs from it by up to 22.6 EPS
    of a level's max |grad| (0.088; the Pallas bf16 result is as far from
    the fp32 sum, the port's within 0.6 EPS of it), far beyond one rounding
    of the sum. Logged in ROADMAP.md Queue 3; held here at 32 EPS."""
    _, got = _port_roi(roi_case, BF16)
    _, got32 = _port_roi(roi_case, torch.float32)
    want = roi_case["pallas"][1]
    for level, (g16, g32, w16) in enumerate(zip(got, got32, want)):
        assert g16.dtype == BF16 and w16.dtype == jnp.bfloat16
        assert torch.equal(g16, g32.to(BF16)), level
        if np.abs(_np(w16)).max():         # a level with rois
            assert rel_err(g16, _np(w16)) <= 32 * EPS, level
    assert all(np.abs(_np(w)).max() > 0 for w in want[:2])


# -------------------------------------------- losses and a 3-step trajectory

FILTERS, NUM_CLASS, TB, TH, TW = 64, 5, 2, 96, 128
FIXED = ("conv0", "stage1", "scale", "bias")
SEED_KEY = jax.random.PRNGKey(3)


def train_params_classes():
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
            image_roi = 64
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
        stride = STRIDES
        roi_canonical_scale = 224
        roi_canonical_level = 4

    class BboxParam:
        num_class = NUM_CLASS

        class regress_target:
            class_agnostic = False
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    return [patch_config_as_nothrow(c) for c in (RpnParam, RoiParam,
                                                  BboxParam)]


@pytest.fixture(scope="module")
def trajectories():
    """Three SGD steps (the flagship's momentum, wd, warmup and frozen
    patterns, lr 0.002) of the depth-18 bf16 detector on both sides from the
    same params, with fixed proposals, arange priorities and the JAX
    package's crop RoIAlign (whose bf16 backward accumulates in bf16, like
    the Pallas kernel's tables). At the flagship's lr 0.02 this seeded model
    leaves its basin in the second step on both sides (total loss 4 -> 68),
    which would amplify rounding differences without bound."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SIMPLEDET_ROI_ALIGN", "crop")
    mp.setattr(jsampling, "_priorities",
               lambda rng, n, deterministic: jnp.arange(n, dtype=jnp.float32))
    try:
        p_rpn, p_roi, p_bbox = train_params_classes()
        p_rpn.dtype = jnp.bfloat16
        jrpn = JRpnHead(p_rpn)
        bf = jnp.bfloat16
        jmodel = JFasterRcnn(
            backbone=jresnet.ResNet(depth=18, norm=normalizer_factory("fixbn"),
                                    dtype=bf, name="backbone"),
            neck=jfpn.FPNNeck(filters=FILTERS, dtype=bf, name="neck"),
            rpn_module=jrpn.module, rpn=jrpn,
            bbox_head=jheads.Bbox2fcHead(num_class=NUM_CLASS,
                                         num_reg_class=NUM_CLASS, dtype=bf,
                                         name="bbox_head"),
            p_rpn=p_rpn, p_roi=p_roi, p_bbox=p_bbox, fixed_proposals=True)
        rng = np.random.RandomState(0)
        data = rng.randint(0, 256, (TB, TH, TW, 3), dtype=np.uint8)
        im_info = np.float32([[TH, TW, 1.0], [80, 100, 1.0]])
        gt = np.full((TB, 8, 5), -1, np.float32)
        gt[0, :3] = [[10, 12, 60, 70, 1], [50, 20, 120, 90, 3],
                     [5, 40, 40, 94, 4]]
        gt[1, :2] = [[20, 10, 90, 60, 2], [0, 30, 50, 79, 1]]
        params = jax.jit(lambda i: jmodel.init(
            {"params": jax.random.PRNGKey(0),
             "sampling": jax.random.PRNGKey(1)},
            jnp.zeros((TB, TH, TW, 3)), i, mode="test"))(
                jnp.asarray(im_info))["params"]
        # the Flax initialisers, with random folded statistics in FrozenBN
        params = jax.tree_util.tree_map_with_path(
            lambda path, v: (
                rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
                if path[-1].key == "scale" else
                rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
                if path[-1].key == "bias" and v.ndim == 1
                and "bn" in path[-2].key else np.asarray(v)), params)
        sched = dict(warmup_lr=0.002 / 3, warmup_iter=500)
        tx = j_make_optimizer(j_warmup(0.002, [60000, 80000], **sched),
                              momentum=0.9, wd=1e-4,
                              trainable_mask=j_freeze_mask(params, FIXED))
        state = TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx)
        step = make_train_step(jmodel, donate=False, pixel_norm=(MEAN, STD))
        batch = {"data": jnp.asarray(data), "im_info": jnp.asarray(im_info),
                 "gt_bbox": jnp.asarray(gt)}
        backbone = ResNet(18, dtype=BF16)
        trpn = FPNRpnHead(p_rpn)
        model = FasterRcnn(
            backbone, FPNNeck(backbone.out_channels, FILTERS, dtype=BF16),
            RpnConvHead(trpn.num_anchor, FILTERS, FILTERS, dtype=BF16), trpn,
            Bbox2fcHead(NUM_CLASS, NUM_CLASS, 49 * FILTERS, dtype=BF16),
            p_roi, p_bbox, fixed_proposals=True, deterministic_sampling=True)
        from_flax(params, model)
        trainer = Trainer(model.to(memory_format=torch.channels_last).train(),
                          schedule=warmup_multifactor(0.002, [60000, 80000],
                                                      **sched),
                          fixed_param=FIXED, momentum=0.9, wd=1e-4,
                          pixel_norm=(MEAN, STD))
        jl, tl = [], []
        for i in range(3):
            state, losses, _ = step(state, batch,
                                    jax.random.fold_in(SEED_KEY, i))
            jl.append({k: float(v) for k, v in losses.items()})
            tl.append({k: float(v) for k, v in trainer.step(
                torch.from_numpy(data), torch.from_numpy(im_info),
                torch.from_numpy(gt)).items()})
    finally:
        mp.undo()
    return dict(params=params, state=state, trainer=trainer, jl=jl, tl=tl)


# Losses from bf16 features on both sides, teacher-forced: each within 4 EPS
# relative (measured 0.16).
LOSS_RTOL = 4 * EPS


def test_losses_teacher_forced_bf16(trajectories):
    """The first step's four losses, computed in fp32 from the bf16 path with
    fixed proposals and arange priorities on both sides."""
    want, got = trajectories["jl"][0], trajectories["tl"][0]
    assert set(want) == set(got) and len(want) == 5
    for k in want:
        assert abs(got[k] - want[k]) <= LOSS_RTOL * abs(want[k]), k


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def test_bf16_sgd_trajectory(trajectories):
    """Three bf16 SGD steps: every loss within 4 EPS (measured 0.2),
    every parameter (fp32 on both sides) within 4 EPS of its scale (measured
    1.0), every trained leaf's total update within 32 EPS of the update's
    scale (measured 20: each weight gradient of a bf16 layer is rounded to
    bf16, and each step's gradient is taken where the last step left the
    parameters), frozen leaves bit-unchanged on both sides."""
    s = trajectories
    for jl, tl in zip(s["jl"], s["tl"]):
        assert abs(tl["total_loss"] - jl["total_loss"]) <= \
            LOSS_RTOL * abs(jl["total_loss"])
    want = dict(_flat(jax.tree.map(np.asarray, s["state"].params)))
    start = dict(_flat(s["params"]))
    trainer = s["trainer"]
    assert trainer.step_count == 3
    worst = 0.0
    for name, t in trainer.model.state_dict().items():
        path = flax_path(name)
        assert t.dtype == torch.float32, name
        g = t.numpy()
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)
        elif g.ndim == 2:
            g = g.T
        assert rel_err(g, want[path]) <= 4 * EPS, name
        moved = want[path] - start[path]
        if trainer.trainable[name]:
            assert np.abs(moved).max() > 0, name
            worst = max(worst, rel_err(g - start[path], moved))
        else:
            np.testing.assert_array_equal(g, start[path])
            assert not np.abs(moved).any(), name
    assert worst <= 32 * EPS, worst


# ------------------------------------------------------------- full width

FLAGSHIP_BF16 = "config/faster_r50v1_fpn_bf16_1x.py"


@pytest.fixture(scope="module")
def bf16_leaves():
    """The JAX package's param shapes of the bf16 flagship (test symbol)."""
    from simpledet_tpu.core.config import load_config as j_load_config

    jmodel = j_load_config(FLAGSHIP_BF16).get_config(is_train=False)[6]
    return jax.eval_shape(lambda: jmodel.test_symbol.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros((1, 128, 160, 3)), jnp.asarray([[128, 160, 1.0]]),
        mode="test"))["params"]


@pytest.mark.parametrize("is_train", [False, True])
def test_bf16_config_builds_and_maps_all_leaves(bf16_leaves, is_train):
    """read_config serves the config's import of
    simpledet_tpu.config_templates from the port's copy: the bf16 detector
    builds for test and train, computes in bf16 with fp32 islands, keeps its
    189 parameters and buffers in fp32, and from_flax maps the JAX model's
    189 leaves onto it with equal shapes."""
    import sys

    from simpledet_torch.core.config import read_config
    from simpledet_torch.dsl import build_detector

    real = sys.modules.get("simpledet_tpu.config_templates")
    spec = read_config(FLAGSHIP_BF16, is_train=is_train)
    assert sys.modules.get("simpledet_tpu.config_templates") is real
    assert spec.detector == "FasterRcnn" and spec.is_train == is_train
    assert spec.name == "config_faster_r50v1_fpn_bf16_1x"
    assert spec.components["rpn_head"].param.proposal.post_nms_top_n == (
        2000 if is_train else 1000)
    model = build_detector(spec)
    assert model.backbone.dtype == BF16
    assert model.neck.P2_conv.compute_dtype == BF16
    assert model.rpn_module.rpn_conv.compute_dtype == BF16
    assert not hasattr(model.rpn_module.rpn_cls, "compute_dtype")
    assert model.bbox_head.fc2.compute_dtype == BF16
    assert not hasattr(model.bbox_head.cls_logit, "compute_dtype")
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        bf16_leaves)
    assert len(jax.tree_util.tree_leaves(params)) == 189
    from_flax(params, model)
    state = model.state_dict()
    assert len(state) == 189
    assert all(t.dtype == torch.float32 for t in state.values())
