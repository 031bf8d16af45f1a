"""TSD in the port against the JAX package, on the CPU.

The deformable pool (`ops/deform_roi_align.py`) against
`multilevel_roi_align_gather` with `bin_offset` (vmapped over the images, as
the JAX TSDFasterRcnn pools), on four levels of a 512 x 640 image: rois on
every level, touching the image's edges and the last row and column of a
level's map (at x1 = 0 the first bin's clip takes its max at a tie), offsets of
about a cell: the output, and the gradients with respect to the features,
the rois and the offsets; zero offsets against the pool without offsets.
A float64 numpy transcription of the pool holds the premises: every sample
coordinate lies at least 1e-3 from an integer (where the taps, and the
offsets' and rois' gradients, jump) and no bin's max is within 1e-5 of its
runner-up (where float32 differences move the max's gradient).

Then the TSD losses (`tsd_reg_target`, `cls_pc_loss`, `reg_pc_loss`, with
their gradients and stop-gradients) and the whole detector of
tests/rcnn_parity.py's setting (depth 18, FPN 32, 4 classes, 128 x 160,
batch 2) with the TSD head's predictors at Flax's inits (offsets of a
tenth to a third of a bin: HEAD_STDS), built on both sides from the same Flax
params: the train losses (1e-5 relative), the sampled labels, every
gradient (1e-4 of its max), a 3-step SGD trajectory (1e-4) and the test
forward (the TSD branch's scores and boxes decoded against rois_r, 1e-4).
The JAX side compiles its value_and_grad (which also captures its pyramid)
and its test forward once each, in module-scoped fixtures.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_tpu.kernels.roi_align import multilevel_roi_align_gather
from simpledet_tpu.models import fpn as jfpn
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models import tsd as jtsd
from simpledet_tpu.models.norm import normalizer_factory as j_norm
from simpledet_tpu.models.rpn import FPNRpnHead as JRpnHead
from simpledet_torch.core.train import Trainer
from simpledet_torch.kernels.roi_align import multilevel_roi_align_plain
from simpledet_torch.models import tsd
from simpledet_torch.models.fpn import FPNNeck
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.rpn import FPNRpnHead, RpnConvHead
from simpledet_torch.ops.deform_roi_align import deformable_roi_align
from simpledet_torch.targets.fpn_assign import fpn_roi_level
from simpledet_torch.weights import flax_leaf, from_flax

from rcnn_parity import (B, DET_RTOL, FILTERS, FIXED, GRAD_RTOL, LOSS_RTOL,
                         MEAN, NUM_CLASS, SEED_KEY, STD, check_gradients,
                         flat, gt_and_polys, images, jax_sampling_patches,
                         normalised_jax, normalised_torch,
                         param_classes, rel_err, schedule, seeded, t,
                         trajectory)

STRIDES = (4, 8, 16, 32)
POOL_HW, POOL_C, POOL_R = (512, 640), 6, 14
# 16 sampled rois an image, and seeds whose two pools sample no coordinate
# within 1e-4 of an integer (`test_pools_premises`): XLA's fused float32
# coordinates and the port's differ by ulps (4e-6 near cell 40), and a
# coordinate that the two round to either side of an integer moves its
# sample's taps, and so the gradients that reach the offsets and the rois
# (at 64 rois and seeds 1 / 5, one at 4.5e-5 from 37 moved delta_r's by
# 5e-3 of their max; at 64 rois the chance that every one of their ~50,000
# coordinates keeps 1e-4 away is e^-10)
IMAGE_ROI = 16
IMAGE_SEED, PARAM_SEED = 2, 1
TRAJECTORY_LR = 0.01
# what the JAX train forward captures beside its losses: the pyramid, the
# head's outputs (rois_r among them) and its offset predictors'
CAPTURED = ("neck", "bbox_head", "delta_c_fc2", "delta_r_fc2")
# the TSD head's predictors and offset predictors at Flax's inits (drawn
# N(0, 1 / fan_in), the offset predictors moved rois_r by a tenth of a roi,
# and the 3-step trajectory turned chaotic: the TSD regression loss, whose
# targets follow rois_r, climbed from 8.4 to 194 at lr 0.02, and a step's
# gradients jumped on one side wherever it left a sample coordinate within
# float32 noise of an integer; at 0.001-0.005 the third step's losses
# differed by up to 1.2e-2, and by another amount at 2 threads than at 8)
HEAD_STDS = {"tsd_cls_logit": 0.01, "tsd_reg_delta": 0.01,
             "bbox_cls_logit": 0.01, "bbox_reg_delta": 0.001,
             "delta_c_fc1": 0.01, "delta_c_fc2": 0.01, "delta_r_fc1": 0.01,
             "delta_r_fc2": 0.01}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module's tests run: the tier-1
    command runs 6 test workers on the CPU's cores, and torch's default of
    a thread a core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- the deformable pool


def np_pool(feats, rois, off, strides=STRIDES, p=7, trans_std=0.1):
    """Float64 transcription of the pool: (out [B, R, P, P, C], the samples
    [B, R, P, P, 2, 2, C], their coordinates y and x [B, R, P, P, 2, 2] in
    the level's cells, empty [B, R, P, P]); levels from the port's
    float32 fpn_roi_level."""
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    lvl = (fpn_roi_level(t(rois)).numpy() - int(np.log2(strides[0])))
    out = np.zeros((b, r, p, p, c))
    val = np.zeros((b, r, p, p, 2, 2, c))
    ys, xs = np.zeros((2, b, r, p, p, 2, 2))
    empty = np.zeros((b, r, p, p), bool)
    fr = np.array([1 / 3, 2 / 3])
    g = np.arange(p)
    for i in range(b):
        for j in range(r):
            f = feats[lvl[i, j]][i].astype(np.float64)
            hb, wb = f.shape[0] - 1, f.shape[1] - 1
            x1, y1, x2, y2 = rois[i, j].astype(np.float64) / strides[
                lvl[i, j]]
            bh, bw = (y2 - y1) / p, (x2 - x1) / p
            hs, he = (np.clip(y1 + k * bh, 0, hb) for k in (g, g + 1))
            ws, we = (np.clip(x1 + k * bw, 0, wb) for k in (g, g + 1))
            empty[i, j] = (he <= hs)[:, None] | (we <= ws)[None, :]
            y = (hs[:, None] + (he - hs)[:, None] * fr)[:, None, :, None] \
                + (off[i, j, ..., 1] * trans_std * (y2 - y1))[..., None, None]
            x = (ws[:, None] + (we - ws)[:, None] * fr)[None, :, None, :] \
                + (off[i, j, ..., 0] * trans_std * (x2 - x1))[..., None, None]
            y, x = np.broadcast_arrays(y, x)
            yl, yh = np.clip(np.floor(y), 0, hb), np.clip(np.ceil(y), 0, hb)
            xl, xh = np.clip(np.floor(x), 0, wb), np.clip(np.ceil(x), 0, wb)
            a = np.where(yh > yl, y - yl, 0.5)[..., None]
            bt = np.where(xh > xl, x - xl, 0.5)[..., None]

            def tap(yy, xx):
                return f[yy.astype(int), xx.astype(int)]

            v = ((1 - a) * (1 - bt) * tap(yl, xl) + a * (1 - bt) * tap(yh, xl)
                 + (1 - a) * bt * tap(yl, xh) + a * bt * tap(yh, xh))
            val[i, j], ys[i, j], xs[i, j] = v, y, x
            out[i, j] = np.where(empty[i, j][..., None], 0.0,
                                 v.max(axis=(2, 3)))
    return out, val, ys, xs, empty


def assert_bin_max_premise(val, empty, scale):
    """In every non-empty bin, the max of the four samples above the
    runner-up by 1e-5 of the features' scale, or tied with it exactly
    (samples off the map, clamped to the same cells: both packages compute
    the same value for each and split the max's gradient evenly)."""
    top = np.sort(val.reshape(*val.shape[:4], 4, -1), axis=4)
    gap = (top[:, :, :, :, 3] - top[:, :, :, :, 2])[~empty]
    assert gap[gap > 0].min() >= 1e-5 * scale


def pool_inputs():
    """Features [B, H_l, W_l, C] at strides 4-32 of a 512 x 640 image, rois
    [B, POOL_R, 4] on every level, on the image's edges (x1 = 0 or y1 = 0:
    the first bin's clip at 0 is a tie) and one ending on the last row of
    the stride-4 map (508 = (128 - 1) * 4), offsets [B, POOL_R, 7, 7, 2] of
    about 0.7, a bin's redrawn while one of its samples lies within 2e-3 of
    an integer coordinate (the premise, with a margin)."""
    rng = np.random.RandomState(11)
    h, w = POOL_HW
    feats = [rng.randn(B, h // s, w // s, POOL_C).astype(np.float32)
             for s in STRIDES]
    sizes = rng.choice([40.0, 90.0, 150.0, 260.0, 420.0], (B, POOL_R))
    aspect = rng.uniform(0.6, 1.6, (B, POOL_R))
    bw, bh = sizes * np.sqrt(aspect), sizes / np.sqrt(aspect)
    x1 = rng.uniform(-20, w - bw + 20)
    y1 = rng.uniform(-20, h - bh + 20)
    rois = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
    rois = np.clip(rois, 0, [w - 1, h - 1, w - 1, h - 1]).astype(np.float32)
    rois[0, 0] = [0, 470.0, 30.3, 508.0]
    rois[0, 1] = [0, 13.7, 250.5, 511.0]
    rois[1, 0] = [301.2, 0, 639.0, 390.4]
    rois[1, 1] = [611.0, 480.2, 639.0, 511.0]
    rois[1, 2] = [10.5, 5.2, 630.0, 500.3]
    off = (rng.randn(B, POOL_R, 7, 7, 2) * 0.7).astype(np.float32)
    for _ in range(50):
        _, _, ys, xs, _ = np_pool(feats, rois, off)
        near = [np.abs(v - np.round(v)) < 2e-3 for v in (ys, xs)]
        bad = (near[0] | near[1]).any((4, 5))
        if not bad.any():
            return feats, rois, off
        off[bad] = (rng.randn(int(bad.sum()), 2) * 0.7).astype(np.float32)
    raise AssertionError("no offsets away from integer coordinates")


@pytest.fixture(scope="module")
def pool_case():
    """(inputs, the JAX pool's output and its gradients of sum(out * g) with
    respect to the features, the rois and the offsets, g), compiled once."""
    feats, rois, off = pool_inputs()

    def pool(fs, r, o):
        return jax.vmap(lambda f0, f1, f2, f3, rr, oo:
                        multilevel_roi_align_gather(
                            [f0, f1, f2, f3], rr, STRIDES, out_size=7,
                            bin_offset=oo))(*fs, r, o)

    g = np.random.RandomState(12).randn(B, POOL_R, 7, 7, POOL_C).astype(
        np.float32)
    args = ([jnp.asarray(f) for f in feats], jnp.asarray(rois),
            jnp.asarray(off))
    out, vjp = jax.vjp(jax.jit(pool), *args)
    grads = vjp(jnp.asarray(g))
    plain = jax.jit(lambda fs, r: jax.vmap(
        lambda f0, f1, f2, f3, rr: multilevel_roi_align_gather(
            [f0, f1, f2, f3], rr, STRIDES, out_size=7))(*fs, r))(
        args[0], args[1])
    return (feats, rois, off), np.asarray(out), jax.tree.map(
        np.asarray, grads), g, np.asarray(plain)


def test_pool_premises_and_float64_transcription(pool_case):
    """Rois on all four levels; the premises; the port's float32 pool within
    1e-4 of the float64 transcription (a float32 sample coordinate near
    cell 160 is off by up to 1.5e-5 cells, times the features' slope)."""
    (feats, rois, off), *_ = pool_case
    lvl = fpn_roi_level(torch.from_numpy(rois)).numpy()
    assert set(lvl.ravel()) == {2, 3, 4, 5}
    out, val, ys, xs, empty = np_pool(feats, rois, off)
    for v in (ys, xs):
        assert np.abs(v - np.round(v)).min() >= 1e-3
    assert_bin_max_premise(val, empty, max(np.abs(f).max() for f in feats))
    got = deformable_roi_align([t(f) for f in feats], t(rois), t(off),
                               STRIDES)
    assert rel_err(got, out) <= 1e-4
    assert (ys < 0).any() and (xs < 0).any()       # samples off the map too


def test_pool_and_its_gradients_match_jax(pool_case):
    """Output within 1e-4 of its scale (XLA's fused float32 coordinates
    differ from the port's by an ulp, 1.5e-5 cells near cell 160, times the
    features' slope: 1.6e-5 measured); the gradients with respect to the
    features, the rois and the offsets within 1e-4 of their max, the rois'
    and offsets' nonzero."""
    (feats, rois, off), want, (gf, gr, go), g, _ = pool_case
    tf = [t(f).requires_grad_() for f in feats]
    tr, to = t(rois).requires_grad_(), t(off).requires_grad_()
    out = deformable_roi_align(tf, tr, to, STRIDES)
    assert out.shape == (B, POOL_R, 7, 7, POOL_C)
    assert rel_err(out.detach(), want) <= DET_RTOL
    (out * t(g)).sum().backward()
    for got, ref in zip(tf + [tr, to], list(gf) + [gr, go]):
        assert np.abs(ref).max() > 0
        assert rel_err(got.grad, ref) <= GRAD_RTOL


def test_zero_offsets_pool_as_without_offsets(pool_case):
    """Zero offsets give the pool without offsets: the JAX gather without
    bin_offset within 1e-4 (as above), and, on the rois that the RoIAlign
    kernel's long-side clamp leaves on their level, the kernel's plain
    version bit for bit."""
    (feats, rois, off), *_, plain = pool_case
    got = deformable_roi_align([t(f) for f in feats], t(rois),
                               torch.zeros(off.shape), STRIDES)
    assert rel_err(got, plain) <= DET_RTOL
    small = np.maximum(rois[..., 2] - rois[..., 0],
                       rois[..., 3] - rois[..., 1]) < 150
    kernel = multilevel_roi_align_plain([t(f) for f in feats], t(rois),
                                        STRIDES)
    assert small.sum() >= 8
    assert torch.equal(got[small], kernel[small])


# ----------------------------------------------------------- the TSD losses


def loss_inputs():
    rng = np.random.RandomState(21)
    r = 12
    gt, _ = gt_and_polys()
    rois = np.concatenate([gt[:, :3, :4] + rng.uniform(-6, 6, (B, 3, 4)),
                           np.tile(rng.uniform(0, 100, (B, r - 3, 2)), 2)
                           + [0, 0, 30, 25]], 1)
    rois_r = rois + rng.uniform(-4, 4, rois.shape)
    label = rng.randint(0, NUM_CLASS, (B, r))
    label[:, :3] = gt[:, :3, 4]
    return dict(rois=rois.astype(np.float32),
                rois_r=rois_r.astype(np.float32), gt=gt,
                label=label.astype(np.float32),
                logits=rng.randn(B, r, NUM_CLASS).astype(np.float32),
                tsd_logits=rng.randn(B, r, NUM_CLASS).astype(np.float32),
                delta=(rng.randn(B, r, 4 * NUM_CLASS) * 0.3).astype(
                    np.float32),
                tsd_delta=(rng.randn(B, r, 4 * NUM_CLASS) * 0.3).astype(
                    np.float32))


MEAN4, STD4 = (0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2)


def test_tsd_reg_target_matches_jax():
    d = loss_inputs()
    want = jax.jit(jax.vmap(lambda rr, g, lb: jtsd.tsd_reg_target(
        rr, g, lb, NUM_CLASS, MEAN4, STD4)))(
        jnp.asarray(d["rois_r"]), jnp.asarray(d["gt"]),
        jnp.asarray(d["label"]))
    got = tsd.tsd_reg_target(t(d["rois_r"]), t(d["gt"]), t(d["label"]),
                             NUM_CLASS, MEAN4, STD4)
    assert got.shape == (B, 12, 4 * NUM_CLASS)
    assert rel_err(got, want) <= 1e-6
    assert (np.abs(np.asarray(want)) > 0).sum() >= 4 * 6


def test_progressive_constraints_and_gradients_match_jax():
    """cls_pc_loss and reg_pc_loss within 1e-5, positive; their gradients
    with respect to the TSD branch's logits and deltas within 1e-4, and
    none reaching the sibling's (its stop-gradients)."""
    d = loss_inputs()
    j = {k: jnp.asarray(v) for k, v in d.items()}

    def jloss(logits, tsd_logits, delta, tsd_delta):
        c = jtsd.cls_pc_loss(logits, tsd_logits, j["label"])
        r = jnp.mean(jax.vmap(lambda a, b_, ro, rr, g, lb: jtsd.reg_pc_loss(
            a, b_, ro, rr, g, lb, NUM_CLASS, MEAN4, STD4))(
            delta, tsd_delta, j["rois"], j["rois_r"], j["gt"], j["label"]))
        return c + 2.0 * r, (c, r)

    (_, (want_c, want_r)), grads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        j["logits"], j["tsd_logits"], j["delta"], j["tsd_delta"])
    ins = [t(d[k]).requires_grad_() for k in ("logits", "tsd_logits",
                                              "delta", "tsd_delta")]
    c = tsd.cls_pc_loss(ins[0], ins[1], t(d["label"]))
    r = tsd.reg_pc_loss(ins[2], ins[3], t(d["rois"]), t(d["rois_r"]),
                        t(d["gt"]), t(d["label"]), NUM_CLASS, MEAN4, STD4)
    assert float(want_c) > 0 and float(want_r) > 0
    assert rel_err(c.detach(), want_c) <= LOSS_RTOL
    assert rel_err(r.detach(), want_r) <= LOSS_RTOL
    (c + 2.0 * r).backward()
    for x, g in zip(ins, grads):
        g = np.asarray(g)
        if x is ins[0] or x is ins[2]:
            assert x.grad is None or not x.grad.any()
            assert not g.any()
        else:
            assert np.abs(g).max() > 0
            assert rel_err(x.grad, g) <= GRAD_RTOL


# ------------------------------------------------------ the whole detector


def jax_model(p):
    p_rpn, p_roi, p_bbox = p[:3]
    jrpn = JRpnHead(p_rpn)
    return jtsd.TSDFasterRcnn(
        backbone=jresnet.ResNet(depth=18, norm=j_norm("fixbn"),
                                name="backbone"),
        neck=jfpn.FPNNeck(filters=FILTERS, name="neck"),
        rpn_module=jrpn.module, rpn=jrpn,
        bbox_head=jtsd.TSDBboxHead(num_class=NUM_CLASS,
                                   num_reg_class=NUM_CLASS, name="bbox_head"),
        p_rpn=p_rpn, p_roi=p_roi, p_bbox=p_bbox), jrpn


def torch_model(params, p, train=True):
    p_rpn, p_roi, p_bbox = p[:3]
    backbone = ResNet(18)
    trpn = FPNRpnHead(p_rpn)
    model = tsd.TSDFasterRcnn(
        backbone, FPNNeck(backbone.out_channels, FILTERS),
        RpnConvHead(trpn.num_anchor, FILTERS, FILTERS), trpn,
        tsd.TSDBboxHead(NUM_CLASS, NUM_CLASS, FILTERS, 7), p_roi, p_bbox,
        fixed_proposals=train, deterministic_sampling=train)
    from_flax(params, model)
    return model.to(memory_format=torch.channels_last).train(train)


def captured(mdl, _):
    return mdl.name in CAPTURED


@pytest.fixture(scope="module")
def setup():
    """The JAX side's losses, aux (with its pyramid, its offsets and rois_r)
    and gradients of one train forward, and its value_and_grad, compiled
    once."""
    p = param_classes(IMAGE_ROI)
    jmodel, jrpn = jax_model(p)
    data, im_info = images(IMAGE_SEED)
    gt, _ = gt_and_polys()
    shapes = jax.eval_shape(
        lambda r, x, i: jmodel.init(r, x, i, mode="test"),
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros(data.shape), jnp.asarray(im_info))["params"]
    params = seeded(shapes, np.random.RandomState(PARAM_SEED), HEAD_STDS)
    s = dict(p=p, jmodel=jmodel, data=data, im_info=im_info, gt=gt,
             params=params)
    mp = jax_sampling_patches(jrpn, gt)
    x = normalised_jax(data, im_info)

    def loss_fn(prm):
        (losses, aux), inter = jmodel.apply(
            {"params": prm}, x, jnp.asarray(im_info), jnp.asarray(gt),
            mode="train", rngs={"sampling": SEED_KEY},
            capture_intermediates=captured, mutable=["intermediates"])
        inter = inter["intermediates"]
        head = inter["bbox_head"]
        aux = dict(aux, pyramid=inter["neck"]["__call__"][0],
                   delta_c=head["delta_c_fc2"]["__call__"][0],
                   delta_r=head["delta_r_fc2"]["__call__"][0],
                   rois_r=head["__call__"][0][4])
        return sum(losses.values()), (losses, aux)

    s["loss_and_grad"] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (losses, aux)), grads = s["loss_and_grad"](params)
    s["want"] = (jax.tree.map(np.asarray, losses),
                 jax.tree.map(np.asarray, aux),
                 dict(flat(jax.tree.map(np.asarray, grads))))
    yield s
    mp.undo()


@pytest.fixture(scope="module")
def torch_step(setup):
    """The port's train forward and backward, and each deformable pool's
    (rois, offsets) of it."""
    s = setup
    model = torch_model(s["params"], s["p"])
    pools = []
    real = model.extract_deform

    def recording(pyr, rois, bin_offset):
        pools.append((rois.detach().numpy(), bin_offset.detach().numpy()))
        return real(pyr, rois, bin_offset)

    model.extract_deform = recording
    losses, aux = model(normalised_torch(s["data"], s["im_info"]),
                        t(s["im_info"]), t(s["gt"]), mode="train",
                        generator=torch.Generator())
    del model.extract_deform
    sum(losses.values()).backward()
    return model, losses, aux, pools


def test_pools_premises(setup, torch_step):
    """Each of the step's two pools (the sampled rois with delta_c, rois_r
    with delta_r tiled) samples the same cells on both sides and takes its
    bin maxima at the same samples: in every non-empty bin each sample
    coordinate from the port's rois and offsets lies 1e-4 or more from an
    integer and has the floor of the one from the JAX package's, and the
    float64 transcription on the port's pyramid and inputs takes each bin's
    max at the sample it takes on the JAX package's (but where the top two
    samples tie exactly, off the map); the offsets move samples by more
    than a tenth of a bin (at Flax's inits of the offset predictors)."""
    model, _, aux, pools = torch_step
    s = setup
    want_aux = s["want"][1]
    with torch.no_grad():
        pyr = model.pyramid(normalised_torch(s["data"], s["im_info"]))
    feats = [pyr[f"stride{k}"].permute(0, 2, 3, 1).numpy() for k in STRIDES]
    jfeats = [want_aux["pyramid"][f"stride{k}"] for k in STRIDES]
    for f, jf in zip(feats, jfeats):
        assert rel_err(f, jf) <= 1e-5
    b, r = aux["bbox_label"].shape
    jax_pools = [(pools[0][0], want_aux["delta_c"].reshape(b, r, 7, 7, 2)),
                 (want_aux["rois_r"], np.broadcast_to(
                     want_aux["delta_r"][:, :, None, None, :],
                     (b, r, 7, 7, 2)))]
    assert len(pools) == 2
    for (rois, off), (jrois, joff) in zip(pools, jax_pools):
        _, val, ys, xs, empty = np_pool(feats, rois, off)
        _, jval, jys, jxs, _ = np_pool(jfeats, jrois, joff)
        np.testing.assert_array_equal(np.floor(ys), np.floor(jys))
        np.testing.assert_array_equal(np.floor(xs), np.floor(jxs))
        for v in (ys, xs):
            assert (np.abs(v - np.round(v)) >= 1e-4)[~empty].all()
        flat4 = [v.reshape(*v.shape[:4], 4, -1) for v in (val, jval)]
        top = np.sort(flat4[0], axis=4)
        tie = top[:, :, :, :, 3] == top[:, :, :, :, 2]
        same = np.argmax(flat4[0], 4) == np.argmax(flat4[1], 4)
        assert (same | tie)[~empty].all()
        assert np.abs(off).max() * 0.1 * 7 > 0.1


def test_no_bin_max_flips(setup, torch_step):
    """The sibling RoIAlign's bin maxima on the sampled rois are taken at
    the same samples from the JAX pyramid as from the port's."""
    model, _, _, _ = torch_step
    s = setup
    with torch.no_grad():
        pyr, sample, _, _ = model.box_branch(
            normalised_torch(s["data"], s["im_info"]), t(s["im_info"]),
            t(s["gt"]), torch.Generator())
    want = s["want"][1]["pyramid"]
    codes = [multilevel_roi_align_plain(fs, sample["rois"], STRIDES,
                                        with_codes=True)[1]
             for fs in ([pyr[f"stride{k}"].permute(0, 2, 3, 1).contiguous()
                         for k in STRIDES],
                        [t(want[f"stride{k}"]) for k in STRIDES])]
    assert torch.equal(*codes)


def test_train_losses_and_labels_match(setup, torch_step):
    want, want_aux, _ = setup["want"]
    _, losses, aux, _ = torch_step
    assert set(losses) == set(want) == {
        "rpn_cls_loss", "rpn_reg_loss", "bbox_cls_loss", "bbox_reg_loss",
        "tsd_cls_loss", "tsd_reg_loss", "tsd_cls_pc_loss", "tsd_reg_pc_loss"}
    for k, v in want.items():
        assert rel_err(losses[k].detach(), v) <= LOSS_RTOL, k
        assert float(v) > 0, k
    label = aux["bbox_label"].numpy()
    np.testing.assert_array_equal(label, want_aux["bbox_label"])
    assert (label > 0).sum(1).min() >= 2
    # the TSD branch's logits (aux), after the deformable pools: within
    # 1e-4, as the pool's outputs (test_pool_and_its_gradients_match_jax)
    assert rel_err(aux["bbox_cls_logit"].detach(),
                   want_aux["bbox_cls_logit"]) <= DET_RTOL


def test_every_gradient_matches_jax_grad(setup, torch_step):
    """Each parameter's gradient within 1e-4 of its max |grad| of jax.grad;
    the offset predictors' among them, nonzero."""
    grads = setup["want"][2]
    got = check_gradients(grads, torch_step[0], flax_leaf)
    for k in ("delta_c_fc2", "delta_r_fc2", "delta_shared_fc1"):
        assert np.abs(got[f"bbox_head/{k}/kernel"]).max() > 0, k


def test_sgd_trajectory_matches(setup):
    """Three SGD steps at lr 0.01 on both sides (`trajectory`)."""
    s = setup
    trainer = Trainer(torch_model(s["params"], s["p"]), schedule=schedule(
        TRAJECTORY_LR), fixed_param=FIXED, momentum=0.9, wd=1e-4,
        pixel_norm=(MEAN, STD))
    trajectory(s["loss_and_grad"], s["params"], trainer,
               (t(s["data"]), t(s["im_info"]), t(s["gt"])), TRAJECTORY_LR)


@pytest.fixture(scope="module")
def test_outputs(setup):
    """Both sides' test forward, the RPN's cls kernel scaled by 30 so that
    proposal scores stand apart."""
    s = setup
    params = jax.tree.map(np.array, s["params"])
    params["rpn_module"]["rpn_cls"]["kernel"] *= 30
    im_info = jnp.asarray(s["im_info"])
    want = jax.tree.map(np.asarray, jax.jit(
        lambda prm, x: s["jmodel"].apply({"params": prm}, x, im_info,
                                         mode="test"))(
        params, normalised_jax(s["data"], s["im_info"])))
    model = torch_model(params, s["p"], train=False)
    got = model(normalised_torch(s["data"], s["im_info"]), t(s["im_info"]),
                mode="test")
    return want, got


def test_test_forward_matches(test_outputs):
    """The TSD branch's scores and its boxes, decoded against rois_r and
    clipped, within 1e-4 of their scale; the proposals within 1e-4."""
    want, got = test_outputs
    assert set(got) == set(want)
    for k in ("cls_score", "bbox_xyxy", "rois"):
        assert got[k].shape == want[k].shape
        assert rel_err(got[k].numpy(), want[k]) <= DET_RTOL, k
