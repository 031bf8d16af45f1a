"""Mask Scoring R-CNN in the port against the JAX package, on the CPU.

`polygon_area` and `maskiou_target` against the JAX package's on random
inputs (padding edges, rows off the fg, rois narrower than a cell); the
MaskIoU head (3 + 1 convs 32 wide, the stride-2 one padded as Flax's SAME,
two fc layers) on 2 x 5 rois: its output and the gradients of its
parameters, its features and its mask logits (through the 2x max pool).
Then the whole detector in tests/rcnn_parity.py's setting (depth 18, FPN
32, 4 classes, 128 x 160, batch 2, 64 sampled rois an image of which the
first 16 feed the mask branch, mask RoIAlign 14 x 14, mask head 32 wide)
built on both sides from the same Flax params (the mask logit kernel
scaled by 0.05, as tests/test_torch_mask.py scales it, so that the
probabilities spread over (0, 1)): the train losses, maskiou_loss among
them (1e-5 relative), the sampled labels (exactly), every
gradient (1e-4 of its max), a 3-step SGD trajectory (1e-4) and the test
forward (the kept detections, their mask probabilities and mask_score =
score * predicted IoU, 1e-4; the class logits scaled by 100 there, so that
the scores stand apart for the NMS). The premise of the gradients, asserted
as in tests/test_torch_mask.py: the RoIAlign takes each bin's max at the
same samples from the JAX pyramid as from the port's, at 7 x 7 and at
14 x 14. The JAX side compiles its value_and_grad (which also captures its
pyramid) and its test forward once each, in module-scoped fixtures.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledet_tpu.models import fpn as jfpn
from simpledet_tpu.models import heads as jheads
from simpledet_tpu.models import msrcnn as jms
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models.mask_rcnn import MaskHead4Conv as JMaskHead4Conv
from simpledet_tpu.models.norm import normalizer_factory as j_norm
from simpledet_tpu.models.rpn import FPNRpnHead as JRpnHead
from simpledet_torch.core.train import Trainer
from simpledet_torch.kernels.roi_align import multilevel_roi_align_plain
from simpledet_torch.models import msrcnn
from simpledet_torch.models.fpn import FPNNeck
from simpledet_torch.models.heads import Bbox2fcHead
from simpledet_torch.models.mask_rcnn import MaskHead4Conv
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.rpn import FPNRpnHead, RpnConvHead
from simpledet_torch.weights import flax_leaf, flax_path, from_flax

from rcnn_parity import (B, DET_RTOL, FILTERS, FIXED, GRAD_RTOL, LOSS_RTOL,
                         MEAN, NUM_CLASS, SEED_KEY, STD, check_gradients,
                         flat, gt_and_polys, images, jax_sampling_patches,
                         neck_filter, normalised_jax, normalised_torch,
                         param_classes, rel_err, schedule, seeded, t,
                         trajectory)

STRIDES = (4, 8, 16, 32)
NUM_FG, MASK = 16, 28
IMAGE_SEED, PARAM_SEED = 2, 0
HEAD_STDS = {"cls_logit": 0.01, "bbox_delta": 0.001, "iou_head_pred": 0.01}
TRAJECTORY_LR = 0.01


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module's tests run: the tier-1
    command runs 6 test workers on the CPU's cores, and torch's default of
    a thread a core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ targets and the MaskIoU head


def test_polygon_area_matches_jax():
    """The shoelace area of packed edges with padding rows, within 1e-6."""
    _, gt_poly = gt_and_polys()
    want = np.asarray(jms.polygon_area(jnp.asarray(gt_poly)))
    got = msrcnn.polygon_area(t(gt_poly))
    assert rel_err(got, want) <= 1e-6
    # the ellipse of gt (0, 0), 60 x 58, is a 16-gon inside it
    assert 0.95 * np.pi * 30 * 29 < want[0, 0] < np.pi * 30 * 29


def test_maskiou_target_matches_jax():
    """IoU targets and weights of random masks on 2 x 9 rows (some off the
    fg, one roi narrower than a cell) within 1e-6; some targets near 1 and
    the full-instance correction effective on a roi that crops its gt."""
    rng = np.random.RandomState(3)
    _, gt_poly = gt_and_polys()
    f = 9
    prob = rng.uniform(0, 1, (B, f, MASK, MASK)).astype(np.float32)
    tgt = (rng.uniform(0, 1, (B, f, MASK, MASK)) > 0.5).astype(np.float32)
    prob[0, 0] = tgt[0, 0] * 0.9 + 0.05                 # the same mask
    rois = np.concatenate([rng.uniform(0, 60, (B, f, 2)),
                           rng.uniform(70, 150, (B, f, 2))], -1)
    rois[0, 1] = [10, 12, 10.5, 40]                     # narrower than 1
    rois[1, 2] = [20, 10, 50, 40]                       # crops gt (1, 0)
    gt_index = rng.randint(0, 3, (B, f))
    gt_index[1, 2] = 0
    fg = rng.uniform(0, 1, (B, f)) > 0.3
    fg[0, :3] = fg[1, 2] = True
    args = (prob, tgt, rois.astype(np.float32), gt_poly, gt_index, fg)
    want = [np.asarray(w) for w in jax.jit(jax.vmap(jms.maskiou_target))(
        *map(jnp.asarray, args))]
    got = msrcnn.maskiou_target(*map(t, args))
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-6
    assert want[0][0, 0] > 0.99
    np.testing.assert_array_equal(want[1], fg.astype(np.float32))


def test_maskiou_head_matches_jax():
    """The head on converted weights: output within 1e-5, gradients of its
    parameters, its features and its mask logits within 1e-4 of their
    max."""
    rng = np.random.RandomState(4)
    feat = rng.randn(B, 5, 14, 14, FILTERS).astype(np.float32)
    logit = rng.randn(B, 5, MASK, MASK).astype(np.float32)
    jhead = jms.MaskIoUHead(num_class=NUM_CLASS, conv_channel=FILTERS)
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0),
                            jnp.asarray(feat), jnp.asarray(logit))["params"]
    params = seeded(shapes, rng, HEAD_STDS)
    sel = rng.randn(B, 5, NUM_CLASS).astype(np.float32)

    def loss(p, x, m):
        out = jhead.apply({"params": p}, x, m)
        return jnp.sum(out * sel), out

    (_, want), (gp, gx, gm) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(feat), jnp.asarray(logit))
    head = msrcnn.MaskIoUHead(NUM_CLASS, FILTERS, 14, FILTERS)
    from_flax(params, head)
    x, m = t(feat).requires_grad_(), t(logit).requires_grad_()
    out = head(x, m)
    assert out.shape == (B, 5, NUM_CLASS)
    assert rel_err(out.detach(), want) <= LOSS_RTOL
    (out * t(sel)).sum().backward()
    assert rel_err(x.grad, gx) <= GRAD_RTOL
    assert rel_err(m.grad, gm) <= GRAD_RTOL
    want_g = dict(flat(jax.tree.map(np.asarray, gp)))
    for name, prm in head.named_parameters():
        assert rel_err(flax_leaf(name, prm.grad.numpy()),
                       want_g[flax_path(name)]) <= GRAD_RTOL, name


# ------------------------------------------------------ the whole detector


def jax_model(p):
    p_rpn, p_roi, p_bbox, p_mask, p_mask_roi, p_test = p
    jrpn = JRpnHead(p_rpn)
    return jms.MaskScoringFasterRcnn(
        backbone=jresnet.ResNet(depth=18, norm=j_norm("fixbn"),
                                name="backbone"),
        neck=jfpn.FPNNeck(filters=FILTERS, name="neck"),
        rpn_module=jrpn.module, rpn=jrpn,
        bbox_head=jheads.Bbox2fcHead(num_class=NUM_CLASS,
                                     num_reg_class=NUM_CLASS,
                                     name="bbox_head"),
        p_rpn=p_rpn, p_roi=p_roi, p_bbox=p_bbox,
        mask_head=JMaskHead4Conv(num_class=NUM_CLASS, dim_reduced=FILTERS,
                                 name="mask_head"),
        p_mask=p_mask, p_mask_roi=p_mask_roi, p_test=p_test,
        maskiou_head=jms.MaskIoUHead(num_class=NUM_CLASS,
                                     conv_channel=FILTERS,
                                     name="maskiou_head")), jrpn


def torch_model(params, p, train=True):
    p_rpn, p_roi, p_bbox, p_mask, p_mask_roi, p_test = p
    backbone = ResNet(18)
    trpn = FPNRpnHead(p_rpn)
    model = msrcnn.MaskScoringFasterRcnn(
        backbone, FPNNeck(backbone.out_channels, FILTERS),
        RpnConvHead(trpn.num_anchor, FILTERS, FILTERS), trpn,
        Bbox2fcHead(NUM_CLASS, NUM_CLASS, 49 * FILTERS),
        MaskHead4Conv(NUM_CLASS, FILTERS, FILTERS), p_roi, p_bbox, p_mask,
        p_mask_roi, p_test, fixed_proposals=train,
        deterministic_sampling=train,
        maskiou_head=msrcnn.MaskIoUHead(NUM_CLASS, FILTERS, 14, FILTERS))
    from_flax(params, model)
    return model.to(memory_format=torch.channels_last).train(train)


@pytest.fixture(scope="module")
def setup():
    """The JAX side's losses, aux (with its pyramid) and gradients of one
    train forward, and its value_and_grad, compiled once."""
    p = param_classes()
    jmodel, jrpn = jax_model(p)
    data, im_info = images(IMAGE_SEED)
    gt, gt_poly = gt_and_polys()
    shapes = jax.eval_shape(
        lambda r, x, i: jmodel.init(r, x, i, mode="test"),
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros(data.shape), jnp.asarray(im_info))["params"]
    params = seeded(shapes, np.random.RandomState(PARAM_SEED), HEAD_STDS)
    params["mask_head"]["mask_fcn_logit"]["kernel"] *= 0.05
    s = dict(p=p, jmodel=jmodel, data=data, im_info=im_info, gt=gt,
             gt_poly=gt_poly, params=params)
    mp = jax_sampling_patches(jrpn, gt)
    x = normalised_jax(data, im_info)

    def loss_fn(prm):
        (losses, aux), inter = jmodel.apply(
            {"params": prm}, x, jnp.asarray(im_info), jnp.asarray(gt),
            jnp.asarray(gt_poly), mode="train", rngs={"sampling": SEED_KEY},
            capture_intermediates=neck_filter, mutable=["intermediates"])
        aux = dict(aux, pyramid=inter["intermediates"]["neck"]["__call__"][0])
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
    s = setup
    model = torch_model(s["params"], s["p"])
    losses, aux = model(normalised_torch(s["data"], s["im_info"]),
                        t(s["im_info"]), t(s["gt"]), t(s["gt_poly"]),
                        mode="train", generator=torch.Generator())
    sum(losses.values()).backward()
    return model, losses, aux


def test_no_bin_max_flips(setup, torch_step):
    """On the sampled rois (7 x 7) and their fg prefix (14 x 14), each bin's
    max is taken at the same samples from the JAX pyramid as from the
    port's."""
    model = torch_step[0]
    s = setup
    with torch.no_grad():
        pyr, sample, _, _ = model.box_branch(
            normalised_torch(s["data"], s["im_info"]), t(s["im_info"]),
            t(s["gt"]), torch.Generator())
    want = s["want"][1]["pyramid"]
    sides = ([pyr[f"stride{k}"].permute(0, 2, 3, 1).contiguous()
              for k in STRIDES], [t(want[f"stride{k}"]) for k in STRIDES])
    for rois, size in ((sample["rois"], 7),
                       (sample["rois"][:, :NUM_FG].contiguous(), 14)):
        codes = [multilevel_roi_align_plain(f, rois, STRIDES, out_size=size,
                                            with_codes=True)[1]
                 for f in sides]
        assert torch.equal(*codes), size


def test_train_losses_labels_and_targets_match(setup, torch_step):
    """The six losses within 1e-5 relative, maskiou_loss positive; the
    sampled labels identical; fg rows in the mask targets on both images
    (the targets themselves: tests/test_torch_mask.py)."""
    want, want_aux, _ = setup["want"]
    _, losses, aux = torch_step
    assert set(losses) == set(want) == {
        "rpn_cls_loss", "rpn_reg_loss", "bbox_cls_loss", "bbox_reg_loss",
        "mask_loss", "maskiou_loss"}
    for k, v in want.items():
        assert rel_err(losses[k].detach(), v) <= LOSS_RTOL, k
    assert float(want["maskiou_loss"]) > 0
    np.testing.assert_array_equal(aux["bbox_label"].numpy(),
                                  want_aux["bbox_label"])
    target = aux["mask_target"].numpy()
    assert target.shape == (B, NUM_FG, MASK, MASK)
    assert (target >= 0).all((2, 3)).any(1).all()


def test_every_gradient_matches_jax_grad(setup, torch_step):
    """Each parameter's gradient, the MaskIoU head's among them, within 1e-4
    of its max |grad| of jax.grad; the mask head's logit kernel receives
    the MaskIoU loss's gradient through the pooled logits, as in JAX."""
    got = check_gradients(setup["want"][2], torch_step[0], flax_leaf)
    assert np.abs(got["maskiou_head/iou_head_conv_0/kernel"]).max() > 0


def test_sgd_trajectory_matches(setup):
    """Three SGD steps at lr 0.01 on both sides (`trajectory`), gt_poly in
    the batch."""
    s = setup
    trainer = Trainer(torch_model(s["params"], s["p"]), schedule=schedule(
        TRAJECTORY_LR), fixed_param=FIXED, momentum=0.9, wd=1e-4,
        pixel_norm=(MEAN, STD))
    trajectory(s["loss_and_grad"], s["params"], trainer,
               (t(s["data"]), t(s["im_info"]), t(s["gt"]), t(s["gt_poly"])),
               TRAJECTORY_LR)


@pytest.fixture(scope="module")
def test_outputs(setup):
    s = setup
    params = jax.tree.map(np.array, s["params"])
    params["bbox_head"]["cls_logit"]["kernel"] *= 100.0
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
    """The same kept detections and classes; their boxes, scores, mask
    probabilities and mask scores within 1e-4 of their scale; detections on
    each image, mask scores below the scores."""
    want, got = test_outputs
    assert set(got) == set(want) == {"cls_score", "bbox_xyxy", "cls",
                                     "det_valid", "mask_prob", "mask_score"}
    np.testing.assert_array_equal(got["det_valid"].numpy(),
                                  want["det_valid"])
    np.testing.assert_array_equal(got["cls"].numpy(), want["cls"])
    for k in ("cls_score", "bbox_xyxy", "mask_prob", "mask_score"):
        assert got[k].shape == want[k].shape
        assert rel_err(got[k].numpy(), want[k]) <= DET_RTOL, k
    valid = want["det_valid"]
    assert valid.any(1).all()
    assert (np.abs(want["mask_score"][valid])
            < want["cls_score"][valid]).all()
