"""The port's Faster R-CNN test path against the JAX package, on the CPU.

A small detector (depth-18 bottleneck ResNet, FPN filters 64, 5 classes,
pre/post NMS 128/64) is built from components on both sides with the same
Flax params, mapped by `weights.from_flax`. It is held stage by stage, each
discrete stage fed the JAX stage's output (so that ulp-level conv differences
cannot flip a top-k or NMS decision), and end to end. The full-width config
is read, built and mapped without edits.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledet_tpu.eval.postprocess import per_class_nms as j_per_class_nms
from simpledet_tpu.models import fpn as jfpn
from simpledet_tpu.models import heads as jheads
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models.faster_rcnn import FasterRcnn as JFasterRcnn
from simpledet_tpu.models.norm import normalizer_factory
from simpledet_tpu.models.rpn import FPNRpnHead as JRpnHead
from simpledet_tpu.ops.image import device_normalize as j_normalize
from simpledet_torch.core.config import patch_config_as_nothrow, read_config
from simpledet_torch.dsl import build_detector
from simpledet_torch.eval.postprocess import per_class_nms
from simpledet_torch.models.faster_rcnn import FasterRcnn
from simpledet_torch.models.fpn import FPNNeck
from simpledet_torch.models.heads import Bbox2fcHead
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.rpn import FPNRpnHead, RpnConvHead
from simpledet_torch.ops.image import device_normalize
from simpledet_torch.weights import from_flax

FLAGSHIP = "config/faster_r50v1_fpn_1x.py"
MEAN, STD = (122.7717, 115.9465, 102.9801), (1.0, 1.0, 1.0)
FILTERS, NUM_CLASS, B, H, W = 64, 5, 2, 96, 128


def rel_close(got, want, rtol):
    """|got - want| <= rtol * max|want|: float32 convolutions summed in
    another order differ in proportion to the tensor's scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f"relative error {err:.3g} > {rtol}"


# fp32 convs and matmuls on both sides, summed in different orders (XLA's
# and oneDNN's): a depth-18 backbone accumulates a few ulps per layer, so the
# continuous stages are held to 1e-5 of each tensor's scale.
CONT = 1e-5


def params_classes():
    class RpnParam:
        class anchor_generate:
            scale = (8,)
            ratio = (0.5, 1.0, 2.0)
            stride = (4, 8, 16, 32, 64)

        class head:
            conv_channel = FILTERS

        class proposal:
            pre_nms_top_n = 128
            post_nms_top_n = 64
            nms_thr = 0.7
            min_bbox_side = 0

    class RoiParam:
        out_size = 7
        stride = (4, 8, 16, 32)
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
def pair():
    """(jax model, its params, torch model, uint8 batch, im_info)."""
    p_rpn, p_roi, p_bbox = params_classes()
    p_rpn.dtype = jnp.float32
    jrpn = JRpnHead(p_rpn)
    jmodel = JFasterRcnn(
        backbone=jresnet.ResNet(depth=18, norm=normalizer_factory("fixbn"),
                                name="backbone"),
        neck=jfpn.FPNNeck(filters=FILTERS, name="neck"),
        rpn_module=jrpn.module, rpn=jrpn,
        bbox_head=jheads.Bbox2fcHead(num_class=NUM_CLASS,
                                     num_reg_class=NUM_CLASS,
                                     name="bbox_head"),
        p_rpn=p_rpn, p_roi=p_roi, p_bbox=p_bbox)
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8)
    im_info = np.float32([[H, W, 1.0], [80, 100, 1.0]])
    params = jmodel.init({"params": jax.random.PRNGKey(0),
                          "sampling": jax.random.PRNGKey(1)},
                         jnp.zeros((B, H, W, 3)), jnp.asarray(im_info),
                         mode="test")["params"]
    params = jax.tree.map(np.asarray, params)
    # FrozenBN starts as the identity; random folded stats keep activations
    # of order one through the depth and exercise the buffers' mapping
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
                         if path[-1].key == "scale" else
                         rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
                         if path[-1].key == "bias" and v.ndim == 1
                         and "bn" in path[-2].key else v), params)

    backbone = ResNet(18)
    trpn = FPNRpnHead(p_rpn)
    tmodel = FasterRcnn(backbone, FPNNeck(backbone.out_channels, FILTERS),
                        RpnConvHead(trpn.num_anchor, FILTERS, FILTERS), trpn,
                        Bbox2fcHead(NUM_CLASS, NUM_CLASS, 49 * FILTERS),
                        p_roi, p_bbox)
    from_flax(params, tmodel)
    tmodel = tmodel.to(memory_format=torch.channels_last).eval()
    return jmodel, params, tmodel, data, im_info


def _j(jmodel, params, fn, *args):
    return jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a,
                                              method=fn))(params, *args)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def jax_stages(pair):
    """The JAX package's outputs of every stage (crop RoIAlign, which applies
    the long-side clamp as the TPU kernel does)."""
    jmodel, params, _, data, im_info = pair
    mp = pytest.MonkeyPatch()
    mp.setenv("SIMPLEDET_ROI_ALIGN", "crop")
    try:
        d = j_normalize(jnp.asarray(data), jnp.asarray(im_info), MEAN, STD)
        pyr = _j(jmodel, params, lambda m, x: m.pyramid(x), d)
        rpn = _j(jmodel, params, lambda m, p: m.rpn_module(p), pyr)
        props, pscore = jax.jit(lambda r, i: jmodel.rpn.proposals(
            r, i, (H, W), False))(rpn, jnp.asarray(im_info))
        feat = _j(jmodel, params, lambda m, p, r: m.extract_rois(p, r),
                  pyr, props)
        cls, delta = _j(jmodel, params, lambda m, f: m.bbox_head(f), feat)
        score, boxes = jheads.bbox_head_predict(
            cls, delta, props, jnp.asarray(im_info),
            bbox_mean=(0.0,) * 4, bbox_std=(0.1, 0.1, 0.2, 0.2),
            class_agnostic=False, num_class=NUM_CLASS)
        full = jax.jit(lambda p, x, i: jmodel.apply({"params": p}, x, i,
                                                    mode="test"))(
            params, d, jnp.asarray(im_info))
    finally:
        mp.undo()
    return dict(data=d, pyr=pyr, rpn=rpn, props=props, pscore=pscore,
                feat=feat, cls=cls, delta=delta, score=score, boxes=boxes,
                full=full)


def test_normalised_input(pair, jax_stages):
    _, _, _, data, im_info = pair
    got = device_normalize(_t(data), _t(im_info), MEAN, STD)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_stages["data"]))


def test_pyramid(pair, jax_stages):
    tmodel = pair[2]
    got = tmodel.pyramid(_t(jax_stages["data"]))
    assert set(got) == set(jax_stages["pyr"])
    for k, v in jax_stages["pyr"].items():
        if k != "stride64":     # P6 is a strided view of P5
            assert got[k].is_contiguous(memory_format=torch.channels_last)
        rel_close(got[k].permute(0, 2, 3, 1).detach(), v, CONT)


def test_rpn_head(pair, jax_stages):
    tmodel = pair[2]
    pyr = {k: _nchw(v) for k, v in jax_stages["pyr"].items()}
    with torch.no_grad():
        got = tmodel.rpn_module(pyr)
    for k, (cls, reg) in jax_stages["rpn"].items():
        rel_close(got[k][0].permute(0, 2, 3, 1), cls, CONT)
        rel_close(got[k][1].permute(0, 2, 3, 1), reg, CONT)


def test_rpn_proposals(pair, jax_stages):
    """Teacher-forced: the JAX head's outputs in, identical proposals out
    (boxes to 1e-4 px: decode rounds the same float32 operations)."""
    _, _, tmodel, _, im_info = pair
    rpn = {k: (_nchw(c), _nchw(r)) for k, (c, r) in jax_stages["rpn"].items()}
    boxes, scores = tmodel.rpn.proposals(rpn, _t(im_info))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jax_stages["pscore"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jax_stages["props"]),
                               rtol=0, atol=1e-4)


def test_roi_features(pair, jax_stages):
    tmodel = pair[2]
    pyr = {k: _nchw(v) for k, v in jax_stages["pyr"].items()}
    got = tmodel.extract_rois(pyr, _t(jax_stages["props"]))
    rel_close(got, jax_stages["feat"], CONT)


def test_box_head_and_predict(pair, jax_stages):
    _, _, tmodel, _, im_info = pair
    with torch.no_grad():
        cls, delta = tmodel.bbox_head(_t(jax_stages["feat"]))
    rel_close(cls, jax_stages["cls"], CONT)
    rel_close(delta, jax_stages["delta"], CONT)
    score, boxes = tmodel.predict(_t(jax_stages["cls"]),
                                  _t(jax_stages["delta"]),
                                  _t(jax_stages["props"]), _t(im_info))
    np.testing.assert_allclose(score.numpy(), np.asarray(jax_stages["score"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jax_stages["boxes"]),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("score_thr", [0.05, 0.0])
def test_per_class_nms(jax_stages, score_thr):
    """Teacher-forced: identical detections, rows and classes."""
    s, b = jax_stages["score"], jax_stages["boxes"]
    want = jax.vmap(lambda ss, bb: j_per_class_nms(
        ss, bb, score_thr=score_thr, nms_thr=0.5, max_det=100))(s, b)
    got = per_class_nms(_t(s), _t(b), score_thr=score_thr, nms_thr=0.5,
                        max_det=100)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].any()


def test_test_forward_end_to_end(pair, jax_stages):
    """One whole mode="test" forward from the uint8 batch. Continuous outputs
    within 1e-4 of their scale: conv sums differ by ulps, which moves box
    coordinates slightly but, for these inputs, flips no top-k or NMS
    decision (the proposals are checked to be the same rows first)."""
    _, _, tmodel, data, im_info = pair
    d = device_normalize(_t(data), _t(im_info), MEAN, STD)
    out = tmodel(d, _t(im_info), mode="test")
    full = jax_stages["full"]
    assert set(out) == set(full)
    np.testing.assert_allclose(out["rois"].numpy(), np.asarray(full["rois"]),
                               rtol=0, atol=1e-2)
    for key in ("roi_score", "cls_score", "bbox_xyxy"):
        rel_close(out[key], full[key], 1e-4)


def test_rpn_test_mode(pair, jax_stages):
    _, _, tmodel, _, im_info = pair
    out = tmodel(_t(jax_stages["data"]), _t(im_info), mode="rpn_test")
    np.testing.assert_allclose(out["proposal"].numpy(),
                               np.asarray(jax_stages["full"]["rois"]),
                               rtol=0, atol=1e-2)
    rel_close(out["proposal_score"], jax_stages["full"]["roi_score"], 1e-4)


# ------------------------------------------------------------- full width


def test_flagship_config_builds_and_maps_all_leaves():
    """The port reads the flagship config unedited, and from_flax maps all
    189 leaves of the JAX model's param tree with equal shapes."""
    from simpledet_tpu.core.config import load_config as j_load_config

    spec = read_config(FLAGSHIP)
    assert spec.pixel_norm == (MEAN, STD)
    assert spec.test.nms.thr == 0.5 and spec.test.max_det_per_image == 100
    model = build_detector(spec)
    jmodel = j_load_config(FLAGSHIP).get_config(is_train=False)[6].test_symbol
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros((1, 128, 160, 3)), jnp.asarray([[128, 160, 1.0]]),
        mode="test"))["params"]
    leaves = jax.tree_util.tree_leaves(shapes)
    assert len(leaves) == 189
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    from_flax(params, model)
    assert len(model.state_dict()) == 189
    w = model.state_dict()["bbox_head.fc1.weight"]
    np.testing.assert_array_equal(w.numpy(),
                                  params["bbox_head"]["fc1"]["kernel"].T)
    with pytest.raises(KeyError):
        from_flax({**params, "extra": {"kernel": np.zeros((1, 1))}}, model)


@pytest.mark.parametrize("path,what", [
    # detectors whose components the reader has no roles for (FCOS on the
    # RPN detector, FreeAnchor's head, TSD and Mask Scoring R-CNN are read
    # and built since they were ported)
    ("config/crowdhuman/faster_emd_r50v1_fpn_1x.py", "DoublePredRcnn"),
    ("config/crowdhuman/doublepred_r50v1b_fpn_1x.py", "DoublePredRcnn"),
    # a backbone the port does not have
    ("config/efficientnet/efficientnet_b5_fpn_bn_scratch_400_12x.py",
     "EfficientNetB5FPN"),
    # a mask head the port does not have (the DCN backbones and the PAFPN
    # and FPG necks are read and built since they were ported)
    ("config/se/mask_se_r50v1_fpn_1x.py", "MaskRcnnSe4convHead"),
    # a config template that the port's copy does not hold
    ("config/cascade_r50v2_c5_red_1x.py", "cascade_c5_red_config"),
    # a detector whose components the reader has no roles for: it raises
    # rather than keeping the first five (its train symbol has a sixth)
    ("config/converge_kd.py", "FitNetFasterRcnn"),
])
def test_unported_configs_raise_naming_what_is_missing(path, what):
    import symbol.builder   # the real shim stays in place around the reader
    real = sys.modules["symbol.builder"]
    with pytest.raises(NotImplementedError, match=what):
        build_detector(read_config(path))
    assert sys.modules["symbol.builder"] is real is symbol.builder


def test_flagship_forward_on_cpu():
    """Torch only, full width at 128 x 160: finite outputs of the right
    shapes."""
    from simpledet_torch.infer import Detector, synthetic_batch

    det = Detector(FLAGSHIP, device="cpu", seed=0)
    images, im_info = synthetic_batch(1, 128, 160, 0)
    out = det.model(device_normalize(images, im_info, MEAN, STD), im_info)
    assert out["cls_score"].shape == (1, 1000, 81)
    assert out["bbox_xyxy"].shape == (1, 1000, 324)
    assert out["rois"].shape == (1, 1000, 4)
    for v in out.values():
        assert torch.isfinite(v).all()
    boxes, scores, classes, valid = det.detect(images, im_info)
    assert boxes.shape == (1, 100, 4) and valid.any()
    assert ((classes[valid] >= 1) & (classes[valid] <= 80)).all()
    (one,) = det(images, im_info)
    assert torch.equal(one["classes"], classes[0][valid[0]])
    assert one["boxes"].shape == (int(valid[0].sum()), 4)


def test_detector_reads_min_det_score_0_as_the_jax_package(tmp_path):
    """A config whose TestParam.min_det_score is 0 (as the RetinaNet and
    RepPoints configs set it): the JAX package's CLIs read
    `min_det_score or 0.05`, and so does the port's Detector."""
    from simpledet_torch.infer import Detector

    cfg = tmp_path / "score0.py"
    cfg.write_text(
        "import importlib.util\n"
        f"_s = importlib.util.spec_from_file_location('_flag', {FLAGSHIP!r})\n"
        "_m = importlib.util.module_from_spec(_s)\n"
        "_s.loader.exec_module(_m)\n\n\n"
        "def get_config(is_train):\n"
        "    out = _m.get_config(is_train)\n"
        "    out[8].min_det_score = 0\n"
        "    return out\n")
    det = Detector(str(cfg), device="cpu")
    assert det.spec.test.min_det_score == 0
    assert det.score_thr == 0.05
