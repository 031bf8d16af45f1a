"""The port's RPN-only detector and its proposal-recall CLI against the JAX
package, on the CPU.

A small RpnOnly (depth-18 bottleneck ResNet with FrozenBN, FPN 64 wide,
96 x 128 images, batch 2, 256 sampled anchors an image, pre/post NMS
256/128) is built on both sides with the same Flax params: its train losses
(the anchor sampler on `arange` priorities on both sides: the JAX package's
`_priorities` patched, the port's `deterministic_sampling`), every gradient
against jax.grad, and its proposals. `recall_at` against `rpn_test.recall_at`;
`python -m simpledet_torch.rpn_test` against `rpn_test.rpn_test_net` on
config/micro_test.py and the synthetic micro-COCO, both from one JAX-written
checkpoint (seeded weights differ between the packages); and
config/rpn_r50v1_fpn_1x.py read (its `class _RpnDetector(RPN)` as the RPN
detector) and built, every leaf of the JAX model mapped.
"""
import os
import pickle

import flax.linen
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import make_micro_dataset
from simpledet_tpu.core.checkpoint import save_checkpoint as j_save
from simpledet_tpu.models import fpn as jfpn
from simpledet_tpu.models import resnet as jresnet
from simpledet_tpu.models.faster_rcnn import RpnOnly as JRpnOnly
from simpledet_tpu.models.norm import normalizer_factory
from simpledet_tpu.models.rpn import FPNRpnHead as JRpnHead
from simpledet_tpu.ops.image import device_normalize as j_normalize
from simpledet_tpu.targets import sampling as jsampling
from simpledet_torch.core import checkpoint as ckpt
from simpledet_torch.core.config import patch_config_as_nothrow, read_config
from simpledet_torch.data.loader import Loader
from simpledet_torch.data.roidb import load_roidb
from simpledet_torch.data.transforms import from_config
from simpledet_torch.dsl import build_detector
from simpledet_torch.models.faster_rcnn import RpnOnly
from simpledet_torch.models.fpn import FPNNeck
from simpledet_torch.models.norm import fold_batch_stats
from simpledet_torch.models.resnet import ResNet
from simpledet_torch.models.rpn import FPNRpnHead, RpnConvHead
from simpledet_torch.ops.image import device_normalize
from simpledet_torch.rpn_test import recall_at
from simpledet_torch.weights import flax_path, from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = os.path.join(REPO, "config", "micro_test.py")
RPN_CONFIG = "config/rpn_r50v1_fpn_1x.py"
MEAN, STD = (122.7717, 115.9465, 102.9801), (1.0, 1.0, 1.0)
FILTERS, B, H, W = 64, 2, 96, 128
SEED_KEY = jax.random.PRNGKey(3)
# as tests/test_torch_train.py: losses 1e-5 relative, gradients 1e-4 of
# each leaf's max |grad|, proposal scores 1e-4 of their scale and boxes
# within 1e-2 px (tests/test_torch_model.py)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module's tests run: the tier-1
    command runs 6 test workers on the CPU's cores, and torch's default of
    a thread a core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rpn_param():
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

    return patch_config_as_nothrow(RpnParam)


def torch_model(params, p_rpn, train=True):
    backbone = ResNet(18)
    rpn = FPNRpnHead(p_rpn)
    model = RpnOnly(backbone, FPNNeck(backbone.out_channels, FILTERS),
                    RpnConvHead(rpn.num_anchor, FILTERS, FILTERS), rpn,
                    deterministic_sampling=True)
    from_flax(params, model)
    return model.to(memory_format=torch.channels_last).train(train)


@pytest.fixture(scope="module")
def setup():
    p_rpn = rpn_param()
    p_rpn.dtype = jnp.float32
    jrpn = JRpnHead(p_rpn)
    jmodel = JRpnOnly(
        backbone=jresnet.ResNet(depth=18, norm=normalizer_factory("fixbn"),
                                name="backbone"),
        neck=jfpn.FPNNeck(filters=FILTERS, name="neck"),
        rpn_module=jrpn.module, rpn=jrpn)
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8)
    im_info = np.float32([[H, W, 1.0], [80, 100, 1.0]])
    gt = np.full((B, 8, 5), -1, np.float32)
    gt[0, :3] = [[10, 12, 60, 70, 1], [50, 20, 120, 90, 3], [5, 40, 40, 94, 4]]
    gt[1, :2] = [[20, 10, 90, 60, 2], [0, 30, 50, 79, 1]]
    params = jax.jit(lambda r, x, i: jmodel.init(r, x, i, mode="test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros((B, H, W, 3)), jnp.asarray(im_info))["params"]
    params = jax.tree.map(np.asarray, params)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
                         if path[-1].key == "scale" else
                         rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
                         if path[-1].key == "bias" and v.ndim == 1
                         and "bn" in path[-2].key else v), params)
    # the objectness logits scaled apart: no near-tie for the top-k or the
    # NMS to break differently
    params["rpn_module"]["rpn_cls"]["kernel"] = \
        params["rpn_module"]["rpn_cls"]["kernel"] * 300.0
    return dict(jmodel=jmodel, params=params, data=data, im_info=im_info,
                gt=gt, p_rpn=p_rpn)


def _normalised(s):
    return j_normalize(jnp.asarray(s["data"]), jnp.asarray(s["im_info"]),
                       MEAN, STD)


@pytest.fixture(scope="module")
def jax_side(setup):
    """The JAX train losses and gradients (arange priorities while traced)
    and its test-mode proposals."""
    s = setup
    mp = pytest.MonkeyPatch()
    mp.setattr(jsampling, "_priorities",
               lambda rng, n, deterministic: jnp.arange(n, dtype=jnp.float32))
    data = _normalised(s)

    def loss_fn(params):
        losses, aux = s["jmodel"].apply(
            {"params": params}, data, jnp.asarray(s["im_info"]),
            jnp.asarray(s["gt"]), mode="train", rngs={"sampling": SEED_KEY})
        return sum(losses.values()), (losses, aux)

    try:
        (_, (losses, aux)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(s["params"])
        props = jax.jit(lambda p, d, i: s["jmodel"].apply(
            {"params": p}, d, i, mode="test"))(s["params"], data,
                                               jnp.asarray(s["im_info"]))
    finally:
        mp.undo()
    return jax.tree.map(np.asarray, (losses, aux, grads, props))


@pytest.fixture(scope="module")
def torch_step(setup):
    s = setup
    model = torch_model(s["params"], s["p_rpn"])
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    losses, aux = model(data, _t(s["im_info"]), _t(s["gt"]), mode="train",
                        generator=torch.Generator())
    sum(losses.values()).backward()
    return model, losses, aux


def test_rpn_only_train_losses_and_labels_match(jax_side, torch_step):
    """Both RPN losses within 1e-5 relative; the sampled anchor labels
    identical (positives among them)."""
    want, want_aux, _, _ = jax_side
    _, losses, aux = torch_step
    assert set(losses) == set(want) == {"rpn_cls_loss", "rpn_reg_loss"}
    for k, v in want.items():
        assert rel_err(losses[k].detach(), v) <= LOSS_RTOL, k
    np.testing.assert_array_equal(aux["rpn_label"].numpy(),
                                  want_aux["rpn_label"])
    assert (want_aux["rpn_label"] == 1).sum() >= 5


def test_rpn_only_every_gradient_matches_jax_grad(jax_side, torch_step):
    """Each parameter's gradient within 1e-4 of its leaf's max |grad|; the
    model holds the backbone, neck and RPN head and nothing else."""
    _, _, grads, _ = jax_side
    model = torch_step[0]
    want = dict(_flat(grads))
    assert {k.split("/")[0] for k in want} == {"backbone", "neck",
                                               "rpn_module"}
    errs = {}
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        g = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
        errs[name] = rel_err(g, want[flax_path(name)])
    assert len(errs) == sum(1 for k in want if not k.endswith("scale")
                            and "bn" not in k.split("/")[-2])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


@pytest.mark.parametrize("mode", ["test", "rpn_test"])
def test_rpn_only_proposals_match(setup, jax_side, mode):
    """Modes "test" and "rpn_test" both give the proposals: boxes within
    1e-2 px, scores within 1e-4 of their scale, the same rows valid."""
    s = setup
    want = jax_side[3]
    model = torch_model(s["params"], s["p_rpn"], train=False)
    data = device_normalize(_t(s["data"]), _t(s["im_info"]), MEAN, STD)
    out = model(data, _t(s["im_info"]), mode=mode)
    assert set(out) == set(want) == {"proposal", "proposal_score"}
    assert out["proposal"].shape == (B, 128, 4)
    valid = want["proposal_score"] > -1e9
    np.testing.assert_array_equal(out["proposal_score"].numpy() > -1e9,
                                  valid)
    np.testing.assert_allclose(out["proposal"].numpy(), want["proposal"],
                               rtol=0, atol=1e-2)
    assert rel_err(out["proposal_score"].numpy()[valid],
                   want["proposal_score"][valid]) <= 1e-4
    assert valid.sum() > 100


# ---------------------------------------------------------------- recall


def _recall_cases():
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 200, (40, 2))
    props = np.concatenate([xy, xy + rng.uniform(10, 90, (40, 2))], 1)
    gt = props[[3, 17, 30]] + rng.uniform(-6, 6, (3, 4))
    return {"no gt": (np.zeros((0, 4)), props),
            "no proposals": (gt, np.zeros((0, 4))),
            "jittered": (gt, props),
            "far": (gt + 500.0, props)}


@pytest.mark.parametrize("case", list(_recall_cases()))
@pytest.mark.parametrize("thr", [0.5, 0.75, 0.9])
def test_recall_at_matches_rpn_test(case, thr):
    from rpn_test import recall_at as j_recall_at

    gt, props = _recall_cases()[case]
    assert recall_at(gt, props, thr) == j_recall_at(gt, props, thr)


# -------------------------------------------------------------- configs


def test_rpn_config_reads_as_the_rpn_detector_and_maps_every_leaf():
    """config/rpn_r50v1_fpn_1x.py (its `_RpnDetector(RPN)` calls
    `RPN._assemble`): read as the RPN detector with the flagship's
    backbone, neck and RPN head in both modes, built as RpnOnly, every leaf
    of the JAX model's tree mapped with its shape."""
    from simpledet_tpu.core.config import load_config as j_load_config

    for is_train in (True, False):
        spec = read_config(RPN_CONFIG, is_train=is_train)
        assert spec.detector == "RPN"
        assert {k: v.name for k, v in spec.components.items()} == {
            "backbone": "MSRAResNet50V1FPN", "neck": "FPNNeck",
            "rpn_head": "FPNRpnHead"}
    assert spec.components["rpn_head"].param.proposal.post_nms_top_n == 1000
    model = build_detector(spec)
    assert isinstance(model, RpnOnly)
    jmodel = j_load_config(RPN_CONFIG).get_config(is_train=False)[6] \
        .test_symbol
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros((1, 128, 160, 3)), jnp.asarray([[128, 160, 1.0]]),
        mode="test"))["params"]
    from_flax(jax.tree.map(lambda v: np.zeros(v.shape, np.float32), shapes),
              model)
    assert len(model.state_dict()) == len(jax.tree_util.tree_leaves(shapes))


def test_only_a_detector_assembles(tmp_path):
    """The RPN config with its components assembled by the backbone's class
    in place of RPN: neither the JAX package nor the reader has
    `_assemble` on a component that is not a detector."""
    from simpledet_tpu.core.config import load_config as j_load_config

    with open(RPN_CONFIG) as f:
        text = f.read()
    old = "return RPN._assemble(backbone, neck, rpn_head)"
    assert text.count(old) == 3
    path = tmp_path / "backbone_assembles.py"
    path.write_text(text.replace(
        old, "return type(backbone)._assemble(backbone, neck, rpn_head)"))
    with pytest.raises(AttributeError, match="_assemble"):
        j_load_config(str(path)).get_config(is_train=False)
    with pytest.raises(AttributeError, match="_assemble"):
        read_config(str(path), is_train=False)


# ------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """The micro-COCO, its val set cut to the 4 landscape images (one
    padded shape, so the JAX side compiles one forward)."""
    root = tmp_path_factory.mktemp("micro")
    make_micro_dataset(str(root), n_images=8)
    with open(root / "cache" / "micro_val.roidb", "rb") as f:
        val = [r for r in pickle.load(f) if r["h"] < r["w"]]
    with open(root / "cache" / "micro_val.roidb", "wb") as f:
        pickle.dump(val, f)
    return root


def _template_init():
    """Flax's Module.init as zeros of the shapes it would make
    (`jax.eval_shape` traces the model without compiling it)."""
    orig_init = flax.linen.Module.init

    def init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(
            lambda r, *x: orig_init(self, r, *x, **kwargs), rngs, *args)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    return init


def test_rpn_test_cli_matches_jax_rpn_test_net(micro, tmp_path, monkeypatch):
    """From one JAX-written checkpoint of config/micro_test.py with 1000
    proposals an image (pre and post NMS; the config's 64 reach no gt at
    seeded weights) and its backbone cut to depth 18 (a backbone class
    with `depth = 18`, as the converge configs' TinyBackbone), the port's
    seeded detector with one val batch's statistics folded into FrozenBN
    and its objectness logits scaled apart: `rpn_test.rpn_test_net` and
    `python -m simpledet_torch.rpn_test` on the first 2 images report the
    same recalls and log the same Recall lines."""
    from rpn_test import rpn_test_net as j_rpn_test_net
    from simpledet_torch.rpn_test import main

    monkeypatch.setenv("MICRO_DATA_ROOT", str(micro))
    monkeypatch.chdir(tmp_path)
    with open(MICRO) as f:
        text = f.read()
    config = str(tmp_path / "micro_test_1000.py")
    with open(config, "w") as f:
        f.write(text.replace("pre_nms_top_n = 128", "pre_nms_top_n = 1000")
                .replace("post_nms_top_n = 64", "post_nms_top_n = 1000")
                .replace("    backbone = Backbone(BackboneParam)",
                         "    class Backbone18(Backbone):\n"
                         "        depth = 18\n\n"
                         "    backbone = Backbone18(BackboneParam)"))
    spec = read_config(config)
    assert spec.components["rpn_head"].param.proposal.post_nms_top_n == 1000
    assert spec.components["backbone"].depth == 18
    model = build_detector(spec)
    model.init_weights(torch.Generator().manual_seed(0))
    roidb = load_roidb(spec.dataset.image_set, spec.dataset.cache_dir)
    batch = next(iter(Loader(roidb, from_config(spec.transform), 4,
                             shuffle=False, num_workers=0)))
    data = device_normalize(torch.from_numpy(batch["data"]),
                            torch.from_numpy(batch["im_info"]),
                            *spec.pixel_norm)
    fold_batch_stats(model.backbone, data.permute(0, 3, 1, 2))
    with torch.no_grad():
        model.rpn_module.rpn_cls.weight.mul_(300.0)
    j_save("experiments/micro_test/checkpoint", 1, ckpt.to_flax(model))
    # rpn_test_net's eager Flax init only makes the template that the
    # checkpoint replaces leaf by leaf: its shapes are enough
    monkeypatch.setattr(flax.linen.Module, "init", _template_init())
    want = j_rpn_test_net(config, max_images=2)
    log = tmp_path / "experiments" / "micro_test" / "log.txt"
    want_lines = [ln.split(" ", 2)[2] for ln in log.read_text().splitlines()
                  if "Recall@" in ln]
    log.unlink()
    got = main(["--config", config, "--max-images", "2", "--device",
                "cpu"])
    got_lines = [ln.split(" ", 2)[2] for ln in log.read_text().splitlines()
                 if "Recall@" in ln]
    assert got == want and set(got) == {100, 300, 1000}
    assert got_lines == want_lines and len(got_lines) == 3
    assert "loaded experiments/micro_test/checkpoint-0001.params" in \
        log.read_text()
    assert got[100] <= got[300] < got[1000] <= 1.0
