"""The port stands alone: it imports no JAX, no Flax and nothing of the JAX
package, even while it reads a config whose shims import them."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "simpledet_tpu",
             "tests", "tools", "fixtures")


def test_reading_and_building_imports_no_jax():
    code = (
        "import sys\n"
        "from simpledet_torch.dsl import detector_from_config\n"
        "model, spec = detector_from_config('config/faster_r50v1_fpn_1x.py',"
        " device='cpu')\n"
        "import simpledet_torch.infer, simpledet_torch.weights\n"
        "import simpledet_torch.train\n"
        "train, _ = detector_from_config('config/faster_r50v1_fpn_1x.py',"
        " device='cpu', is_train=True)\n"
        "assert train.training and train.rpn.p.proposal.post_nms_top_n == 2000\n"
        "import simpledet_torch.detection_train, simpledet_torch.detection_test\n"
        "import simpledet_torch.core.checkpoint\n"
        "bf16, _ = detector_from_config('config/faster_r50v1_fpn_bf16_1x.py',"
        " device='cpu')\n"
        "assert bf16.backbone.dtype is __import__('torch').bfloat16\n"
        "import simpledet_torch.parallel.dist, simpledet_torch.core.metrics\n"
        "import simpledet_torch.data.synthetic\n"
        "tiny, _ = detector_from_config('config/converge_test.py',"
        " device='cpu', is_train=True)\n"
        "assert len(tiny.backbone.units[0]) == 2\n"
        "for cfg in ('cascade_r50v1_fpn_1x', 'cascade_r101v1_fpn_1x'):\n"
        "    cascade, _ = detector_from_config(f'config/{cfg}.py',"
        " device='cpu', is_train=True)\n"
        "    assert len(cascade.heads) == 3\n"
        "import simpledet_torch.breakdown, simpledet_torch.mask_test\n"
        # the mask configs' test chain imports simpledet_tpu.data.transforms
        "for cfg, tr in (('mask_r50v1_fpn_1x', False), "
        "('converge_mask', True)):\n"
        "    mask, _ = detector_from_config(f'config/{cfg}.py',"
        " device='cpu', is_train=tr)\n"
        "    assert mask.mask_head is not None\n"
        # RetinaNet and the RPN-only detector: read, and built at depth 18
        # without the seeded init (no new full-width build)
        "from simpledet_torch.core.config import read_config\n"
        "from simpledet_torch.dsl import build_detector\n"
        "import simpledet_torch.rpn_test, simpledet_torch.models.retinanet\n"
        "import simpledet_torch.targets.retina_target\n"
        "for cfg in ('retina_r50v1_fpn_1x', 'retina_r101v1_fpn_1x', "
        "'retina_micro_test', 'converge_retina', 'rpn_r50v1_fpn_1x'):\n"
        "    for tr in (False, True):\n"
        "        net = build_detector(read_config(f'config/{cfg}.py', tr), "
        "depth=18)\n"
        "        assert type(net).__name__ in ('RetinaNet', 'RpnOnly'), cfg\n"
        # the v1b / v1d / R152 configs and mask_fpn_config, at depth 18
        # without the seeded init; micro_test's v1b / v1d backbones come
        # from `import simpledet_tpu.dsl`, served as a stand-in
        "import os, glob\n"
        "v1b = (['config/faster_r50v1b_fpn_1x.py'] + [c for c in "
        "sorted(glob.glob('config/resnet_v1b/*_r*v1[bd]_fpn_[12]x.py')) "
        "if os.path.basename(c).split('_')[0] in ('faster', 'mask', 'retina')] + "
        "sorted(glob.glob('config/scratch/mask_r50v1b_fpn_*_scratch_2x.py')))\n"
        "assert len(v1b) == 19, v1b\n"
        "for cfg in v1b:\n"
        "    for tr in (False, True):\n"
        "        net = build_detector(read_config(cfg, tr), depth=18)\n"
        "        assert net.backbone.variant in ('v1b', 'v1d'), cfg\n"
        # C4 and TridentNet (the multi-scale chain imports
        # simpledet_tpu.data.transforms, served by the port's), at depth 18
        "import simpledet_torch.models.tridentnet\n"
        "for cfg in ('tridentnet_r50v2c4_c5_1x', 'converge_trident', "
        "'faster_r50v1c4_c5_512roi_1x_fp16', 'rpn_r50v2c4_1x', "
        "'resnet_v1b/tridentnet_fast_r50v1bc4_c5_1x', "
        "'tridentnet_r101v2c4_c5_multiscale_addminival_3x_fp16'):\n"
        "    for tr in (False, True):\n"
        "        net = build_detector(read_config(f'config/{cfg}.py', tr), "
        "depth=18)\n"
        "        assert net.backbone.out_channels == 1024, cfg\n"
        # DCN, NAS-FPN / TDBU and SEPC, at depth 18 on the meta device
        "import simpledet_torch.models.dcn, simpledet_torch.models.nasfpn\n"
        "import simpledet_torch.models.sepc, simpledet_torch.ops.deform_conv\n"
        "import torch\n"
        "for cfg in ('dcn/faster_dcnv2_r50v1bc4_c5_512roi_1x', "
        "'dcn/faster_dcn_r50v1b_fpn_1x', 'NASFPN/retina_r50v1b_nasfpn_640_"
        "7@256_25epoch', 'NASFPN/retina_r50v1b_tdbu_640_3@384_25epoch', "
        "'sepc/retina_r50v1b_fpn_sepc_1x', 'sepc/retina_r50v1b_fpn_1x', "
        "'converge_sepc', 'converge_nasfpn'):\n"
        "    for tr in (False, True):\n"
        "        spec = read_config(f'config/{cfg}.py', tr)\n"
        "        with torch.device('meta'):\n"
        "            net = build_detector(spec, depth=18)\n"
        "        assert type(net).__name__ in ('RetinaNet', "
        "'TridentFasterRcnn', 'FasterRcnn'), cfg\n"
        # FCOS, RepPoints (the DCN one) and FreeAnchor, at depth 18 on the
        # meta device
        "import simpledet_torch.models.fcos, simpledet_torch.ops.points\n"
        "import simpledet_torch.models.reppoints\n"
        "import simpledet_torch.models.freeanchor\n"
        "for cfg, kind in (('fcos_r50v1_fpn_1x', 'FCOS'), "
        "('RepPoints/reppoints_moment_dcn_r101v1b_fpn_multiscale_2x', "
        "'RepPoints'), ('FreeAnchor/free_anchor_r50v1_fpn_1x', "
        "'RetinaNet')):\n"
        "    for tr in (False, True):\n"
        "        spec = read_config(f'config/{cfg}.py', tr)\n"
        "        with torch.device('meta'):\n"
        "            net = build_detector(spec, depth=18)\n"
        "        assert type(net).__name__ == kind, cfg\n"
        # the two-stage FPN variants: PAFPN / FPG, the dual head, Mask
        # Scoring R-CNN and TSD, at depth 18 on the meta device
        "import simpledet_torch.models.fpg, simpledet_torch.models.msrcnn\n"
        "import simpledet_torch.models.tsd\n"
        "import simpledet_torch.ops.deform_roi_align\n"
        "for cfg, kind in (('FPG/faster_r50v1b_fpg6_256_syncbn_1x', "
        "'FasterRcnn'), ('FPG/faster_r50v1b_pafpn3_384_syncbn_1x', "
        "'FasterRcnn'), ('resnet_v1b/faster_r50v1b_fpn_dualheadsmall_1x', "
        "'FasterRcnn'), ('ms_r50v1_fpn_1x', 'MaskScoringFasterRcnn'), "
        "('TSD/tsd_r50v1_fpn_1x', 'TSDFasterRcnn')):\n"
        "    for tr in (False, True):\n"
        "        spec = read_config(f'config/{cfg}.py', tr)\n"
        "        with torch.device('meta'):\n"
        "            net = build_detector(spec, depth=18)\n"
        "        assert type(net).__name__ == kind, cfg\n"
        "for variant in ('v1b', 'v1d'):\n"
        "    os.environ['SIMPLEDET_MICRO_BACKBONE'] = variant\n"
        "    net = build_detector(read_config('config/micro_test.py', True))\n"
        "    assert net.backbone.variant == variant\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print(sum(p.numel() for p in model.parameters()))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) > 40_000_000


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO) for p in (REPO / "simpledet_torch").rglob("*.py")]
    + [Path("chip_smoke.py"), Path("alternate.py")]), ids=str)
def test_source_imports_no_jax(path):
    bad = [m for m in _imports(REPO / path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
