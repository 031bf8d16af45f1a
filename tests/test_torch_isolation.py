"""The port stands alone: it imports no JAX, no Flax and nothing of the JAX
package, even while it reads a config whose shims import them."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "simpledet_tpu")


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
    + [Path("chip_smoke.py")]), ids=str)
def test_source_imports_no_jax(path):
    bad = [m for m in _imports(REPO / path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
