"""`python -m simpledet_torch.converge_repeat` on the CPU: each recipe's
override prefix is the one its config reads (as the JAX package's
tools/converge_family.py names them), and one short run of
config/converge_test.py (2 steps at batch 2) trains and evaluates through
the CLIs at the lr given, prints its line, and leaves the working directory
and the environment as they were."""
import json
import os

import numpy as np
import pytest
import torch

from simpledet_torch import converge_repeat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module's tests run: the tier-1
    command runs 6 test workers on the CPU's cores, and torch's default of
    a thread a core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name, prefix", [
    ("converge_test", "CONVERGE"), ("converge_mask", "CONVERGE_MASK"),
    ("converge_cascade", "CONVERGE_CASCADE"),
    ("converge_trident", "CONVERGE_TRIDENT"),
    ("converge_retina", "CONVERGE_RETINA")])
def test_env_prefix(name, prefix):
    path = os.path.join(REPO, "config", f"{name}.py")
    assert converge_repeat.env_prefix(path) == prefix


def test_one_short_run_on_the_cpu(capsys, monkeypatch):
    monkeypatch.delenv("CONVERGE_LR", raising=False)
    cwd, env = os.getcwd(), dict(os.environ)
    lines = converge_repeat.main([
        "--config", os.path.join(REPO, "config", "converge_test.py"),
        "--max-iter", "2", "--batch", "2", "--lr", "0.002",
        "--device", "cpu"])
    assert os.getcwd() == cwd and dict(os.environ) == env
    (line,) = lines
    assert line["run"] == 0 and line["lr"] == 0.002 and line["steps"] == 2
    assert np.isfinite([line["first20"], line["last20"], line["largest"]]
                       ).all()
    assert line["means40"] == [round(line["first20"], 4)]
    assert 0 <= line["largest_at"] < 2 and {"AP", "AP50"} <= set(line)
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("run ")]
    assert [json.loads(ln[4:]) for ln in printed] == lines
