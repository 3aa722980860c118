"""Every cell run end to end on the CPU at a tiny size (the harness's look
for a card skipped): sound, it comes out correct; with its timed path
broken underneath, or with the lower-precision control in the program's
place, it comes out not correct.  The card test runs ``run.py`` itself."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from pbench import harness  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = ["search-saturated", "classify-batch", "classify-streams"]
SEED = 2**31 + 101


def _run(root, cell, **kw):
    return harness.run_cell(root, cell, SEED, 1.0, False, "cpu", 0.0, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_cpu(tiny_root, cell):
    out = _run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "checks"


def _half_rows(fn):
    """The wrapped kernel leaves the latter half of its batch rows out."""

    def broken(*args, **kwargs):
        y = fn(*args, **kwargs)
        y = y.clone()
        y[y.shape[0] // 2:] = 0
        return y

    return broken


def _scaled_scores(fn):
    """The wrapped readout alters the first row's scores where they are made."""

    def broken(*args, **kwargs):
        s, i = fn(*args, **kwargs)
        s = s.clone()
        s[0] = s[0] * 1.01
        return s, i

    return broken


def _swapped_classes(fn):
    """The wrapped head swaps the first clip's two largest logits."""

    def broken(*args, **kwargs):
        y = fn(*args, **kwargs).clone()
        top = torch.topk(y[0], 2).indices
        y[0, top[0]], y[0, top[1]] = y[0, top[1]].clone(), y[0, top[0]].clone()
        return y

    return broken


FAULTS = {
    # (cell, fault): (module, attribute, wrapper)
    ("search-saturated", "half_batch"): ("repro_torch.kernels.stmul.ops", "spectral_mac_grouped", _half_rows),
    ("search-saturated", "answer_altered"): ("repro_torch.kernels.stmul.ops", "topk_readout", _scaled_scores),
    ("classify-batch", "half_batch"): ("repro_torch.kernels.stmul.ops", "spectral_mac", _half_rows),
    ("classify-batch", "answer_altered"): ("repro_torch.core.hybrid", "head", _swapped_classes),
    ("classify-streams", "half_batch"): ("repro_torch.kernels.stmul.ops", "spectral_mac", _half_rows),
    ("classify-streams", "answer_altered"): ("repro_torch.core.hybrid", "head", _swapped_classes),
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    import importlib

    module, name, wrap = FAULTS[(cell, fault)]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    out = _run(tiny_root, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_lower_precision_control_is_not_correct(tiny_root, cell):
    """Search: the program's own bfloat16-grating path; the classifier:
    the reference in bfloat16 in the program's place."""
    out = _run(tiny_root, cell, control=True)
    assert not out["correct"], out["checks"]
    first = next(iter(out["checks"].values()))
    assert first["value"] > 3 * first["limit"]


@pytest.mark.card
def test_run_py_on_the_card(tmp_path):
    """One short traced run of the cheapest cell through the command the
    driver runs (``python3 portbench/run.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cmd = [sys.executable, "portbench/run.py", "--workload", "classify-batch", "--seed", str(SEED),
           "--seconds", "2", "--trace", "1"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0 and "b1_roofline" in out["metrics"]
