"""The C3D cell, ``c3d-clips``, end to end on the CPU at a tiny size (the
harness's look for a card skipped): sound, it comes out correct; with
half of each batch dropped inside ``conv3d``, with the head's top two
logits swapped, or with the TF32 control in the program's place, it
does not.  Its tiny root is the benchmark's (``tiny_root``, from
``conftest.make_tiny_root``) with the C3D configuration and mix cut here
too."""

import json

import pytest

torch = pytest.importorskip("torch")

from pbench import harness  # noqa: E402

CELL = "c3d-clips"
SEED = 2**31 + 101
TINY = {
    # C3D's structure at 16 x 16 x 8, the widths the igemm route takes
    # (multiples of 64 over 32-channel multiples) cut to the least
    "configs/c3d-sports1m.json": lambda c: c["model"].update(
        height=16, width=16, frames=8, stages=[[64], [64], [64, 64], [64, 64], [64, 64]], fc=[32, 32],
        num_classes=10,
    ),
    "traffic/c3d-clips.json": lambda m: m["request"].update(clips=4, frames=8),
}


@pytest.fixture
def c3d_root(tiny_root):
    for rel, cut in TINY.items():
        path = tiny_root / "portbench" / rel
        data = json.loads(path.read_text())
        cut(data)
        path.write_text(json.dumps(data))
    return tiny_root


def _run(root, **kw):
    return harness.run_cell(root, CELL, SEED, 1.0, False, "cpu", 0.0, **kw)


def test_c3d_cell_is_correct_on_the_cpu(c3d_root):
    out = _run(c3d_root)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}


def test_c3d_cell_reads_its_layer_metrics_on_the_cpu(c3d_root):
    """A traced CPU run: no device trace to read, so only the host-clock
    and counter metrics appear (the counters stay at 0 off the card)."""
    out = harness.run_cell(c3d_root, CELL, SEED, 1.0, True, "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"mfu_tf32"}


def _half_batch(fn):
    """The wrapped convolution leaves the latter half of its batch out."""

    def broken(*args, **kwargs):
        y = fn(*args, **kwargs).clone()
        y[y.shape[0] // 2:] = 0
        return y

    return broken


def _swapped_classes(fn):
    """The wrapped head swaps each clip's two largest logits."""

    def broken(*args, **kwargs):
        y = fn(*args, **kwargs).clone()
        top = torch.topk(y, 2, dim=-1).indices
        a, b = y.gather(-1, top[:, :1]), y.gather(-1, top[:, 1:])
        return y.scatter(-1, top[:, :1], b).scatter(-1, top[:, 1:], a)

    return broken


@pytest.mark.parametrize("module,name,wrap", [
    ("repro_torch.kernels.conv3d.ops", "conv3d", _half_batch),
    ("repro_torch.models.c3d", "head", _swapped_classes),
], ids=["half_batch", "answer_altered"])
def test_a_broken_c3d_path_is_not_correct(c3d_root, monkeypatch, module, name, wrap):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    out = _run(c3d_root)
    assert not out["correct"], out["checks"]


def test_the_tf32_control_is_not_correct(c3d_root):
    out = _run(c3d_root, control=True)
    assert not out["correct"], out["checks"]
    assert out["checks"]["answer_err"]["value"] > 3 * out["checks"]["answer_err"]["limit"]
