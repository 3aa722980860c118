"""Test settings of the benchmark's own tests (``test_portbench_*.py``).

``card`` marks a test that needs a CUDA card; it decides inside the test
and skips elsewhere.  ``tiny_root`` is a copy of the benchmark, every cell
cut to a size a CPU run of a second or two can hold.
"""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips on a host without one")


TINY = {
    "configs/sthc-kth-search.json": lambda c: (
        c.update(frame_hw=[20, 24], kernel_shape=[3, 1, 7, 9, 4]),
        c["server"].update(window_frames=16, chunk_windows=2),
        c["scheduler"].update(max_batch=3),
    ),
    "configs/sthc-kth-hybrid.json": lambda c: c["model"].update(
        height=20, width=24, frames=10, num_kernels=3, k_h=7, k_w=9, k_t=4, pool_window=[4, 4, 2],
        hidden=16,
    ),
    "traffic/search-saturated.json": lambda m: (m.update(clients=6), m["request"].update(frames=64)),
    "traffic/classify-batch.json": lambda m: m["request"].update(clips=8, frames=10),
    "traffic/classify-streams.json": lambda m: m["request"].update(clips=2, frames=40),
}


def make_tiny_root(dest: Path) -> Path:
    """A checkout holding BENCHMARK.json and the benchmark's files, each
    configuration and mix cut to a tiny size."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*.py"))
    for rel, cut in TINY.items():
        path = dest / "portbench" / rel
        data = json.loads(path.read_text())
        cut(data)
        path.write_text(json.dumps(data))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield make_tiny_root(tmp_path)
    finally:
        torch.set_num_threads(threads)
