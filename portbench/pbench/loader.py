"""Find a benchmark's pieces by name: configurations, traffic mixes,
limits, systems, end-to-end and per-layer metric readers.

Each lives in a file of its own under ``portbench/``; adding one is adding
a file and an entry of ``BENCHMARK.json``, with no edit to a file that is
already there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = "portbench"


def bench_dir(root: Path) -> Path:
    return Path(root) / BENCH


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, kind: str):
    """Import one Python file by path, under a module name of its own."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    name = f"pb_{kind}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Benchmark:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return load_json(bench_dir(self.root) / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return load_json(bench_dir(self.root) / "limits" / f"{workload}.json")

    def system(self, name: str):
        return load_module(bench_dir(self.root) / "systems" / f"{name}.py", "system")

    def metrics(self, workload: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries that ``workload``
        reports: those that list it, and those that list no cells."""
        return [m for m in self.spec[kind] if workload in m.get("workloads", [workload])]

    def reader(self, metric: dict, kind: str):
        sub = "e2e" if kind == "end_to_end" else "metrics"
        return load_module(bench_dir(self.root) / sub / f"{metric['name']}.py", "metric")
