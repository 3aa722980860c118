"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program.  Module names are compared by
their top-level name whole: ``repro_torch`` begins with ``repro``."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}

HARNESS = r"""
import json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root / "portbench"), str(root / "src")]
from pbench import harness, loader, stats, trace, traffic, yardstick
import reference.sthc
bench = loader.Benchmark(root)
for w in bench.spec["workloads"]:
    cfg = bench.config(w["config"])
    bench.system(cfg["system"])
    bench.mix(w["traffic"])
    bench.limits(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in bench.metrics(w["name"], kind):
            bench.reader(m, kind)
for p in sorted((root / "portbench" / "tools").glob("*.py")):
    loader.load_module(p, "tool")
# what the system adapters import when they build a cell
import repro_torch.launch.serve, repro_torch.core.hybrid, repro_torch.core.fidelity
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = r"""
import json, sys
from pathlib import Path
sys.path[:0] = [str(Path(sys.argv[1]) / "portbench")]
import reference.sthc
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set[str]:
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    loaded = _top_level(HARNESS)
    assert "repro_torch" in loaded and "pbench" in loaded
    assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE)
    assert "torch" in loaded
    assert not loaded & (FORBIDDEN | {"repro_torch", "pbench"}), sorted(loaded & (FORBIDDEN | {"repro_torch"}))
