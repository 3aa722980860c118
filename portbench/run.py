"""Run one cell of the benchmark of ``repro_torch`` once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up every shape the cell uses (set-up), measures for
``--seconds``, frees the program, checks the answers of the window
against the plain reference under ``portbench/reference/``, and prints
one JSON line last on standard output.  With no CUDA card, or fewer than
the cell asks for, it exits 2 and prints no result.  See README.md.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"


def _pin_caches() -> None:
    """Every compiler and kernel cache at a fixed path inside the checkout
    (the stmul library itself is built into ``build/kernels/``)."""
    for var, sub in (
        ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
        ("TRITON_CACHE_DIR", "triton"),
        ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
        ("CUDA_CACHE_PATH", "cuda_cache"),
    ):
        os.environ[var] = str(BUILD / sub)


def _power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out.stdout.strip() or out.stderr.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _pin_caches()
    sys.path[:0] = [str(ROOT / "portbench"), str(ROOT / "src")]
    from pbench import harness
    from pbench.loader import Benchmark

    chips = Benchmark(ROOT).cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run_cell(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS
    )
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}", file=sys.stderr)
    for line in harness.describe_checks(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
