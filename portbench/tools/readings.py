"""Read the numbers a cell's ``correct`` compares, for the program and for
its lower-precision control, over many seeds in one process: the
readings each limit in ``portbench/limits/`` is set from.

    python3 portbench/tools/readings.py --workload search-saturated \\
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 4 \\
        --out chiprun_out/readings.json

Each seed is one run of the cell (its own traffic and sizes, a window of
``--seconds``); the control runs are the same with the control in the
program's place (search: the program's own bfloat16-grating path; the
classifier: the reference computed in bfloat16).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT / "src")]


def main() -> None:
    from pbench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    rows = []
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",") if s):
            t = time.perf_counter()
            out = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, "cuda", t,
                                   control=control)
            row = {"control": control, "seed": seed, "correct": out["correct"],
                   "attempted": out["attempted"],
                   "checks": {k: v["value"] for k, v in out["checks"].items()},
                   "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
