"""Find the knee of an open-loop cell: the highest offered rate the program
sustains without a growing backlog.

    python3 portbench/tools/sweep.py --config sthc-kth-search --traffic search-steady \\
        --seed 7 --seconds 10 --rates 120,150,180 --out chiprun_out/sweep.json

Builds the configuration's system once, then offers the open-loop mix at
each rate (its ``arrivals.rate_per_s`` replaced) for ``--seconds`` and
prints one row per rate: offered and answered requests/s, p50 and p95
from due time to answer, and the backlog's trend (the median latency of
the last third of the requests over that of the first third; a backlog
that grows through the run reads well above 1).  The rate is then
written into the mix by hand, at 0.8 of the knee.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT / "src")]


def main() -> None:
    from pbench import stats, traffic
    from pbench.loader import Benchmark
    from pbench.trace import Tracer

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True, help="requests/s, comma-separated")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    bench = Benchmark(ROOT)
    config = bench.config(args.config)
    mix = bench.mix(args.traffic)
    system = bench.system(config["system"]).System(
        config=config, mix=mix, seed=args.seed, device="cuda", tracer=Tracer(False, "cuda")
    )
    system.setup()
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        m = copy.deepcopy(mix)
        m["arrivals"]["rate_per_s"] = rate
        schedule = traffic.Schedule(m, args.seed, args.seconds)
        before = system.counters()
        t0 = time.perf_counter()
        recs = traffic.open_loop(schedule, system.issue, system.is_rejection, t0)
        after = system.counters()
        lat = [(r.t_done - r.due) * 1e3 if r.ok else math.inf for r in recs]
        ok = [r for r in recs if r.ok]
        third = max(len(lat) // 3, 1)
        row = {
            "rate_per_s": rate,
            "requests": len(recs),
            "answered_per_s": len(ok) / (max(r.t_done for r in ok) - t0) if ok else 0.0,
            "p50_ms": stats.quantile(lat, 0.5),
            "p95_ms": stats.quantile(lat, 0.95),
            "trend": stats.quantile(lat[-third:], 0.5) / stats.quantile(lat[:third], 0.5),
            "mean_batch": (after["completed"] - before["completed"]) / max(after["batches"] - before["batches"], 1),
            "rejected": after["rejected"] - before["rejected"],
            "sender_late_ms": traffic.lateness_s(recs) * 1e3,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    system.release()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
