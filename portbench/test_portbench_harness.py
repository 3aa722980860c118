"""CPU tests of the benchmark's parts: the traffic generator, the metric
arithmetic, the frozen yardstick against the program's own, the trace
reduction, and pieces found by name."""

import json
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from pbench import harness, stats, traffic, yardstick  # noqa: E402
from pbench.loader import Benchmark, load_module  # noqa: E402
from pbench.trace import Trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

MIXES = ["search-saturated", "search-steady", "classify-batch", "classify-streams"]


# -- the traffic generator ----------------------------------------------------


@pytest.mark.parametrize("mix", MIXES)
def test_schedule_is_the_seeds(mix):
    spec = json.loads((ROOT / "portbench" / "traffic" / f"{mix}.json").read_text())
    a, b, c = (traffic.Schedule(spec, s, 20.0) for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    reqs = [[s.request(i) for i in range(64)] for s in (a, b, c)]
    assert reqs[0] == reqs[1]
    assert a.due == b.due
    if spec["loop"] == "open":
        assert a.due != c.due
        # every seed offers the same set of gaps, in its own order
        ga, gc = (sorted(x - y for x, y in zip(s.due[1:], s.due[:-1])) for s in (a, c))
        assert len(a.due) == len(c.due) and ga[: len(ga) // 2] == pytest.approx(gc[: len(gc) // 2])
    if any(isinstance(v, dict) for v in spec["request"].values()):
        assert reqs[0] != reqs[2]


def test_balanced_field_takes_every_value_once_per_run():
    s = traffic.Schedule({"loop": "closed", "request": {"t": {"balanced": list("ABCD")}}}, 9, 1.0)
    for block in range(5):
        assert sorted(s.request(4 * block + i)["t"] for i in range(4)) == list("ABCD")


def test_request_seed_takes_any_whole_number():
    seeds = {traffic.request_seed(s, traffic.STREAM_DATA, 7) for s in (0, 1, 2**31 + 11, 2**40, -3)}
    assert len(seeds) == 5
    assert traffic.request_seed(2**31 + 11, 4, 7) == traffic.request_seed(2**31 + 11, 4, 7)


def test_poisson_arrivals_fill_the_window_at_the_rate():
    s = traffic.Schedule({"loop": "open", "arrivals": {"process": "poisson", "rate_per_s": 50.0},
                          "request": {}}, 3, 20.0)
    assert 950 <= len(s.due) <= 1000
    assert s.due[0] == 0.0 and all(0 <= t < 20.0 for t in s.due)


# -- the metric arithmetic ----------------------------------------------------


class _FakeSystem:
    def frames(self, rec):
        return rec.params["frames"]

    def model_flops(self, rec):
        return 1e9


def _run(recs, window=(100.0, 110.0)):
    run = harness.Run(None, {"name": "x"}, {}, {}, _FakeSystem(), 1, window[1] - window[0], 3.5)
    run.recs, run.window = recs, window
    return run


def _rec(i, due=None, sent=100.0, done=None, error=None, rejected=False, frames=1024):
    r = traffic.Rec(i, {"frames": frames}, due=due, t_sent=sent, t_done=done, error=error)
    r.rejected = rejected
    return r


def test_rate_counts_all_work_answered_in_the_window():
    reader = load_module(ROOT / "portbench" / "e2e" / "frames_per_s.py", "metric")
    recs = [_rec(0, done=101.0), _rec(1, done=109.9, frames=2048), _rec(2, done=110.5),
            _rec(3, done=105.0, error=RuntimeError("x"))]
    assert reader.read(_run(recs)) == pytest.approx((1024 + 2048) / 10.0)


def test_p95_counts_failures_and_refusals_as_misses():
    """A tail over every request of a window: one that failed, was refused
    or never answered sorts above every answered one."""
    lat = [(i + 1) * 10.0 for i in range(100)]
    assert stats.quantile(lat, 0.95) == pytest.approx(950.5)
    for i in (3, 7, 11, 20, 30):
        lat[i] = math.inf
    assert stats.quantile(lat, 0.95) == math.inf
    # below the misses the tail is the answered requests' own
    assert stats.quantile(lat, 0.90) == stats.quantile([x if x < math.inf else 1e9 for x in lat], 0.90)
    assert stats.quantile([1.0] * 95 + [math.inf] * 5, 0.90) == 1.0


def test_quantile_matches_numpy_linear():
    np = pytest.importorskip("numpy")
    xs = [3.0, 1.0, 7.5, 2.25, 9.0, 4.0, 4.0]
    for q in (0.0, 0.25, 0.5, 0.95, 1.0):
        assert stats.quantile(xs, q) == pytest.approx(float(np.quantile(xs, q)))


# -- the frozen yardstick equals the program's --------------------------------


def _search_cfg():
    return json.loads((ROOT / "portbench" / "configs" / "sthc-kth-search.json").read_text())


def _hybrid_cfg():
    return json.loads((ROOT / "portbench" / "configs" / "sthc-kth-hybrid.json").read_text())


def test_fft_flops_and_stream_plan_equal_the_programs():
    from repro_torch.core import spectral_conv, throughput

    s, h = _search_cfg(), _hybrid_cfg()["model"]
    (H, W), (O, C, kh, kw, kt) = s["frame_hw"], s["kernel_shape"]
    block = s["server"]["window_frames"]
    cases = [(H, W, block, C, O, kh, kw, kt),
             (h["height"], h["width"], h["frames"], h["in_channels"], h["num_kernels"], h["k_h"],
              h["k_w"], h["k_t"])]
    for hh, ww, ff, cc, oo, a, b, t in cases:
        port = throughput.ConvWorkload(hh, ww, ff, cc, oo, a, b, t).fft_flops()
        assert yardstick.fft_flops(hh, ww, ff, cc, oo, a, b, t) == port
        assert yardstick.fft_shape_for((hh, ww, ff), (a, b, t)) == spectral_conv.fft_shape_for((hh, ww, ff), (a, b, t))
    for T, k, blk, chunk in ((1024, kt, block, s["server"]["chunk_windows"]), (2048, h["k_t"], h["frames"], 1)):
        assert yardstick.stream_plan(T, k, blk, chunk).__dict__ == spectral_conv.stream_plan(T, k, blk, chunk).__dict__
    for n in range(1, 3000, 7):
        assert yardstick.next_fast_len(n) == spectral_conv.next_fast_len(n)


def test_kernel_costs_equal_the_programs():
    from repro_torch.launch.op_analysis import kernel_cost

    h = _hybrid_cfg()["model"]
    F = yardstick.spectral_bins(h["height"], h["width"], h["frames"], h["k_h"], h["k_w"], h["k_t"])
    assert F == 140_400
    for B in (1, 16, 256):
        port = kernel_cost("spectral_mac", B=B, O=9, C=1, F=F)
        assert yardstick.spectral_mac_cost(B, 9, 1, F) == (port.flops, port.bytes)
    s = _search_cfg()
    (H, W), (O, C, kh, kw, kt) = s["frame_hw"], s["kernel_shape"]
    Fs = yardstick.spectral_bins(H, W, s["server"]["window_frames"], kh, kw, kt)
    assert Fs == 399_600
    # one launch: 4 windows x 3 rows reading two tenants' 9-row slices
    o_start = [0, 9, 0] * 4
    port = kernel_cost("spectral_mac_grouped", B=12, C=1, F=Fs, o_start=o_start, n_out=9, itemsize=4)
    assert yardstick.grouped_mac_bytes(12, 18, 1, Fs, 9, 4) == port.bytes


def test_h100_constants_equal_the_programs():
    from repro_torch.launch import roofline

    assert yardstick.HBM_BW == roofline.HBM_BW
    assert yardstick.PEAK_F32 == roofline.PEAK_FLOPS_F32


# -- the trace reduction ------------------------------------------------------


def test_busy_union_and_idle_gaps_name_the_open_span():
    tr = Trace(window=(0, 100),
               device=[("a", 10, 20), ("b", 25, 10), ("c", 60, 10), ("d", 95, 30)],
               spans=[("generate", 0, 5), ("search_batch", 38, 58), ("submit", 40, 50)])
    assert tr.busy_intervals() == [(10, 35), (60, 70), (95, 100)]
    assert tr.busy_s() == pytest.approx(40e-9)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["search_batch", pytest.approx(25e-9)]
    assert gaps[1] == ["none", pytest.approx(25e-9)]
    assert tr.top_ops(2) == [["d", pytest.approx(30e-9)], ["a", pytest.approx(20e-9)]]


# -- found by name ------------------------------------------------------------


def test_every_named_piece_exists():
    bench = Benchmark(ROOT)
    for w in bench.spec["workloads"]:
        cfg = bench.config(w["config"])
        bench.system(cfg["system"])
        bench.mix(w["traffic"])
        assert set(bench.limits(w["name"])["limits"]) >= {"lost"}
        for kind in ("end_to_end", "per_layer"):
            for m in bench.metrics(w["name"], kind):
                assert callable(bench.reader(m, kind).read)


def test_a_new_cell_mix_and_metric_are_found_by_name(tiny_root):
    """A throwaway metric, mix and cell, added as files and entries only:
    an open-loop mix of the search configuration, read by a new metric."""
    pb = tiny_root / "portbench"
    (pb / "metrics" / "requests_answered.py").write_text(
        "def read(run):\n    return len(run.answered())\n"
    )
    mix = {"loop": "open", "arrivals": {"process": "poisson", "rate_per_s": 20.0},
           "request": {"tenant": {"balanced": ["A", "B", "C", "D"]}, "streams": 1, "frames": 48}}
    (pb / "traffic" / "tiny-open.json").write_text(json.dumps(mix))
    limits = json.loads((pb / "limits" / "search-saturated.json").read_text())
    (pb / "limits" / "tiny-cell.json").write_text(json.dumps(limits))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-cell", "config": "sthc-kth-search", "traffic": "tiny-open",
                              "chips": 1, "why": "throwaway"})
    spec["per_layer"].append({"name": "requests_answered", "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "device", "moves": "frames_per_s",
                              "workloads": ["tiny-cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = harness.run_cell(tiny_root, "tiny-cell", 17, 1.0, True, "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 20 and out["metrics"]["requests_answered"]["value"] == 20
