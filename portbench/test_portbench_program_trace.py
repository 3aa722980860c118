"""The program's spans beside the device trace (``pbench/program_trace.py``)
and ``tools/attribute.py``, on the CPU.

A synthetic trace of two threads (a batcher inside ``sched.batch`` and
the caller drawing inputs) checks that each device operation goes to the
innermost span open in its launching thread, that idle gaps gain the
program span open at their middle, and the arithmetic of each
program-side number.  A tiny cell run checks the tool end to end and that
the benchmark's own traced run leaves the program's recorder off.
"""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from pbench import harness  # noqa: E402
from pbench.loader import load_module  # noqa: E402
from pbench.program_trace import (  # noqa: E402
    ProgramTrace,
    batch_host_ms_mean,
    glue_us_per_frame,
    head_us_per_frame,
    queue_wait_ms_mean,
    queue_wait_ms_quantiles,
    rebuilds,
    top_pairs,
)

ROOT = Path(__file__).resolve().parents[1]

BATCHER, CALLER = 11, 22


def _trace(launch_tids=None):
    """Batcher: a cycle of prepare, one window chunk (an inverse FFT in
    it) and a readback; a second cycle past the window's end.  Caller:
    ``generate`` and ``submit`` while the batcher prepares, later a
    ``classify`` call whose head runs one operation."""
    program = [
        ("sched.batch", 1, None, BATCHER, 100, 600, {"batch": 1}),
        ("serve.prepare", 2, 1, BATCHER, 110, 150, None),
        ("engine.chunk", 3, 1, BATCHER, 200, 400, None),
        ("stmul.irfftn", 4, 3, BATCHER, 250, 300, None),
        ("serve.readback", 5, 1, BATCHER, 400, 550, None),
        ("sched.queue", 6, None, BATCHER, 50, 100, {"request": 1, "batch": 1}),
        ("classify.head", 7, None, CALLER, 700, 750, None),
        ("sched.batch", 8, None, BATCHER, 950, 1100, {"batch": 2}),
    ]
    spans = [("generate", 120, 140), ("search_batch", 105, 560), ("submit", 140, 145),
             ("classify", 600, 800)]
    threads = [CALLER, BATCHER, CALLER, CALLER]
    device = [  # (name, start, duration), each with its launch
        ("regular_fft_c2r", 270, 50),        # in stmul.irfftn
        ("distribution_rand", 150, 10),      # caller, in generate
        ("Memcpy_DtoD", 360, 20),            # in engine.chunk, after the FFT closed
        ("mac_grouped_kernel", 330, 10),     # in engine.chunk: B2
        ("late_kernel", 810, 30),            # caller, outside every span
        ("no_launch_record", 420, 10),       # found by its device time
        ("prologue", 105, 10),               # in sched.batch before prepare
        ("bias_add", 710, 40),               # in classify.head
    ]
    launch = {1: (BATCHER, 260), 2: (CALLER, 130), 3: (BATCHER, 350), 4: (BATCHER, 320),
              5: (CALLER, 800), 7: (BATCHER, 102), 8: (CALLER, 705)}
    corr = [1, 2, 3, 4, 5, 0, 7, 8]
    if launch_tids is not None:
        launch = {c: (launch_tids[tid], t) for c, (tid, t) in launch.items()}
    calls = [("cudaMalloc", BATCHER, 270, 5), ("cudaLaunchKernel", BATCHER, 260, 2),
             ("cudaFree", CALLER, 2000, 1), ("cudaStreamSynchronize", BATCHER, 410, 120),
             ("cudaMemcpyAsync", BATCHER, 210, 30)]
    if launch_tids is not None:
        calls = [(n, launch_tids[tid], t, d) for n, tid, t, d in calls]
    return ProgramTrace(window=(0, 1000), device=device, spans=spans, program_spans=program,
                        span_threads=threads, device_corr=corr, launches=launch, runtime_calls=calls)


WANT = [("stmul.irfftn", "program", "launch"), ("generate", "benchmark", "launch"),
        ("engine.chunk", "program", "launch"), ("engine.chunk", "program", "launch"),
        ("none", "none", "launch"), ("serve.readback", "program", "device_time"),
        ("sched.batch", "program", "launch"), ("classify.head", "program", "launch")]


def test_each_operation_goes_to_the_innermost_span_of_its_launching_thread():
    tr = _trace()
    assert tr.threads_matched()
    assert tr.attribution() == WANT
    total = 50 + 10 + 20 + 10 + 30 + 10 + 10 + 40
    shares = tr.shares()
    assert shares["program"] == pytest.approx((50 + 20 + 10 + 10 + 10 + 40) / total)
    assert shares["benchmark"] == pytest.approx(10 / total)
    assert shares["none"] == pytest.approx(30 / total)
    assert shares["device_time"] == pytest.approx(10 / total)
    assert top_pairs(tr, 2) == [["stmul.irfftn", "regular_fft_c2r", pytest.approx(50e-9)],
                                ["classify.head", "bias_add", pytest.approx(40e-9)]]


def test_a_launch_from_a_thread_without_spans_goes_to_none():
    """Thread ids that match no span's (another numbering) are reported,
    and their launches are given to no span rather than guessed."""
    tr = _trace({BATCHER: 111, CALLER: 222})
    assert not tr.threads_matched()
    assert [a[0] for a in tr.attribution()] == ["none"] * 5 + ["serve.readback", "none", "none"]
    assert tr.allocations() == [["cudaMalloc", "none", 5e-9, 270e-9]]


def test_idle_gaps_gain_the_program_span_open_at_their_middle():
    gaps = {round(s * 1e9): label for label, s in _trace().idle_gaps(10)}
    assert gaps == {
        105: "none",                          # 0..105: no span open
        35: "search_batch/serve.prepare",     # 115..150
        110: "search_batch/engine.chunk",     # 160..270, before the FFT's launch
        10: "search_batch/engine.chunk",      # 320..330
        20: "search_batch/engine.chunk",      # 340..360
        40: "search_batch/serve.readback",    # 380..420
        280: "none/sched.batch",              # 430..710: past search_batch, in the cycle
        60: "classify",                       # 750..810: the head has closed
        160: "none",                          # 840..1000
    }


def test_allocation_calls_inside_the_window_name_their_span():
    assert _trace().allocations() == [["cudaMalloc", "stmul.irfftn", 5e-9, 270e-9]]


def test_idle_and_host_seconds_by_span_and_the_longest_runtime_calls():
    tr = _trace()
    idle = {k: round(v * 1e9) for k, v in tr.idle_by_label().items()}
    assert idle == {"none/sched.batch": 280, "search_batch/engine.chunk": 140, "none": 265,
                    "classify": 60, "search_batch/serve.readback": 40,
                    "search_batch/serve.prepare": 35}
    host = {k: round(v * 1e9) for k, v in tr.self_times().items()}
    # a cycle's own time is what its stages leave: 500 - 40 - 200 - 150, and the later 150
    assert host == {"sched.batch": 260, "engine.chunk": 150, "serve.readback": 150,
                    "stmul.irfftn": 50, "classify.head": 50, "serve.prepare": 40}
    assert tr.long_calls(5) == [["cudaMalloc", "stmul.irfftn", 5e-9, 270e-9],
                                ["cudaLaunchKernel", "stmul.irfftn", 2e-9, 260e-9]]
    assert tr.waits_by_span() == {"serve.readback": pytest.approx(120e-9),
                                  "engine.chunk": pytest.approx(30e-9)}


def test_program_side_numbers():
    tr = _trace()
    # the cycle inside the window: 500 ns, 150 of them waiting on the readback
    # and 30 in the chunk's copy (the readback's own synchronize is not counted twice)
    assert batch_host_ms_mean(tr) == pytest.approx(320e-6)
    assert head_us_per_frame(tr, 4) == pytest.approx(40e-9 * 1e6 / 4)
    # engine.* / stmul.* time that is neither cuFFT nor B1-B3: the copy
    assert glue_us_per_frame(tr, 4) == pytest.approx(20e-9 * 1e6 / 4)
    # the one request whose wait (50..100) ended in the window
    assert queue_wait_ms_quantiles(tr) == [pytest.approx(50e-6), pytest.approx(50e-6)]
    assert queue_wait_ms_mean({"dequeued": 10, "queue_wait_ns": 1_000_000},
                              {"dequeued": 14, "queue_wait_ns": 9_000_000}) == pytest.approx(2.0)
    assert rebuilds({"cufft_plans": 5, "device_allocs": 9, "alloc_retries": 0, "grating_misses": 4},
                    {"cufft_plans": 6, "device_allocs": 11, "alloc_retries": 0, "grating_misses": 4}) == 3


def test_program_side_numbers_read_nothing_where_nothing_is_there():
    empty = ProgramTrace(window=(0, 1000), device=[], spans=[])
    assert batch_host_ms_mean(empty) is None and queue_wait_ms_quantiles(empty) is None
    assert head_us_per_frame(empty, 4) is None and glue_us_per_frame(_trace(), 0) is None
    assert queue_wait_ms_mean({}, {}) is None  # a scheduler without the counters
    assert queue_wait_ms_mean({"dequeued": 3, "queue_wait_ns": 5}, {"dequeued": 3, "queue_wait_ns": 5}) is None
    assert rebuilds({"grating_misses": 1}, {}) is None


def test_attribute_tool_runs_a_tiny_cell_and_the_benchmark_leaves_the_recorder_off(tiny_root):
    from repro_torch import tracing

    tool = load_module(ROOT / "portbench" / "tools" / "attribute.py", "tool")
    row = tool.run_once(tiny_root, "search-saturated", 2**31 + 5, 1.0, "cpu", True, 0.0)
    assert row["frames_per_s"] > 0
    assert row["program"]["queue_wait_ms.mean"] > 0
    assert row["program"]["batch_host_ms.mean"] > 0
    assert row["program"]["rebuilds"] == 0  # the grating cache missed nothing
    for name in ("sched.batch", "sched.queue", "serve.prepare", "engine.chunk", "sched.deliver"):
        assert row["program_spans"].get(name, 0) > 0, name
    off = tool.run_once(tiny_root, "search-saturated", 2**31 + 5, 1.0, "cpu", False, 0.0)
    assert off["program_spans"] == {} and off["program"]["batch_host_ms.mean"] is None
    out = harness.run_cell(tiny_root, "classify-streams", 9, 1.0, True, "cpu", 0.0)
    assert out["correct"]
    assert not tracing.recording() and tracing.stop() == []
