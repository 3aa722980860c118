"""Chip smoke test of the PyTorch/CUDA port on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--out report.json]

Phases, each reported on lines of its own:

1. build   — compile the CUDA kernels (``src/repro_torch/kernels/
             stmul/csrc``, ``kernels/ssd/csrc``, ``kernels/flash/csrc``
             and ``kernels/conv3d/csrc``) with nvcc for sm_90a, one nvcc
             per library, all started together, and load them; print
             ``-Xptxas -v``'s registers, spills and stack per kernel.
             B6's library must report, for every (dtype, head dim), the
             dynamic shared memory ``kernel.smem_bytes`` plans (at most
             227 KB), and its bf16 builds must hold warpgroup MMAs
             (HGMMA, wgmma) and cp.async copies (LDGSTS) in their SASS
             (``cuobjdump``); B5's chunk-state and chunk-scan kernels
             must hold tensor-core MMAs (HMMA, 3xTF32 mma.sync), the
             scan also cp.async copies; B4's tensor-core kernel
             (``conv3d_tc.cu``) warpgroup MMAs (HGMMA, 3xTF32 wgmma),
             tensor-map copies (UTMALDG) and bulk copies (UBLKCP), with
             no wgmma serialization reported by ptxas.
2. serve   — a VideoSearchServer at the paper geometry (60x80 frames,
             four tenants of 9x1x30x40x8 kernels, 64-frame windows, 4
             windows per chunk) answers six 1024-frame requests, two
             sharing one clip: pooled (B2 + B3), sequential (B1 + B3),
             stitched (return_volume, whose fused scores must equal the
             stitched amax/argmax bitwise), and pooled again with bf16
             gratings.  The launch counters are zeroed before and read
             after; every kernel of each rung must have run.  The ideal
             tenant's scores are checked against direct conv3d
             correlation on a short clip, and one call of each rung is
             profiled (host clip hashing, device busy time by kernel,
             every kernel of the repository's own listed).  Then a
             ``max_buffer_windows = 8`` server searches numpy streams of
             4096 and 8192 frames: its peak device memory may grow by
             less than a quarter of the shorter stream's bytes, and its
             detections must equal the unbounded server's bitwise.
3. kernels — run every kernel at the shapes the serving batch gives it
             and hold it against its plain torch version on the card:
             B1 v2/v1 bitwise, also at an odd F, at C = 3 (the kernel
             for C > 1) and with 20 kernels (O in chunks that do not fill
             the last); B2 f32/bf16 at the pooled
             rung's shape, with irregular unsorted offsets into a 64-row
             arena and at an odd F, bitwise; the top-K readout (B3, k = 1
             and 3 at 36 rows, k = 1 at 9 and 18; rows with NaN, -inf,
             ties and signed zeros, then inputs with those on the slice
             boundaries of the host plan) bitwise.  Times each with
             CUDA events beside its plain version, a one-call library
             yardstick and its bound (bytes at 3.35 TB/s or float32
             operations at 67 TFLOP/s, whichever is larger).
4. lm      — mamba2-370m at its published config (48 layers, bf16,
             random weights from a seeded generator on the card) served
             by ``LMServer.generate``: 4 prompts x 2048 tokens then 32
             greedy tokens, and 2 x 1000 (padded to 1024 inside the SSD)
             then 8.  One warm-up and 5 timed calls each of prefill-only
             and full generation; the SSD kernel's (B5) launch counter,
             zeroed before the timed calls, must read 48 x the prefills
             run.  B5 is held against its plain version on layer 0's SSD
             inputs of the first batch, of its 2 x 1024 prefix (the grid
             batch two gives it) and of its first prompt (1 x 2048, 32
             heads), relative L2 <= 1e-5 for y and the final state, and
             timed like the others (no single PyTorch call computes it:
             library "none"; bound: its FLOPs at the TF32 tensor-core
             rate / 3, the float32 FMA bound beside it); its (16, 16, 16) build,
             which ``serve --mode lm`` runs on the smoke config, is held
             to the same limit on that config; a 2-layer float32 model
             at full width must give the same last logits by the kernel
             route and the plain route (relative L2 <= 1e-4).
5. lm_dense — qwen2-1.5b at its published config (28 layers, d_model
             1536, 12 query and 2 kv heads of 128, bf16, random weights
             from a seeded generator on the card) served by
             ``LMServer.generate`` with a KV cache of prompt + new tokens,
             on the same two batches, timed and profiled as in ``lm``;
             the flash-attention kernel's (B6) launch counter must read
             28 x the prefills run.  B6 in bf16 (the wgmma build)
             is held against its plain version on layer 0's q, k, v of
             both batches and on a bf16 sweep (ragged 37, 130 and 1000,
             Sq != Sk both ways, GQA groups 1, 2 and 6, head dims 16, 24,
             32 and 128, both mask settings): relative L2 <= 1e-2 (the
             plain version rounds q·scale to bf16), and against the
             plain version on the same inputs upcast to float32 the
             worst row's relative L2 <= 1e-2 and max abs <= 5e-3
             max|v|; in float32 (the FMA build) on the reference test
             sweep's shapes and the smoke config's head dim 24
             (relative L2 <= 1e-5, max abs <= 3e-5); timed
             beside its plain version, one
             ``scaled_dot_product_attention`` call as the library
             yardstick, and its bound (bytes at 3.35 TB/s or the causal
             triangle's FLOPs at 989 TFLOP/s bf16); a 2-layer float32
             model at full width must give the same last logits by the
             kernel route and the plain route (relative L2 <= 1e-4).
             Decode attention at layer 0's decode shapes: the bf16-GEMM
             route against the ``_dot_f32`` route on the same tensors
             (each product's float32 output within 1e-5, the bf16 output
             within 1e-2), no cache-sized float32 copy, and decode
             ms/token of ``generate`` on each route, in turns.
6. classify — the paper's hybrid 3-D CNN at its full geometry (60x80x16
             clips, 9 kernels of 30x40x8, pool (8, 8, 3), hidden 128, 4
             classes; random weights from a seeded generator on the card)
             on the 144-clip synthetic-KTH test split in batches of 16:
             ``predict`` with impl digital (B4), spectral and
             sthc_physical (B1), and ``HybridClassifierServer.classify``,
             physical and ideal (B1); one warm-up and 7 timed batches per
             route, five profiled calls each.  Then ``classify_stream`` and
             ``conv_layer_stream(impl='digital')`` on four 512-frame
             streams, one per class.  Checks: digital and spectral
             predictions equal outside near-ties (top-two logits within
             1e-4 of their scale), the ideal server equal to
             ``predict(spectral)`` likewise, every ``classify_stream``
             segment equal to ``classify`` of its sub-clip, the streamed
             digital conv within 2e-4 (max error over max) of the
             streamed ideal STHC conv, and B4's launch counter, zeroed
             before the phase, equal to the digital calls made.  B4 is
             held against its plain version (relative L2 <= 1e-5 in
             float32, <= 1e-2 in bf16 against the plain version on the
             same inputs upcast) at the batch and stream shapes (the
             tensor-core route, which ``kernel.route`` must give them),
             kernels_bench's C3D case (float32 and bf16) and the
             reference test sweep's shapes (the FMA route), and timed
             beside it (the
             plain version is one cuDNN ``F.conv3d`` call, so its time is
             also the library time; float32 rows carry both bounds,
             TF32 / 3 and float32 FMA); B1 likewise, bitwise, at the
             classifier's shapes (16 spectra against a (9, 1, F)
             grating, F from the 60x80x16 clip's FFT grid).

The last line is ``{"ok": true, "device": {...}}``; any failure raises
and exits non-zero.  Without CUDA, or outside a checkout of the repo, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor cores; B5's 3xTF32 runs three per product
SSD_RTOL = 1e-5
FLASH_BF16_RTOL = 1e-2  # the plain version rounds q·scale to bf16 before the dot
# B6 in bf16 against the plain version on the same inputs upcast to float32
# (no q·scale rounding, p not rounded): the kernel rounds each p (relative
# 2^-9) and each output (2^-9) to bf16, so a right row is off by about
# 2^-9 of its norm and no element by more than 2^-8·max|v| (3.9e-3);
# a wrong row (mask, kv head, stale tile) is off by O(1) of its norm,
# which the whole tensor's relative L2 dilutes to ~3e-3 at 98,304 rows
FLASH_BF16_ROW_RTOL = 1e-2  # worst row's relative L2
FLASH_BF16_ABS_V = 5e-3  # max abs error, in units of max|v|
FLASH_F32_RTOL, FLASH_F32_ATOL = 1e-5, 3e-5
# B6 bf16 sweep (B, Sq, Sk, H, G, D, causal): ragged lengths (37, 130,
# 1000: not multiples of the 64-row tile), Sq != Sk both ways, GQA groups
# H/G of 1, 2 and 6, head dims 16, 24 (padded to 32 in shared memory), 32
# and 128, both mask settings
FLASH_BF16_SWEEP = (
    (2, 37, 37, 4, 4, 16, True), (2, 37, 37, 4, 2, 16, False),
    (1, 40, 100, 4, 2, 16, False), (1, 40, 100, 4, 2, 16, True),
    (2, 96, 96, 8, 4, 32, True), (2, 71, 71, 6, 1, 32, False), (1, 100, 40, 4, 2, 32, True),
    (2, 64, 64, 2, 2, 24, True), (2, 130, 130, 6, 1, 24, False),
    (1, 40, 100, 12, 2, 128, False), (1, 300, 300, 4, 4, 128, True),
    (2, 1000, 1000, 12, 2, 128, True), (2, 1000, 1000, 12, 2, 128, False),
)
LM_RTOL = 1e-4
# substrings of the hand-written kernels' names, listed in every profile
OWN_KERNELS = ("topk", "mac_", "ssd", "flash", "conv3d")
# Decode attention's bf16-GEMM route against the _dot_f32 route on
# the same tensors.  Each product's float32 output: the products are exact
# in float32 on both routes and only the sum order differs.  The whole
# bf16 output: p and the output are rounded to bf16 (2^-9 relative), so a
# sum-order difference can flip a rounding; a wrong head or layout is off
# by O(1)
DECODE_DOT_RTOL = 1e-5
DECODE_OUT_RTOL = 1e-2
MEM_STREAM_FRAMES = (4096, 8192)  # a cursor stream, then one twice as long
SERVE_REPS = 7  # timed calls per serving mode, after one warm-up
LM_REPS = 5  # timed calls per LM batch and kind, after one warm-up
LM_BATCHES = ((4, 2048, 32), (2, 1000, 8))  # (prompts, prompt tokens, new tokens)
CONV_RTOL, CONV_BF16_RTOL = 1e-5, 1e-2  # B4 vs its plain version, relative L2
STREAM_RTOL = 2e-4  # streamed digital vs ideal STHC conv (the reference test's bound)
TIE = 1e-4  # top-two logits this close (relative to their scale) may break either way
CLASSIFY_BATCH = 16  # clips per batch, as benchmarks/accuracy.py evaluates
CLASSIFY_REPS = 7  # timed batches per route, after one warm-up
STREAM_FRAMES = 512  # frames of each of the four long clips
# the reference conv3d test sweep's shapes (tests/test_kernels.py):
# (b, c, o, k, h, t) -> x (b, c, h, h+2, t), w (o, c, k, k, min(k, t))
CONV_SWEEP = (
    (1, 1, 1, 1, 6, 4), (2, 4, 6, 3, 14, 10), (1, 3, 2, 2, 9, 5), (2, 2, 5, 3, 7, 7),
    (1, 4, 3, 1, 12, 9), (2, 1, 4, 2, 11, 6), (1, 2, 6, 3, 8, 8), (2, 3, 1, 2, 13, 4),
)


def _time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in one CUDA
    graph, replayed and timed with CUDA events, so the host's cost of
    launching each call is not in it (it is in ``_time_ms`` when a call
    takes the device less time than the host takes to launch it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = _time_ms(graph.replay, 5) / reps
    del graph
    return ms


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _bound_ms(nbytes: float, flops: float, rate: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _cuda_tool(name: str) -> str | None:
    found = shutil.which(name)
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    return cand if os.path.exists(cand) else None


def _demangle(names: list[str]) -> dict[str, str]:
    tool = shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    lines = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else {n: n for n in names}


def _ptxas_by_function(log: str) -> list[dict]:
    """``-Xptxas -v``'s registers, spills and stack, per entry function."""
    funcs, cur, props = [], None, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"function": ln.split("'")[1]}
            funcs.append(cur)
        elif "Function properties for" in ln:
            props = ln.split("Function properties for")[1].strip()
        elif cur is not None and "spill stores" in ln and props == cur["function"]:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            cur["stack_bytes"], cur["spill_store_bytes"], cur["spill_load_bytes"] = nums[:3]
        elif cur is not None and "registers" in ln:
            words = ln.replace(",", " ").split()
            cur["registers"] = int(words[words.index("registers") - 1])
    names = _demangle([f["function"] for f in funcs])
    for f in funcs:
        f["function"] = names[f["function"]]
    return funcs


def phase_build(libs: dict) -> dict:
    """Build every kernel library at once (one nvcc each, in parallel)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(libs)) as pool:
        futs = {name: pool.submit(mod.build) for name, mod in libs.items()}
        infos = {name: f.result() for name, f in futs.items()}
    report = {}
    for name, info in infos.items():
        funcs = _ptxas_by_function(info["log"])
        print(f"build: {name} {info['seconds']:.2f} s nvcc sm_90a -> {os.path.relpath(info['path'], ROOT)}")
        for f in funcs:
            print(
                f"build:   {f['function']}: {f.get('registers')} registers, "
                f"{f.get('spill_store_bytes')} bytes spill stores, "
                f"{f.get('spill_load_bytes')} bytes spill loads, {f.get('stack_bytes')} bytes stack"
            )
        warnings = [ln.strip() for ln in info["log"].splitlines() if "warning" in ln.lower()]
        for ln in warnings:
            print(f"build:   {ln}")
        report[name] = {"seconds": info["seconds"], "path": info["path"], "ptxas": funcs,
                        "warnings": warnings}
    return report


def _sass_counts(so_path: str, ops: tuple) -> dict | None:
    """Instructions of each kernel in a library's SASS (``cuobjdump``), by
    demangled name; None when the tool is missing."""
    tool = _cuda_tool("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            fn = ln.split("Function : ")[1].strip()
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in counts[fn]:
                if f" {op}" in ln:
                    counts[fn][op] += 1
    names = _demangle(list(counts))
    return {names[f]: c for f, c in counts.items()}


def check_ssd_build(so_path: str) -> dict | None:
    """B5's chunk-state and chunk-scan kernels, every instantiation, issue
    tensor-core MMAs (HMMA, mma.sync) in their SASS; the scan kernel's
    operands arrive by cp.async (LDGSTS)."""
    counts = _sass_counts(so_path, ("HMMA", "LDGSTS", "FFMA"))
    if counts is None:
        print("build: ssd SASS: cuobjdump not found, instructions not counted")
        return None
    mma = {f: c for f, c in counts.items() if "ssd_state_kernel" in f or "ssd_scan_kernel" in f}
    for f, c in mma.items():
        print(f"build: ssd SASS {f}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    if len(mma) != 4 or not all(c["HMMA"] for c in mma.values()) or not all(
        c["LDGSTS"] for f, c in mma.items() if "ssd_scan_kernel" in f
    ):
        raise AssertionError(f"the ssd builds lack tensor-core MMAs or cp.async: {mma}")
    return mma


def check_flash_build(flash_kernel, so_path: str) -> dict:
    """B6's builds as compiled: every (dtype, head dim)'s dynamic shared
    memory from the library equals ``kernel.smem_bytes`` and fits one
    block's 227 KB; in the SASS (``cuobjdump``), every bf16 build issues
    warpgroup tensor-core MMAs (HGMMA, wgmma) and asynchronous copies
    (LDGSTS, cp.async)."""
    plan = {}
    for dtype in flash_kernel.DTYPES:
        for d in flash_kernel.HEAD_DIMS:
            want, got = flash_kernel.smem_bytes(dtype, d), flash_kernel.smem_bytes_built(dtype, d)
            route = flash_kernel.ROUTES[(dtype, d)]
            print(f"build: flash ({str(dtype).removeprefix('torch.')}, D {d}) -> {route} kernel, "
                  f"{got} bytes dynamic shared memory")
            if got != want or not 0 < got <= flash_kernel.SMEM_PER_BLOCK:
                raise AssertionError(f"flash ({dtype}, {d}): library plans {got} bytes, kernel.py {want}")
            plan[f"{dtype}/{d}"] = {"route": route, "smem_bytes": got}
    counts = _sass_counts(so_path, ("HGMMA", "HMMA", "LDGSTS", "MUFU.EX2", "FFMA"))
    if counts is None:
        print("build: flash SASS: cuobjdump not found, instructions not counted")
        return {"plan": plan, "sass": None}
    wg = {f: c for f, c in counts.items() if "flash_wgmma_kernel" in f}
    for f, c in wg.items():
        print(f"build: flash SASS {f}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    if len(wg) != len(flash_kernel.HEAD_DIMS) or not all(c["HGMMA"] and c["LDGSTS"] for c in wg.values()):
        raise AssertionError(f"the bf16 flash builds lack wgmma or cp.async: {wg}")
    return {"plan": plan, "sass": wg}


def check_conv3d_build(so_path: str, warnings: list[str]) -> dict | None:
    """B4's tensor-core kernel issues warpgroup tensor-core MMAs (HGMMA,
    3xTF32 wgmma) and asynchronous copies (UTMALDG: TMA tensor-map loads
    of x; UBLKCP: bulk copies of B) in its SASS, and ptxas warned of no
    wgmma serialization for the library."""
    serial = [ln for ln in warnings if "wgmma" in ln and "serializ" in ln]
    if serial:
        raise AssertionError("ptxas serialized wgmma in the conv3d library:\n" + "\n".join(serial))
    counts = _sass_counts(so_path, ("HGMMA", "UTMALDG", "UBLKCP", "LDS", "FFMA"))
    if counts is None:
        print("build: conv3d SASS: cuobjdump not found, instructions not counted")
        return None
    tc = {f: c for f, c in counts.items() if "conv3d_tc_kernel" in f}
    for f, c in tc.items():
        print(f"build: conv3d SASS {f}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    if len(tc) != 1 or not all(c["HGMMA"] and c["UTMALDG"] and c["UBLKCP"] for c in tc.values()):
        raise AssertionError(f"the conv3d tensor-core kernel lacks wgmma or asynchronous copies: {tc}")
    return tc


def phase_kernels(kernel, ref, seed: int, launches: dict) -> list[dict]:
    """Each kernel vs its plain version at the serving path's shapes."""
    from repro_torch.core import spectral_conv

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    F = 90 * 120 * 37  # rfftn grid of a 64-frame window at 60x80, 30x40x8
    L = 4 * 31 * 41 * 57  # one readout launch: 4 windows x H' x W' x step
    O, C = 9, 1

    def cplx(*shape):
        return torch.complex(
            torch.randn(shape, generator=g, device=dev),
            torch.randn(shape, generator=g, device=dev),
        )

    rows = []

    def row(name, fn, plain, library, check, nbytes, flops, launches_of, reps=20, graph=False):
        out = fn()
        exp = plain()
        err, ok = check(out, exp)
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version ({err})")
        timer = _graph_ms if graph else _time_ms
        ms = timer(fn, reps)
        plain_ms = _time_ms(plain, 3)
        lib_ms = timer(library, reps) if library is not None else None
        bound, by = _bound_ms(nbytes, flops)
        r = {
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/stmul/csrc/stmul.cu",
            "replaces": launches_of[1],
            "launches": launches[launches_of[0]],
            "max_abs_err": err["max_abs_err"],
            "max_err": err["max_abs_err"],
            "rel_l2": err.get("rel_l2"),
            "ms": ms,
            "kernel_ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": lib_ms,
        }
        if graph:  # the same calls launched one by one, host time included
            r["host_ms"] = _time_ms(fn, reps)
            print(f"kernels: {name} {ms:.4f} ms on the device (CUDA graph of {reps} calls), "
                  f"{r['host_ms']:.4f} ms a call launched one by one")
        rows.append(r)
        del out, exp

    def mac_bits(out, exp):
        mx = float(torch.max(torch.abs(out - exp)))
        return {"max_abs_err": mx}, _bits_equal(torch.view_as_real(out), torch.view_as_real(exp))

    # B1: sequential rung, a tenant group of 2 streams x 4 windows per chunk
    x = cplx(8, C, F)
    gr = cplx(O, C, F)
    b1_bytes = (x.numel() + gr.numel() + 8 * O * F) * 8
    b1_flops = 8 * 8 * O * C * F
    with spectral_conv.full_precision():
        for version, name in ((2, "spectral_mac"), (1, "spectral_mac[v1]")):
            row(
                name,
                lambda v=version: kernel.spectral_mac_cuda(x, gr, v),
                lambda v=version: ref.spectral_mac_ref(x, gr, v),
                lambda: torch.einsum("bcf,ocf->bof", x, gr),
                mac_bits, b1_bytes, b1_flops,
                ("spectral_mac", "src/repro/kernels/stmul/kernel.py:147"),
            )
    del x, gr

    # B1 off the rung's plan, bitwise: an odd F (scalar path), three
    # channels (the C > 1 kernel, even and odd F) and 20 kernels at C = 1
    # (registers, chunks of 9, 9 and 2)
    for B_, O_, C_, Fx in ((8, O, C, F - 1), (4, O, 3, 10_000), (4, O, 3, 10_001), (3, 20, 1, 10_001)):
        xx, gg = cplx(B_, C_, Fx), cplx(O_, C_, Fx)
        plan = kernel.mac_plan(B_, O_, C_, Fx)
        for version in (2, 1):
            err, ok = mac_bits(kernel.spectral_mac_cuda(xx, gg, version), ref.spectral_mac_ref(xx, gg, version))
            print(f"kernels: B1 v{version} x ({B_}, {C_}, {Fx}) grating ({O_}, {C_}, {Fx}), plan {plan}: "
                  f"{'bitwise' if ok else 'DIFFERS'}")
            if not ok:
                raise AssertionError(f"B1 v{version} at B={B_}, O={O_}, C={C_}, F={Fx} differs ({err})")
        del xx, gg

    # B2: pooled rung, 4 encoded streams x 4 windows against an 18-row
    # arena; then irregular, unsorted offsets into a 64-row arena, and an
    # odd F (rows that are not 16-byte aligned); bitwise in every case
    x = cplx(16, C, F)
    b2_cases = (
        ("", [0, 0, 9, 9] * 4, 18, F),
        (",irregular", [37, 3, 55, 12, 0, 41, 29, 8, 50, 19, 33, 1, 46, 24, 5, 14], 64, F),
        (",odd F", [0, 0, 9, 9] * 4, 18, F - 1),
    )
    for tag, offs, n_rows, Fx in b2_cases:
        xx = x if Fx == F else x[:, :, :Fx].contiguous()
        for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            pre = torch.randn((n_rows, C, Fx), generator=g, device=dev).to(dtype)
            pim = torch.randn((n_rows, C, Fx), generator=g, device=dev).to(dtype)
            sel = torch.complex(pre.float(), pim.float())[
                torch.as_tensor(offs, device=dev)[:, None] + torch.arange(O, device=dev)[None]
            ]
            used = len({o + j for o in offs for j in range(O)})
            nbytes = (xx.numel() * 8 + 2 * used * C * Fx * pre.element_size()
                      + 16 * O * Fx * 8)
            with spectral_conv.full_precision():
                row(
                    f"spectral_mac_grouped[{dname}{tag}]",
                    lambda: kernel.spectral_mac_grouped_cuda(xx, pre, pim, offs, O),
                    lambda: ref.spectral_mac_grouped_ref(xx, pre, pim, offs, O),
                    lambda: torch.einsum("bcf,bocf->bof", xx, sel),
                    mac_bits, nbytes, 8 * 16 * O * C * Fx,
                    ("spectral_mac_grouped", "src/repro/kernels/stmul/kernel.py:248"),
                )
            del pre, pim, sel
        del xx
    del x

    # B2 beyond the video rung's C = 1: three channels (x staged beside
    # the arena), nine kernels in two chunks of o rows, even and odd F
    for Fx in (10_000, 10_001):
        xx = cplx(4, 3, Fx)
        for dtype in (torch.float32, torch.bfloat16):
            pre = torch.randn((12, 3, Fx), generator=g, device=dev).to(dtype)
            pim = torch.randn((12, 3, Fx), generator=g, device=dev).to(dtype)
            err, ok = mac_bits(kernel.spectral_mac_grouped_cuda(xx, pre, pim, [3, 0, 3, 1], O),
                               ref.spectral_mac_grouped_ref(xx, pre, pim, [3, 0, 3, 1], O))
            print(f"kernels: B2 x (4, 3, {Fx}) {dtype} against a 12-row arena, 9 outputs: "
                  f"{'bitwise' if ok else 'DIFFERS'}")
            if not ok:
                raise AssertionError(f"B2 at C = 3, F = {Fx}, {dtype} differs ({err})")

    # B3: pooled readout of 4 streams x 9 kernels; rows with NaN, -inf,
    # exact ties and signed zeros
    R = 4 * O
    vals = torch.randn((R, L), generator=g, device=dev)
    vals[:, 1::7] = vals[:, 0::7][:, : vals[:, 1::7].shape[1]]  # ties
    vals[1, 123] = float("nan")
    vals[2, :] = float("-inf")
    vals[2, 5:8] = torch.tensor([1.0, float("-inf"), 1.0], device=dev)
    vals[3, :] = 0.0
    vals[3, 10::3] = -0.0
    vals[4, 1000:] = float("-inf")
    gidx = torch.randperm(L, generator=g, device=dev).to(torch.int32)
    vals_tiefree = torch.randperm(R * L, generator=g, device=dev).float().reshape(R, L)

    def topk_check(out, exp):
        s_ok = _bits_equal(out[0], exp[0])
        i_ok = torch.equal(out[1], exp[1])
        both = torch.isfinite(out[0]) & torch.isfinite(exp[0])
        mx = float(torch.max(torch.abs(out[0][both] - exp[0][both]))) if both.any() else 0.0
        return {"max_abs_err": mx}, s_ok and i_ok

    # the pooled rung's 36 rows at k = 1 and 3, the sequential rung's 9
    # (one stream's group) and 18 (two streams) at k = 1
    for R_, k in ((R, 1), (R, 3), (9, 1), (18, 1)):
        v = vals[:R_]
        row(
            f"topk_readout[k={k}]" if R_ == R else f"topk_readout[k={k},R={R_}]",
            lambda k=k, v=v: kernel.topk_readout_cuda(v, gidx, k),
            lambda k=k, v=v: ref.topk_readout_ref(v, gidx, k),
            lambda k=k, R_=R_: torch.topk(vals_tiefree[:R_], k, dim=-1),
            topk_check, R_ * L * 4 + L * 4 + R_ * k * 8, 0,
            ("topk_readout", "src/repro/kernels/stmul/kernel.py:434"), graph=True,
        )
    # tie runs, NaN and -inf stretches and signed zeros on the slice
    # boundaries the host plan picks, bitwise against the plain version,
    # and every other list width K (k = 2, 8, 16, 32) on six of the rows
    for R_, k in ((R, 1), (R, 3), (9, 1), (18, 1), (6, 2), (6, 8), (6, 16), (6, 32)):
        v = _straddling_scores(kernel.topk_plan(R_, L), R_, L, g)
        out = kernel.topk_readout_cuda(v, gidx, k)
        err, ok = topk_check(out, ref.topk_readout_ref(v, gidx, k))
        print(f"kernels: B3 ({R_}, {L}) k={k} with ties, NaN, -inf and +-0 on the "
              f"{kernel.topk_plan(R_, L)} slice boundaries: {'bitwise' if ok else 'DIFFERS'}")
        if not ok:
            raise AssertionError(f"B3 ({R_}, {L}) k={k} differs on slice boundaries ({err})")
        del v, out
    torch.cuda.synchronize()
    return rows


def _straddling_scores(plan, R, L, g) -> torch.Tensor:
    """(R, L) random scores with, around one slice boundary of ``plan``
    per row (rows take the boundaries in turn): a run of equal maxima
    across it, NaN just after or just before it, a row of -inf with two
    finite scores across it, a run of +0 / -0 maxima across it, and a
    -inf stretch across it with equal maxima at both ends."""
    S, n = plan
    v = torch.randn((R, L), generator=g, device="cuda")
    cuts = [s * n for s in range(1, S)] or [L // 2]
    for r in range(R):
        c = cuts[r % len(cuts)]
        kind = r % 6
        if kind == 0:
            v[r, max(c - 3, 0) : c + 3] = 10.0
        elif kind == 1:
            v[r, c] = float("nan")
        elif kind == 2:
            v[r, c - 1] = float("nan")
        elif kind == 3:
            v[r] = float("-inf")
            v[r, c - 1] = v[r, min(c + 1, L - 1)] = 1.0
        elif kind == 4:
            v[r] = -1.0 - torch.abs(v[r])
            v[r, max(c - 2, 0) : c + 2] = torch.tensor([0.0, -0.0, 0.0, -0.0], device="cuda")[
                : min(c + 2, L) - max(c - 2, 0)]
        else:
            lo, hi = max(c - 5000, 1), min(c + 5000, L - 1)
            v[r, lo:hi] = float("-inf")
            v[r, lo - 1] = v[r, hi] = 9.0
    return v


def _profile(fn) -> dict:
    """Wall time of one call, the device time of the kernels it ran (by
    name, from the profiler's CUDA events) and the device's busy share.
    Kernels on one stream do not overlap, so their sum is busy time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _device_time(prof, wall_ms, 1)


def _pass_ms(fn, marker: str, reps: int = 10) -> dict:
    """Device ms per call of each kernel whose name holds ``marker``
    (the launches behind one wrapper call), from the profiler's CUDA
    activity over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if marker in e.key and us:
            out[e.key.split("namespace)::")[-1].split("(")[0]] = us / reps / 1e3
    return out


def _device_time(prof, wall_ms: float, calls: int) -> dict:
    """Per call: the device time of the kernels a profile holds, by name,
    their sum (busy time) and its share of ``wall_ms``.  The step markers
    a profiler schedule adds are not kernels."""
    from torch.autograd import DeviceType

    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep"):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    busy_ms = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    # the eight longest, then every kernel of this repository's own
    top = ranked[:8] + [kv for kv in ranked[8:] if any(m in kv[0] for m in OWN_KERNELS)]
    return {
        "wall_ms": wall_ms,
        "device_ms": busy_ms if by_name else None,
        "busy_share": busy_ms / wall_ms if by_name else None,
        "top_kernels_ms": [(n[:80], ms) for n, ms in top],
    }


def _requests(rng):
    clips = [rng.rand(1, 1, 60, 80, 1024).astype(np.float32) for _ in range(5)]
    # request 2 shares request 1's clip (clip-dedup); C and D stack two
    # streams each
    return [
        ("A", clips[0]), ("B", clips[0]), ("C", clips[1]),
        ("C", clips[2]), ("D", clips[3]), ("D", clips[4]),
    ]


def _server(tenants, **cfg):
    from repro_torch.launch.serve import VideoSearchConfig, VideoSearchServer

    server = VideoSearchServer(
        frame_hw=(60, 80),
        cfg=VideoSearchConfig(window_frames=64, chunk_windows=4, use_pallas=True, **cfg),
    )
    for name, k, pipe in tenants:
        server.add_tenant(name, k, fidelity=pipe)
    return server


def _run(server, reqs, **kw):
    """One warm-up call, then ``SERVE_REPS`` timed calls of the batch.
    Returns the first timed output and the latencies (s); every call
    must answer every request, finite, and bitwise like the first."""
    server.search_batch(reqs, **kw)  # warm: cuFFT plans, allocator
    torch.cuda.synchronize()
    out, lat = None, []
    for _ in range(SERVE_REPS):
        t0 = time.perf_counter()
        res = server.search_batch(reqs, **kw)
        lat.append(time.perf_counter() - t0)
        for r in res:
            if not isinstance(r, dict):
                raise AssertionError(f"request failed: {r!r}")
            if r["scores"].shape != (1, 9) or not np.isfinite(r["scores"]).all():
                raise AssertionError(f"bad scores {r['scores']!r}")
        if out is None:
            out = res
        elif not all(np.array_equal(a["scores"], b["scores"]) for a, b in zip(out, res)):
            raise AssertionError("a repeated batch answered differently")
    return out, lat


def _mode_report(name, lat, frames, delta, extra="") -> dict:
    med = float(np.median(lat))
    print(
        f"serve: {name:11s} median {med * 1e3:8.2f} ms (min {min(lat) * 1e3:.2f}, "
        f"max {max(lat) * 1e3:.2f}, n={len(lat)})  {frames / med:10.1f} frames/s  "
        f"launches {delta}{extra}"
    )
    return {"latency_s": lat, "median_s": med, "frames_per_s": frames / med, "launches": delta}


def phase_serve(kernel, seed: int) -> dict:
    from repro_torch.core import fidelity as fid
    from repro_torch.core import spectral_conv
    from repro_torch.core.engine import clip_keys_for

    rng = np.random.RandomState(seed)
    ks = [rng.randn(9, 1, 30, 40, 8).astype(np.float32) for _ in range(4)]
    tenants = [
        ("A", ks[0], fid.ideal()),
        ("B", ks[1], fid.ideal()),
        ("C", ks[2], fid.physical()),
        ("D", ks[3], fid.pipeline(fid.SLMQuantize())),
    ]
    reqs = _requests(rng)
    frames = sum(c.shape[0] * c.shape[-1] for _, c in reqs)
    server = _server(tenants)
    report = {"modes": {}}
    fns = (kernel.spectral_mac_cuda, kernel.spectral_mac_grouped_cuda, kernel.topk_readout_cuda)

    def counts():
        return {f.__name__.removesuffix("_cuda"): f.launches for f in fns}

    kernel.reset_launches()
    modes = [
        ("pooled", server, {}, ("spectral_mac_grouped", "topk_readout")),
        ("sequential", server, {"pooled": False}, ("spectral_mac", "topk_readout")),
        ("stitched", server, {"return_volume": True}, ("spectral_mac_grouped",)),
    ]
    outs = {}
    for name, srv, kw, need in modes:
        before = counts()
        outs[name], lat = _run(srv, reqs, **kw)
        after = counts()
        delta = {k: after[k] - before[k] for k in after}
        for k in need:
            if delta[k] <= 0:
                raise AssertionError(f"{name}: kernel {k} was not launched")
        report["modes"][name] = _mode_report(name, lat, frames, delta)
    # fused (pooled) == stitched amax / argmax, bitwise
    for a, b in zip(outs["pooled"], outs["stitched"]):
        if not (np.array_equal(a["scores"].view(np.int32), b["scores"].view(np.int32))
                and np.array_equal(a["peak_frame"], b["peak_frame"])):
            raise AssertionError(f"fused != stitched for tenant {a['tenant']}")
        vol = b["volume"].reshape(1, 9, -1)
        if not (torch.equal(torch.amax(vol, -1).cpu(), torch.from_numpy(b["scores"]))):
            raise AssertionError("stitched scores are not the volume's amax")
    pooled_vs_seq = max(
        float(np.max(np.abs(a["scores"] - b["scores"]) / np.abs(b["scores"])))
        for a, b in zip(outs["pooled"], outs["sequential"])
    )
    if pooled_vs_seq > 1e-5:
        raise AssertionError(f"pooled vs sequential scores differ by {pooled_vs_seq:.3g}")
    report["pooled_vs_sequential_max_rel"] = pooled_vs_seq
    print(f"serve: fused == stitched bitwise; pooled vs sequential max rel {pooled_vs_seq:.3g}")
    del outs["stitched"]

    # where the time goes: host-side clip hashing (the dedup key), then a
    # profiled call of each rung
    t0 = time.perf_counter()
    clip_keys_for([c for _, c in reqs])
    report["host_clip_hash_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"profile: host clip hashing (dedup keys) {report['host_clip_hash_ms']:.2f} ms")
    for name, kw in (("pooled", {}), ("sequential", {"pooled": False})):
        prof = _profile(lambda kw=kw: server.search_batch(reqs, **kw))
        report["modes"][name]["profile"] = prof
        if prof["busy_share"] is None:
            busy = "not measured"
        else:
            busy = f"{prof['device_ms']:.2f} ms ({prof['busy_share']:.1%})"
        print(f"profile: {name:10s} wall {prof['wall_ms']:.2f} ms, device busy {busy}")
        for kname, ms in prof["top_kernels_ms"]:
            print(f"profile:   {ms:9.3f} ms  {kname}")

    bf16 = _server(tenants, grating_dtype="bfloat16")
    before = counts()
    out_bf, lat = _run(bf16, reqs)
    after = counts()
    delta = {k: after[k] - before[k] for k in after}
    for k in ("spectral_mac_grouped", "topk_readout"):
        if delta[k] <= 0:
            raise AssertionError(f"bf16 pooled: kernel {k} was not launched")
    bf_rel = max(
        float(np.max(np.abs(a["scores"] - b["scores"]) / np.abs(b["scores"])))
        for a, b in zip(out_bf, outs["pooled"])
    )
    if bf_rel > 2e-2:
        raise AssertionError(f"bf16 scores off the f32 ones by {bf_rel:.3g}")
    report["modes"]["pooled_bf16"] = _mode_report(
        "pooled_bf16", lat, frames, delta, f"  max rel vs f32 {bf_rel:.3g}"
    )
    report["modes"]["pooled_bf16"]["max_rel_vs_f32"] = bf_rel
    report["launches"] = counts()

    # correctness against direct correlation on a short clip (ideal tenant)
    short = rng.rand(1, 1, 60, 80, 128).astype(np.float32)
    got = server.search(short, tenant="A")
    direct = spectral_conv.direct_correlate3d(
        torch.from_numpy(short).cuda(), torch.from_numpy(ks[0]).cuda()
    ).reshape(1, 9, -1)
    want = torch.amax(direct, -1).cpu().numpy()
    rel = float(np.max(np.abs(got["scores"] - want) / np.abs(want)))
    if rel > 1e-4:
        raise AssertionError(f"ideal scores off direct correlation by {rel:.3g}")
    report["ideal_vs_direct_max_rel"] = rel
    print(f"serve: ideal tenant vs direct conv3d max rel {rel:.3g}")
    report["cursor_memory"] = _cursor_memory(tenants, server, rng)
    report["frames_per_request"] = 1024
    return report


def _cursor_memory(tenants, unbounded, rng) -> dict:
    """Host residency of cursor streams: a ``max_buffer_windows = 8``
    pooled search (an ideal and a physical tenant on one numpy stream)
    keeps the stream on the host, so its peak device memory must not grow
    by a quarter of the stream's bytes when the stream doubles; its
    detections must equal the unbounded server's bitwise."""
    bounded = _server(tenants, max_buffer_windows=8)
    warm = rng.rand(1, 1, 60, 80, 1024).astype(np.float32)
    bounded.search_batch([("A", warm), ("C", warm)])  # record, plan, pool
    unbounded.search_batch([("A", warm), ("C", warm)])
    peaks, out = {}, {}
    for T in MEM_STREAM_FRAMES:
        clip = rng.rand(1, 1, 60, 80, T).astype(np.float32)
        reqs = [("A", clip), ("C", clip)]
        for name, srv in (("bounded", bounded), ("unbounded", unbounded)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = srv.search_batch(reqs)
            torch.cuda.synchronize()
            peaks[f"{name}_{T}"] = torch.cuda.max_memory_allocated()
            out[name] = res
        for a, b in zip(out["bounded"], out["unbounded"]):
            if not (np.array_equal(a["scores"].view(np.int32), b["scores"].view(np.int32))
                    and np.array_equal(a["peak_frame"], b["peak_frame"])):
                raise AssertionError(f"cursor detections at {T} frames differ from the unbounded call")
        print(f"serve: cursor {T}-frame numpy stream, max_buffer_windows 8: peak device memory "
              f"{peaks[f'bounded_{T}'] / 2**20:.1f} MiB (unbounded {peaks[f'unbounded_{T}'] / 2**20:.1f} "
              f"MiB); detections equal the unbounded call's bitwise")
        del clip, reqs, out["bounded"], out["unbounded"]
    t0, t1 = MEM_STREAM_FRAMES
    grew = peaks[f"bounded_{t1}"] - peaks[f"bounded_{t0}"]
    limit = 60 * 80 * t0 * 4 / 4  # a quarter of the shorter stream's bytes
    print(f"serve: cursor peak grew by {grew / 2**20:.2f} MiB from {t0} to {t1} frames "
          f"(limit {limit / 2**20:.2f} MiB)")
    if not grew < limit:
        raise AssertionError(f"cursor peak memory grew by {grew} bytes (limit {limit:.0f})")
    return {"peak_bytes": peaks, "growth_bytes": grew, "limit_bytes": limit}


def _ssd_cost(Bb, L, H, G, P, N, Q) -> tuple[float, float]:
    """Bytes (each input read once, each output written once) and FLOPs of
    one chunked SSD scan.  Per (batch, chunk, group): the causal lower
    triangle of the scores C·Bᵀ, Q(Q+1)/2 dot products of length N
    (Q(Q+1)N), which depend on the group's B and C only and so are shared
    by its H / G heads.  Per (batch, chunk, head): the intra-chunk
    product, Q(Q+1)/2 rows of P (Q(Q+1)P), and the state readout and the
    state update, 2QNP each."""
    nbytes = 4 * (2 * Bb * L * H * P + Bb * L * H + H + 2 * Bb * L * G * N + Bb * H * P * N)
    flops = Bb * (L // Q) * (G * Q * (Q + 1) * N + H * (Q * (Q + 1) * P + 4 * Q * N * P))
    return nbytes, flops


def _serve_lm(tag, cfg, server_for, gen, kernel_fn, reset) -> tuple[dict, dict]:
    """``LMServer.generate`` over ``LM_BATCHES``: one warm-up, then
    ``LM_REPS`` timed prefill-only and full calls per batch; the
    kernel's launch counter, zeroed before the timed calls, must read
    ``n_layers`` x the prefills run.  Then one profiled prefill and one
    profiled generate of batch one.  Returns the report and the prompts
    by (rows, length)."""
    report = {"config": cfg.name, "params": cfg.num_params(), "batches": {}}
    kname = kernel_fn.__name__
    launches = 0
    prompts_by, servers = {}, {}
    for Bb, S, n_new in LM_BATCHES:
        server = servers[(Bb, S)] = server_for(S + n_new)
        prompts = torch.randint(0, cfg.vocab, (Bb, S), generator=gen, device="cuda")
        prompts_by[(Bb, S)] = prompts
        server.generate(prompts, n_new)  # warm: cuBLAS handles, allocator
        server.generate(prompts, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        pre, full, outs = [], [], []
        for _ in range(LM_REPS):
            t0 = time.perf_counter()
            server.generate(prompts, 1)  # prefill + argmax; ends in a host copy
            pre.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            outs.append(server.generate(prompts, n_new))
            full.append(time.perf_counter() - t0)
        n_launch = kernel_fn.launches
        prefills = 2 * LM_REPS
        if n_launch != cfg.n_layers * prefills:
            raise AssertionError(
                f"{kname} launched {n_launch} times for {prefills} prefills of {cfg.n_layers} layers"
            )
        launches += n_launch
        for o in outs:
            if o.shape != (Bb, n_new) or not ((0 <= o) & (o < cfg.vocab)).all():
                raise AssertionError(f"bad tokens {o!r}")
            if not np.array_equal(o, outs[0]):
                raise AssertionError("a repeated generate answered differently")
        med_pre, med_full = float(np.median(pre)), float(np.median(full))
        dec_s = (med_full - med_pre) / (n_new - 1)
        rec = {
            "prompts": Bb, "prompt_tokens": S, "new_tokens": n_new,
            "prefill_s": pre, "generate_s": full,
            "prefill_median_ms": med_pre * 1e3,
            "decode_ms_per_token": dec_s * 1e3,
            "prefill_tokens_per_s": Bb * S / med_pre,
            "decode_tokens_per_s": Bb / dec_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "kernel_launches": n_launch,
            "first_tokens": outs[0][:, :8].tolist(),
        }
        report["batches"][f"{Bb}x{S}+{n_new}"] = rec
        print(
            f"{tag}: {Bb}x{S} prefill median {med_pre * 1e3:.2f} ms (min {min(pre) * 1e3:.2f}, "
            f"max {max(pre) * 1e3:.2f}, n={len(pre)}) {rec['prefill_tokens_per_s']:.1f} tok/s; "
            f"decode {dec_s * 1e3:.3f} ms/token {rec['decode_tokens_per_s']:.1f} tok/s "
            f"(generate {n_new}: median {med_full * 1e3:.2f} ms); peak mem "
            f"{rec['max_memory_allocated'] / 2**30:.2f} GiB; {kname} launches {n_launch}"
        )
    report["kernel_launches"] = launches

    # where the time goes: one profiled prefill and one profiled generate
    Bb, S, n_new = LM_BATCHES[0]
    prompts = prompts_by[(Bb, S)]
    for name, n in (("prefill", 1), ("generate", n_new)):
        prof = _profile(lambda n=n: servers[(Bb, S)].generate(prompts, n))
        report[f"profile_{name}"] = prof
        busy = ("not measured" if prof["busy_share"] is None
                else f"{prof['device_ms']:.2f} ms ({prof['busy_share']:.1%})")
        print(f"profile: {tag} {name:8s} wall {prof['wall_ms']:.2f} ms, device busy {busy}")
        for kn, ms in prof["top_kernels_ms"]:
            print(f"profile:   {ms:9.3f} ms  {kn}")
    return report, prompts_by


def phase_lm(seed: int) -> tuple[dict, list[dict]]:
    """LM serving at mamba2-370m's published config; returns the report
    and the B5 kernel rows."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.launch.serve import LMServer
    from repro_torch.models import mamba2

    cfg = configs.get_config("mamba2-370m")
    gen = torch.Generator("cuda").manual_seed(seed)
    server = LMServer(cfg, mamba2.init_params(cfg, gen, device="cuda"), device="cuda")
    report, prompts_by = _serve_lm(
        "lm", cfg, lambda max_len: server, gen, ssd_kernel.ssd_chunked_cuda,
        ssd_kernel.reset_launches,
    )
    launches = report["kernel_launches"]
    prompts = prompts_by[LM_BATCHES[0][:2]]

    # B5 against its plain version on layer 0's SSD inputs: batch one,
    # the 2 x 1024 grid that batch two's padded prompts give it, one
    # 2048-token prompt (Bb·H = 32 heads), and the (16, 16, 16) build
    # that ``serve --mode lm`` runs on the smoke config
    def b5_inputs(m, c, toks):
        with torch.inference_mode():
            x0 = m.embed.to(c.compute_dtype)[toks]
            return [t.contiguous() for t in m.layers[0].ssd_inputs(x0)]

    def b5_check(args, chunk):
        y_k, s_k = ssd_kernel.ssd_chunked_cuda(*args, chunk)
        y_p, s_p = ssd_ref.ssd_chunked_ref(*args, chunk=chunk)
        rel_y, rel_s = _rel_l2(y_k, y_p), _rel_l2(s_k, s_p)
        mx = max(float(torch.max(torch.abs(y_k - y_p))), float(torch.max(torch.abs(s_k - s_p))))
        Bb, L, H, P = args[0].shape
        N = args[3].shape[3]
        print(
            f"lm: B5 ({chunk}, {P}, {N}) vs plain on layer-0 inputs {Bb}x{L}: "
            f"y rel L2 {rel_y:.3g}, S rel L2 {rel_s:.3g}, max abs {mx:.3g}"
        )
        if not (rel_y <= SSD_RTOL and rel_s <= SSD_RTOL):
            raise AssertionError(f"B5 disagrees with its plain version (y {rel_y:.3g}, S {rel_s:.3g})")
        return max(rel_y, rel_s), mx

    model = server.model
    rows = []
    for tag, toks in (("", prompts), ("[2x1024]", prompts[:2, :1024]), ("[1x2048]", prompts[:1])):
        args = b5_inputs(model, cfg, toks)
        rel, mx = b5_check(args, cfg.chunk)
        Bb, L, H, P = args[0].shape
        G, N = args[3].shape[2:]
        ms = _time_ms(lambda: ssd_kernel.ssd_chunked_cuda(*args, cfg.chunk), 20)
        plain_ms = _time_ms(lambda: ssd_ref.ssd_chunked_ref(*args, chunk=cfg.chunk), 3)
        passes = _pass_ms(lambda: ssd_kernel.ssd_chunked_cuda(*args, cfg.chunk), "ssd_")
        print(f"lm: B5 {Bb}x{L} passes: " + ", ".join(f"{n} {ms:.4f} ms" for n, ms in passes.items()))
        cost = _ssd_cost(Bb, L, H, G, P, N, cfg.chunk)
        # the products run on the TF32 tensor cores, three per product
        # (3xTF32); the FMA pipes' float32 bound is kept beside it
        bound, by = _bound_ms(*cost, rate=TF32_FLOPS / 3)
        bound_f32, _ = _bound_ms(*cost)
        rows.append({
            "name": f"ssd_chunked{tag}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:82",
            "launches": launches,
            "max_abs_err": mx,
            "max_err": mx,
            "rel_l2": rel,
            "ms": ms,
            "kernel_ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by,
            "bound_f32_fma_ms": bound_f32,
                "library_ms": None,
            "shape": {"Bb": Bb, "L": L, "H": H, "G": G, "P": P, "N": N, "chunk": cfg.chunk},
        })
        del args
    scfg = configs.get_smoke_config("mamba2-370m")
    small = mamba2.init_params(scfg, gen, device="cuda")
    toks = torch.randint(0, scfg.vocab, (2, 64), generator=gen, device="cuda")
    rel, mx = b5_check(b5_inputs(small, scfg, toks), scfg.chunk)
    report["b5_smoke_build"] = {"rel_l2": rel, "max_abs_err": mx, "shape": [2, 64]}
    del small

    # a 2-layer float32 model at full width: kernel route == plain route
    cfg2 = dataclasses.replace(
        cfg, n_layers=2, param_dtype=torch.float32, compute_dtype=torch.float32
    )
    m_kernel = mamba2.init_params(cfg2, gen, device="cuda")
    m_plain = mamba2.Mamba2(dataclasses.replace(cfg2, ssd_impl="chunked"), "cuda")
    m_plain.load_state_dict(m_kernel.state_dict())
    with torch.inference_mode():
        l_kernel, _ = m_kernel.prefill(prompts_by[LM_BATCHES[1][:2]])
        l_plain, _ = m_plain.prefill(prompts_by[LM_BATCHES[1][:2]])
    rel = _rel_l2(l_kernel.float(), l_plain.float())
    report["f32_2layer_logits_rel_l2"] = rel
    print(f"lm: 2-layer f32 last logits, kernel vs plain route: rel L2 {rel:.3g}")
    if not (rel <= LM_RTOL and torch.isfinite(l_kernel).all()):
        raise AssertionError(f"kernel and plain routes disagree: rel L2 {rel:.3g}")
    return report, rows


def _attn_cost(B, Sq, Sk, H, G, D, causal, itemsize) -> tuple[float, float]:
    """Bytes (q, k, v read once, o written once) and FLOPs (4·D per
    query-key pair the mask keeps: the causal triangle, top-left
    aligned) of one attention forward."""
    nbytes = itemsize * D * (2 * B * Sq * H + 2 * B * Sk * G)
    n = min(Sq, Sk)
    pairs = n * (n + 1) // 2 + max(Sq - Sk, 0) * Sk if causal else Sq * Sk
    return nbytes, 4 * D * B * H * pairs


@contextlib.contextmanager
def _dot_f32_decode():
    """Decode attention on its ``_dot_f32`` route (the cache widened to
    float32) whatever the tensors, for the comparison with the bf16-GEMM
    route."""
    from repro_torch.models import common

    route = common._bf16_gemm_route
    common._bf16_gemm_route = lambda q, k, v: False
    try:
        yield
    finally:
        common._bf16_gemm_route = route


def _decode_route_check(cfg, qkv, batch, server, prompts, batches) -> dict:
    """At layer 0's decode shapes (the last prompt position's q against
    a cache of prompt + new tokens), decode attention's bf16-GEMM route
    against its ``_dot_f32`` route on the same tensors: each
    product's float32 output within ``DECODE_DOT_RTOL``, the bf16 output
    within ``DECODE_OUT_RTOL``, and no cache-sized float32 copy (the
    route's extra peak memory below the cache's float32 bytes).  Then
    decode ms/token of ``generate`` on each route, in turns."""
    from repro_torch.models import common

    Bb, S, n_new = batch
    q, k, v = qkv
    M, G, D, H = S + n_new, k.shape[2], k.shape[3], q.shape[2]
    R = H // G
    kc = torch.zeros((Bb, M, G, D), dtype=k.dtype, device="cuda")
    vc = torch.zeros_like(kc)
    kc[:, :S], vc[:, :S] = k, v
    q1 = q[:, -1:].contiguous()
    kv_len = torch.full((Bb,), S, dtype=torch.int32, device="cuda")
    res = {}
    with torch.inference_mode():
        for name, ctx in (("gemm", contextlib.nullcontext()), ("dot_f32", _dot_f32_decode())):
            with ctx:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = common.decode_attention(q1, kc, vc, kv_len)
                torch.cuda.synchronize()
                res[name] = (out, torch.cuda.max_memory_allocated() - base)
        rel_out = _rel_l2(res["gemm"][0].float(), res["dot_f32"][0].float())
        qf = (q1 * (1.0 / D ** 0.5)).reshape(Bb, 1, G, R, D)
        s_g = common._cache_dot(qf.permute(0, 2, 3, 1, 4).reshape(Bb, G, R, D), kc, True)
        s_d = common._dot_f32("bqgrd,bkgd->bgrqk", qf, kc)
        rel_s = _rel_l2(s_g.reshape(s_d.shape), s_d)
        p = torch.exp(s_d - s_d.amax(-1, keepdim=True)).to(vc.dtype)
        o_g = common._cache_dot(p.reshape(Bb, G, R, M), vc, False)
        o_d = common._dot_f32("bgrqk,bkgd->bgrqd", p, vc)
        rel_o = _rel_l2(o_g.reshape(o_d.shape), o_d)
    cache_f32 = kc.numel() * 4
    extra = {name: r[1] for name, r in res.items()}
    print(
        f"lm_dense: decode route: attention q {tuple(q1.shape)} cache {tuple(kc.shape)} bf16, "
        f"bf16-GEMM vs _dot_f32 route: q.k rel L2 {rel_s:.3g}, p.v rel L2 {rel_o:.3g} "
        f"(<= {DECODE_DOT_RTOL:g}), output rel L2 {rel_out:.3g} (<= {DECODE_OUT_RTOL:g}); "
        f"extra peak memory {extra['gemm'] / 2**20:.2f} MiB vs {extra['dot_f32'] / 2**20:.2f} MiB "
        f"(the cache in float32: {cache_f32 / 2**20:.2f} MiB)"
    )
    if not (rel_s <= DECODE_DOT_RTOL and rel_o <= DECODE_DOT_RTOL and rel_out <= DECODE_OUT_RTOL):
        raise AssertionError(f"decode routes disagree: q.k {rel_s:.3g}, p.v {rel_o:.3g}, out {rel_out:.3g}")
    if not extra["gemm"] < cache_f32:
        raise AssertionError(f"the bf16-GEMM route allocated {extra['gemm']} bytes, a cache-sized copy")
    # decode ms/token on each route, in turns (gemm, dot, dot, gemm, ...)
    pre = batches[f"{Bb}x{S}+{n_new}"]["prefill_median_ms"]
    full = {"gemm": [], "dot_f32": []}
    for name in ("gemm", "dot_f32", "dot_f32", "gemm", "gemm", "dot_f32"):
        with contextlib.nullcontext() if name == "gemm" else _dot_f32_decode():
            t0 = time.perf_counter()
            server.generate(prompts, n_new)
            full[name].append(time.perf_counter() - t0)
    dec = {n: (float(np.median(t)) * 1e3 - pre) / (n_new - 1) for n, t in full.items()}
    print(f"lm_dense: decode route: {Bb}x{S}+{n_new}: {dec['gemm']:.3f} ms/token on the bf16-GEMM "
          f"route, {dec['dot_f32']:.3f} ms/token on the _dot_f32 route (3 calls each, in turns)")
    # the device's share, which the host's load does not move: one
    # profiled generate on each route
    dev_ms = {}
    for name in ("gemm", "dot_f32"):
        with contextlib.nullcontext() if name == "gemm" else _dot_f32_decode():
            dev_ms[name] = _profile(lambda: server.generate(prompts, n_new))["device_ms"]
    shown = {n: "not measured" if v is None else f"{v:.2f} ms" for n, v in dev_ms.items()}
    print(f"lm_dense: decode route: device time of one generate {Bb}x{S}+{n_new}: {shown['gemm']} on the "
          f"bf16-GEMM route, {shown['dot_f32']} on the _dot_f32 route")
    return {"qk_rel_l2": rel_s, "pv_rel_l2": rel_o, "out_rel_l2": rel_out,
            "extra_peak_bytes": extra, "cache_f32_bytes": cache_f32,
            "decode_ms_per_token": dec, "generate_device_ms": dev_ms}


def phase_lm_dense(seed: int) -> tuple[dict, list[dict]]:
    """Dense-transformer LM serving at qwen2-1.5b's published config;
    returns the report and the B6 kernel rows."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.launch.serve import LMServer
    from repro_torch.models import transformer

    cfg = configs.get_config("qwen2-1.5b")
    gen = torch.Generator("cuda").manual_seed(seed)
    model = transformer.init_params(cfg, gen, device="cuda")
    report, prompts_by = _serve_lm(
        "lm_dense", cfg,
        lambda max_len: LMServer(cfg, model, max_len=max_len, device="cuda"),
        gen, flash_kernel.flash_fwd_cuda, flash_kernel.reset_launches,
    )
    launches = report["kernel_launches"]

    def layer0_qkv(m, toks):
        with torch.inference_mode():
            B, S = toks.shape
            pos = torch.arange(S, device="cuda")[None].expand(B, S)
            return m.layers[0].qkv(m.embed.to(m.cfg.compute_dtype)[toks], pos)

    report["decode_route"] = _decode_route_check(
        cfg, layer0_qkv(model, prompts_by[LM_BATCHES[0][:2]]), LM_BATCHES[0],
        LMServer(cfg, model, max_len=sum(LM_BATCHES[0][1:]), device="cuda"),
        prompts_by[LM_BATCHES[0][:2]], report["batches"],
    )

    def check(tag, q, k, v, causal, rtol, atol=None):
        """B6 against its plain version; in bf16 also the worst row and the
        max abs error against the plain version on float32 inputs."""
        o_k = flash_kernel.flash_fwd_cuda(q, k, v, causal)
        o_p = flash_ref.flash_ref(q, k, v, causal=causal)
        rel = _rel_l2(o_k.float(), o_p.float())
        mx = float(torch.max(torch.abs(o_k.float() - o_p.float())))
        ok = rel <= rtol and (atol is None or mx <= atol) and bool(torch.isfinite(o_k).all())
        res = {"rel_l2": rel, "max_abs_err": mx}
        line = f"rel L2 {rel:.3g}, max abs {mx:.3g}"
        if q.dtype == torch.bfloat16:
            D = q.shape[-1]
            o_f = flash_ref.flash_ref(q.float(), k.float(), v.float(), causal=causal)
            err = (o_k.float() - o_f).reshape(-1, D)
            row = float(torch.max(
                torch.linalg.vector_norm(err, dim=1)
                / torch.linalg.vector_norm(o_f.reshape(-1, D), dim=1).clamp_min(1e-30)
            ))
            abs_f = float(torch.max(torch.abs(err)))
            vmax = float(torch.max(torch.abs(v.float())))
            ok = ok and row <= FLASH_BF16_ROW_RTOL and abs_f <= FLASH_BF16_ABS_V * vmax
            res.update(worst_row_rel_l2=row, max_abs_err_f32=abs_f, max_abs_v=vmax)
            line += (f"; vs plain on float32 inputs: worst row rel L2 {row:.3g} "
                     f"(<= {FLASH_BF16_ROW_RTOL:g}), max abs {abs_f:.3g} = {abs_f / vmax:.3g} max|v| "
                     f"(<= {FLASH_BF16_ABS_V:g})")
            del o_f, err
        print(
            f"lm_dense: B6 {tag} q {tuple(q.shape)} kv {tuple(k.shape)} {q.dtype} "
            f"causal={causal} vs plain: {line}"
        )
        if not ok:
            raise AssertionError(f"B6 {tag} disagrees with its plain version: {res}")
        return res

    # B6 at the main path's shapes: layer 0's real q, k, v of both batches
    rows = []
    for Bb, S, _ in LM_BATCHES:
        q, k, v = layer0_qkv(model, prompts_by[(Bb, S)])
        res = check(f"[{Bb}x{S}]", q, k, v, True, FLASH_BF16_RTOL)
        G = k.shape[2]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = _time_ms(lambda: flash_kernel.flash_fwd_cuda(q, k, v, True), 20)
        plain_ms = _time_ms(lambda: flash_ref.flash_ref(q, k, v, causal=True), 3)
        lib_ms = _time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), 20
        )
        cost = _attn_cost(Bb, S, S, cfg.n_heads, G, cfg.hd, True, q.element_size())
        bound, by = _bound_ms(*cost, rate=BF16_FLOPS)
        rows.append({
            "name": f"flash_fwd[{Bb}x{S}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash/csrc/flash_wgmma.cu",
            "replaces": "src/repro/kernels/flash/kernel.py:94",
            "launches": launches,
            "max_abs_err": res["max_abs_err"],
            "max_err": res["max_abs_err"],
            "rel_l2": res["rel_l2"],
            "worst_row_rel_l2": res["worst_row_rel_l2"],
            "max_abs_err_f32": res["max_abs_err_f32"],
            "max_abs_v": res["max_abs_v"],
            "ms": ms,
            "kernel_ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": lib_ms,
            "shape": {"B": Bb, "Sq": S, "Sk": S, "H": cfg.n_heads, "G": G, "D": cfg.hd,
                      "dtype": "bfloat16", "causal": True},
        })
        del q, k, v, qt, kt, vt

    # the bf16 build on the sweep's shapes
    bf16 = {}
    for B, Sq, Sk, H, G, D, causal in FLASH_BF16_SWEEP:
        q, k, v = (
            torch.randn((B, S, n, D), generator=gen, device="cuda").to(torch.bfloat16)
            for S, n in ((Sq, H), (Sk, G), (Sk, G))
        )
        tag = f"bf16[{B}x{Sq}x{Sk},h{H},g{G},d{D},{'causal' if causal else 'full'}]"
        bf16[tag] = check(tag, q, k, v, causal, FLASH_BF16_RTOL)
    report["b6_bf16_checks"] = bf16

    # float32 builds: the reference test sweep's shapes (head dims 16 and
    # 32, both mask settings, ragged lengths, the 40-vs-100 cross case)
    # and the qwen2 smoke config's layer 0 (head dim 24), which
    # ``serve --mode lm`` runs
    f32 = {}
    for B, Sq, Sk, H, G, D, causal in (
        (2, 37, 37, 4, 2, 16, True), (2, 37, 37, 4, 4, 16, False),
        (2, 96, 96, 8, 4, 32, True), (2, 71, 71, 2, 2, 32, False),
        (1, 40, 100, 4, 2, 16, False),
    ):
        q = torch.randn((B, Sq, H, D), generator=gen, device="cuda")
        k = torch.randn((B, Sk, G, D), generator=gen, device="cuda")
        v = torch.randn((B, Sk, G, D), generator=gen, device="cuda")
        tag = f"f32[{B}x{Sq}x{Sk},h{H},g{G},d{D}]"
        f32[tag] = check(tag, q, k, v, causal, FLASH_F32_RTOL, FLASH_F32_ATOL)
    scfg = configs.get_smoke_config("qwen2-1.5b")
    small = transformer.init_params(scfg, gen, device="cuda")
    toks = torch.randint(0, scfg.vocab, (2, 64), generator=gen, device="cuda")
    f32["smoke[2x64,d24]"] = check(
        "qwen2 smoke", *layer0_qkv(small, toks), True, FLASH_F32_RTOL, FLASH_F32_ATOL
    )
    report["b6_f32_checks"] = f32
    del small

    # a 2-layer float32 model at full width: kernel route == plain route
    cfg2 = dataclasses.replace(
        cfg, n_layers=2, param_dtype=torch.float32, compute_dtype=torch.float32
    )
    m_kernel = transformer.init_params(cfg2, gen, device="cuda")
    m_plain = transformer.Transformer(dataclasses.replace(cfg2, attn_impl="blockwise"), "cuda")
    m_plain.load_state_dict(m_kernel.state_dict())
    with torch.inference_mode():
        l_kernel, _ = m_kernel.prefill(prompts_by[LM_BATCHES[1][:2]])
        l_plain, _ = m_plain.prefill(prompts_by[LM_BATCHES[1][:2]])
    rel = _rel_l2(l_kernel.float(), l_plain.float())
    report["f32_2layer_logits_rel_l2"] = rel
    print(f"lm_dense: 2-layer f32 last logits, kernel vs plain route: rel L2 {rel:.3g}")
    if not (rel <= LM_RTOL and torch.isfinite(l_kernel).all()):
        raise AssertionError(f"kernel and plain routes disagree: rel L2 {rel:.3g}")
    return report, rows


def _conv_row(tag, x, w, launches, rtol, reps=20, want_route=None) -> dict:
    """One B4 ``kernel:`` row: the kernel ``kernel.route`` names (and, if
    given, it must be ``want_route``) against its plain version on the
    same inputs (bf16 inputs upcast to float32 for the plain version),
    then both timed with CUDA events.  The plain version is one cuDNN
    ``F.conv3d`` call (TF32 off), so its time is also the library time.
    Bound: bf16 at the bf16 tensor-core rate; float32 at the TF32 rate / 3
    (3xTF32 keeps float32 accuracy), the FMA pipes' bound beside it."""
    from repro_torch.kernels.conv3d import kernel as conv_kernel
    from repro_torch.kernels.conv3d import ref as conv_ref

    route = conv_kernel.route(tuple(x.shape), tuple(w.shape), x.dtype)
    if want_route is not None and route != want_route:
        raise AssertionError(f"B4 {tag} routed to {route}, not {want_route}")
    got = conv_kernel.conv3d_cuda(x, w).float()
    want = conv_ref.conv3d_ref(x.float(), w.float())
    rel = _rel_l2(got, want)
    mx = float(torch.max(torch.abs(got - want)))
    cost = ((x.numel() + w.numel() + got.numel()) * x.element_size(),
            conv_kernel.flops(tuple(x.shape), tuple(w.shape)))
    if x.dtype == torch.bfloat16:
        (bound, by), bound_fma = _bound_ms(*cost, rate=BF16_FLOPS), None
    else:
        (bound, by), bound_fma = _bound_ms(*cost, rate=TF32_FLOPS / 3), _bound_ms(*cost)[0]
    print(
        f"classify: B4 {tag} x {tuple(x.shape)} w {tuple(w.shape)} {x.dtype} route {route} vs plain: "
        f"rel L2 {rel:.3g}, max abs {mx:.3g}; bound {bound:.4f} ms ({by})"
        + ("" if bound_fma is None else f" at TF32 / 3, float32 FMA {bound_fma:.4f}")
    )
    if not (rel <= rtol and torch.isfinite(got).all()):
        raise AssertionError(f"B4 {tag} disagrees with its plain version (rel L2 {rel:.3g})")
    del got, want
    ms = _time_ms(lambda: conv_kernel.conv3d_cuda(x, w), reps)
    plain_ms = _time_ms(lambda: conv_ref.conv3d_ref(x, w), max(3, reps // 4))
    source = "conv3d_tc.cu" if route == "wgmma" else "conv3d.cu"
    return {
        "name": f"conv3d{tag}",
        "route": "cuda",
        "b4_route": route,
        "source": f"src/repro_torch/kernels/conv3d/csrc/{source}",
        "replaces": "src/repro/kernels/conv3d/kernel.py:41",
        "launches": launches,
        "max_abs_err": mx,
        "max_err": mx,
        "rel_l2": rel,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "bound_f32_fma_ms": bound_fma,
        "library_ms": plain_ms,
        "shape": {"x": list(x.shape), "w": list(w.shape), "dtype": str(x.dtype).removeprefix("torch.")},
    }


def _ties(logits: torch.Tensor) -> torch.Tensor:
    """Rows whose top-two logits lie within ``TIE`` of their scale."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) <= TIE * torch.amax(torch.abs(logits), dim=-1)


def _same_classes(what, got, want, logits) -> int:
    """Class predictions must match outside the near-ties of ``logits``;
    returns the tie count."""
    ties = _ties(logits).cpu().numpy()
    got, want = np.asarray(got), np.asarray(want)
    if not np.array_equal(got[~ties], want[~ties]):
        bad = int(np.sum((got != want) & ~ties))
        raise AssertionError(f"{what}: {bad} predictions differ outside near-ties")
    print(f"classify: {what}: {len(got)} predictions equal outside {int(ties.sum())} near-ties")
    return int(ties.sum())


def _profile_steady(fn, reps: int = 5) -> dict:
    """``_profile`` for calls of a few ms: the profiler skips one call and
    discards a warm-up call (its first activity records can be lost), then
    records ``reps`` calls; times are per call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=reps)) as prof:
        for i in range(2 + reps):
            if i == 2:
                t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof.step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    return _device_time(prof, wall_ms, reps)


def _timed(fn, batches) -> list[float]:
    """One warm-up call, then one timed call per batch (host clock around
    a call that ends in a host copy)."""
    fn(batches[0])
    torch.cuda.synchronize()
    lat = []
    for b in batches[1 : 1 + CLASSIFY_REPS]:
        t0 = time.perf_counter()
        fn(b)
        lat.append(time.perf_counter() - t0)
    return lat


def phase_classify(seed: int, stmul_kernel) -> tuple[dict, list[dict]]:
    """The paper's hybrid 3-D CNN at its full geometry (60x80x16 clips, 9
    kernels of 30x40x8, pool (8, 8, 3), hidden 128, 4 classes), random
    weights from a seeded generator on the card, on the synthetic-KTH
    test split; returns the report and the B4 and B1 kernel rows."""
    from repro_torch.configs import sthc_kth
    from repro_torch.core import hybrid, spectral_conv
    from repro_torch.data import kth_synthetic as kth
    from repro_torch.kernels.conv3d import kernel as conv_kernel
    from repro_torch.kernels.stmul import ref as stmul_ref
    from repro_torch.launch.serve import HybridClassifierServer

    cfg = sthc_kth.config()
    gen = torch.Generator("cuda").manual_seed(seed)
    params = hybrid.init_params(cfg, gen, device="cuda")
    x_test, y_test = kth.make_split("test")
    batches = [x_test[i : i + CLASSIFY_BATCH] for i in range(0, len(y_test), CLASSIFY_BATCH)]
    streams = np.stack([
        kth.render_clip(label, 17, 0, kth.VideoSpec(60, 80, STREAM_FRAMES))[None]
        for label in range(4)
    ])
    report = {"config": dataclasses.asdict(cfg) | {"dtype": "float32"}, "clips": len(y_test),
              "batch": CLASSIFY_BATCH, "stream_frames": STREAM_FRAMES, "routes": {}}

    def predict(impl):
        return lambda b: hybrid.predict(params, b, cfg, impl=impl).cpu().numpy()

    # the main path, counted: kernel launch counters at 0 just before it
    conv_kernel.reset_launches()
    stmul_kernel.reset_launches()
    digital_calls = 0
    with torch.no_grad():
        servers = {
            "server_physical": HybridClassifierServer(params, cfg, physical=True),
            "server_ideal": HybridClassifierServer(params, cfg, physical=False),
        }
        routes = {impl: predict(impl) for impl in ("digital", "spectral", "sthc_physical")}
        routes |= {name: srv.classify for name, srv in servers.items()}
        # every route over the whole split; digital and spectral logits kept
        logits = {
            impl: torch.cat([hybrid.forward(params, b, cfg, impl=impl) for b in batches])
            for impl in ("digital", "spectral")
        }
        digital_calls += len(batches)
        preds = {impl: lg.argmax(-1).cpu().numpy() for impl, lg in logits.items()}
        for name in ("sthc_physical", "server_physical", "server_ideal"):
            preds[name] = np.concatenate([routes[name](b) for b in batches])
        for name, p in preds.items():
            report["routes"][name] = {"accuracy": float(np.mean(p == y_test))}
        report["digital_vs_spectral_ties"] = _same_classes(
            "digital vs spectral", preds["digital"], preds["spectral"], logits["digital"]
        )
        report["server_ideal_vs_spectral_ties"] = _same_classes(
            "server ideal vs predict(spectral)", preds["server_ideal"], preds["spectral"],
            logits["spectral"],
        )
        # batch latency per route
        for name, fn in routes.items():
            lat = _timed(fn, batches)
            digital_calls += (1 + len(lat)) * (name == "digital")
            med = float(np.median(lat))
            report["routes"][name] |= {"latency_s": lat, "median_ms": med * 1e3,
                                       "clips_per_s": CLASSIFY_BATCH / med}
            print(
                f"classify: {name:15s} median {med * 1e3:8.3f} ms (min {min(lat) * 1e3:.3f}, "
                f"max {max(lat) * 1e3:.3f}, n={len(lat)})  {CLASSIFY_BATCH / med:10.1f} clips/s  "
                f"accuracy {report['routes'][name]['accuracy']:.4f} (random weights)"
            )
        ratio = report["routes"]["digital"]["median_ms"] / report["routes"]["spectral"]["median_ms"]
        report["digital_vs_spectral_ratio"] = ratio
        print(f"classify: digital / spectral median batch latency {ratio:.3f}")
        # long clips: 4 streams of STREAM_FRAMES, one per class
        srv = servers["server_ideal"]
        seg_preds = srv.classify_stream(streams)
        ot = cfg.conv_out_shape[2]
        n_seg = seg_preds.shape[1]
        seg_ties = 0
        for s in range(n_seg):
            sub = streams[..., s * ot : s * ot + cfg.frames]
            one = srv.classify(sub)
            ties = _ties(hybrid.forward(params, sub, cfg, impl="sthc_ideal")).cpu().numpy()
            if not np.array_equal(seg_preds[:, s][~ties], one[~ties]):
                raise AssertionError(f"classify_stream segment {s} != classify of its sub-clip")
            seg_ties += int(ties.sum())
        report["stream_segments"] = n_seg
        report["stream_segment_ties"] = seg_ties
        print(f"classify: classify_stream: {n_seg} segments x 4 streams equal classify of "
              f"their sub-clips outside {seg_ties} near-ties")
        conv_d = hybrid.conv_layer_stream(params, streams, cfg, impl="digital")
        conv_s = hybrid.conv_layer_stream(params, streams, cfg, impl="spectral")
        digital_calls += 1
        err = float(torch.max(torch.abs(conv_d - conv_s)) / torch.max(torch.abs(conv_d)))
        report["stream_digital_vs_ideal_max_rel"] = err
        print(f"classify: streamed digital (B4) vs streamed ideal STHC conv: max err / max "
              f"{err:.3g} (bound {STREAM_RTOL:g})")
        if not err <= STREAM_RTOL:
            raise AssertionError(f"streamed digital vs ideal conv differ by {err:.3g}")
        del conv_d, conv_s
        stream_jobs = {
            "classify_stream_physical": lambda s: servers["server_physical"].classify_stream(s),
            "classify_stream_ideal": lambda s: servers["server_ideal"].classify_stream(s),
            "conv_layer_stream_digital": lambda s: (
                hybrid.conv_layer_stream(params, s, cfg, impl="digital"), torch.cuda.synchronize()),
        }
        for name, fn in stream_jobs.items():
            lat = _timed(fn, [streams] * (1 + CLASSIFY_REPS))
            digital_calls += (1 + len(lat)) * (name == "conv_layer_stream_digital")
            med = float(np.median(lat))
            report["routes"][name] = {"latency_s": lat, "median_ms": med * 1e3,
                                      "frames_per_s": 4 * STREAM_FRAMES / med}
            print(f"classify: {name:26s} median {med * 1e3:9.3f} ms (min {min(lat) * 1e3:.3f}, "
                  f"max {max(lat) * 1e3:.3f}, n={len(lat)})  {4 * STREAM_FRAMES / med:10.1f} frames/s")
        torch.cuda.synchronize()
    b4 = conv_kernel.conv3d_cuda.launches
    b1 = stmul_kernel.spectral_mac_cuda.launches
    report["launches"] = {"conv3d": b4, "spectral_mac": b1, "digital_calls": digital_calls}
    print(f"classify: launches conv3d {b4} (digital calls {digital_calls}), spectral_mac {b1}")
    if b4 != digital_calls:
        raise AssertionError(f"B4 launched {b4} times for {digital_calls} digital calls")
    if b1 <= 0:
        raise AssertionError("B1 was not launched by the STHC routes")

    # where the time goes: five profiled calls of each route
    with torch.no_grad():
        for name, fn in routes.items():
            prof = _profile_steady(lambda fn=fn: fn(batches[0]))
            report["routes"][name]["profile"] = prof
            busy = ("not measured" if prof["busy_share"] is None
                    else f"{prof['device_ms']:.3f} ms ({prof['busy_share']:.1%})")
            print(f"profile: classify {name:15s} wall {prof['wall_ms']:.3f} ms, device busy {busy}")
            for kn, ms in prof["top_kernels_ms"]:
                print(f"profile:   {ms:9.3f} ms  {kn}")

    # B4 rows: the phase's two shapes (the batch and the streams with this
    # run's weights), kernels_bench's C3D case in float32 and bf16, and
    # the reference test sweep's shapes
    w = params.conv_w.detach()
    xb, xs = torch.from_numpy(batches[0]).cuda(), torch.from_numpy(streams).cuda()
    rows = [
        _conv_row(f"[{xb.shape[0]}x{'x'.join(map(str, xb.shape[2:]))}]", xb, w, b4, CONV_RTOL,
                  want_route="wgmma"),
        _conv_row(f"[{xs.shape[0]}x{'x'.join(map(str, xs.shape[2:]))}]", xs, w, b4, CONV_RTOL,
                  reps=5, want_route="wgmma"),
    ]
    del xb, xs
    xc = torch.randn((1, 16, 14, 14, 8), generator=gen, device="cuda")
    wc = torch.randn((16, 16, 3, 3, 3), generator=gen, device="cuda")
    rows.append(_conv_row("_c3d[f32]", xc, wc, b4, CONV_RTOL))
    rows.append(_conv_row("_c3d[bf16]", xc.bfloat16(), wc.bfloat16(), b4, CONV_BF16_RTOL))
    for b, c, o, k, h, t in CONV_SWEEP:
        xs = torch.randn((b, c, h, h + 2, t), generator=gen, device="cuda")
        ws = torch.randn((o, c, k, k, min(k, t)), generator=gen, device="cuda")
        rows.append(_conv_row(f"_sweep[{b}x{c}x{h}x{h + 2}x{t},o{o},k{k}]", xs, ws, b4, CONV_RTOL))

    # B1 at the classifier's shapes: the batch's spectra against a 9-kernel
    # grating on the 60x80x16 clip's FFT grid
    fft = spectral_conv.fft_shape_for((60, 80, 16), (30, 40, 8))
    F = fft[0] * fft[1] * (fft[2] // 2 + 1)

    def cplx(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device="cuda"),
                             torch.randn(shape, generator=gen, device="cuda"))

    xh, gr = cplx(CLASSIFY_BATCH, 1, F), cplx(9, 1, F)
    with spectral_conv.full_precision():
        got = stmul_kernel.spectral_mac_cuda(xh, gr, 2)
        want = stmul_ref.spectral_mac_ref(xh, gr, 2)
        mx = float(torch.max(torch.abs(got - want)))
        bitwise = _bits_equal(torch.view_as_real(got), torch.view_as_real(want))
        print(f"classify: B1 x {tuple(xh.shape)} grating {tuple(gr.shape)} vs plain: "
              f"{'bitwise' if bitwise else 'DIFFERS'}, max abs {mx:.3g}")
        if not bitwise:
            raise AssertionError(f"B1 at the classifier's shapes differs from its plain version (max abs {mx:.3g})")
        ms = _time_ms(lambda: stmul_kernel.spectral_mac_cuda(xh, gr, 2), 20)
        plain_ms = _time_ms(lambda: stmul_ref.spectral_mac_ref(xh, gr, 2), 3)
        lib_ms = _time_ms(lambda: torch.einsum("bcf,ocf->bof", xh, gr), 20)
    bound, by = _bound_ms((xh.numel() + gr.numel() + CLASSIFY_BATCH * 9 * F) * 8,
                          8 * CLASSIFY_BATCH * 9 * F)
    rows.append({
        "name": "spectral_mac[classify]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/stmul/csrc/stmul.cu",
        "replaces": "src/repro/kernels/stmul/kernel.py:147",
        "launches": b1,
        "max_abs_err": mx,
        "max_err": mx,
        "bitwise": bitwise,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": lib_ms,
        "shape": {"B": CLASSIFY_BATCH, "O": 9, "C": 1, "F": F},
    })
    return report, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the full report as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.conv3d import kernel as conv_kernel
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.stmul import kernel, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"build": phase_build({
        "stmul": kernel, "ssd": ssd_kernel, "flash": flash_kernel, "conv3d": conv_kernel,
    })}
    report["build"]["flash_checks"] = check_flash_build(flash_kernel, report["build"]["flash"]["path"])
    report["build"]["ssd_sass"] = check_ssd_build(report["build"]["ssd"]["path"])
    report["build"]["conv3d_sass"] = check_conv3d_build(
        report["build"]["conv3d"]["path"], report["build"]["conv3d"]["warnings"])
    report["serve"] = phase_serve(kernel, args.seed)
    rows = phase_kernels(kernel, ref, args.seed, report["serve"]["launches"])
    report["lm"], ssd_rows = phase_lm(args.seed)
    rows += ssd_rows
    report["lm_dense"], flash_rows = phase_lm_dense(args.seed)
    rows += flash_rows
    report["classify"], classify_rows = phase_classify(args.seed, kernel)
    rows += classify_rows
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(
            f"kernel: {r['name']:36s} {r['ms']:8.4f} ms (bound {r['bound_ms']:.4f} "
            f"{r['bound_by']}, plain {r['plain_ms']:.3f}, library "
            f"{lib}) launches {r['launches']} max_abs_err {r['max_abs_err']:.3g}"
        )
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    report["card"] = card
    report["kernels"] = rows
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
