"""Chip smoke test of the PyTorch/CUDA port on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--out report.json]

Phases, each reported on lines of its own:

1. build   — compile the stmul CUDA kernels from ``src/repro_torch/
             kernels/stmul/csrc`` with nvcc (sm_90a) and load them.
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
             profiled (host clip hashing, device busy time by kernel).
3. kernels — run every kernel at the shapes the serving batch gives it
             and hold it against its plain torch version on the card:
             the spectral MACs (B1 v2/v1, B2 f32/bf16 arena) to relative
             L2 <= 1e-5, the top-K readout (B3, k = 1 and 3, rows with
             NaN, -inf, ties and signed zeros) bitwise.  Times each with
             CUDA events beside its plain version, a one-call library
             yardstick and its bound (bytes at 3.35 TB/s or float32
             operations at 67 TFLOP/s, whichever is larger).

The last line is ``{"ok": true, "device": {...}}``; any failure raises
and exits non-zero.  Without CUDA, or outside a checkout of the repo, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
MAC_RTOL = 1e-5
SERVE_REPS = 7  # timed calls per serving mode, after one warm-up


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


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def phase_build(kernel) -> dict:
    info = kernel.build()
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    print(f"build: {info['seconds']:.2f} s nvcc sm_90a -> {os.path.relpath(info['path'], ROOT)}")
    for ln in ptxas:
        print(f"build:   {ln}")
    return {"seconds": info["seconds"], "ptxas": ptxas}


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

    def row(name, fn, plain, library, check, nbytes, flops, launches_of, reps=20):
        out = fn()
        exp = plain()
        err, ok = check(out, exp)
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version ({err})")
        ms = _time_ms(fn, reps)
        plain_ms = _time_ms(plain, 3)
        lib_ms = _time_ms(library, reps) if library is not None else None
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
        rows.append(r)
        del out, exp

    def mac_check(out, exp):
        rel = _rel_l2(torch.view_as_real(out), torch.view_as_real(exp))
        mx = float(torch.max(torch.abs(out - exp)))
        return {"max_abs_err": mx, "rel_l2": rel}, rel <= MAC_RTOL

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
                mac_check, b1_bytes, b1_flops,
                ("spectral_mac", "src/repro/kernels/stmul/kernel.py:147"),
            )
    del x, gr

    # B2: pooled rung, 4 encoded streams x 4 windows against an 18-row arena
    x = cplx(16, C, F)
    offs = [0, 0, 9, 9] * 4
    for dtype, name in ((torch.float32, "spectral_mac_grouped[f32]"),
                        (torch.bfloat16, "spectral_mac_grouped[bf16]")):
        pre = torch.randn((18, C, F), generator=g, device=dev).to(dtype)
        pim = torch.randn((18, C, F), generator=g, device=dev).to(dtype)
        sel = torch.complex(pre.float(), pim.float())[
            torch.as_tensor(offs, device=dev)[:, None] + torch.arange(O, device=dev)[None]
        ]
        nbytes = (x.numel() * 8 + 2 * pre.numel() * pre.element_size()
                  + 16 * O * F * 8)
        with spectral_conv.full_precision():
            row(
                name,
                lambda: kernel.spectral_mac_grouped_cuda(x, pre, pim, offs, O),
                lambda: ref.spectral_mac_grouped_ref(x, pre, pim, offs, O),
                lambda: torch.einsum("bcf,bocf->bof", x, sel),
                mac_check, nbytes, 8 * 16 * O * C * F,
                ("spectral_mac_grouped", "src/repro/kernels/stmul/kernel.py:248"),
            )
        del pre, pim, sel
    del x

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

    for k in (1, 3):
        row(
            f"topk_readout[k={k}]",
            lambda k=k: kernel.topk_readout_cuda(vals, gidx, k),
            lambda k=k: ref.topk_readout_ref(vals, gidx, k),
            lambda k=k: torch.topk(vals_tiefree, k, dim=-1),
            topk_check, R * L * 4 + L * 4 + R * k * 8, 0,
            ("topk_readout", "src/repro/kernels/stmul/kernel.py:434"),
        )
    torch.cuda.synchronize()
    return rows


def _profile(fn) -> dict:
    """Wall time of one call, the device time of the kernels it ran (by
    name, from the profiler's CUDA events) and the device's busy share.
    Kernels on one stream do not overlap, so their sum is busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
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
    report["frames_per_request"] = 1024
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the full report as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.stmul import kernel, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"build": phase_build(kernel)}
    report["serve"] = phase_serve(kernel, args.seed)
    rows = phase_kernels(kernel, ref, args.seed, report["serve"]["launches"])
    for r in rows:
        print(
            f"kernel: {r['name']:28s} {r['ms']:8.4f} ms (bound {r['bound_ms']:.4f} "
            f"{r['bound_by']}, plain {r['plain_ms']:.3f}, library "
            f"{r['library_ms']:.4f}) launches {r['launches']} max_abs_err {r['max_abs_err']:.3g}"
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
