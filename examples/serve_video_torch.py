"""Streaming video event search on the PyTorch/CUDA port — the twin of
``examples/serve_video.py``.

Reference event clips ("what to look for") are recorded once into the
grating; a long video stream is then pushed through the coherence-window
segmentation (overlap-save, paper Fig. 1C) and each reference produces a
correlation peak wherever its event occurs.

One server holds the same action-class references three times, each
with its own fidelity pipeline (ideal, physical, and a quantization-only
subset), all in one grating cache.  Detection runs through the fused
readout (the correlation volume never materializes); one call opts back
into the stitched volume to show the scores are bitwise its max.  The
front door for concurrent callers is the microbatch scheduler
(queue → batcher → pooled executor): the stream goes through the other
two fidelities concurrently, and the scheduler's latency percentiles
and batch counters are printed.

On the card (the hand-written CUDA kernels) by default; ``--device cpu``
runs the plain torch versions on the host:

    PYTHONPATH=src python examples/serve_video_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import fidelity
from repro_torch.data import kth_synthetic as kth
from repro_torch.launch.serve import (
    MicrobatchScheduler,
    VideoSearchConfig,
    VideoSearchServer,
)

SPEC = kth.VideoSpec(height=24, width=32, frames=12)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # reference events: one exemplar per action class (subject 20 — unseen)
    refs = np.stack([kth.render_clip(label, 20, 0, SPEC) for label in range(4)])[:, None]
    refs = refs - refs.mean(axis=(2, 3, 4), keepdims=True)  # zero-mean match
    refs = refs.astype(np.float32)

    # a long stream: waving ... running ... boxing (subject 21, unseen)
    segments = [kth.render_clip(1, 21, 1, SPEC), kth.render_clip(3, 21, 1, SPEC),
                kth.render_clip(2, 21, 1, SPEC)]
    stream = np.concatenate(segments, axis=-1)[None, None].astype(np.float32)

    server = VideoSearchServer(
        frame_hw=(SPEC.height, SPEC.width),
        cfg=VideoSearchConfig(window_frames=24, chunk_windows=2, device=device),
    )
    server.add_kernel_set("actions", refs)  # server default: ideal()
    server.add_kernel_set("actions-physical", refs, fidelity=fidelity.physical())
    server.add_kernel_set(
        "actions-slm-only", refs,
        fidelity=fidelity.pipeline(fidelity.SLMQuantize(), name="slm-only"),
    )

    out = server.search(stream, tenant="actions")
    print(f"stream of {stream.shape[-1]} frames searched in {out['windows']} "
          f"coherence windows on {device} ({out['latency_s'] * 1000:.0f} ms)")
    scores = out["scores"][0]
    peaks = out["peak_frame"][0]
    for i, name in enumerate(kth.CLASSES):
        print(f"  reference '{name:9s}': score {scores[i]:7.2f} peak at frame {peaks[i]:3d}")
    # localization check: the 'running' reference must peak inside the
    # running segment (frames 12..23 of the stream)
    run_peak = int(peaks[3])
    ok = 12 - SPEC.frames // 2 <= run_peak <= 23
    print(f"'running' reference localizes the running segment "
          f"(frames 12-23): peak {run_peak} -> {'OK' if ok else 'MISS'}")

    vol_out = server.search(stream, tenant="actions", return_volume=True)
    exact = bool(np.array_equal(out["scores"], vol_out["scores"]))
    print(f"fused readout == stitched volume max: {exact} "
          f"(a {'x'.join(str(d) for d in vol_out['volume'].shape)} volume "
          f"avoided per search)")
    topk_server = VideoSearchServer(
        frame_hw=(SPEC.height, SPEC.width),
        cfg=VideoSearchConfig(window_frames=24, chunk_windows=2, readout_topk=3, device=device),
    )
    topk_server.add_kernel_set("actions", refs)
    t3 = topk_server.search(stream, tenant="actions")
    frames3 = ", ".join(str(f) for f in t3["topk_frames"][0][3])
    print(f"top-3 'running' detections peak at frames [{frames3}]")

    # the same stream through the other two fidelities concurrently, via
    # the microbatch scheduler: one microbatch, one pooled dispatch
    with MicrobatchScheduler(server, max_queue=16, max_batch=8, batch_wait_s=0.01) as sched:
        futs = {
            tenant: sched.submit(tenant, stream)
            for tenant in ("actions-physical", "actions-slm-only")
        }
        for tenant, fut in futs.items():
            tout = fut.result(timeout=120)
            fid_name = server.metrics()["tenants"][tenant]["fidelity"]
            print(f"[{fid_name:9s}] 'running' score {tout['scores'][0][3]:7.2f} "
                  f"(ideal {scores[3]:7.2f}), peak at frame {tout['peak_frame'][0][3]}, "
                  f"end-to-end {tout['queue_latency_s'] * 1e3:.0f} ms")
        sm = sched.metrics()
    print(f"scheduler: {sm['completed']} served in {sm['batches']} microbatches "
          f"(mean size {sm['mean_batch_size']:.1f}), p50 {sm['latency_p50_ms']:.0f} ms "
          f"/ p99 {sm['latency_p99_ms']:.0f} ms, {sm['rejected']} shed")

    m = server.metrics()
    c = m["cache"]
    print(f"cache: {c['hits']} hits / {c['misses']} misses / {c['evictions']} "
          f"evictions, {c['entries']} gratings ({c['bytes'] / 1e6:.2f} MB resident)")
    print(f"throughput: {m['frames_per_s']:.0f} frames/s measured on {device} vs "
          f"{m['projected_slm_fps']:.0f} fps (SLM) / {m['projected_hmd_fps']:.0f} fps "
          f"(HMD) projected loaders")


if __name__ == "__main__":
    main()
