"""System adapter: multi-tenant STHC video search behind the microbatch
scheduler (``repro_torch.launch.serve``).

The program under test is ``MicrobatchScheduler.submit`` ->
``VideoSearchServer.search_batch`` -> the engine's pooled executor.  The
adapter makes every input itself from the seed, on the card: each
tenant's kernels (one ``randn``) and each request's stream (one ``rand``
from ``(seed, request index)``, drawn when the request is sent).  It
wraps ``server.search_batch`` to stamp each batch call (its duration and
its rows) and answers the harness's
questions: frames and model FLOPs of a request, counters, a sample of
answers, and the comparison with ``reference.sthc``.
"""

from __future__ import annotations

import itertools
import time
from concurrent.futures import Future

import numpy as np
import torch

from pbench import stats, traffic, yardstick
from pbench.fidelity import pipeline
from reference import sthc as ref

WARM_STREAM = 2**32  # data sub-stream of the warm-up clip, never a request index


class System:
    def __init__(self, config: dict, mix: dict, seed: int, device: str, tracer, control: bool = False):
        self.config, self.mix, self.seed, self.device = config, mix, int(seed), device
        self.tracer = tracer
        self.control = control  # the program's own bfloat16-grating path
        self.calls: list[dict] = []
        self._gen = None

    # -- the program -------------------------------------------------------

    def _device_model(self):
        from repro_torch.core import atomic, optics

        ph = self.config["physics"]
        if ph["storage_interval_s"] != 0.0:
            raise ValueError("the server records with no storage interval")
        slm = optics.SLMConfig(bits=int(ph["slm_bits"]))
        atoms = atomic.AtomicConfig(t2_s=ph["t2_s"], frame_time_s=ph["frame_time_s"],
                                    ihb_profile=ph["ihb_profile"], coverage=ph["ihb_coverage"])
        return slm, atoms

    def _clip(self, gen: torch.Generator, idx: int, streams: int, frames: int) -> torch.Tensor:
        H, W = self.config["frame_hw"]
        C = self.config["kernel_shape"][1]
        gen.manual_seed(traffic.request_seed(self.seed, traffic.STREAM_DATA, idx))
        return torch.rand((streams, C, H, W, frames), generator=gen, device=self.device)

    def setup(self) -> None:
        from repro_torch.launch.resilience import RequestRejected
        from repro_torch.launch.serve import MicrobatchScheduler, VideoSearchConfig, VideoSearchServer

        self._rejected = RequestRejected
        cfg = self.config
        H, W = cfg["frame_hw"]
        tenants = cfg["tenants"]
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(traffic.request_seed(self.seed, traffic.STREAM_WEIGHTS))
        self.kernels = torch.randn((len(tenants), *cfg["kernel_shape"]), generator=self._gen,
                                   device=self.device)
        server_cfg = dict(cfg["server"])
        if self.control:
            server_cfg["grating_dtype"] = "bfloat16"
        slm, atoms = self._device_model()
        self.server = VideoSearchServer(
            frame_hw=(H, W), cfg=VideoSearchConfig(**server_cfg, slm=slm, atoms=atoms, device=self.device)
        )
        with torch.no_grad():
            for i, t in enumerate(tenants):
                self.server.add_tenant(t["name"], self.kernels[i], fidelity=pipeline(t["fidelity"], cfg["physics"]))
        self.server.search_batch = self._stamped(self.server.search_batch)
        self._warm_up()
        self.sched = MicrobatchScheduler(self.server, **cfg["scheduler"])
        names = [t["name"] for t in tenants]
        for f in [self.sched.submit(n, self._warm_clip) for n in names]:
            f.result(timeout=120)
        self.calls.clear()

    def _warm_up(self) -> None:
        """Every batch shape the cell's traffic can form: 1 .. max_batch
        rows of each tenant (each pool group's FFT plans), and every set of
        tenants in one batch (each arena of the pooled executor)."""
        fields = self.mix["request"]
        streams, frames = fields["streams"], fields["frames"]
        self._warm_clip = self._clip(self._gen, WARM_STREAM, streams, frames)
        names = [t["name"] for t in self.config["tenants"]]
        batch = self.config["scheduler"]["max_batch"]
        for n in range(1, batch + 1):
            for name in names:
                self.server.search_batch([(name, self._warm_clip)] * n)
        for k in range(2, len(names) + 1):
            for subset in itertools.combinations(names, k):
                self.server.search_batch([(name, self._warm_clip) for name in subset])
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def _stamped(self, search_batch):
        """``search_batch`` stamped on the host clock: the call's start, its
        end, its rows."""

        def stamped(requests, *args, **kwargs):
            t0 = time.perf_counter()
            with self.tracer.span("search_batch"):
                out = search_batch(requests, *args, **kwargs)
            self.calls.append({
                "t0": t0, "t1": time.perf_counter(),
                "rows": [(name, int(clip.shape[0]), int(clip.shape[-1])) for name, clip in requests],
            })
            return out

        return stamped

    # -- the loop's side ---------------------------------------------------

    def issue(self, rec: traffic.Rec) -> Future:
        p = rec.params
        with self.tracer.span("generate"):
            clip = self._clip(self._gen, rec.idx, p["streams"], p["frames"])
        with self.tracer.span("submit"):
            return self.sched.submit(p["tenant"], clip)

    def is_rejection(self, exc: BaseException) -> bool:
        return isinstance(exc, self._rejected)

    def counters(self) -> dict:
        m = self.sched.metrics()
        return {k: m[k] for k in ("submitted", "completed", "failed", "rejected", "batches")}

    def release(self) -> None:
        """Stop the scheduler and drop the program's state."""
        self.sched.close()
        del self.sched, self.server

    # -- work --------------------------------------------------------------

    def frames(self, rec: traffic.Rec) -> int:
        return int(rec.params["streams"]) * int(rec.params["frames"])

    def model_flops(self, rec: traffic.Rec) -> float:
        """The spectral algorithm's FLOPs for one request: every coherence
        window of its streams' overlap-save plan at the configuration's
        geometry."""
        H, W = self.config["frame_hw"]
        O, C, kh, kw, kt = self.config["kernel_shape"]
        block = self.config["server"]["window_frames"]
        plan = yardstick.stream_plan(rec.params["frames"], kt, block)
        per_window = yardstick.fft_flops(H, W, block, C, O, kh, kw, kt)
        return float(rec.params["streams"] * plan.n_blocks * per_window)

    # -- correctness -------------------------------------------------------

    @torch.no_grad()
    def check(self, sample: list[traffic.Rec], run) -> dict:
        """Per sampled request and kernel: the gap between the peak score
        served and the reference's (``score_err``), and how far the
        reference's best at the served peak frame lies below its peak
        (``frame_gap``), both as shares of the reference volume's largest
        magnitude."""
        physics = self.config["physics"]
        index = {t["name"]: (i, t["fidelity"]) for i, t in enumerate(self.config["tenants"])}
        k_eff: dict[str, torch.Tensor] = {}
        gen = torch.Generator(device=self.device)
        score_err = frame_gap = 0.0
        for rec in sample:
            name = rec.params["tenant"]
            i, fid = index[name]
            if name not in k_eff:
                k_eff[name] = ref.effective_kernels(self.kernels[i], fid, physics)
            if rec.result.get("tenant") != name:
                return {"score_err": float("inf"), "frame_gap": float("inf")}
            x = self._clip(gen, rec.idx, rec.params["streams"], rec.params["frames"])
            vol = ref.search_volume(x, k_eff[name], fid, physics)
            flat = vol.flatten(2)
            best = flat.amax(-1)
            scale = flat.abs().amax(-1)
            served = torch.as_tensor(np.asarray(rec.result["scores"]), dtype=torch.float64, device=vol.device)
            t_at = torch.as_tensor(np.asarray(rec.result["peak_frame"]), dtype=torch.long, device=vol.device)
            at = vol.amax(dim=(2, 3)).gather(-1, t_at[..., None].clamp(0, vol.shape[-1] - 1))[..., 0]
            if bool(((t_at < 0) | (t_at >= vol.shape[-1])).any()):
                at = torch.full_like(at, -float("inf"))
            score_err = stats.worst(score_err, ((served - best).abs() / scale).max())
            frame_gap = stats.worst(frame_gap, ((best - at) / scale).max())
            del vol, flat
        return {"score_err": score_err, "frame_gap": frame_gap}
