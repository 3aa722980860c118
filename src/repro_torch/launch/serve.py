"""Multi-tenant STHC video event search serving (port of the
``VideoSearchServer`` part of ``repro.launch.serve``).

Each *tenant* is a named reference kernel set ("what to look for") with
its own fidelity pipeline and device model, recorded into one shared
content-hash :class:`~repro_torch.core.engine.GratingCache` with an LRU
budget in entries and bytes; evicted tenants re-record on their next
query.  ``search_batch`` serves a mixed-tenant batch of long streams:

* **pooled** (default) — one call of the engine's cross-tenant executor
  (``QueryEngine.query_stream_many``): every window chunk runs one FFT,
  one grouped MAC against the pooled arena (kernel B2) and one IFFT for
  the whole batch, and requests whose clips hash equal share one
  physical row (clip-dedup);
* **sequential** (``pooled=False``) — one overlap-save pass per tenant
  group (kernel B1);
* **fused readout** (``fused_readout``, default on) — each window chunk
  collapses to per-(stream, kernel) top-K states (kernel B3), bitwise
  the stitched volume's max / argmax; ``return_volume=True`` forces the
  stitched path and returns the volumes too.

``guard_scores`` quarantines a request whose scores are not finite
(:class:`~repro_torch.launch.resilience.TenantQuarantined`) while the
rest of the batch delivers; ``verify_gratings`` checksums every cache
fetch.  ``metrics()`` reports cache counters, dispatch and dedup
counters, and measured windows/s and frames/s against the paper's
projected loader rates.  ``server.chaos`` takes a
:class:`~repro_torch.distributed.fault.ChaosInjector`, whose seams
(``cache_fetch``, ``encode``, ``dispatch``, ``readout``) fire where the
reference's do; with no injector each seam is one attribute check.

:class:`MicrobatchScheduler` fronts the server as the reference's does
(queue → batcher → pooled executor): ``submit`` hashes the clip in the
caller's thread and returns a future, a batcher thread forms
mixed-tenant microbatches with same-clip requests side by side (dedup
groups), and each batch runs on the highest rung of the degradation
ladder (pooled → sequential → single) whose breaker admits it, under
deadlines, seeded retries and a watchdog that resolves every future.

``VideoSearchConfig(mesh_shape=(data, model))`` serves the pooled rung
over a :class:`~repro_torch.launch.mesh.LocalMesh` the server builds
once (``mesh_devices`` lays it over named devices, which may repeat: a
logical mesh on one card or on the CPU); every answer is bitwise the
single-device one, and ``metrics()["mesh"]`` reports the shape.

:class:`HybridClassifierServer` serves the paper's hybrid 3-D CNN (§4):
the conv layer is an STHC whose grating is recorded once, at
construction, and every ``classify`` runs one correlate (kernel B1 on
the card) and the digital head; ``classify_stream`` streams long clips
through the coherence-window overlap-save path and classifies each
training-length segment.  :class:`C3DClassifierServer` serves C3D, the
digital 3-D CNN the paper sets its correlator against, through the same
``classify`` entry, its convolutions on kernel B4.

:class:`LMServer` serves a language model greedily: one ``prefill`` of
the prompt batch, then one ``decode_step`` per new token: Mamba-2,
whose prefill runs the SSD kernel once per layer, or the dense
transformer, whose prefill runs the flash-attention kernel once per
layer.

Run ``python -m repro_torch.launch.serve --mode video`` (or ``--mode
lm``) for a demo (on the card; ``--device cpu`` for the plain torch
path).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import queue as queue_mod
import threading
import time
import warnings
from concurrent.futures import Future
from typing import Sequence

import numpy as np
import torch

from repro_torch import configs, resolve_device, tracing
from repro_torch.core import atomic, fidelity as fidelity_mod, hybrid, optics, throughput
from repro_torch.core import spectral_conv
from repro_torch.core.engine import (
    TOPK_EMPTY_IDX,
    GratingCache,
    clip_key,
    clip_keys_for,
    host_stream,
    stack_streams,
    stage_clips,
    staged_to_device,
)
from repro_torch.core.fidelity import FidelityPipeline
from repro_torch.core.sthc import STHC, STHCConfig
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import c3d
from repro_torch.launch.resilience import (
    BatchExecutionError,
    DeadlineExceeded,
    DegradationLadder,
    RequestRejected,
    RetryPolicy,
    SchedulerClosed,
    ServingError,
    TenantQuarantined,
    Watchdog,
    is_transient,
    is_validation_error,
    resolve_exception,
    resolve_result,
)
from repro_torch.models import model_api


@dataclasses.dataclass
class VideoSearchConfig:
    """Multi-tenant video-search serving knobs (field names as in the
    reference, so one set of values builds both servers).

    Attributes:
      window_frames: coherence window T2 (frames) — the streaming FFT
        geometry every tenant is recorded at.
      mode: DEPRECATED two-way fidelity switch; use ``fidelity=``.
      fidelity: the server's default fidelity pipeline (None = ideal).
      chunk_windows: coherence windows correlated per step as one batch.
      cache_entries / cache_bytes: LRU budget of the shared grating
        cache.
      use_pallas: route the MAC and the readout through the hand-written
        CUDA kernels (their plain torch versions on the CPU); False =
        the torch einsum path.
      pooled_queries: serve mixed-tenant batches through the pooled
        executor (False = the per-tenant sequential loop).
      dedup_clips: collapse pooled rows whose clips hash equal.
      max_buffer_windows: serve at most this many coherence windows from
        one device buffer (stream cursor); None = whole stream.
      grating_dtype: 'float32' | 'bfloat16' grating storage.
      slm / atoms: the server's default device model.
      fused_readout: fold the detection readout into the overlap-save
        epilogue (no correlation volume materializes).
      readout_topk: detections reported per (stream, kernel).
      readout_block_o / readout_block_l: the reference's TPU readout
        tiles; kept for config compatibility, read by no CUDA kernel.
      guard_scores: quarantine requests with non-finite scores.
      verify_gratings: checksum-verify every cache fetch.
      mesh_shape: ``(data, model)`` device mesh of the pooled rung: the
        arena's tiles over the model axis, the stream rows over the data
        axis, scores bitwise the single-device ones.  None = one device.
      mesh_devices: the ``data * model`` devices of that mesh, row-major
        (a device may repeat: ``("cpu",) * 8``, ``("cuda:0",) * 4``);
        None = the visible CUDA devices.  The one field the reference
        lacks: its forced host devices have no torch counterpart.
      device: torch device; None = the card, raising when no GPU is
        present.  Pass ``"cpu"`` for the plain torch path.
    """

    window_frames: int = 64
    mode: str | None = None
    fidelity: FidelityPipeline | None = None
    chunk_windows: int = 4
    cache_entries: int = 8
    cache_bytes: int | None = None
    use_pallas: bool = True
    pooled_queries: bool = True
    dedup_clips: bool = True
    max_buffer_windows: int | None = None
    fused_readout: bool = True
    readout_topk: int = 1
    readout_block_o: int | None = None
    readout_block_l: int | None = None
    grating_dtype: str = "float32"
    slm: optics.SLMConfig | None = None
    atoms: atomic.AtomicConfig | None = None
    guard_scores: bool = True
    verify_gratings: bool = False
    mesh_shape: tuple[int, int] | None = None
    mesh_devices: tuple[str, ...] | None = None
    device: str | None = None

    def __post_init__(self) -> None:
        """Structural validation of the mesh request (the devices' fit is
        checked by ``make_local_mesh`` when the server is built), its
        devices' type against the server's (None means the card on both
        sides), then the device."""
        ms = self.mesh_shape
        if ms is not None:
            if (
                not isinstance(ms, (tuple, list))
                or len(ms) != 2
                or not all(isinstance(a, int) and not isinstance(a, bool) for a in ms)
            ):
                raise ValueError(f"mesh_shape must be a (data, model) pair of ints, got {ms!r}")
            if any(a < 1 for a in ms):
                raise ValueError(f"mesh_shape axes must be >= 1, got {tuple(ms)}")
            self.mesh_shape = tuple(ms)
        if self.mesh_devices is not None:
            if ms is None:
                raise ValueError("mesh_devices needs a mesh_shape")
            self.mesh_devices = tuple(str(d) for d in self.mesh_devices)
        if ms is not None:
            want = "cuda" if self.device is None else torch.device(self.device).type
            got = {"cuda"} if self.mesh_devices is None else {
                torch.device(d).type for d in self.mesh_devices
            }
            if got != {want}:
                raise ValueError(
                    f"mesh devices {self.mesh_devices or 'the visible CUDA devices'} are not "
                    f"all of the server's device type {want!r}"
                )
        self.device = resolve_device(self.device)


@dataclasses.dataclass
class _Tenant:
    """Per-tenant kernels + serving counters."""

    kernels: np.ndarray | None  # (O, C, kh, kw, kt), held host-side
    kt: int
    channels: int = 1
    signal_shape: tuple[int, int, int] | None = None  # record geometry
    key: tuple | None = None  # cache key, hashed once at registration
    sthc: STHC | None = None
    fidelity_label: str = ""
    device_label: str = "default"
    queries: int = 0
    windows: int = 0
    frames: int = 0
    seconds: float = 0.0


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class VideoSearchServer:
    """Record reference kernel sets once; stream queries through the
    engine's overlap-save path — one shared grating cache, many tenants.
    Gratings are fetched through the cache on every search, so an
    evicted tenant re-records transparently."""

    def __init__(
        self,
        kernels=None,  # optional bootstrap tenant
        frame_hw: tuple[int, int] = (60, 80),
        cfg: VideoSearchConfig | None = None,
    ):
        self.cfg = cfg = cfg if cfg is not None else VideoSearchConfig()
        self.frame_hw = tuple(frame_hw)
        self.device = cfg.device
        # the replica's own device mesh, built once and passed to every
        # pooled dispatch; make_local_mesh raises when the devices do not fit
        self.mesh = None
        if cfg.mesh_shape is not None:
            self.mesh = make_local_mesh(*cfg.mesh_shape, devices=cfg.mesh_devices)
        self.cache = GratingCache(
            max_entries=cfg.cache_entries,
            max_bytes=cfg.cache_bytes,
            verify=cfg.verify_gratings,
        )
        # optional ChaosInjector (distributed.fault); when attached the
        # hot path fires its seams — when None each seam is one attr check
        self.chaos = None
        self._quarantined = 0  # guarded-by: _lock
        # one engine per (fidelity fingerprint, device model), all
        # sharing the one grating cache
        self._sthcs: dict[tuple, STHC] = {}  # guarded-by: _pool_lock
        self._pool_lock = threading.Lock()
        self._default_fidelity = self._resolve_cfg_fidelity(cfg)
        self.sthc = self._sthc_for(self._default_fidelity)
        self._tenants: dict[str, _Tenant] = {}  # guarded-by: _lock
        # traffic of removed / replaced tenants, kept in the totals
        self._retired = _Tenant(kernels=None, kt=0)
        self._lock = threading.Lock()
        self._pooled_dispatches = 0  # guarded-by: _lock
        self._sequential_dispatches = 0  # guarded-by: _lock
        if kernels is not None:
            self.add_tenant("default", kernels)

    # -- engine pool (one per fidelity fingerprint) -------------------------

    @staticmethod
    def _resolve_cfg_fidelity(cfg: VideoSearchConfig) -> FidelityPipeline:
        if cfg.fidelity is not None:
            if cfg.mode is not None:
                raise ValueError(
                    "pass either the deprecated VideoSearchConfig.mode or "
                    "fidelity, not both"
                )
            return cfg.fidelity
        if cfg.mode is not None:
            pipe = fidelity_mod.from_mode(cfg.mode)
            warnings.warn(
                "VideoSearchConfig(mode=...) is deprecated; pass "
                "fidelity=fidelity.ideal() / fidelity.physical() instead",
                DeprecationWarning,
                stacklevel=3,
            )
            return pipe
        return fidelity_mod.ideal()

    def _resolve_device(
        self,
        slm: optics.SLMConfig | None,
        atoms: atomic.AtomicConfig | None,
    ) -> tuple[optics.SLMConfig, atomic.AtomicConfig]:
        """Tenant override → server default → library default."""
        if slm is None:
            slm = self.cfg.slm if self.cfg.slm is not None else optics.SLMConfig()
        if atoms is None:
            atoms = self.cfg.atoms if self.cfg.atoms is not None else atomic.AtomicConfig()
        return slm, atoms

    def _sthc_for(
        self,
        pipe: FidelityPipeline,
        slm: optics.SLMConfig | None = None,
        atoms: atomic.AtomicConfig | None = None,
    ) -> STHC:
        """The correlator serving one (fidelity, device model) pair, keyed
        by the pipeline fingerprint plus the resolved device configs."""
        slm, atoms = self._resolve_device(slm, atoms)
        key = (pipe.fingerprint(), slm, atoms)
        with self._pool_lock:
            sthc = self._sthcs.get(key)
            if sthc is None:
                sthc = STHC(
                    STHCConfig(
                        fidelity=pipe,
                        slm=slm,
                        atoms=atoms,
                        use_pallas=self.cfg.use_pallas,
                        osave_chunk_windows=self.cfg.chunk_windows,
                        osave_max_buffer_windows=self.cfg.max_buffer_windows,
                        # serving never runs the unfused ± reference path
                        keep_stacked=False,
                        grating_dtype=self.cfg.grating_dtype,
                        readout_block_o=self.cfg.readout_block_o,
                        readout_block_l=self.cfg.readout_block_l,
                        device=self.device,
                    ),
                    cache=self.cache,
                )
                self._sthcs[key] = sthc
        return sthc

    # -- tenant management -------------------------------------------------

    def add_tenant(
        self,
        name: str,
        kernels,
        fidelity: FidelityPipeline | None = None,
        slm: optics.SLMConfig | None = None,
        atoms: atomic.AtomicConfig | None = None,
    ) -> "VideoSearchServer":
        """Register a reference kernel set (O, C, kh, kw, kt) and record
        it into the cache, under its own fidelity pipeline and device
        model (None = the server defaults)."""
        kt = int(kernels.shape[-1])
        if self.cfg.window_frames <= kt - 1:
            raise ValueError(
                f"coherence window ({self.cfg.window_frames}) must be at "
                f"least the kernel length ({kt}) for tenant {name!r}"
            )
        kh, kw = int(kernels.shape[-3]), int(kernels.shape[-2])
        if kh > self.frame_hw[0] or kw > self.frame_hw[1]:
            raise ValueError(
                f"kernel spatial size ({kh}x{kw}) exceeds the server frame "
                f"size ({self.frame_hw[0]}x{self.frame_hw[1]}) for tenant "
                f"{name!r}"
            )
        # a host copy: a caller mutating its buffer afterwards cannot
        # desync the stored bytes from the content-hash key
        if isinstance(kernels, torch.Tensor):
            kernels = kernels.detach().cpu().numpy().copy()
        else:
            kernels = np.array(kernels)
        pipe = fidelity if fidelity is not None else self._default_fidelity
        sthc = self._sthc_for(pipe, slm, atoms)
        signal_shape = self._signal_shape()
        key = GratingCache.key_for(kernels, signal_shape, sthc.config)
        r_slm, r_atoms = self._resolve_device(slm, atoms)
        device_label = (
            "default"
            if slm is None and atoms is None
            else f"slm(bits={r_slm.bits})/atoms({r_atoms.ihb_profile},"
            f"t2={r_atoms.t2_s:g}s)"
        )
        ten = _Tenant(
            kernels=kernels,
            kt=kt,
            channels=int(kernels.shape[1]),
            signal_shape=signal_shape,
            key=key,
            sthc=sthc,
            fidelity_label=pipe.describe(),
            device_label=device_label,
        )
        with self._lock:
            old = self._tenants.pop(name, None)
            self._tenants[name] = ten
            if old is not None:
                self._discard_if_unreferenced(old.key)
                self._retire(old)
        self._fetch_grating(name, ten)
        return self

    add_kernel_set = add_tenant

    def remove_tenant(self, name: str) -> None:
        """Drop a tenant; free its grating unless another tenant with
        byte-identical kernels still references the shared entry."""
        with self._lock:
            if name not in self._tenants:
                raise KeyError(f"unknown tenant {name!r}; have {list(self._tenants)}")
            ten = self._tenants.pop(name)
            self._discard_if_unreferenced(ten.key)
            self._retire(ten)

    def _retire(self, ten: _Tenant) -> None:  # holds-lock: _lock
        self._retired.queries += ten.queries
        self._retired.windows += ten.windows
        self._retired.frames += ten.frames
        self._retired.seconds += ten.seconds

    def _discard_if_unreferenced(self, key: tuple | None) -> None:  # holds-lock: _lock
        if key is not None and all(t.key != key for t in self._tenants.values()):
            self.cache.discard(key)

    @property
    def tenants(self) -> list[str]:
        with self._lock:
            return list(self._tenants)

    def _signal_shape(self) -> tuple[int, int, int]:
        return (self.frame_hw[0], self.frame_hw[1], self.cfg.window_frames)

    def _fetch_grating(self, name: str, ten: _Tenant):
        """The one grating-fetch path: hit while resident, re-record on a
        miss; a fetch raced by removal drops its orphan entry."""
        if self.chaos is not None:
            self.chaos.on("cache_fetch")
        grating = self.cache.get_or_record(
            ten.sthc.engine,
            ten.kernels,
            ten.signal_shape or self._signal_shape(),
            key=ten.key,
            admit=lambda: self._tenants.get(name) is ten,
        )
        with self._lock:
            if self._tenants.get(name) is not ten:
                self._discard_if_unreferenced(ten.key)
        return grating

    # -- query -------------------------------------------------------------

    def search(self, clip, tenant: str = "default", return_volume: bool = False) -> dict:
        """clip: (B, C, H, W, T) long stream.  Returns detections — one
        call is exactly a one-request ``search_batch``.  Raises
        :class:`TenantQuarantined` if the guard rejected the scores."""
        (out,) = self.search_batch([(tenant, clip)], return_volume=return_volume)
        if isinstance(out, ServingError):
            raise out
        return out

    def search_batch(
        self,
        requests: Sequence[tuple[str, object]],
        pooled: bool | None = None,
        clip_keys: Sequence[tuple | None] | None = None,
        dedup: bool | None = None,
        return_volume: bool = False,
    ) -> list:
        """Serve concurrent stream searches, results in request order.

        Requests — ``(tenant, clip)`` pairs, clips numpy arrays or
        tensors — are grouped by tenant and stream shape; each group
        stacks on the batch axis.  ``pooled`` (default
        ``cfg.pooled_queries``) answers all groups with one call of the
        pooled executor, deduplicating equal clips with ``dedup``
        (default ``cfg.dedup_clips``; ``clip_keys`` passes fingerprints
        hashed upstream); ``pooled=False`` runs one streaming pass per
        group.  With ``cfg.fused_readout`` the readout is fused into the
        pass; ``return_volume=True`` forces the stitched path and adds
        each request's (B, O, H', W', T') volume under ``"volume"``.  A
        request whose scores are not finite gets a
        :class:`TenantQuarantined` instance in its slot when
        ``cfg.guard_scores`` is on.
        """
        if pooled is None:
            pooled = self.cfg.pooled_queries
        if dedup is None:
            dedup = self.cfg.dedup_clips
        fused = self.cfg.fused_readout and not return_volume
        topk = max(1, int(self.cfg.readout_topk))
        with tracing.span("serve.prepare"):
            order, tens, stacks = self._prepare(requests, pooled)
        if pooled:
            t0 = time.perf_counter()
            with tracing.span("serve.fetch"):
                gratings = [self._fetch_grating(key[0], ten) for (key, _), ten in zip(order, tens)]
            group_keys = None
            if dedup:
                if clip_keys is None:
                    clip_keys = clip_keys_for([clip for _, clip in requests])
                group_keys = []
                for _, idxs in order:
                    ks = [clip_keys[i] for i in idxs]
                    if any(k is None for k in ks):
                        group_keys.append(None)
                    elif len(ks) == 1:
                        group_keys.append(ks[0])
                    else:
                        group_keys.append(("stack",) + tuple(ks))
            if self.chaos is not None:  # chaos seam: pooled dispatch
                self.chaos.on("dispatch", mode="pooled")
            engine = self.sthc.engine
            if fused:
                fmaps = None
                dets = engine.query_stream_many(
                    list(zip(gratings, stacks)),
                    clip_keys=group_keys,
                    dedup=dedup,
                    readout_k=topk,
                    mesh=self.mesh,
                )
                with tracing.span("serve.readback"):
                    states = [(d.scores.cpu(), d.index.cpu()) for d in dets]
            else:
                dets = None
                fmaps = engine.query_stream_many(
                    list(zip(gratings, stacks)), clip_keys=group_keys, dedup=dedup, mesh=self.mesh
                )
                with tracing.span("serve.readback"):
                    readouts = self._readout(fmaps)
            dt = time.perf_counter() - t0
            with self._lock:
                self._pooled_dispatches += 1
            lat = [dt] * len(order)
            plans = [
                ten.sthc.engine.stream_plan_for(g, clips.shape[-1])
                for ten, g, clips in zip(tens, gratings, stacks)
            ]
            # busy seconds credited by window share: the batch paid dt once
            weights = [p.n_blocks * int(clips.shape[0]) for p, clips in zip(plans, stacks)]
            total_w = sum(weights) or 1
            busy = [dt * w / total_w for w in weights]
        else:
            gratings, plans, lat, busy = [], [], [], []
            fmaps = None if fused else []
            dets = [] if fused else None
            states = [] if fused else None
            for (key, _), ten, clips in zip(order, tens, stacks):
                t0 = time.perf_counter()
                with tracing.span("serve.fetch"):
                    grating = self._fetch_grating(key[0], ten)
                if self.chaos is not None:  # chaos seam: sequential path
                    self.chaos.on("dispatch", mode="sequential")
                if fused:
                    det = ten.sthc.engine.query_stream(grating, clips, readout_k=topk)
                    dets.append(det)
                    with tracing.span("serve.readback"):
                        states.append((det.scores.cpu(), det.index.cpu()))
                else:
                    fmaps.append(ten.sthc.engine.query_stream(grating, clips))
                    with tracing.span("serve.readback"):
                        _sync(self.device)
                dt = time.perf_counter() - t0
                with self._lock:
                    self._sequential_dispatches += 1
                gratings.append(grating)
                plans.append(ten.sthc.engine.stream_plan_for(grating, clips.shape[-1]))
                lat.append(dt)
                busy.append(dt)
            if not fused:
                with tracing.span("serve.readback"):
                    readouts = self._readout(fmaps)

        with tracing.span("serve.assemble"):
            results: list = [None] * len(requests)
            with self._lock:
                for g_i, ((key, idxs), ten, clips) in enumerate(zip(order, tens, stacks)):
                    tgt = ten if self._tenants.get(key[0]) is ten else self._retired
                    n_streams = clips.shape[0]
                    tgt.queries += len(idxs)
                    tgt.windows += plans[g_i].n_blocks * n_streams
                    tgt.frames += int(clips.shape[-1]) * n_streams
                    tgt.seconds += busy[g_i]
            guard = self.cfg.guard_scores
            for g_i, ((key, idxs), clips) in enumerate(zip(order, stacks)):
                tenant = key[0]
                plan = plans[g_i]
                topk_s = topk_t = None
                if fused:
                    # slot 0 of the (B, O, K) state IS the stitched max/argmax
                    tmod = int(dets[g_i].out_shape[-1])
                    state_s = states[g_i][0].numpy()
                    state_i = states[g_i][1].numpy()
                    peak = state_s[..., 0]
                    idx = state_i[..., 0]
                    if topk > 1:
                        topk_s = state_s
                        topk_t = np.where(state_i == TOPK_EMPTY_IDX, -1, state_i % tmod)
                else:
                    tmod = int(fmaps[g_i].shape[-1])
                    peak = readouts[g_i][0]
                    idx = readouts[g_i][1]
                if self.chaos is not None:  # chaos seam: detection readout
                    peak = self.chaos.on(
                        "readout", mode="pooled" if pooled else "sequential", payload=peak
                    )
                t_idx = idx % tmod
                b = 0
                for i in idxs:
                    nb = requests[i][1].shape[0]
                    scores = peak[b : b + nb]
                    if guard and not np.isfinite(scores).all():
                        with self._lock:
                            self._quarantined += 1
                        results[i] = TenantQuarantined(
                            f"non-finite correlation scores for tenant "
                            f"{tenant!r}; request quarantined",
                            tenant=tenant,
                        )
                    else:
                        res = {
                            "tenant": tenant,
                            "scores": scores,
                            "peak_frame": t_idx[b : b + nb],
                            "latency_s": lat[g_i],
                            "windows": plan.n_blocks,
                        }
                        if topk_s is not None:
                            res["topk_scores"] = topk_s[b : b + nb]
                            res["topk_frames"] = topk_t[b : b + nb]
                        if return_volume:
                            res["volume"] = fmaps[g_i][b : b + nb]
                        results[i] = res
                    b += nb
        return results

    def _prepare(self, requests, pooled: bool) -> tuple[list, list, list]:
        """Validate the requests, group them by tenant and stream shape in
        canonical order, and stack each group's clips on the device:
        ``(order, tenants, stacks)``."""
        groups: dict[tuple, list[int]] = {}
        with self._lock:  # snapshot: a racing remove_tenant can't break
            tenants = dict(self._tenants)
        for i, (tenant, clip) in enumerate(requests):
            if tenant not in tenants:
                raise KeyError(f"unknown tenant {tenant!r}; have {list(tenants)}")
            if tuple(clip.shape[-3:-1]) != self.frame_hw:
                raise ValueError(
                    f"request {i}: clip frames {tuple(clip.shape[-3:-1])} do not "
                    f"match the server frame size {self.frame_hw}"
                )
            if clip.shape[-1] < tenants[tenant].kt:
                raise ValueError(
                    f"request {i}: stream of {clip.shape[-1]} frames is "
                    f"shorter than tenant {tenant!r}'s kernel length "
                    f"({tenants[tenant].kt})"
                )
            if clip.shape[1] != tenants[tenant].channels:
                raise ValueError(
                    f"request {i}: clip has {clip.shape[1]} channels; "
                    f"tenant {tenant!r} was recorded with "
                    f"{tenants[tenant].channels}"
                )
            key = (tenant, tuple(clip.shape[1:]))
            groups.setdefault(key, []).append(i)

        # canonical group order, so permutations of one tenant mix give
        # one composition
        order = sorted(groups.items(), key=lambda kv: (kv[0][0], str(kv[0][1:])))
        tens = [tenants[key[0]] for key, _ in order]
        # each distinct clip object crosses to the device once, a host
        # clip through pinned staging; a stream that goes through the
        # cursor stays on the host, and the engine moves it one segment
        # at a time
        on_device: dict[int, torch.Tensor] = {}

        def dev(clip):
            t = on_device.get(id(clip))
            if t is None:
                t = on_device[id(clip)] = staged_to_device(clip, self.device)
            return t

        def stack(idxs, ten):
            clips = [requests[i][1] for i in idxs]
            if self._through_cursor(ten, clips[0].shape[-1]):
                return stack_streams([host_stream(c, self.device) for c in clips], self.device)
            return dev(clips[0]) if len(clips) == 1 else torch.cat([dev(c) for c in clips])

        stacks = [stack(idxs, ten) for (_, idxs), ten in zip(order, tens)]
        if self.chaos is not None:  # chaos seam: batch encode/stacking
            self.chaos.on("encode", mode="pooled" if pooled else "sequential")
        return order, tens, stacks

    def _through_cursor(self, ten: _Tenant, n_frames: int) -> bool:
        """Whether a tenant group's stream of ``n_frames`` needs more than
        ``max_buffer_windows`` windows, so the engine's cursor serves it."""
        mbw = self.cfg.max_buffer_windows
        if mbw is None:
            return False
        plan = spectral_conv.stream_plan(
            int(n_frames), ten.kt, self.cfg.window_frames, self.cfg.chunk_windows
        )
        return plan.n_blocks > max(int(mbw), 1)

    @staticmethod
    def _readout(fmaps) -> list[tuple[np.ndarray, np.ndarray]]:
        """The stitched-volume readout shared by both rungs: per group,
        peak and first-occurrence argmax over each (row, kernel) volume."""
        out = []
        for f in fmaps:
            flat = f.reshape(f.shape[0], f.shape[1], -1)
            out.append((torch.amax(flat, -1).cpu().numpy(), torch.argmax(flat, -1).cpu().numpy()))
        return out

    # -- observability -----------------------------------------------------

    def metrics(self) -> dict:
        """Serving metrics: cache counters + measured vs projected rates
        (rates divide by summed per-group busy seconds)."""
        with self._lock:
            per_tenant = {
                name: {
                    "fidelity": t.fidelity_label,
                    "device": t.device_label,
                    "queries": t.queries,
                    "windows": t.windows,
                    "frames": t.frames,
                    "seconds": t.seconds,
                }
                for name, t in self._tenants.items()
            }
            retired = self._retired
            queries = retired.queries + sum(t["queries"] for t in per_tenant.values())
            windows = retired.windows + sum(t["windows"] for t in per_tenant.values())
            frames = retired.frames + sum(t["frames"] for t in per_tenant.values())
            seconds = retired.seconds + sum(t["seconds"] for t in per_tenant.values())
            pooled = self._pooled_dispatches
            sequential = self._sequential_dispatches
            quarantined = self._quarantined
        fps = frames / seconds if seconds > 0 else 0.0
        return {
            "cache": self.cache.stats(),
            "tenants": per_tenant,
            "pooled_dispatches": pooled,
            "sequential_dispatches": sequential,
            # the replica's device mesh (None = one device)
            "mesh": (
                {"shape": self.mesh.shape, "devices": self.mesh.size}
                if self.mesh is not None
                else None
            ),
            "quarantined": quarantined,
            "dedup": self.sthc.engine.pool_stats(),
            "queries": queries,
            "windows_total": windows,
            "frames_total": frames,
            "windows_per_s": windows / seconds if seconds > 0 else 0.0,
            "frames_per_s": fps,
            "device": self.device,
            "projected_slm_fps": throughput.SLM_FPS,
            "projected_hmd_fps": throughput.HMD_FPS,
            "frames_per_s_vs_slm": fps / throughput.SLM_FPS,
            "frames_per_s_vs_hmd": fps / throughput.HMD_FPS,
        }


# ---------------------------------------------------------------------------
# Async microbatch scheduling (queue → batcher → pooled executor)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)  # identity semantics: the clip field
class _Pending:  # would make field-wise == ambiguous (array truthiness)
    tenant: str
    clip: object  # numpy array or tensor, (B, C, H, W, T)
    future: Future
    t_submit: float
    # content fingerprint of the clip, hashed once in the submitter's
    # thread (off the batcher's critical path) — the identity the
    # shared-stream dedup groups ride on
    clip_id: tuple | None = None
    # absolute wall-clock deadline (time.time() frame); None = none
    deadline: float | None = None
    # the scheduler's request number, and when the request entered the
    # queue (perf_counter_ns): the start of its queue wait
    seq: int = 0
    t_queued_ns: int = dataclasses.field(default_factory=time.perf_counter_ns)


class MicrobatchScheduler:
    """Async microbatch front end for a :class:`VideoSearchServer` (port
    of the reference's scheduler: same constructor, defaults and methods;
    ``metrics()`` has the reference's keys plus ``dequeued`` and
    ``queue_wait_ns``).

    Callers ``submit()`` requests and get a
    :class:`concurrent.futures.Future`; a scheduler thread drains the
    bounded queue into mixed-tenant microbatches and dispatches each
    through ``server.search_batch`` — where same-geometry tenants pool
    into single device dispatches.

    * **Admission control / backpressure** — the queue holds at most
      ``max_queue`` requests.  ``submit(block=False)`` (default) sheds
      immediately on a full queue (:class:`RequestRejected`, the
      ``rejected`` counter); ``submit(block=True)`` blocks the caller
      until a slot frees.
    * **Batch forming** — the scheduler takes the first queued request,
      then waits up to ``batch_wait_s`` for more, collecting up to
      ``max_batch`` requests of the *same clip shape* (others are
      stashed for the next cycle, arrival order kept within a shape).
      Requests whose clips hash equal are placed side by side (dedup
      groups) and counted in ``dedup_grouped``.
    * **Observability** — per-request submit → result latency in a
      sliding window; :meth:`metrics` reports p50/p90/p99, queue depth,
      shed/submit/complete counters and the mean formed batch size, and
      the cumulative ``dequeued`` / ``queue_wait_ns`` (requests taken into
      a dispatched batch, and their summed wait since submit), whose
      deltas give the mean queue wait over any window.
    * **Resilience** — deadlines (``default_deadline_s`` / per-request
      ``deadline_s``) enforced at dispatch, across retries, and by a
      watchdog thread that resolves any overdue future with
      ``DeadlineExceeded``; transient dispatch failures retried under
      the seeded ``RetryPolicy``; repeated failures trip the
      ``DegradationLadder``'s breakers, degrading pooled → sequential →
      single-request dispatch and recovering via half-open probes.  (The
      ``pooled`` rung honors the server's ``cfg.pooled_queries``.)
      Every future resolves with a result or a typed ``ServingError``;
      queued futures are resolved with ``SchedulerClosed`` on shutdown.

    The batcher thread launches on its own current CUDA stream — the
    default stream, the same one the caller's thread uses unless it set
    another — so its kernels and copies are ordered as any caller's.  It
    runs with the intra-op thread count of the thread that built the
    scheduler: on the CPU, MKL's FFT rounds by its thread count, which
    ``torch.set_num_threads`` sets for the calling thread alone, so a
    request's scores would otherwise depend on the thread serving it.
    Use as a context manager or call :meth:`close`.
    """

    def __init__(
        self,
        server: VideoSearchServer,
        max_queue: int = 64,
        max_batch: int = 8,
        batch_wait_s: float = 0.002,
        latency_window: int = 1024,
        default_deadline_s: float | None = None,
        retry: RetryPolicy | None = None,
        ladder: DegradationLadder | None = None,
        watchdog_interval_s: float = 0.02,
    ):
        if max_queue < 1 or max_batch < 1:
            raise ValueError("max_queue and max_batch must be >= 1")
        self.server = server
        self.max_batch = int(max_batch)
        self.batch_wait_s = float(batch_wait_s)
        self.default_deadline_s = default_deadline_s
        self.retry = retry if retry is not None else RetryPolicy()
        self.ladder = ladder if ladder is not None else DegradationLadder()
        self._q: queue_mod.Queue[_Pending] = queue_mod.Queue(maxsize=max_queue)
        # batcher-thread only (and _drain_and_fail, which runs strictly
        # after the batcher thread is dead) — deliberately unguarded
        self._stash: collections.deque[_Pending] = collections.deque()
        self._lock = threading.Lock()
        self._latencies: collections.deque[float] = collections.deque(  # guarded-by: _lock
            maxlen=latency_window
        )
        self._batch_sizes: collections.deque[int] = collections.deque(  # guarded-by: _lock
            maxlen=latency_window
        )
        self.submitted = 0  # guarded-by: _lock
        self.completed = 0  # guarded-by: _lock
        self.rejected = 0  # guarded-by: _lock
        self.failed = 0  # guarded-by: _lock
        self.batches = 0  # guarded-by: _lock
        # requests that joined an existing shared-stream dedup group
        # (same-clip rows beyond the first in a formed batch)
        self.dedup_grouped = 0  # guarded-by: _lock
        self.deadline_missed = 0  # guarded-by: _lock
        self.retries = 0  # guarded-by: _lock
        self.quarantined = 0  # guarded-by: _lock
        self.dequeued = 0  # guarded-by: _lock
        self.queue_wait_ns = 0  # guarded-by: _lock
        self._batch_seq = 0  # guarded-by: _lock
        self._request_seq = itertools.count(1)
        # serializes intake against close(): submit must never land a
        # request after close() drained the queue (its future would hang
        # forever).  Deliberately NOT self._lock — the batcher takes
        # that inside _dispatch, and a submitter blocked on a full
        # queue while holding it would deadlock the drain.
        self._intake_lock = threading.Lock()
        self._num_threads = torch.get_num_threads()
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="sthc-microbatcher", daemon=True
        )
        self._thread.start()
        # the no-hangs backstop: resolves overdue futures with
        # DeadlineExceeded and fails everything if the batcher dies
        self._watchdog = Watchdog(
            interval_s=watchdog_interval_s,
            on_expire=self._on_deadline_expired,
            on_tick=self._check_liveness,
        )

    # -- intake ------------------------------------------------------------

    def submit(
        self,
        tenant: str,
        clip,
        block: bool = False,
        deadline_s: float | None = None,
    ) -> Future:
        """Enqueue one search; returns a future resolving to the same
        result dict ``search_batch`` produces (plus ``queue_latency_s``,
        the end-to-end submit→result time).

        The clip's content fingerprint (the full SHA-1, ``clip_key``) is
        hashed here, in the caller's thread, so the batcher forms dedup
        groups without re-reading clip bytes: a numpy clip is hashed in
        place, a CUDA tensor costs one device→host copy first.  Skipped
        when the server's dedup (or its pooled path) is off.

        ``deadline_s`` (default ``self.default_deadline_s``; None = no
        deadline) bounds submit → result: past it the future resolves
        with :class:`DeadlineExceeded` — enforced at dispatch, across
        retries, and by the watchdog thread as the backstop."""
        cfg = self.server.cfg
        # the sequential executor never reads clip keys either
        wants_dedup = cfg.dedup_clips and cfg.pooled_queries
        cid = clip_key(clip) if wants_dedup else None
        now = time.time()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline = now + deadline_s if deadline_s is not None else None
        item = _Pending(tenant, clip, Future(), now, cid, deadline, seq=next(self._request_seq))
        # every put happens under the intake lock (so close() can never
        # miss a request and leave its future hanging), but the lock is
        # never held across a blocking wait: a backpressured submitter
        # polls for a slot between acquisitions
        while True:
            with self._intake_lock:
                if self._closed.is_set():
                    raise SchedulerClosed("scheduler is closed")
                try:
                    self._q.put_nowait(item)
                    break
                except queue_mod.Full:
                    if not block:
                        with self._lock:
                            self.rejected += 1
                        raise RequestRejected(
                            f"request queue full ({self._q.maxsize} deep); "
                            f"request for tenant {tenant!r} shed",
                            tenant=tenant,
                        ) from None
            time.sleep(0.001)  # backpressure: wait for a slot
        with self._lock:
            self.submitted += 1
        self._watchdog.track(item.future, deadline, tenant)
        return item.future

    def search(self, tenant: str, clip, block: bool = True) -> dict:
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(tenant, clip, block=block).result()

    # -- the batcher loop --------------------------------------------------

    def _take(self, timeout: float) -> _Pending | None:
        if self._stash:
            return self._stash.popleft()
        try:
            return self._q.get(timeout=timeout)
        except queue_mod.Empty:
            return None

    def _run(self) -> None:
        torch.set_num_threads(self._num_threads)
        while True:
            if self._closed.is_set():
                # exit promptly: anything still queued/stashed is failed
                # by close()'s drain
                return
            item = self._take(timeout=0.05)
            if item is None:
                continue
            # one batcher cycle: form, then dispatch and deliver
            with tracing.span("sched.batch") as cycle:
                with tracing.span("sched.form"):
                    batch = [item]
                    shape = tuple(item.clip.shape)
                    deadline = item.t_submit + self.batch_wait_s
                    # coalesce with earlier same-shape stash leftovers first
                    kept: collections.deque[_Pending] = collections.deque()
                    while self._stash and len(batch) < self.max_batch:
                        nxt = self._stash.popleft()
                        if tuple(nxt.clip.shape) == shape:
                            batch.append(nxt)
                        else:
                            kept.append(nxt)
                    kept.extend(self._stash)
                    self._stash = kept
                    # then the live queue: wait out the deadline for a fuller
                    # batch, and past it take only what is already here —
                    # bounded to 2 * max_batch pulls per cycle, so a sustained
                    # other-shape stream can neither livelock this batch nor
                    # grow the stash without bound
                    skipped: list[_Pending] = []
                    while (
                        len(batch) < self.max_batch
                        and len(batch) + len(skipped) < 2 * self.max_batch
                    ):
                        rem = deadline - time.time()
                        try:
                            if rem > 0:
                                nxt = self._q.get(timeout=rem)
                            else:
                                nxt = self._q.get_nowait()
                        except queue_mod.Empty:
                            break
                        if tuple(nxt.clip.shape) == shape:
                            batch.append(nxt)
                        else:
                            skipped.append(nxt)
                    self._stash.extend(skipped)  # next cycle, arrival order kept
                try:
                    cycle.note(
                        "batch", self._dispatch(self._form_dedup_groups(batch))
                    )
                except Exception:  # noqa: BLE001 — the batcher must survive
                    # _dispatch fails futures itself; this is a belt for
                    # future-state races — a dead batcher thread would hang
                    # every later request
                    pass

    def _form_dedup_groups(self, batch: list[_Pending]) -> list[_Pending]:
        """Arrange a formed microbatch into shared-stream dedup groups:
        requests whose clips hash equal become adjacent (stable within a
        group, groups in first-arrival order).  Rows the dedup will
        collapse (every request beyond the first of its clip) are
        counted for :meth:`metrics`."""
        groups: dict[tuple, list[_Pending]] = {}
        singles: list[_Pending] = []  # unhashed clips: never deduped
        order: list[tuple] = []  # first-arrival group order
        for p in batch:
            if p.clip_id is None:
                singles.append(p)
                continue
            if p.clip_id not in groups:
                order.append(p.clip_id)
            groups.setdefault(p.clip_id, []).append(p)
        shared = sum(len(g) - 1 for g in groups.values())
        if shared:
            with self._lock:
                self.dedup_grouped += shared
        return [p for k in order for p in groups[k]] + singles

    @staticmethod
    def _claim(future: Future) -> bool:
        """``set_running_or_notify_cancel`` tolerant of the watchdog
        having already resolved the future (raises from FINISHED)."""
        try:
            return future.set_running_or_notify_cancel()
        except Exception:  # noqa: BLE001 — InvalidStateError
            return False

    def _expire(self, p: _Pending, batch_id: int | None) -> None:
        if resolve_exception(
            p.future,
            DeadlineExceeded(
                f"deadline passed before dispatch for tenant {p.tenant!r}",
                tenant=p.tenant,
                batch_id=batch_id,
            ),
        ):
            with self._lock:
                self.deadline_missed += 1
                self.failed += 1

    def _dispatch(self, batch: list[_Pending]) -> int:
        """Serve one formed batch; returns its id.  Its requests' queue
        waits end here."""
        t_ns = time.perf_counter_ns()
        with self._lock:
            self._batch_seq += 1
            batch_id = self._batch_seq
            self.dequeued += len(batch)
            self.queue_wait_ns += sum(t_ns - p.t_queued_ns for p in batch)
        if tracing.recording():
            for p in batch:
                tracing.record("sched.queue", p.t_queued_ns, t_ns, request=p.seq, batch=batch_id)
        # claim each future before any work: a cancelled future drops
        # out, and claiming locks out late cancels during the server
        # call.  _execute assumes every future it sees is claimed.
        batch = [p for p in batch if self._claim(p.future)]
        if batch:
            self._execute(batch, batch_id)
        return batch_id

    def _run_mode(self, mode: str, batch: list[_Pending]) -> list:
        """One dispatch in the given ladder mode.  ``pooled`` defers to
        the server's configured preference (``cfg.pooled_queries``);
        ``sequential`` forces the per-tenant dispatch loop; ``single``
        additionally drops microbatching — one server call per request,
        the floor the ladder can always serve from."""
        keys = [p.clip_id for p in batch]
        reqs = [(p.tenant, p.clip) for p in batch]
        if mode == "pooled":
            # fingerprints were hashed at submit: the executor's dedup
            # must not re-read the clip bytes per batch
            return self.server.search_batch(reqs, clip_keys=keys)
        if mode == "sequential":
            return self.server.search_batch(reqs, pooled=False, clip_keys=keys)
        outs = []
        for req, key in zip(reqs, keys):
            outs.extend(
                self.server.search_batch([req], pooled=False, clip_keys=[key])
            )
        return outs

    def _execute(self, batch: list[_Pending], batch_id: int) -> None:
        """Serve one claimed microbatch to completion: ladder-mode
        selection, transient-failure retries under the seeded backoff,
        deadline pruning between attempts, and typed-error resolution.
        Every future in ``batch`` is resolved by the time this returns
        (or already was, by the watchdog/close)."""
        # the retry schedule ends once a sleep would run past the
        # batch's earliest request deadline
        deadlines = [p.deadline for p in batch if p.deadline is not None]
        delays = self.retry.delays(
            deadline=min(deadlines) if deadlines else None
        )
        while True:
            now = time.time()
            live: list[_Pending] = []
            for p in batch:
                if p.future.done():  # watchdog/cancel won the race
                    continue
                if p.deadline is not None and now >= p.deadline:
                    self._expire(p, batch_id)
                    continue
                live.append(p)
            if not live:
                return
            batch = live
            mode = self.ladder.select()
            try:
                outs = self._run_mode(mode, batch)
            except Exception as exc:  # noqa: BLE001 — routed into futures
                # validation errors neither trip breakers nor retry: a
                # malformed request fails every rung identically
                if not is_validation_error(exc):
                    self.ladder.report(mode, ok=False)
                    if self.ladder.peek() != mode:
                        # the ladder degraded under us: re-dispatch on the
                        # lower rung — degradation is not a retry and must
                        # not consume the backoff budget
                        continue
                    if is_transient(exc):
                        delay = next(delays, None)
                        if delay is not None:
                            with self._lock:
                                self.retries += 1
                            time.sleep(delay)
                            continue
                if len(batch) > 1:
                    # one bad request fails the batched call upfront (the
                    # server validates before any device work): retry
                    # singly so the good requests still complete
                    for p in batch:
                        self._execute([p], batch_id)
                    return
                p = batch[0]
                if isinstance(exc, ServingError) or is_validation_error(exc):
                    err: BaseException = exc  # typed/caller error: as-is
                else:
                    err = BatchExecutionError(
                        f"batch {batch_id} failed in {mode!r} mode after "
                        f"retries: {exc}",
                        tenant=p.tenant,
                        batch_id=batch_id,
                    )
                    err.__cause__ = exc
                if resolve_exception(p.future, err):
                    with self._lock:
                        self.failed += 1
                return
            self.ladder.report(mode, ok=True)
            self._deliver(batch, outs, batch_id)
            return

    def _deliver(
        self, batch: list[_Pending], outs: list, batch_id: int
    ) -> None:
        with tracing.span("sched.deliver"):
            now = time.time()
            with self._lock:
                self.batches += 1
                self._batch_sizes.append(len(batch))
            for p, out in zip(batch, outs):
                if isinstance(out, ServingError):
                    # signal-integrity quarantine: the server isolated this
                    # row; the rest of the batch delivered untouched
                    out.tenant = out.tenant or p.tenant
                    out.batch_id = batch_id
                    if resolve_exception(p.future, out):
                        with self._lock:
                            self.quarantined += 1
                            self.failed += 1
                    continue
                out["queue_latency_s"] = now - p.t_submit
                if resolve_result(p.future, out):
                    with self._lock:
                        self.completed += 1
                        self._latencies.append(now - p.t_submit)

    # -- lifecycle / observability ----------------------------------------

    def _on_deadline_expired(self, tenant: str | None) -> None:
        # watchdog resolved an overdue future with DeadlineExceeded
        with self._lock:
            self.deadline_missed += 1
            self.failed += 1

    def _check_liveness(self) -> None:
        # watchdog tick: a dead batcher thread would hang every queued
        # future — close intake and resolve the backlog instead
        if self._closed.is_set() or self._thread.is_alive():
            return
        with self._intake_lock:
            if self._closed.is_set():
                return
            self._closed.set()
        self._drain_and_fail(
            lambda p: BatchExecutionError(
                "scheduler batcher thread died", tenant=p.tenant
            )
        )

    def _drain_and_fail(self, make_exc) -> None:
        """Resolve everything still queued/stashed with ``make_exc(p)``."""
        leftovers = list(self._stash)
        self._stash.clear()
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue_mod.Empty:
                break
        for p in leftovers:
            if resolve_exception(p.future, make_exc(p)):
                with self._lock:
                    self.failed += 1

    def close(self) -> None:
        """Stop the batcher; resolve anything still queued with
        :class:`SchedulerClosed` (futures are never abandoned)."""
        with self._intake_lock:
            # under the intake lock: a submit() that already passed the
            # closed check finishes its put before we proceed
            if self._closed.is_set():
                self._watchdog.close()
                return
            self._closed.set()
        self._thread.join()
        self._drain_and_fail(
            lambda p: SchedulerClosed("scheduler closed", tenant=p.tenant)
        )
        self._watchdog.close()

    def __enter__(self) -> "MicrobatchScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def metrics(self) -> dict:
        """Scheduler counters + end-to-end latency percentiles +
        resilience state (ladder mode, breaker snapshots, deadline/
        retry/quarantine counters): the reference's keys, plus the
        cumulative ``dequeued`` and ``queue_wait_ns``."""
        with self._lock:
            lats = sorted(self._latencies)
            sizes = list(self._batch_sizes)
            out = {
                "queue_depth": self._q.qsize() + len(self._stash),
                "max_queue": self._q.maxsize,
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "failed": self.failed,
                "batches": self.batches,
                "dedup_grouped": self.dedup_grouped,
                "mean_batch_size": (
                    sum(sizes) / len(sizes) if sizes else 0.0
                ),
                "mode": self.ladder.peek(),
                "ladder": self.ladder.metrics(),
                "deadline_missed": self.deadline_missed,
                "retries": self.retries,
                "quarantined": self.quarantined,
                "dequeued": self.dequeued,
                "queue_wait_ns": self.queue_wait_ns,
                "watchdog_expired": self._watchdog.expired,
                "default_deadline_s": self.default_deadline_s,
            }
        for name, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
            out[f"latency_{name}_ms"] = (
                1e3 * lats[min(int(q * len(lats)), len(lats) - 1)]
                if lats
                else 0.0
            )
        return out


# ---------------------------------------------------------------------------
# Hybrid classifier serving (paper §4: conv optical, head digital)
# ---------------------------------------------------------------------------


class HybridClassifierServer:
    """Serve the trained hybrid 3-D CNN with the STHC conv backend.

    ``params`` is the :class:`~repro_torch.core.hybrid.HybridCNN` built for
    ``cfg`` (``hybrid.init_params`` or ``interop.hybrid_params_from_numpy``);
    it is moved to ``device`` (None = the card).  ``fidelity`` overrides
    the ``physical`` switch's preset."""

    def __init__(self, params: hybrid.HybridCNN, cfg: hybrid.HybridConfig,
                 physical: bool = True,
                 fidelity: FidelityPipeline | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        if fidelity is None:
            fidelity = (
                fidelity_mod.physical() if physical else fidelity_mod.ideal()
            )
        self.params = params.to(self.device)
        self.sthc = STHC(STHCConfig(fidelity=fidelity, device=self.device))
        # record once: the kernels live in the atomic medium
        with torch.no_grad():
            self.grating = self.sthc.record(
                self.params.conv_w, (cfg.height, cfg.width, cfg.frames)
            )

    def _head(self, conv_out: torch.Tensor) -> torch.Tensor:
        y = conv_out + self.params.conv_b[None, :, None, None, None]
        return hybrid.head(self.params, y, self.cfg)

    @torch.no_grad()
    def classify(self, clips) -> np.ndarray:
        """Class predictions (B,) of clips (B, C, H, W, frames), numpy or
        a tensor."""
        with tracing.span("classify.upload"):
            x = hybrid.clips_to_device(self.params, clips)
        with tracing.span("classify.correlate"):
            conv = self.sthc.correlate(self.grating, x)  # optical layer
        with tracing.span("classify.head"):
            preds = torch.argmax(self._head(conv), dim=-1)  # digital layers
        with tracing.span("classify.readback"):
            return preds.cpu().numpy()

    @torch.no_grad()
    def classify_stream(self, clips, block_t: int | None = None) -> np.ndarray:
        """Long-clip inference (paper Fig. 1C): conv streams through the
        engine's coherence-window overlap-save path, then the digital
        head classifies each ``cfg.frames``-long segment of the stream.

        ``clips`` is (B, C, H, W, T) with arbitrary T ≥ ``cfg.frames``;
        returns (B, n_segments) class predictions, one per training-
        length window at stride ``ot = frames − k_t + 1``.  Segment s of
        the streamed conv output is the one-shot conv of input frames
        ``[s·ot, s·ot + cfg.frames)``, so each prediction matches
        `classify` on that sub-clip (physical mode differs only in the
        stream-global vs per-segment SLM scale).
        """
        cfg = self.cfg
        if clips.shape[-1] < cfg.frames:
            # reject before any device work: a T >= kt stream would
            # stream-correlate fine yet still yield zero segments
            raise ValueError(
                f"stream of {clips.shape[-1]} frames is shorter than one "
                f"classification window ({cfg.frames} frames)"
            )
        with tracing.span("classify.upload"):
            x = host_stream(clips, self.device)
        with tracing.span("classify.correlate"):
            conv = self.sthc.correlate_stream(
                self.params.conv_w, x, cfg.frames if block_t is None else int(block_t)
            )
        ot = cfg.conv_out_shape[2]
        n_seg = conv.shape[-1] // ot
        with tracing.span("classify.head"):
            # fold the equal-shape segments into the batch axis: one head
            # call + one host transfer regardless of stream length
            segs = conv[..., : n_seg * ot].reshape(conv.shape[:-1] + (n_seg, ot))
            segs = torch.movedim(segs, -2, 0)  # segment-major
            segs = segs.reshape((n_seg * conv.shape[0],) + tuple(conv.shape[1:-1]) + (ot,))
            preds = torch.argmax(self._head(segs), dim=-1).reshape(n_seg, -1)
        with tracing.span("classify.readback"):
            return preds.T.cpu().numpy()  # (B, n_seg)


class C3DClassifierServer:
    """Serve C3D, the digital 3-D CNN (``models/c3d.py``), on the classifier
    path: the same ``classify(clips)`` entry, pinned upload and readback as
    :class:`HybridClassifierServer`, the trunk's eight convolutions on
    kernel B4 (its ``igemm`` route on the card) where the hybrid records
    and correlates an STHC grating.

    ``params`` is the :class:`~repro_torch.models.c3d.C3D` to serve
    (``c3d.init_params``, or loaded by name); it is moved to ``device``
    (None = the card)."""

    def __init__(self, params: c3d.C3D, device=None):
        self.device = resolve_device(device)
        self.cfg = params.cfg
        self.params = params.to(self.device)

    def _head(self, features: torch.Tensor) -> torch.Tensor:
        return c3d.head(self.params, features)

    @torch.no_grad()
    def classify(self, clips) -> np.ndarray:
        """Class predictions (B,) of clips (B, C, H, W, frames), numpy or
        a tensor."""
        with tracing.span("classify.upload"):
            x = stage_clips(clips, self.device, torch.float32)
        with tracing.span("classify.conv"):
            features = c3d.trunk(self.params, x)
        with tracing.span("classify.head"):
            preds = torch.argmax(self._head(features), dim=-1)
        with tracing.span("classify.readback"):
            return preds.cpu().numpy()


# ---------------------------------------------------------------------------
# LM serving
# ---------------------------------------------------------------------------


class LMServer:
    """Greedy generation with a ported language model (port of the
    reference's ``LMServer``).

    ``params`` is the model module built for ``cfg`` (``init_params`` or
    ``interop.*_params_from_numpy``); it is moved to ``device`` (None =
    the card).  ``max_len`` is the KV cache's length in positions: a
    dense transformer's prompt plus generated tokens must fit in it (its
    decode raises a ``ValueError`` past it).  Zamba-2 keeps one such KV
    cache per shared-block site (``n_segments`` of them), so ``max_len``
    bounds it the same way and sizes it ``n_segments`` times over.
    Mamba-2 ignores it: an SSM state does not grow with the sequence.
    An Arctic-style MoE model keeps the dense transformer's K/V cache;
    MLA (DeepSeek-V2) caches a latent of ``kv_lora + qk_rope`` values per
    position and layer.  MoE decode drops tokens: a decode step routes
    the batch's B tokens as one group, so each expert takes
    max(int(capacity_factor · B · top_k / E), 1) of them (1 for both
    published configs at B <= 4), and a token whose choice collides with
    an earlier one loses that expert, as in the reference.  The VLM's
    cache holds its ``n_patches`` patch positions ahead of the prompt, so
    its ``max_len`` counts them too (patches + prompt + generated tokens).
    Whisper's ``max_len`` bounds the decoder's self K/V; its cross K/V are
    fixed at the T encoder frames, and its positions end at
    ``max_target``."""

    def __init__(self, cfg, params: torch.nn.Module, max_len: int = 128, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_len = max_len
        model_api.get_model(cfg)  # a TypeError for a family not ported yet
        if getattr(params, "cfg", None) != cfg:
            raise ValueError("params were not built for this config")
        self.model = params.to(self.device)

    def _prompts(self, prompts):
        """The prompts on the server's device: (B, S) tokens as ``long``;
        for the ``'audio'`` and ``'vlm'`` families a batch dict, its
        ``tokens`` as ``long`` and its floating entries (``frames``,
        ``patches``) as they are, for the model to cast."""
        if self.cfg.family not in ("audio", "vlm"):
            return torch.as_tensor(prompts).to(device=self.device, dtype=torch.long)
        if not isinstance(prompts, dict):
            raise TypeError(
                f"a {self.cfg.family!r} model takes a batch dict of tokens and "
                f"{'frames' if self.cfg.family == 'audio' else 'patches'}, got {type(prompts).__name__}"
            )
        batch = {}
        for name, value in prompts.items():
            t = torch.as_tensor(value)
            if name == "tokens":
                batch[name] = t.to(device=self.device, dtype=torch.long)
            elif t.is_floating_point():
                batch[name] = t.to(device=self.device)
            else:
                raise ValueError(f"prompts[{name!r}] must be floating, got {t.dtype}")
        return batch

    @torch.inference_mode()
    def generate(self, prompts, n_tokens: int) -> np.ndarray:
        """Greedy generation.  prompts: (B, S) integer tokens (numpy or a
        tensor), or for the ``'audio'`` and ``'vlm'`` families a dict of
        ``tokens`` (B, S) and ``frames`` (B, T, d_model) or ``patches``
        (B, Np, d_model), passed to ``prefill`` as the reference passes
        it.  Returns (B, n_tokens) int32: the argmax after the prompt, then
        after each generated token."""
        logits, cache = self.model.prefill(self._prompts(prompts), max_len=self.max_len)
        out = [logits.argmax(-1)[:, None]]
        for _ in range(n_tokens - 1):
            logits, cache = self.model.decode_step(cache, out[-1])
            out.append(logits.argmax(-1)[:, None])
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="STHC video-search / LM serving demo")
    ap.add_argument(
        "--mode", choices=["video", "lm"], default="video",
        help="video: two-tenant video search; lm: greedy generation of 8 "
        "tokens after an 8-token prompt with the qwen2-1.5b smoke config",
    )
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        cfg = configs.get_smoke_config("qwen2-1.5b")
        device = resolve_device(args.device)
        params = model_api.get_model(cfg).init_params(
            cfg, torch.Generator(device).manual_seed(0), device=device
        )
        server = LMServer(cfg, params, device=device)
        toks = np.arange(8, dtype=np.int64)[None] % cfg.vocab
        print(f"generated on {device}:", server.generate(toks, 8))
        return
    rng = np.random.RandomState(0)
    server = VideoSearchServer(
        frame_hw=(24, 32), cfg=VideoSearchConfig(device=args.device)
    )
    kernels = rng.randn(4, 1, 12, 16, 8).astype(np.float32)
    server.add_kernel_set("events-ideal", kernels)
    server.add_kernel_set("events-physical", kernels, fidelity=fidelity_mod.physical())
    clip = rng.rand(2, 1, 24, 32, args.frames).astype(np.float32)
    outs = server.search_batch([("events-ideal", clip), ("events-physical", clip)])
    m = server.metrics()
    for out in outs:
        fid = m["tenants"][out["tenant"]]["fidelity"]
        print(
            f"[{out['tenant']} ({fid})] searched {args.frames} frames in "
            f"{out['windows']} coherence windows on {m['device']}, latency "
            f"{out['latency_s']:.3f}s"
        )
        print("  scores:", np.round(out["scores"], 2))
    print(
        f"cache: {m['cache']['hits']} hits / {m['cache']['misses']} misses"
        f" / {m['cache']['evictions']} evictions, "
        f"{m['cache']['bytes'] / 1e6:.1f} MB resident"
    )


if __name__ == "__main__":
    main()
