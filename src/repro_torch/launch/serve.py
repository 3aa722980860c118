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
projected loader rates.  The microbatch scheduler, the chaos seams and
mesh serving come in later slices.

:class:`HybridClassifierServer` serves the paper's hybrid 3-D CNN (§4):
the conv layer is an STHC whose grating is recorded once, at
construction, and every ``classify`` runs one correlate (kernel B1 on
the card) and the digital head; ``classify_stream`` streams long clips
through the coherence-window overlap-save path and classifies each
training-length segment.

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
import dataclasses
import threading
import time
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core import atomic, fidelity as fidelity_mod, hybrid, optics, throughput
from repro_torch.core import spectral_conv
from repro_torch.core.engine import (
    TOPK_EMPTY_IDX,
    GratingCache,
    as_tensor,
    clip_keys_for,
    host_stream,
    stack_streams,
)
from repro_torch.core.fidelity import FidelityPipeline
from repro_torch.core.sthc import STHC, STHCConfig
from repro_torch.launch.resilience import ServingError, TenantQuarantined
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
      mesh_shape: device-mesh serving; not ported yet (raises).
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
    device: str | None = None

    def __post_init__(self) -> None:
        if self.mesh_shape is not None:
            raise NotImplementedError(
                "mesh serving is not ported to the torch package yet"
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
        self.cache = GratingCache(
            max_entries=cfg.cache_entries,
            max_bytes=cfg.cache_bytes,
            verify=cfg.verify_gratings,
        )
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
        # each distinct clip object crosses to the device once; a stream
        # that goes through the cursor stays on the host, and the engine
        # moves it one segment at a time
        on_device: dict[int, torch.Tensor] = {}

        def dev(clip):
            t = on_device.get(id(clip))
            if t is None:
                t = on_device[id(clip)] = as_tensor(clip, self.device)
            return t

        def stack(idxs, ten):
            clips = [requests[i][1] for i in idxs]
            if self._through_cursor(ten, clips[0].shape[-1]):
                return stack_streams([host_stream(c, self.device) for c in clips], self.device)
            return dev(clips[0]) if len(clips) == 1 else torch.cat([dev(c) for c in clips])

        stacks = [stack(idxs, ten) for (_, idxs), ten in zip(order, tens)]

        if pooled:
            t0 = time.perf_counter()
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
            engine = self.sthc.engine
            if fused:
                fmaps = None
                dets = engine.query_stream_many(
                    list(zip(gratings, stacks)),
                    clip_keys=group_keys,
                    dedup=dedup,
                    readout_k=topk,
                )
                states = [(d.scores.cpu(), d.index.cpu()) for d in dets]
            else:
                dets = None
                fmaps = engine.query_stream_many(
                    list(zip(gratings, stacks)), clip_keys=group_keys, dedup=dedup
                )
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
                grating = self._fetch_grating(key[0], ten)
                if fused:
                    det = ten.sthc.engine.query_stream(grating, clips, readout_k=topk)
                    dets.append(det)
                    states.append((det.scores.cpu(), det.index.cpu()))
                else:
                    fmaps.append(ten.sthc.engine.query_stream(grating, clips))
                    _sync(self.device)
                dt = time.perf_counter() - t0
                with self._lock:
                    self._sequential_dispatches += 1
                gratings.append(grating)
                plans.append(ten.sthc.engine.stream_plan_for(grating, clips.shape[-1]))
                lat.append(dt)
                busy.append(dt)
            if not fused:
                readouts = self._readout(fmaps)

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
        x = as_tensor(clips, self.device)
        conv = self.sthc.correlate(self.grating, x)  # optical layer
        logits = self._head(conv)  # digital layers
        return torch.argmax(logits, dim=-1).cpu().numpy()

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
        conv = self.sthc.correlate_stream(
            self.params.conv_w,
            host_stream(clips, self.device),
            cfg.frames if block_t is None else int(block_t),
        )
        ot = cfg.conv_out_shape[2]
        n_seg = conv.shape[-1] // ot
        # fold the equal-shape segments into the batch axis: one head
        # call + one host transfer regardless of stream length
        segs = conv[..., : n_seg * ot].reshape(conv.shape[:-1] + (n_seg, ot))
        segs = torch.movedim(segs, -2, 0)  # segment-major
        segs = segs.reshape((n_seg * conv.shape[0],) + tuple(conv.shape[1:-1]) + (ot,))
        preds = torch.argmax(self._head(segs), dim=-1).reshape(n_seg, -1)
        return preds.T.cpu().numpy()  # (B, n_seg)


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
    decode raises a ``ValueError`` past it).  Mamba-2 ignores it: an SSM
    state does not grow with the sequence."""

    def __init__(self, cfg, params: torch.nn.Module, max_len: int = 128, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_len = max_len
        model_api.get_model(cfg)  # a TypeError for a family not ported yet
        if getattr(params, "cfg", None) != cfg:
            raise ValueError("params were not built for this config")
        self.model = params.to(self.device)

    @torch.inference_mode()
    def generate(self, prompts, n_tokens: int) -> np.ndarray:
        """Greedy generation.  prompts: (B, S) integer tokens (numpy or a
        tensor).  Returns (B, n_tokens) int32: the argmax after the
        prompt, then after each generated token."""
        toks = torch.as_tensor(prompts).to(device=self.device, dtype=torch.long)
        logits, cache = self.model.prefill(toks, max_len=self.max_len)
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
