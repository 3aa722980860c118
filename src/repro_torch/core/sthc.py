"""The Spatio-Temporal Holographic Correlator, end to end (port of
``repro.core.sthc``).

`STHC` packages the record/query cycle of the optical system around the
fused :class:`~repro.core.engine.QueryEngine` (the single hot path for
all STHC consumers):

  1. **record** — project the reference kernels through the pipeline's
     record-time stages (± encoding, SLM quantization, IHB/pulse
     envelopes, T2 apodization); store the 3-D spectrum as the atomic
     grating.  The engine folds everything static — the ``G⁺ − G⁻``
     combine, the kernel de-quantization scale, the photon-echo gain —
     into a single effective grating.  Recording is memoized in a
     content-hash cache keyed on the kernel bytes *and* the pipeline
     fingerprint, so repeated calls with the same kernels write the
     medium once, exactly like the physical system.
  2. **query** — project video clips; one forward ``rfftn`` per clip,
     one channel-contracted spectral MAC against the effective grating
     (the compute hot spot, served by the hand-written CUDA ``stmul``
     kernel under ``use_pallas``), one inverse FFT.  The only per-query epilogue left is the
     pipeline's query-time de-scaling (when it encodes at all).

Fidelity is a first-class, per-correlator object — an ordered stack of
typed physics stages (:mod:`repro.core.fidelity`):

* ``fidelity.ideal()``     — exact FFT correlator (no stages).  Must match
  direct correlation to float tolerance (tested); the numerical 'spec'.
* ``fidelity.physical()``  — SLM bit-depth quantization, pseudo-negative ±
  channels, IHB bandwidth envelope, T2 apodization, echo efficiency,
  recording-pulse deconvolution.  The paper's reported accuracy drop
  (69.84 % digital val → 59.72 % hybrid test) comes from this stack.
* arbitrary named subsets — ``fidelity.pipeline(SLMQuantize(), ...)`` —
  power the ablation benchmark's stage-by-stage decomposition and
  per-tenant mixed-fidelity serving.

Migration: ``STHCConfig(mode="ideal"|"physical")`` survives as a thin
deprecated alias mapping to the matching preset (with a
``DeprecationWarning``); outputs are bit-identical (pinned tests).  New
code passes ``STHCConfig(fidelity=...)``.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch import resolve_device, tracing
from repro_torch.core import atomic, fidelity as fidelity_mod, optics
from repro_torch.core.engine import FusedGrating, GratingCache, QueryEngine, default_cache
from repro_torch.core.fidelity import FidelityPipeline

Array = torch.Tensor

# Backward-compatible name: the recorded state of the medium.
Grating = FusedGrating


@dataclasses.dataclass(frozen=True)
class STHCConfig:
    # DEPRECATED: the two-way fidelity switch.  Maps to the matching
    # pipeline preset with a DeprecationWarning; use ``fidelity=``.
    mode: str | None = None
    # The fidelity pipeline — an ordered stack of typed physics stages
    # (repro.core.fidelity).  None resolves to fidelity.ideal() (or to
    # the preset named by the deprecated ``mode``).
    fidelity: FidelityPipeline | None = None
    slm: optics.SLMConfig = dataclasses.field(default_factory=optics.SLMConfig)
    atoms: atomic.AtomicConfig = dataclasses.field(default_factory=atomic.AtomicConfig)
    # route the spectral MAC and the top-K readout through the
    # hand-written CUDA kernels of kernels/stmul (their plain torch
    # versions on CPU tensors); False = the torch einsum path
    use_pallas: bool = True
    stmul_version: int = 2  # stmul MAC generation (2 Karatsuba, 1 direct)
    # The reference's TPU tile and MXU-routing knobs.  They keep their
    # names so one set of values builds both packages; the CUDA kernels
    # choose their own launch shape and read none of them.
    stmul_min_mxu_c: int | None = None
    stmul_block_b: int | None = None
    stmul_block_o: int | None = None
    stmul_block_f: int | None = None
    readout_block_o: int | None = None
    readout_block_l: int | None = None
    storage_interval_s: float = 0.0  # T_Q − T_P (echo-efficiency factor)
    # DEPRECATED alongside ``mode``: with the deprecated alias it selects
    # the physical preset's PulseCompensate(compensate=...) stage; with an
    # explicit ``fidelity`` pipeline, pass the stage parameter instead.
    compensate_pulse: bool = True
    fused: bool = True  # single-FFT fused query (False = two-query reference)
    # Storage precision of the recorded effective grating: 'float32' keeps
    # the complex64 tensor (bit-identical to every pre-knob path);
    # 'bfloat16' stores split real/imag bf16 planes — half the HBM per
    # grating, so a GratingCache byte budget holds ~2x the tenants — and
    # queries up-cast to f32 at the MAC (f32 accumulation).  bf16 storage
    # targets serving: the raw ± reference stack is dropped (as with
    # keep_stacked=False) because the unfused reference path is an f32
    # validation tool, not a serving path.
    grating_dtype: str = "float32"
    cache_gratings: bool = True  # memoize record() by kernel content hash
    # Keep the raw ± gratings alongside the effective one at record time.
    # Only the unfused reference path reads them; serving sets False so a
    # cached physical grating charges 1x (not 3x) its hot-path bytes
    # against the cache byte budget.
    keep_stacked: bool = True
    # Overlap-save streaming: windows correlated per chunk (one batch).
    # 1 = strictly sequential (lowest peak memory, the seed behavior).
    osave_chunk_windows: int = 1
    # Bounded-memory streaming: serve at most this many coherence windows
    # from one device buffer.  Streams needing more are fed through a
    # StreamCursor in fixed-size T-chunks with kt−1-frame carry-over
    # tails — peak device memory stays constant no matter how long the
    # clip, and the output equals the one-shot correlation exactly (the
    # SLM scale stays stream-global).  None = unbounded (whole stream in
    # one buffer, the pre-cursor behavior).
    osave_max_buffer_windows: int | None = None
    # torch device the correlator runs on; None = the card ("cuda"),
    # raising when no GPU is present.  Pass "cpu" for the plain paths.
    device: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        if (
            self.osave_max_buffer_windows is not None
            and self.osave_max_buffer_windows < 1
        ):
            raise ValueError(
                "osave_max_buffer_windows must be >= 1 or None, got "
                f"{self.osave_max_buffer_windows}"
            )
        if self.grating_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "grating_dtype must be 'float32' or 'bfloat16', got "
                f"{self.grating_dtype!r}"
            )
        if self.mode is not None:
            # validate first (raises on unknown strings), then warn
            preset = fidelity_mod.from_mode(
                self.mode, compensate_pulse=self.compensate_pulse
            )
            warnings.warn(
                "STHCConfig(mode=...) is deprecated; pass "
                "fidelity=fidelity.ideal() / fidelity.physical() (or an "
                "arbitrary stage pipeline) instead",
                DeprecationWarning,
                stacklevel=3,
            )
            if (
                self.fidelity is not None
                and self.fidelity.fingerprint() != preset.fingerprint()
            ):
                raise ValueError(
                    "pass either the deprecated mode or an explicit "
                    "fidelity pipeline, not two that disagree "
                    f"(mode={self.mode!r} vs {self.fidelity.describe()!r})"
                )
            object.__setattr__(self, "fidelity", preset)
        else:
            if not self.compensate_pulse:
                # loud, not silent: the legacy knob only acts through the
                # deprecated mode alias — whether a pipeline was given
                # explicitly or defaulted, the stage parameter governs
                raise ValueError(
                    "compensate_pulse only applies to the deprecated mode "
                    "alias; pass a fidelity pipeline with "
                    "PulseCompensate(compensate=False) instead"
                )
            if self.fidelity is None:
                object.__setattr__(self, "fidelity", fidelity_mod.ideal())


class STHC:
    """Stateless correlator: ``record`` returns a Grating, ``correlate``
    consumes one."""

    def __init__(self, config: STHCConfig | None = None,
                 cache: GratingCache | None = None):
        self.config = config or STHCConfig()
        self.engine = QueryEngine(self.config)
        self._cache = cache if cache is not None else default_cache()

    # -- record -----------------------------------------------------------

    def record(
        self, kernels: Array, signal_shape: tuple[int, int, int]
    ) -> Grating:
        """Store a kernel stack (O, C, kh, kw, kt) for signals (H, W, T).

        Cached by kernel content + pipeline fingerprint when
        ``cache_gratings`` is set.
        """
        if self.config.cache_gratings:
            return self._cache.get_or_record(self.engine, kernels, signal_shape)
        return self.engine.record(kernels, signal_shape)

    # -- query ------------------------------------------------------------

    def correlate(self, grating: Grating, x: Array) -> Array:
        """Correlate clips x (B, C, H, W, T) against a recorded grating.

        Returns (B, O, H', W', T') signed feature maps (valid region).
        """
        if self.config.fused:
            return self.engine.query(grating, x)
        return self.engine.query_unfused(grating, x)

    def correlate_stream(self, kernels: Array, x: Array, block_t: int) -> Array:
        """Streaming (overlap-save) correlation over a long time axis.

        Records the grating once (cached) at the coherence-window FFT
        geometry — only the FFT numerics; the recorded physics (the
        pipeline's record-time stages) live on the kernel's own kt-point
        grid and are query-geometry-independent — then pushes ``x``
        (B, C, H, W, T) through the engine's overlap-save driver;
        ``osave_chunk_windows`` windows are correlated per step as one
        batch.  Query-time encoding uses a stream-global SLM
        scale (one modulator dynamic range for the whole stream), which
        makes the streaming output match the one-shot correlation
        (tested at the paper geometry).
        """
        H, W = x.shape[-3:-1]
        with tracing.span("sthc.record"):
            grating = self.record(kernels, (H, W, block_t))
        return self.engine.query_stream(grating, x)

    def __call__(self, kernels: Array, x: Array) -> Array:
        grating = self.record(kernels, x.shape[-3:])
        return self.correlate(grating, x)
