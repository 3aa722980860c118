"""Composable fidelity pipeline — the STHC's physics, one stage at a time
(port of ``repro.core.fidelity``; fingerprints equal the reference's).

The paper's central empirical claim is a *degradation decomposition*:
69.84 % digital validation accuracy drops to 59.72 % hybrid test through
a stack of physical effects (SLM quantization, pseudo-negative ±
encoding, IHB bandwidth, T2 apodization, echo efficiency, the recording
pulse).  The seed code could only toggle all of them at once through
``STHCConfig.mode: str`` — one fidelity per engine, no way to ablate a
single effect or to serve tenants at different fidelities from one
process.

This module replaces the two-way mode string with a first-class
:class:`FidelityPipeline`: an ordered, immutable stack of typed physics
stages.  Each stage declares *where* it acts:

* **record time** — folded into the effective grating when the reference
  kernels are written into the medium (``Stage.site`` contains
  ``'record'``).  Record-time hooks:

  - :meth:`Stage.prepare_kernels` — time-domain kernel transform on the
    reference's own ``kt``-point grid (SLM quantization of the kernel
    display, T2 tap-weight apodization);
  - :meth:`Stage.shape_spectrum` — multiplicative temporal transfer
    function on the same grid (IHB coverage envelope, recording-pulse
    spectrum and its digital compensation);
  - :meth:`Stage.fold_gain` — scalar gains folded into the effective
    grating (photon-echo efficiency).

  :class:`PseudoNegative` is *structural* rather than pointwise: its
  presence makes the engine split signed kernels into non-negative ±
  channels, record both, and fold ``G⁺ − G⁻`` back into one effective
  grating.

* **query time** — the encode/decode epilogue every clip passes through
  (``Stage.encodes_query``).  :class:`SLMQuantize` is the only built-in
  query-side stage: clips are clamped non-negative, scaled per example
  (stream-global for streaming queries) and quantized at the SLM bit
  depth; the de-scaling is the one epilogue left on the hot path.

Stage order matters (quantize-then-apodize is the physical write order
used by :func:`physical`); pipelines are compared and cached by
:meth:`FidelityPipeline.fingerprint`, which is stable across processes
and deliberately excludes the display ``name`` — two pipelines with the
same stages and parameters are the same physics and share one grating
cache entry.

Presets: :func:`ideal` (empty stack — the exact FFT correlator),
:func:`physical` (the paper's full effect stack), :func:`pipeline` for
arbitrary named subsets, and :func:`ablation_stacks` — the cumulative
stage stacks the ablation benchmark sweeps to reproduce the paper's
digital→hybrid accuracy-drop decomposition.

Migration from the old API::

    STHCConfig(mode="ideal")     ->  STHCConfig(fidelity=fidelity.ideal())
    STHCConfig(mode="physical")  ->  STHCConfig(fidelity=fidelity.physical())
    STHCConfig(mode="physical", compensate_pulse=False)
        ->  STHCConfig(fidelity=fidelity.physical(compensate_pulse=False))

``mode`` survives as a thin deprecated alias (it maps to the matching
preset with a ``DeprecationWarning``); every pre-redesign call site keeps
working and produces bit-identical outputs (pinned tests).
"""

from __future__ import annotations

import dataclasses
import re
from typing import ClassVar

import torch

from repro_torch.core import atomic, optics

Array = torch.Tensor


@dataclasses.dataclass(frozen=True)
class StageContext:
    """Record-time environment the stage hooks see.

    Attributes:
      kt: temporal length of the reference kernels — every record-time
        transform lives on this grid (the medium is written before any
        query exists, so recorded physics cannot depend on a query FFT
        geometry).
      slm / atoms / storage_interval_s: the correlator's device
        parameters (from ``STHCConfig``).
      bits: resolved SLM bit depth (stage override or ``slm.bits``).
      signed: True when the kernels reaching ``prepare_kernels`` are
        still signed — i.e. the pipeline has no :class:`PseudoNegative`
        stage; quantizers must then preserve sign.
      kernel_scale: (O, 1, 1, 1, 1) per-output-channel normalization the
        quantizer works in; the engine folds it back into the effective
        grating after recording.
    """

    kt: int
    slm: optics.SLMConfig
    atoms: atomic.AtomicConfig
    storage_interval_s: float
    bits: int
    signed: bool
    kernel_scale: Array


@dataclasses.dataclass(frozen=True)
class Stage:
    """A physics effect in the fidelity pipeline.

    Subclasses override the hooks for the site(s) they act at; the
    default hooks are identity, so a stage only pays for what it models.
    ``site`` is documentation + introspection ('record', 'query', or
    'record+query'); the engine consumes the hooks, not the label.
    """

    site: ClassVar[str] = "record"
    encodes_query: ClassVar[bool] = False

    # -- record-time hooks (folded into the effective grating) ----------

    def prepare_kernels(self, kernels: Array, ctx: StageContext) -> Array:
        """Time-domain kernel transform, applied in stack order."""
        return kernels

    def shape_spectrum(self, h: Array | None, ctx: StageContext) -> Array | None:
        """Fold into the temporal transfer function on the kt-grid.

        ``h`` is None until the first contributing stage — an all-ones
        transfer is represented as "absent" so pipelines without
        spectral stages skip the band-limiting FFT round trip entirely
        (and stay bit-identical to the pre-pipeline ideal path).
        """
        return h

    def fold_gain(self, gain: Array | None, ctx: StageContext) -> Array | None:
        """Fold a scalar gain into the effective grating (None = unity)."""
        return gain


@dataclasses.dataclass(frozen=True)
class PseudoNegative(Stage):
    """± encoding of signed kernels for intensity-only optics (record).

    Structural stage: the engine splits ``K = K⁺ − K⁻`` (both
    non-negative), records each half through the remaining record-time
    stages, and folds ``G⁺ − G⁻`` into the effective grating.  Alone it
    is exactly lossless (correlation is linear); its accuracy cost in
    the paper's decomposition comes from the interaction with
    :class:`SLMQuantize` — each half is quantized separately.
    """

    site: ClassVar[str] = "record"


@dataclasses.dataclass(frozen=True)
class SLMQuantize(Stage):
    """Finite SLM bit depth, on both light fields (record + query).

    Record side: the displayed kernel is quantized in the shared
    per-output-channel scale ``ctx.kernel_scale`` — within each
    non-negative ± half when :class:`PseudoNegative` is present,
    sign-preserving otherwise (the bipolar-SLM idealization an ablation
    without ± encoding implies).  Query side: clips are clamped
    non-negative, scaled per example and quantized at the same depth
    (``encodes_query``), with only the de-scaling left as the query
    epilogue.

    ``bits=None`` defers to ``SLMConfig.bits`` so the device config
    stays the single source of truth unless a stage explicitly overrides
    it (e.g. a mixed-bit-depth ablation).
    """

    site: ClassVar[str] = "record+query"
    encodes_query: ClassVar[bool] = True

    bits: int | None = None

    def prepare_kernels(self, kernels: Array, ctx: StageContext) -> Array:
        unit = kernels / ctx.kernel_scale
        if ctx.signed:
            return optics.quantize_signed(unit, ctx.bits)
        return optics.quantize_unit(unit, ctx.bits)


@dataclasses.dataclass(frozen=True)
class IHBEnvelope(Stage):
    """Inhomogeneous-broadening spectral coverage of the atoms (record).

    Multiplies the temporal transfer function by the (unit-peak) IHB
    diffraction-efficiency envelope over the reference's own kt-point
    band — see :func:`repro.core.atomic.ihb_envelope`.  Profile and
    coverage come from ``STHCConfig.atoms``.
    """

    site: ClassVar[str] = "record"

    def shape_spectrum(self, h: Array | None, ctx: StageContext) -> Array:
        env = atomic.photon_echo_transfer(
            ctx.kt, ctx.atoms, ctx.kernel_scale.device
        )
        return env if h is None else h * env


@dataclasses.dataclass(frozen=True)
class T2Apodize(Stage):
    """T2 coherence decay across the stored reference frames (record).

    Time-domain tap weights on the kernel — frames written earlier have
    decayed more by readout (see
    :func:`repro.core.atomic.t2_tap_weights`; a multiplicative spectral
    window would be the wrong physics).
    """

    site: ClassVar[str] = "record"

    def prepare_kernels(self, kernels: Array, ctx: StageContext) -> Array:
        decay = atomic.t2_tap_weights(
            ctx.kt, ctx.atoms, ctx.storage_interval_s, ctx.kernel_scale.device
        )
        # explicit trailing-axis broadcast: (O, C, kh, kw, kt) * (kt,)
        return kernels * decay.reshape((1,) * (kernels.ndim - 1) + (-1,))


@dataclasses.dataclass(frozen=True)
class EchoGain(Stage):
    """Photon-echo efficiency for the storage interval (record).

    Scalar ``exp(-Δt/T2)`` amplitude factor, folded into the effective
    grating so queries never pay for it.
    """

    site: ClassVar[str] = "record"

    def fold_gain(self, gain: Array | None, ctx: StageContext) -> Array:
        g = atomic.echo_efficiency(
            ctx.atoms, ctx.storage_interval_s, ctx.kernel_scale.device
        )
        return g if gain is None else gain * g


@dataclasses.dataclass(frozen=True)
class PulseCompensate(Stage):
    """The recording pulse's temporal spectrum — and its deconvolution.

    The short recording pulse is the temporal reference of the write:
    its spectrum ``P(f_t)`` is burned into the grating (recorded ∝
    ``P*·K̂``).  This stage owns both halves of that physics: it always
    multiplies ``P`` into the transfer function, and with
    ``compensate=True`` (the paper's readout) divides the known,
    near-flat spectrum back out digitally — residual error is only the
    clamped region where ``P < floor``.  Dropping the stage from a
    pipeline models an idealized (spectrally flat) write pulse.
    """

    site: ClassVar[str] = "record"

    compensate: bool = True
    duration_frames: float = 0.25
    floor: float = 1e-3

    def shape_spectrum(self, h: Array | None, ctx: StageContext) -> Array:
        p = optics.temporal_pulse_spectrum(
            ctx.kt, self.duration_frames, ctx.kernel_scale.device
        )
        h = p if h is None else h * p
        if self.compensate:
            h = h / torch.clamp(p, min=self.floor)
        return h


# Canonical stage order — the physical write order used by the
# :func:`physical` preset and by :func:`pipeline`'s sorted construction,
# so every subset of the same stages fingerprints identically.
CANONICAL_ORDER: tuple[type[Stage], ...] = (
    PseudoNegative,
    SLMQuantize,
    IHBEnvelope,
    T2Apodize,
    EchoGain,
    PulseCompensate,
)


def _snake(cls: type) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", cls.__name__).lower()


@dataclasses.dataclass(frozen=True)
class FidelityPipeline:
    """Ordered, immutable stack of :class:`Stage` instances.

    The engine consumes the stack's record-time transforms when writing
    the grating and its query-time transforms as the encode/decode
    epilogue; :meth:`fingerprint` keys the grating cache (and the
    serving engine pool), so tenants at different fidelities share one
    cache without ever cross-hitting.

    ``name`` is display-only (metrics, benches) and excluded from the
    fingerprint: same stages ⇒ same physics ⇒ same cache entry.
    """

    stages: tuple[Stage, ...] = ()
    name: str = ""

    def __post_init__(self):
        stages = tuple(self.stages)
        seen: set[type] = set()
        for s in stages:
            if not isinstance(s, Stage):
                raise TypeError(
                    f"pipeline stages must be Stage instances, got {s!r}"
                )
            if type(s) in seen:
                raise ValueError(
                    f"duplicate stage type {type(s).__name__} in pipeline; "
                    "each physical effect appears at most once"
                )
            seen.add(type(s))
        object.__setattr__(self, "stages", stages)

    # -- introspection ---------------------------------------------------

    def __iter__(self):
        return iter(self.stages)

    def __len__(self) -> int:
        return len(self.stages)

    def get(self, stage_type: type[Stage]) -> Stage | None:
        for s in self.stages:
            if isinstance(s, stage_type):
                return s
        return None

    def has(self, stage_type: type[Stage]) -> bool:
        return self.get(stage_type) is not None

    @property
    def encodes_query(self) -> bool:
        """Whether queries pass through the SLM encode/decode epilogue."""
        return any(s.encodes_query for s in self.stages)

    def resolved_bits(self, slm: optics.SLMConfig) -> int:
        """SLM bit depth queries/kernels are quantized at (stage override
        wins, else the device config)."""
        q = self.get(SLMQuantize)
        if q is not None and q.bits is not None:
            return int(q.bits)
        return int(slm.bits)

    # -- identity --------------------------------------------------------

    def fingerprint(self) -> str:
        """Stable, process-independent identity of the physics.

        Stage class names + their parameters, in stack order; the
        display ``name`` is deliberately excluded.  This is what the
        grating cache keys on (alongside the device configs), so one
        shared cache serves tenants at different fidelities with no
        cross-fidelity hits.
        """
        parts = []
        for s in self.stages:
            fields = dataclasses.fields(s)
            if fields:
                kv = ",".join(
                    f"{f.name}={getattr(s, f.name)!r}" for f in fields
                )
                parts.append(f"{type(s).__name__}({kv})")
            else:
                parts.append(type(s).__name__)
        return "|".join(parts) if parts else "identity"

    def describe(self) -> str:
        """Short human-readable label for metrics and bench rows."""
        if self.name:
            return self.name
        if not self.stages:
            return "ideal"
        return "+".join(_snake(type(s)) for s in self.stages)

    # -- derivation ------------------------------------------------------

    def without(self, *stage_types: type[Stage]) -> "FidelityPipeline":
        """A copy with the given stage types removed (ablation helper)."""
        kept = tuple(
            s for s in self.stages if not isinstance(s, tuple(stage_types))
        )
        return FidelityPipeline(kept, name="")


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------


def ideal() -> FidelityPipeline:
    """The exact FFT correlator: no stages, no encode — the numerical
    'spec' of the machine (must match direct correlation to float
    tolerance; tested)."""
    return FidelityPipeline((), name="ideal")


def physical(
    *, slm_bits: int | None = None, compensate_pulse: bool = True
) -> FidelityPipeline:
    """The paper's full physical model — the effect stack behind the
    reported 69.84 % digital → 59.72 % hybrid accuracy drop."""
    return FidelityPipeline(
        (
            PseudoNegative(),
            SLMQuantize(slm_bits),
            IHBEnvelope(),
            T2Apodize(),
            EchoGain(),
            PulseCompensate(compensate=compensate_pulse),
        ),
        name="physical",
    )


def pipeline(*stages: Stage, name: str = "") -> FidelityPipeline:
    """Arbitrary named subset, sorted into the canonical write order so
    equal stage sets fingerprint identically regardless of the order the
    caller lists them in.  Stage types outside ``CANONICAL_ORDER``
    (future/pluggable stages) keep their given relative order, after the
    canonical ones."""

    def rank(s: Stage) -> int:
        for i, cls in enumerate(CANONICAL_ORDER):
            if isinstance(s, cls):
                return i
        return len(CANONICAL_ORDER)

    ordered = tuple(sorted(stages, key=rank))
    return FidelityPipeline(ordered, name=name)


def from_mode(mode: str, *, compensate_pulse: bool = True) -> FidelityPipeline:
    """Map the deprecated ``STHCConfig.mode`` string to its preset."""
    if mode == "ideal":
        return ideal()
    if mode == "physical":
        return physical(compensate_pulse=compensate_pulse)
    raise ValueError(
        f"STHC mode must be 'ideal' or 'physical', got {mode!r}"
    )


def ablation_stacks(
    *, slm_bits: int | None = None
) -> list[tuple[str, FidelityPipeline]]:
    """The cumulative stage stacks of the paper's degradation
    decomposition, from the exact digital correlator to the full
    physical model.

    Each entry adds one effect to the previous stack (stages sorted
    into canonical order, so the final stack fingerprints identically
    to :func:`physical` and shares its cache entry).  The addition
    order follows the paper's narrative: quantization first (the SLM
    is the front door), then the ± encoding it interacts with, then
    the atomic-medium effects.
    """
    additions: list[tuple[str, Stage]] = [
        ("slm_quantize", SLMQuantize(slm_bits)),
        ("pseudo_negative", PseudoNegative()),
        ("ihb_envelope", IHBEnvelope()),
        ("t2_apodize", T2Apodize()),
        ("echo_gain", EchoGain()),
        ("pulse_compensate", PulseCompensate()),
    ]
    stacks: list[tuple[str, FidelityPipeline]] = [("digital", ideal())]
    acc: list[Stage] = []
    for label, stage in additions:
        acc.append(stage)
        stacks.append((f"+{label}", pipeline(*acc, name=f"+{label}")))
    return stacks
