"""Parity of the torch port's leaf physics, spectral-correlation math,
overlap-save windowing and fidelity pipeline with the JAX reference.

Inputs come from a seeded numpy RandomState and go through both
packages; the port runs on the CPU.  Tolerances: relative L2 <= 1e-5
for float32 results (framework FFTs differ by ~2e-7 relative); exact
for quantization, integer plans and fingerprints.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests elsewhere must not starve
torch.set_num_threads(1)
# full float32 in any matmul / convolution a test reaches (cuDNN defaults to TF32)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

import jax.numpy as jnp  # noqa: E402

from repro.core import atomic as r_atomic  # noqa: E402
from repro.core import fidelity as r_fid  # noqa: E402
from repro.core import optics as r_optics  # noqa: E402
from repro.core import pseudo_negative as r_pn  # noqa: E402
from repro.core import spectral_conv as r_sc  # noqa: E402
from repro_torch.core import atomic as t_atomic  # noqa: E402
from repro_torch.core import fidelity as t_fid  # noqa: E402
from repro_torch.core import optics as t_optics  # noqa: E402
from repro_torch.core import pseudo_negative as t_pn  # noqa: E402
from repro_torch.core import spectral_conv as t_sc  # noqa: E402

RTOL = 1e-5


def rel_l2(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    cplx = np.iscomplexobj(got) or np.iscomplexobj(want)
    got = got.astype(np.complex128 if cplx else np.float64)
    want = want.astype(np.complex128 if cplx else np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- optics -------------------------------------------------------------------


@pytest.mark.parametrize("bits", [0, 1, 4, 8])
def test_quantize_unit_and_signed_bitwise(bits, rng):
    x = rng.uniform(-0.2, 1.2, size=(4, 257)).astype(np.float32)
    x[0, :5] = [0.5 / 255, 1.5 / 255, 2.5 / 255, 0.0, 1.0]  # half-way ties
    assert np.array_equal(
        t_optics.quantize_unit(T(x), bits).numpy(),
        np.asarray(r_optics.quantize_unit(jnp.asarray(x), bits)),
    )
    s = rng.uniform(-1.1, 1.1, size=(3, 129)).astype(np.float32)
    assert np.array_equal(
        t_optics.quantize_signed(T(s), bits).numpy(),
        np.asarray(r_optics.quantize_signed(jnp.asarray(s), bits)),
    )


def test_quantize_unit_straight_through_gradient(rng):
    x = T(rng.uniform(0.0, 1.0, size=(16,)).astype(np.float32)).requires_grad_()
    t_optics.quantize_unit(x, 4).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_slm_encode_matches(rng):
    frames = rng.randn(2, 1, 5, 6, 7).astype(np.float32)
    cfg_t, cfg_r = t_optics.SLMConfig(bits=6), r_optics.SLMConfig(bits=6)
    enc_t, sc_t = t_optics.slm_encode(T(frames), cfg_t)
    enc_r, sc_r = r_optics.slm_encode(jnp.asarray(frames), cfg_r)
    assert np.array_equal(enc_t.numpy(), np.asarray(enc_r))
    assert np.array_equal(sc_t.numpy(), np.asarray(sc_r))


def test_lens_aperture_and_pulse_spectra(rng):
    field = rng.randn(3, 8, 10).astype(np.float32)
    assert rel_l2(t_optics.lens_ft(T(field)).numpy(), r_optics.lens_ft(jnp.asarray(field))) < RTOL
    spec = (rng.randn(8, 10) + 1j * rng.randn(8, 10)).astype(np.complex64)
    assert rel_l2(t_optics.lens_ift(T(spec)).numpy(), r_optics.lens_ift(jnp.asarray(spec))) < RTOL
    for frac in (0.3, 0.7, 1.0):
        assert np.array_equal(
            t_optics.aperture_mask((9, 12), frac).numpy(),
            np.asarray(r_optics.aperture_mask((9, 12), frac)),
        )
    assert rel_l2(
        t_optics.recording_pulse_spectrum((12, 16), 2.0).numpy(),
        r_optics.recording_pulse_spectrum((12, 16), 2.0),
    ) < RTOL
    assert rel_l2(
        t_optics.temporal_pulse_spectrum(9, 0.4).numpy(),
        r_optics.temporal_pulse_spectrum(9, 0.4),
    ) < RTOL


# -- atomic medium ------------------------------------------------------------


@pytest.mark.parametrize("profile", ["gaussian", "lorentzian", "flat"])
def test_ihb_envelope_matches(profile):
    kw = dict(ihb_profile=profile, coverage=1.3)
    got = t_atomic.ihb_envelope(11, t_atomic.AtomicConfig(**kw)).numpy()
    want = r_atomic.ihb_envelope(11, r_atomic.AtomicConfig(**kw))
    assert rel_l2(got, want) < RTOL
    assert np.array_equal(
        t_atomic.photon_echo_transfer(11, t_atomic.AtomicConfig(**kw)).numpy(), got
    )


def test_t2_taps_and_echo_efficiency():
    kw = dict(t2_s=3e-9, frame_time_s=1e-9)
    got = t_atomic.t2_tap_weights(6, t_atomic.AtomicConfig(**kw), 2e-9).numpy()
    want = r_atomic.t2_tap_weights(6, r_atomic.AtomicConfig(**kw), 2e-9)
    assert rel_l2(got, want) < RTOL
    e_t = float(t_atomic.echo_efficiency(t_atomic.AtomicConfig(**kw), 1e-9))
    e_r = float(r_atomic.echo_efficiency(r_atomic.AtomicConfig(**kw), 1e-9))
    assert abs(e_t - e_r) <= 1e-6 * abs(e_r)
    assert t_atomic.AtomicConfig().window_frames == r_atomic.AtomicConfig().window_frames


def test_pseudo_negative_roundtrip(rng):
    k = rng.randn(3, 2, 4, 5).astype(np.float32)
    kp, km = t_pn.split(T(k))
    rp, rm = r_pn.split(jnp.asarray(k))
    assert np.array_equal(kp.numpy(), np.asarray(rp))
    assert np.array_equal(km.numpy(), np.asarray(rm))
    inter = t_pn.interleave_channels(kp, km)
    assert np.array_equal(inter.numpy(), np.asarray(r_pn.interleave_channels(rp, rm)))
    assert np.array_equal(t_pn.deinterleave_outputs(inter, axis=0).numpy(), k)
    assert np.array_equal(t_pn.combine(kp, km).numpy(), k)


# -- spectral correlation -----------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 17, 26, 97, 129, 1000])
def test_next_fast_len_and_shapes(n):
    assert t_sc.next_fast_len(n) == r_sc.next_fast_len(n)
    assert t_sc.fft_shape_for((n, 20, 9), (3, 4, 5)) == r_sc.fft_shape_for((n, 20, 9), (3, 4, 5))
    assert t_sc.valid_shape((n + 5, 20, 9), (3, 4, 5)) == r_sc.valid_shape((n + 5, 20, 9), (3, 4, 5))


@pytest.mark.parametrize("mode", ["valid", "same", "full"])
def test_correlate_fft_and_direct_match_reference(mode, rng):
    x = rng.randn(2, 2, 9, 10, 8).astype(np.float32)
    k = rng.randn(3, 2, 4, 3, 3).astype(np.float32)
    want = np.asarray(r_sc.direct_correlate3d(jnp.asarray(x), jnp.asarray(k), mode))
    direct = t_sc.direct_correlate3d(T(x), T(k), mode).numpy()
    spectral = t_sc.correlate3d_fft(T(x), T(k), mode).numpy()
    assert direct.shape == want.shape == spectral.shape
    assert rel_l2(direct, want) < RTOL
    assert rel_l2(spectral, want) < RTOL


def test_grating_and_query_match_reference(rng):
    x = rng.rand(2, 1, 12, 14, 10).astype(np.float32)
    k = rng.randn(3, 1, 5, 6, 4).astype(np.float32)
    fs = r_sc.fft_shape_for(x.shape[-3:], k.shape[-3:])
    out = r_sc.valid_shape(x.shape[-3:], k.shape[-3:])
    g_t = t_sc.make_grating(T(k), fs)
    g_r = r_sc.make_grating(jnp.asarray(k), fs)
    assert rel_l2(g_t.numpy(), g_r) < RTOL
    y_t = t_sc.query_grating(T(x), g_t, fs, out).numpy()
    y_r = r_sc.query_grating(jnp.asarray(x), g_r, fs, out)
    assert rel_l2(y_t, y_r) < RTOL


def test_full_precision_restores_tf32_flags():
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    with t_sc.full_precision():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == mm
    assert torch.backends.cudnn.allow_tf32 == cd


# -- overlap-save plans -------------------------------------------------------

PLANS = [
    (40, 4, 16, None), (40, 4, 16, 2), (40, 4, 16, 3), (1024, 8, 64, 4),
    (71, 8, 64, 4), (8, 8, 16, 1), (200, 5, 9, 7), (1017, 8, 64, 100),
]


@pytest.mark.parametrize("T_,kt,block_t,chunk", PLANS)
def test_stream_plan_and_cursor_fields_equal(T_, kt, block_t, chunk):
    p_t = t_sc.stream_plan(T_, kt, block_t, chunk)
    p_r = r_sc.stream_plan(T_, kt, block_t, chunk)
    assert dataclasses.astuple(p_t) == dataclasses.astuple(p_r)
    assert np.array_equal(t_sc.window_starts(p_t).numpy(), np.asarray(r_sc.window_starts(p_r)))
    for mbw in (None, 1, 2, 5):
        c_t = t_sc.StreamCursor(p_t, mbw or p_t.n_blocks)
        c_r = r_sc.StreamCursor(p_r, mbw or p_r.n_blocks)
        assert [dataclasses.astuple(s) for s in c_t] == [dataclasses.astuple(s) for s in c_r]
        assert c_t.peak_buffer_frames == c_r.peak_buffer_frames
        assert len(c_t) == len(c_r)


def test_stream_plan_rejects_like_reference():
    for args in [(10, 4, 3), (3, 4, 16)]:
        with pytest.raises(ValueError):
            r_sc.stream_plan(*args)
        with pytest.raises(ValueError):
            t_sc.stream_plan(*args)
    with pytest.raises(ValueError):
        t_sc.StreamCursor(t_sc.stream_plan(40, 4, 16), 0)


# -- stream_cursor (the reference's tests/test_spectral_conv.py:149–201) ------

CURSOR_CASES = [  # (t, kt, extra, mbw) over the reference strategy's ranges
    (8, 2, 1, 1), (90, 6, 9, 7), (37, 3, 4, 2), (64, 5, 1, 3), (13, 4, 9, 5),
    (71, 2, 6, 4), (50, 6, 2, 6), (29, 3, 7, 1), (88, 4, 3, 7), (45, 5, 5, 2),
    (9, 6, 8, 3), (60, 2, 2, 5), (33, 5, 9, 4), (77, 3, 1, 6), (20, 4, 6, 2),
    (90, 2, 9, 1),
]


@pytest.mark.parametrize("t,kt,extra,mbw", CURSOR_CASES)
def test_stream_cursor_partitions_windows(t, kt, extra, mbw):
    """Segments partition the plan's windows and valid outputs, overlap
    by exactly kt − 1 input frames, fit the constant-memory bound, and
    equal the reference's ``stream_cursor`` field by field."""
    if t < kt:
        t = kt + t
    block_t = kt - 1 + extra
    cursor = t_sc.stream_cursor(t, kt, block_t, max_buffer_windows=mbw)
    plan = cursor.plan
    segs = list(cursor)
    assert sum(s.n_windows for s in segs) == plan.n_blocks
    assert segs[0].t0 == 0 and segs[0].out_t0 == 0
    out_next = 0
    for i, s in enumerate(segs):
        assert s.n_windows <= mbw
        assert s.out_t0 == out_next
        out_next += s.n_valid
        assert s.frames == s.t1 - s.t0 <= cursor.peak_buffer_frames
        if i > 0:
            prev = segs[i - 1]
            assert s.t0 == prev.t0 + prev.n_windows * plan.step
            assert prev.t1 - s.t0 == kt - 1
    assert out_next == plan.n_valid
    assert segs[-1].t1 <= t
    assert cursor.peak_buffer_frames <= (min(mbw, plan.n_blocks) - 1) * plan.step + plan.block_t
    ref = r_sc.stream_cursor(t, kt, block_t, max_buffer_windows=mbw)
    assert [dataclasses.astuple(s) for s in segs] == [dataclasses.astuple(s) for s in ref]


def test_stream_cursor_single_segment_when_unbounded():
    cursor = t_sc.stream_cursor(40, 3, 10, max_buffer_windows=None)
    assert len(cursor) == 1
    (seg,) = cursor
    assert seg.t0 == 0 and seg.n_windows == cursor.plan.n_blocks
    assert seg.n_valid == cursor.plan.n_valid
    assert dataclasses.astuple(cursor.plan) == dataclasses.astuple(r_sc.stream_cursor(40, 3, 10).plan)


def test_stream_cursor_rejects_bad_budget():
    for budget in (0, -1):
        with pytest.raises(ValueError, match="max_buffer_windows"):
            t_sc.stream_cursor(40, 3, 10, max_buffer_windows=budget)
        with pytest.raises(ValueError, match="max_buffer_windows"):
            r_sc.stream_cursor(40, 3, 10, max_buffer_windows=budget)


def test_stream_cursor_segment_plans_are_consistent():
    """Each segment re-planned at its own frame count yields exactly its
    window and valid counts (the engine's segment loop relies on it)."""
    cursor = t_sc.stream_cursor(67, 4, 12, chunk_windows=2, max_buffer_windows=3)
    assert len(cursor) > 1
    for seg in cursor:
        sub = t_sc.stream_plan(seg.frames, 4, 12, 2)
        assert sub.n_blocks == seg.n_windows
        assert sub.n_valid == seg.n_valid


def test_stitch_windows_matches(rng):
    plan = t_sc.stream_plan(40, 4, 16, 2)
    blocks = rng.randn(plan.n_padded // plan.chunk, plan.chunk, 2, 3, 4, 5, plan.step)
    blocks = blocks.astype(np.float32)
    got = t_sc.stitch_windows(T(blocks), plan).numpy()
    want = np.asarray(r_sc.stitch_windows(jnp.asarray(blocks), r_sc.stream_plan(40, 4, 16, 2)))
    assert np.array_equal(got, want)


# -- fidelity pipeline --------------------------------------------------------


def _pipelines(mod):
    return [
        mod.ideal(),
        mod.physical(),
        mod.physical(slm_bits=4, compensate_pulse=False),
        mod.pipeline(mod.PulseCompensate(floor=0.01), mod.SLMQuantize(6)),
        mod.pipeline(mod.T2Apodize(), mod.PseudoNegative(), name="x"),
        mod.from_mode("physical"),
        mod.from_mode("ideal"),
        mod.physical().without(mod.SLMQuantize, mod.EchoGain),
    ] + [p for _, p in mod.ablation_stacks(slm_bits=5)]


@pytest.mark.parametrize("i", range(len(_pipelines(r_fid))))
def test_fidelity_fingerprints_equal(i):
    p_t, p_r = _pipelines(t_fid)[i], _pipelines(r_fid)[i]
    assert p_t.fingerprint() == p_r.fingerprint()
    assert p_t.describe() == p_r.describe()
    assert p_t.encodes_query == p_r.encodes_query
    assert p_t.resolved_bits(t_optics.SLMConfig()) == p_r.resolved_bits(r_optics.SLMConfig())


def test_fidelity_validation_matches():
    with pytest.raises(ValueError):
        t_fid.FidelityPipeline((t_fid.EchoGain(), t_fid.EchoGain()))
    with pytest.raises(TypeError):
        t_fid.FidelityPipeline(("not a stage",))
    with pytest.raises(ValueError):
        t_fid.from_mode("bogus")
    assert [n for n, _ in t_fid.ablation_stacks()] == [n for n, _ in r_fid.ablation_stacks()]
