"""The STHC correlator and the hybrid 3-D CNN in plain PyTorch, float64.

What the correlator computes, written from the paper's model and not from
the program's engine:

* **record**: each tenant's kernels pass through the fidelity stages the
  configuration names.  ``slm_quantize`` shows each kernel on the SLM at
  ``bits`` in a per-output-channel scale (sign kept without
  ``pseudo_negative``; each non-negative half on its own with it),
  ``t2_apodize`` weighs the kt stored frames by their T2 decay,
  ``ihb_envelope`` and ``pulse_compensate`` multiply the kernel's
  temporal spectrum on its own kt-point grid (the IHB coverage; the
  recording pulse's spectrum, divided back out where it is above its
  floor), ``echo_gain`` scales by exp(-storage / T2), and
  ``pseudo_negative`` records the two halves and subtracts them.  The
  result is one effective kernel in float64.
* **query**: a stage set with ``slm_quantize`` shows each clip (each
  stream) clamped non-negative, in its own scale, at ``bits``; the output
  is scaled back.  The correlation ``y[t] = sum_m k[m] x[t + m]`` over the
  valid region is one float64 FFT of the whole clip or stream: an FFT as
  long as the signal wraps no valid output, so no windows and no padding
  rule of the program's are needed.

The two functions that round (the SLM quantizer) run in float32 exactly as
the SLM model states them, so a float32 value on a level boundary is
decided as the program decides it; everything after them is float64.

``dtype="bf16"`` runs the same steps in float32 with every stage's result
rounded to bfloat16: the lower-precision control the benchmark's limits
are set against.
"""

from __future__ import annotations

import math

import torch

PHYSICAL = ("pseudo_negative", "slm_quantize", "ihb_envelope", "t2_apodize", "echo_gain",
            "pulse_compensate")
PRESETS = {"ideal": (), "physical": PHYSICAL, "slm_quantize": ("slm_quantize",)}


def stages(fidelity: str) -> tuple[str, ...]:
    return PRESETS[fidelity]


def quantize_unit(x: torch.Tensor, bits: int) -> torch.Tensor:
    """The SLM's uniform quantizer on [0, 1], in x's precision, as
    ``clip + (round(clip * L) / L - clip)`` with L = 2**bits - 1."""
    levels = float(2**bits - 1)
    xc = torch.clamp(x, 0.0, 1.0)
    q = torch.round(xc * levels) / levels
    return xc + (q - xc)


def quantize_signed(x: torch.Tensor, bits: int) -> torch.Tensor:
    return torch.sign(x) * quantize_unit(torch.abs(x), bits)


def _fftfreq(n: int, device) -> torch.Tensor:
    return torch.fft.fftfreq(n, device=device, dtype=torch.float64)


def temporal_transfer(kt: int, st: tuple, physics: dict, device) -> torch.Tensor | None:
    """The recorded temporal transfer function on the kernel's kt grid."""
    h = None
    if "ihb_envelope" in st:
        f = _fftfreq(kt, device)
        if physics["ihb_profile"] != "gaussian":
            raise ValueError(f"profile {physics['ihb_profile']!r} is not modelled here")
        sigma = physics["ihb_coverage"] / (2.0 * math.sqrt(2.0 * math.log(2.0)))
        env = torch.exp(-0.5 * (f / sigma) ** 2)
        h = env / env.max()
    if "pulse_compensate" in st:
        f = _fftfreq(kt, device)
        sigma_f = 1.0 / (2.0 * math.pi * max(physics["pulse_duration_frames"], 1e-6))
        p = torch.exp(-0.5 * (f / sigma_f) ** 2)
        p = p / p.max()
        h = p if h is None else h * p
        if physics["pulse_compensate"]:
            h = h / torch.clamp(p, min=physics["pulse_floor"])
    return h


def effective_kernels(kernels: torch.Tensor, fidelity: str, physics: dict) -> torch.Tensor:
    """The float64 kernels (O, C, kh, kw, kt) a recording under
    ``fidelity`` correlates with."""
    st = stages(fidelity)
    k32 = kernels.to(torch.float32)
    dev = k32.device
    O, kt = k32.shape[0], k32.shape[-1]
    quant = "slm_quantize" in st
    pn = "pseudo_negative" in st
    if quant:
        scale = torch.amax(torch.abs(k32), dim=(1, 2, 3, 4), keepdim=True)
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    else:
        scale = torch.ones((O, 1, 1, 1, 1), dtype=torch.float32, device=dev)
    bits = int(physics["slm_bits"])
    tau = torch.arange(kt, device=dev, dtype=torch.float64)
    decay = torch.exp(-(physics["storage_interval_s"] + (kt - 1 - tau) * physics["frame_time_s"])
                      / physics["t2_s"])
    h = temporal_transfer(kt, st, physics, dev)

    def shown(k: torch.Tensor) -> torch.Tensor:
        if quant:
            unit = k / scale
            k = quantize_unit(unit, bits) if pn else quantize_signed(unit, bits)
        k = k.to(torch.float64)
        if "t2_apodize" in st:
            k = k * decay
        if h is not None:
            k = torch.real(torch.fft.ifft(torch.fft.fft(k, dim=-1) * h, dim=-1))
        return k

    if pn:
        eff = shown(torch.clamp(k32, min=0.0)) - shown(torch.clamp(-k32, min=0.0))
    else:
        eff = shown(k32)
    eff = eff * scale.to(torch.float64)
    if "echo_gain" in st:
        eff = eff * math.exp(-physics["storage_interval_s"] / physics["t2_s"])
    return eff


def encode(x: torch.Tensor, fidelity: str, physics: dict) -> tuple[torch.Tensor, torch.Tensor | None]:
    """A clip or stream (B, C, H, W, T) as the correlator sees it, and the
    per-row scale to multiply the output by (None: not encoded)."""
    if "slm_quantize" not in stages(fidelity):
        return x, None
    x = torch.clamp(x.to(torch.float32), min=0.0)
    scale = torch.amax(x, dim=(1, 2, 3, 4), keepdim=True)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return quantize_unit(x / scale, int(physics["slm_bits"])), scale


def _bf(t: torch.Tensor) -> torch.Tensor:
    if t.is_complex():
        return torch.complex(_bf(t.real), _bf(t.imag))
    return t.to(torch.bfloat16).to(torch.float32)


def correlate(x: torch.Tensor, k: torch.Tensor, dtype: str = "float64") -> torch.Tensor:
    """Valid multi-channel correlation of x (B, C, H, W, T) with k (O, C,
    kh, kw, kt): (B, O, H - kh + 1, W - kw + 1, T - kt + 1)."""
    H, W, T = x.shape[-3:]
    kh, kw, kt = k.shape[-3:]
    s, dims = (H, W, T), (-3, -2, -1)
    if dtype == "float64":
        xh = torch.fft.rfftn(x.to(torch.float64), s=s, dim=dims)
        kh_ = torch.fft.rfftn(k.to(torch.float64), s=s, dim=dims)
        yh = torch.einsum("bcxyz,ocxyz->boxyz", xh, torch.conj(kh_))
        y = torch.fft.irfftn(yh, s=s, dim=dims)
    elif dtype == "bf16":
        xh = _bf(torch.fft.rfftn(_bf(x.to(torch.float32)), s=s, dim=dims))
        kh_ = _bf(torch.fft.rfftn(_bf(k.to(torch.float32)), s=s, dim=dims))
        yh = _bf(torch.einsum("bcxyz,ocxyz->boxyz", xh, torch.conj(kh_)))
        y = _bf(torch.fft.irfftn(yh, s=s, dim=dims))
    else:
        raise ValueError(f"unknown dtype {dtype!r}")
    return y[..., : H - kh + 1, : W - kw + 1, : T - kt + 1]


def search_volume(x: torch.Tensor, k_eff: torch.Tensor, fidelity: str, physics: dict,
                  dtype: str = "float64") -> torch.Tensor:
    """The correlation volume (B, O, H', W', T') a search of stream x
    reads its detections from."""
    enc, scale = encode(x, fidelity, physics)
    y = correlate(enc, k_eff, dtype)
    if scale is not None:
        y = y * scale.to(y.dtype)
        if dtype == "bf16":
            y = _bf(y)
    return y


# ---------------------------------------------------------------------------
# the hybrid 3-D CNN's digital head (paper section 4)
# ---------------------------------------------------------------------------


def max_pool3d(y: torch.Tensor, window) -> torch.Tensor:
    ph, pw, pt = window
    B, O, H, W, T = y.shape
    nh, nw, nt = H // ph, W // pw, T // pt
    y = y[..., : nh * ph, : nw * pw, : nt * pt].reshape(B, O, nh, ph, nw, pw, nt, pt)
    return torch.amax(y, dim=(3, 5, 7))


def head(y: torch.Tensor, w: dict, pool, dtype: str = "float64") -> torch.Tensor:
    """ReLU, max-pool, flatten, FC, ReLU, FC on the biased conv output."""
    rnd = _bf if dtype == "bf16" else (lambda t: t)
    cast = (lambda t: t.to(torch.float64)) if dtype == "float64" else (lambda t: _bf(t.to(torch.float32)))
    y = rnd(max_pool3d(torch.relu(y), pool)).reshape(y.shape[0], -1)
    y = rnd(torch.relu(y @ cast(w["fc1_w"]) + cast(w["fc1_b"])))
    return rnd(y @ cast(w["fc2_w"]) + cast(w["fc2_b"]))


def hybrid_logits(x: torch.Tensor, w: dict, k_eff: torch.Tensor, fidelity: str, physics: dict,
                  pool, frames: int, stream: bool, dtype: str = "float64") -> torch.Tensor:
    """Logits of the hybrid classifier.

    ``stream=False``: x is a batch of clips (B, C, H, W, frames), each
    shown in its own scale; returns (B, classes).  ``stream=True``: x is
    (B, C, H, W, T) streams, each shown in one scale, and every segment of
    ``frames - kt + 1`` valid outputs is classified; returns (n_seg * B,
    classes), segment-major."""
    y = search_volume(x, k_eff, fidelity, physics, dtype)
    conv_b = w["conv_b"].to(y.dtype)
    y = y + (conv_b if dtype == "float64" else _bf(conv_b))[None, :, None, None, None]
    if not stream:
        return head(y, w, pool, dtype)
    ot = frames - k_eff.shape[-1] + 1
    n_seg = y.shape[-1] // ot
    segs = y[..., : n_seg * ot].reshape(y.shape[:-1] + (n_seg, ot))
    segs = torch.movedim(segs, -2, 0).reshape((n_seg * y.shape[0],) + tuple(y.shape[1:-1]) + (ot,))
    return head(segs, w, pool, dtype)
