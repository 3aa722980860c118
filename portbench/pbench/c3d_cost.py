"""The C3D cell's fixed arithmetic: each 3x3x3 layer's operations and
bytes, the model's operations per clip, and the H100's dense TF32 rate.

Frozen here, from the configuration's numbers alone, so that a change to
the program cannot move the yardstick it is measured with; nothing here
imports the program.

* ``PEAK_TF32``: NVIDIA's data sheet, H100 SXM, dense TF32 on the
  tensor cores (494.7e12 FLOP/s), the most the card does on float32
  operands; a float32-correct product takes three TF32 passes (3xTF32),
  so a layer bound by operations reads at most a third of it;
* ``HBM_BW``: ``yardstick.HBM_BW`` (3.35e12 B/s).
"""

from __future__ import annotations

from pbench import yardstick

PEAK_TF32 = 494.7e12  # FLOP/s
HBM_BW = yardstick.HBM_BW


def convs(m: dict) -> list[tuple[str, int, int, int, int, int]]:
    """(name, input channels, filters, H, W, T) of each convolution, H, W,
    T its input's (and, with the one-voxel border, its output's) extent;
    the pools' windows are their strides and round up."""
    h, w, t, c = m["height"], m["width"], m["frames"], m["in_channels"]
    out = []
    for i, (widths, (ph, pw, pt)) in enumerate(zip(m["stages"], m["pools"])):
        for j, o in enumerate(widths):
            out.append((f"conv{i + 1}{'ab'[j]}", c, o, h, w, t))
            c = o
        h, w, t = -(-h // ph), -(-w // pw), -(-t // pt)
    return out


def features(m: dict) -> int:
    """Inputs of fc6: the last width over the last pool's output."""
    h, w, t = m["height"], m["width"], m["frames"]
    for ph, pw, pt in m["pools"]:
        h, w, t = -(-h // ph), -(-w // pw), -(-t // pt)
    return m["stages"][-1][-1] * h * w * t


def fcs(m: dict) -> list[tuple[int, int]]:
    """(inputs, outputs) of fc6, fc7, fc8."""
    dims = [features(m), *m["fc"], m["num_classes"]]
    return list(zip(dims[:-1], dims[1:]))


def conv_cost(B: int, C: int, O: int, H: int, W: int, T: int, k: int = 3) -> tuple[int, int]:
    """(FLOPs, bytes) of one layer over B clips: 2 per multiply-add; the
    input with its zero border, the weights and the output, float32, each
    moved once."""
    flops = 2 * B * O * C * k ** 3 * H * W * T
    nbytes = 4 * (B * C * (H + k - 1) * (W + k - 1) * (T + k - 1) + O * C * k ** 3 + B * O * H * W * T)
    return flops, nbytes


def call_bound_s(m: dict, clips: int) -> float:
    """The least time of one call's convolutions: each layer's operations
    at PEAK_TF32 or bytes at HBM_BW, the larger, summed."""
    total = 0.0
    for _, C, O, H, W, T in convs(m):
        flops, nbytes = conv_cost(clips, C, O, H, W, T, m["kernel"])
        total += max(flops / PEAK_TF32, nbytes / HBM_BW)
    return total


def model_flops_per_clip(m: dict) -> int:
    """The convolutions' and fc6–fc8's operations for one clip (77.1e9 at
    the published widths)."""
    conv = sum(conv_cost(1, C, O, H, W, T, m["kernel"])[0] for _, C, O, H, W, T in convs(m))
    return conv + sum(2 * a * b for a, b in fcs(m))
