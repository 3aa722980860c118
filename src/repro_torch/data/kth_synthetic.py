"""Synthetic KTH-style human-action video dataset (the port's own copy of
``repro.data.kth_synthetic``: numpy only, the same seeds, bitwise the
same arrays).

The real KTH dataset (Schuldt et al., 2004) is not redistributed with
this repository, so we generate a 4-class action dataset with **matched
geometry** (60×80 px, 16 uniformly-sampled frames, grayscale) and
class-separable *spatio-temporal* statistics — each class is a moving
pattern whose single-frame appearance overlaps with the others (so a 2-D
model can't trivially separate them) but whose motion differs:

  0 clapping — two blobs oscillating horizontally toward/away from the
               body midline (high lateral frequency, small amplitude)
  1 waving   — two blobs swinging vertically above the torso (vertical
               oscillation, larger amplitude, slower)
  2 boxing   — one blob thrusting forward periodically (asymmetric,
               horizontal, fast attack / slow retract)
  3 running  — whole body translating horizontally across the frame with
               limb oscillation (global motion — the class the paper's
               system separates best)

Subject-dependent style parameters (body position, scale, speed, phase,
noise) are derived from the subject id, and the splits are
subject-disjoint exactly like the paper's protocol: subjects 1–12 train
(192 clips), 13–16 val (64), 17–25 test (144) — 100 clips/class from 25
subjects × 4 scenarios.
"""

from __future__ import annotations

import dataclasses

import numpy as np

CLASSES = ("clapping", "waving", "boxing", "running")
N_SUBJECTS = 25
N_SCENARIOS = 4  # the four KTH recording conditions → style variation


@dataclasses.dataclass(frozen=True)
class VideoSpec:
    height: int = 60
    width: int = 80
    frames: int = 16


def _blob(h, w, cy, cx, ry, rx):
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    return np.exp(-(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2))


def render_clip(
    label: int, subject: int, scenario: int, spec: VideoSpec = VideoSpec()
) -> np.ndarray:
    """One (H, W, T) float32 clip in [0, 1]."""
    rng = np.random.RandomState(subject * 1009 + scenario * 101 + label)
    h, w, T = spec.height, spec.width, spec.frames
    # subject 'style'
    scale = 0.8 + 0.4 * rng.rand()
    speed = 0.7 + 0.6 * rng.rand()
    phase = 2 * np.pi * rng.rand()
    cx0 = w * (0.35 + 0.3 * rng.rand())
    cy0 = h * (0.45 + 0.15 * rng.rand())
    noise = 0.02 + 0.03 * rng.rand()
    bg = 0.1 + 0.08 * rng.rand()

    clip = np.zeros((h, w, T), np.float32)
    for t in range(T):
        tt = speed * t + phase
        frame = np.full((h, w), bg, np.float32)
        # torso (static per subject)
        frame += 0.5 * _blob(h, w, cy0, cx0, 9 * scale, 4 * scale)
        # head
        frame += 0.45 * _blob(h, w, cy0 - 12 * scale, cx0, 3.5 * scale, 3 * scale)
        if label == 0:  # clapping: hands oscillate toward midline
            dx = 6 * scale * np.abs(np.sin(1.8 * tt))
            for s in (-1, 1):
                frame += 0.6 * _blob(
                    h, w, cy0 - 2 * scale, cx0 + s * (4 + dx), 2.5, 2.5
                )
        elif label == 1:  # waving: hands swing vertically overhead
            dy = 7 * scale * np.sin(0.9 * tt)
            for s in (-1, 1):
                frame += 0.6 * _blob(
                    h, w, cy0 - 14 * scale - dy * s, cx0 + s * 9 * scale, 2.5, 2.5
                )
        elif label == 2:  # boxing: one fist thrusts forward (sawtooth)
            saw = (0.9 * tt / np.pi) % 1.0
            thrust = 12 * scale * (saw if saw < 0.3 else (1 - saw) * 0.43)
            frame += 0.65 * _blob(h, w, cy0 - 4 * scale, cx0 + 5 + thrust, 2.5, 3.0)
            frame += 0.5 * _blob(h, w, cy0 - 2 * scale, cx0 - 5 * scale, 2.5, 2.5)
        else:  # running: global translation + limb oscillation
            gx = (cx0 + (t - T / 2) * 2.2 * speed) % w
            leg = 5 * scale * np.sin(2.2 * tt)
            frame = np.full((h, w), bg, np.float32)
            frame += 0.5 * _blob(h, w, cy0, gx, 8 * scale, 3.5 * scale)
            frame += 0.45 * _blob(h, w, cy0 - 11 * scale, gx + 1, 3.2, 2.8)
            frame += 0.5 * _blob(h, w, cy0 + 9 * scale, gx + leg, 3, 2.2)
            frame += 0.5 * _blob(h, w, cy0 + 9 * scale, gx - leg, 3, 2.2)
        frame += noise * rng.randn(h, w).astype(np.float32)
        clip[:, :, t] = np.clip(frame, 0.0, 1.0)
    return clip


def make_split(
    split: str, spec: VideoSpec = VideoSpec()
) -> tuple[np.ndarray, np.ndarray]:
    """Subject-disjoint splits matching the paper's §4.1 protocol.

    Returns (videos (N, 1, H, W, T) float32, labels (N,) int32).
    """
    subjects = {
        "train": range(1, 13),  # 12 subjects → 192 clips
        "val": range(13, 17),  # 4 → 64
        "test": range(17, 26),  # 9 → 144
    }[split]
    vids, labels = [], []
    for subj in subjects:
        for scen in range(N_SCENARIOS):
            for label in range(len(CLASSES)):
                vids.append(render_clip(label, subj, scen, spec)[None])
                labels.append(label)
    x = np.stack(vids).astype(np.float32)  # (N, 1, H, W, T)
    y = np.asarray(labels, np.int32)
    rng = np.random.RandomState(0)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def batches(x, y, batch_size: int, rng: np.random.RandomState, epochs: int = 1):
    """Shuffled minibatch iterator (host-side)."""
    n = len(y)
    for _ in range(epochs):
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i : i + batch_size]
            yield {"video": x[idx], "label": y[idx]}
