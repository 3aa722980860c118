"""Training, accuracy and the fidelity ablation of the hybrid 3-D CNN
(paper §4.1, Fig. 6): the port of the reference's
``benchmarks/accuracy.py`` and ``benchmarks/ablation.py``.

The paper's exact geometry (60×80 px, 16 frames, 9 kernels of 30×40×8)
on synthetic KTH with subject-disjoint splits.  Training runs through
``impl="spectral"`` (the FFT twin of the digital conv) with AdamW, lr
3e-3, weight decay 0.01, 30 warmup steps into a cosine decay to 0.05,
batch 32, 45 epochs, as the reference does; ``impl="digital"`` trains
through kernel B4 (its backward recomputes through the plain version).
The train split is copied to the device once, and every batch is taken
there by the indices that ``kth.batches`` draws with ``RandomState(0)``.

:func:`evaluate` runs the conv layer in any backend; :func:`accuracy_rows`
and :func:`ablation_rows` give the rows of the reference's
``accuracy.run`` and ``ablation.run`` (the ablation sweeps every
cumulative stack of ``configs.sthc_kth.fidelity_stacks()`` on one
``GratingCache``).  The reference's evaluation is jitted and looks a
grating up once per stack; the port looks it up once per batch, so its
cache counts more hits.

    python -m repro_torch.launch.train_hybrid [--smoke] [--epochs N] [--device cpu|cuda]

prints the rows; it writes no file.
"""

from __future__ import annotations

import argparse
import time
from collections.abc import Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import sthc_kth
from repro_torch.core import hybrid, spectral_conv
from repro_torch.core.engine import GratingCache
from repro_torch.core.sthc import STHC, STHCConfig
from repro_torch.data import kth_synthetic as kth
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule

PAPER_ROWS = ("paper_reference_val_digital,0,0.6984", "paper_reference_test_hybrid,0,0.5972")


def reduced_config() -> hybrid.HybridConfig:
    """``accuracy.run(full_geometry=False)``'s size: 20×24×10 clips, 4
    kernels of 7×9×4, pool (4, 4, 2), hidden 32."""
    return hybrid.HybridConfig(
        height=20, width=24, frames=10, k_h=7, k_w=9, k_t=4,
        num_kernels=4, pool_window=(4, 4, 2), hidden=32,
    )


def _spec(cfg: hybrid.HybridConfig) -> kth.VideoSpec:
    return kth.VideoSpec(cfg.height, cfg.width, cfg.frames)


def train_steps(
    cfg: hybrid.HybridConfig,
    params: hybrid.HybridCNN,
    epochs: int = 45,
    lr: float = 3e-3,
    batch_size: int = 32,
    warmup_steps: int = 30,
    min_lr_frac: float = 0.05,
    impl: str = "spectral",
) -> Iterator[tuple[int, dict[str, torch.Tensor]]]:
    """Train ``params`` in place, yielding ``(step, aux)`` after each
    update is enqueued (``aux``: the batch's loss and accuracy, before
    the update, as device tensors; nothing here waits for the device).

    The learning-rate multiplier is evaluated at the step count before
    the update, so step 0 scales by 1 / ``warmup_steps``."""
    device = params.conv_w.device
    x_train, y_train = kth.make_split("train", _spec(cfg))
    n = len(y_train)
    # kth.batches over the clip indices: the reference's batch order,
    # with each batch gathered on the device instead of copied per step
    order = np.stack([
        b["video"] for b in kth.batches(np.arange(n), y_train, batch_size,
                                        np.random.RandomState(0), epochs=epochs)
    ])
    xs = torch.from_numpy(x_train).to(device)
    ys = torch.from_numpy(y_train).to(device=device, dtype=torch.long)
    idx = torch.from_numpy(order).to(device)
    named = dict(params.named_parameters())
    opt_cfg = AdamWConfig(lr=lr, weight_decay=0.01)
    opt = adamw_init(opt_cfg, named)
    # floor, as kth.batches drops the remainder batch
    total_steps = epochs * max(n // batch_size, 1)
    for i in range(len(order)):
        batch = {"video": xs[idx[i]], "label": ys[idx[i]]}
        loss, aux = hybrid.loss_fn(params, batch, cfg, impl=impl)
        grads = torch.autograd.grad(loss, list(named.values()))
        scale = cosine_schedule(opt["step"], total_steps, warmup_steps, min_lr_frac)
        adamw_update(opt_cfg, named, dict(zip(named, grads)), opt, lr_scale=scale)
        yield i, {k: v.detach() for k, v in aux.items()}


def train_hybrid(
    cfg: hybrid.HybridConfig,
    epochs: int = 45,
    lr: float = 3e-3,
    batch_size: int = 32,
    warmup_steps: int = 30,
    min_lr_frac: float = 0.05,
    params: hybrid.HybridCNN | None = None,
    impl: str = "spectral",
    log=lambda *_: None,
    device=None,
) -> hybrid.HybridCNN:
    """Train the hybrid CNN (AdamW + cross-entropy, §4.1); returns the
    trained parameters.  ``params=None`` starts from ``init_params``
    drawn from a generator seeded with 0 on ``device`` (None = the card);
    given ``params`` are trained in place on their own device."""
    if params is None:
        device = resolve_device(device)
        gen = torch.Generator(device).manual_seed(0)
        params = hybrid.init_params(cfg, gen, device=device)
    for i, aux in train_steps(cfg, params, epochs, lr, batch_size, warmup_steps,
                              min_lr_frac, impl):
        if i % 20 == 0:
            log(f"  step {i} loss {float(aux['loss']):.3f} "
                f"acc {float(aux['accuracy']):.3f}")
    return params


def evaluate(cfg: hybrid.HybridConfig, params: hybrid.HybridCNN, split: str, impl: str,
             batch: int = 16, sthc: STHC | None = None) -> tuple[float, np.ndarray]:
    """Accuracy and confusion matrix (rows: true class) of one conv
    backend on a split; ``sthc`` with ``impl="sthc"`` evaluates through
    any fidelity pipeline."""
    xs, ys = kth.make_split(split, _spec(cfg))
    preds = np.concatenate([
        hybrid.predict(params, xs[i : i + batch], cfg, impl=impl, sthc=sthc).cpu().numpy()
        for i in range(0, len(ys), batch)
    ])
    conf = np.zeros((cfg.num_classes, cfg.num_classes), np.int32)
    np.add.at(conf, (ys, preds), 1)
    return float(np.mean(preds == ys)), conf


def accuracy_rows(cfg: hybrid.HybridConfig, params: hybrid.HybridCNN, train_s: float,
                  log=print) -> list[str]:
    """The rows of the reference's ``accuracy.run`` for trained
    ``params`` (``train_s``: the training's wall seconds), and its
    confusion matrix of the physical backend, logged."""
    val_dig, _ = evaluate(cfg, params, "val", "spectral")
    test_phys, conf = evaluate(cfg, params, "test", "sthc_physical")
    test_dig, _ = evaluate(cfg, params, "test", "spectral")
    rows = [
        f"accuracy_val_digital,{train_s * 1e6:.0f},{val_dig:.4f}",
        f"accuracy_test_digital,0,{test_dig:.4f}",
        f"accuracy_test_hybrid_physical,0,{test_phys:.4f}",
        *PAPER_ROWS,
    ]
    log("confusion matrix (rows=true clap/wave/box/run):")
    for r in conf:
        log("  " + " ".join(f"{v:4d}" for v in r))
    return rows


@torch.no_grad()
def ablation_rows(cfg: hybrid.HybridConfig, params: hybrid.HybridCNN, log=print) -> list[str]:
    """The rows of the reference's ``ablation.run`` for trained
    ``params``: test accuracy through every stack of
    ``sthc_kth.fidelity_stacks()``, each stack's relative error against
    direct correlation on a seeded probe batch, and the shared cache's
    stats."""
    device = params.conv_w.device
    rng = np.random.RandomState(0)
    probe = torch.from_numpy(
        rng.rand(2, cfg.in_channels, cfg.height, cfg.width, cfg.frames).astype(np.float32)
    ).to(device)
    w = params.conv_w
    ref = spectral_conv.direct_correlate3d(probe, w, "valid")
    nref = float(torch.linalg.norm(ref))
    # one cache for every stack: the pipeline fingerprint keeps them apart
    cache = GratingCache(max_entries=32)
    val_digital, _ = evaluate(cfg, params, "val", "spectral")
    rows = [f"ablation_val_digital,0,acc={val_digital:.4f}"]
    for name, pipe in sthc_kth.fidelity_stacks():
        sthc = STHC(STHCConfig(fidelity=pipe, device=str(device)), cache=cache)
        rel = float(torch.linalg.norm(sthc(w, probe) - ref)) / nref
        t1 = time.time()
        acc, _ = evaluate(cfg, params, "test", "sthc", sthc=sthc)
        dt = time.time() - t1
        rows.append(f"ablation_{name},0,acc={acc:.4f};rel_err={rel:.4f};eval_s={dt:.1f}")
        log(f"  {name:22s} test acc {acc:.4f}  rel err {rel:.4f}")
    stats = cache.stats()
    rows.append(
        f"ablation_cache,0,entries={stats['entries']};"
        f"misses={stats['misses']};hits={stats['hits']}"
    )
    rows.extend(PAPER_ROWS)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced geometry and 2 epochs (accuracy.run's smoke size)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    epochs = args.epochs if args.epochs is not None else (2 if args.smoke else 45)
    cfg = reduced_config() if args.smoke else sthc_kth.config()
    t0 = time.time()
    params = train_hybrid(cfg, epochs=epochs, log=print, device=args.device)
    train_s = time.time() - t0
    rows = accuracy_rows(cfg, params, train_s) + ablation_rows(cfg, params)
    print("name,us_per_call,derived")
    for row in rows:
        print(row)


if __name__ == "__main__":
    main()
