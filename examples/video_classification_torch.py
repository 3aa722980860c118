"""End-to-end run on the PyTorch/CUDA port — the twin of
``examples/video_classification.py``: the paper's §4.1 experiment at the
full geometry.

Trains the single-conv-layer hybrid 3-D CNN (9 kernels, 30×40×8) on the
synthetic KTH action dataset for a few hundred steps, then evaluates the
subject-held-out splits with the conv layer served by the ideal STHC
(the FFT twin of the digital baseline) and by the physical STHC (SLM
quantization + pseudo-negative + atomic envelopes), the paper's hybrid
deployment.

On the card by default; ``--device cpu`` runs the plain torch versions
on the host (use ``--fast`` there: the reduced geometry):

    PYTHONPATH=src python examples/video_classification_torch.py [--fast] [--epochs N] [--device cpu]
"""

import argparse
import time

from repro_torch.configs import sthc_kth
from repro_torch.launch import train_hybrid


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    args = ap.parse_args()
    epochs = args.epochs or (8 if args.fast else 40)
    cfg = train_hybrid.reduced_config() if args.fast else sthc_kth.config()
    t0 = time.time()
    params = train_hybrid.train_hybrid(cfg, epochs=epochs, log=print, device=args.device)
    rows = train_hybrid.accuracy_rows(cfg, params, time.time() - t0)
    print(f"\n--- results ({time.time() - t0:.0f}s) ---")
    for r in rows:
        name, _, val = r.split(",")
        print(f"{name:40s} {val}")


if __name__ == "__main__":
    main()
