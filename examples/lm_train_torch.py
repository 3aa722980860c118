"""Train an LM of the model zoo (reduced config) with the PyTorch port's
stack: train step, AdamW + cosine schedule, gradient compression
(optional), atomic async checkpoints, kill-safe resume.  The twin of
``examples/lm_train.py``.

Run:  PYTHONPATH=src python examples/lm_train_torch.py --arch mamba2-370m \\
          --steps 60 --ckpt-dir /tmp/lm_ckpt --device cpu
Re-run the same command to watch it resume from the latest checkpoint.
Without ``--device`` it trains on the card.
"""

import argparse
import os
import tempfile

from repro_torch import configs
from repro_torch.launch.train import TrainConfig, train_loop
from repro_torch.optim import AdamWConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "lm_ckpt"))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    args = ap.parse_args()

    cfg = configs.get_smoke_config(args.arch)
    tc = TrainConfig(
        steps=args.steps, batch=args.batch, seq=args.seq,
        save_every=max(args.steps // 5, 1),
        compress_grads=args.compress_grads,
    )
    out = train_loop(cfg, tc, args.ckpt_dir, opt_cfg=AdamWConfig(lr=1e-3), device=args.device)
    print(f"[{args.arch}] done: loss {out['loss']:.4f} after "
          f"{out['steps_done']} steps (ckpts in {args.ckpt_dir})")


if __name__ == "__main__":
    main()
