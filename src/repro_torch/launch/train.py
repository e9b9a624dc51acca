"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

As the JAX package's launcher, it trains the reduced config: its
``--smoke`` flag is on by default and cannot be turned off (a quirk of the
reference, mirrored).  ``--device`` picks the card (default ``cuda``) or
``cpu``; without a card the default raises.  Restarting the command after
a crash resumes from the latest complete checkpoint (see
training/checkpoint.py).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import TrainConfig, train

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = get_model(cfg, device=args.device)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                    global_batch=args.batch)
    return train(model, cfg, tc, dc)


if __name__ == "__main__":
    main()
