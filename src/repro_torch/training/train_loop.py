"""Fault-tolerant training loop: the train step, async checkpoints and
restart from the latest, after the JAX package's ``training/train_loop.py``.
Used by launch/train.py."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import DataConfig, TokenPipeline
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            make_train_step)


@dataclass
class TrainConfig:
    steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    ckpt_dir: str = "checkpoints"
    n_microbatches: int = 1
    seed: int = 0


def train(model, cfg, tc: TrainConfig, data_cfg: Optional[DataConfig] = None,
          on_step: Optional[Callable] = None):
    """Returns (params, opt_state, losses).  Resumes from the latest complete
    checkpoint in tc.ckpt_dir if one exists (crash recovery); with
    ``checkpoint_every=0`` it never saves.  Runs on the model's device."""
    data_cfg = data_cfg or DataConfig(
        vocab=cfg.vocab, seq_len=128, global_batch=8, seed=tc.seed)
    pipe = TokenPipeline(data_cfg)
    ckpt = CheckpointManager(tc.ckpt_dir)

    params = model.init(torch.Generator(model.device).manual_seed(tc.seed))
    opt_state = adamw_init(params)
    start = 0
    latest = ckpt.latest_step()
    if latest is not None:
        state = ckpt.restore(latest, dict(params=params, opt=opt_state))
        params, opt_state = state["params"], state["opt"]
        start = latest
        print(f"[train] resumed from step {latest}")

    step_fn = make_train_step(model, AdamWConfig(lr=3e-3),
                              n_microbatches=tc.n_microbatches)
    losses = []
    t0 = time.time()
    for step in range(start, tc.steps):
        params, opt_state, loss = step_fn(params, opt_state, pipe.batch(step))
        losses.append(float(loss))
        if step % tc.log_every == 0:
            print(f"[train] step {step:5d} loss {float(loss):8.4f} "
                  f"({time.time()-t0:.1f}s)")
        if tc.checkpoint_every and (step + 1) % tc.checkpoint_every == 0:
            ckpt.save(step + 1, dict(params=params, opt=opt_state))
        if on_step:
            on_step(step, float(loss))
    ckpt.wait()
    return params, opt_state, losses
