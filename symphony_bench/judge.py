"""What decides ``correct``: a sample of the turns the window served, each
served token held against the float32 reference's logits.

The sample is drawn from the seed among the turns finished in the window.
It always holds the turn with the most served tokens and the turn with the
longest history, one turn of a session the node quantized and one of a
session it sent to the host (where the window finished such turns), and
then turns at random until it holds ``min_tokens`` served tokens.  For
each, the reference runs once over the session's whole history as served
(the mix's prompts and the program's own earlier replies) and reads, at
each served token, by how much its logit lies below the reference's best.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from symphony_bench import reference


def sample(loop, t0: float, t1: float, seed: int, min_tokens: int) -> List:
    done = [r for r in loop.turns if r.turn >= 0 and r.finished is not None
            and t0 <= r.finished <= t1]
    if not done:
        return []
    rng = np.random.default_rng([int(seed), 3])
    picked = {id(max(done, key=lambda r: len(r.outputs))),
              id(max(done, key=lambda r: r.start + r.n_prompt))}
    for tag in ("int8", "host"):
        tagged = [r for r in done if tag in r.sess.moved]
        if tagged:
            picked.add(id(tagged[int(rng.integers(len(tagged)))]))
    chosen = [r for r in done if id(r) in picked]
    rest = [r for r in done if id(r) not in picked]
    for i in rng.permutation(len(rest)):
        if sum(len(r.outputs) for r in chosen) >= min_tokens:
            break
        chosen.append(rest[i])
    return chosen


def judged_positions(turns) -> Dict:
    """Per session: (its history up to the last judged token, the
    positions whose logits predict each served token, those tokens)."""
    by: Dict[str, Tuple[object, List]] = {}
    for r in turns:
        by.setdefault(r.sess.sid, (r.sess, []))[1].append(r)
    out = {}
    for sid, (s, rs) in by.items():
        pos, tok, end = [], [], 0
        for r in rs:
            base = r.start + r.n_prompt - 1
            pos += [base + j for j in range(len(r.outputs))]
            tok += list(r.outputs)
            end = max(end, r.start + r.n_prompt + len(r.outputs) - 1)
        out[sid] = (s.tokens[:end], pos, tok)
    return out


def worst_gap(weights, cfg: Dict, turns, precision: str = "fp32",
              ref=reference) -> Tuple[Optional[float], int]:
    """(the widest gap over every judged token, how many were judged), by
    the plain reference ``ref`` (the model family's ``logits_at`` and
    ``gaps``).  With ``precision="fp8"`` (the control) the gap is read at
    the token the float8 reference puts first at each position instead."""
    worst, n = None, 0
    for hist, pos, tok in judged_positions(turns).values():
        if not pos:
            continue
        best = ref.logits_at(weights, cfg, hist, pos)
        if precision != "fp32":
            low = ref.logits_at(weights, cfg, hist, pos, precision)
            tok = low.argmax(dim=-1).tolist()
        g = float(ref.gaps(best, tok).max())
        worst = g if worst is None else max(worst, g)
        n += len(pos)
    return worst, n
