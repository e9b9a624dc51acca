"""Closed-loop multi-turn session traffic, generated from a traffic file and
a seed.

A traffic file (``traffic/<name>.json``) gives the mix as data: how many
sessions stay open, the shared system prompt, the turns of a session, the
new prompt tokens of its first and later turns (sums of parts, each a
distribution), the reply lengths, and what the client does between turns
(a tool that runs for a drawn time, or a person who reads the reply and
types the next question).  Every session is a closed loop: its next turn
is due only after its reply is done and the think time has passed.

The sizes and think times are one fixed bank of session scripts, drawn once
from the file's ``bank_seed`` and dealt in the bank's order; a run's seed
draws every token id (and the weights).  So every seed offers the same
work, session for session, and two runs differ by the system alone.

The first ``in_flight`` sessions of the bank are mid-reply when the run
starts: their next turn was sent and ``done`` tokens of its reply are out,
so a mix that keeps a full batch of lanes starts with one.

The chat figures are frozen from ``repro_torch.traces.sharegpt``: prompt
lognormal(3.4, 0.9) clipped to 4-2048 tokens, reply lognormal(5.3, 0.7)
clipped to 8-2048, reading at 4.9 tokens/s, typing at 3.5 tokens/s, the
advisory when typing starts.  Nothing here imports the program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

def draw(spec: Dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` draws of one distribution of a traffic file: ``lognormal``
    (``mu``, ``sigma``: the log's mean and spread, so the median is
    exp(mu)), ``uniform_int`` (``lo`` to ``hi``, both included) or
    ``const`` (``value``); ``lo``/``hi`` clip a lognormal, ``scale``
    multiplies the result.  Token counts come back as int64, times (``unit``
    ``s``) as float64."""
    kind = spec["dist"]
    if kind == "lognormal":
        x = np.clip(rng.lognormal(spec["mu"], spec["sigma"], n),
                    spec["lo"], spec["hi"])
    elif kind == "uniform_int":
        x = rng.integers(spec["lo"], spec["hi"] + 1, n).astype(np.float64)
    elif kind == "const":
        x = np.full(n, float(spec["value"]))
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    x = x * spec.get("scale", 1)
    if spec.get("unit") == "s":
        return x
    return x.astype(np.int64)


@dataclass
class Turn:
    prompt: int          # new prompt tokens of the turn
    typed: int           # of which a person types (0 for a tool's output)
    reply: int           # tokens the reply generates
    think: float         # seconds from the previous reply's end to due
    lead: float          # seconds the advisory fires before the turn is due


@dataclass
class Script:
    turns: List[Turn]
    age: int             # turns already done when the run starts
    offset: float        # seconds into the run at which turn `age` is due
    done: int = -1       # reply tokens of turn `age` out at the start
                         # (-1: the turn is not in flight)


def _prompt(parts: List[Dict], rng: np.random.Generator):
    total = typed = 0
    for p in parts:
        n = int(draw(p, rng, 1)[0])
        total += n
        if p.get("typed"):
            typed += n
    return total, typed


def session_script(mix: Dict, rng: np.random.Generator) -> Script:
    """One session: its turns, its age and the offset of its next turn."""
    cap = mix.get("context_cap")
    n_turns = (int(draw(mix["turns"], rng, 1)[0]) if "turns" in mix
               else mix["max_turns"])
    turns: List[Turn] = []
    ctx = mix["system_prompt"]
    think_spec = mix["think"]
    for i in range(n_turns):
        prompt, typed = _prompt(mix["prompt_first" if i == 0
                                    else "prompt_later"], rng)
        reply = int(draw(mix["reply"], rng, 1)[0])
        if cap is not None and turns and ctx + prompt + reply > cap:
            break
        if i == 0:
            think = lead = 0.0
        elif "tool" in think_spec:
            think = lead = float(draw(think_spec["tool"], rng, 1)[0])
        else:
            lead = typed / think_spec["type_tok_s"]
            think = turns[-1].reply / think_spec["read_tok_s"] + lead
        turns.append(Turn(prompt, typed, reply, think, lead))
        ctx += prompt + reply
    age = int(rng.integers(0, len(turns)))
    nxt = turns[age]
    # a fresh session's first turn is due at once; an older session is
    # somewhere in the think time that precedes its next turn
    span = nxt.think if age else mix["fresh_spread_s"]
    return Script(turns, age, float(rng.uniform(0.0, span)))


def bank(mix: Dict) -> List[Script]:
    """The mix's fixed bank of session scripts (``bank_size`` of them),
    drawn from its ``bank_seed``: the same for every run."""
    rng = np.random.default_rng(mix["bank_seed"])
    scripts = [session_script(mix, rng) for _ in range(mix["bank_size"])]
    flight = np.random.default_rng([mix["bank_seed"], 1])
    for s in scripts[:mix.get("in_flight", 0)]:
        # at least one reply token is left for the run to generate after
        # the one that set-up's prefill of the history emits
        s.done = int(flight.integers(0, s.turns[s.age].reply - 1))
        s.offset = 0.0
    return scripts


class Deal:
    """The bank dealt out for one run, and its token ids from ``seed``.

    ``initial()`` are the sessions open when the run starts, each at its
    script's age; ``fresh()`` gives the next script for a session that
    takes a finished one's place, at age 0 (from the start of the bank
    again once it runs out)."""

    def __init__(self, mix: Dict, seed: int, vocab: int):
        self.mix = mix
        self.vocab = vocab
        self.seed = int(seed)
        self.scripts = bank(mix)
        self._next = mix["sessions"]
        self.system = self._ids(np.random.default_rng([self.seed, 0]),
                                mix["system_prompt"])

    def _ids(self, rng, n: int) -> List[int]:
        return rng.integers(0, self.vocab, n).tolist()

    def initial(self) -> List[Script]:
        return self.scripts[:self.mix["sessions"]]

    def fresh(self) -> Script:
        s = self.scripts[self._next % len(self.scripts)]
        self._next += 1
        return Script(s.turns, 0, 0.0)

    def token_rng(self, session_index: int) -> np.random.Generator:
        """The generator of one session's token ids: the same session
        index gives the same ids under the same seed, whatever the timing."""
        return np.random.default_rng([self.seed, 1, session_index])

    def turn_ids(self, rng, turn: Turn) -> List[int]:
        return self._ids(rng, turn.prompt)

    def reply_ids(self, rng, turn: Turn) -> List[int]:
        """A finished turn's reply as the history holds it at set-up (the
        replies of turns before the run are not generated again)."""
        return self._ids(rng, turn.reply)
