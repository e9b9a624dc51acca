"""ShareGPT-calibrated multi-turn chat trace synthesis (paper SS4 "Trace
Generation").

The raw ShareGPT dump is unavailable offline, so we synthesize sessions
matching the paper's published moments:
  * 73.4% of conversations multi-turn, turn count heavy-tailed to 400
    (Fig. 4 CDF shape);
  * mean session length ~2.2K tokens;
  * arrival of turn t+1 = completion of turn t + reading time of the
    response + typing time of the next prompt (IReST reading speed,
    Pinet et al. typing speed);
  * the ADVISORY fires when the user starts typing, i.e. it leads the
    request by the typing duration (paper: 11.3 s mean lead on ShareGPT —
    our generator reproduces ~11-14 s with chat typing at ~70 wpm);
  * fixed number of concurrently active users: a finished session is
    replaced by a fresh one until the session budget is exhausted.

Events are produced lazily via the simulator's "chain" mechanism because a
turn's arrival depends on the previous turn's completion time.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.advisory import AdvisoryRequest, InferenceRequest

READ_TOK_PER_S = 4.9      # IReST ~228 wpm x 1.3 tok/word / 60
TYPE_TOK_PER_S = 3.5      # ~70 wpm chat typing (calibrates advisory lead ~11s)


class Trace:
    def events(self) -> Iterable[Tuple[float, str, object]]:
        raise NotImplementedError


@dataclass
class Turn:
    prompt: int
    response: int


def sample_session(rng: np.random.Generator, prefill_heavy: bool = False
                   ) -> List[Turn]:
    if prefill_heavy:                       # paper SS4.5 Fig 16 workload
        n = max(2, int(rng.lognormal(1.7, 0.9)))
        return [Turn(1024, 1) for _ in range(min(n, 50))]
    if rng.random() < 0.266:
        n = 1
    else:
        n = 2 + int(min(398, rng.lognormal(1.55, 1.25)))
    turns = []
    total = 0
    for _ in range(n):
        p = int(np.clip(rng.lognormal(3.4, 0.9), 4, 2048))
        r = int(np.clip(rng.lognormal(5.3, 0.7), 8, 2048))
        total += p + r
        if total > 24_576:      # serving context cap (sessions end at the
            break               # model's usable window, as in production)
        turns.append(Turn(p, r))
    return turns or [Turn(p, r)]


class ShareGPTTrace(Trace):
    def __init__(self, n_users: int = 64, n_sessions: int = 500,
                 seed: int = 0, advisory_miss_rate: float = 0.0,
                 prefill_heavy: bool = False, priority_frac: float = 0.0,
                 ramp_s: float = 30.0):
        self.n_users = n_users
        self.n_sessions = n_sessions
        self.rng = np.random.default_rng(seed)
        self.miss = advisory_miss_rate
        self.prefill_heavy = prefill_heavy
        self.priority_frac = priority_frac
        self.ramp = ramp_s
        self._sid = itertools.count()
        self._budget = n_sessions
        self.advisory_leads: List[float] = []

    def _new_session(self, t0: float):
        """Returns the initial events for a fresh session, or [] if budget
        is exhausted."""
        if self._budget <= 0:
            return []
        self._budget -= 1
        sid = f"s{next(self._sid)}"
        turns = sample_session(self.rng, self.prefill_heavy)
        prio = 1 if self.rng.random() < self.priority_frac else 0
        state = dict(i=0)

        def make_request(i: int, arrival: float) -> InferenceRequest:
            return InferenceRequest(
                session_id=sid, prompt_tokens=turns[i].prompt,
                max_new_tokens=turns[i].response, arrival=arrival,
                priority=prio)

        def cb(req: InferenceRequest, now: float):
            state["i"] += 1
            i = state["i"]
            ev = []
            if i < len(turns):
                read_t = req.generated / READ_TOK_PER_S
                type_t = turns[i].prompt / TYPE_TOK_PER_S
                t_adv = now + read_t
                t_req = now + read_t + type_t
                if self.rng.random() >= self.miss:
                    self.advisory_leads.append(t_req - t_adv)
                    ev.append((t_adv, "advisory", AdvisoryRequest(
                        session_id=sid, priority=prio or None)))
                ev.append((t_req, "request", make_request(i, t_req)))
                ev.append((now, "chain", (sid, cb)))
            else:
                ev.append((now, "end", sid))
                ev.extend(self._new_session(now + 1.0))
            return ev

        first = make_request(0, t0)
        return [(t0, "chain", (sid, cb)), (t0, "request", first)]

    def events(self):
        evs = []
        for _u in range(self.n_users):
            t0 = float(self.rng.uniform(0, self.ramp))
            evs.extend(self._new_session(t0))
        return evs

    # trace-level statistics (paper Fig. 4 / 6 analyses)

    @staticmethod
    def turn_statistics(n_sessions: int = 5000, seed: int = 0) -> dict:
        rng = np.random.default_rng(seed)
        sessions = [sample_session(rng) for _ in range(n_sessions)]
        turns = np.array([len(s) for s in sessions])
        toks = np.array([sum(t.prompt + t.response for t in s)
                         for s in sessions])
        # wasted prefill under recompute: turn t re-processes all prior turns
        wasted_by_turn = {}
        for k in (1, 2, 3, 4, 6, 8, 12, 16):
            tot = red = 0
            for s in sessions:
                hist = 0
                for i, t in enumerate(s[:k]):
                    if i > 0:
                        red += hist
                    tot += hist + t.prompt
                    hist += t.prompt + t.response
            wasted_by_turn[k] = red / max(tot, 1)
        all_tot = all_red = 0
        for s in sessions:
            hist = 0
            for i, t in enumerate(s):
                if i > 0:
                    all_red += hist
                all_tot += hist + t.prompt
                hist += t.prompt + t.response
        return dict(
            multi_turn_frac=float((turns > 1).mean()),
            mean_turns=float(turns.mean()),
            p99_turns=float(np.percentile(turns, 99)),
            max_turns=int(turns.max()),
            mean_session_tokens=float(toks.mean()),
            wasted_frac_by_turn=wasted_by_turn,
            overall_redundant_frac=all_red / all_tot,
        )
