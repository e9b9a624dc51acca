"""Real-mode cluster scenarios: multi-turn token-id traces (with leading
advisories and an optional data-dependent node failure) plus the dense
single-model reference that `ClusterRuntime(mode="real")` outputs must
match token-for-token.

The failure injection is deliberately *data-dependent*: the trace kills the
node that actually served a designated session's turn, so the scenario is
guaranteed to orphan a session with live KV — which forces the runtime
through the spool-recovery (or full-recompute) path, whatever the
scheduler's placement decisions were on this run.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.advisory import AdvisoryRequest, InferenceRequest
from repro_torch.traces.sharegpt import Trace


class MultiTurnRealTrace(Trace):
    """n_sessions interleaved chat sessions, n_turns each, real token ids.

    Every turn is preceded by an advisory that leads the request by
    ``lead`` virtual seconds, so the scheduler plans placement (and the
    node manager migrates/promotes KV) before the request lands — the
    paper's mechanism, exercised on real tensors.
    """

    def __init__(self, cfg, n_sessions: int = 4, n_turns: int = 3,
                 prompt_len: int = 10, gen: int = 8, seed: int = 1,
                 lead: float = 0.05,
                 fail_after_turn: Optional[int] = None,
                 fail_session: str = "s0", group: str = "default",
                 sid_prefix: str = "s"):
        rng = np.random.default_rng(seed)
        self.gen = gen
        self.lead = lead
        self.group = group
        self.prompts: Dict[str, List[List[int]]] = {
            f"{sid_prefix}{i}":
                [list(map(int, rng.integers(0, cfg.vocab, prompt_len)))
                 for _ in range(n_turns)]
            for i in range(n_sessions)}
        self.fail_after_turn = fail_after_turn
        self.fail_session = fail_session
        self._failed = False

    def _session_events(self, sid: str, turns: List[List[int]], t0: float):
        state = dict(i=0)

        def make_req(i: int, t: float) -> InferenceRequest:
            return InferenceRequest(
                session_id=sid, prompt_tokens=len(turns[i]),
                max_new_tokens=self.gen, prompt_ids=list(turns[i]),
                arrival=t, group=self.group)

        def cb(req: InferenceRequest, now: float):
            state["i"] += 1
            i = state["i"]
            ev = []
            if (self.fail_after_turn is not None and not self._failed
                    and sid == self.fail_session
                    and i == self.fail_after_turn):
                # kill the node that just served this session: its KV (and
                # possibly other sessions' in-flight work) dies with it
                self._failed = True
                ev.append((now + 1e-3, "fail", req.node_id))
            if i < len(turns):
                ev.append((now + 0.5 * self.lead, "advisory",
                           AdvisoryRequest(session_id=sid, group=self.group)))
                ev.append((now + self.lead, "request",
                           make_req(i, now + self.lead)))
                ev.append((now, "chain", (sid, cb)))
            return ev

        return [(t0, "advisory",
                 AdvisoryRequest(session_id=sid, group=self.group)),
                (t0 + self.lead, "chain", (sid, cb)),
                (t0 + self.lead, "request", make_req(0, t0 + self.lead))]

    def events(self):
        self._failed = False     # re-arm the failure for a fresh run()
        evs = []
        for k, (sid, turns) in enumerate(self.prompts.items()):
            evs.extend(self._session_events(sid, turns, 0.01 * k))
        return evs


class MixedTrace(Trace):
    """Interleave several traces into one event stream (the runtime's event
    heap time-orders them): the mixed-architecture cluster workload, where
    each sub-trace tags its sessions with its own node group."""

    def __init__(self, *traces: Trace):
        self.traces = traces

    def events(self):
        evs = []
        for t in self.traces:
            evs.extend(t.events())
        return evs


class SharedPrefixTrace(Trace):
    """n_sessions single-turn sessions whose prompts share a common prefix
    (the multi-tenant system-prompt / few-shot workload prefix sharing
    targets): session k's prompt is ``shared_len`` common tokens plus
    ``suffix_len`` private tokens.  The first session is the DONOR: the
    rest arrive (in one wave, ``stagger`` virtual seconds later) only once
    it completes — causally chained, so its pages are registered in the
    prefix index before any sharer routes.  Every later session then adopts
    the shared span copy-on-write instead of prefilling it, and the
    scheduler's prefix-aware `route` pulls the whole cohort onto the
    donor's node.  No advisories: placement is the prefix hint's to win.
    """

    def __init__(self, cfg, n_sessions: int = 4, shared_len: int = 16,
                 suffix_len: int = 4, gen: int = 4, seed: int = 7,
                 stagger: float = 0.5):
        rng = np.random.default_rng(seed)
        self.gen = gen
        self.stagger = stagger
        shared = list(map(int, rng.integers(0, cfg.vocab, shared_len)))
        self.prompts: Dict[str, List[List[int]]] = {}
        for i in range(n_sessions):
            suffix = list(map(int, rng.integers(0, cfg.vocab, suffix_len)))
            self.prompts[f"s{i:04d}"] = [shared + suffix]

    def _req(self, sid: str, t: float) -> InferenceRequest:
        p = self.prompts[sid][0]
        return InferenceRequest(session_id=sid, prompt_tokens=len(p),
                                max_new_tokens=self.gen, prompt_ids=list(p),
                                arrival=t)

    def events(self):
        sids = list(self.prompts)
        donor, rest = sids[0], sids[1:]

        def cb(_req: InferenceRequest, now: float):
            return [(now + self.stagger * (1 + 0.001 * k), "request",
                     self._req(sid, now + self.stagger))
                    for k, sid in enumerate(rest)]

        return [(0.0, "chain", (donor, cb)),
                (0.0, "request", self._req(donor, 0.0))]


def dense_reference(cfg, model, params, prompts: Dict[str, List[List[int]]],
                    gen: int) -> Dict[str, List[List[int]]]:
    """Greedy full-recompute reference: each session's turn stream served
    by the dense (unpaged, single-model) forward pass.  This is the oracle
    the cluster — with all its migration, preemption, failure, and
    recovery — must reproduce exactly.  Runs on the model's device; each
    token's argmax is taken there."""
    want: Dict[str, List[List[int]]] = {}
    for sid, turns in prompts.items():
        history: List[int] = []
        want[sid] = []
        for t in turns:
            history = history + list(t)
            tokens = torch.tensor([history], dtype=torch.int32,
                                  device=model.device)
            logits, cache = model.prefill(params, tokens)
            cache = model.grow_cache(cache, gen)
            outs = []
            for _ in range(gen):
                nxt = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
                outs.append(int(nxt[0]))
                logits, cache = model.decode_step(params, cache, nxt)
            want[sid].append(outs)
            history = history + outs
    return want


def session_outputs(result) -> Dict[str, List[List[int]]]:
    """Per-session turn outputs from a ClusterResult, in completion order."""
    outs: Dict[str, List[List[int]]] = {}
    for r in sorted(result.completed, key=lambda r: r.finished_at):
        outs.setdefault(r.session_id, []).append(list(r.output_ids or []))
    return outs
