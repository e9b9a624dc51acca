"""Per-node continuous-batching engine: a Sarathi-style token-budget
iteration scheduler with SYMPHONY's cooperative memory management hooks.

Each call to `step()` is ONE fused mixed-batch dispatch: every running
decode lane rides along (one token each), and up to ``token_budget`` prompt
tokens are packed on top — long prompts are split into chunks across steps,
so a 4k-token arrival can no longer stall every decode lane on the node for
a whole monolithic prefill.  Time-between-tokens for running lanes is
therefore bounded by the budget, not by the longest queued prompt.

The engine is backend-agnostic by construction: all execution and capacity
accounting go through one `Backend` object (serving/backend.py).  With the
default `SimBackend` every step returns a duration from the CostModel's
mixed-step model; with a `RealBackend` the same control flow drives an
actual PyTorch model — one bucketed `step_paged` dispatch over stacked paged KV
pools — and step durations are measured wall time.  There is no sim/real
fork inside step(): one code path, two backends.

Key behaviours under test:
  * chunked continuation prefill — with KV reuse, prefill cost covers only
    the NEW tokens of the turn (paper's compute saving), consumed
    ``token_budget`` tokens per iteration; chunk boundaries are preemption
    points (a swapped-out mid-prompt request resumes from its last chunk,
    never recomputing consumed tokens);
  * bounded-lookahead admission — a queue head blocked by page-granular
    fragmentation no longer starves smaller admissible requests behind it:
    admission skips at most ``admit_lookahead`` blocked heads per step,
    preserving priority order among what it admits;
  * preemption — under HBM pressure the engine first purges *prefetched*
    blocks via the node manager (cooperative, free: persistent copy
    exists), then swaps the youngest running request to host
    (InferCept-style) or drops it for recompute (vLLM-style);
  * stall accounting — a request whose KV layers are not yet HBM-resident
    pays the residual layer-wise-fetch stall (zero when the advisory led
    the request by enough; in real mode, the measured swap-in copy time —
    including swap-ins that land mid-decode).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Tuple

from repro_torch.core.advisory import InferenceRequest
from repro_torch.core.node_manager import NodeManager
from repro_torch.serving.backend import Backend, LaneWork, SimBackend, StepResult
from repro_torch.serving.cost_model import CostModel
from repro_torch.serving.kv_cache import OutOfPages
from repro_torch.serving.transfer import OUT


@dataclass
class Running:
    req: InferenceRequest
    ctx_tokens: int                 # context length so far (incl. generated)
    remaining: int                  # tokens still to generate
    prompt_left: int = 0            # prompt tokens not yet prefilled
    consumed: int = 0               # prompt tokens already chunked in
    started: bool = False           # has taken >= 1 step since (re)admission


class NodeEngine:
    def __init__(self, node_id: int, cfg, cost: CostModel, mgr: NodeManager,
                 max_batch: int = 32, policy_reuses_kv: bool = True,
                 swap_on_preempt: bool = True,
                 backend: Optional[Backend] = None,
                 token_budget: int = 512, admit_lookahead: int = 4):
        self.node_id = node_id
        self.cfg = cfg
        self.cost = cost
        self.mgr = mgr
        self.backend: Backend = backend if backend is not None \
            else SimBackend(cost, mgr)
        self.max_batch = max_batch
        self.reuses_kv = policy_reuses_kv
        self.swap_on_preempt = swap_on_preempt
        self.token_budget = max(int(token_budget), 1)
        self.admit_lookahead = max(int(admit_lookahead), 0)
        self.waiting: Deque[InferenceRequest] = deque()
        self.running: List[Running] = []
        self.completed: List[InferenceRequest] = []
        self.stats = dict(prefill_tokens=0, redundant_tokens=0,
                          decode_steps=0, preemptions=0, stall_s=0.0,
                          busy_s=0.0, chunks=0, admission_skips=0,
                          shared_prefix_tokens=0)

    # -- queue interface ----------------------------------------------------------

    def submit(self, req: InferenceRequest) -> None:
        if req.priority > 0:
            self.waiting.appendleft(req)
        else:
            self.waiting.append(req)

    @property
    def load(self) -> int:
        return len(self.waiting) + len(self.running)

    def kv_in_use(self) -> float:
        return self.backend.kv_in_use(self.running)

    def _prompt_work(self, req: InferenceRequest) -> int:
        """Prompt tokens this request must push through prefill (a policy
        that does not reuse KV recomputes the cached context too)."""
        return req.prompt_tokens + (0 if self.reuses_kv
                                    else req.cached_tokens)

    # -- one engine iteration -------------------------------------------------------

    def step(self, now: float) -> float:
        """Run one token-budget iteration; returns its duration (sim or
        wall seconds)."""
        # reap finished async tier transfers (non-blocking): swap-outs and
        # prefetches launched in earlier iterations drained while compute
        # ran — their bookkeeping (page release, host installs, deferred
        # disk writes) lands here, off every lane's critical path
        self.backend.poll_transfers()
        budget = self.token_budget
        plan: List[Tuple[Running, LaneWork]] = []
        # 1) running lanes ride every step: decode lanes cost no budget,
        #    in-flight chunked prefills consume it in admission order
        for r in self.running:
            if r.prompt_left > 0:
                c = min(r.prompt_left, budget)
                if c == 0:
                    continue             # budget exhausted: chunk waits
                budget -= c
                plan.append((r, LaneWork(
                    req=r.req, new_tokens=c, start=r.consumed,
                    cached=r.ctx_tokens, final=(c == r.prompt_left),
                    first=not r.started)))
            else:
                plan.append((r, LaneWork(
                    req=r.req, new_tokens=0, cached=r.ctx_tokens,
                    final=True, first=not r.started,
                    is_decode=r.req.generated > 0)))

        # 2) admission: pack waiting prompts into the remaining budget, with
        #    bounded lookahead past heads blocked by memory/fragmentation
        budget = self._admit(plan, budget, now)

        if not plan:
            return 0.0

        # context-aware lane ordering: widest context first, so the
        # backend's skew split (at most two sub-dispatches on the bucket
        # lattice) cuts the sorted order at one point and the grouping is
        # deterministic across steps — per-lane results are keyed by lane,
        # never by position, so reordering is free
        plan.sort(key=lambda e: -(e[1].cached + e[1].new_tokens))

        # 3) ONE fused mixed dispatch (with pressure handling)
        res = self._step_with_pressure(plan, now)
        if res is None:
            return 0.0

        # 4) advance every lane by what the step did
        dt = res.duration
        self.stats["stall_s"] += res.stall
        any_decode = False
        for r, ln in plan:
            r.started = True
            if ln.new_tokens:
                self.stats["prefill_tokens"] += ln.new_tokens
                self.stats["chunks"] += 1
                r.prompt_left -= ln.new_tokens
                r.consumed += ln.new_tokens
                r.ctx_tokens += ln.new_tokens
            if ln.is_decode:
                any_decode = True
            if ln.final:
                r.ctx_tokens += 1
                if r.req.first_token_at is None:
                    r.req.first_token_at = now + dt
                r.req.generated += 1
                r.remaining -= 1
                if r.remaining <= 0:
                    r.req.finished_at = now + dt
                    self.running.remove(r)
                    self.completed.append(r.req)
                    self.backend.finish(r.req, now + dt)
        if any_decode:
            self.stats["decode_steps"] += 1
        self.stats["busy_s"] += dt
        return dt

    def _admit(self, plan: List[Tuple[Running, LaneWork]], budget: int,
               now: float) -> int:
        """Admit waiting requests into `plan` while budget + batch slots
        allow, skipping at most ``admit_lookahead`` blocked heads."""
        idx, skipped = 0, 0
        planned = 0.0       # bytes reserved by lanes admitted this step

        def _skip() -> bool:
            """Look past a blocked head; False once the K-skip bound is
            spent (admission stops, order preserved)."""
            nonlocal idx, skipped
            if skipped >= self.admit_lookahead:
                return False
            idx += 1
            skipped += 1
            self.stats["admission_skips"] += 1
            return True

        while (idx < len(self.waiting)
               and len(self.running) < self.max_batch):
            req = self.waiting[idx]
            # cross-session prefix sharing: a brand-new session whose prompt
            # extends an indexed prefix adopts the donor's resident pages
            # (copy-on-write) — the shared span becomes cached context and
            # leaves the prompt, so it is never prefillled.  Swap-resumed
            # or recompute re-admissions never adopt: their KV (or its
            # recompute obligation) already exists
            if (self.reuses_kv and req.cached_tokens == 0
                    and req.generated == 0 and req.prompt_ids):
                shared = self.backend.adopt_prefix(req)
                if shared:
                    req.cached_tokens = shared
                    req.prompt_ids = list(req.prompt_ids[shared:])
                    req.prompt_tokens = len(req.prompt_ids)
                    self.stats["shared_prefix_tokens"] += shared
            work = self._prompt_work(req)
            if budget <= 0 and work > 0:
                break                    # no token budget left this step
            cached = req.cached_tokens if self.reuses_kv else 0
            total_ctx = req.cached_tokens + req.prompt_tokens \
                + req.max_new_tokens
            need = max(0.0, self.backend.session_kv_bytes(total_ctx)
                       - self.backend.resident_kv_bytes(req.session_id))
            hbm = self.backend.hbm_kv_budget()
            if need > hbm:
                # can never fit, even on an empty node: fail loudly instead
                # of letting every driver's serve loop spin forever at dt=0
                raise OutOfPages(
                    f"{req.session_id}: request needs {need:.3g} KV bytes, "
                    f"node budget is {hbm:.3g}")
            protect = {r.req.session_id for r in self.running}
            protect.add(req.session_id)
            if self.kv_in_use() + planned + need > hbm:
                # cooperative: purge prefetched blocks (free — persistent
                # copy exists)
                self.mgr.on_memory_pressure(
                    self.kv_in_use() + planned + need - hbm, now, protect)
                if self.kv_in_use() + planned + need > hbm:
                    # leased pages of still-draining swap-outs are
                    # reclaimable capacity: fence them before giving up
                    self.backend.drain_transfers(OUT)
                if self.kv_in_use() + planned + need > hbm:
                    if _skip():          # blocked head: bounded lookahead
                        continue
                    break
            c = min(work, budget)
            # a swap-resumed mid-decode request's first step back emits its
            # next decode token — classify it as the decode lane it is
            cand = LaneWork(req=req, new_tokens=c, start=0, cached=cached,
                            final=(c == work), first=True,
                            is_decode=(work == 0 and req.generated > 0))
            others = [ln for _, ln in plan]
            if not self.backend.plan_fits(others + [cand]):
                # page-granular fragmentation: purge prefetched blocks
                # (evicting layers frees real pages), then give up on THIS
                # head only — don't starve admissible requests behind it
                self.mgr.on_memory_pressure(need, now, protect)
                if not self.backend.plan_fits(others + [cand]):
                    if _skip():
                        continue
                    break
            del self.waiting[idx]
            if not self.reuses_kv and req.cached_tokens > 0:
                self.stats["redundant_tokens"] += req.cached_tokens
            budget -= c
            planned += need
            run = Running(req, ctx_tokens=cached,
                          remaining=req.max_new_tokens, prompt_left=work)
            self.running.append(run)
            plan.append((run, cand))
        return budget

    def _step_with_pressure(self, plan: List[Tuple[Running, LaneWork]],
                            now: float) -> Optional[StepResult]:
        """One backend step; on page exhaustion (real mode), first ask the
        node manager for a cooperative purge, then swap out victims (whose
        lanes leave the plan) until the step fits."""
        purged = False
        while plan:
            try:
                return self.backend.step([ln for _, ln in plan], now)
            except OutOfPages:
                if not purged:
                    purged = True
                    protect = {r.req.session_id for r, _ in plan}
                    self.mgr.on_memory_pressure(
                        sum(self.backend.session_kv_bytes(
                            ln.new_tokens + 1) for _, ln in plan),
                        now, protect)
                    continue
                victim = self.preempt_one(now)
                if victim is None:
                    raise
                plan[:] = [(r, ln) for r, ln in plan
                           if r.req.session_id != victim.session_id]
        return None

    # -- preemption (memory pressure mid-step) ----------------------------------------

    def preempt_one(self, now: float) -> Optional[InferenceRequest]:
        if not self.running:
            return None
        victim = min(self.running, key=lambda r: (r.req.priority,
                                                  -r.req.arrival))
        self.running.remove(victim)
        self.stats["preemptions"] += 1
        req = victim.req
        if self.swap_on_preempt:
            # swap out: consumed KV kept; an in-flight prompt resumes from
            # its chunk boundary (only the unconsumed tail stays prompt).
            # The backend launches the copy asynchronously — fencing any
            # transfer the victim already has in flight (a lane preempted
            # mid-prefetch, or re-preempted while an earlier swap-out
            # drains) — and leases the pages until it lands, so the next
            # dispatch launches while the victim's KV is still draining
            req.cached_tokens = victim.ctx_tokens
            if victim.prompt_left > 0 and req.prompt_ids is not None:
                req.prompt_ids = list(req.prompt_ids[victim.consumed:])
            else:
                req.prompt_ids = None   # consumed into the swapped KV
            req.prompt_tokens = victim.prompt_left
            self.backend.swap_out(req.session_id, victim.ctx_tokens)
        else:
            req.cached_tokens = 0       # drop: full recompute
            # real mode: the engine does not hold the session's full token
            # history, so recompute needs the driver to resubmit it; stale
            # prompt_ids would silently serve a truncated context instead
            req.prompt_ids = None
            req.prompt_tokens = victim.ctx_tokens + victim.prompt_left
            self.backend.drop(req.session_id)
        req.max_new_tokens = victim.remaining
        self.waiting.appendleft(req)
        return req
