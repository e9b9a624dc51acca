"""Backend-agnostic cluster runtime: SYMPHONY scheduler + node managers +
continuous-batching engines over ONE event loop and either backend.

* ``mode="sim"`` — every node runs a `SimBackend`: CostModel virtual
  seconds, no tensors.  This is the discrete-event simulator that drives
  the paper's experiments at 8-replica (and larger) scale: normalized
  latency / TTFT / TPOT vs concurrent users, load imbalance, prefill-heavy
  ablation, missing advisories, prioritization.
* ``mode="real"`` — every node runs a `RealBackend` (dense family) or a
  `StateBackend` (mamba2, hybrid) on ``device``, all of them on the one
  card by default: per-node paged KV pools or state slots, a host staging
  tier, and a per-node disk spool.  The nodes of a group share one
  ``params`` dict.  Step durations are measured wall seconds (they set
  ``node_busy_until``); a CUDA step's wall time covers its device work
  because the backend reads the step's tokens back to the host inside its
  timed region.  Advisories trigger real cross-node
  `export_session`/`import_session` copies, and a node failure physically
  loses the fast tiers — recovery reads the crashed node's spool.  This is
  the 2–4 node correctness/soak mode: the same control flow as
  simulation, executed on real tensors.

The failure story is shared by both modes: when a session's KV has no live
home, the next advisory/request either recovers it from the crashed node's
disk spool (paying disk-read cost) or falls back to full-history recompute
— never to the pre-fix behaviour of serving continuation prefill against
KV that no longer exists.
"""
from __future__ import annotations

import heapq
import itertools
import shutil
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.advisory import AdvisoryRequest, InferenceRequest
from repro_torch.core.node_manager import NodeManager
from repro_torch.core.policies import POLICIES, Policy
from repro_torch.core.scheduler import SymphonyScheduler
from repro_torch.serving.cost_model import CostModel, HardwareSpec
from repro_torch.traces.sharegpt import Trace


@dataclass
class ClusterResult:
    completed: List[InferenceRequest]
    node_load_samples: List[List[int]]      # periodic per-node outstanding
    stats: dict

    def mean(self, attr: str) -> float:
        vals = [getattr(r, attr) for r in self.completed
                if getattr(r, attr) is not None]
        return sum(vals) / max(len(vals), 1)

    def p99(self, attr: str) -> float:
        vals = sorted(v for v in (getattr(r, attr) for r in self.completed)
                      if v is not None)
        if not vals:
            return 0.0
        return vals[min(len(vals) - 1, int(0.99 * len(vals)))]

    @property
    def throughput(self) -> float:
        if not self.completed:
            return 0.0
        t_end = max(r.finished_at for r in self.completed)
        return len(self.completed) / max(t_end, 1e-9)

    def load_imbalance(self) -> dict:
        """Paper Fig. 1/14 metric: requests per server, max vs median vs min,
        time-averaged over samples where the cluster is loaded."""
        import numpy as np
        if not self.node_load_samples:
            return dict(max=0, median=0, min=0, ratio=1.0)
        arr = np.array(self.node_load_samples)          # (samples, nodes)
        active = arr[arr.max(axis=1) >= 1]
        if len(active) == 0:
            return dict(max=0, median=0, min=0, ratio=1.0)
        per_node = active.mean(axis=0)
        med = float(np.median(per_node))
        return dict(max=float(per_node.max()), median=med,
                    min=float(per_node.min()),
                    ratio=float(per_node.max() / max(med, 1e-9)))

    def metrics(self) -> dict:
        """Cluster-level metrics surface, shared by sim and real modes:
        latency/throughput/imbalance headlines plus per-node migration,
        stall, recovery, and disk-traffic detail."""
        eng = self.stats.get("engine", {})
        mgr = self.stats.get("manager", {})
        be = self.stats.get("backend", {})
        per_node = {}
        for i in sorted(eng):
            m = mgr.get(i, {})
            row = dict(
                busy_s=eng[i].get("busy_s", 0.0),
                stall_s=eng[i].get("stall_s", 0.0),
                prefill_tokens=eng[i].get("prefill_tokens", 0),
                redundant_tokens=eng[i].get("redundant_tokens", 0),
                decode_steps=eng[i].get("decode_steps", 0),
                preemptions=eng[i].get("preemptions", 0),
                migrations=m.get("migrations", 0),
                migrated_bytes=m.get("migrated_bytes", 0.0),
                recoveries=m.get("recoveries", 0),
                evictions=m.get("evictions", 0),
                disk_writes=m.get("disk_writes", 0),
            )
            if i in be:
                row["copied_bytes"] = be[i].get("copied_bytes", 0.0)
                row["migrations_in"] = be[i].get("migrations_in", 0)
            per_node[i] = row
        return dict(
            mode=self.stats.get("mode", "sim"),
            completed=len(self.completed),
            throughput_rps=self.throughput,
            ttft_mean_s=self.mean("ttft"),
            ttft_p99_s=self.p99("ttft"),
            tpot_mean_s=self.mean("tpot"),
            norm_latency_mean_s=self.mean("normalized_latency"),
            imbalance=self.load_imbalance(),
            per_node=per_node,
        )


class ClusterRuntime:
    """One event loop, two backends — see module docstring."""

    def __init__(self, cfg: ModelConfig, n_nodes: int = 8,
                 policy: str = "symphony", hw: HardwareSpec = HardwareSpec(),
                 max_batch: int = 32, nodes_per_pod: int = 16,
                 advisory_to_hbm: bool = True, mode: str = "sim",
                 model=None, params=None, n_pages: int = 64,
                 page_size: int = 8, kernel_mode: str = "auto",
                 spool_root: Optional[str] = None,
                 trace_logits: bool = True, token_budget: int = 512,
                 admit_lookahead: int = 4,
                 node_groups: Optional[Dict[str, dict]] = None,
                 device="cuda"):
        if mode not in ("sim", "real"):
            raise ValueError(f"unknown mode {mode!r} (sim|real)")
        self.cfg = cfg
        self.mode = mode
        self.policy: Policy = POLICIES[policy]
        # ---- node groups: one architecture (cfg/cost/model) per group ----
        # The homogeneous call is the single-group special case; a mixed
        # cluster passes node_groups={"default": {...}, "mamba2": {...}} and
        # requests carry .group so routing never crosses architectures.
        if node_groups is None:
            node_groups = {"default": dict(cfg=cfg, n_nodes=n_nodes,
                                           model=model, params=params)}
        self.cfgs: Dict[int, ModelConfig] = {}
        self.costs: Dict[int, CostModel] = {}
        self.node_group: Dict[int, str] = {}
        group_mp: Dict[str, tuple] = {}
        nid = 0
        for gname, spec in node_groups.items():
            gcfg = spec["cfg"]
            gcost = CostModel(gcfg, spec.get("hw", hw))
            group_mp[gname] = (spec.get("model"), spec.get("params"))
            for _ in range(spec.get("n_nodes", 1)):
                self.cfgs[nid] = gcfg
                self.costs[nid] = gcost
                self.node_group[nid] = gname
                nid += 1
        n_nodes = nid
        self.cost = self.costs[0]      # homogeneous-call compatibility
        self.sched = SymphonyScheduler(n_nodes, self.policy,
                                       node_groups=self.node_group)
        pod_of = lambda n: n // nodes_per_pod
        self.managers: Dict[int, NodeManager] = {
            i: NodeManager(i, self.cfgs[i], self.costs[i], pod_of=pod_of)
            for i in range(n_nodes)}
        for i, m in self.managers.items():
            m.register_peers(self.managers)
            self.sched.register_node_manager(i, m)

        self.backends: Dict[int, object] = {}
        self.spool_root: Optional[Path] = None
        self._own_spool = False
        if mode == "real":
            from repro_torch.models.transformer import resolve_device
            from repro_torch.serving.backend import make_backend
            device = resolve_device(device)
            for gname, (gmodel, gparams) in group_mp.items():
                if gmodel is None or gparams is None:
                    raise ValueError(
                        f"mode='real' requires model= and params= "
                        f"(group {gname!r})")
                if gmodel.device != device:
                    raise ValueError(
                        f"group {gname!r}: the model lives on "
                        f"{gmodel.device}, the runtime on {device}")
            self.spool_root = Path(spool_root) if spool_root is not None \
                else Path(tempfile.mkdtemp(prefix="symphony_cluster_"))
            self._own_spool = spool_root is None
            for i in range(n_nodes):
                gmodel, gparams = group_mp[self.node_group[i]]
                if self.costs[i].n_params is None:
                    self.costs[i].set_param_count(gmodel.param_count())
                self.backends[i] = make_backend(
                    self.cfgs[i], gmodel, gparams, n_pages=n_pages,
                    page_size=page_size, kernel_mode=kernel_mode,
                    mgr=self.managers[i], trace_logits=trace_logits,
                    spool_dir=str(self.spool_root / f"node{i}"),
                    device=device)

        from repro_torch.serving.engine import NodeEngine
        self.engines: Dict[int, "NodeEngine"] = {}
        for i in range(n_nodes):
            # real mode always swaps on preemption: the drop-for-recompute
            # path would need the driver to resubmit the full token history
            # mid-step, which the engine cannot do (stateless still
            # recomputes every *turn* via policy_reuses_kv=False)
            self.engines[i] = NodeEngine(
                i, self.cfgs[i], self.costs[i], self.managers[i],
                max_batch=max_batch,
                policy_reuses_kv=self.policy.reuses_kv,
                swap_on_preempt=(self.policy.name != "stateless"
                                 or mode == "real"),
                backend=self.backends.get(i),
                token_budget=token_budget,
                admit_lookahead=admit_lookahead)
            if i not in self.backends:       # sim: engine built its own
                self.backends[i] = self.engines[i].backend
        self.advisory_to_hbm = advisory_to_hbm
        self._dead: set = set()
        # real-mode driver-side ledger: the dense-equivalent token stream of
        # each session, plus a pristine per-turn snapshot so a request
        # stranded on a failed node can be replayed from turn start
        self._history: Dict[str, list] = {}
        self._turn0: Dict[str, tuple] = {}

    def cleanup(self) -> None:
        """Remove a runtime-owned spool directory (real mode only)."""
        if self._own_spool and self.spool_root is not None:
            shutil.rmtree(self.spool_root, ignore_errors=True)
            self.spool_root = None

    # -- main loop --------------------------------------------------------------------

    def run(self, trace: Trace, sample_every: float = 5.0,
            fail_node_at: Optional[tuple] = None) -> ClusterResult:
        """trace: iterable of (time, kind, payload) events, time-sorted.

        In sim mode the clock is virtual seconds throughout; in real mode
        arrivals are virtual but every step's duration is measured wall
        time, so ``node_busy_until`` reflects what the hardware actually
        did."""
        eq: list = []
        seq = itertools.count()
        self._dead = set()
        self._history = {}
        self._turn0 = {}
        for t, kind, payload in trace.events():
            heapq.heappush(eq, (t, next(seq), kind, payload))
        if fail_node_at is not None:
            heapq.heappush(eq, (fail_node_at[1], next(seq), "fail",
                                fail_node_at[0]))
        busy_until = {i: 0.0 for i in self.engines}
        load_samples: List[List[int]] = []
        next_sample = 0.0
        completed: List[InferenceRequest] = []
        inflight_done = {}

        def push(t: float, kind: str, payload) -> None:
            heapq.heappush(eq, (t, next(seq), kind, payload))

        def schedule_node(i: int, now: float) -> None:
            eng = self.engines[i]
            if not (eng.waiting or eng.running):
                return
            push(max(now, busy_until[i]), "step", i)

        while eq:
            now, _, kind, payload = heapq.heappop(eq)
            # background drain: reap any tier transfer whose copy finished
            # (non-blocking; sim backends no-op) — launched spool writes and
            # swap-outs land as the event loop makes progress, not only
            # when their owning engine happens to step
            for b in self.backends.values():
                b.poll_transfers()
            while next_sample <= now:
                load_samples.append(
                    [self.engines[i].load for i in sorted(self.engines)])
                next_sample += sample_every

            if kind == "advisory":
                self._on_advisory(payload, now)

            elif kind == "request":
                req: InferenceRequest = payload
                req.arrival = now
                # pristine turn snapshot: a node failure mid-turn replays
                # the request from here (preemption mutates the live fields)
                self._turn0[req.session_id] = (
                    list(req.prompt_ids) if req.prompt_ids is not None
                    else None,
                    req.prompt_tokens, req.max_new_tokens)
                self._dispatch(req, now, schedule_node)

            elif kind == "step":
                i = payload
                if not self.sched.nodes[i].alive:
                    continue
                if now < busy_until[i] - 1e-12:
                    push(busy_until[i], "step", i)
                    continue
                eng = self.engines[i]
                n_done_before = len(eng.completed)
                dt = eng.step(now)
                busy_until[i] = now + dt
                self.sched.report_step_latency(i, dt)
                for req in eng.completed[n_done_before:]:
                    self._complete(req, i, now + dt)
                    completed.append(req)
                    cb = inflight_done.pop(req.session_id, None)
                    if cb:
                        for t, k, p in cb(req, now + dt):
                            push(t, k, p)
                schedule_node(i, now + dt)

            elif kind == "chain":
                # trace callback: schedule follow-up events once a given
                # session's current request completes
                sid, cb = payload
                inflight_done[sid] = cb

            elif kind == "fail":
                self._fail(payload, now, schedule_node)

            elif kind == "end":
                self.sched.end_session(payload)

        stats = dict(
            mode=self.mode,
            engine={i: dict(self.engines[i].stats) for i in self.engines},
            manager={i: dict(self.managers[i].stats) for i in self.managers},
        )
        if self.mode == "real":
            stats["backend"] = {i: dict(self.backends[i].stats)
                                for i in self.backends}
        return ClusterResult(completed, load_samples, stats)

    # -- event handlers ---------------------------------------------------------------

    def _kv_holder(self, sid: str) -> Optional[int]:
        """The live node whose store actually holds this session's KV.  The
        scheduler's ``kv_node`` is only updated at request completion and is
        stale across advisory migrations and node failures — placement
        actions must consult physical truth, not the routing hint."""
        for i, m in self.managers.items():
            if self.sched.nodes[i].alive and sid in m.store.entries:
                return i
        return None

    def _on_advisory(self, adv: AdvisoryRequest, now: float) -> None:
        adv.issued_at = now
        if not self.policy.uses_advisory:
            return
        sid = adv.session_id
        meta = self.sched.bind_group(sid, adv.group)
        to_hbm = self.advisory_to_hbm and (
            not self.policy.prefetch_to_hbm_priority_only
            or (adv.priority or 0) > 0)
        target = self.sched.policy.place(self.sched, meta, True)
        if target is None:
            return
        self.sched.plan(sid, target)
        holder = self._kv_holder(sid)
        if holder is None and self.policy.reuses_kv \
                and meta.total_tokens > 0:
            # KV lost with a failed node: recover from its disk spool now,
            # off the critical path — the advisory's whole point
            if self._recover(sid, target, now):
                holder = target
        self.managers[target].on_advisory(adv, kv_node=holder, now=now,
                                          to_hbm=to_hbm)

    def _prefix_node(self, req: InferenceRequest) -> Optional[int]:
        """Routing hint: the live node whose resident pages hold the
        longest indexed shared prefix of this prompt.  Only a FRESH session
        consults the index (an ongoing session's sticky/advisory placement
        dominates), only in real mode (sim has no pages or token ids)."""
        if (self.mode != "real" or not self.policy.reuses_kv
                or not req.prompt_ids
                or self.sched.session(req.session_id).total_tokens > 0):
            return None
        best, best_m = None, 0
        for i, be in self.backends.items():
            if not self.sched.nodes[i].alive \
                    or self.node_group[i] != req.group:
                continue
            m = be.prefix_match_tokens(req.prompt_ids)
            if m > best_m:
                best, best_m = i, m
        return best

    def _dispatch(self, req: InferenceRequest, now: float,
                  schedule_node) -> None:
        sid = req.session_id
        node = self.sched.route(req, now,
                                prefix_node=self._prefix_node(req))
        meta = self.sched.session(sid)
        if self.policy.reuses_kv and meta.total_tokens > 0:
            holder = self._kv_holder(sid)
            if holder is None:
                # no live copy anywhere: explicit disk recovery from the
                # crashed node's spool, else full-history recompute — the
                # session must never be served as if its KV still existed
                if self._recover(sid, node, now):
                    req.cached_tokens = meta.total_tokens
                else:
                    self._to_recompute(req, meta)
            else:
                if req.cached_tokens == 0:
                    # route() zeroed it (mark_failed staled kv_node) but the
                    # KV does live on a healthy node — e.g. it was advisory-
                    # migrated away before its old home crashed
                    req.cached_tokens = meta.total_tokens
                if holder != node:
                    # no advisory was sent / sticky: on-demand migration
                    # cost sits on the critical path via kv_stall inside
                    # the engine
                    self.managers[node].on_advisory(
                        AdvisoryRequest(sid), kv_node=holder, now=now,
                        to_hbm=True)
        self.engines[node].submit(req)
        schedule_node(node, now)

    def _recover(self, sid: str, node: int, now: float) -> bool:
        for j in sorted(self._dead):
            if self.managers[node].recover_from_spool(
                    sid, self.managers[j], now):
                return True
        return False

    def _to_recompute(self, req: InferenceRequest, meta) -> None:
        """Lost KV with no recoverable spool copy: the whole session context
        becomes fresh prefill work (the recompute cost the paper's recovery
        story is priced against)."""
        sid = req.session_id
        req.cached_tokens = 0
        if self.mode == "real":
            turn = self._turn0.get(sid)
            prompt = list(turn[0]) if turn and turn[0] is not None \
                else list(req.prompt_ids or [])
            req.prompt_ids = list(self._history.get(sid, [])) + prompt
            req.prompt_tokens = len(req.prompt_ids)
            if turn is not None:
                req.max_new_tokens = turn[2]
            req.output_ids = []
            req.generated = 0
            req.first_token_at = None
            for j, m in self.managers.items():
                if self.sched.nodes[j].alive:
                    m.drop_session(sid)      # no stale partial state anywhere
        else:
            req.prompt_tokens += meta.total_tokens
        meta.kv_node = None

    def _complete(self, req: InferenceRequest, i: int, t_done: float) -> None:
        sid = req.session_id
        turn = self._turn0.pop(sid, None)
        if self.mode == "real":
            # page-accurate truth, robust across preemption round trips
            total = self.backends[i].session_tokens(sid)
            if turn is not None and turn[0] is not None:
                self._history.setdefault(sid, []).extend(
                    list(turn[0]) + list(req.output_ids or []))
        else:
            total = req.cached_tokens + req.prompt_tokens + req.generated
        self.sched.on_request_complete(req, total)
        if self.policy.reuses_kv:
            if self.mode == "sim":
                # per-node cost/granularity: a recurrent node's store holds
                # ONE whole-blob layer, a transformer's one per model layer
                cost, cfg = self.costs[i], self.cfgs[i]
                layers = getattr(cost, "store_layers", cfg.n_layers)
                self.managers[i].mark_resident(
                    sid, total, cost.session_kv_bytes(total) / layers,
                    req.priority)
            if self.policy.uses_advisory:
                # background disk write-through: the always-one-copy-on-disk
                # invariant that makes post-crash recovery possible (only
                # this session's copy can be stale — growth resets on_disk)
                self.managers[i].flush_session(sid, t_done)

    def _reset_to_turn_start(self, req: InferenceRequest) -> None:
        """Rewind a request stranded on a failed node to its pristine
        turn-start form (preemption may have consumed prompt_ids and
        rewritten the token budgets)."""
        turn = self._turn0.get(req.session_id)
        if turn is not None:
            ids, prompt_tokens, max_new = turn
            req.prompt_ids = list(ids) if ids is not None else None
            req.prompt_tokens = prompt_tokens
            req.max_new_tokens = max_new
        req.cached_tokens = 0
        req.generated = 0
        req.first_token_at = None
        if req.output_ids is not None:
            req.output_ids = []

    def _fail(self, i: int, now: float, schedule_node) -> None:
        self.sched.mark_failed(i)
        # poison first, account second: the backend kills its in-flight
        # transfers (mid-copy gathers install nothing, pending spool writes
        # never happen), then the manager drops sessions whose disk
        # write-through had not completed by the crash instant — an
        # interrupted transfer must resolve to LOST, never to phantom KV
        self.backends[i].crash()
        self.managers[i].crash(now)
        self._dead.add(i)
        eng = self.engines[i]
        stranded = [r.req if hasattr(r, "req") else r
                    for r in list(eng.running) + list(eng.waiting)]
        eng.running.clear()
        eng.waiting.clear()
        for rr in stranded:
            # reconcile the dead node's queue accounting (route() charged it
            # at admission; nothing will ever complete there)
            self.sched.release_failed(rr, i)
            self._reset_to_turn_start(rr)
            self._dispatch(rr, now, schedule_node)


# Backwards-compatible names: the simulator is the runtime in sim mode.
ClusterSim = ClusterRuntime
SimResult = ClusterResult
