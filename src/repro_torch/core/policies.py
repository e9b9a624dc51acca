"""Placement policies: SYMPHONY + the paper's baselines, all as plugins on
the same request-level scheduling substrate (paper SS3.5).

  symphony   — request-level least-loaded placement, KV reuse via advisory-
               driven migration (the paper's system).
  sticky     — InferCept-style: session pinned to the node that served its
               first request (stateful offload, no migration).
  stateless  — vLLM-style: least-loaded placement per request, KV discarded
               (full recompute each turn).
  priority   — symphony + priority tiers: high-priority sessions are
               prefetched straight to HBM and spread evenly (SS4.5).
"""
from __future__ import annotations

from typing import Optional


class Policy:
    name = "base"
    reuses_kv = True
    uses_advisory = True
    prefetch_to_hbm_priority_only = False

    def place(self, sched, meta, advisory: bool) -> Optional[int]:
        raise NotImplementedError

    @staticmethod
    def _candidates(sched, meta):
        """Live nodes of the session's architecture group: a recurrent-state
        session must never be placed on a node whose backend cannot hold its
        state kind."""
        nodes = sched.live_nodes(getattr(meta, "group", "default"))
        if not nodes:
            raise RuntimeError(
                f"no live node serves group {getattr(meta, 'group', None)!r}")
        return nodes

    def _least_loaded(self, sched, meta) -> int:
        return min(self._candidates(sched, meta),
                   key=lambda n: n.load_key()).node_id


class SymphonyPolicy(Policy):
    name = "symphony"

    def place(self, sched, meta, advisory: bool) -> int:
        return self._least_loaded(sched, meta)


class StickyPolicy(Policy):
    """InferCept baseline: first request least-loaded, then session-sticky.
    Advisories are ignored (the system has no migration path)."""
    name = "sticky"
    uses_advisory = False

    def place(self, sched, meta, advisory: bool) -> Optional[int]:
        if advisory:
            return None
        if meta.kv_node is not None and sched.nodes[meta.kv_node].alive:
            return meta.kv_node
        return min(self._candidates(sched, meta),
                   key=lambda n: (n.sessions, n.outstanding, n.node_id)).node_id


class StatelessPolicy(Policy):
    """vLLM baseline: per-request least-loaded, recompute everything."""
    name = "stateless"
    reuses_kv = False
    uses_advisory = False

    def place(self, sched, meta, advisory: bool) -> Optional[int]:
        if advisory:
            return None
        return self._least_loaded(sched, meta)


class PriorityTierPolicy(SymphonyPolicy):
    """SS4.5: paid-tier sessions get HBM prefetch + even spread across nodes;
    free-tier sessions behave like plain symphony but only prefetch to host."""
    name = "priority"
    prefetch_to_hbm_priority_only = True

    def place(self, sched, meta, advisory: bool) -> int:
        nodes = self._candidates(sched, meta)
        if meta.priority > 0:
            # spread high-priority sessions by count of high-pri sessions
            return min(nodes, key=lambda n: (
                getattr(n, "hi_pri", 0), n.outstanding, n.node_id)).node_id
        return self._least_loaded(sched, meta)


POLICIES = {p.name: p for p in
            (SymphonyPolicy(), StickyPolicy(), StatelessPolicy(),
             PriorityTierPolicy())}
