"""SYMPHONY cluster scheduler: request-level placement driven by advisory
requests (paper SS3.2).

On an advisory the scheduler (a) picks a target node via the pluggable
policy, (b) annotates the advisory with the current KV location, (c)
forwards it to that node's manager (which migrates/prefetches off the
critical path), and (d) updates the location map.  The later inference
request routes to the prepared node.  Baselines (vLLM-recompute, InferCept
sticky) are the same scheduler with different policies — see policies.py.

Straggler mitigation: placement uses an EWMA of per-node step latency as a
tiebreak so slow nodes stop attracting new sessions (free with advisories:
placement is off the critical path).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.advisory import InferenceRequest, SessionMeta
from repro_torch.core.policies import Policy


@dataclass
class NodeStats:
    node_id: int
    outstanding: int = 0           # queued + running requests
    planned: int = 0               # advisory-planned arrivals not yet routed
    sessions: int = 0              # sessions whose KV lives here
    ewma_step: float = 0.0         # straggler signal (s per decode step)
    alive: bool = True
    group: str = "default"         # architecture group this node serves

    def load_key(self):
        # an advisory reserves capacity on its target: simultaneous
        # advisories must spread instead of all picking the same idle node
        return (self.outstanding + self.planned, self.ewma_step,
                self.node_id)


class SymphonyScheduler:
    def __init__(self, n_nodes: int, policy: Policy,
                 node_groups: Optional[Dict[int, str]] = None):
        groups = node_groups or {}
        self.nodes = {i: NodeStats(i, group=groups.get(i, "default"))
                      for i in range(n_nodes)}
        self.policy = policy
        self.sessions: Dict[str, SessionMeta] = {}
        self.planned: Dict[str, int] = {}      # session -> node chosen at advisory
        self.node_managers = {}                # wired by the cluster runtime

    # -- wiring ------------------------------------------------------------------

    def register_node_manager(self, node_id: int, mgr) -> None:
        self.node_managers[node_id] = mgr

    def session(self, sid: str) -> SessionMeta:
        if sid not in self.sessions:
            self.sessions[sid] = SessionMeta(sid)
        return self.sessions[sid]

    def bind_group(self, sid: str, group: str) -> SessionMeta:
        """Bind a session to its architecture group (sticky once set off the
        default — a later event that omits the group must not unbind it)."""
        meta = self.session(sid)
        if group != "default":
            meta.group = group
        return meta

    # -- planned-placement bookkeeping ---------------------------------------------

    def plan(self, sid: str, target: int) -> None:
        """Record an advisory-planned placement; the target node carries the
        reservation in its load key until the request routes (or the
        session ends / the node fails)."""
        self._unplan(sid)
        self.planned[sid] = target
        self.nodes[target].planned += 1

    def _unplan(self, sid: str) -> Optional[int]:
        target = self.planned.pop(sid, None)
        if target is not None and target in self.nodes:
            st = self.nodes[target]
            st.planned = max(0, st.planned - 1)
        return target

    # -- events --------------------------------------------------------------------
    # (advisory handling lives in ClusterRuntime._on_advisory: placement
    # must consult the physical KV holder and the failure-recovery path,
    # which the scheduler alone cannot see)

    def route(self, req: InferenceRequest, now: float,
              prefix_node: Optional[int] = None) -> int:
        """Route an inference request; advisory-planned node wins, then a
        ``prefix_node`` hint (a node whose resident pages already hold a
        shared prefix of this prompt — serving there skips that prefill
        entirely via copy-on-write sharing), then the placement policy."""
        meta = self.bind_group(req.session_id, req.group)
        req.group = meta.group
        req.priority = max(req.priority, meta.priority)
        target = self._unplan(req.session_id)
        if target is None or not self.nodes[target].alive \
                or self.nodes[target].group != meta.group:
            # a plan from a group-less early advisory may point at the wrong
            # architecture; the request's group is authoritative
            if prefix_node is not None and prefix_node in self.nodes \
                    and self.nodes[prefix_node].alive \
                    and self.nodes[prefix_node].group == meta.group:
                target = prefix_node
            else:
                target = self.policy.place(self, meta, advisory=False)
        req.node_id = target
        # session history length; the engine decides whether it is reusable
        # KV (symphony/sticky) or redundant recompute work (stateless)
        if self.policy.reuses_kv and meta.kv_node is None \
                and meta.total_tokens > 0:
            # no live KV location (post-failure): the session must not be
            # served as if its KV still existed — the runtime either recovers
            # it explicitly from a crashed node's disk spool (and restores
            # cached_tokens) or pays full recompute
            req.cached_tokens = 0
        else:
            req.cached_tokens = meta.total_tokens
        self.nodes[target].outstanding += 1
        return target

    def on_request_complete(self, req: InferenceRequest,
                            new_total_tokens: int) -> None:
        meta = self.session(req.session_id)
        node = self.nodes[req.node_id]
        node.outstanding -= 1
        meta.total_tokens = new_total_tokens
        if self.policy.reuses_kv:
            if meta.kv_node is not None and meta.kv_node != req.node_id \
                    and meta.kv_node in self.nodes:
                self.nodes[meta.kv_node].sessions = max(
                    0, self.nodes[meta.kv_node].sessions - 1)
            if meta.kv_node != req.node_id:
                node.sessions += 1
            meta.kv_node = req.node_id
        meta.turns += 1

    def end_session(self, sid: str) -> None:
        meta = self.sessions.pop(sid, None)
        self._unplan(sid)
        if meta and meta.kv_node is not None and meta.kv_node in self.nodes:
            self.nodes[meta.kv_node].sessions = max(
                0, self.nodes[meta.kv_node].sessions - 1)
        if meta and meta.kv_node is not None:
            mgr = self.node_managers.get(meta.kv_node)
            if mgr is not None:
                mgr.drop_session(sid)

    # -- fault tolerance ---------------------------------------------------------------

    def release_failed(self, req: InferenceRequest, node_id: int) -> None:
        """A request stranded on a failed node is being rerouted: release the
        dead node's queue accounting so the counter is reconciled, not
        leaked (route() will charge the new node when it re-places it)."""
        st = self.nodes[node_id]
        st.outstanding = max(0, st.outstanding - 1)
        req.node_id = None

    def mark_failed(self, node_id: int) -> List[str]:
        """Node failure: reroute its sessions; KV recovers from the disk tier
        of the failed node's spool (paper's always-one-copy-on-disk makes the
        persistent tier the recovery substrate)."""
        self.nodes[node_id].alive = False
        orphans = [s.session_id for s in self.sessions.values()
                   if s.kv_node == node_id]
        for sid in orphans:
            self.sessions[sid].kv_node = None     # forces refetch/recompute
            self._unplan(sid)
        return orphans

    def report_step_latency(self, node_id: int, dt: float) -> None:
        st = self.nodes[node_id]
        st.ewma_step = 0.8 * st.ewma_step + 0.2 * dt if st.ewma_step else dt

    def live_nodes(self, group: Optional[str] = None) -> List[NodeStats]:
        return [n for n in self.nodes.values() if n.alive
                and (group is None or n.group == group)]
