"""SYMPHONY node manager (paper SS3.2-3.3): owns the node's tiered KV store,
prefetches on advisories (peer migration + layer-priority HBM promotion),
answers peer fetch requests, and exposes the cooperative-memory hook the
serving engine calls under HBM pressure.

All timing flows through simulated per-channel queues (h2d / disk / peer),
so migrations serialize realistically and the engine can ask "how much
critical-path stall remains for session X at time T?" — with advisories
the answer is usually zero (the paper's headline mechanism)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.advisory import AdvisoryRequest
from repro_torch.core.memory import DISK, HBM, HOST, TieredKVStore
from repro_torch.serving.cost_model import CostModel
from repro_torch.serving.transfer import OUT


@dataclass
class FetchState:
    """Per-session in-flight fetch bookkeeping: layer l usable at ready[l]."""
    ready_at: list = field(default_factory=list)


class NodeManager:
    def __init__(self, node_id: int, cfg, cost: CostModel,
                 host_budget: Optional[float] = None,
                 pod_of=lambda node: 0, enable_quantize: bool = True):
        self.node_id = node_id
        self.cfg = cfg
        self.cost = cost
        # quantize-before-swap under HBM pressure (the in-HBM int8 tier);
        # off = the pre-quantization eviction policy, the sim A/B lever
        self.enable_quantize = enable_quantize
        # advisory-fed reuse predictions: sid -> absolute expected use time
        self.expected_use: Dict[str, float] = {}
        # store granularity: transformers tier KV layer-by-layer; recurrent
        # (mamba2/xlstm) and hybrid sessions move as ONE fixed-size state
        # blob, so their store entries carry a single "layer" unit
        self.n_layers = getattr(cost, "store_layers", cfg.n_layers)
        self.store = TieredKVStore(
            hbm_budget=int(cost.hbm_kv_budget()),
            host_budget=int(host_budget or cost.hw.host_dram))
        # simulated transfer channels: busy-until timestamps
        self.chan: Dict[str, float] = {"h2d": 0.0, "peer": 0.0, "disk": 0.0}
        self.fetches: Dict[str, FetchState] = {}
        # completion time of each session's last disk write-through: a
        # crash BEFORE this time poisons the in-flight write (the copy
        # never finished — it must not be a recovery substrate)
        self.disk_done: Dict[str, float] = {}
        self.pod_of = pod_of
        self.peers: Dict[int, "NodeManager"] = {}
        # real-mode execution backend (serving/backend.py); when attached,
        # every placement decision below also moves actual page contents
        self.backend = None
        self.stats = dict(prefetches=0, migrations=0, migrated_bytes=0.0,
                          evictions=0, disk_writes=0, recoveries=0,
                          swaps_in=0, promoted_layers=0,
                          quantized_sessions=0, quantize_freed_bytes=0.0,
                          evicted_bytes=0.0)

    def register_peers(self, managers: Dict[int, "NodeManager"]) -> None:
        self.peers = managers

    def attach_backend(self, backend) -> None:
        self.backend = backend

    # -- channel helper ------------------------------------------------------------

    def _enqueue(self, chan: str, nbytes: float, kind: str, now: float) -> float:
        start = max(now, self.chan[chan])
        done = start + self.cost.transfer_time(nbytes, kind)
        self.chan[chan] = done
        return done

    # -- advisory path (off the critical path) ---------------------------------------

    def on_advisory(self, adv: AdvisoryRequest, kv_node: Optional[int],
                    now: float, to_hbm: bool = True) -> None:
        sid = adv.session_id
        # the advisory's lead time IS the reuse prediction the
        # quantize-vs-swap policy consumes (no expected_arrival = imminent)
        self.note_reuse(sid, now + (adv.expected_arrival or 0.0))
        e = self.store.entries.get(sid)
        if e is None:
            if kv_node is None or kv_node == self.node_id:
                return                       # brand-new session: nothing to move
            peer = self.peers.get(kv_node)
            if peer is None or sid not in peer.store.entries:
                return
            pe = peer.store.entries[sid]
            if pe.pinned:
                return               # peer is actively serving this session
            kind = "peer" if self.pod_of(kv_node) == self.pod_of(self.node_id) \
                else "xpod"
            # migrate layer-by-layer into host (+ disk write-through)
            ready = []
            for l in range(pe.n_layers):
                done = self._enqueue("peer", pe.bytes_per_layer, kind, now)
                ready.append(done)
            peer.store.drop(sid)
            peer.fetches.pop(sid, None)
            self.store.admit(sid, pe.n_tokens, pe.bytes_per_layer,
                             pe.n_layers, tier=HOST, priority=pe.priority,
                             kind=pe.kind)
            # real mode: actually move the page contents between nodes
            if self.backend is not None and peer.backend is not None:
                payload = peer.backend.export_session(sid)
                if payload is not None:
                    self.backend.import_session(sid, payload)
            self.fetches[sid] = FetchState(ready_at=ready)
            self.stats["migrations"] += 1
            self.stats["migrated_bytes"] += pe.total_bytes
            self._disk_writethrough(sid, now)
            e = self.store.entries[sid]
        if to_hbm:
            self.promote(sid, now)
        self.stats["prefetches"] += 1

    def promote(self, sid: str, now: float) -> None:
        """Greedy cooperative promotion: lower layers first into free HBM.

        The advisory path ENQUEUES, it never copies inline: the backend
        allocates pages for the plan and launches one asynchronous
        host->device scatter (`Backend.prefetch`), then returns — by the
        time the engine admits the request the copy has drained under the
        intervening compute and `_ensure_resident` only fences the future.

        Best-effort by contract: page allocation happens at enqueue BEFORE
        the accounting move, so a backend that runs out of physical pages
        (fragmentation the byte-level store cannot see) cuts the plan short
        with the remaining layers left in the slow tier — the advisory path
        never raises and store accounting never diverges from placement."""
        e = self.store.entries.get(sid)
        if e is None:
            return
        fs = self.fetches.setdefault(
            sid, FetchState(ready_at=[now] * e.n_layers))
        plan = self.store.promotion_plan(sid)
        if not plan:
            return
        launched = None
        if self.backend is not None:
            got = self.backend.prefetch(sid, [l for l, _ in plan])
            launched = None if got is None else set(got)
        moved = 0
        for l, src in plan:
            if launched is not None and l not in launched:
                break            # HBM physically full: stay in slow tier
            kind = "h2d" if src in (HOST,) else "disk_r"
            chan = "h2d" if src == HOST else "disk"
            start = max(now, fs.ready_at[l] if l < len(fs.ready_at) else now)
            done = self._enqueue(chan, e.bytes_per_layer, kind, start)
            fs.ready_at[l] = done
            self.store.move_layer(sid, l, HBM)
            moved += 1
        if moved:
            # one session swap-in occurrence + its layer count — identical
            # accounting on both backends (the sim/real parity observable)
            self.stats["swaps_in"] += 1
            self.stats["promoted_layers"] += moved

    def _disk_writethrough(self, sid: str, now: float) -> None:
        e = self.store.entries.get(sid)
        if e is None or e.on_disk:
            return
        if self.backend is not None and not self.backend.persist(sid):
            return        # nothing physically written: invariant not claimable
        # the write is modeled (and in real mode launched) asynchronously;
        # record when it lands so a crash before then poisons it
        self.disk_done[sid] = self._enqueue("disk", e.total_bytes,
                                            "disk_w", now)
        self.store.ensure_persistent(sid)
        self.stats["disk_writes"] += 1

    # -- critical path: how much stall remains when the request shows up ---------------

    def kv_stall(self, sid: str, now: float, step_time: float) -> float:
        """Seconds of critical-path stall to begin computing with this
        session's KV, given layer-wise async reads.  Each layer's residual
        is `CostModel.overlap_stall(remaining transfer, compute it can hide
        behind)` — the same overlap model the real backend realizes by
        fencing in-flight futures, so sim and real agree by construction:
        a transfer launched (advisory) early enough has remaining <= the
        compute walk and contributes zero."""
        e = self.store.entries.get(sid)
        if e is None:
            return 0.0                       # nothing cached: pure prefill
        fs = self.fetches.get(sid)
        per_layer = step_time / max(self.n_layers, 1)
        stall = 0.0
        fetch_q = 0.0
        for l in range(e.n_layers):
            t = e.tier[l]
            ready = now
            if fs and l < len(fs.ready_at):
                ready = max(ready, fs.ready_at[l])
            if t != HBM:
                kind = ("h2d", "disk_r")[t == DISK]
                fetch_q += self.cost.transfer_time(e.bytes_per_layer, kind)
                ready = max(ready, now + fetch_q)
            stall = max(stall, self.cost.overlap_stall(ready - now,
                                                       l * per_layer))
        return stall

    def mark_resident(self, sid: str, n_tokens: int,
                      bytes_per_layer: float, priority: int = 0,
                      shared_tokens: int = 0, quant_tokens: int = 0) -> None:
        """After serving, the session's (grown) KV is in HBM on this node.
        ``shared_tokens`` of that context live in pages shared with other
        sessions (real-mode prefix sharing) — the backend already excluded
        them from ``bytes_per_layer``, so the ledger never double-charges a
        physical page; the entry records the span for observability.
        ``quant_tokens`` of it sit in int8 pages (already reflected in
        ``bytes_per_layer`` by the backend's exact page pricing)."""
        if sid in self.store.entries:
            self.store.grow(sid, 0, int(bytes_per_layer), quant_tokens)
            e = self.store.entries[sid]
            e.n_tokens = n_tokens
        else:
            e = self.store.admit(sid, n_tokens, int(bytes_per_layer),
                                 self.n_layers, tier=HBM, priority=priority,
                                 kind=getattr(self.cost, "state_kind", "kv"))
            e.quant_tokens = quant_tokens
        e.shared_tokens = shared_tokens
        self.fetches.pop(sid, None)

    # -- reuse prediction (feeds quantize-vs-swap) ---------------------------------------

    def note_reuse(self, sid: str, at: float) -> None:
        """Record when this session is next expected to serve."""
        self.expected_use[sid] = at

    def reuse_distance(self, sid: str, now: float) -> Optional[float]:
        """Seconds until the predicted next use; None = no advisory ever
        mentioned this session (no idea when it returns)."""
        t = self.expected_use.get(sid)
        return None if t is None else max(0.0, t - now)

    # -- cooperative memory management ---------------------------------------------------

    def on_memory_pressure(self, bytes_needed: float, now: float,
                           protect: Optional[set] = None) -> float:
        # QUANTIZE BEFORE SWAP: victims whose predicted reuse is near stay
        # serving-warm at the int8 tier's price (one cheap in-HBM round
        # trip, zero PCIe); only far-reuse — or advisory-less — sessions
        # fall through to the eviction path below.  With no advisories
        # nothing quantizes and the path is byte-identical to before.
        if self.enable_quantize:
            bytes_needed -= self._quantize_pass(bytes_needed, now,
                                                protect or set())
        if bytes_needed > 0:
            evicted = self.store.evict_hbm_to_fit(int(bytes_needed), protect)
            self.stats["evictions"] += len(evicted)
            # write-back is free when a persistent copy exists (the
            # invariant); otherwise the block demotes to host (no copy-out
            # modeled: layer KV writes stream through the background disk
            # thread)
            for sid, l in evicted:
                self.stats["evicted_bytes"] += \
                    self.store.entries[sid].bytes_per_layer
                if self.backend is not None:
                    self.backend.evict_layer(sid, l)
                self._disk_writethrough(sid, now)
            if evicted and self.backend is not None:
                # pressure wants the pages NOW: every victim layer's gather
                # was launched above and the copies overlap each other —
                # one barrier reclaims all their leased pages
                self.backend.drain_transfers(OUT)
            elif self.backend is None:
                # sim mirror of the real backend's swap re-inflation: tier
                # payloads are fp, so a quantized victim that leaves HBM
                # reprices back to full-precision geometry (otherwise the
                # A/B's transfer bytes would flatter the quantized arm)
                for sid in {s for s, _ in evicted}:
                    e = self.store.entries[sid]
                    if e.quant_tokens:
                        self.store.reprice(
                            sid,
                            int(self.cost.session_kv_bytes(e.n_tokens))
                            // max(self.n_layers, 1), 0)
        return self.store.free(HBM)

    def _quantize_pass(self, bytes_needed: float, now: float,
                       protect: set) -> float:
        """Compress near-reuse HBM victims in place; returns the HBM bytes
        freed.  Largest sessions first (most bytes recovered per compress
        dispatch); only fully-HBM-resident entries qualify — quantization
        is layer-lockstep by construction."""
        if bytes_needed <= 0:
            return 0.0
        freed = 0.0
        victims = sorted(
            (e for e in self.store.entries.values()
             if not e.pinned and e.session_id not in protect
             and e.quant_tokens < e.n_tokens
             and all(t == HBM for t in e.tier)),
            key=lambda e: -e.total_bytes)
        for e in victims:
            if freed >= bytes_needed:
                break
            if not self.cost.prefer_quantize(
                    e.n_tokens, self.reuse_distance(e.session_id, now)):
                continue
            got = self._quantize_session(e, now)
            if got > 0:
                freed += got
                self.stats["quantized_sessions"] += 1
                self.stats["quantize_freed_bytes"] += got
        return freed

    def _quantize_session(self, e, now: float) -> float:
        """One victim's compress, on either backend: real mode runs the
        fused `compress_paged` dispatch (which also reprices the store);
        sim mode reprices the entry to the cost model's int8 geometry.
        Both charge `CostModel.compress_time` through the session's
        ready_at horizon, so a victim that serves again immediately pays
        the same residual on both backends (sim/real agreement by
        construction)."""
        sid = e.session_id
        if self.backend is not None:
            freed = float(self.backend.quantize_session(sid))
        else:
            new_bpl = int(self.cost.session_kv_bytes(e.n_tokens, e.n_tokens)
                          // max(self.n_layers, 1))
            if new_bpl >= e.bytes_per_layer:
                return 0.0
            freed = float(-self.store.reprice(sid, new_bpl, e.n_tokens))
        if freed > 0:
            done = now + self.cost.compress_time(e.n_tokens)
            fs = self.fetches.setdefault(
                sid, FetchState(ready_at=[now] * e.n_layers))
            fs.ready_at = [max(r, done) for r in fs.ready_at]
        return freed

    def flush_session(self, sid: str, now: float) -> None:
        """Write-through one session's (possibly regrown) KV to disk."""
        self._disk_writethrough(sid, now)

    def background_flush(self, now: float) -> None:
        for sid in list(self.store.entries):
            self._disk_writethrough(sid, now)

    def drop_session(self, sid: str) -> None:
        self.store.drop(sid)
        self.fetches.pop(sid, None)
        self.disk_done.pop(sid, None)
        self.expected_use.pop(sid, None)
        if self.backend is not None:
            self.backend.drop(sid)

    # -- fault tolerance -----------------------------------------------------------------

    def recover_from_spool(self, sid: str, dead: "NodeManager",
                           now: float) -> bool:
        """Failure recovery: pull a session's persistent copy out of a
        crashed peer's disk spool into this node's host tier (the paper's
        always-one-copy-on-disk invariant is the recovery substrate).

        Physical first, accounting second: in real mode the payload is read
        from the dead node's spool before either store is touched, so a
        missing/corrupt spool file leaves both nodes' accounting intact and
        the caller falls back to full recompute."""
        if sid in self.store.entries:
            return True                       # already recovered here
        e = dead.store.entries.get(sid)
        if e is None or not e.on_disk:
            return False
        payload = None
        if self.backend is not None:
            if dead.backend is None:
                return False
            payload = dead.backend.recover_session(sid)
            if payload is None:
                return False     # no physical copy: recovery not claimable
            tokens = payload["n_kv"] + (payload["last_token"] is not None)
            if tokens != e.n_tokens:
                # STALE snapshot: the session grew after this copy and the
                # fresher write-through died in flight with the node —
                # serving it would be phantom (truncated) KV.  Fall back to
                # recompute; the consumed spool file was stale anyway.
                # (Real mode only by construction: sim has no file whose
                # content can lag — `TieredKVStore.grow` resets on_disk on
                # every growth, so a sim entry that kept on_disk through
                # `crash(now)` was flushed at its current n_tokens.)
                return False
        ready = []
        for l in range(e.n_layers):
            done = self._enqueue("disk", e.bytes_per_layer, "disk_r", now)
            ready.append(done)
        dead.store.drop(sid)
        dead.fetches.pop(sid, None)
        self.store.admit(sid, e.n_tokens, e.bytes_per_layer, e.n_layers,
                         tier=HOST, priority=e.priority, kind=e.kind)
        self.fetches[sid] = FetchState(ready_at=ready)
        if payload is not None:
            self.backend.import_session(sid, payload)
        self._disk_writethrough(sid, now)     # re-establish the invariant
        self.stats["recoveries"] += 1
        return True

    def crash(self, now: Optional[float] = None) -> None:
        """Lose HBM/host tiers; the disk spool survives (recovery path).

        With ``now``, in-flight disk write-throughs are POISONED: a session
        whose write-through had not completed by the crash instant has no
        durable copy — claiming one would recover phantom KV.  Without
        ``now`` every recorded write is treated as complete (back-compat
        for callers outside the event loop).  In real mode a physically
        written spool file overrides the modeled completion time (physical
        first, accounting second): the entry stays recoverable, and the
        recovery path's freshness check consumes-and-rejects the file if
        it turns out stale — which also keeps dead spools from
        accumulating orphaned snapshots."""
        for sid in list(self.store.entries):
            e = self.store.entries[sid]
            persisted = e.on_disk and (
                now is None or self.disk_done.get(sid, 0.0) <= now
                or (self.backend is not None
                    and self.backend.spool_exists(sid)))
            if not persisted:
                self.store.drop(sid)
            else:
                for l in range(e.n_layers):
                    self.store.move_layer(sid, l, DISK)
                e.pinned = False     # whoever was serving it is gone
        self.chan = {k: 0.0 for k in self.chan}
        self.fetches.clear()
        self.disk_done.clear()
        self.expected_use.clear()
