"""Hierarchical (HBM / host / disk) KV store with the paper's three
mechanisms:

* layer-granular placement — each session's KV is tracked per layer, so the
  node manager can stream layers asynchronously and start decoding as soon
  as layer 0 is resident (SS3.3 "layer-wise asynchronous reading/writing");
* priority-based placement — earlier layers have higher placement priority
  (needed first; later layers' fetch hides behind the forward pass);
  eviction order is the reverse: later layers first, then smallest sessions
  (SS3.3 "Priority-Based K,V Cache");
* cooperative memory management — the serving engine may purge prefetched
  HBM blocks at zero cost because one complete copy always lives on the
  slowest tier (SS3.3; `ensure_persistent` + `evict_hbm_to_fit`).

Accounting is in bytes and layer units; the actual tensors (real mode) live
in the owning runtime keyed by (session, layer) — this class is pure
bookkeeping, shared verbatim by the simulator and the real engine.

The store also owns the node's `PrefixIndex` (when serving in real mode):
a chained hash of page-aligned token-id chunks -> (donor session, depth)
that admission consults for longest-shared-prefix lookup, the entry point
of cross-session copy-on-write KV sharing.  `drop()` is prefix-aware — a
dropped session's index entries go with it, so a later admission can never
adopt pages from a session the store no longer tracks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

HBM, HOST, DISK = "hbm", "host", "disk"
TIER_ORDER = (HBM, HOST, DISK)


class PrefixIndex:
    """Longest-shared-prefix index over page-aligned token-id chunks.

    Each full page-size chunk of a registered session's token history is
    hashed CHAINED on its predecessor — key(d) = hash(key(d-1), chunk d) —
    so a single dict lookup at depth d certifies the entire d-page prefix,
    not just the d-th chunk.  `lookup` walks a candidate prompt down the
    chain and returns the deepest registered (donor, pages) hit.  First
    registrant wins a key (stable donors); collisions and staleness are the
    CALLER's problem — adopters must verify the donor's actual token ids
    and page residency before attaching (backend.adopt_prefix does)."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.chains: Dict[int, Tuple[str, int]] = {}   # key -> (sid, depth)
        self.by_sid: Dict[str, List[int]] = {}         # sid -> keys it owns

    @staticmethod
    def _chunk_key(parent: int, chunk: Tuple[int, ...]) -> int:
        return hash((parent,) + chunk)

    def register(self, sid: str, ids: Sequence[int]) -> int:
        """Index every full-page prefix of ``ids``; returns pages indexed."""
        ps = self.page_size
        key, depth = 0, 0
        owned = self.by_sid.setdefault(sid, [])
        for i in range(0, len(ids) - ps + 1, ps):
            key = self._chunk_key(key, tuple(ids[i:i + ps]))
            depth += 1
            if key not in self.chains:
                self.chains[key] = (sid, depth)
                owned.append(key)
        return depth

    def lookup(self, ids: Sequence[int],
               exclude: Optional[str] = None) -> Tuple[Optional[str], int]:
        """Deepest registered (donor, depth-in-pages) whose indexed prefix
        chain-matches ``ids``; (None, 0) when no full page matches."""
        ps = self.page_size
        key, depth = 0, 0
        best: Tuple[Optional[str], int] = (None, 0)
        for i in range(0, len(ids) - ps + 1, ps):
            key = self._chunk_key(key, tuple(ids[i:i + ps]))
            hit = self.chains.get(key)
            depth += 1
            # a miss at this depth does NOT end the walk: key(d) is computed
            # from the ids alone, and a dropped session may have taken its
            # shallow keys with it while a deeper registrant's keys survive
            if hit is not None and hit[0] != exclude:
                best = (hit[0], depth)
        return best

    def drop(self, sid: str) -> None:
        for key in self.by_sid.pop(sid, []):
            cur = self.chains.get(key)
            if cur is not None and cur[0] == sid:
                del self.chains[key]

    def clear(self) -> None:
        self.chains.clear()
        self.by_sid.clear()


@dataclass
class KVEntry:
    session_id: str
    n_tokens: int
    bytes_per_layer: int
    n_layers: int
    # tier[l] = where layer l currently is (highest tier holding it)
    tier: List[str] = field(default_factory=list)
    on_disk: bool = False          # a complete persistent copy exists
    pinned: bool = False           # in active use by the engine (not evictable)
    priority: int = 0
    # tokens of this session's context resident in pages SHARED with other
    # sessions (informational: the bytes ledger charges shared pages to
    # their first owner only, so per-entry bytes undercount by this span)
    shared_tokens: int = 0
    # what the bytes ARE: "kv" (paged, layer-granular), "state" (one fixed
    # recurrent blob), or "hybrid" (blob + windowed KV, still one unit).
    # Placement logic is kind-agnostic — recurrent entries simply carry
    # n_layers == 1 — but the ledger keeps per-kind totals so a mixed
    # cluster can report where its memory actually goes
    kind: str = "kv"
    # tokens held in INT8 pages of the quantized-in-HBM tier (already
    # reflected in bytes_per_layer by the caller's repricing; kept so the
    # policy can tell a compressed entry from an fp one and re-inflate its
    # geometry on swap-out)
    quant_tokens: int = 0

    def __post_init__(self):
        if not self.tier:
            self.tier = [HOST] * self.n_layers

    @property
    def total_bytes(self) -> int:
        return self.bytes_per_layer * self.n_layers

    def layers_in(self, tier: str) -> List[int]:
        return [l for l, t in enumerate(self.tier) if t == tier]


class TieredKVStore:
    def __init__(self, hbm_budget: int, host_budget: int,
                 disk_budget: int = 1 << 50):
        self.budget = {HBM: hbm_budget, HOST: host_budget, DISK: disk_budget}
        self.used = {HBM: 0, HOST: 0, DISK: 0}
        # per-state-kind breakdown of `used` (kv / state / hybrid): the
        # mixed-cluster observability ledger, conserved by check()
        self.used_kind: Dict[str, Dict[str, int]] = {
            t: {} for t in TIER_ORDER}
        self.entries: Dict[str, KVEntry] = {}
        # cross-session prefix index (real-mode serving attaches one sized
        # to the backend's page geometry; sim mode leaves it None)
        self.prefix: Optional[PrefixIndex] = None

    def _acct(self, tier: str, kind: str, delta: int) -> None:
        """Single funnel for every byte movement: the tier total and its
        per-kind breakdown can never diverge."""
        self.used[tier] += delta
        bk = self.used_kind[tier]
        bk[kind] = bk.get(kind, 0) + delta
        if bk[kind] == 0:
            del bk[kind]

    # -- admission -------------------------------------------------------------

    def admit(self, session_id: str, n_tokens: int, bytes_per_layer: int,
              n_layers: int, tier: str = HOST, priority: int = 0,
              on_disk: bool = False, kind: str = "kv") -> KVEntry:
        assert session_id not in self.entries
        e = KVEntry(session_id, n_tokens, bytes_per_layer, n_layers,
                    tier=[tier] * n_layers, priority=priority,
                    on_disk=on_disk, kind=kind)
        self.entries[session_id] = e
        self._acct(tier, kind, e.total_bytes)
        if on_disk:
            self._acct(DISK, kind, e.total_bytes)
        return e

    def drop(self, session_id: str) -> None:
        # prefix hygiene FIRST, and unconditionally: even a session the
        # store never admitted (dropped mid-serve, before its first
        # mark_resident) may have registered prefix chunks
        if self.prefix is not None:
            self.prefix.drop(session_id)
        e = self.entries.pop(session_id, None)
        if e is None:
            return
        for l, t in enumerate(e.tier):
            self._acct(t, e.kind, -e.bytes_per_layer)
        if e.on_disk:
            self._acct(DISK, e.kind, -e.total_bytes)

    def grow(self, session_id: str, new_tokens: int,
             new_bytes_per_layer: int, quant_tokens: int = 0) -> None:
        """After a turn, the session KV grew; it is resident in HBM."""
        e = self.entries[session_id]
        for l, t in enumerate(e.tier):
            self._acct(t, e.kind, -e.bytes_per_layer)
        if e.on_disk:
            self._acct(DISK, e.kind, -e.total_bytes)
            e.on_disk = False      # disk copy is stale after growth
        e.n_tokens += new_tokens
        e.bytes_per_layer = new_bytes_per_layer
        e.quant_tokens = quant_tokens
        e.tier = [HBM] * e.n_layers
        self._acct(HBM, e.kind, e.total_bytes)

    def reprice(self, session_id: str, new_bytes_per_layer: int,
                quant_tokens: int = 0) -> int:
        """Same tokens, new bytes: the quantized-in-HBM tier compresses a
        session's pages in place (or re-inflates them on swap-out /
        dequant), changing its per-layer byte price without moving a layer
        between tiers.  Every tier currently holding a layer — and the
        persistent disk copy, whose accounting mirrors total_bytes — is
        re-charged through the `_acct` funnel.  Returns the byte delta on
        the HBM ledger (negative = freed)."""
        e = self.entries[session_id]
        if new_bytes_per_layer == e.bytes_per_layer:
            e.quant_tokens = quant_tokens
            return 0
        delta = new_bytes_per_layer - e.bytes_per_layer
        hbm_delta = 0
        for l, t in enumerate(e.tier):
            self._acct(t, e.kind, delta)
            if t == HBM:
                hbm_delta += delta
        if e.on_disk:
            self._acct(DISK, e.kind, delta * e.n_layers)
        e.bytes_per_layer = new_bytes_per_layer
        e.quant_tokens = quant_tokens
        return hbm_delta

    # -- placement -------------------------------------------------------------

    def free(self, tier: str) -> int:
        return self.budget[tier] - self.used[tier]

    def move_layer(self, session_id: str, layer: int, dst: str) -> int:
        """Move one layer's KV to a tier; returns bytes moved."""
        e = self.entries[session_id]
        src = e.tier[layer]
        if src == dst:
            return 0
        self._acct(src, e.kind, -e.bytes_per_layer)
        self._acct(dst, e.kind, e.bytes_per_layer)
        e.tier[layer] = dst
        return e.bytes_per_layer

    def ensure_persistent(self, session_id: str) -> int:
        """Background disk write-through; returns bytes written."""
        e = self.entries[session_id]
        if e.on_disk:
            return 0
        e.on_disk = True
        self._acct(DISK, e.kind, e.total_bytes)
        return e.total_bytes

    # -- the paper's priority scheme ---------------------------------------------

    def promotion_plan(self, session_id: str, max_bytes: Optional[int] = None
                       ) -> List[Tuple[int, str]]:
        """Layers to promote to HBM, lowest layer first (highest priority),
        bounded by free HBM (+ optional cap). Returns [(layer, src_tier)]."""
        e = self.entries[session_id]
        budget = self.free(HBM) if max_bytes is None else min(
            self.free(HBM), max_bytes)
        plan = []
        for l in range(e.n_layers):
            if e.tier[l] != HBM and budget >= e.bytes_per_layer:
                plan.append((l, e.tier[l]))
                budget -= e.bytes_per_layer
        return plan

    def evict_hbm_to_fit(self, bytes_needed: int,
                         protect: Optional[set] = None) -> List[Tuple[str, int]]:
        """Cooperative memory management: free HBM by demoting prefetched
        blocks.  Eviction order: *later layers first* across victim sessions,
        then smallest sessions first (paper SS3.3).  Blocks whose session has a
        persistent copy are dropped for free; others demote to host.
        Returns [(session, layer)] evicted."""
        protect = protect or set()
        victims = [e for e in self.entries.values()
                   if not e.pinned and e.session_id not in protect]
        # smallest sessions get *second*-lowest priority => evict them after
        # later-layer blocks of all sessions; implement as sort key
        blocks = []
        for e in victims:
            for l in e.layers_in(HBM):
                # higher key = evicted earlier: later layer, then smaller size
                blocks.append(((l / e.n_layers, -e.total_bytes), e.session_id, l))
        blocks.sort(key=lambda b: b[0], reverse=True)
        evicted = []
        freed = 0
        for _, sid, l in blocks:
            if freed >= bytes_needed:
                break
            e = self.entries[sid]
            dst = HOST if not e.on_disk and self.free(HOST) > e.bytes_per_layer \
                else (HOST if self.free(HOST) > e.bytes_per_layer else DISK)
            freed += self.move_layer(sid, l, dst)
            evicted.append((sid, l))
        return evicted

    # -- invariant ---------------------------------------------------------------

    def check(self) -> None:
        """Byte-conservation invariant: per-tier accounting equals the sum
        over entries (layer placements + persistent disk copies), the
        per-kind breakdown partitions each tier total exactly, and no
        counter ever goes negative."""
        for tier in TIER_ORDER:
            expect_kind: Dict[str, int] = {}
            for e in self.entries.values():
                n = sum(1 for t in e.tier if t == tier)
                if tier == DISK and e.on_disk:
                    n += e.n_layers
                if n:
                    expect_kind[e.kind] = expect_kind.get(e.kind, 0) \
                        + n * e.bytes_per_layer
            expect = sum(expect_kind.values())
            assert self.used[tier] >= 0, f"{tier}: negative accounting"
            assert self.used[tier] == expect, \
                f"{tier}: used={self.used[tier]} expected={expect}"
            assert self.used_kind[tier] == expect_kind, \
                f"{tier}: per-kind {self.used_kind[tier]} != {expect_kind}"

    # -- queries -----------------------------------------------------------------

    def hbm_resident_layers(self, session_id: str) -> int:
        e = self.entries.get(session_id)
        if e is None:
            return 0
        return sum(1 for t in e.tier if t == HBM)

    def lowest_tier(self, session_id: str) -> str:
        e = self.entries[session_id]
        worst = HBM
        for t in e.tier:
            if TIER_ORDER.index(t) > TIER_ORDER.index(worst):
                worst = t
        return worst
