"""Execution backends for the serving engine.

One `Backend` protocol, two implementations, selected at engine
construction — the engine's control flow (token-budget admission, chunked
continuation prefill, batched decode, cooperative purge, preemption) is
identical in both modes:

* `SimBackend` — every step charges CostModel seconds and no tensor moves.
  This is the discrete-event simulator's backend.
* `RealBackend` — owns ONE stacked physical page pool per side
  ((L, P+1, page, Hkv, D) tensors on the card; page index P is a trash
  page for padded-lane scatter) and executes one engine iteration as one
  (or, under context skew, two) mixed-batch `DenseLM.step_paged` calls: a
  MIXED batch where each lane carries (q_len, ctx_len) — decode lanes are
  the q_len = 1 special case, prefill lanes carry this step's chunk of new
  prompt tokens — with the KV scatter, the paged attention kernel and the
  FFN on every layer, returning argmax token ids computed on the device.
  Dispatch is SHAPE-BUCKETED exactly as in the JAX package — lane count,
  tokens-per-step and block-table width padded to powers of two — so the
  bucket census (`compile_counts`) stays comparable.

Per-layer `PagedAllocator`s are the placement bookkeeping; `TieredKVStore`
(via the attached NodeManager) stays the single source of truth for
placement accounting.

Token-id semantics in real mode (the "pending token" invariant): the last
generated token of a sequence never has KV written — it is fed as the next
step's input.  A turn's first chunk therefore consumes [pending] +
prompt slice; mid-prompt chunks emit nothing (their tokens' KV is written,
no token is sampled); the FINAL chunk emits one token; each decode consumes
the pending token, writes its KV, and emits the next.

CROSS-SESSION PREFIX SHARING (copy-on-write): completed sessions register
their page-aligned token-id chunks in the store's `PrefixIndex`; at
admission `adopt_prefix` maps a new request's longest indexed prefix onto
the donor's RESIDENT pages (`PagedAllocator.share`: refcount + 1, zero
copies, zero prefill for the shared span) after verifying the donor's
actual token ids.  The shared span may end mid-page; the first WRITE into a
page whose refcount is > 1 triggers a CoW fork inside `step()`: the
allocator remaps the writer to a fresh page and `DenseLM.fork_paged` copies
the page contents on the device, so readers never observe the writer's
tokens.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
tier movement — `swap_out`, `evict_layer`, `prefetch`, a `persist` with a
spool, `export_session`/`import_session`, `recover_session`, `crash` — and
the int8 tier (`quantize_session`).  The in-flight transfer plumbing
(`TransferEngine`) is kept so the engine's drain points run unchanged;
nothing is launched into it yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.memory import PrefixIndex
from repro_torch.models.transformer import resolve_device
from repro_torch.serving.cost_model import CostModel
from repro_torch.serving.kv_cache import OutOfPages, PagedAllocator
from repro_torch.serving.transfer import OUT, TransferEngine

_TIER_MOVEMENT = "ROADMAP A.4 (tier movement)"
_INT8_TIER = "ROADMAP A.5 (int8 tier)"


def _not_ported(what: str, item: str):
    return NotImplementedError(f"RealBackend.{what} is not ported yet: {item}")


@dataclass
class LaneWork:
    """One lane of a mixed serving step (the engine -> backend contract).

    A decode lane is ``new_tokens=0, final=True, is_decode=True``; a
    chunked-prefill lane consumes ``prompt_ids[start : start+new_tokens]``
    and is ``final`` only on the chunk that exhausts the prompt (that chunk
    emits the turn's first token).  ``first`` marks the request's first
    step since (re)admission — the step that pays any residual KV-fetch
    stall."""
    req: object                  # InferenceRequest
    new_tokens: int = 0          # prompt tokens consumed this step
    start: int = 0               # offset of this chunk into req.prompt_ids
    cached: int = 0              # engine-view context before this step
    final: bool = True           # emits a token (decode, or last chunk)
    first: bool = False          # first step since (re)admission
    is_decode: bool = False      # an already-emitting lane (TBT-sensitive)


@dataclass
class StepResult:
    duration: float          # seconds this fused step occupied the node
    stall: float = 0.0       # portion spent waiting on KV fetch/swap-in


class Backend:
    """Protocol: what one engine iteration needs from an execution backend."""

    # -- capacity accounting (engine admission control) ---------------------
    def session_kv_bytes(self, tokens: int) -> float:
        raise NotImplementedError

    def hbm_kv_budget(self) -> float:
        raise NotImplementedError

    def kv_in_use(self, running) -> float:
        raise NotImplementedError

    def resident_kv_bytes(self, sid: str) -> float:
        """Fast-tier bytes this session already occupies (so admission does
        not count them twice).  Sim sessions are tracked in the store, not
        the engine — nothing to discount."""
        return 0.0

    # -- one engine iteration ----------------------------------------------
    def step(self, lanes: List[LaneWork], now: float) -> StepResult:
        """Execute ONE mixed iteration (decode lanes + prefill chunks)."""
        raise NotImplementedError

    def plan_fits(self, lanes: List[LaneWork]) -> bool:
        """Would `step(lanes)`'s all-or-nothing page allocation succeed?
        Admission uses this for bounded lookahead past page-fragmentation-
        blocked queue heads.  Sim has no pages — byte-level admission checks
        already gate capacity."""
        return True

    # -- async tier transfers (sim: nothing physically in flight) -----------
    def poll_transfers(self) -> None:
        """Non-blocking: run completion bookkeeping for any in-flight tier
        transfer whose copy already finished."""

    def drain_transfers(self, kind: Optional[str] = None) -> None:
        """Blocking fence of all in-flight transfers (of one kind)."""

    # -- cross-session prefix sharing (sim: no pages to share) --------------
    def adopt_prefix(self, req) -> int:
        """Attach the longest indexed shared prefix of ``req.prompt_ids``
        to existing resident pages (copy-on-write); returns the shared
        token count (0: nothing adopted).  Idempotent per session — a
        request re-examined by admission adopts at most once."""
        return 0

    def prefix_match_tokens(self, prompt_ids) -> int:
        """Non-mutating routing query: how many leading tokens of this
        prompt could be served from pages resident on THIS node."""
        return 0

    # -- preemption / lifecycle --------------------------------------------
    def quantize_session(self, sid: str) -> int:
        """Demote a session's full KV pages into the quantized-in-HBM tier
        (INT8 shadow pages + per-page scales, served with in-kernel
        dequant); returns the HBM ledger bytes freed.  0 = nothing to
        compress, or the backend has no quantized tier (sim sessions are
        repriced by the NodeManager directly)."""
        return 0

    def swap_out(self, sid: str, n_tokens: int) -> None:
        pass

    def drop(self, sid: str) -> None:
        pass

    def finish(self, req, now: float) -> None:
        pass

    # -- node-manager hooks (real page copies; sim: accounting only) --------
    def evict_layer(self, sid: str, layer: int) -> None:
        pass

    def prefetch(self, sid: str, layers: List[int]) -> Optional[List[int]]:
        """Advisory-path swap-in: enqueue async host->device copies for as
        many of ``layers`` (in priority order) as physically fit; returns
        the launched prefix.  None means "no physical pages" (sim): every
        planned layer moves in accounting."""
        return None

    def persist(self, sid: str) -> bool:
        """Write-through a complete copy to the slowest tier; returns
        whether the write is underway/exists (sim: the modeled write always
        happens).  Real mode launches the gather asynchronously — recovery
        is gated on the physically written file, never on this flag."""
        return True

    def export_session(self, sid: str) -> Optional[dict]:
        return None

    def import_session(self, sid: str, payload: dict) -> None:
        pass

    # -- fault tolerance (sim: accounting-only, nothing physical to lose) ---
    def crash(self) -> None:
        pass

    def spool_exists(self, sid: str) -> bool:
        """Does a physically written spool copy exist right now?  Sim has
        no files — the store's modeled accounting is the only truth."""
        return False

    def recover_session(self, sid: str) -> Optional[dict]:
        return None


class SimBackend(Backend):
    """CostModel-timed backend: the simulator's execution model, verbatim.

    Mixed-step semantics mirror the real backend's single fused dispatch:
    one `step` charges `CostModel.mixed_step_time` for its decode lanes and
    prefill chunks together, plus the residual layer-wise KV-fetch stall
    (`NodeManager.kv_stall`, built on `CostModel.overlap_stall`) of any
    lane on its first step since admission — the sim-mode analogue of the
    real backend fencing its in-flight swap-in futures."""

    def __init__(self, cost: CostModel, mgr):
        self.cost = cost
        self.mgr = mgr

    def session_kv_bytes(self, tokens: int) -> float:
        return self.cost.session_kv_bytes(tokens)

    def hbm_kv_budget(self) -> float:
        return self.cost.hbm_kv_budget()

    def kv_in_use(self, running) -> float:
        return sum(self.cost.session_kv_bytes(r.ctx_tokens) for r in running)

    def step(self, lanes, now):
        chunks = [(ln.new_tokens, ln.cached) for ln in lanes
                  if ln.new_tokens > 0]
        decode = [ln for ln in lanes if ln.new_tokens == 0 and ln.final]
        compute = self.cost.mixed_step_time(
            chunks, len(decode), sum(ln.cached for ln in decode),
            decode_ctx=[ln.cached for ln in decode])
        # residual stall for cached KV not yet HBM-resident (layer-wise);
        # lanes fetching concurrently overlap within the one fused step
        stall = max((self.mgr.kv_stall(ln.req.session_id, now, compute)
                     for ln in lanes if ln.first and ln.cached > 0),
                    default=0.0)
        return StepResult(compute + stall, stall)


# ---------------------------------------------------------------------------
# Real execution
# ---------------------------------------------------------------------------

@dataclass
class _SeqState:
    n_kv: int = 0                       # tokens whose KV is written in pools
    last_token: Optional[int] = None    # pending token (KV not yet written)
    priority: int = 0
    # token ids whose KV is written, in order (len == n_kv): the substrate
    # of prefix sharing — registered in the PrefixIndex at finish, and the
    # ground truth adopt_prefix verifies candidate matches against
    ids: List[int] = field(default_factory=list)


def _bucket(n: int, floor: int = 1) -> int:
    """Smallest power-of-two >= n (and >= floor): the shape-bucket lattice."""
    b = floor
    while b < n:
        b <<= 1
    return b


class RealBackend(Backend):
    """Real PyTorch execution over a stacked paged KV pool on ``device``.

    The "HBM" tier is one (L, P+1, page, Hkv, D) pool per side (page index
    P is the trash page that padded lanes scatter into — it is never
    allocated, so it never appears in a block table).  One PagedAllocator
    per layer hands out pages; in this slice every layer moves in lockstep.

    ``trace_logits`` keeps the per-token (sid, logits) trail the parity
    tests diff against the dense reference.  It costs a full-logits host
    copy per step, so benchmarks and chip_smoke.py turn it off; with it off
    the only per-dispatch host sync is the argmax token ids.

    ``device`` defaults to the card and raises on a machine without one;
    pass ``device="cpu"`` to serve with the plain attention on the CPU.
    ``kernel_mode`` is passed to `DenseLM.step_paged` (auto | ref).
    """

    def __init__(self, cfg, model, params, *, n_pages: int = 64,
                 page_size: int = 8, kernel_mode: str = "auto",
                 spool_dir: Optional[str] = None, mgr=None,
                 trace_logits: bool = True, split_skew: float = 4.0,
                 device="cuda"):
        if spool_dir is not None:
            raise _not_ported("spool_dir", _TIER_MOVEMENT)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model
        self.params = params
        self.n_pages = n_pages
        self.page_size = page_size
        self.kernel_mode = kernel_mode
        self.trace_logits = trace_logits
        # context-aware lane packing: when the bucketed table-width skew
        # (widest lane's bucket over the median lane's bucket) reaches this
        # ratio, step() splits the batch into two sub-dispatches so one
        # resumed long session stops inflating Tb for every short decode
        # lane.  <= 1 disables splitting (always one dispatch).
        self.split_skew = float(split_skew)
        self.dtype = model.dtype
        L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
        shape = (L, n_pages + 1, page_size, Hkv, D)
        self.k_pool = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.alloc: List[PagedAllocator] = [
            PagedAllocator(n_pages, page_size) for _ in range(L)]
        self.seqs: Dict[str, _SeqState] = {}
        self.transfers = TransferEngine()
        self.spool = None
        self.mgr = None
        self._local_prefix: Optional[PrefixIndex] = None
        if mgr is not None:
            self.attach(mgr)
        self.stats = dict(prefills=0, decode_steps=0, prefix_hits=0,
                          shared_tokens=0, cow_forks=0, sub_dispatches=0,
                          split_steps=0, kv_pages=0, grid_pages=0)
        self.logit_trace: List[Tuple[str, np.ndarray]] = []

    def compile_counts(self) -> Dict[str, int]:
        """Distinct shape buckets of the fused serving step ("step") and of
        the CoW fork ("fork"); shared across backends serving the same
        model."""
        return self.model.paged_compile_counts()

    def attach(self, mgr) -> None:
        """Bidirectional wiring with the node manager."""
        self.mgr = mgr
        mgr.attach_backend(self)

    @property
    def prefix(self) -> PrefixIndex:
        """The node's prefix index.  Lives in the TieredKVStore (the store
        owns all cross-session placement state); a manager-less backend
        keeps a local one so sharing still works in unit harnesses."""
        if self.mgr is not None:
            store = self.mgr.store
            if store.prefix is None or store.prefix.page_size != self.page_size:
                store.prefix = PrefixIndex(self.page_size)
            return store.prefix
        if self._local_prefix is None:
            self._local_prefix = PrefixIndex(self.page_size)
        return self._local_prefix

    # -- sizes --------------------------------------------------------------

    @property
    def _token_bytes(self) -> int:
        c = self.cfg
        return c.n_layers * 2 * c.n_kv_heads * c.d_head * self.dtype.itemsize

    @property
    def _layer_page_bytes(self) -> int:
        c = self.cfg
        return self.page_size * 2 * c.n_kv_heads * c.d_head \
            * self.dtype.itemsize

    def session_kv_bytes(self, tokens: int) -> float:
        pages = self.alloc[0].pages_for(max(int(tokens), 0))
        return pages * self.page_size * self._token_bytes

    def hbm_kv_budget(self) -> float:
        return self.n_pages * self.page_size * self._token_bytes

    def pool_device_bytes(self) -> int:
        """Physical bytes of the stacked pools (both sides)."""
        return 2 * self.k_pool.numel() * self.k_pool.element_size()

    def kv_in_use(self, running) -> float:
        return float(max(a.used_pages for a in self.alloc)
                     * self._layer_page_bytes * self.cfg.n_layers)

    def resident_kv_bytes(self, sid: str) -> float:
        pages = min(len(a.seqs[sid].pages) if sid in a.seqs else 0
                    for a in self.alloc)
        return float(pages * self._layer_page_bytes * self.cfg.n_layers)

    def session_tokens(self, sid: str) -> int:
        """Sequence length incl. the pending token (what the next turn's
        cached_tokens should be)."""
        st = self.seqs.get(sid)
        if st is None:
            return 0
        return st.n_kv + (1 if st.last_token is not None else 0)

    # -- cross-session prefix sharing (copy-on-write) -----------------------

    def _find_prefix(self, ids: List[int], exclude: Optional[str] = None
                     ) -> Tuple[Optional[str], int]:
        """Longest indexed-AND-VERIFIED shared span of ``ids``: (donor sid,
        shared token count).  The index is a hint — hash collisions and
        stale entries are rejected here by checking the donor's actual
        token history, then the span extends TOKEN-WISE into the donor's
        partial last page (so divergence mid-page still shares the page,
        CoW-forked on first write).  Capped at len(ids) - 1: the adopter
        must keep at least one token to process (the pending-token
        invariant forbids zero-token lanes)."""
        ps = self.page_size
        if len(ids) < ps + 1:
            return None, 0
        limit = len(ids) - 1
        donor, depth = self.prefix.lookup(ids[:limit], exclude=exclude)
        if donor is None:
            return None, 0
        dst = self.seqs.get(donor)
        if dst is None or dst.ids[:depth * ps] != list(ids[:depth * ps]):
            return None, 0               # stale index entry / hash collision
        m = depth * ps
        stop = min(len(dst.ids), limit)
        while m < stop and dst.ids[m] == ids[m]:
            m += 1
        npages = self.alloc[0].pages_for(m)
        for a in self.alloc:
            s = a.seqs.get(donor)
            if s is None or len(s.pages) < npages or s.n_tokens < m:
                return None, 0           # donor (partially) evicted
        return donor, m

    def prefix_match_tokens(self, prompt_ids) -> int:
        _, m = self._find_prefix(list(prompt_ids or []))
        return m

    def adopt_prefix(self, req) -> int:
        """Attach ``req``'s longest verified shared prefix to the donor's
        resident pages: `PagedAllocator.share` on every layer (refcount + 1,
        zero copies), a new `_SeqState` already holding the shared span.
        The engine then trims the request's prompt by the returned count —
        the shared tokens are never prefilled."""
        sid = req.session_id
        if sid in self.seqs:
            return 0                     # re-examined admission: at most once
        ids = list(req.prompt_ids or [])
        donor, m = self._find_prefix(ids, exclude=sid)
        if m <= 0:
            return 0
        npages = self.alloc[0].pages_for(m)
        for a in self.alloc:
            a.share(sid, a.seqs[donor].pages[:npages], m)
        self.seqs[sid] = _SeqState(n_kv=m, ids=list(ids[:m]),
                                   priority=req.priority)
        self.stats["prefix_hits"] += 1
        self.stats["shared_tokens"] += m
        return m

    # -- transfer plumbing (the engine's drain points) ----------------------

    def poll_transfers(self) -> None:
        self.transfers.poll()

    def drain_transfers(self, kind: Optional[str] = None) -> None:
        self.transfers.fence(kind=kind)

    # -- engine iteration ---------------------------------------------------

    def _lane_ids(self, lane: LaneWork) -> List[int]:
        """Token ids this lane processes: the pending token (whose KV is
        written by this step) leads, then this chunk's slice of the prompt.
        A decode lane is the pending token alone."""
        st = self.seqs[lane.req.session_id]
        ids = [] if st.last_token is None else [st.last_token]
        if lane.new_tokens:
            if lane.req.prompt_ids is None:
                # a drop-preempted request re-enters with prompt_tokens > 0
                # but no ids — the driver must resubmit the token history;
                # serving a made-up context instead would silently corrupt
                # the session
                raise ValueError(
                    f"{lane.req.session_id}: {lane.new_tokens} prompt "
                    f"tokens requested but prompt_ids is None — resubmit "
                    f"the request with its full token history")
            ids.extend(lane.req.prompt_ids[lane.start:
                                           lane.start + lane.new_tokens])
        return ids

    def _fork_need(self, a: PagedAllocator, sid: str) -> int:
        """Pages a CoW fork will consume in allocator ``a`` when ``sid``
        next writes: 1 iff its write position lands mid-page in a page
        other holders still reference."""
        st = self.seqs.get(sid)
        if st is None or st.n_kv % self.page_size == 0:
            return 0
        s = a.seqs.get(sid)
        if s is None:
            return 0
        pi = st.n_kv // self.page_size
        if pi < len(s.pages) and a.refcount_of(s.pages[pi]) > 1:
            return 1
        return 0

    def _plan_fits_now(self, lanes) -> bool:
        for a in self.alloc:
            need = 0
            for ln in lanes:
                sid = ln.req.session_id
                st = self.seqs.get(sid)
                q = ln.new_tokens + (1 if st is not None
                                     and st.last_token is not None else 0)
                if st is not None and sid in a.seqs:
                    s = a.seqs[sid]
                    need += a.pages_for(s.n_tokens + q) - len(s.pages)
                    need += self._fork_need(a, sid)
                else:
                    base = st.n_kv if st is not None else 0
                    need += a.pages_for(base + q)
            if need > len(a.free_list):
                return False
        return True

    def plan_fits(self, lanes) -> bool:
        """Mirror of step()'s all-or-nothing page check, without mutating.
        Completed-but-unreaped transfers are reaped first; a shortfall with
        swap-outs still in flight reclaims their leased pages (blocking)
        before giving up."""
        self.transfers.poll()
        if self._plan_fits_now(lanes):
            return True
        if self.transfers.pending_kind(OUT):
            self.transfers.fence(kind=OUT)
            return self._plan_fits_now(lanes)
        return False

    def _pack_lanes(self, widths: List[int]) -> List[np.ndarray]:
        """Context-aware lane packing: lane indices grouped into the sub-
        dispatches one engine step issues — normally ONE group, split into
        exactly TWO when the bucketed table-width skew (widest lane's
        power-of-two bucket over the median lane's) reaches ``split_skew``.
        The decision reads BUCKETED widths only, so a lane growing within
        its bucket can never flip the split on and off between steps."""
        B = len(widths)
        if B < 2 or self.split_skew <= 1.0:
            return [np.arange(B)]
        order = sorted(range(B), key=lambda i: widths[i])
        tb_med = _bucket(max(widths[order[(B - 1) // 2]], 1))
        tb_max = _bucket(max(widths[order[-1]], 1))
        if tb_max < self.split_skew * tb_med:
            return [np.arange(B)]
        short = [i for i in order if _bucket(max(widths[i], 1)) <= tb_med]
        long = [i for i in order if _bucket(max(widths[i], 1)) > tb_med]
        return [np.asarray(short), np.asarray(long)]

    def _dispatch_lanes(self, sids: List[str], ids_by_lane: List[List[int]]
                        ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Assemble and run ONE bucketed ``step_paged`` call over the given
        lanes; returns (token ids (B,), logits (B, V) or None).  The pools
        are updated in place, so two sub-dispatches chain exactly like two
        engine steps would."""
        L = self.cfg.n_layers
        B = len(sids)
        q_lens = [len(ids) for ids in ids_by_lane]
        # tokens-per-step bucket: pure-decode groups sit at Sq = 1, chunked
        # groups land on the power-of-two lattice (no floor: every lane in
        # the group pays Sqb query rows)
        Sqb = _bucket(max(q_lens))
        Bb = _bucket(B)                          # lane-count shape bucket
        Tb = _bucket(max(len(self.alloc[0].seqs[s].pages) for s in sids))
        ids_p = np.zeros((Bb, Sqb), np.int32)
        qoff = np.zeros((Bb,), np.int32)
        ctx = np.zeros((Bb,), np.int32)          # padded lanes: ctx 0 -> masked
        last = np.zeros((Bb,), np.int32)
        tables = np.zeros((L, Bb, Tb), np.int32)
        # padded slots scatter into the trash page (index n_pages)
        pg = np.full((L, Bb, Sqb), self.n_pages, np.int32)
        off = np.zeros((L, Bb, Sqb), np.int32)
        for i, (sid, ids) in enumerate(zip(sids, ids_by_lane)):
            st = self.seqs[sid]
            n = len(ids)
            ids_p[i, :n] = ids
            qoff[i] = st.n_kv
            ctx[i] = st.n_kv + n
            last[i] = n - 1
            pages = np.asarray([self.alloc[l].seqs[sid].pages
                                for l in range(L)], np.int32)
            w = pages.shape[1]
            tables[:, i, :w] = pages
            # pad table columns with the lane's LAST VALID page id, as
            # PagedAllocator.block_table does; the kernel never reads them
            if w:
                tables[:, i, w:] = pages[:, -1:]
            pos = st.n_kv + np.arange(n)
            pg[:, i, :n] = pages[:, pos // self.page_size]
            off[:, i, :n] = pos % self.page_size
        # page-walk accounting (per kv head): the kernel reads each lane's
        # own relevant pages; the bucket spans Bb x Tb
        self.stats["kv_pages"] += int(
            sum(-(-int(c) // self.page_size) for c in ctx[:B]))
        self.stats["grid_pages"] += Bb * Tb
        self.stats["sub_dispatches"] += 1
        dev = self.device
        toks, logits = self.model.step_paged(
            self.params, torch.from_numpy(ids_p).to(dev), self.k_pool,
            self.v_pool, torch.from_numpy(tables).to(dev),
            torch.from_numpy(qoff).to(dev), torch.from_numpy(ctx).to(dev),
            torch.from_numpy(last).to(dev), torch.from_numpy(pg).to(dev),
            torch.from_numpy(off).to(dev), kernel_mode=self.kernel_mode)
        # the one host sync of a dispatch: the token ids (and the logits
        # only when tracing)
        tok_np = toks[:B].cpu().numpy()
        lg_np = None
        if self.trace_logits:
            lg_np = logits[:B, :self.cfg.vocab].float().cpu().numpy()
        return tok_np, lg_np

    def step(self, lanes, now) -> StepResult:
        # reap ready transfers BEFORE the timed region, as the JAX backend
        self.transfers.poll()
        t0 = time.perf_counter()
        for ln in lanes:
            sid = ln.req.session_id
            if ln.req.output_ids is None:
                ln.req.output_ids = []
            st = self.seqs.get(sid)
            if st is None:
                st = self.seqs[sid] = _SeqState(priority=ln.req.priority)
                for a in self.alloc:
                    a.allocate(sid, 0)
            elif any(sid not in a.seqs for a in self.alloc):
                # only tier movement (not ported) takes layers off the pools
                raise _not_ported("step of a non-resident session",
                                  _TIER_MOVEMENT)
            e = self._store_entry(sid)
            if e is not None:
                e.pinned = True      # serving: not migratable/evictable

        ids_by_lane = [self._lane_ids(ln) for ln in lanes]
        for ln, ids in zip(lanes, ids_by_lane):
            if not ids:
                raise ValueError(f"{ln.req.session_id}: lane with no tokens "
                                 f"to process")
        sids = [ln.req.session_id for ln in lanes]

        # all-or-nothing growth across the whole mixed batch: check every
        # layer before mutating any allocator
        def _shortfall(a):
            return sum(a.pages_for(a.seqs[s].n_tokens + len(ids))
                       - len(a.seqs[s].pages) + self._fork_need(a, s)
                       for s, ids in zip(sids, ids_by_lane)) \
                - len(a.free_list)
        for attempt in (0, 1):
            worst = max(_shortfall(a) for a in self.alloc)
            if worst <= 0:
                break
            if attempt == 0 and self.transfers.pending_kind(OUT):
                self.transfers.fence(kind=OUT)
                continue
            raise OutOfPages(f"step: need {worst} pages beyond the free "
                             f"list")
        # COPY-ON-WRITE forks, before any table is built: a lane whose
        # write position lands mid-page in a page other holders still
        # reference gets a private copy — the allocator remaps the block-
        # table entry, one bucketed in-place device copy moves the contents.
        # Writes at a page boundary never fork (the new page is private).
        forks: List[Tuple[int, int, int]] = []       # (layer, src, dst)
        for sid in sids:
            st = self.seqs[sid]
            if st.n_kv % self.page_size == 0:
                continue
            pi = st.n_kv // self.page_size
            for l, a in enumerate(self.alloc):
                if pi >= len(a.seqs[sid].pages):
                    continue
                r = a.fork_cow(sid, pi)
                if r is not None:
                    forks.append((l, r[0], r[1]))
                    self.stats["cow_forks"] += 1
        if forks:
            Fb = _bucket(len(forks))
            f = np.zeros((3, Fb), np.int32)
            f[1:] = self.n_pages                     # pad: trash -> trash
            f[:, :len(forks)] = np.asarray(forks, np.int32).T
            fd = torch.from_numpy(f).to(self.device)
            self.model.fork_paged(self.k_pool, self.v_pool, fd[0], fd[1],
                                  fd[2])
        for sid, ids in zip(sids, ids_by_lane):
            self._extend_all(sid, len(ids))

        B = len(lanes)
        # per-lane table widths from LAYER 0: every layer grows in
        # lockstep, so layer 0's page count is THE page count
        widths = [len(self.alloc[0].seqs[s].pages) for s in sids]
        groups = self._pack_lanes(widths)
        if len(groups) > 1:
            self.stats["split_steps"] += 1
        tok_np = np.zeros((B,), np.int32)
        lg_np = (np.zeros((B, self.cfg.vocab), np.float32)
                 if self.trace_logits else None)
        for g in groups:
            toks, lg = self._dispatch_lanes([sids[i] for i in g],
                                            [ids_by_lane[i] for i in g])
            tok_np[g] = toks
            if lg_np is not None:
                lg_np[g] = lg
        any_decode = False
        for i, (ln, ids) in enumerate(zip(lanes, ids_by_lane)):
            st = self.seqs[ln.req.session_id]
            st.n_kv += len(ids)
            st.ids.extend(ids)
            if ln.final:
                if lg_np is not None:
                    self.logit_trace.append((ln.req.session_id, lg_np[i]))
                tok = int(tok_np[i])
                st.last_token = tok
                ln.req.output_ids.append(tok)
            else:
                st.last_token = None     # mid-prompt: nothing sampled
            if ln.is_decode:
                any_decode = True
            elif ln.final:
                self.stats["prefills"] += 1
        if any_decode:
            self.stats["decode_steps"] += 1
        # nothing is fetched from another tier yet, so no step stalls
        return StepResult(time.perf_counter() - t0, stall=0.0)

    def _extend_all(self, sid: str, n: int) -> None:
        """Grow every layer's allocation by n tokens, all-or-nothing."""
        if n <= 0:
            return
        for a in self.alloc:
            s = a.seqs[sid]
            need = a.pages_for(s.n_tokens + n) - len(s.pages)
            if need > len(a.free_list):
                raise OutOfPages(
                    f"{sid}: need {need} pages, have {len(a.free_list)}")
        for a in self.alloc:
            a.extend(sid, n)

    def _store_entry(self, sid: str):
        if self.mgr is None:
            return None
        return self.mgr.store.entries.get(sid)

    # -- lifecycle ----------------------------------------------------------

    def drop(self, sid: str) -> None:
        # shared pages survive the free(): refcounting keeps any page a
        # sharer still references out of the free list, and the prefix
        # index forgets this donor so no later admission adopts from it
        self.transfers.poison(sid=sid, release=True)
        self.prefix.drop(sid)
        for a in self.alloc:
            a.free(sid)
        self.seqs.pop(sid, None)

    def finish(self, req, now) -> None:
        """Request completed: register the session's token history in the
        prefix index (it becomes a donor) and sync the store's view."""
        sid = req.session_id
        st = self.seqs.get(sid)
        if st is not None and st.n_kv > 0 and len(st.ids) == st.n_kv:
            self.prefix.register(sid, st.ids)
        if self.mgr is None:
            return
        # the bytes ledger charges each SHARED page to its first owner only
        # — a sharer accounts its private pages; the physical allocator
        # (used_pages) remains the real capacity gate either way
        a0 = self.alloc[0]
        pages = a0.seqs[sid].pages
        private = sum(1 for p in pages if a0.refcount_of(p) == 1)
        shared_tok = min((len(pages) - private) * self.page_size,
                         st.n_kv if st is not None else 0)
        self.mgr.mark_resident(sid, self.session_tokens(sid),
                               private * self._layer_page_bytes,
                               priority=req.priority,
                               shared_tokens=shared_tok)
        e = self._store_entry(sid)
        if e is not None:
            e.pinned = False         # idle again: migratable between turns

    def persist(self, sid: str) -> bool:
        """Disk write-through.  With no spool (the only configuration this
        slice builds) there is no persistent copy to claim: False, as in
        the JAX backend."""
        if self.spool is None:
            return False
        raise _not_ported("persist", _TIER_MOVEMENT)

    # -- not ported yet ----------------------------------------------------

    def quantize_session(self, sid: str) -> int:
        raise _not_ported("quantize_session", _INT8_TIER)

    def swap_out(self, sid: str, n_tokens: int) -> None:
        raise _not_ported("swap_out", _TIER_MOVEMENT)

    def evict_layer(self, sid: str, layer: int) -> None:
        raise _not_ported("evict_layer", _TIER_MOVEMENT)

    def prefetch(self, sid: str, layers: List[int]) -> Optional[List[int]]:
        raise _not_ported("prefetch", _TIER_MOVEMENT)

    def export_session(self, sid: str) -> Optional[dict]:
        raise _not_ported("export_session", _TIER_MOVEMENT)

    def import_session(self, sid: str, payload: dict) -> None:
        raise _not_ported("import_session", _TIER_MOVEMENT)

    def recover_session(self, sid: str) -> Optional[dict]:
        raise _not_ported("recover_session", _TIER_MOVEMENT)

    def crash(self) -> None:
        raise _not_ported("crash", _TIER_MOVEMENT)


def make_backend(cfg, model, params, **kw):
    """Real-backend factory.  The dense family serves through `RealBackend`;
    the recurrent and hybrid families' `StateBackend` is not ported yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"make_backend: family {cfg.family!r} is not ported yet "
            f"(ROADMAP A.7 for mamba2/xlstm/hybrid, A.9 for the others)")
    return RealBackend(cfg, model, params, **kw)
