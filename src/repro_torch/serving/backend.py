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

TIER MOVEMENT (HBM <-> pinned host <-> disk spool, and export/import
between nodes) runs through `TransferEngine` futures.  Stream ordering
takes the place of the JAX package's data dependencies:

* device -> host: the gather runs on the compute stream (a private copy of
  the session's valid token range, int8 pages dequantized on the way out),
  then a side copy stream that has waited on the compute stream copies it
  into pinned host memory; the transfer's `EventBuffer` holds both tensors
  until the copy's event fires;
* host -> device: the side stream copies pinned host tensors into a device
  staging tensor; the compute stream waits on that copy and does the
  in-place `index_put_` into the pools, so every pool write stays ordered
  on ONE stream (a scatter can never race a step that reuses a dropped
  session's pages).

Host payloads are ``{k, v, n_tokens}`` with k/v (n, Hkv, D) CPU tensors in
the model dtype (pinned when they came off the card).  At the spool and
export boundary they become numpy: float32/float16 as they are, bfloat16
beside a ``dtype`` entry, since numpy has no bfloat16 — in the spool as
its raw 16-bit pattern (uint16), in an export widened to float32 (exact),
which the JAX package's import casts back to the same bits where it would
read uint16 as numbers.  A bfloat16 array the JAX package made (ml_dtypes)
is read by viewing its bits as uint16.

TENSOR-PARALLEL NODE (``mesh=``, a 1-D ``("model",)`` mesh from
`launch.mesh.make_serving_mesh`): one node is tp shards serving one
replica, driven by this one process.  The pools are cut by
`ShardingPlan.pool_spec` (kv heads over the shards when divisible, else
the split-K rung: each shard holds a slice of every page's rows, else the
head-feature rung: each shard holds a slice of every row's features), the
int8 shadow pools like them, the per-page scales replicated; the weights
by the plan's column/row specs.  Every dispatch passes ``layout=`` to the model,
which runs each shard's part and the collectives between them
(`DenseLM.step_paged_tp`).  Tier movement gathers every shard's part of a
session and concatenates it to full heads before the host copy, and a
scatter cuts a full-head payload into the shards, so host, spool and
export payloads do not depend on the shard count (a session exported at
tp = 2 imports at tp = 4).  All byte accounting stays logical;
`pool_device_bytes` is one shard's.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.memory import PrefixIndex
from repro_torch.distributed.sharding import PoolLayout, ShardingPlan
from repro_torch.models.transformer import resolve_device
from repro_torch.serving.cost_model import CostModel
from repro_torch.serving.kv_cache import OutOfPages, PagedAllocator
from repro_torch.serving.transfer import (DONE, IN, OUT, PERSIST,
                                          EventBuffer, PendingPayload,
                                          Transfer, TransferEngine,
                                          copy_to_host)

HBM, HOST = "hbm", "host"


class LostKV(RuntimeError):
    """A session's KV is unreachable in every tier (e.g. its transfer was
    poisoned by a crash).  Raised instead of silently serving a fabricated
    context — the caller must recover from a spool or resubmit history."""


def _np_array(t: torch.Tensor, export: bool = False) -> np.ndarray:
    """A host tensor as numpy for the spool format (bfloat16 as its 16-bit
    pattern, uint16) or, with ``export``, the migration format (bfloat16
    widened to float32); other dtypes as they are."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        if export:
            return t.float().numpy()
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _host_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A host-tier tensor of ``dtype`` from a payload array: a tensor
    passes through; a numpy array with 16-bit elements that are not
    float16 (the port's uint16 pattern, or a JAX-made bfloat16) is read as
    bfloat16 bits."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # e.g. a view of a JAX array
        a = a.copy()
    if a.dtype.itemsize == 2 and a.dtype != np.float16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(dtype)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


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
    allocated, so it never appears in a block table); the host tier is
    ``{k, v, n_tokens}`` CPU-tensor payloads keyed (sid, layer) — or
    `PendingPayload` futures while a device->host copy is in flight; the
    optional disk tier is an .npz spool directory.  One PagedAllocator per
    layer hands out pages — allocators stay in lockstep except where the
    node manager evicted individual layers (the paper's layer-granular
    placement).

    ``trace_logits`` keeps the per-token (sid, logits) trail the parity
    tests diff against the dense reference.  It costs a full-logits host
    copy per step, so benchmarks and chip_smoke.py turn it off; with it off
    the only per-dispatch host sync is the argmax token ids.

    QUANTIZED-IN-HBM TIER (``hbm_pages=``): between fp-HBM and the host
    tier sits an int8 tier that never leaves the device — per-page
    symmetric quantization into lazily allocated shadow pools (one float32
    scale per (layer, page, side)), served directly by the int8 attention
    kernel (no re-inflation copy).  `quantize_session` compresses a
    session's full pages in lockstep across layers with one bucketed
    dispatch; the allocators carry the per-page precision bit, the byte
    ledger prices int8 pages exactly (elements + scales), and every tier
    payload leaving the device re-inflates to fp first, so the host, disk
    and export formats never know the int8 tier exists.  Pass ``hbm_pages <
    n_pages`` to give the node more physical page slots than its fp byte
    budget — the headroom quantized pages make usable.

    ``device`` defaults to the card and raises on a machine without one;
    pass ``device="cpu"`` to serve with the plain attention on the CPU.
    ``kernel_mode`` is passed to `DenseLM.step_paged` (auto | ref).  With
    ``mesh`` (see the module docstring) the mesh's devices replace
    ``device``: shard 0's is where the backend assembles its inputs.
    """

    def __init__(self, cfg, model, params, *, n_pages: int = 64,
                 page_size: int = 8, kernel_mode: str = "auto",
                 spool_dir: Optional[str] = None, mgr=None,
                 trace_logits: bool = True, mesh=None,
                 hbm_pages: Optional[int] = None, split_skew: float = 4.0,
                 device="cuda"):
        self.device = (mesh.model_devices()[0] if mesh is not None
                       else resolve_device(device))
        self.cfg = cfg
        self.model = model
        self.params = params
        self.n_pages = n_pages
        # byte budget, in FULL-PRECISION page units: admission and the store
        # are budgeted for `hbm_pages` worth of fp KV while the pools carry
        # `n_pages` physical page slots; the difference is the int8 tier's
        # headroom.  None keeps both equal.
        self.hbm_pages = n_pages if hbm_pages is None else hbm_pages
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
        # on a mesh the pools (and the int8 pools and scales) are lists of
        # one tensor a shard, and every model call gets the layout
        self.tp, self.plan, self._layout = 1, None, None
        if mesh is not None:
            self.plan = ShardingPlan(cfg, mesh)
            self.tp = self.plan.tp
            self._layout = PoolLayout(self.plan, shape)
            self.params = self.plan.shard_params(params)
            self.k_pool = self._layout.zeros(self.dtype)
            self.v_pool = self._layout.zeros(self.dtype)
        else:
            self.k_pool = torch.zeros(shape, dtype=self.dtype,
                                      device=self.device)
            self.v_pool = torch.zeros(shape, dtype=self.dtype,
                                      device=self.device)
        # int8 tier: shadow pools + per-(layer, page) float32 scales,
        # allocated at the first compress; the precision FLAGS are rebuilt
        # from the allocators' bits at every dispatch, never kept on the
        # device (page reuse can never serve a stale flag)
        self.kq_pool = self.vq_pool = None
        self.k_scale = self.v_scale = None
        self._quant_active = False
        # host<->device copies run here, beside the compute stream
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self.alloc: List[PagedAllocator] = [
            PagedAllocator(n_pages, page_size) for _ in range(L)]
        self.host: Dict[Tuple[str, int], object] = {}  # (sid, layer) ->
        self.seqs: Dict[str, _SeqState] = {}           # payload | Pending
        self.transfers = TransferEngine()
        self.spool = Path(spool_dir) if spool_dir else None
        if self.spool:
            self.spool.mkdir(parents=True, exist_ok=True)
        self.mgr = None
        self._local_prefix: Optional[PrefixIndex] = None
        if mgr is not None:
            self.attach(mgr)
        self.stats = dict(prefills=0, decode_steps=0, swaps_out=0,
                          swaps_in=0, layer_evictions=0, layer_promotions=0,
                          migrations_in=0, copied_bytes=0.0, disk_writes=0,
                          prefix_hits=0, shared_tokens=0, cow_forks=0,
                          quantized_pages=0, quant_dispatches=0,
                          dequant_forks=0, admit_quantized=0,
                          sub_dispatches=0, split_steps=0, kv_pages=0,
                          grid_pages=0)
        self.logit_trace: List[Tuple[str, np.ndarray]] = []

    def compile_counts(self) -> Dict[str, int]:
        """Distinct shape buckets of the fused serving step ("step"), the
        CoW fork ("fork"), the tier scatter ("scatter") and the compress
        ("compress"); shared across backends serving the same model.  A
        meshed backend's keys carry the mesh signature (axis sizes and the
        pool spec), so tp placements of one bucket count apart."""
        return self.model.paged_compile_counts()

    def attach(self, mgr) -> None:
        """Bidirectional wiring: manager promote/evict trigger real copies."""
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

    @property
    def _layer_page_bytes_q(self) -> int:
        """One page's ledger price once quantized: int8 elements plus the
        two per-page float32 scales (k and v) — exact, not a ratio."""
        c = self.cfg
        return self.page_size * 2 * c.n_kv_heads * c.d_head + 2 * 4

    def session_kv_bytes(self, tokens: int) -> float:
        # priced FULL PRECISION: new KV is always written fp (quantization
        # is a later demotion), so admission must reserve the fp bytes
        pages = self.alloc[0].pages_for(max(int(tokens), 0))
        return pages * self.page_size * self._token_bytes

    def hbm_kv_budget(self) -> float:
        return self.hbm_pages * self.page_size * self._token_bytes

    def pool_device_bytes(self) -> int:
        """Physical bytes of the stacked fp pools (both sides) on one
        device: one shard's on a mesh (1/tp of the pool, except on the
        replicated rung).  Observational only: admission and the store
        account the logical bytes above."""
        k = self.k_pool[0] if self._layout is not None else self.k_pool
        return 2 * k.numel() * k.element_size()

    def kv_in_use(self, running) -> float:
        # used_pages includes leased pages: an in-flight swap-out still
        # physically occupies its source pages until the copy lands.
        # Quantized pages are priced at the int8 tier
        return float(max(
            (a.used_pages - len(a.quantized)) * self._layer_page_bytes
            + len(a.quantized) * self._layer_page_bytes_q
            for a in self.alloc)) * self.cfg.n_layers

    def resident_kv_bytes(self, sid: str) -> float:
        # min across layers: never discount pages an evicted layer lacks;
        # quantized pages discount at their int8 price only
        def _layer(a: PagedAllocator) -> int:
            s = a.seqs.get(sid)
            if s is None:
                return 0
            nq = sum(1 for p in s.pages if p in a.quantized)
            return (len(s.pages) - nq) * self._layer_page_bytes \
                + nq * self._layer_page_bytes_q
        return float(min(_layer(a) for a in self.alloc)) * self.cfg.n_layers

    def session_tokens(self, sid: str) -> int:
        """Sequence length incl. the pending token (what the next turn's
        cached_tokens should be)."""
        st = self.seqs.get(sid)
        if st is None:
            return 0
        return st.n_kv + (1 if st.last_token is not None else 0)

    def _i32(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int32)).to(self.device)

    # -- quantized-in-HBM tier ----------------------------------------------

    def _ensure_quant_pools(self) -> None:
        """Allocate the int8 shadow pools and the per-page float32 scales
        at the first compress (a node that never quantizes never pays)."""
        if self._quant_active:
            return
        lay = self._layout
        if lay is not None:            # int8 pools cut like the fp pools,
            def scales(dev):           # the scales replicated
                return torch.zeros(lay.shape[:2], dtype=torch.float32,
                                   device=dev)
            self.kq_pool = lay.zeros(torch.int8)
            self.vq_pool = lay.zeros(torch.int8)
            self.k_scale = lay.replicated(scales)
            self.v_scale = lay.replicated(scales)
            self._quant_active = True
            return
        shape = tuple(self.k_pool.shape)
        dev = self.device
        self.kq_pool = torch.zeros(shape, dtype=torch.int8, device=dev)
        self.vq_pool = torch.zeros(shape, dtype=torch.int8, device=dev)
        self.k_scale = torch.zeros(shape[:2], dtype=torch.float32, device=dev)
        self.v_scale = torch.zeros(shape[:2], dtype=torch.float32, device=dev)
        self._quant_active = True

    def _quant_flags(self) -> torch.Tensor:
        """(L, P+1) int32 precision bits, rebuilt from the allocators at
        every dispatch.  The trash page is never quantized."""
        flags = np.zeros((self.cfg.n_layers, self.n_pages + 1), np.int32)
        for l, a in enumerate(self.alloc):
            if a.quantized:
                flags[l, list(a.quantized)] = 1
        return self._i32(flags)

    def _quant_args(self):
        """The int8 tuple threaded to `step_paged`: None until the first
        compress, so a node that never quantizes keeps the all-fp kernel
        and bucket key."""
        if not self._quant_active:
            return None
        return (self.kq_pool, self.vq_pool, self.k_scale, self.v_scale,
                self._quant_flags())

    def quantize_session(self, sid: str) -> int:
        """Compress the session's FULL pages (never the partial tail —
        writes land there) into the int8 shadow pools: ONE bucketed
        `compress_paged` dispatch quantizes every not-yet-quantized
        (layer, page) in LOCKSTEP across layers, the allocators' precision
        bits flip, and the store entry reprices to the int8 geometry.
        Returns the HBM ledger bytes freed (0: nothing to compress, or a
        layer is evicted and lockstep is impossible)."""
        st = self.seqs.get(sid)
        if st is None:
            return 0
        full = st.n_kv // self.page_size
        if full <= 0:
            return 0
        rows: List[Tuple[int, int]] = []
        for l, a in enumerate(self.alloc):
            s = a.seqs.get(sid)
            if s is None or len(s.pages) < full:
                return 0
            rows.extend((l, p) for p in s.pages[:full]
                        if not a.is_quantized(p))
        if not rows:
            return 0
        self._ensure_quant_pools()
        Rb = _bucket(len(rows))
        r_li = np.zeros((Rb,), np.int32)                # pad rows point at
        r_pg = np.full((Rb,), self.n_pages, np.int32)   # (layer 0, trash)
        r_li[:len(rows)], r_pg[:len(rows)] = np.asarray(rows, np.int32).T
        self.model.compress_paged(self.k_pool, self.v_pool, self.kq_pool,
                                  self.vq_pool, self.k_scale, self.v_scale,
                                  self._i32(r_li), self._i32(r_pg),
                                  layout=self._layout)
        for l, p in rows:
            self.alloc[l].set_quantized(p)
        self.stats["quantized_pages"] += len(rows)
        self.stats["quant_dispatches"] += 1
        self._reprice_store(sid)
        return len(rows) * (self._layer_page_bytes
                            - self._layer_page_bytes_q)

    def _dequantize_session(self, sid: str) -> None:
        """Re-inflate every quantized page of ``sid`` IN PLACE (dequant
        write-back rows, src == dst) and clear its precision bits.  Called
        when layer-granular movement is about to break the lockstep the
        int8 ledger price assumes; the fp pool gets the dequantized values,
        not the pre-compress bytes."""
        rows: List[Tuple[int, int]] = []
        for l, a in enumerate(self.alloc):
            for p in a.quantized_pages_of(sid):
                rows.append((l, p))
                a.set_quantized(p, False)
                self.stats["dequant_forks"] += 1
        if not rows:
            return
        Rb = _bucket(len(rows))
        f_li = np.zeros((Rb,), np.int32)
        f_pg = np.full((Rb,), self.n_pages, np.int32)
        f_q = np.zeros((Rb,), np.int32)
        f_li[:len(rows)], f_pg[:len(rows)] = np.asarray(rows, np.int32).T
        f_q[:len(rows)] = 1
        pg = self._i32(f_pg)
        self.model.fork_paged_quant(self.k_pool, self.v_pool, self.kq_pool,
                                    self.vq_pool, self.k_scale, self.v_scale,
                                    self._i32(f_li), pg, pg, self._i32(f_q),
                                    layout=self._layout)

    def _session_bpl(self, sid: str) -> Tuple[int, int]:
        """Store-entry price of this session's PRIVATE pages: (bytes per
        layer, quantized token count).  Shared pages are charged to their
        first owner (see `finish`); quantized pages at the int8 price."""
        a0 = self.alloc[0]
        s = a0.seqs.get(sid)
        if s is None:
            return 0, 0
        private = [p for p in s.pages if a0.refcount_of(p) == 1]
        nq = sum(1 for p in private if a0.is_quantized(p))
        bpl = (len(private) - nq) * self._layer_page_bytes \
            + nq * self._layer_page_bytes_q
        return bpl, nq * self.page_size

    def _reprice_store(self, sid: str) -> None:
        if self._store_entry(sid) is None:
            return
        bpl, qtok = self._session_bpl(sid)
        self.mgr.store.reprice(sid, bpl, qtok)

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

    # -- async transfer plumbing -------------------------------------------

    def poll_transfers(self) -> None:
        self.transfers.poll()

    def drain_transfers(self, kind: Optional[str] = None) -> None:
        self.transfers.fence(kind=kind)

    def _host_payload(self, sid: str, layer: int) -> Optional[dict]:
        """Host-tier payload for (sid, layer), fencing its in-flight
        gather if one is still draining.  None if absent or poisoned."""
        p = self.host.get((sid, layer))
        if isinstance(p, PendingPayload):
            p = p.get()
        return p

    def _slots(self, layer: int, sid: str, start: int, n: int):
        """(page_ids, offsets) for token positions [start, start+n)."""
        pages = np.asarray(self.alloc[layer].seqs[sid].pages, np.int32)
        pos = start + np.arange(n)
        return pages[pos // self.page_size], \
            np.asarray(pos % self.page_size, np.int32)

    def _copy_to_host(self, tensors):
        """Start device->host copies of ``tensors`` (made on the compute
        stream) into pinned host memory on the copy stream; returns the
        host tensors and the buffer the transfer waits on."""
        return copy_to_host(tensors, self._copy_stream, self.device)

    def _gather_device(self, sid: str, layers: List[int]):
        """Gather the valid token range of many (sid, layer)s on the compute
        stream — one private device copy per side per (n_tokens, n_pages)
        group, int8 pages dequantized on the way out (host payloads are
        always fp) — and START their copies to pinned host memory.
        Padding never crosses the bus or counts in stats.  Returns
        (groups, empties): in-flight groups and zero-page payloads."""
        c = self.cfg
        groups, empties = [], {}
        by: Dict[Tuple[int, int], List[int]] = {}
        for l in layers:
            s = self.alloc[l].seqs[sid]
            by.setdefault((s.n_tokens, len(s.pages)), []).append(l)
        for (n, npg), ls in by.items():
            if npg == 0:
                em = torch.zeros((0, c.n_kv_heads, c.d_head), dtype=self.dtype)
                for l in ls:
                    empties[l] = dict(k=em, v=em, n_tokens=n)
                continue
            pg = np.stack([self._slots(l, sid, 0, n)[0] for l in ls])
            off = self._slots(ls[0], sid, 0, n)[1]
            qf = None
            if self._quant_active:
                qf = np.stack([np.isin(pg[i], list(self.alloc[l].quantized))
                               for i, l in enumerate(ls)])
                if not qf.any():
                    qf = None
            pools = (self.k_pool, self.v_pool, self.kq_pool, self.vq_pool,
                     self.k_scale, self.v_scale)
            if self._layout is None:
                k, v = self._gather_rows(pools, ls, pg, off, qf)
            else:                    # each shard's part, then full heads
                k, v = self._layout.gather(
                    lambda r, o: self._gather_rows(
                        tuple(None if t is None else t[r] for t in pools),
                        ls, pg, o, qf), self._i32(off))
            (hk, hv), buf = self._copy_to_host((k, v))
            groups.append(dict(layers=ls, n=n, k=hk, v=hv, buf=buf))
        return groups, empties

    def _gather_rows(self, pools, ls, pg, off, qf):
        """(k, v) rows (G, n, Hkv, D) of layers ``ls`` at pages ``pg`` (G, n)
        and in-page offsets ``off`` (n,) of one set of pools (k, v, and the
        int8 kq, vq, k_scale, v_scale, or Nones), on their device; rows of
        pages flagged in ``qf`` (or None) read ``int8 * scale``."""
        kp, vp, kq, vq, ks, vs = pools
        dev = kp.device

        def on_dev(a):                 # an index array or tensor, as long
            t = a if torch.is_tensor(a) else torch.from_numpy(
                np.asarray(a, np.int64))
            return t.to(dev).long()
        idx = (on_dev(ls)[:, None], on_dev(pg), on_dev(off)[None, :])
        k = kp[idx]
        v = vp[idx]
        if qf is not None:
            isq = torch.from_numpy(qf).to(dev)[..., None, None]
            k = torch.where(isq, (kq[idx].float()
                                  * ks[idx[:2]][..., None, None])
                            .to(self.dtype), k)
            v = torch.where(isq, (vq[idx].float()
                                  * vs[idx[:2]][..., None, None])
                            .to(self.dtype), v)
        return k, v

    @staticmethod
    def _realize_groups(groups) -> Dict[int, dict]:
        """Per-layer host payloads of `_gather_device` groups (run at
        transfer completion, after the copies landed)."""
        out: Dict[int, dict] = {}
        for g in groups:
            for i, l in enumerate(g["layers"]):
                out[l] = dict(k=g["k"][i], v=g["v"][i], n_tokens=g["n"])
        return out

    @staticmethod
    def _group_bytes(groups) -> float:
        return float(sum(2 * g["k"].numel() * g["k"].element_size()
                         for g in groups))

    def _launch_swap_to_host(self, sid: str, layers: List[int]) -> None:
        """Launch the async device->host copy of ``layers`` and LEASE their
        pages: the host dict gets `PendingPayload` futures now; pages
        return to the free list and store accounting moves HBM->HOST only
        when the copy lands (a failed or preempted transfer never loses
        KV).  Zero-page layers complete inline."""
        groups, empties = self._gather_device(sid, layers)
        leases = {l: self.alloc[l].lease(sid) for l in layers}

        def _bookkeep(done_layers):
            for l, pages in leases.items():
                if l in done_layers and pages:
                    self.alloc[l].release(pages)
            e = self._store_entry(sid)
            if e is not None:
                for l in done_layers:
                    if l < e.n_layers and e.tier[l] == HBM:
                        self.mgr.store.move_layer(sid, l, HOST)

        for l, p in empties.items():
            self.host[(sid, l)] = p
        if empties:
            _bookkeep(list(empties))
        if not groups:
            return

        tr = Transfer(sid, OUT, [g["buf"] for g in groups],
                      nbytes=self._group_bytes(groups))
        pendings: Dict[int, PendingPayload] = {}
        for g in groups:
            for l in g["layers"]:
                pendings[l] = PendingPayload(self.transfers, tr, l, g["n"])
                self.host[(sid, l)] = pendings[l]

        def _complete(t):
            for l, pl in self._realize_groups(groups).items():
                pendings[l].payload = pl
                if self.host.get((sid, l)) is pendings[l]:
                    self.host[(sid, l)] = pl
            # copied bytes count when they LAND — a poisoned transfer
            # moved nothing anywhere
            self.stats["copied_bytes"] += t.nbytes
            _bookkeep(list(pendings))

        def _release(_t):
            # cancelled on a live node (drop): the data is discarded but
            # the leased pages must come home
            for l, pages in leases.items():
                if l in pendings and pages:
                    self.alloc[l].release(pages)

        tr.on_complete = _complete
        tr.on_release = _release
        self.transfers.launch(tr)

    def _launch_scatter_in(self, sid: str, payloads: Dict[int, dict]) -> None:
        """Launch the host->device copy of already-allocated layers, one
        group per token count, and track it as an in-flight inbound future.
        The copy runs on the copy stream into a device staging tensor; the
        compute stream waits for it and scatters into the pools in place,
        so every pool write stays ordered on the compute stream.  A
        consumer fences via `transfers.fence(sid, IN)` — the residual wait
        IS the stall."""
        c = self.cfg
        groups: Dict[int, List[int]] = {}
        for l, p in payloads.items():
            if p["n_tokens"] > 0:
                groups.setdefault(p["n_tokens"], []).append(l)
        if not groups:
            return
        nbytes = 0.0
        keep = []
        for n, ls in groups.items():
            pg = np.stack([self._slots(l, sid, 0, n)[0] for l in ls])
            off = np.tile(self._slots(ls[0], sid, 0, n)[1], (len(ls), 1))
            hk = [payloads[l]["k"] for l in ls]
            hv = [payloads[l]["v"] for l in ls]
            if self._copy_stream is None:
                ks, vs = torch.stack(hk), torch.stack(hv)
            else:
                shape = (len(ls), n, c.n_kv_heads, c.d_head)
                ks = torch.empty(shape, dtype=self.dtype, device=self.device)
                vs = torch.empty_like(ks)
                cur = torch.cuda.current_stream(self.device)
                self._copy_stream.wait_stream(cur)
                with torch.cuda.stream(self._copy_stream):
                    for i in range(len(ls)):
                        ks[i].copy_(hk[i], non_blocking=True)
                        vs[i].copy_(hv[i], non_blocking=True)
                cur.wait_stream(self._copy_stream)
                keep += hk + hv
            self.model.scatter_paged(self.k_pool, self.v_pool,
                                     self._i32(ls)[:, None], self._i32(pg),
                                     self._i32(off), ks, vs,
                                     layout=self._layout)
            nbytes += float(2 * ks.numel() * ks.element_size())
        buf = (DONE if self._copy_stream is None else
               EventBuffer(torch.cuda.current_stream(self.device), keep))

        def _complete(t):
            self.stats["copied_bytes"] += t.nbytes

        self.transfers.launch(Transfer(sid, IN, [buf], nbytes=nbytes,
                                       on_complete=_complete))

    def _scatter_layers(self, sid: str, payloads: Dict[int, dict]) -> None:
        """Allocate + launch the copy of many host-tier layers back into
        the stacked pool.  All-or-nothing: if any layer's pages don't fit,
        no allocator is touched (OutOfPages)."""
        for l, p in payloads.items():
            a = self.alloc[l]
            need = a.pages_for(p["n_tokens"])
            if need > len(a.free_list):
                raise OutOfPages(f"{sid} layer {l}: need {need} pages, "
                                 f"have {len(a.free_list)}")
        for l, p in payloads.items():
            self.alloc[l].allocate(sid, p["n_tokens"])
        self._launch_scatter_in(sid, payloads)

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

    def _spool_payload(self, z, l: int) -> dict:
        return dict(k=_host_tensor(z[f"k{l}"], self.dtype),
                    v=_host_tensor(z[f"v{l}"], self.dtype),
                    n_tokens=int(z["n_tokens"]))

    def _ensure_resident(self, sid: str) -> None:
        """Swap in any host/disk-staged layers (one launched batched copy);
        allocate missing ones.  A layer that is neither resident, staged,
        nor spooled while the session claims KV is LOST (e.g. poisoned by a
        crash mid-transfer) — refuse loudly rather than serve phantom KV."""
        st = self.seqs[sid]
        missing = [l for l in range(self.cfg.n_layers)
                   if sid not in self.alloc[l].seqs]
        if not missing:
            return
        payloads: Dict[int, dict] = {}
        with contextlib.ExitStack() as stack:
            z = None
            f = self.spool / f"{sid}.npz" if self.spool else None
            for l in missing:
                payload = self._host_payload(sid, l)
                if payload is None and f is not None:
                    if z is None and f.exists():
                        z = stack.enter_context(np.load(f))
                    if z is not None:
                        payload = self._spool_payload(z, l)
                if payload is not None:
                    payloads[l] = payload

        def _store_to_hbm(ls):
            e = self._store_entry(sid)
            if e is None:
                return
            for l in ls:
                if l < e.n_layers and e.tier[l] != HBM:
                    self.mgr.store.move_layer(sid, l, HBM)

        empty = [l for l in missing if l not in payloads]
        if empty and st.n_kv > 0:
            raise LostKV(
                f"{sid}: layers {empty} of a {st.n_kv}-token session are "
                f"unreachable in every tier — refusing to serve phantom KV")
        for l in empty:
            self.alloc[l].allocate(sid, 0)
        _store_to_hbm(empty)
        if payloads:
            # scatter first (may raise OutOfPages, touching nothing), only
            # then drop the host copies — a failed swap-in must not lose KV
            self._scatter_layers(sid, payloads)
            for l in payloads:
                self.host.pop((sid, l), None)
                self.stats["swaps_in"] += 1
            _store_to_hbm(payloads)
            # admission under pressure: a swap-in landing on a nearly full
            # node comes back already compressed — the alternative is
            # immediately re-evicting someone else.  (The compress is
            # enqueued after the scatter on the compute stream.)
            if min(len(a.free_list) for a in self.alloc) \
                    < max(1, self.n_pages // 8):
                if self.quantize_session(sid):
                    self.stats["admit_quantized"] += 1

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
                    # swap-in rescatters the full history before the chunk
                    base = st.n_kv if st is not None else 0
                    need += a.pages_for(base + q)
            if need > len(a.free_list):
                return False
        return True

    def plan_fits(self, lanes) -> bool:
        """Mirror of step()'s all-or-nothing page check, without mutating.
        Completed-but-unreaped transfers are reaped first; a shortfall with
        swap-outs still in flight reclaims their leased pages (blocking)
        before giving up — the pages exist, they are just mid-copy."""
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

    def _dispatch_lanes(self, sids: List[str], ids_by_lane: List[List[int]],
                        quant) -> Tuple[np.ndarray, Optional[np.ndarray]]:
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
        toks, logits = self.model.step_paged(
            self.params, self._i32(ids_p), self.k_pool, self.v_pool,
            self._i32(tables), self._i32(qoff), self._i32(ctx),
            self._i32(last), self._i32(pg), self._i32(off), quant=quant,
            kernel_mode=self.kernel_mode, layout=self._layout)
        # the one host sync of a dispatch: the token ids (and the logits
        # only when tracing)
        tok_np = toks[:B].cpu().numpy()
        lg_np = None
        if self.trace_logits:
            lg_np = logits[:B, :self.cfg.vocab].float().cpu().numpy()
        return tok_np, lg_np

    def step(self, lanes, now) -> StepResult:
        # reap ready transfers BEFORE the timed region: a pending persist's
        # np.savez is background work and must not inflate this step's
        # measured duration
        self.transfers.poll()
        t0 = time.perf_counter()
        # tier fetch first (timed: swap-ins during decode are stall, not
        # compute)
        for ln in lanes:
            sid = ln.req.session_id
            if ln.req.output_ids is None:
                ln.req.output_ids = []
            st = self.seqs.get(sid)
            if st is None:
                st = self.seqs[sid] = _SeqState(priority=ln.req.priority)
                for a in self.alloc:
                    a.allocate(sid, 0)
            try:
                self._ensure_resident(sid)
            except OutOfPages:
                # leased pages of draining swap-outs are reclaimable: fence
                # them and retry before surfacing pressure to the engine
                self.transfers.fence(kind=OUT)
                self._ensure_resident(sid)
            e = self._store_entry(sid)
            if e is not None:
                e.pinned = True      # serving: not migratable/evictable
        # fence in-flight inbound futures (advisory prefetches launched in
        # earlier steps, swap-ins launched just above): the wait measured
        # here is the RESIDUAL transfer time the compute could not hide —
        # ~0 when the advisory led admission by enough
        for ln in lanes:
            self.transfers.fence(sid=ln.req.session_id, kind=IN)
        t_resident = time.perf_counter()

        ids_by_lane = [self._lane_ids(ln) for ln in lanes]
        for ln, ids in zip(lanes, ids_by_lane):
            if not ids:
                raise ValueError(f"{ln.req.session_id}: lane with no tokens "
                                 f"to process")
        sids = [ln.req.session_id for ln in lanes]

        # all-or-nothing growth across the whole mixed batch: check every
        # layer before mutating any allocator (reclaiming in-flight
        # swap-outs' leased pages once if the free lists run short)
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
        # COPY-ON-WRITE forks, before any table is built: a lane whose write
        # position lands mid-page in a page other holders still reference
        # gets a private copy — the allocator remaps the block-table entry,
        # one bucketed in-place device copy moves the contents.  Writes at
        # a page boundary never fork (the new page is private).  A CoW fork
        # of an int8 donor page re-materializes fp into the writer's copy,
        # and a SOLE holder writing mid-page into its own quantized page
        # dequantizes it in place (src == dst, bit cleared).
        forks: List[Tuple[int, int, int, int]] = []  # (layer, src, dst, srcq)
        for sid in sids:
            st = self.seqs[sid]
            if st.n_kv % self.page_size == 0:
                continue
            pi = st.n_kv // self.page_size
            for l, a in enumerate(self.alloc):
                s = a.seqs[sid]
                if pi >= len(s.pages):
                    continue
                page = s.pages[pi]
                r = a.fork_cow(sid, pi)
                if r is not None:
                    forks.append((l, r[0], r[1], int(a.is_quantized(r[0]))))
                    self.stats["cow_forks"] += 1
                elif a.is_quantized(page):
                    forks.append((l, page, page, 1))
                    a.set_quantized(page, False)
                    self.stats["dequant_forks"] += 1
        if forks:
            Fb = _bucket(len(forks))
            f = np.zeros((4, Fb), np.int32)
            f[1:3] = self.n_pages                    # pad: trash -> trash
            f[:, :len(forks)] = np.asarray(forks, np.int32).T
            fd = self._i32(f)
            if f[3].any():
                self.model.fork_paged_quant(
                    self.k_pool, self.v_pool, self.kq_pool, self.vq_pool,
                    self.k_scale, self.v_scale, fd[0], fd[1], fd[2], fd[3],
                    layout=self._layout)
            else:
                self.model.fork_paged(self.k_pool, self.v_pool, fd[0], fd[1],
                                      fd[2], layout=self._layout)
        for sid, ids in zip(sids, ids_by_lane):
            self._extend_all(sid, len(ids))

        B = len(lanes)
        # per-lane table widths from LAYER 0: _ensure_resident and
        # _extend_all grow every layer in lockstep, so layer 0's page count
        # is THE page count
        widths = [len(self.alloc[0].seqs[s].pages) for s in sids]
        groups = self._pack_lanes(widths)
        if len(groups) > 1:
            self.stats["split_steps"] += 1
        quant = self._quant_args()        # one flag build serves every group
        tok_np = np.zeros((B,), np.int32)
        lg_np = (np.zeros((B, self.cfg.vocab), np.float32)
                 if self.trace_logits else None)
        for g in groups:
            toks, lg = self._dispatch_lanes([sids[i] for i in g],
                                            [ids_by_lane[i] for i in g],
                                            quant)
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
        return StepResult(time.perf_counter() - t0,
                          stall=t_resident - t0)

    # -- preemption / lifecycle ---------------------------------------------

    def swap_out(self, sid: str, n_tokens: int) -> None:
        """LAUNCH the copy of every resident layer to the host tier (one
        batched async device->host transfer across all L layers) and lease
        its pages — non-blocking; pages come back to the free list when the
        copy lands (or at an allocation-pressure reclaim).  Fences any
        transfer this session already has in flight first: a victim
        preempted mid-prefetch (or re-preempted while an earlier swap-out
        drains) must order those copies before its pages are re-gathered."""
        st = self.seqs.get(sid)
        if st is None:
            return
        # a PERSIST is gather-only and rides along undisturbed; IN/OUT
        # must be ordered before this session's pages are re-gathered
        for kind in (IN, OUT):
            if self.transfers.pending_for(sid, kind):
                self.transfers.fence(sid=sid, kind=kind)
        # host payloads are re-inflated to full precision by the gather —
        # reprice the store entry to fp geometry BEFORE its pages lease out
        # (the precision bits die with the pages when the copy lands)
        e = self._store_entry(sid)
        if e is not None and e.quant_tokens:
            a0 = self.alloc[0]
            s0 = a0.seqs.get(sid)
            if s0 is not None:
                private = sum(1 for p in s0.pages
                              if a0.refcount_of(p) == 1)
                self.mgr.store.reprice(
                    sid, private * self._layer_page_bytes, 0)
        resident = [l for l in range(self.cfg.n_layers)
                    if sid in self.alloc[l].seqs]
        self._launch_swap_to_host(sid, resident)
        e = self._store_entry(sid)
        if e is not None:
            e.pinned = False         # preempted: fair game for migration
        self.stats["swaps_out"] += 1

    def drop(self, sid: str) -> None:
        # cancel in-flight transfers (reclaiming their leased pages): the
        # session is gone, nothing should be installed or written for it.
        # Shared pages survive the free(): refcounting keeps any page a
        # sharer still references out of the free list, and the prefix
        # index forgets this donor so no later admission adopts from it.
        self.transfers.poison(sid=sid, release=True)
        self.prefix.drop(sid)
        for a in self.alloc:
            a.free(sid)
        for l in range(self.cfg.n_layers):
            self.host.pop((sid, l), None)
        self.seqs.pop(sid, None)
        if self.spool:
            f = self.spool / f"{sid}.npz"
            if f.exists():
                f.unlink()

    def finish(self, req, now) -> None:
        """Request completed: register the session's token history in the
        prefix index (it becomes a donor) and sync the store's view."""
        sid = req.session_id
        st = self.seqs.get(sid)
        if st is not None and st.n_kv > 0 and len(st.ids) == st.n_kv:
            # ids shorter than n_kv = history not fully known (e.g. session
            # recovered from a spool without ids): never index unverifiable
            # chunks
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
        bpl, quant_tok = self._session_bpl(sid)
        self.mgr.mark_resident(sid, self.session_tokens(sid), bpl,
                               priority=req.priority,
                               shared_tokens=shared_tok,
                               quant_tokens=quant_tok)
        e = self._store_entry(sid)
        if e is not None:
            e.pinned = False         # idle again: migratable between turns

    # -- node-manager hooks (cooperative purge / advisory prefetch) ---------

    def evict_layer(self, sid: str, layer: int) -> None:
        """Launch one layer's eviction copy (async; pages leased until it
        lands).  The caller (cooperative purge) drains the batch once after
        launching every victim layer — the copies overlap each other."""
        a = self.alloc[layer]
        if sid not in a.seqs or sid not in self.seqs:
            return
        # layer-granular movement breaks the lockstep the int8 ledger price
        # assumes: dequant-write-back the whole session first (clears its
        # bits) and reprice to fp, THEN evict the one layer
        if self._quant_active and any(
                x.quantized_pages_of(sid) for x in self.alloc):
            self._dequantize_session(sid)
            self._reprice_store(sid)
        self._launch_swap_to_host(sid, [layer])
        self.stats["layer_evictions"] += 1

    def prefetch(self, sid: str, layers: List[int]) -> List[int]:
        """Advisory-path swap-in, ENQUEUED ahead of admission: allocate
        pages for as many of ``layers`` (in priority order) as physically
        fit and launch ONE async host->device copy and scatter for them.
        By the time the engine admits the session, `_ensure_resident` finds
        the pages placed and only fences the in-flight future.  Returns the
        launched prefix — an OutOfPages or unreachable payload cuts the
        plan short (best-effort, never raises)."""
        if sid not in self.seqs:
            return []
        payloads: Dict[int, dict] = {}
        launched: List[int] = []
        for l in layers:
            if sid in self.alloc[l].seqs:
                launched.append(l)       # already resident: placement holds
                continue
            p = self._host_payload(sid, l)
            if p is None:
                break                    # unreachable payload: stop the plan
            try:
                self.alloc[l].allocate(sid, p["n_tokens"])
            except OutOfPages:
                break                    # HBM physically full: plan cut short
            payloads[l] = p
            launched.append(l)
        if payloads:
            self._launch_scatter_in(sid, payloads)
            for l in payloads:
                self.host.pop((sid, l), None)
                self.stats["layer_promotions"] += 1
        return launched

    def _np_payload(self, p: dict) -> dict:
        """A host payload in the migration format (numpy beside its
        ``dtype``; bfloat16 widened to float32, see `_np_array`)."""
        return dict(k=_np_array(p["k"], export=True),
                    v=_np_array(p["v"], export=True),
                    n_tokens=int(p["n_tokens"]),
                    dtype=_dtype_name(self.dtype))

    def persist(self, sid: str) -> bool:
        """Disk write-through, launched asynchronously: the device->host
        gather of every resident layer starts now; the .npz lands when the
        transfer completes at a drain point.  Returns False (no persistent
        copy claimable) when there is no spool or a layer is unreachable.
        Recovery is gated on the physically written file, so a crash that
        poisons the in-flight write can never fake durability."""
        if self.spool is None or sid not in self.seqs:
            return False
        st = self.seqs[sid]
        resident, staged = [], []
        for l in range(self.cfg.n_layers):
            if sid in self.alloc[l].seqs:
                resident.append(l)
            elif (sid, l) in self.host:
                staged.append(l)
            else:
                return False               # a layer is unreachable: no copy
        groups, empties = self._gather_device(sid, resident)
        staged_refs = {l: self.host[(sid, l)] for l in staged}
        # the pending token has no KV anywhere — it must ride along in the
        # spool or a post-crash recovery cannot resume the sequence
        last_token = -1 if st.last_token is None else st.last_token
        priority = st.priority
        ids_arr = np.asarray(st.ids, np.int64)     # snapshot at launch: the
        path = self.spool / f"{sid}.npz"           # live list keeps growing

        def _complete(t):
            payloads: Dict[int, dict] = dict(empties)
            payloads.update(self._realize_groups(groups))
            self.stats["copied_bytes"] += t.nbytes
            for l, p in staged_refs.items():
                if isinstance(p, PendingPayload):
                    p = p.get()
                    if p is None:
                        return             # staged layer lost: abort write
                payloads[l] = p
            ns = {p["n_tokens"] for p in payloads.values()}
            assert len(ns) == 1, f"{sid}: per-layer n_tokens diverge: {ns}"
            arrs = dict(n_tokens=np.int64(ns.pop()),
                        last_token=np.int64(last_token),
                        priority=np.int64(priority), ids=ids_arr,
                        dtype=np.str_(_dtype_name(self.dtype)))
            for l, p in payloads.items():
                arrs[f"k{l}"] = _np_array(p["k"])
                arrs[f"v{l}"] = _np_array(p["v"])
            np.savez(path, **arrs)
            self.stats["disk_writes"] += 1

        self.transfers.launch(Transfer(
            sid, PERSIST, [g["buf"] for g in groups], on_complete=_complete,
            nbytes=self._group_bytes(groups)))
        return True

    # -- peer migration (the advisory path, real copies) --------------------

    def export_session(self, sid: str) -> Optional[dict]:
        """Detach a session into the migration format (numpy layers, see
        the module docstring) for a peer.  The handoff fences this
        session's in-flight transfers — bytes must physically exist before
        they can cross nodes, so a source crash after export can never
        poison the adopting node's copy."""
        st = self.seqs.get(sid)
        if st is None:
            return None
        self.swap_out(sid, st.n_kv)
        self.transfers.fence(sid=sid)
        layers = {l: self._np_payload(self.host.pop((sid, l)))
                  for l in range(self.cfg.n_layers) if (sid, l) in self.host}
        self.seqs.pop(sid)
        if self.spool:
            f = self.spool / f"{sid}.npz"
            if f.exists():
                f.unlink()
        return dict(layers=layers, n_kv=st.n_kv, last_token=st.last_token,
                    priority=st.priority, ids=list(st.ids))

    def import_session(self, sid: str, payload: dict) -> None:
        """Adopt a migrated session — from this package or the JAX one —
        into the host tier (promotion follows the node manager's priority
        plan)."""
        ids = list(payload.get("ids") or [])
        if len(ids) != payload["n_kv"]:
            ids = []                 # unknown history: never a prefix donor
        self.seqs[sid] = _SeqState(n_kv=payload["n_kv"],
                                   last_token=payload["last_token"],
                                   priority=payload.get("priority", 0),
                                   ids=ids)
        for l, p in payload["layers"].items():
            self.host[(sid, l)] = dict(k=_host_tensor(p["k"], self.dtype),
                                       v=_host_tensor(p["v"], self.dtype),
                                       n_tokens=int(p["n_tokens"]))
        self.stats["migrations_in"] += 1

    # -- fault tolerance ----------------------------------------------------

    def crash(self) -> None:
        """Node failure: the HBM pools and host staging tier are lost; the
        disk spool survives and is the recovery substrate
        (`recover_session` on this backend, driven by a live peer).
        In-flight transfers are POISONED, not resolved — a gather that was
        mid-copy installs nothing, a pending .npz write never happens —
        so no phantom KV can outlive the node."""
        self.transfers.poison()
        self.prefix.clear()          # the index described pages now gone
        self.alloc = [PagedAllocator(self.n_pages, self.page_size)
                      for _ in range(self.cfg.n_layers)]
        self.host.clear()
        self.seqs.clear()
        # the int8 shadow tier lives in the same HBM: it dies too
        self.kq_pool = self.vq_pool = None
        self.k_scale = self.v_scale = None
        self._quant_active = False

    def spool_exists(self, sid: str) -> bool:
        return self.spool is not None and (self.spool / f"{sid}.npz").exists()

    def recover_session(self, sid: str) -> Optional[dict]:
        """Rebuild a migration-format payload from this node's disk spool
        (the only tier that survives `crash()`).  Consumes the spool file —
        the session's persistent copy moves with it to the adopting node."""
        if self.spool is None:
            return None
        f = self.spool / f"{sid}.npz"
        if not f.exists():
            return None
        with np.load(f) as z:
            n = int(z["n_tokens"])
            dt = str(z["dtype"]) if "dtype" in z.files \
                else _dtype_name(self.dtype)
            layers = {l: dict(k=z[f"k{l}"], v=z[f"v{l}"], n_tokens=n,
                              dtype=dt)
                      for l in range(self.cfg.n_layers)}
            last = int(z["last_token"]) if "last_token" in z.files else -1
            prio = int(z["priority"]) if "priority" in z.files else 0
            ids = [int(i) for i in z["ids"]] if "ids" in z.files else []
        self.stats["copied_bytes"] += sum(
            p["k"].nbytes + p["v"].nbytes for p in layers.values())
        f.unlink()
        return dict(layers=layers, n_kv=n,
                    last_token=None if last < 0 else last, priority=prio,
                    ids=ids)


def make_backend(cfg, model, params, **kw):
    """Family-dispatching real-backend factory, as the JAX package's: the
    mamba2, xlstm and hybrid families serve through the slot-pool
    `StateBackend` (serving/state_backend.py), the dense and vlm families
    through `RealBackend` (text-only, as in the JAX package); the keywords
    pass through.  The moe and encdec families have no paged serving step
    in the reference (MoELM drops the dense FFN weights that step_paged
    reads; EncDecLM has no step_paged), so they raise."""
    if cfg.family in ("mamba2", "xlstm", "hybrid"):
        from repro_torch.serving.state_backend import StateBackend
        kw.pop("mesh", None)         # TP serving is transformer-only so far
        kw.pop("hbm_pages", None)    # as is the quantized page tier
        return StateBackend(cfg, model, params, **kw)
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"make_backend: family {cfg.family!r} has no paged serving step "
            f"in the reference (it serves through prefill / decode_step "
            f"only)")
    kw.pop("n_slots", None)          # slot pools are a recurrent concept
    return RealBackend(cfg, model, params, **kw)
