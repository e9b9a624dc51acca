"""Slot-pool execution backend for recurrent and hybrid session state.

SYMPHONY's memory story generalizes past KV caches: a *session* owns
whatever state its architecture accumulates — paged KV for transformers,
O(1) fixed-size recurrent state for SSM backbones, or both at once for
hybrids.  `StateBackend` is the `RealBackend` counterpart for the non-KV
kinds, behind the SAME `Backend` protocol, so the engine's control flow
(token-budget mixed steps, admission, preemption, cooperative purge) and
the NodeManager's tiering machinery (advisory prefetch, eviction, disk
write-through, crash recovery) drive all three state kinds unchanged:

* "HBM" is one stacked pool per state tensor on the card —
  (n_layers, n_slots + 1, ...) with slot ``n_slots`` the trash slot padded
  lanes read and write — handed out by a `StateAllocator` (one fixed slot
  per resident session; same lease/conservation discipline as page
  allocation).  Hybrid configs add per-application paged KV pools
  ((n_apps, n_pages + 1, page, Hkv, D)) with lockstep `PagedAllocator`s.
* One engine iteration is ONE fused ``model.step_slots`` call
  (`Zamba2LM` or `XLSTMLM`; the backend reads only the model's
  ``state_pool_names``, ``init_slot_pools``, ``blank_state``,
  ``step_slots`` and ``scatter_slots``): every lane gathers its slot, runs
  the masked chunked form over its padded token slice (for Mamba the CUDA
  ``ssd_scan`` kernel on every layer; xLSTM's mLSTM and sLSTM blocks are
  plain tensor code, as in the JAX package), and writes the advanced
  state back in place — decode lanes are the q_len = 1 case; the hybrid's
  shared blocks run the paged attention kernel on every application.
  Shape-bucketed (lane count, tokens per step, block-table width) exactly
  like the JAX package.
* Recurrent state is the paper's cheapest-migration case: the whole session
  is ONE fixed-size blob, so the tiered store tracks it as a single "layer"
  unit (CostModel.store_layers == 1) and every tier movement — swap-out,
  eviction, advisory prefetch, disk persist, peer migration — carries the
  blob atomically through the same asynchronous `TransferEngine` lifecycle
  as KV pages (lease at launch, bookkeeping at drain points, poison on
  crash).

Stream ordering, as in `RealBackend`: a gather is a private device copy
made on the compute stream, copied into pinned host memory on a side
stream; a swap-in is copied from host memory on the side stream into a
device staging tensor, and the compute stream waits for it and writes the
pools in place — every pool write stays on the compute stream.

Host payloads are ``{n_tokens, state: {name: tensor}, kv: {k, v} | None}``
with CPU tensors, one per state pool in its pool's dtype (Mamba's conv
and xLSTM's m_conv in the model dtype, the rest float32), k/v in the
model dtype ((n_apps, n_tokens, Hkv, D)).  At the spool and export
boundary they become numpy dicts with a ``dtype`` entry, bfloat16 as its
16-bit pattern (uint16) in the spool and widened to float32 in an export
(backend.py's module docstring says why); a bfloat16 array the JAX package
made is read by viewing its bits.

There is NO prefix sharing here by construction: recurrent state folds the
whole history into one tensor, so no page-aligned span can be shared or
copy-on-write forked.  `adopt_prefix`/`prefix_match_tokens` inherit the
protocol's zero defaults, which is the honest answer.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.transformer import resolve_device
from repro_torch.serving.backend import (HBM, HOST, Backend, LostKV,
                                         StepResult, _bucket, _dtype_name,
                                         _host_tensor, _np_array, _SeqState)
from repro_torch.serving.kv_cache import (OutOfPages, PagedAllocator,
                                          StateAllocator)
from repro_torch.serving.transfer import (DONE, IN, OUT, PERSIST,
                                          EventBuffer, PendingPayload,
                                          Transfer, TransferEngine,
                                          copy_to_host)


class StateBackend(Backend):
    """Real PyTorch execution over stacked recurrent-state slot pools (plus
    paged KV for hybrid families) on ``device``.

    The host tier is one payload per session — or a `PendingPayload`
    future while its device->host copy drains; the optional disk tier is
    an .npz spool.  ``trace_logits`` keeps the per-token (sid, logits)
    trail the parity tests diff against the dense reference (a full-logits
    host copy per step; chip_smoke.py turns it off on the main path).

    ``device`` defaults to the card and raises on a machine without one;
    pass ``device="cpu"`` to serve with the plain versions on the CPU.
    ``kernel_mode`` is passed to ``model.step_slots`` (auto | ref)."""

    def __init__(self, cfg, model, params, *, n_slots: int = 8,
                 n_pages: int = 64, page_size: int = 8,
                 kernel_mode: str = "auto", spool_dir: Optional[str] = None,
                 mgr=None, trace_logits: bool = True, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"backend on {self.device}")
        self.cfg = cfg
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.n_pages = n_pages
        self.page_size = page_size
        self.kernel_mode = kernel_mode
        self.trace_logits = trace_logits
        self.dtype = model.dtype
        self.has_kv = bool(getattr(model, "has_attn", False))
        self.pools: Dict[str, torch.Tensor] = model.init_slot_pools(n_slots)
        self.pool_names = tuple(model.state_pool_names)
        self.slots = StateAllocator(n_slots)
        # bytes of ONE session's fixed state across every pool
        self._state_bytes = int(sum(
            p.numel() * p.element_size() // (n_slots + 1)
            for p in self.pools.values()))
        # host<->device copies run here, beside the compute stream
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        if self.has_kv:
            self.n_apps = model.n_groups_outer
            shape = (self.n_apps, n_pages + 1, page_size,
                     cfg.n_kv_heads, cfg.d_head)
            self.k_pool = torch.zeros(shape, dtype=self.dtype,
                                      device=self.device)
            self.v_pool = torch.zeros(shape, dtype=self.dtype,
                                      device=self.device)
            self.kv_alloc: List[PagedAllocator] = [
                PagedAllocator(n_pages, page_size)
                for _ in range(self.n_apps)]
        else:
            self.n_apps = 0
            self.k_pool = self.v_pool = None
            self.kv_alloc = []
        self.host: Dict[str, object] = {}       # sid -> payload | Pending
        self.seqs: Dict[str, _SeqState] = {}
        self.transfers = TransferEngine()
        self.spool = Path(spool_dir) if spool_dir else None
        if self.spool:
            self.spool.mkdir(parents=True, exist_ok=True)
        self.mgr = None
        if mgr is not None:
            self.attach(mgr)
        self.stats = dict(prefills=0, decode_steps=0, swaps_out=0,
                          swaps_in=0, layer_evictions=0, layer_promotions=0,
                          migrations_in=0, copied_bytes=0.0, disk_writes=0,
                          prefix_hits=0, shared_tokens=0, cow_forks=0,
                          sub_dispatches=0)
        self.logit_trace: List = []

    def compile_counts(self) -> Dict[str, int]:
        """Distinct shape buckets of the fused slot step ("slots") and the
        state/KV scatters ("scatter")."""
        return self.model.slot_compile_counts()

    def attach(self, mgr) -> None:
        self.mgr = mgr
        mgr.attach_backend(self)

    # -- sizes --------------------------------------------------------------

    @property
    def _page_bytes(self) -> int:
        """Both-sides bytes of one KV page in ONE application's pool."""
        c = self.cfg
        return self.page_size * 2 * c.n_kv_heads * c.d_head \
            * self.dtype.itemsize

    def session_kv_bytes(self, tokens: int) -> float:
        b = float(self._state_bytes)
        if self.has_kv:
            b += self.kv_alloc[0].pages_for(max(int(tokens), 0)) \
                * self._page_bytes * self.n_apps
        return b

    def hbm_kv_budget(self) -> float:
        b = float(self.n_slots * self._state_bytes)
        if self.has_kv:
            b += self.n_pages * self._page_bytes * self.n_apps
        return b

    def kv_in_use(self, running) -> float:
        # used slots/pages include leased ones: an in-flight swap-out still
        # physically occupies its sources until the copy lands
        b = float(self.slots.used_slots * self._state_bytes)
        if self.has_kv:
            b += max(a.used_pages for a in self.kv_alloc) \
                * self._page_bytes * self.n_apps
        return b

    def resident_kv_bytes(self, sid: str) -> float:
        b = float(self._state_bytes) if sid in self.slots.seqs else 0.0
        if self.has_kv and sid in self.kv_alloc[0].seqs:
            b += min(len(a.seqs[sid].pages) for a in self.kv_alloc) \
                * self._page_bytes * self.n_apps
        return b

    def session_tokens(self, sid: str) -> int:
        st = self.seqs.get(sid)
        if st is None:
            return 0
        return st.n_kv + (1 if st.last_token is not None else 0)

    def _i32(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int32)).to(self.device)

    def _pool_dtype(self, name: str) -> torch.dtype:
        return self.pools[name].dtype

    # -- async transfer plumbing -------------------------------------------

    def poll_transfers(self) -> None:
        self.transfers.poll()

    def drain_transfers(self, kind: Optional[str] = None) -> None:
        self.transfers.fence(kind=kind)

    def _host_payload(self, sid: str) -> Optional[dict]:
        p = self.host.get(sid)
        if isinstance(p, PendingPayload):
            p = p.get()
        return p

    def _store_entry(self, sid: str):
        if self.mgr is None:
            return None
        return self.mgr.store.entries.get(sid)

    def _gather(self, sid: str):
        """Private device copies of one session's slot in every pool and,
        for the hybrid, of its paged KV across every application (the
        allocators are lockstep), made on the compute stream, and their
        copies to pinned host memory STARTED.  Returns (n_tokens, the host
        tensors by role, the transfer buffer, bytes)."""
        c = self.cfg
        slot = self.slots.slot_of(sid)
        names = list(self.pool_names)
        dev = [self.pools[k][:, slot].clone(memory_format=torch.contiguous_format)
               for k in names]
        n = self.seqs[sid].n_kv
        has_kv = self.has_kv and sid in self.kv_alloc[0].seqs
        npg = 0
        if has_kv:
            s0 = self.kv_alloc[0].seqs[sid]
            n, npg = s0.n_tokens, len(s0.pages)
        if npg:
            pi = self._i32(np.stack([self.kv_alloc[a].seqs[sid].pages
                                     for a in range(self.n_apps)])).long()
            ai = torch.arange(self.n_apps, device=self.device)[:, None]
            shape = (self.n_apps, npg * self.page_size, c.n_kv_heads,
                     c.d_head)
            for pool in (self.k_pool, self.v_pool):
                dev.append(pool[ai, pi].reshape(shape)[:, :n].contiguous())
        hosts, buf = copy_to_host(dev, self._copy_stream, self.device)
        out = dict(state=dict(zip(names, hosts[:len(names)])))
        if npg:
            out["kv"] = dict(k=hosts[-2], v=hosts[-1])
        elif has_kv:
            em = torch.zeros((self.n_apps, 0, c.n_kv_heads, c.d_head),
                             dtype=self.dtype)
            out["kv"] = dict(k=em, v=em)
        nbytes = float(sum(t.numel() * t.element_size() for t in dev))
        return n, out, buf, nbytes

    @staticmethod
    def _payload(n: int, parts: dict) -> dict:
        """The host payload of a landed gather."""
        payload = dict(n_tokens=n, state=dict(parts["state"]))
        if "kv" in parts:
            payload["kv"] = dict(parts["kv"])
        return payload

    def _launch_swap_to_host(self, sid: str) -> None:
        """Launch the async device->host copy of the WHOLE session blob
        (state slot + hybrid KV) and LEASE its slot/pages: the host dict
        gets a `PendingPayload` future now; resources return to the free
        lists and store accounting moves HBM->HOST only when the copy
        lands (a failed or preempted transfer never loses state)."""
        n, parts, buf, nbytes = self._gather(sid)
        slot = self.slots.lease(sid)
        kv_leases = {a: self.kv_alloc[a].lease(sid)
                     for a in range(self.n_apps)} if self.has_kv else {}

        def _release_leases():
            if slot is not None:
                self.slots.release(slot)
            for a, pages in kv_leases.items():
                if pages:
                    self.kv_alloc[a].release(pages)

        tr = Transfer(sid, OUT, [buf], nbytes=nbytes)
        pending = PendingPayload(self.transfers, tr, 0, n)
        self.host[sid] = pending

        def _complete(t):
            pending.payload = self._payload(n, parts)
            if self.host.get(sid) is pending:
                self.host[sid] = pending.payload
            self.stats["copied_bytes"] += t.nbytes
            _release_leases()
            e = self._store_entry(sid)
            if e is not None and e.tier[0] == HBM:
                self.mgr.store.move_layer(sid, 0, HOST)

        tr.on_complete = _complete
        tr.on_release = lambda _t: _release_leases()
        self.transfers.launch(tr)

    def _kv_slots(self, app: int, sid: str, start: int, n: int):
        """(page_ids, offsets) for token positions [start, start+n)."""
        pages = np.asarray(self.kv_alloc[app].seqs[sid].pages, np.int32)
        pos = start + np.arange(n)
        return pages[pos // self.page_size], \
            np.asarray(pos % self.page_size, np.int32)

    def _to_device(self, hosts, shapes):
        """Host tensors copied into fresh zeroed device tensors of
        ``shapes`` (each host tensor fills the leading part of its dim-1
        axis), on the side stream; the compute stream waits for the copies
        before anything it enqueues next."""
        outs = [torch.zeros(s, dtype=h.dtype, device=self.device)
                for h, s in zip(hosts, shapes)]
        if self._copy_stream is None:
            for h, o in zip(hosts, outs):
                o[:, :h.shape[1]].copy_(h)
            return outs
        cur = torch.cuda.current_stream(self.device)
        self._copy_stream.wait_stream(cur)
        with torch.cuda.stream(self._copy_stream):
            for h, o in zip(hosts, outs):
                o[:, :h.shape[1]].copy_(h, non_blocking=True)
        cur.wait_stream(self._copy_stream)
        return outs

    def _launch_scatter_in(self, sid: str, slot: int,
                           payload: Optional[dict]) -> None:
        """Scatter one session blob into its freshly allocated slot (and
        hybrid pages) in place, tracked as one in-flight inbound future.
        ``payload=None`` is a brand-new session: the slot is reset to the
        blank state (a reused slot still holds its previous owner's
        tensors) and nothing crosses the bus — no transfer."""
        slot_idx = self._i32([slot])
        if payload is None:          # xLSTM's stabilizers start at -1e30
            blank = self.model.blank_state(self.device)
            self.model.scatter_slots(self.pools, slot_idx,
                                     {k: v[:, None] for k, v in blank.items()})
            return
        state = payload["state"]
        hosts = [_host_tensor(state[k], self._pool_dtype(k))[:, None]
                 for k in self.pool_names]
        shapes = [tuple(h.shape) for h in hosts]
        nbytes = float(sum(h.numel() * h.element_size() for h in hosts))
        n = payload["n_tokens"]
        kv_hosts = []
        if self.has_kv and n > 0:
            c = self.cfg
            nb = _bucket(n)
            kv_hosts = [_host_tensor(payload["kv"][s], self.dtype)
                        for s in ("k", "v")]
            shapes += [(self.n_apps, nb, c.n_kv_heads, c.d_head)] * 2
        devs = self._to_device(hosts + kv_hosts, shapes)
        self.model.scatter_slots(self.pools, slot_idx,
                                 dict(zip(self.pool_names, devs)))
        if kv_hosts:
            pg = np.full((self.n_apps, nb), self.n_pages, np.int32)
            off = np.zeros((self.n_apps, nb), np.int32)
            for a in range(self.n_apps):
                pg[a, :n], off[a, :n] = self._kv_slots(a, sid, 0, n)
            self.model.scatter_paged(
                self.k_pool, self.v_pool,
                self._i32(np.arange(self.n_apps)[:, None]), self._i32(pg),
                self._i32(off), devs[-2], devs[-1])
            nbytes += float(sum(h.numel() * h.element_size()
                                for h in kv_hosts))
        buf = (DONE if self._copy_stream is None else EventBuffer(
            torch.cuda.current_stream(self.device), keep=hosts + kv_hosts))

        def _complete(t):
            self.stats["copied_bytes"] += t.nbytes

        self.transfers.launch(Transfer(sid, IN, [buf], nbytes=nbytes,
                                       on_complete=_complete))

    def _spool_payload(self, sid: str) -> Optional[dict]:
        if self.spool is None:
            return None
        f = self.spool / f"{sid}.npz"
        if not f.exists():
            return None
        with np.load(f) as z:
            payload = dict(
                n_tokens=int(z["n_tokens"]),
                state={k: _host_tensor(z[f"s_{k}"], self._pool_dtype(k))
                       for k in self.pool_names})
            if "kv_k" in z.files:
                payload["kv"] = dict(k=_host_tensor(z["kv_k"], self.dtype),
                                     v=_host_tensor(z["kv_v"], self.dtype))
        return payload

    def _ensure_resident(self, sid: str) -> None:
        """Swap the session blob back in (one launched scatter); a session
        that claims context but is reachable in no tier (e.g. its transfer
        was poisoned by a crash) is LOST — refuse loudly rather than serve
        phantom state.  All-or-nothing: hybrid page capacity is checked
        before the slot is allocated, so a failure touches nothing."""
        st = self.seqs[sid]
        if sid in self.slots.seqs:
            e = self._store_entry(sid)
            if e is not None and e.tier[0] != HBM:
                self.mgr.store.move_layer(sid, 0, HBM)
            return
        payload = self._host_payload(sid)
        if payload is None:
            payload = self._spool_payload(sid)
        if payload is None and st.n_kv > 0:
            raise LostKV(
                f"{sid}: state of a {st.n_kv}-token session is unreachable "
                f"in every tier — refusing to serve phantom state")
        n = payload["n_tokens"] if payload is not None else 0
        if self.has_kv:
            need = self.kv_alloc[0].pages_for(n)
            for a in self.kv_alloc:
                if need > len(a.free_list):
                    raise OutOfPages(f"{sid}: need {need} KV pages, have "
                                     f"{len(a.free_list)}")
        slot = self.slots.allocate(sid)          # raises OutOfSlots
        for a in self.kv_alloc:
            a.allocate(sid, n)
        self._launch_scatter_in(sid, slot, payload)
        if payload is not None:
            if self.host.pop(sid, None) is not None:
                self.stats["swaps_in"] += 1
        e = self._store_entry(sid)
        if e is not None and e.tier[0] != HBM:
            self.mgr.store.move_layer(sid, 0, HBM)

    # -- engine iteration ---------------------------------------------------

    def _lane_ids(self, lane) -> List[int]:
        """Token ids this lane processes: the pending token leads, then
        this chunk's slice of the prompt (same invariant as RealBackend)."""
        st = self.seqs[lane.req.session_id]
        ids = [] if st.last_token is None else [st.last_token]
        if lane.new_tokens:
            if lane.req.prompt_ids is None:
                raise ValueError(
                    f"{lane.req.session_id}: {lane.new_tokens} prompt "
                    f"tokens requested but prompt_ids is None — resubmit "
                    f"the request with its full token history")
            ids.extend(lane.req.prompt_ids[lane.start:
                                           lane.start + lane.new_tokens])
        return ids

    def _plan_fits_now(self, lanes) -> bool:
        need_slots = len({ln.req.session_id for ln in lanes
                          if ln.req.session_id not in self.slots.seqs})
        if need_slots > len(self.slots.free_list):
            return False
        for a in self.kv_alloc:
            need = 0
            for ln in lanes:
                sid = ln.req.session_id
                st = self.seqs.get(sid)
                q = ln.new_tokens + (1 if st is not None
                                     and st.last_token is not None else 0)
                if st is not None and sid in a.seqs:
                    s = a.seqs[sid]
                    need += a.pages_for(s.n_tokens + q) - len(s.pages)
                else:
                    base = st.n_kv if st is not None else 0
                    need += a.pages_for(base + q)
            if need > len(a.free_list):
                return False
        return True

    def plan_fits(self, lanes) -> bool:
        self.transfers.poll()
        if self._plan_fits_now(lanes):
            return True
        if self.transfers.pending_kind(OUT):
            self.transfers.fence(kind=OUT)
            return self._plan_fits_now(lanes)
        return False

    def step(self, lanes, now) -> StepResult:
        self.transfers.poll()
        t0 = time.perf_counter()
        for ln in lanes:
            sid = ln.req.session_id
            if ln.req.output_ids is None:
                ln.req.output_ids = []
            if sid not in self.seqs:
                self.seqs[sid] = _SeqState(priority=ln.req.priority)
            try:
                self._ensure_resident(sid)
            except OutOfPages:
                # leased slots/pages of draining swap-outs are reclaimable
                self.transfers.fence(kind=OUT)
                self._ensure_resident(sid)
            e = self._store_entry(sid)
            if e is not None:
                e.pinned = True
        for ln in lanes:
            self.transfers.fence(sid=ln.req.session_id, kind=IN)
        t_resident = time.perf_counter()

        ids_by_lane = [self._lane_ids(ln) for ln in lanes]
        for ln, ids in zip(lanes, ids_by_lane):
            if not ids:
                raise ValueError(f"{ln.req.session_id}: lane with no tokens "
                                 f"to process")
        sids = [ln.req.session_id for ln in lanes]
        if self.has_kv:
            # all-or-nothing page growth across the whole mixed batch
            def _shortfall(a):
                return sum(a.pages_for(a.seqs[s].n_tokens + len(ids))
                           - len(a.seqs[s].pages)
                           for s, ids in zip(sids, ids_by_lane)) \
                    - len(a.free_list)
            for attempt in (0, 1):
                worst = max(_shortfall(a) for a in self.kv_alloc)
                if worst <= 0:
                    break
                if attempt == 0 and self.transfers.pending_kind(OUT):
                    self.transfers.fence(kind=OUT)
                    continue
                raise OutOfPages(f"step: need {worst} pages beyond the "
                                 f"free list")
            for sid, ids in zip(sids, ids_by_lane):
                for a in self.kv_alloc:
                    a.extend(sid, len(ids))

        B = len(lanes)
        Sqb = _bucket(max(len(ids) for ids in ids_by_lane))
        Bb = _bucket(B)
        ids_p = np.zeros((Bb, Sqb), np.int32)
        n_valid = np.zeros((Bb,), np.int32)      # padded lanes: 0 -> masked
        last = np.zeros((Bb,), np.int32)
        # padded lanes read/write the trash slot (index n_slots)
        slot_idx = np.full((Bb,), self.n_slots, np.int32)
        for i, (sid, ids) in enumerate(zip(sids, ids_by_lane)):
            n = len(ids)
            ids_p[i, :n] = ids
            n_valid[i] = n
            last[i] = n - 1
            slot_idx[i] = self.slots.slot_of(sid)
        args = (self.params, self._i32(ids_p), self.pools,
                self._i32(slot_idx), self._i32(n_valid), self._i32(last))
        kw = {}
        if self.has_kv:
            Tb = _bucket(max(len(a.seqs[s].pages)
                             for a in self.kv_alloc for s in sids))
            tables = np.zeros((self.n_apps, Bb, Tb), np.int32)
            qoff = np.zeros((Bb,), np.int32)
            ctx = np.zeros((Bb,), np.int32)
            pg = np.full((self.n_apps, Bb, Sqb), self.n_pages, np.int32)
            off = np.zeros((self.n_apps, Bb, Sqb), np.int32)
            for a in range(self.n_apps):
                tables[a, :B] = self.kv_alloc[a].batch_block_tables(sids, Tb)
            for i, (sid, ids) in enumerate(zip(sids, ids_by_lane)):
                st = self.seqs[sid]
                n = len(ids)
                qoff[i] = st.n_kv
                ctx[i] = st.n_kv + n
                for a in range(self.n_apps):
                    pg[a, i, :n], off[a, i, :n] = self._kv_slots(
                        a, sid, st.n_kv, n)
            kw = dict(k_pool=self.k_pool, v_pool=self.v_pool,
                      tables=self._i32(tables), q_offsets=self._i32(qoff),
                      ctx_lens=self._i32(ctx), slot_pages=self._i32(pg),
                      slot_offs=self._i32(off))
        self.stats["sub_dispatches"] += 1
        toks, logits = self.model.step_slots(*args, **kw,
                                             kernel_mode=self.kernel_mode)
        # the one host sync of a step: the token ids (and the logits only
        # when tracing)
        tok_np = toks[:B].cpu().numpy()
        lg_np = None
        if self.trace_logits:
            lg_np = logits[:B, :self.cfg.vocab].float().cpu().numpy()
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
        st = self.seqs.get(sid)
        if st is None or sid not in self.slots.seqs:
            return
        # a PERSIST is gather-only and rides along; IN/OUT must be ordered
        # before this session's slot is re-gathered
        for kind in (IN, OUT):
            if self.transfers.pending_for(sid, kind):
                self.transfers.fence(sid=sid, kind=kind)
        self._launch_swap_to_host(sid)
        e = self._store_entry(sid)
        if e is not None:
            e.pinned = False
        self.stats["swaps_out"] += 1

    def drop(self, sid: str) -> None:
        self.transfers.poison(sid=sid, release=True)
        self.slots.free(sid)
        for a in self.kv_alloc:
            a.free(sid)
        self.host.pop(sid, None)
        self.seqs.pop(sid, None)
        if self.spool:
            f = self.spool / f"{sid}.npz"
            if f.exists():
                f.unlink()

    def finish(self, req, now) -> None:
        sid = req.session_id
        if self.mgr is None:
            return
        bpl = float(self._state_bytes)
        if self.has_kv and sid in self.kv_alloc[0].seqs:
            bpl += sum(len(a.seqs[sid].pages) for a in self.kv_alloc) \
                * self._page_bytes
        self.mgr.mark_resident(sid, self.session_tokens(sid), bpl,
                               priority=req.priority)
        e = self._store_entry(sid)
        if e is not None:
            e.pinned = False         # idle: migratable between turns

    # -- node-manager hooks -------------------------------------------------

    def evict_layer(self, sid: str, layer: int) -> None:
        """The store tracks recurrent state as ONE layer unit, so an
        eviction moves the whole session blob to host."""
        if sid not in self.slots.seqs or sid not in self.seqs:
            return
        self._launch_swap_to_host(sid)
        self.stats["layer_evictions"] += 1

    def prefetch(self, sid: str, layers: List[int]) -> List[int]:
        """Advisory-path swap-in, enqueued ahead of admission.  The blob is
        atomic: either the whole plan launches or none of it."""
        if sid not in self.seqs:
            return []
        if sid in self.slots.seqs:
            return list(layers)
        payload = self._host_payload(sid)
        if payload is None:
            return []
        n = payload["n_tokens"]
        if not self.slots.free_list:
            return []
        if self.has_kv:
            need = self.kv_alloc[0].pages_for(n)
            if any(need > len(a.free_list) for a in self.kv_alloc):
                return []
        slot = self.slots.allocate(sid)
        for a in self.kv_alloc:
            a.allocate(sid, n)
        self._launch_scatter_in(sid, slot, payload)
        self.host.pop(sid, None)
        self.stats["layer_promotions"] += 1
        return list(layers)

    def _np_payload(self, p: dict, export: bool = False) -> dict:
        """A host payload's arrays in the spool or (``export``) the
        migration format (numpy; see `backend._np_array`)."""
        out = dict(n_tokens=int(p["n_tokens"]),
                   state={k: _np_array(_host_tensor(v, self._pool_dtype(k)),
                                       export)
                          for k, v in p["state"].items()})
        kv = p.get("kv")
        out["kv"] = None if kv is None else {
            s: _np_array(_host_tensor(kv[s], self.dtype), export)
            for s in ("k", "v")}
        return out

    def persist(self, sid: str) -> bool:
        """Disk write-through, launched asynchronously; the .npz lands at a
        drain point.  Recovery is gated on the physically written file."""
        if self.spool is None or sid not in self.seqs:
            return False
        st = self.seqs[sid]
        path = self.spool / f"{sid}.npz"
        last_token = -1 if st.last_token is None else st.last_token
        priority = st.priority
        ids_arr = np.asarray(st.ids, np.int64)

        def _write(payload, nbytes):
            p = self._np_payload(payload)
            arrs = dict(n_tokens=np.int64(p["n_tokens"]),
                        last_token=np.int64(last_token),
                        priority=np.int64(priority), ids=ids_arr,
                        dtype=np.str_(_dtype_name(self.dtype)))
            for k in self.pool_names:
                arrs[f"s_{k}"] = p["state"][k]
            if p["kv"] is not None:
                arrs["kv_k"] = p["kv"]["k"]
                arrs["kv_v"] = p["kv"]["v"]
            np.savez(path, **arrs)
            self.stats["disk_writes"] += 1
            self.stats["copied_bytes"] += nbytes

        if sid in self.slots.seqs:
            n, parts, buf, nbytes = self._gather(sid)
            self.transfers.launch(Transfer(
                sid, PERSIST, [buf], nbytes=nbytes,
                on_complete=lambda t: _write(self._payload(n, parts),
                                             t.nbytes)))
            return True
        staged = self.host.get(sid)
        if staged is None:
            return False

        def _complete_staged(_t):
            p = staged.get() if isinstance(staged, PendingPayload) else staged
            if p is None:
                return               # staged blob lost: abort the write
            _write(p, 0.0)

        # no device buffers: completes at the next drain point, after the
        # staged blob's own OUT transfer (fenced inside via get())
        self.transfers.launch(Transfer(sid, PERSIST, [],
                                       on_complete=_complete_staged))
        return True

    # -- peer migration -----------------------------------------------------

    def export_session(self, sid: str) -> Optional[dict]:
        """Detach a session into the migration format (numpy, see the
        module docstring); fences its in-flight transfers — bytes must
        physically exist before they cross nodes."""
        st = self.seqs.get(sid)
        if st is None:
            return None
        self.swap_out(sid, st.n_kv)
        self.transfers.fence(sid=sid)
        payload = self.host.pop(sid, None)
        if isinstance(payload, PendingPayload):
            payload = payload.get()
        self.seqs.pop(sid)
        if self.spool:
            f = self.spool / f"{sid}.npz"
            if f.exists():
                f.unlink()
        if payload is None:
            if st.n_kv > 0:
                return None          # state unreachable: nothing to migrate
            payload = dict(n_tokens=0, state=self.model.blank_state())
        p = self._np_payload(payload, export=True)
        return dict(state=p["state"], kv=p["kv"], n_kv=st.n_kv,
                    last_token=st.last_token, priority=st.priority,
                    ids=list(st.ids), dtype=_dtype_name(self.dtype))

    def import_session(self, sid: str, payload: dict) -> None:
        """Adopt a migrated session — from this package or the JAX one —
        into the host tier."""
        ids = list(payload.get("ids") or [])
        if len(ids) != payload["n_kv"]:
            ids = []                 # unknown history
        self.seqs[sid] = _SeqState(n_kv=payload["n_kv"],
                                   last_token=payload["last_token"],
                                   priority=payload.get("priority", 0),
                                   ids=ids)
        blob = dict(n_tokens=payload["n_kv"], state={
            k: _host_tensor(v, self._pool_dtype(k))
            for k, v in payload["state"].items()})
        if payload.get("kv") is not None:
            blob["kv"] = {s: _host_tensor(payload["kv"][s], self.dtype)
                          for s in ("k", "v")}
        self.host[sid] = blob
        self.stats["migrations_in"] += 1

    # -- fault tolerance ----------------------------------------------------

    def crash(self) -> None:
        """Node failure: slot pools, KV pools and host tier are lost; the
        disk spool survives.  In-flight transfers are POISONED — nothing
        installed, written, or accounted."""
        self.transfers.poison()
        self.slots = StateAllocator(self.n_slots)
        if self.has_kv:
            self.kv_alloc = [PagedAllocator(self.n_pages, self.page_size)
                             for _ in range(self.n_apps)]
        self.host.clear()
        self.seqs.clear()

    def spool_exists(self, sid: str) -> bool:
        return self.spool is not None and (self.spool / f"{sid}.npz").exists()

    def recover_session(self, sid: str) -> Optional[dict]:
        """Rebuild a migration-format payload from this node's disk spool;
        consumes the file (the persistent copy moves with the session)."""
        if self.spool is None:
            return None
        f = self.spool / f"{sid}.npz"
        if not f.exists():
            return None
        with np.load(f) as z:
            state = {k: np.asarray(z[f"s_{k}"]) for k in self.pool_names}
            kv = None
            if "kv_k" in z.files:
                kv = dict(k=np.asarray(z["kv_k"]), v=np.asarray(z["kv_v"]))
            n = int(z["n_tokens"])
            last = int(z["last_token"]) if "last_token" in z.files else -1
            prio = int(z["priority"]) if "priority" in z.files else 0
            ids = [int(i) for i in z["ids"]] if "ids" in z.files else []
            dt = str(z["dtype"]) if "dtype" in z.files \
                else _dtype_name(self.dtype)
        self.stats["copied_bytes"] += sum(v.nbytes for v in state.values()) \
            + (kv["k"].nbytes + kv["v"].nbytes if kv else 0)
        f.unlink()
        return dict(state=state, kv=kv, n_kv=n,
                    last_token=None if last < 0 else last, priority=prio,
                    ids=ids, dtype=dt)
