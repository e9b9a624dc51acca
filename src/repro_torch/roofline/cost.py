"""The work a torch program does, counted from the program itself: the
counterpart of ``src/repro/roofline/hlo_cost.py``.

The JAX package parses the optimised HLO that XLA compiled.  The port has
no compiled module: it runs eager PyTorch, so `Counter` (a
``TorchDispatchMode``) sees every ATen operation as it runs, on real
tensors or on ``meta`` tensors (shapes only, no data, no card), and
charges it.  It claims no HLO semantics.  What it counts:

  flops      — matmul-family products 2·M·N·K (``torch.utils.flop_counter``'s
               formulas: mm, bmm, addmm, baddbmm, convolutions, attention);
               elementwise operations one a result element, reductions one
               an input element (the approximations hlo_cost.py uses); data
               movement (copies, casts, concatenation, gathers, scatters,
               fills) none.  Kept by dtype too, for the peak of each type.
  hbm_bytes  — operands plus results of every operation that materialises
               a result; views are free; a gather moves twice its result,
               a scatter three times its update (hlo_cost.py's rules).
               Eager PyTorch materialises every operation, so this is the
               port's own traffic, not XLA's fused traffic, and it is
               larger than what hlo_cost.py reports for the same program.
  coll_bytes — the collectives of ``distributed/collectives.py``, per
               device, by type, with hlo_cost.py's ring terms: all-reduce
               2·B·(g−1)/g, all-gather out·(g−1)/g, reduce-scatter
               B·(g−1)/g.

Kernel entries.  Each entry of ``kernels/ops.py`` is charged its analytic
work once, whatever implements the call — the CUDA kernel, the plain
version or the meta route — from the functions below (``attention_work``,
``flash_work``, ``scan_work``, ``partial_work``, ``merge_work``,
``feature_scores_work``, ``feature_pv_work``), and the
operations inside it are not counted.  So the same step through the
kernels and through the plain versions is charged the same work.  Where
the work depends on the data (the lanes' context lengths, int8 flags), a
call on meta tensors, which have none, is charged as if every lane's
table were full and every page were full precision.  The plain version's
backward pass, where autograd records an entry on real tensors, runs as
ordinary operations and is counted as such; on meta tensors the entry's
backward is charged twice its forward work (the four products of the
softmax gradient against the forward's two).

Loops.  ``trips`` stands for ``range`` in a Python loop whose iterations
have equal shapes.  Under ``Counter(fold=True)`` it runs the first two
iterations only and multiplies what the second is charged (and what its
backward pass is charged, through the autograd nodes it created) by the
trip count less one, as hlo_cost.py multiplies a while body by its
``known_trip_count``.  Only meta runs fold: the skipped iterations'
values are not computed.  A Python ``range`` always knows its trip count,
so ``unknown_trip_whiles`` (the JAX artifact's key) is always 0 here.

Memory.  ``peak_live_bytes`` is the most bytes that results of the counted
operations held at once: each result's storage from its creation until the
last tensor on it is freed (autograd's saved tensors included).  Tensors
made before the count began (parameters, caches, the batch) are not in it.
The stored iterations of a folded loop are counted once.
"""
from __future__ import annotations

import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# H100 SXM data sheet, dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def peak_flops(dtype) -> float:
    """The card's peak rate for operations on ``dtype``: the tensor cores'
    bf16 rate for bf16 and fp16, the CUDA cores' float32 rate for every
    other type."""
    if dtype in (torch.bfloat16, torch.float16):
        return PEAK_FLOPS[torch.bfloat16]
    return PEAK_FLOPS[torch.float32]


def bound(nbytes: int, flops: int, dtype):
    """(bound ms, what bounds it, bytes ms, operations ms)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / peak_flops(dtype) * 1e3
    return (max(t_b, t_f), "bytes" if t_b >= t_f else "operations", t_b, t_f)


# -- the kernels' analytic work ----------------------------------------------

def attention_work(q, tables, q_offsets, ctx_lens, page, hkv, d, itemsize,
                   q_lens, flags=None):
    """Bytes a paged attention call must move and the operations it must do
    for THESE inputs: each real query row read and its output written once
    (nothing for bucket padding or ctx=0 lanes), each lane's relevant K/V
    rows once (per kv head), the tables' relevant columns; QK and PV over
    the keys each real query row sees (4 D operations per head and key).
    With ``flags`` (the int8 kernel): a flagged page's rows at one byte an
    element plus its two float32 scales, and each relevant page's flag."""
    B, Sq, H, D = q.shape
    qo = q_offsets.cpu().numpy().astype(np.int64)
    cx = ctx_lens.cpu().numpy().astype(np.int64)
    tab = tables.cpu().numpy()
    fl = None if flags is None else flags.cpu().numpy()
    nbytes = 2 * B * 4
    flops = 0
    for b in range(B):
        if cx[b] == 0:
            continue
        n = int(q_lens[b])
        c = int(cx[b])
        npg = -(-c // page)
        nbytes += 2 * n * H * D * itemsize
        nbytes += 4 * npg
        if fl is None:
            nbytes += 2 * c * hkv * d * itemsize
        else:
            nbytes += 4 * npg
            for i in range(npg):
                rows = min(page, c - i * page)
                if fl[tab[b, i]]:
                    nbytes += 2 * rows * hkv * d + 2 * 4
                else:
                    nbytes += 2 * rows * hkv * d * itemsize
        seen = np.minimum(cx[b], qo[b] + np.arange(n) + 1)
        flops += 4 * D * H * int(seen.sum())
    return nbytes, flops


def partial_work(q, tables, q_offsets, ctx_lens, page_g, pl, shard, hkv, d,
                 itemsize, q_lens, flags=None):
    """`attention_work` of one shard's partial call: its real query rows
    read and outputs (and lse) written, the shard's rows of each lane's
    relevant pages (int8 where flagged), and QK and PV over the keys of
    the shard each real row sees."""
    B, Sq, H, D = q.shape
    qo = q_offsets.cpu().numpy().astype(np.int64)
    cx = ctx_lens.cpu().numpy().astype(np.int64)
    tab = tables.cpu().numpy()
    fl = None if flags is None else flags.cpu().numpy()
    nbytes, flops = 2 * B * 4, 0
    for b in range(B):
        if cx[b] == 0:
            continue
        n, c = int(q_lens[b]), int(cx[b])
        npg = -(-c // page_g)
        nbytes += 2 * n * H * D * itemsize + 4 * n * H + 4 * npg
        pos = (np.arange(npg)[:, None] * page_g + shard * pl
               + np.arange(pl)[None, :])
        rows = (pos < c).sum(axis=1)
        for i in range(npg):
            if fl is not None and fl[tab[b, i]]:
                nbytes += 2 * rows[i] * hkv * d + 8 + 4
            else:
                nbytes += 2 * rows[i] * hkv * d * itemsize + (
                    0 if fl is None else 4)
        keys = np.sort(pos[pos < c])
        seen = np.searchsorted(keys, qo[b] + np.arange(n), side="right")
        flops += 4 * D * H * int(seen.sum())
    return nbytes, flops


def merge_work(o, lse, itemsize):
    """Bytes the merge of one call must move for THESE partials: every lse
    read, the o rows of partials that saw a key (the others are not read),
    the output written; its operations are negligible."""
    N, B, Sq, H, D = o.shape
    seen = (lse.numel() if lse.device.type == "meta"
            else int(torch.isfinite(lse).sum()))
    return 4 * lse.numel() + 4 * D * seen + B * Sq * H * D * itemsize


def _seen(q_offsets, ctx_lens, q_lens):
    """Per lane: (real rows n, keys read kv_end, keys seen summed over the
    real rows), the rows at q_offsets + i < ctx each seeing min(ctx,
    qpos + 1) keys."""
    qo = q_offsets.cpu().numpy().astype(np.int64)
    cx = ctx_lens.cpu().numpy().astype(np.int64)
    out = []
    for b in range(len(cx)):
        n = int(q_lens[b]) if cx[b] else 0
        seen = np.minimum(cx[b], qo[b] + np.arange(n) + 1)
        out.append((n, int(seen.max()) if n else 0, int(seen.sum())))
    return out


def _feature_rows(tables, page, hkv, dr, itemsize, kv_end, b, flags):
    """Bytes of one lane's key (or value) features below ``kv_end`` of one
    shard, with the table entries; int8 where flagged, plus its scale and
    flag."""
    npg = -(-kv_end // page)
    nbytes = 4 * npg
    for i in range(npg):
        rows = min(page, kv_end - i * page)
        if flags is not None and flags[tables[b, i]]:
            nbytes += rows * hkv * dr + 4 + 4
        else:
            nbytes += rows * hkv * dr * itemsize + (0 if flags is None
                                                    else 4)
    return nbytes


def feature_scores_work(q, tables, q_offsets, ctx_lens, page, hkv, dr,
                        itemsize, q_lens, flags=None, accumulate=False):
    """Bytes F1 (a shard's partial scores on the head-feature rung) must
    move and the operations it must do for THESE inputs: each real query
    row's dr features read once, each lane's key features up to its
    horizon once (int8 where flagged), a float32 score written for each
    (real row, head, key it sees) — and read, when the call adds into the
    buffer; 2 dr operations a score."""
    B, Sq, H, _ = q.shape
    tab = tables.cpu().numpy()
    fl = None if flags is None else flags.cpu().numpy()
    nbytes, flops = 2 * B * 4, 0
    for b, (n, kv_end, seen) in enumerate(_seen(q_offsets, ctx_lens,
                                                q_lens)):
        if not n:
            continue
        nbytes += n * H * dr * itemsize + _feature_rows(
            tab, page, hkv, dr, itemsize, kv_end, b, fl)
        nbytes += 4 * H * seen * (2 if accumulate else 1)
        flops += 2 * dr * H * seen
    return nbytes, flops


def feature_pv_work(scores, tables, q_offsets, ctx_lens, page, hkv, dr,
                    itemsize, q_lens, flags=None):
    """Bytes F2 (a shard's softmax · V on the head-feature rung) must move
    and the operations it must do for THESE inputs: the float32 score of
    each (real row, head, key it sees) read once, each lane's value
    features up to its horizon once (int8 where flagged), each real row's
    dr outputs written once; per score the softmax (scale, maximum,
    exponent, sum: 4) and 2 dr for P · V."""
    B, H, Sq, _ = scores.shape
    tab = tables.cpu().numpy()
    fl = None if flags is None else flags.cpu().numpy()
    nbytes, flops = 2 * B * 4, 0
    for b, (n, kv_end, seen) in enumerate(_seen(q_offsets, ctx_lens,
                                                q_lens)):
        if not n:
            continue
        nbytes += 4 * H * seen + n * H * dr * itemsize + _feature_rows(
            tab, page, hkv, dr, itemsize, kv_end, b, fl)
        flops += (2 * dr + 4) * H * seen
    return nbytes, flops


def flash_work(q, k, q_offset):
    """Bytes causal prefill attention must move and the operations it must
    do on THESE inputs: q read and the output written once, each kv head's
    K/V rows up to the last query's horizon (q_offset + Sq; keys past it
    are padding no row sees) read once; QK and PV over the keys each query
    row sees (4 D operations per head and key)."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    it = q.element_size()
    nbytes = 2 * B * Sq * H * D * it + 2 * B * (q_offset + Sq) * Hkv * D * it
    seen = Sq * q_offset + Sq * (Sq + 1) // 2
    return nbytes, 4 * D * H * B * seen


def scan_work(x, Bm, init):
    """Bytes the scan must move and the float32 operations it must do on
    THESE inputs: x, dA, B, C and the initial state read once, y and the
    final state written once; per step and head, the recurrence's state
    update (B x^T into h, 2 N P operations) and C h (2 N P, none on the
    first step of a zero state).  Any chunk length computes the same
    function, and the chunked forms do more (the scores' causal tiles), so
    this is the least; the decays' O(H) a step are left out."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    it = x.element_size()
    nbytes = (2 * B * S * H * P * it + B * S * H * 4 + 2 * B * S * G * N * it
              + B * H * N * P * 4 * (2 if init else 1))
    steps_ch = S if init else max(S - 1, 0)
    flops = 2 * B * H * N * P * (S + steps_ch)
    return nbytes, flops


# -- each kernels/ops.py entry's charge (same arguments as the entry) --------

def _lanes(q, tables, q_offsets, ctx_lens, page):
    """(tables, q_offsets, ctx_lens) on the host; on meta tensors, which
    carry no data, every lane's table full and its Sq rows real."""
    if q.device.type != "meta":
        return tables, q_offsets, ctx_lens
    B, T = tables.shape
    ctx = torch.full((B,), T * page, dtype=torch.int64)
    return (torch.zeros((B, T), dtype=torch.int64), ctx - q.shape[1], ctx)


def paged_attention_work(q, k_pages, v_pages, block_tables, ctx_lens,
                         mode="auto"):
    _, page, hkv, d = k_pages.shape
    q4 = q[:, None]
    tab, _, ctx = _lanes(q4, block_tables, None, ctx_lens, page)
    qoff = (ctx.long() - 1).clamp(min=0)
    return attention_work(q4, tab, qoff, ctx, page, hkv, d,
                          q.element_size(), (ctx > 0).int().tolist()), \
        q.dtype


def paged_chunk_attention_work(q, k_pages, v_pages, block_tables, q_offsets,
                               ctx_lens, mode="auto", quant=None):
    _, page, hkv, d = k_pages.shape
    tab, qoff, ctx = _lanes(q, block_tables, q_offsets, ctx_lens, page)
    q_lens = (ctx.long() - qoff.long()).clamp(min=0).tolist()
    flags = None if quant is None or q.device.type == "meta" else quant[4]
    return attention_work(q, tab, qoff, ctx, page, hkv, d, q.element_size(),
                          q_lens, flags), q.dtype


def paged_chunk_attention_features_work(q, k_pools, v_pools, block_tables,
                                        q_offsets, ctx_lens, mode="auto",
                                        quant=None):
    """`attention_work` at the full head d = dr·tp: every shard's features
    of each relevant row read once (int8 where flagged, the page's scales
    once for all shards)."""
    _, page, hkv, dr = k_pools[0].shape
    tab, qoff, ctx = _lanes(q, block_tables, q_offsets, ctx_lens, page)
    q_lens = (ctx.long() - qoff.long()).clamp(min=0).tolist()
    flags = None if quant is None or q.device.type == "meta" else quant[4]
    return attention_work(q, tab, qoff, ctx, page, hkv, dr * len(k_pools),
                          q.element_size(), q_lens, flags), q.dtype


def paged_chunk_attention_partial_work(q, k_pages, v_pages, block_tables,
                                       q_offsets, ctx_lens, shard, n_shards,
                                       mode="auto", quant=None, out=None):
    _, pl, hkv, d = k_pages.shape
    page_g = pl * n_shards
    tab, qoff, ctx = _lanes(q, block_tables, q_offsets, ctx_lens, page_g)
    q_lens = (ctx.long() - qoff.long()).clamp(min=0).tolist()
    flags = None if quant is None or q.device.type == "meta" else quant[4]
    return partial_work(q, tab, qoff, ctx, page_g, pl, shard, hkv, d,
                        q.element_size(), q_lens, flags), q.dtype


def paged_chunk_scores_partial_work(q, k_pages, block_tables, q_offsets,
                                    ctx_lens, mode="auto", quant=None,
                                    out=None, accumulate=False):
    _, page, hkv, dr = k_pages.shape
    tab, qoff, ctx = _lanes(q, block_tables, q_offsets, ctx_lens, page)
    q_lens = (ctx.long() - qoff.long()).clamp(min=0).tolist()
    flags = None if quant is None or q.device.type == "meta" else quant[4]
    return feature_scores_work(q, tab, qoff, ctx, page, hkv, dr,
                               q.element_size(), q_lens, flags,
                               accumulate), q.dtype


def paged_chunk_softmax_pv_work(scores, v_pages, block_tables, q_offsets,
                                ctx_lens, head_dim, dtype, mode="auto",
                                quant=None):
    _, page, hkv, dr = v_pages.shape
    # `_lanes` reads the rows Sq from dim 1
    tab, qoff, ctx = _lanes(scores.transpose(1, 2), block_tables, q_offsets,
                            ctx_lens, page)
    q_lens = (ctx.long() - qoff.long()).clamp(min=0).tolist()
    flags = None if quant is None or scores.device.type == "meta" \
        else quant[4]
    return feature_pv_work(scores, tab, qoff, ctx, page, hkv, dr,
                           v_pages.element_size(), q_lens, flags), dtype


def merge_partials_work(o, lse, dtype, mode="auto"):
    return (merge_work(o, lse, torch.empty((), dtype=dtype).element_size()),
            0), dtype


def flash_prefill_work(q, k, v, q_offset=0, mode="auto"):
    return flash_work(q, k, q_offset), q.dtype


def ssd_scan_work(x, dA, Bm, Cm, chunk, init_state=None, mode="auto"):
    return scan_work(x, Bm, init_state is not None), torch.float32


# -- the cost record ----------------------------------------------------------

@dataclass
class Cost:
    """What a counted run did: hlo_cost.Cost's fields and ``to_json`` keys,
    plus the operations by dtype (for the peak of each type), each kernel
    entry's calls, operations and bytes, and the peak of live bytes."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_counts: Dict[str, int] = field(default_factory=dict)
    unknown_trip_whiles: int = 0
    flops_by_dtype: Dict[torch.dtype, float] = field(default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    peak_live_bytes: float = 0.0

    @property
    def total_coll_bytes(self):
        return sum(self.coll_bytes.values())

    def bound(self):
        """(bound ms, what bounds it, bytes ms, operations ms) of the whole
        run on one card: the bytes over the memory rate, against each
        type's operations over its peak, summed."""
        t_b = self.hbm_bytes / HBM_BYTES_PER_S * 1e3
        t_f = sum(f / peak_flops(dt) for dt, f in
                  self.flops_by_dtype.items()) * 1e3
        return (max(t_b, t_f), "bytes" if t_b >= t_f else "operations",
                t_b, t_f)

    def to_json(self):
        return dict(flops=self.flops, hbm_bytes=self.hbm_bytes,
                    coll_bytes=dict(self.coll_bytes),
                    coll_counts={k: int(v) for k, v in
                                 self.coll_counts.items()},
                    total_coll_bytes=self.total_coll_bytes,
                    unknown_trip_whiles=self.unknown_trip_whiles,
                    flops_by_dtype={str(k).replace("torch.", ""): v
                                    for k, v in self.flops_by_dtype.items()},
                    kernels={k: dict(v) for k, v in self.kernels.items()},
                    peak_live_bytes=self.peak_live_bytes)


# -- the counter --------------------------------------------------------------

aten = torch.ops.aten
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten._unsafe_view.default,
         aten.lift_fresh.default, aten.detach.default}
_GATHER = {aten.index.Tensor, aten.index_select.default,
           aten.embedding.default, aten.gather.default,
           aten._unsafe_index.Tensor}
_SCATTER = {aten.index_put_.default: 2, aten.index_put.default: 2,
            aten._index_put_impl_.default: 2, aten.scatter.src: 3,
            aten.scatter_.src: 3, aten.scatter_add.default: 3,
            aten.scatter_add_.default: 3, aten.index_copy_.default: 3,
            aten.index_copy.default: 3, aten.index_add_.default: 3,
            aten.index_add.default: 3}
_MOVE = {aten.clone.default, aten.copy_.default, aten._to_copy.default,
         aten.cat.default, aten.stack.default, aten.zeros.default,
         aten.ones.default, aten.full.default, aten.zeros_like.default,
         aten.ones_like.default, aten.full_like.default,
         aten.new_zeros.default, aten.new_ones.default,
         aten.new_full.default, aten.fill_.Scalar, aten.fill_.Tensor,
         aten.zero_.default, aten.arange.default, aten.arange.start,
         aten.arange.start_step, aten.constant_pad_nd.default,
         aten.repeat.default, aten.repeat_interleave.self_int,
         aten.slice_scatter.default, aten.select_scatter.default,
         aten.expand_copy.default, aten.split_with_sizes_copy.default,
         aten.unbind_copy.int, *_GATHER, *_SCATTER}


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


def _fresh(func) -> bool:
    return all(r.alias_info is None for r in func._schema.returns)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """Counts the work of the operations run under it into ``self.cost``.
    ``fold``: `trips` loops run two iterations, the second multiplied
    (meta runs only)."""

    def __init__(self, fold: bool = False):
        super().__init__()
        self.fold = fold
        self.cost = Cost()
        self._mult = []                 # trip counts of the folded loops
        self._folds = []                # (first node, end node, trips)
        self._paused = 0
        self._live = {}                 # storage key -> [tensors, bytes]
        self._live_bytes = 0

    # -- multipliers -------------------------------------------------------

    def _multiplier(self) -> float:
        m = 1.0
        for n in self._mult:
            m *= n
        node = torch._C._current_autograd_node()
        if node is not None and self._folds:
            seq = node._sequence_nr()
            for lo, hi, n in self._folds:
                if lo <= seq < hi:
                    m *= n
        return m

    @contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # -- charges -----------------------------------------------------------

    def _charge(self, flops, nbytes, dtype, mult):
        c = self.cost
        c.flops += flops * mult
        c.hbm_bytes += nbytes * mult
        if flops:
            c.flops_by_dtype[dtype] = (c.flops_by_dtype.get(dtype, 0.0)
                                       + flops * mult)

    def charge_entry(self, name, work, dtype):
        nbytes, flops = work
        mult = self._multiplier()
        self._charge(flops, nbytes, dtype, mult)
        k = self.cost.kernels.setdefault(
            name, dict(calls=0, flops=0.0, bytes=0.0))
        k["calls"] += mult
        k["flops"] += flops * mult
        k["bytes"] += nbytes * mult

    def charge_collective(self, kind, in_bytes, out_bytes, g):
        """One collective of ``kind`` over a group of ``g`` devices, each
        with ``in_bytes`` in and ``out_bytes`` out: its ring link bytes."""
        ring = (g - 1) / g if g > 1 else 0.0
        self.charge_link(kind, {"all-reduce": 2 * in_bytes * ring,
                                "all-gather": out_bytes * ring}.get(
                                    kind, in_bytes * ring))

    def charge_link(self, kind, link):
        """One collective of ``kind`` that moves ``link`` bytes a device."""
        mult = self._multiplier()
        c = self.cost
        c.coll_bytes[kind] = c.coll_bytes.get(kind, 0.0) + link * mult
        c.coll_counts[kind] = c.coll_counts.get(kind, 0) + mult

    # -- liveness ----------------------------------------------------------

    def track(self, out, fresh: bool = True):
        """Count ``out``'s tensors as live until freed: new storages when
        ``fresh`` (a result that aliases nothing), further tensors on an
        already tracked storage otherwise (a view)."""
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = (st.device.type, st._cdata)
            ent = self._live.get(key)
            if ent is None:
                if not fresh:
                    continue
                ent = self._live[key] = [0, st.nbytes()]
                self._live_bytes += ent[1]
                self.cost.peak_live_bytes = max(self.cost.peak_live_bytes,
                                                self._live_bytes)
            ent[0] += 1
            weakref.finalize(t, self._release, key, ent)

    def _release(self, key, ent):
        ent[0] -= 1
        if ent[0] == 0 and self._live.get(key) is ent:
            del self._live[key]
            self._live_bytes -= ent[1]

    # -- the dispatch ------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or func in _FREE:
            return out
        if _is_view(func):
            self.track(out, fresh=False)
            return out
        self._count(func, args, kwargs, out)
        if _fresh(func):
            self.track(out)
        return out

    def _count(self, func, args, kwargs, out):
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        packet = func._overloadpacket
        if func in _GATHER:
            idx = sum(_nbytes(t) for t in ins if not t.is_floating_point())
            nbytes = 2 * sum(_nbytes(t) for t in outs) + idx
        elif func in _SCATTER:
            pos = _SCATTER[func]
            upd = args[pos] if len(args) > pos else None
            upd_b = _nbytes(upd) if isinstance(upd, torch.Tensor) else 0
            idx = sum(_nbytes(t) for t in ins if t is not upd
                      and not t.is_floating_point() and t is not args[0])
            nbytes = 3 * upd_b + idx
        else:
            nbytes = (sum(_nbytes(t) for t in ins)
                      + sum(_nbytes(t) for t in outs))
        typed = [t for t in ins if t.is_floating_point()] or outs or ins
        dtype = typed[0].dtype if typed else None
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        elif func in _MOVE or not outs:
            flops = 0
        else:
            n_out = outs[0].numel()
            n_in = ins[0].numel() if ins else 0
            flops = n_in if n_in > n_out else n_out
        self._charge(flops, nbytes, dtype, self._multiplier())


def active() -> Optional[Counter]:
    """The innermost running `Counter`, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, Counter):
            return mode
    return None


def count(fn, *args, fold: bool = False, **kwargs) -> Cost:
    """The `Cost` of ``fn(*args, **kwargs)``."""
    with Counter(fold=fold) as c:
        fn(*args, **kwargs)
    return c.cost


def kernel_entry(name, work, fn, args, kwargs):
    """Call the kernel entry ``fn``; under a `Counter`, charge it
    ``work(*args, **kwargs)`` = ((bytes, operations), dtype) once and
    count nothing that runs inside it."""
    c = active()
    if c is None or c._paused:
        return fn(*args, **kwargs)
    with c.paused():
        w, dtype = work(*args, **kwargs)
    c.charge_entry(name, w, dtype)
    with c.paused():
        out = fn(*args, **kwargs)
    c.track(out)
    return out


def charge_backward(name, work, dtype):
    """Charge a kernel entry's backward pass on meta tensors: twice the
    forward's bytes and operations."""
    c = active()
    if c is not None and not c._paused:
        c.charge_entry(name + ".backward", (2 * work[0], 2 * work[1]), dtype)


def charge_collective(kind, parts, out=None):
    """Charge one collective over ``parts`` (one tensor a shard): per
    device, its shard's bytes in and ``out``'s bytes (the whole result)."""
    c = active()
    if c is None or c._paused:
        return
    in_b = _nbytes(parts[0])
    out_b = _nbytes(out) if out is not None else in_b
    c.charge_collective(kind, in_b, out_b, len(parts))


class trips:
    """``range(*args)`` for a Python loop whose iterations have equal
    shapes.  Under a folding `Counter` it yields the first two indices
    only: the first iteration is charged once and the second, standing for
    every later one (the first may differ in structure: a zero initial
    state that autograd does not record), ``len(range) - 1`` times, with
    the backward nodes it created.  ``stack`` and ``cat`` then stand the
    two iterations' results for all of them, charged as the full copy::

        steps = trips(S)
        for t in steps:
            hs.append(step(t))
        h = steps.stack(hs, 1)
    """

    def __init__(self, *args):
        self.range = range(*args)
        self.folded = False

    def __iter__(self):
        c = active()
        r = self.range
        if c is None or not c.fold or c._paused or len(r) < 3:
            yield from r
            return
        self.folded = True
        yield r[0]
        first = torch._C._autograd._get_sequence_nr()
        c._mult.append(len(r) - 1)
        try:
            yield r[1]
        finally:
            c._mult.pop()
            c._folds.append((first, torch._C._autograd._get_sequence_nr(),
                             len(r) - 1))

    def _join(self, items, dim, new_dim):
        n = len(self.range)
        c = active()
        with c.paused():
            a, b = items
            if new_dim:
                a, b = a.unsqueeze(dim), b.unsqueeze(dim)
            d = dim % b.dim()
            shape = list(b.shape)
            shape.insert(d, n - 1)
            merged = list(b.shape)
            merged[d] *= n - 1
            rest = b.unsqueeze(d).expand(shape).reshape(merged)
            out = torch.cat([a, rest], d)
        c._charge(0, 2 * _nbytes(out), out.dtype, c._multiplier())
        c.track(out)
        return out

    def stack(self, items, dim: int = 0):
        """``torch.stack(items, dim)`` over every iteration's item."""
        if not self.folded:
            return torch.stack(items, dim)
        return self._join(items, dim, True)

    def cat(self, items, dim: int = 0):
        """``torch.cat(items, dim)`` over every iteration's item."""
        if not self.folded:
            return torch.cat(items, dim)
        return self._join(items, dim, False)
