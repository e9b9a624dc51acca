"""Node-local paged KV-cache allocator (vLLM-style block tables).

Pages are the unit of everything in SYMPHONY's node manager: allocation,
tier placement, migration, and the paged attention kernel's block
tables.  This allocator owns the *physical* page pool of one node and hands
out per-sequence block tables; the TieredKVStore (core/memory.py) tracks
which tier each (session, layer) page group lives in.

Design notes vs the GPU original (DESIGN.md §3): the pool is a dense
(P, page_size, Hkv, D) array per layer — one static shape — and the
block table is the only indirection; copy-on-migrate swaps page *contents*,
never remaps live tables mid-step (tables are step inputs).

Pages are REFCOUNTED so cross-session prefix sharing can attach many
sequences to the same physical page (copy-on-write, Pensieve-style).  A
page is held by (a) every sequence whose block table references it, (b)
explicit `ref()` pins, and (c) in-flight transfer leases — three separate
ledgers, because they have different lifetimes:

    refcount[p]  = #sequence references + #explicit pins  (external[p])
    leased[p]    = #in-flight transfers still reading p

A page returns to the free list only when BOTH counts reach zero.  `free`
and `truncate` decrement instead of freeing; `lease` converts a sequence's
hold into a transfer hold; `fork_cow` gives a writer a private copy of a
page other holders still read.  `check()` asserts conservation of all
three ledgers after every mutation sequence.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


class OutOfPages(RuntimeError):
    pass


class OutOfSlots(OutOfPages):
    """Fixed-slot pool exhausted.  Subclasses OutOfPages so the engine's
    pressure path (reclaim leases -> cooperative purge -> preempt) applies
    unchanged to recurrent-state allocation failures."""


@dataclass
class SeqAlloc:
    seq_id: str
    pages: List[int] = field(default_factory=list)
    n_tokens: int = 0


class PagedAllocator:
    """Physical page bookkeeping for one node (one pool per layer group)."""

    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = n_pages
        self.page_size = page_size
        self.free_list: List[int] = list(range(n_pages - 1, -1, -1))
        self.seqs: Dict[str, SeqAlloc] = {}
        # page -> total holds (sequence references + explicit pins)
        self.refcount: Dict[int, int] = {}
        # page -> explicit ref()/unref() pins (a subset of refcount, kept
        # separately so check() can prove refcount == seq occurrences + pins)
        self.external: Dict[int, int] = {}
        # page -> in-flight transfer holds: removed from a sequence but
        # still physically read by a device->host copy
        # (serving/transfer.py): neither owned nor free until release().
        # A COUNT, not a set — two transfers (e.g. two sharers swapping
        # out) may hold the same shared page simultaneously
        self.leased: Dict[int, int] = {}
        # pages whose live contents are the INT8 shadow pool (per-page
        # precision bit of the quantized-in-HBM tier).  Purely physical —
        # follows the page, not the sequence: shared pages are quantized
        # for every holder at once, and the bit clears whenever the page
        # re-enters the free list (a recycled page always starts fp)
        self.quantized: set = set()
        self.stats = dict(allocs=0, frees=0, peak_used=0, leases=0,
                          shared=0, cow_forks=0, quantized=0,
                          dequantized=0)

    # -- capacity ----------------------------------------------------------------

    @property
    def used_pages(self) -> int:
        """PHYSICAL pages in use (a shared page counts once)."""
        return self.n_pages - len(self.free_list)

    def pages_for(self, n_tokens: int) -> int:
        return (n_tokens + self.page_size - 1) // self.page_size

    def can_fit(self, n_tokens: int, seq_id: Optional[str] = None) -> bool:
        have = self.seqs[seq_id].pages if seq_id in self.seqs else []
        need = self.pages_for((self.seqs[seq_id].n_tokens if seq_id in
                               self.seqs else 0) + n_tokens) - len(have)
        return need <= len(self.free_list)

    # -- refcount plumbing --------------------------------------------------------

    def _take(self, page: int) -> None:
        self.refcount[page] = self.refcount.get(page, 0) + 1

    def _put(self, page: int) -> None:
        """Drop one refcount hold; the page frees at 0 holds + 0 leases."""
        n = self.refcount[page] - 1
        if n > 0:
            self.refcount[page] = n
            return
        del self.refcount[page]
        if not self.leased.get(page):
            self.quantized.discard(page)
            self.free_list.append(page)
            self.stats["frees"] += 1

    def refcount_of(self, page: int) -> int:
        return self.refcount.get(page, 0)

    # -- quantized-in-HBM precision bit -------------------------------------------

    def set_quantized(self, page: int, flag: bool = True) -> None:
        """Flip a held page's precision bit.  The device-side contents move
        (compress_paged / fork_paged_quant) are the caller's job; this is
        the bookkeeping the kernel's per-page dequant flags are rebuilt
        from on every dispatch."""
        assert self.refcount.get(page, 0) > 0 or self.leased.get(page, 0) > 0, \
            f"quantize bit on unheld page {page}"
        if flag and page not in self.quantized:
            self.quantized.add(page)
            self.stats["quantized"] += 1
        elif not flag and page in self.quantized:
            self.quantized.discard(page)
            self.stats["dequantized"] += 1

    def is_quantized(self, page: int) -> bool:
        return page in self.quantized

    def quantized_pages_of(self, seq_id: str) -> List[int]:
        s = self.seqs.get(seq_id)
        if s is None:
            return []
        return [p for p in s.pages if p in self.quantized]

    # -- alloc / extend / free -----------------------------------------------------

    def allocate(self, seq_id: str, n_tokens: int) -> SeqAlloc:
        assert seq_id not in self.seqs
        self.seqs[seq_id] = SeqAlloc(seq_id)
        try:
            return self.extend(seq_id, n_tokens)
        except OutOfPages:
            del self.seqs[seq_id]     # failed admission must not poison sid
            raise

    def extend(self, seq_id: str, new_tokens: int) -> SeqAlloc:
        s = self.seqs[seq_id]
        target = self.pages_for(s.n_tokens + new_tokens)
        need = target - len(s.pages)
        if need > len(self.free_list):
            raise OutOfPages(
                f"{seq_id}: need {need} pages, have {len(self.free_list)}")
        for _ in range(need):
            p = self.free_list.pop()
            s.pages.append(p)
            self._take(p)
            self.stats["allocs"] += 1
        s.n_tokens += new_tokens
        self.stats["peak_used"] = max(self.stats["peak_used"], self.used_pages)
        return s

    def free(self, seq_id: str) -> int:
        """Detach a sequence; each page's refcount drops by one and only
        sole-held pages (no other sharer, no pin, no lease) are freed."""
        s = self.seqs.pop(seq_id, None)
        if s is None:
            return 0
        for p in reversed(s.pages):
            self._put(p)
        return len(s.pages)

    def lease(self, seq_id: str) -> List[int]:
        """Detach a sequence whose pages an in-flight transfer still reads:
        the sequence disappears from the table, but its pages stay out of
        the free list until `release()` — a swap-out that has not completed
        must never have its source pages handed to another sequence.  A
        shared page stays allocated for its other holders regardless."""
        s = self.seqs.pop(seq_id, None)
        if s is None:
            return []
        for p in s.pages:
            self.leased[p] = self.leased.get(p, 0) + 1
            # convert the sequence hold into a transfer hold (no free: the
            # lease keeps the page out of the free list)
            n = self.refcount[p] - 1
            if n > 0:
                self.refcount[p] = n
            else:
                del self.refcount[p]
        self.stats["leases"] += len(s.pages)
        return list(s.pages)

    def release(self, pages: List[int]) -> None:
        """Return transfer holds (copy landed/cancelled); pages with no
        remaining holder of any kind go back to the free list."""
        for p in pages:
            held = self.leased.get(p, 0)
            assert held > 0, f"releasing a non-leased page {p}"
            if held > 1:
                self.leased[p] = held - 1
                continue
            del self.leased[p]
            if not self.refcount.get(p):
                self.quantized.discard(p)
                self.free_list.append(p)
                self.stats["frees"] += 1

    def truncate(self, seq_id: str, n_tokens: int) -> None:
        """Release tail pages (e.g. after demoting part of a session)."""
        s = self.seqs[seq_id]
        keep = self.pages_for(n_tokens)
        while len(s.pages) > keep:
            self._put(s.pages.pop())
        s.n_tokens = min(s.n_tokens, n_tokens)

    # -- prefix sharing (copy-on-write) ------------------------------------------

    def ref(self, pages: List[int]) -> None:
        """Pin live pages (they must already be held by someone)."""
        for p in pages:
            assert self.refcount.get(p, 0) > 0 or self.leased.get(p, 0) > 0, \
                f"ref of unheld page {p}"
            self._take(p)
            self.external[p] = self.external.get(p, 0) + 1

    def unref(self, pages: List[int]) -> None:
        for p in pages:
            pins = self.external.get(p, 0)
            assert pins > 0, f"unref of unpinned page {p}"
            if pins > 1:
                self.external[p] = pins - 1
            else:
                del self.external[p]
            self._put(p)

    def share(self, dst_id: str, pages: List[int], n_tokens: int) -> SeqAlloc:
        """Attach a NEW sequence to an existing prefix's pages (no copy):
        each shared page gains a refcount hold.  ``n_tokens`` is the shared
        token span; it must exactly fill ``pages`` (page-aligned sharing,
        or a trailing partial page the writer will CoW-fork into)."""
        assert dst_id not in self.seqs
        assert self.pages_for(n_tokens) == len(pages), \
            f"{dst_id}: {n_tokens} tokens need {self.pages_for(n_tokens)} " \
            f"pages, got {len(pages)}"
        for p in pages:
            assert self.refcount.get(p, 0) > 0, \
                f"sharing unheld page {p} with {dst_id}"
        s = SeqAlloc(dst_id, pages=list(pages), n_tokens=n_tokens)
        self.seqs[dst_id] = s
        for p in pages:
            self._take(p)
        self.stats["shared"] += len(pages)
        return s

    def fork_cow(self, seq_id: str, page_index: int
                 ) -> Optional[Tuple[int, int]]:
        """Copy-on-write fork: give ``seq_id`` a private copy of the page at
        ``page_index`` in its block table IF other holders still reference
        it.  Returns (old_page, new_page) for the caller to copy contents
        (device-side), or None when the sequence is the sole holder and may
        write in place.  Raises OutOfPages when no free page is available —
        the caller's pressure path (reclaim leases / preempt) applies."""
        s = self.seqs[seq_id]
        old = s.pages[page_index]
        if self.refcount.get(old, 0) <= 1:
            return None                  # sole holder: write in place
        if not self.free_list:
            raise OutOfPages(f"{seq_id}: CoW fork of page {old} needs a "
                             f"free page, have 0")
        new = self.free_list.pop()
        self._take(new)
        s.pages[page_index] = new
        # drop this sequence's hold on the shared original (cannot free:
        # refcount was > 1)
        self.refcount[old] -= 1
        self.stats["allocs"] += 1
        self.stats["cow_forks"] += 1
        self.stats["peak_used"] = max(self.stats["peak_used"], self.used_pages)
        return old, new

    # -- kernel interface -------------------------------------------------------------

    def block_table(self, seq_id: str, max_pages: Optional[int] = None
                    ) -> np.ndarray:
        """Padded int32 block table row for the paged_attention kernel.

        Columns beyond the row's own pages repeat the LAST VALID page id
        (not 0): the kernel's clamped index maps then see an unchanged
        block index across the padded tail, so the tile copy is elided
        instead of re-fetching page 0 once per lane.  Padded columns are
        still fully compute-masked (kpos >= ctx), so this is purely a DMA
        optimisation — rows with no pages keep the zero fill."""
        s = self.seqs[seq_id]
        width = max_pages or len(s.pages)
        fill = s.pages[-1] if s.pages else 0
        out = np.full((width,), fill, np.int32)
        out[:len(s.pages)] = s.pages
        return out

    def batch_block_tables(self, seq_ids: List[str],
                           max_pages: Optional[int] = None) -> np.ndarray:
        """Stacked padded tables; ``max_pages`` pins the width so bucketed
        dispatch can hold the kernel shape constant across batches."""
        width = max_pages or max((len(self.seqs[s].pages)
                                  for s in seq_ids), default=1)
        return np.stack([self.block_table(s, width) for s in seq_ids])

    def ctx_lens(self, seq_ids: List[str]) -> np.ndarray:
        return np.asarray([self.seqs[s].n_tokens for s in seq_ids], np.int32)

    # -- invariant ----------------------------------------------------------------------

    def check(self) -> None:
        occ = Counter(p for s in self.seqs.values() for p in s.pages)
        for s in self.seqs.values():
            assert len(set(s.pages)) == len(s.pages), \
                f"{s.seq_id}: duplicate page in one block table"
        # refcount conservation: every hold is a sequence reference or a pin
        for p, n in self.refcount.items():
            assert n == occ.get(p, 0) + self.external.get(p, 0), \
                f"page {p}: refcount {n} != {occ.get(p, 0)} seq refs + " \
                f"{self.external.get(p, 0)} pins"
            assert n > 0, f"page {p}: zero refcount entry"
        for p in occ:
            assert p in self.refcount, f"page {p}: owned but not refcounted"
        for p, n in self.external.items():
            assert n > 0 and p in self.refcount, f"page {p}: dangling pin"
        for p, n in self.leased.items():
            assert n > 0, f"page {p}: zero lease entry"
        held = set(self.refcount) | set(self.leased)
        free = set(self.free_list)
        assert len(free) == len(self.free_list), "duplicate free page"
        assert held.isdisjoint(free), "freed-in-use page"
        assert len(held) + len(free) == self.n_pages, "leak"
        # the precision bit follows held pages only: a free page is always
        # full precision (recycled pages must never read stale int8)
        assert self.quantized <= held, \
            f"quantized bit on free pages: {self.quantized - held}"


class StateAllocator:
    """Fixed-size recurrent-state slot allocator (SSM conv+state, mLSTM
    C/n/m, sLSTM c/n/h/m): the O(1)-per-session counterpart of
    `PagedAllocator`, with the SAME lease discipline and conservation
    `check()`.

    A slot is one row of every stacked state pool — a session owns exactly
    one slot while resident.  There is no refcounting or copy-on-write:
    recurrent state is never prefix-shared (the whole point of O(1) state
    is that it is 100% session-private).  `lease()` detaches a sequence
    whose slot an in-flight device->host copy still reads, keeping the slot
    out of the free list until `release()` — identical semantics to page
    leases, so a crashed or preempted transfer can never hand a mid-copy
    slot to another session."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.free_list: List[int] = list(range(n_slots - 1, -1, -1))
        self.seqs: Dict[str, int] = {}           # sid -> slot
        self.leased: Dict[int, int] = {}         # slot -> transfer holds
        self.stats = dict(allocs=0, frees=0, peak_used=0, leases=0)

    @property
    def used_slots(self) -> int:
        return self.n_slots - len(self.free_list)

    def can_fit(self, seq_id: Optional[str] = None) -> bool:
        return seq_id in self.seqs or bool(self.free_list)

    def allocate(self, seq_id: str) -> int:
        assert seq_id not in self.seqs
        if not self.free_list:
            raise OutOfSlots(f"{seq_id}: no free state slot "
                             f"(all {self.n_slots} in use)")
        slot = self.free_list.pop()
        self.seqs[seq_id] = slot
        self.stats["allocs"] += 1
        self.stats["peak_used"] = max(self.stats["peak_used"],
                                      self.used_slots)
        return slot

    def slot_of(self, seq_id: str) -> int:
        return self.seqs[seq_id]

    def free(self, seq_id: str) -> int:
        """Detach a sequence; its slot returns to the free list unless an
        in-flight transfer still leases it."""
        slot = self.seqs.pop(seq_id, None)
        if slot is None:
            return 0
        if not self.leased.get(slot):
            self.free_list.append(slot)
            self.stats["frees"] += 1
        return 1

    def lease(self, seq_id: str) -> Optional[int]:
        """Detach a sequence whose slot an in-flight transfer still reads:
        the slot stays out of the free list until `release()`."""
        slot = self.seqs.pop(seq_id, None)
        if slot is None:
            return None
        self.leased[slot] = self.leased.get(slot, 0) + 1
        self.stats["leases"] += 1
        return slot

    def release(self, slot: int) -> None:
        """Return one transfer hold (copy landed/cancelled)."""
        held = self.leased.get(slot, 0)
        assert held > 0, f"releasing a non-leased slot {slot}"
        if held > 1:
            self.leased[slot] = held - 1
            return
        del self.leased[slot]
        if slot not in self.seqs.values():
            self.free_list.append(slot)
            self.stats["frees"] += 1

    def check(self) -> None:
        owned = list(self.seqs.values())
        assert len(set(owned)) == len(owned), "slot owned by two sequences"
        for s, n in self.leased.items():
            assert n > 0, f"slot {s}: zero lease entry"
        held = set(owned) | set(self.leased)
        free = set(self.free_list)
        assert len(free) == len(self.free_list), "duplicate free slot"
        assert held.isdisjoint(free), "freed-in-use slot"
        assert len(held) + len(free) == self.n_slots, "slot leak"
