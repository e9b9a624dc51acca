"""Asynchronous tier-transfer engine: KV migration off the critical path.

SYMPHONY's core claim is that multi-turn hints let K,V caches be moved
between tiers *before* a request needs them, so the serving step never
waits on a copy.  This module is the real-backend half of that claim: every
host<->device tier movement is LAUNCHED (the device-side gather or scatter
is enqueued on the compute stream and the host<->device copy on a side
copy stream, into or out of pinned host memory) and tracked as an
in-flight `Transfer` whose buffers are CUDA events (`EventBuffer`); the
serving loop keeps dispatching fused steps while the copies drain in the
background, and only *fences* a transfer where a consumer actually needs
its result:

    launch            in flight                 complete
      |                   |                        |
      v                   v                        v
  device op     .---------------------.   realize host arrays,
  dispatched -->| poll() at step edges |-> release leased pages,
  (non-block)   | fence() at consumers |   move store accounting,
                | poison() on crash    |   run deferred disk writes
                '---------------------'

Completion bookkeeping always runs on the caller's thread at well-defined
drain points (step start, allocation pressure, an explicit fence), never
concurrently — the data movement is asynchronous, the ledgers are
deterministic, and `PagedAllocator.check()` / `TieredKVStore.check()` hold
at every drain point.

Safety invariants:

* a swap-out's pages are only *leased* back to the allocator
  (`PagedAllocator.lease`) at launch and released on completion, so a
  preempted or still-in-flight transfer never loses the only copy of KV;
* a consumer that needs a payload before its transfer completed fences it
  through `PendingPayload.get()` — the residual wait is exactly the stall
  the engine measures;
* `poison()` (node crash) marks transfers dead WITHOUT running their
  completion: no host payload is installed, no disk file written, no store
  accounting moved — in-flight KV dies with the node instead of surviving
  as phantom state.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch

OUT, IN, PERSIST = "out", "in", "persist"


class EventBuffer:
    """A transfer buffer on the card: ready once a CUDA event recorded on
    ``stream`` after the copy (or the scatter) has fired.  It holds the
    tensors the copy reads or writes (``keep``) until then, so neither a
    pinned host buffer nor a gathered device tensor is freed under an
    in-flight copy."""

    __slots__ = ("event", "keep")

    def __init__(self, stream, keep=()):
        self.event = torch.cuda.Event()
        self.event.record(stream)
        self.keep = tuple(keep)

    def is_ready(self) -> bool:
        return self.event.query()

    def block_until_ready(self) -> None:
        self.event.synchronize()


class DoneBuffer:
    """The buffer of a transfer made on CPU tensors: the copy already
    happened when it was launched."""

    __slots__ = ()

    def is_ready(self) -> bool:
        return True

    def block_until_ready(self) -> None:
        pass


DONE = DoneBuffer()


def copy_to_host(tensors, stream, device):
    """Start device->host copies of ``tensors`` (made on the compute stream
    of ``device``) into pinned host memory on the side ``stream``; returns
    the host tensors and the buffer a transfer waits on.  With no stream
    (CPU tensors) the tensors already are host tensors."""
    if stream is None:
        return list(tensors), DONE
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    hosts = []
    with torch.cuda.stream(stream):
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t.record_stream(stream)
            hosts.append(h)
    return hosts, EventBuffer(stream, keep=(*tensors, *hosts))


class Transfer:
    """One in-flight tier movement (all layers of one session direction)."""

    __slots__ = ("sid", "kind", "bufs", "on_complete", "on_release",
                 "done", "poisoned", "launched_at", "nbytes")

    def __init__(self, sid: str, kind: str, bufs,
                 on_complete: Optional[Callable[["Transfer"], None]] = None,
                 on_release: Optional[Callable[["Transfer"], None]] = None,
                 nbytes: float = 0.0):
        self.sid = sid
        self.kind = kind                 # OUT | IN | PERSIST
        self.bufs = list(bufs)           # EventBuffer / DoneBuffer
        self.on_complete = on_complete   # full bookkeeping (once, at drain)
        self.on_release = on_release     # poison path: free resources only
        self.done = False
        self.poisoned = False
        self.launched_at = time.perf_counter()
        self.nbytes = nbytes

    def ready(self) -> bool:
        """Non-blocking: has the device finished every buffer's copy?"""
        return all(b.is_ready() for b in self.bufs)


class PendingPayload:
    """Host-tier placeholder for one (sid, layer) whose device->host gather
    is still in flight.  `get()` fences the owning transfer (running its
    completion bookkeeping) and returns the realized host payload — or
    None if the transfer was poisoned by a crash (the data is gone; the
    caller must fall back to the disk spool or recompute, never serve it).
    """

    __slots__ = ("engine", "transfer", "layer", "n_tokens", "payload")

    def __init__(self, engine: "TransferEngine", transfer: Transfer,
                 layer: int, n_tokens: int):
        self.engine = engine
        self.transfer = transfer
        self.layer = layer
        self.n_tokens = n_tokens
        self.payload: Optional[dict] = None   # filled by transfer completion

    def get(self) -> Optional[dict]:
        if self.payload is None and not self.transfer.poisoned:
            self.engine.complete(self.transfer)
        return self.payload


class TransferEngine:
    """In-flight transfer ledger: launch / poll / fence / poison.

    Single-threaded by design: `poll` and `fence` run completions on the
    caller's thread, so allocator and store mutations happen at drain
    points the serving loop chooses, and tests can assert invariants at
    each one.  Completion callbacks may themselves fence other transfers
    (a deferred disk write realizing a staged layer); reentrancy is safe
    because `_finish` is idempotent and list cleanup only filters done
    entries."""

    def __init__(self):
        self.inflight: List[Transfer] = []
        self.stats = dict(launched=0, completed=0, poisoned=0,
                          launched_bytes=0.0, fence_wait_s=0.0)

    # -- lifecycle ----------------------------------------------------------

    def launch(self, t: Transfer) -> Transfer:
        self.inflight.append(t)
        self.stats["launched"] += 1
        self.stats["launched_bytes"] += t.nbytes
        return t

    def _finish(self, t: Transfer) -> None:
        if t.done:
            return
        t.done = True                      # before callbacks: reentrancy-safe
        for b in t.bufs:
            b.block_until_ready()
        if t.on_complete is not None:
            t.on_complete(t)
        self.stats["completed"] += 1

    def _sweep(self) -> None:
        self.inflight = [t for t in self.inflight if not t.done]

    # -- drain points -------------------------------------------------------

    def poll(self) -> int:
        """Complete every transfer whose device work already finished.
        Non-blocking: an unfinished copy stays in flight.  Returns the
        number completed."""
        n = 0
        for t in list(self.inflight):
            if not t.done and t.ready():
                self._finish(t)
                n += 1
        self._sweep()
        return n

    def complete(self, t: Transfer) -> None:
        """Blocking fence of one transfer (and its bookkeeping)."""
        self._finish(t)
        self._sweep()

    def fence(self, sid: Optional[str] = None,
              kind: Optional[str] = None) -> float:
        """Blocking fence of every matching in-flight transfer; returns the
        wall seconds spent waiting (the *residual* cost the critical path
        actually paid — ~0 when the transfer was launched early enough)."""
        t0 = time.perf_counter()
        for t in list(self.inflight):
            if ((sid is None or t.sid == sid)
                    and (kind is None or t.kind == kind)):
                self._finish(t)
        self._sweep()
        dt = time.perf_counter() - t0
        self.stats["fence_wait_s"] += dt
        return dt

    def drain(self) -> None:
        self.fence()

    def poison(self, sid: Optional[str] = None, kind: Optional[str] = None,
               release: bool = False) -> int:
        """Kill matching in-flight transfers WITHOUT completion bookkeeping
        (crash: data lost, nothing installed anywhere).  With ``release``
        the resource-only callback still runs (a cancelled transfer on a
        live node must return its leased pages)."""
        n = 0
        for t in list(self.inflight):
            if t.done or (sid is not None and t.sid != sid) \
                    or (kind is not None and t.kind != kind):
                continue
            t.poisoned = True
            t.done = True
            if release and t.on_release is not None:
                t.on_release(t)
            n += 1
        self._sweep()
        self.stats["poisoned"] += n
        return n

    # -- queries ------------------------------------------------------------

    @property
    def pending(self) -> int:
        return len(self.inflight)

    def pending_kind(self, kind: str) -> bool:
        return any(t.kind == kind for t in self.inflight)

    def pending_for(self, sid: str, kind: Optional[str] = None) -> bool:
        return any(t.sid == sid and (kind is None or t.kind == kind)
                   for t in self.inflight)
