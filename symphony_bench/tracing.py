"""Spans around the calls into the program's layers, the record of each
paged step, and the reading of the device trace.

Everything here is recorded from the benchmark's side: the program's
objects get wrappers on the instance (the engine's ``step`` is timed by the
loop itself, the backend's ``step`` and ``poll_transfers``, the model's
``step_paged``) and the module attribute ``ops.paged_chunk_attention`` is
wrapped while a traced run lasts.  Spans stay in memory.  The device trace
is ``torch.profiler`` over CUDA activity alone, for a part of the window;
its clock is put on the host's by a marker launched right after a
synchronise.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch


@dataclass
class Call:
    """One ``step_paged`` call: its shape and its lanes' offsets and
    contexts (device copies while the window runs, numpy after it)."""
    t: float
    q_shape: Tuple[int, int, int, int]
    q_offsets: object
    ctx_lens: object
    quant: bool
    traced: bool = False


@dataclass
class Recorder:
    clock: object
    spans: List[Tuple[str, float, float, int]] = field(default_factory=list)
    calls: List[Call] = field(default_factory=list)
    depth: int = 0
    tracing: bool = False        # inside the device trace's interval
    recording: bool = False      # inside the measured window

    def span(self, name):
        rec = self

        class _Span:
            def __enter__(self):
                self.t0 = rec.clock()
                rec.depth += 1
                return self

            def __exit__(self, *exc):
                rec.depth -= 1
                if rec.recording:
                    rec.spans.append((name, self.t0, rec.clock(), rec.depth))
                return False
        return _Span()

    def wrap(self, obj, attr: str, name: str) -> None:
        fn = getattr(obj, attr)

        def wrapped(*a, **k):
            with self.span(name):
                return fn(*a, **k)
        setattr(obj, attr, wrapped)

    def wrap_step_paged(self, model, n_heads: int, d_head: int) -> None:
        """Time ``step_paged`` and keep its lanes: the offsets and contexts
        are copied on the device, in the stream's order, so the host waits
        for nothing; ``to_host`` reads them once the window has closed."""
        fn = model.step_paged

        def wrapped(params, token_ids, k_pool, v_pool, tables, q_offsets,
                    ctx_lens, *a, quant=None, **k):
            with self.span("model.step_paged"):
                t = self.clock()
                out = fn(params, token_ids, k_pool, v_pool, tables,
                         q_offsets, ctx_lens, *a, quant=quant, **k)
                if self.recording:
                    B, Sq = token_ids.shape
                    self.calls.append(Call(
                        t, (B, Sq, n_heads, d_head), q_offsets.clone(),
                        ctx_lens.clone(), quant is not None,
                        traced=self.tracing))
            return out
        model.step_paged = wrapped

    def to_host(self) -> None:
        for c in self.calls:
            c.q_offsets = c.q_offsets.cpu().numpy()
            c.ctx_lens = c.ctx_lens.cpu().numpy()


class DeviceTrace:
    """``torch.profiler`` over CUDA activity between ``start`` and
    ``stop``; ``events()`` gives (name, start, end) of every device
    operation on the host's clock."""

    def __init__(self, clock):
        self.clock = clock
        self.prof = None
        self.t_start = self.t_stop = None
        self._mark = None

    def warm(self, device) -> None:
        """Start and stop the profiler once over nothing, so that the
        start inside the window does not pay its first-time set-up."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1)
            torch.cuda.synchronize(device)

    def start(self, device) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(device)
        self._mark = self.clock()
        torch.zeros(1, device=device).add_(1)     # the marker kernel
        torch.cuda.synchronize(device)
        self.t_start = self.clock()

    def stop(self, device) -> None:
        torch.cuda.synchronize(device)
        self.t_stop = self.clock()
        self.prof.__exit__(None, None, None)

    @staticmethod
    def _raw(prof) -> List[Tuple[str, float, float]]:
        """(name, start, end) in seconds on the profiler's clock."""
        out = []
        for e in prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()).upper():
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                s, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
            out.append((e.name(), s, s + d))
        out.sort(key=lambda x: x[1])
        return out

    def events(self) -> List[Tuple[str, float, float]]:
        try:
            raw = self._raw(self.prof)
        except (AttributeError, RuntimeError) as e:
            print(f"device trace unreadable: {e!r}", file=sys.stderr)
            return []
        print(f"device trace: {len(raw)} device operations; first "
              f"{[r[0][:40] for r in raw[:3]]}", file=sys.stderr)
        if not raw:
            return []
        # the first device operation is the marker, launched right after
        # the host read self._mark: put the profiler's clock on the host's
        off = self._mark - raw[0][1]
        return [(n, s + off, e + off) for n, s, e in raw[1:]
                if e + off > self.t_start]


def busy_seconds(events, t0: float, t1: float) -> float:
    """Seconds of [t0, t1] in which some device operation ran (the union
    over streams)."""
    busy, end = 0.0, t0
    for _, s, e in sorted(events, key=lambda x: x[1]):
        s, e = max(s, end), min(e, t1)
        if e > s:
            busy += e - s
            end = e
    return busy


def idle_gaps(events, t0: float, t1: float, spans, top: int = 10):
    """The longest stretches of [t0, t1] with no device operation, each
    named by the innermost benchmark span open at its middle."""
    gaps, end = [], t0
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if s > end:
            gaps.append((end, min(s, t1)))
        end = max(end, e)
    if end < t1:
        gaps.append((end, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        inner = [s for s in spans if s[1] <= mid <= s[2]]
        name = max(inner, key=lambda s: s[3])[0] if inner else "harness"
        out.append([name, b - a])
    return out


def top_ops(events, top: int = 10):
    """The device operations that took the most time, summed by name."""
    tot: Dict[str, float] = {}
    for n, s, e in events:
        tot[n] = tot.get(n, 0.0) + (e - s)
    return [[n[:120], t] for n, t in
            sorted(tot.items(), key=lambda x: -x[1])[:top]]
