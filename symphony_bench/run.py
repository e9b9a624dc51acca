#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 symphony_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a model
configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); its correctness limit is ``cells/<name>.json``
and each per-layer metric is read by ``metrics/<name>.py``.  Set-up makes
the weights on the card from the seed, builds one serving node of the
port (`repro_torch`: a `NodeEngine` over a `RealBackend` with its
`NodeManager`), opens the mix's sessions with their earlier turns
prefilled and runs the closed loop for a warm-up; then the window runs
``--seconds`` of it on the wall clock.  Afterwards a sample of the turns
served in the window is judged against the plain float32 reference
(``reference.py``), and the last line of standard output is the result.
Without a CUDA device it exits 2 and prints no result.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()      # set-up is timed from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import heapq  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SHARE = 0.25        # the device trace starts this far into the window
TRACE_MAX_S = 10.0        # and lasts at most this long


def clock() -> float:
    return time.perf_counter() - T_PROCESS


# -- the benchmark's files, found by name ------------------------------------

def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def workload(name: str, bench: Dict) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str, bench_dir: Path = BENCH) -> Dict:
    return load_json(bench_dir / "traffic" / f"{name}.json")


def cell_file(name: str, bench_dir: Path = BENCH) -> Dict:
    return load_json(bench_dir / "cells" / f"{name}.json")


def metric_reader(name: str, bench_dir: Path = BENCH):
    """``read`` of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "symphony_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def program_modules() -> list:
    """Every module a run imports, the program's and the benchmark's (the
    import guard test loads this list in a clean process)."""
    import importlib
    names = ("numpy", "torch", "repro_torch.configs.base",
             "repro_torch.core.advisory", "repro_torch.core.node_manager",
             "repro_torch.kernels.ops", "repro_torch.kernels.paged_attention",
             "repro_torch.models.transformer", "repro_torch.serving.backend",
             "repro_torch.serving.cost_model", "repro_torch.serving.engine",
             "symphony_bench.gen", "symphony_bench.judge",
             "symphony_bench.reference", "symphony_bench.tracing",
             "symphony_bench.work")
    return [importlib.import_module(n) for n in names]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


# -- the model's kind, found by the configuration file's ``family`` --------

def family(name: str, bench_dir: Path = BENCH):
    """``families/<name>.py``: the sizes, model, weights and plain
    reference of one kind of model."""
    path = bench_dir / "families" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "symphony_bench_family_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


# -- the closed loop -----------------------------------------------------------

@dataclass
class Session:
    sid: str
    index: int
    script: object
    rng: object
    turn: int                                   # next turn to send
    tokens: List[int] = field(default_factory=list)
    moved: set = field(default_factory=set)     # "int8", "host"


@dataclass
class TurnRec:
    sess: Session
    turn: int                   # -1: the history prefilled at set-up
    req: object
    due: float
    new_tokens: int             # the turn's own prompt tokens
    start: int                  # where its prompt begins in sess.tokens
    n_prompt: int
    times: List[float] = field(default_factory=list)
    finished: Optional[float] = None
    outputs: List[int] = field(default_factory=list)
    prefilled: int = 0          # of new_tokens, through the steps so far


class Loop:
    """The mix's sessions as closed loops around one node."""

    def __init__(self, node, mix: Dict, deal, clock_fn, rec=None):
        self.eng, self.be, self.mgr = node
        self.mix = mix
        self.deal = deal
        self.clock = clock_fn
        self.rec = rec
        self.events: list = []
        self._seq = itertools.count()
        self._index = itertools.count()
        self.active: Dict[int, TurnRec] = {}
        self.turns: List[TurnRec] = []
        self.steps: List[tuple] = []       # (start, end, prompt tokens)
        self.sessions: Dict[str, Session] = {}

    # sessions and turns
    def open(self, script) -> Session:
        i = next(self._index)
        s = Session(f"s{i}", i, script, self.deal.token_rng(i), script.age)
        self.sessions[s.sid] = s
        return s

    def _request(self, s: Session, ids: List[int], gen: int, t: float,
                 turn: int, new_tokens: int):
        from repro_torch.core.advisory import InferenceRequest
        req = InferenceRequest(session_id=s.sid, prompt_tokens=len(ids),
                               max_new_tokens=gen, prompt_ids=list(ids),
                               cached_tokens=self.be.session_tokens(s.sid),
                               arrival=t)
        r = TurnRec(s, turn, req, t, new_tokens, len(s.tokens), len(ids))
        s.tokens.extend(ids)
        self.active[req.request_id] = r
        self.turns.append(r)
        self.eng.submit(req)
        return r

    def history(self, s: Session) -> Optional[TurnRec]:
        """Submit the session's turns before its age as one prompt (its
        replies as the bank drew them) that emits one token.  A session in
        flight also holds its next turn's prompt and the ``done`` tokens of
        its reply: the token emitted is the reply's next."""
        sc = s.script
        if sc.age == 0 and sc.done < 0:
            return None
        ids = list(self.deal.system)
        for turn in sc.turns[:sc.age]:
            ids += self.deal.turn_ids(s.rng, turn)
            ids += self.deal.reply_ids(s.rng, turn)
        if sc.done >= 0:
            turn = sc.turns[sc.age]
            ids += self.deal.turn_ids(s.rng, turn)
            ids += self.deal.reply_ids(s.rng, turn)[:sc.done]
        return self._request(s, ids, 1, self.clock(), -1, 0)

    def resume(self, s: Session, t: float) -> TurnRec:
        """The rest of an in-flight session's reply: a request with no new
        prompt over its cached history, whose first step feeds the token
        the history emitted."""
        turn = s.script.turns[s.turn]
        return self._request(s, [], turn.reply - s.script.done - 1, t,
                             s.turn, 0)

    def send(self, s: Session, t: float) -> TurnRec:
        turn = s.script.turns[s.turn]
        ids = self.deal.turn_ids(s.rng, turn)
        if s.turn == 0:
            ids = list(self.deal.system) + ids
        return self._request(s, ids, turn.reply, t, s.turn, turn.prompt)

    def advise(self, sid: str, lead: float, t: float) -> None:
        from repro_torch.core.advisory import AdvisoryRequest
        self.mgr.on_advisory(AdvisoryRequest(session_id=sid,
                                             expected_arrival=lead),
                             kv_node=self.mgr.node_id, now=t)

    def schedule(self, s: Session, t_free: float, think: float,
                 lead: float) -> None:
        """The session's next turn is due ``think`` after ``t_free``; its
        advisory fires ``lead`` before that (at once if already due)."""
        due = t_free + think
        if lead > 0:
            self.push(max(t_free, due - lead), "advise", (s, due))
        self.push(due, "due", s)

    def push(self, t, kind, payload) -> None:
        heapq.heappush(self.events, (t, next(self._seq), kind, payload))

    # stepping
    def fire(self, t: float) -> None:
        while self.events and self.events[0][0] <= t:
            _, _, kind, payload = heapq.heappop(self.events)
            if kind == "due":
                if payload.sid in self.sessions:
                    self.send(payload, t)
            else:
                s, due = payload
                if s.sid in self.sessions:
                    self.advise(s.sid, max(0.0, due - t), t)

    def step(self) -> None:
        t0 = self.clock()
        self.eng.step(t0)
        t1 = self.clock()
        # the turns' own prompt tokens that this step prefilled: each
        # turn's progress through them, read from the engine's lanes
        consumed = {run.req.request_id: run.consumed
                    for run in self.eng.running}
        consumed.update((req.request_id, req.prompt_tokens)
                        for req in self.eng.completed)
        fed = 0
        for r in list(self.active.values()):
            out = r.req.output_ids or []
            while len(r.times) < len(out):
                r.times.append(t1)
            c = min(consumed.get(r.req.request_id, 0), r.new_tokens)
            if r.turn >= 0 and c > r.prefilled:
                fed += c - r.prefilled
                r.prefilled = c
        self.steps.append((t0, t1, fed))
        for req in self.eng.completed:
            self._finish(self.active.pop(req.request_id), t1)
        self.eng.completed.clear()

    def _finish(self, r: TurnRec, t: float) -> None:
        s = r.sess
        r.finished = t
        r.outputs = list(r.req.output_ids)
        s.tokens.extend(r.outputs)
        if r.turn < 0:
            return
        s.turn += 1
        if s.turn < len(s.script.turns):
            nxt = s.script.turns[s.turn]
            self.schedule(s, t, nxt.think, nxt.lead)
            return
        # the session is done: its KV goes, and a fresh one takes its place
        self.mgr.drop_session(s.sid)
        del self.sessions[s.sid]
        fresh = self.open(self.deal.fresh())
        self.push(t, "due", fresh)

    def run_until(self, t_end: float, on_tick=None) -> None:
        while True:
            t = self.clock()
            if t >= t_end:
                return
            if on_tick is not None:
                on_tick(t)
            self.fire(t)
            span = self.rec.span if self.rec is not None \
                else (lambda name: contextlib.nullcontext())
            if self.eng.waiting or self.eng.running:
                with span("engine.step"):
                    self.step()
            else:
                nxt = self.events[0][0] if self.events else t_end
                with span("harness.wait"):
                    time.sleep(max(0.0, min(nxt, t_end) - t))

    def drain(self) -> None:
        """Step until nothing waits or runs (set-up only)."""
        while self.eng.waiting or self.eng.running:
            self.step()


# -- the node -------------------------------------------------------------------

def build_node(mcfg, model, params, mix: Dict, device):
    """The node a user of the port builds: `make_backend` gives the
    `RealBackend`, its `NodeManager` attached, the `NodeEngine` over it."""
    from repro_torch.core.node_manager import NodeManager
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.cost_model import CostModel
    from repro_torch.serving.engine import NodeEngine
    cost = CostModel(mcfg)
    cost.set_param_count(model.param_count())
    mgr = NodeManager(0, mcfg, cost, enable_quantize=mix["int8_tier"])
    pool = mix["pool"]
    be = make_backend(mcfg, model, params, n_pages=pool["n_pages"],
                      page_size=mix["page"], hbm_pages=pool["hbm_pages"],
                      spool_dir=None, mgr=mgr, trace_logits=False,
                      kernel_mode="auto", device=device)
    eng = NodeEngine(0, mcfg, cost, mgr, max_batch=mix["max_batch"],
                     backend=be, token_budget=mix["token_budget"])
    return eng, be, mgr


def watch_moves(be, sessions: Dict[str, Session]) -> None:
    """Mark the sessions whose pages the node quantized or sent to the
    host, so the judged sample can take them."""
    def mark(attr, tag):
        fn = getattr(be, attr)

        def wrapped(sid, *a, **k):
            out = fn(sid, *a, **k)
            s = sessions.get(sid)
            if s is not None and (attr != "quantize_session" or out):
                s.moved.add(tag)
            return out
        setattr(be, attr, wrapped)
    mark("quantize_session", "int8")
    mark("swap_out", "host")
    mark("evict_layer", "host")


def history_tokens(sc) -> int:
    """Tokens a script's history holds at the start, system prompt aside."""
    n = sum(t.prompt + t.reply for t in sc.turns[:sc.age])
    if sc.done >= 0:
        n += sc.turns[sc.age].prompt + sc.done
    return n


# -- one run --------------------------------------------------------------------

def percentile(values, q: float) -> Optional[float]:
    import numpy as np
    return float(np.percentile(np.asarray(values, float), q)) \
        if len(values) else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             root: Path = ROOT, data: Path = BENCH,
             t_origin: float = 0.0) -> Dict:
    """Set up, run the window and judge it; returns the result line's
    object (with ``checks`` last).  ``device`` is where the program and the
    reference run: the card for a benchmark run, the CPU in the tests."""
    import numpy as np
    import torch
    program_modules()
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    from symphony_bench import gen, judge, tracing

    bench = spec(root)
    cell = workload(name, bench)
    cfile = config_file(bench, cell["config"], root)
    mix = traffic_file(cell["traffic"], data)
    limits = cell_file(name, data)
    fam = family(cfile["family"])
    cfg = fam.sizes(cfile)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    # set-up: weights, node, sessions, warm-up
    t_w0 = clock()
    mcfg, model = fam.build(cfg, dev)
    params = fam.weights(cfg, seed, dev, model.dtype)
    if on_card:
        torch.cuda.synchronize(dev)
    t_w1 = clock()
    node = build_node(mcfg, model, params, mix, dev)
    eng, be, mgr = node
    rec = tracing.Recorder(clock) if trace else None
    deal = gen.Deal(mix, seed, cfg["vocab"])
    loop = Loop(node, mix, deal, clock, rec)
    watch_moves(be, loop.sessions)
    sessions = [loop.open(s) for s in deal.initial()]
    # histories, longest first, with a wide budget (set-up only): the first
    # alone, as it holds the system prompt that the others then share, the
    # rest ``setup_batch`` at a time, so lanes of a step are of like length
    order = sorted((s for s in sessions
                    if s.script.age or s.script.done >= 0),
                   key=lambda s: -history_tokens(s.script))
    k = mix.get("setup_batch", 1)
    eng.token_budget = mix["setup_token_budget"]
    groups = [order[:1]] + [order[j:j + k]
                            for j in range(1, len(order), k)]
    for group in groups:
        eng.max_batch = max(len(group), 1)
        for s in group:
            loop.history(s)
        loop.drain()
        for s in group:
            if s.script.done < 0:
                loop.advise(s.sid, s.script.offset, clock())
    eng.max_batch, eng.token_budget = mix["max_batch"], mix["token_budget"]
    if on_card:
        torch.cuda.synchronize(dev)
    t_hist = clock()
    t_loop = clock()
    for s in sessions:
        if s.script.done >= 0:
            loop.resume(s, t_loop)
            continue
        nxt = s.script.turns[s.turn]
        due = t_loop + s.script.offset
        lead = min(nxt.lead, s.script.offset) if s.turn else 0.0
        if lead > 0:
            loop.push(max(t_loop, due - lead), "advise", (s, due))
        loop.push(due, "due", s)
    loop.run_until(t_loop + mix["warmup_s"])
    if on_card:
        torch.cuda.synchronize(dev)

    # the window
    if rec is not None:
        rec.wrap(be, "step", "backend.step")
        rec.wrap(be, "poll_transfers", "backend.poll_transfers")
        rec.wrap_step_paged(model, cfg["n_heads"], cfg["d_head"])
        attn = ops.paged_chunk_attention
        rec.wrap(ops, "paged_chunk_attention", "ops.paged_chunk_attention")
    dtrace = tracing.DeviceTrace(clock) if (trace and on_card) else None
    if dtrace is not None:
        dtrace.warm(dev)           # the profiler's first start is slow
    t0 = clock()
    t_end = t0 + seconds
    t_tr0 = t0 + TRACE_SHARE * seconds
    trace_len = min(TRACE_MAX_S, 0.5 * seconds)
    s0 = (dict(eng.stats), dict(be.stats), dict(mgr.stats))
    k0 = (pa.launches, pa.quant_launches)
    kv0 = be.kv_in_use(eng.running) / be.hbm_kv_budget()
    n_steps0 = len(loop.steps)

    def tick(t):
        if dtrace is None:
            return
        if dtrace.prof is None and t >= t_tr0:
            dtrace.start(dev)
            rec.tracing = True
        elif rec.tracing and t >= dtrace.t_start + trace_len:
            rec.tracing = False
            dtrace.stop(dev)

    if rec is not None:
        rec.recording = True
    loop.run_until(t_end, tick)
    if dtrace is not None and rec.tracing:
        rec.tracing = False
        dtrace.stop(dev)
    if rec is not None:
        rec.recording = False
        ops.paged_chunk_attention = attn
        rec.to_host()
    if on_card:
        torch.cuda.synchronize(dev)
    # the window closes with the last step it started: its work and its
    # time are whole steps
    window_steps = loop.steps[n_steps0:]
    t_close = max([t_end] + [b for _, b, _ in window_steps])
    span = t_close - t0
    s1 = (dict(eng.stats), dict(be.stats), dict(mgr.stats))
    kv1 = be.kv_in_use(eng.running) / be.hbm_kv_budget()
    n_waiting, n_running = len(eng.waiting), len(eng.running)
    window_counters = {k: _delta(s0, s1, k) for k in (
        "quantized_pages", "quant_dispatches", "swaps_out", "swaps_in",
        "layer_evictions", "layer_promotions", "prefix_hits", "cow_forks",
        "stall_s", "copied_bytes", "preemptions", "chunks")}
    window_counters["kernel1_launches"] = pa.launches - k0[0]
    window_counters["b2_launches"] = pa.quant_launches - k0[1]

    # end-to-end metrics
    due = [r for r in loop.turns if r.turn >= 0 and t0 <= r.due < t_end]
    ttft = [((r.times[0] if r.times and r.times[0] <= t_close else t_close)
             - r.due) for r in due]
    # prompt tokens count in the step that prefilled them
    new_tok = sum(n for _, _, n in window_steps)
    gaps, gen_tok, served = [], 0, 0
    for r in loop.turns:
        if r.turn < 0:
            continue
        inside = [t for t in r.times if t0 <= t <= t_close]
        gen_tok += len(inside)
        gaps += list(np.diff(inside))
        if r.times and t0 <= r.times[0] <= t_close:
            served += 1
    totals = {"turn_tok_s": (new_tok + gen_tok) / span,
              "setup_s": t0 - t_origin}
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    pinned = None
    if on_card and hasattr(torch.cuda, "host_memory_stats"):
        pinned = {k: v for k, v in torch.cuda.host_memory_stats().items()
                  if "peak" in k and "bytes" in k}
    readings = None
    if trace:
        events = dtrace.events() if dtrace is not None else []
        t_tr = (dtrace.t_start, dtrace.t_stop) if dtrace else (t_end, t_end)
        readings = Readings(
            cfg=cfg, page=mix["page"], seconds=span,
            step_s=[b - a for a, b, _ in window_steps
                    if b <= t_tr[0] or a >= t_tr[1]],
            traced_step_s=[b - a for a, b, _ in window_steps
                           if a >= t_tr[0] and b <= t_tr[1]],
            turns_served=served,
            delta=window_counters,
            calls=rec.calls, events=events,
            trace_s=(dtrace.t_stop - dtrace.t_start) if dtrace else None,
            t_trace=(dtrace.t_start, dtrace.t_stop) if dtrace else None,
            on_card=on_card)
        breakdown = None
        if dtrace is not None:
            a, b = readings.t_trace
            breakdown = dict(
                device_ops=tracing.top_ops(events),
                idle_gaps=tracing.idle_gaps(events, a, b, rec.spans))

    # the judged sample, then the program's state goes and the reference runs
    sample = judge.sample(loop, t0, t_close, seed, limits["sample_tokens"])
    t_j0 = clock()
    del node, eng, be, mgr, loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    worst, judged = judge.worst_gap(params, cfg, sample, ref=fam)
    t_j1 = clock()
    lim = limits["max_logit_gap"]
    checks = {"max_logit_gap": {"value": worst, "limit": lim},
              "judged_tokens": {"value": judged,
                                "limit": limits["sample_tokens"]}}
    correct = (worst is not None and worst <= lim
               and judged >= limits["sample_tokens"])
    out = dict(correct=bool(correct), attempted=len(due), failed=0)
    if trace:
        per = {}
        for m in bench["per_layer"]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            v = metric_reader(m["name"])(readings)
            if v is not None:
                per[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = per
    else:
        out["metrics"] = {}
        for m in bench["end_to_end"]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            v = end_to_end(m["name"], totals, {"ttft": ttft, "tbt": gaps})
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    out["device"] = dict(
        platform="gpu" if on_card else "cpu",
        kind=torch.cuda.get_device_name(dev) if on_card else "cpu",
        count=1, memory_peak_bytes=int(peak))
    if trace and dtrace is not None:
        out["device"]["busy_s"] = tracing.busy_seconds(
            events, *readings.t_trace)
        out["device"]["window_s"] = readings.trace_s
        out["breakdown"] = breakdown
    out["setup"] = dict(weights_s=t_w1 - t_w0, history_s=t_hist - t_w1,
                        warmup_s=t0 - t_loop, sessions=len(sessions),
                        turns_served=served, steps=len(window_steps),
                        judge_s=t_j1 - t_j0)
    out["window_counters"] = window_counters
    out["diagnostics"] = dict(
        ttft_ms={q: 1e3 * percentile(ttft, q) for q in (50, 75, 90, 95)}
        if ttft else None,
        tbt_ms={q: 1e3 * percentile(gaps, q) for q in (50, 90, 95, 99)}
        if gaps else None,
        gaps=len(gaps),
        mean_step_ms=1e3 * float(np.mean(
            [b - a for a, b, _ in window_steps])) if window_steps else None,
        steps_ms=[1e3 * (b - a) for a, b, _ in window_steps],
        window_s=span, kv_share=[kv0, kv1], prompt_tokens=new_tok,
        generated_tokens=gen_tok,
        waiting_at_close=n_waiting, running_at_close=n_running,
        unserved=sum(1 for r in due if not r.times or r.times[0] > t_close),
        pinned_host=pinned)
    out["checks"] = checks
    return out


def end_to_end(name: str, totals: Dict, samples: Dict) -> Optional[float]:
    """An end-to-end metric by its name: ``turn_tok_s``, ``setup_s``, or a
    percentile ``<ttft|tbt>_p<q>_ms`` of the window's times to first token
    or of its gaps between tokens (seconds in ``samples``)."""
    if name in totals:
        return totals[name]
    m = re.fullmatch(r"(ttft|tbt)_p(\d+)_ms", name)
    if m is None:
        raise SystemExit(f"no end-to-end metric {name!r} in the harness")
    values = samples[m.group(1)]
    return 1e3 * percentile(values, int(m.group(2))) if values else None


def _delta(s0, s1, key) -> float:
    for a, b in zip(s0, s1):
        if key in b:
            return b[key] - a[key]
    return 0.0


@dataclass
class Readings:
    """What the per-layer readers read (``metrics/<name>.py``)."""
    cfg: Dict
    page: int
    seconds: float                 # the window, to its last step's end
    step_s: List[float]            # steps outside the device trace
    traced_step_s: List[float]     # steps inside it
    turns_served: int
    delta: Dict[str, float]
    calls: list
    events: list
    trace_s: Optional[float]
    t_trace: Optional[tuple]
    on_card: bool


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the run inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    cell = workload(args.workload, spec())
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"no CUDA device for {args.workload} (needs {cell['chips']}): "
              f"the benchmark runs only on the card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program must be there)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda:0")
    # checked after the window and the judging, before any result
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: nothing it runs may import "
              f"{', '.join(FORBIDDEN)}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
