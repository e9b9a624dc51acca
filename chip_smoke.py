"""Card check of the PyTorch/CUDA port: builds the CUDA kernels, holds each
against its plain PyTorch version, and serves llama3-8b at full width and
depth through the port's entry points.

Run from the repository root on a machine with an NVIDIA card:

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases 1,2,3

Phases:
  1. environment: the card's name and power limit;
  2. build: nvcc for sm_90a, with the registers, shared memory and spills
     that ptxas reports;
  3. kernel vs plain version at llama3-8b widths (H=32, Hkv=8, D=128,
     page 16) in bf16 and fp32: decode at B=8 and 32 (ctx up to 4096),
     chunks of 128 and 512 at q_offsets > 0, ctx=0 lanes, permuted tables
     with last-valid padding; times of the kernel, the plain version, the
     bound and a library yardstick;
  4. serve llama3-8b (32 layers, bf16, random weights from --seed) with
     NodeEngine + NodeManager + RealBackend: 4 sessions x 3 turns, chunked
     prompts, a shared system prompt adopted across sessions with a
     copy-on-write fork.  The kernel's launches must cover every layer of
     every dispatch; a lockstep twin on the plain attention must agree;
     the main path's kernel calls are re-timed against their bound;
  5. exact tokens in fp32 (full width, 2 layers): served turns equal the
     dense prefill/decode recompute.

It prints progress lines, then one line with the kernels' JSON record, the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}.  Any failed phase exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core.advisory import InferenceRequest  # noqa: E402
from repro_torch.core.node_manager import NodeManager  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serving.backend import RealBackend  # noqa: E402
from repro_torch.serving.cost_model import CostModel  # noqa: E402
from repro_torch.serving.engine import NodeEngine  # noqa: E402

# H100 SXM data sheet, dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# tests/test_kernels.py's tolerances, scaled by max |plain| on real rows
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
KERNEL = pa.paged_chunk_attention          # the wrapper; it counts pa.launches


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_work(q, tables, q_offsets, ctx_lens, page, hkv, d, itemsize,
                   q_lens):
    """Bytes a paged attention call must move and the operations it must do
    for THESE inputs: each real query row read and its output written once
    (nothing for bucket padding or ctx=0 lanes), each lane's relevant K/V
    rows once (per kv head), the tables' relevant columns; QK and PV over
    the keys each real query row sees (4 D operations per head and key)."""
    B, Sq, H, D = q.shape
    qo = q_offsets.cpu().numpy().astype(np.int64)
    cx = ctx_lens.cpu().numpy().astype(np.int64)
    nbytes = 2 * B * 4
    flops = 0
    for b in range(B):
        if cx[b] == 0:
            continue
        n = int(q_lens[b])
        nbytes += 2 * n * H * D * itemsize
        nbytes += 2 * int(cx[b]) * hkv * d * itemsize
        nbytes += 4 * (-(-int(cx[b]) // page))
        seen = np.minimum(cx[b], qo[b] + np.arange(n) + 1)
        flops += 4 * D * H * int(seen.sum())
    return nbytes, flops


def bound(nbytes: int, flops: int, dtype):
    """(bound ms, what bounds it, bytes ms, operations ms)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_b, t_f), "bytes" if t_b >= t_f else "operations", t_b, t_f)


def sdpa_yardstick(q, k_pages, v_pages, tables, q_offsets, ctx_lens):
    """One PyTorch call computing the same attention on densely gathered
    K/V: F.scaled_dot_product_attention with a causal-and-context mask.
    The gather and mask are built here, outside the timed call; the port
    never calls this."""
    B, Sq, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    G = H // Hkv
    S = tables.shape[1] * page
    t = tables.long()
    k = k_pages[t].reshape(B, S, Hkv, D).transpose(1, 2)
    v = v_pages[t].reshape(B, S, Hkv, D).transpose(1, 2)
    k = k.repeat_interleave(G, dim=1).contiguous()
    v = v.repeat_interleave(G, dim=1).contiguous()
    qt = q.transpose(1, 2).contiguous()
    qpos = q_offsets.long()[:, None] + torch.arange(Sq, device=q.device)
    kpos = torch.arange(S, device=q.device)
    mask = (qpos[:, :, None] >= kpos) & (kpos < ctx_lens.long()[:, None, None])
    mask = mask[:, None]
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


def compare(q, kp, vp, tables, qoff, ctx, q_lens, dtype, label):
    """Kernel vs plain on one input; returns a record with the error on
    real rows, the times and the bound.  The error must be
    within TOL x max |plain| over the real rows: the outputs are averages
    of V rows, far below 1 at long contexts, where a fixed tolerance would
    pass a kernel that drops a page or shifts the causal mask."""
    out_k = KERNEL(q, kp, vp, tables, qoff, ctx)
    torch.cuda.synchronize()
    out_r = ref.paged_chunk_attention_ref(q, kp, vp, tables, qoff, ctx)
    check(bool(torch.isfinite(out_k.float()).all()),
          f"{label}: kernel output not finite")
    err, scale = 0.0, 0.0
    cx = ctx.cpu().numpy()
    for b in range(q.shape[0]):
        if cx[b] == 0:
            check(bool((out_k[b] == 0).all()),
                  f"{label}: ctx=0 lane {b} is not exactly zero")
            continue
        n = int(q_lens[b])
        check(bool((out_k[b, n:] == 0).all()),
              f"{label}: lane {b}'s padding rows are not zeros")
        want = out_r[b, :n].float()
        err = max(err, (out_k[b, :n].float() - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
    lim = TOL[dtype] * scale
    check(err <= lim, f"{label}: max abs err {err:.3g} > {TOL[dtype]} x "
          f"max|plain| {scale:.3g} = {lim:.3g}")
    _, page, hkv, d = kp.shape
    nbytes, flops = attention_work(q, tables, qoff, ctx, page, hkv, d,
                                   q.element_size(), q_lens)
    b_ms, b_by, t_b, t_f = bound(nbytes, flops, dtype)
    return dict(
        label=label, max_abs_err=err, err_rel=err / scale,
        ms=cuda_ms(lambda: KERNEL(q, kp, vp, tables, qoff, ctx), 20),
        plain_ms=cuda_ms(lambda: ref.paged_chunk_attention_ref(
            q, kp, vp, tables, qoff, ctx), 5),
        library_ms=cuda_ms(sdpa_yardstick(q, kp, vp, tables, qoff, ctx), 20),
        bound_ms=b_ms, bound_by=b_by, bytes_ms=t_b, ops_ms=t_f)


def fmt(rec) -> str:
    keys = ("max_abs_err", "err_rel", "ms", "plain_ms", "library_ms",
            "bound_ms")
    parts = [f"{k}={rec[k]:.4g}" for k in keys if k in rec]
    if "bound_by" in rec:
        parts.append(f"bound_by={rec['bound_by']}")
    return f"  {rec['label']}: " + " ".join(parts)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env():
    check(torch.cuda.is_available(), "no CUDA device: torch.cuda.is_available() "
          "is False")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"[1] device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return kind, card


def phase_build():
    t0 = time.perf_counter()
    path, text = build.build(pa.NAME)
    log(f"[2] {'built' if text else 'up to date:'} {path} in "
        f"{time.perf_counter() - t0:.1f} s")
    spills = []
    for line in text.splitlines():
        if any(w in line for w in ("Compiling entry", "registers")):
            log(f"[2] {pa.NAME}: {line.strip()}")
        if "spill" in line:
            spills.append(line.strip())
    if text:
        log(f"[2] {pa.NAME}: spills: "
            f"{'; '.join(spills) or 'none reported by ptxas'}")


def make_case(rng, B, Sq, ctxs, q_lens, dtype, page=16, H=32, Hkv=8, D=128,
              extra_pages=64):
    """Random q and pools; lane b holds ctxs[b] tokens on a permuted page
    set, its last q_lens[b] tokens are this step's chunk; ctx 0 = padded
    lane.  Tables are last-valid padded to a power-of-two width."""
    dev = "cuda"
    need = [-(-c // page) for c in ctxs]
    T = 1
    while T < max(max(need), 1):
        T <<= 1
    P = sum(need) + extra_pages
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    kp = torch.randn((P + 1, page, Hkv, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P + 1, page, Hkv, D), generator=gen, device=dev).to(dtype)
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dtype)
    perm = rng.permutation(P)
    tables = np.zeros((B, T), np.int32)
    qoff = np.zeros((B,), np.int32)
    used = 0
    for b, c in enumerate(ctxs):
        if c == 0:
            continue
        tables[b, :need[b]] = perm[used:used + need[b]]
        tables[b, need[b]:] = tables[b, need[b] - 1]
        used += need[b]
        qoff[b] = c - q_lens[b]
    as_t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return q, kp, vp, as_t(tables), as_t(qoff), as_t(np.asarray(ctxs, np.int32))


def phase_kernel_vs_plain(rng):
    cases = []
    for B in (8, 32):
        ctxs = [int(c) for c in rng.integers(1024, 4097, B)]
        ctxs[-1] = 0                                   # padded lane
        ctxs[0] = 4096
        cases.append((f"decode B={B} ctx<=4096", B, 1, ctxs, [1] * B))
    for Sq, B in ((128, 4), (512, 2)):
        ctxs, qls = [], []
        for b in range(B):
            n = Sq if b % 2 == 0 else Sq - 27           # ragged chunk
            ctxs.append(int(rng.integers(256, 1537)) + n)
            qls.append(n)
        ctxs.append(0)
        qls.append(0)
        cases.append((f"chunk Sq={Sq} q_offset>0", B + 1, Sq, ctxs, qls))
    recs = []
    for label, B, Sq, ctxs, qls in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, tab, qoff, ctx = make_case(rng, B, Sq, ctxs, qls, dtype)
            rec = compare(q, kp, vp, tab, qoff, ctx, qls, dtype,
                          f"{label} {str(dtype).split('.')[-1]}")
            log("[3]" + fmt(rec))
            recs.append(rec)
            del q, kp, vp
    torch.cuda.empty_cache()
    return recs


def _turns(rng, vocab, n_sessions=4, n_turns=3, system=200):
    """Token ids of every (session, turn) prompt: 256-1024 tokens each;
    sessions 0 and 1 open with the same `system`-token system prompt."""
    sys_ids = [int(t) for t in rng.integers(0, vocab, system)]
    prompts = []
    for s in range(n_sessions):
        turns = []
        for t in range(n_turns):
            n = int(rng.integers(256, 1025))
            if t == 0 and s < 2:
                user = [int(x) for x in rng.integers(0, vocab, n - system)]
                turns.append(sys_ids + user)
            else:
                turns.append([int(x) for x in rng.integers(0, vocab, n)])
        prompts.append(turns)
    return prompts


def make_engine(cfg, model, params, *, kernel_mode="auto",
                trace_logits=False, n_pages=1024, page_size=16):
    """NodeEngine + NodeManager + RealBackend on the model's device, as a
    user of the port would build them."""
    cost = CostModel(cfg)
    cost.set_param_count(model.param_count())
    mgr = NodeManager(0, cfg, cost)
    be = RealBackend(cfg, model, params, n_pages=n_pages, page_size=page_size,
                     mgr=mgr, trace_logits=trace_logits,
                     kernel_mode=kernel_mode, device=model.device)
    eng = NodeEngine(0, cfg, cost, mgr, max_batch=8, backend=be,
                     token_budget=512)
    return eng, be


def rounds(prompts):
    """(session, turn) pairs submitted together: round 0 is session 0's
    first turn alone (finished, and indexed as a prefix donor, before
    session 1 arrives); round r >= 1 submits every session's next turn."""
    n_s, n_t = len(prompts), len(prompts[0])
    out = [[(0, 0)]]
    for r in range(1, n_t + 1):
        out.append([(s, r - (s != 0)) for s in range(n_s)
                    if r - (s != 0) < n_t])
    return out


def submit(eng, be, prompts, s, t, gen):
    sid = f"s{s}"
    req = InferenceRequest(session_id=sid, prompt_tokens=len(prompts[s][t]),
                           max_new_tokens=gen, prompt_ids=list(prompts[s][t]),
                           cached_tokens=be.session_tokens(sid))
    eng.submit(req)
    return req


def run_main_path(cfg, model, params, prompts, gen):
    eng, be = make_engine(cfg, model, params)
    reqs, steps = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0                           # counts of the main path only
    now = 0.0
    for rnd in rounds(prompts):
        for s, t in rnd:
            reqs.append(submit(eng, be, prompts, s, t, gen))
        while eng.waiting or eng.running:
            t0 = time.perf_counter()
            now += eng.step(now)
            steps.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = pa.launches
    return eng, be, reqs, steps, launches


def _ref64(q, k_pages, v_pages, tables, q_offsets, ctx_lens):
    """The plain version's math in float64 (the port's plain version
    computes in float32): the rounding reference the bf16 noise floor is
    measured against."""
    B, Sq, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    S = tables.shape[1] * page
    t = tables.long()
    k = k_pages[t].reshape(B, S, Hkv, D).double()
    v = v_pages[t].reshape(B, S, Hkv, D).double()
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D).double()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / D ** 0.5
    qpos = q_offsets.long()[:, None] + torch.arange(Sq, device=q.device)
    kpos = torch.arange(S, device=q.device)
    mask = (qpos[:, :, None] >= kpos) & (kpos < ctx_lens.long()[:, None, None])
    s = s.masked_fill(~mask[:, None, None], ref.MASK_VALUE)
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), v)
    o = o * (ctx_lens > 0).double()[:, None, None, None, None]
    return o.reshape(B, Sq, H, D).to(q.dtype)


class Float64Attention:
    """While active, the plain attention (``kernels.ref``'s public function,
    which kernels/ops.py calls for ``kernel_mode="ref"``) is _ref64; counts
    its calls so a path that stops going through it is caught."""

    def __init__(self):
        self.n = 0

    @contextlib.contextmanager
    def __call__(self):
        orig = ref.paged_chunk_attention_ref

        def plain64(*args):
            self.n += 1
            return _ref64(*args)

        ref.paged_chunk_attention_ref = plain64
        try:
            yield
        finally:
            ref.paged_chunk_attention_ref = orig


def run_lockstep(cfg, model, params, prompts, gen, dtype, capture):
    """The traffic on three engines in step, all tracing logits: the kernel
    path (K), the plain path (P) and the plain path with its attention in
    float64 (R).  After every step P's and R's emitted tokens are compared
    with K's and then replaced by them (teacher forcing), so a near-tie that
    flips one token cannot desynchronise the rest of the comparison.

    Each emitted token's logit vector is compared norm-wise, as max |x - y|
    over 2e-2 x max |y| (the bf16 tolerance, scaled by the logits): the
    logits are themselves bf16 (one ulp is 0.0625 at |logit| in [8, 16)),
    and a one-ulp difference in any attention output reaches every logit
    after 32 bf16 layers.  P vs R is the noise floor of two correct
    roundings (measured on the card at 1.03 of the tolerance on final
    chunks and 1.11 on decode tokens).  K must be within the tolerance of P
    on the final chunks, or within twice that floor where the floor is the
    larger, and no further from R than twice P's distance from R."""
    eng_k, be_k = make_engine(cfg, model, params, trace_logits=True)
    eng_p, be_p = make_engine(cfg, model, params, trace_logits=True,
                              kernel_mode="ref")
    eng_r, be_r = make_engine(cfg, model, params, trace_logits=True,
                              kernel_mode="ref")
    f64 = Float64Attention()
    launches0 = pa.launches
    tol = TOL[dtype]
    pairs = ("KP", "PR", "KR")
    res = {f"{pr}_{kind}": 0.0 for pr in pairs for kind in ("chunk", "decode")}
    res.update(flips=[], tokens=0)
    now = 0.0
    for rnd in rounds(prompts):
        reqs = dict(K={}, P={}, R={})
        for s, t in rnd:
            for name, eng, be in (("K", eng_k, be_k), ("P", eng_p, be_p),
                                  ("R", eng_r, be_r)):
                reqs[name][f"s{s}"] = submit(eng, be, prompts, s, t, gen)
        while eng_k.waiting or eng_k.running:
            n = [len(b.logit_trace) for b in (be_k, be_p, be_r)]
            with capture():
                dt = eng_k.step(now)
            eng_p.step(now)
            with f64():
                eng_r.step(now)
            now += dt
            new = dict(K=be_k.logit_trace[n[0]:], P=be_p.logit_trace[n[1]:],
                       R=be_r.logit_trace[n[2]:])
            sids = [sid for sid, _ in new["K"]]
            check(all([sid for sid, _ in new[x]] == sids for x in "PR"),
                  "lockstep engines diverged in their schedules")
            for i, sid in enumerate(sids):
                lg = {x: new[x][i][1] for x in "KPR"}
                kind = ("chunk" if len(reqs["K"][sid].output_ids) == 1
                        else "decode")
                for pr in pairs:
                    y = lg[pr[1]]
                    err = float(np.abs(lg[pr[0]] - y).max())
                    res[f"{pr}_{kind}"] = max(
                        res[f"{pr}_{kind}"],
                        err / (tol * float(np.abs(y).max())))
                tk = reqs["K"][sid].output_ids[-1]
                res["tokens"] += 1
                for x, be in (("P", be_p), ("R", be_r)):
                    rq = reqs[x][sid]
                    tx = rq.output_ids[-1]
                    if tx == tk:
                        continue
                    gap = float(lg[x][tx] - lg[x][tk])
                    res["flips"].append((x, sid, tk, tx, gap))
                    check(gap <= tol * float(np.abs(lg[x]).max()),
                          f"{sid}: token {tk} (kernel) vs {tx} ({x}) with a "
                          f"logit gap {gap:.3g} beyond tolerance")
                    be.seqs[sid].last_token = tk
                    rq.output_ids[-1] = tk
        check(not any(e.waiting or e.running for e in (eng_p, eng_r)),
              "a twin engine has work left")
    check(capture.n > 0 and capture.n == pa.launches - launches0,
          f"the capture saw {capture.n} kernel calls of the "
          f"{pa.launches - launches0} the kernel path launched")
    check(f64.n == cfg.n_layers * be_r.stats["sub_dispatches"],
          f"the float64 twin ran {f64.n} float64 attention calls, not "
          f"{cfg.n_layers} x {be_r.stats['sub_dispatches']}")
    check(res["KP_chunk"] <= max(1.0, 2 * res["PR_chunk"]),
          f"final-chunk logits: kernel vs plain at {res['KP_chunk']:.3g} x "
          f"the tolerance, noise floor {res['PR_chunk']:.3g} x")
    for kind in ("chunk", "decode"):
        check(res[f"KR_{kind}"] <= 2 * max(res[f"PR_{kind}"], 1e-3),
              f"{kind} logits: the kernel path is {res[f'KR_{kind}']:.3g} x "
              f"the tolerance from the float64 path, the plain path "
              f"{res[f'PR_{kind}']:.3g} x")
    return res


class Capture:
    """Records the first kernel call of each distinct shape on the serving
    path (layer 0 of each bucket), with copies of its inputs: while active
    it wraps the kernel's public wrapper, ``kernels.paged_attention.
    paged_chunk_attention``, which kernels/ops.py launches through, and
    counts the calls it sees.  Captures happen only in the lockstep twin,
    never in the counted main-path run."""

    def __init__(self):
        self.calls = {}
        self.n = 0

    @contextlib.contextmanager
    def __call__(self):
        orig = pa.paged_chunk_attention

        def recording(q, kp, vp, tables, qoff, ctx):
            self.n += 1
            key = (tuple(q.shape), tuple(tables.shape), q.dtype)
            if key not in self.calls:
                self.calls[key] = tuple(
                    t.clone() for t in (q, kp, vp, tables, qoff, ctx))
            return orig(q, kp, vp, tables, qoff, ctx)

        pa.paged_chunk_attention = recording
        try:
            yield
        finally:
            pa.paged_chunk_attention = orig


def phase_serve(seed):
    rng = np.random.default_rng(seed)
    cfg = configs.get_config("llama3-8b")
    model = get_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in
                 [params["emb"], params["lm_head"], params["ln_f"],
                  *params["blocks"].values()])
    log(f"[4] llama3-8b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.dtype}: {nbytes / 1e9:.2f} GB of weights in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = _turns(rng, cfg.vocab)
    gen = 16
    eng, be, reqs, steps, launches = run_main_path(cfg, model, params,
                                                   prompts, gen)
    subs = be.stats["sub_dispatches"]
    n_tok = sum(len(r.output_ids) for r in reqs)
    log(f"[4] main path: {len(reqs)} requests, {n_tok} generated tokens, "
        f"{eng.stats['prefill_tokens']} prefill tokens in "
        f"{eng.stats['chunks']} chunks, {len(steps)} steps, mean step "
        f"{1e3 * sum(steps) / len(steps):.2f} ms, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"[4] backend stats: {be.stats}; buckets: {be.compile_counts()}")
    log(f"[4] kernel launches {launches} = n_layers {cfg.n_layers} x "
        f"sub-dispatches {subs}: {launches == cfg.n_layers * subs}")
    check(launches == cfg.n_layers * subs and launches > 0,
          f"kernel launches {launches} != {cfg.n_layers} x {subs}")
    check(all(len(r.output_ids) == gen for r in reqs),
          "a request did not generate all its tokens")
    check(be.stats["prefix_hits"] >= 1 and be.stats["cow_forks"] >= 1,
          f"no prefix adoption / CoW fork on the card: {be.stats}")
    check(eng.stats["chunks"] > len(reqs), "no prompt was chunked")
    for a in be.alloc:
        a.check()
    buckets = be.compile_counts()["step"]     # the main path's buckets only

    cap = Capture()
    res = run_lockstep(cfg, model, params, prompts, gen, torch.bfloat16, cap)
    log(f"[4] captured {len(cap.calls)} distinct main-path kernel shapes "
        f"from {cap.n} calls")
    check(len(cap.calls) == buckets,
          f"captured {len(cap.calls)} distinct kernel shapes, the main path "
          f"ran {buckets} step buckets")
    log(f"[4] lockstep, {res['tokens']} tokens; max |logit diff| in units "
        f"of 2e-2 x max|logit|, final chunks / decode: kernel vs plain "
        f"{res['KP_chunk']:.3g} / {res['KP_decode']:.3g}; plain vs float64 "
        f"attention {res['PR_chunk']:.3g} / {res['PR_decode']:.3g}; kernel "
        f"vs float64 attention {res['KR_chunk']:.3g} / {res['KR_decode']:.3g}")
    log(f"[4] token flips (twin, sid, kernel, twin, twin's logit gap): "
        f"{res['flips']}")
    del be, eng
    torch.cuda.empty_cache()

    # the main path's kernel calls, one per distinct bucket shape, timed
    recs = []
    for key, (q, kp, vp, tab, qoff, ctx) in sorted(cap.calls.items(),
                                                   key=lambda kv: kv[0]):
        q_lens = (ctx - qoff).clamp(min=0).cpu().tolist()
        label = f"main path B={q.shape[0]} Sq={q.shape[1]} T={tab.shape[1]}"
        rec = compare(q, kp, vp, tab, qoff, ctx, q_lens, q.dtype, label)
        log("[4]" + fmt(rec))
        recs.append(rec)
    cap.calls.clear()
    del params, model
    torch.cuda.empty_cache()
    return launches, recs


def phase_exact_fp32(seed):
    rng = np.random.default_rng(seed + 1)
    cfg = dataclasses.replace(configs.get_config("llama3-8b"), n_layers=2,
                              dtype="float32", name="llama3-8b-2layer-fp32")
    model = get_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(seed + 1))
    gen = 16
    turns = [[int(x) for x in rng.integers(0, cfg.vocab, int(n))]
             for n in rng.integers(100, 300, 3)]
    # dense recompute: every turn re-prefills the whole history
    history, expect = [], []
    for turn in turns:
        history += turn
        logits, cache = model.prefill(params, torch.tensor([history]))
        cache = model.grow_cache(cache, gen)
        outs = []
        for _ in range(gen):
            nxt = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
            outs.append(int(nxt[0]))
            logits, cache = model.decode_step(params, cache, nxt)
        expect.append(outs)
        history += outs
    cost = CostModel(cfg)
    cost.set_param_count(model.param_count())
    mgr = NodeManager(0, cfg, cost)
    be = RealBackend(cfg, model, params, n_pages=128, page_size=16, mgr=mgr,
                     trace_logits=False, device=model.device)
    eng = NodeEngine(0, cfg, cost, mgr, max_batch=4, backend=be,
                     token_budget=128)
    got, now = [], 0.0
    before = pa.launches
    for turn in turns:
        req = InferenceRequest(session_id="chat", prompt_tokens=len(turn),
                               max_new_tokens=gen, prompt_ids=list(turn),
                               cached_tokens=be.session_tokens("chat"))
        eng.submit(req)
        while eng.waiting or eng.running:
            now += eng.step(now)
        got.append(list(req.output_ids))
    ran = pa.launches - before
    log(f"[5] fp32 2-layer full width: served {got}")
    log(f"[5] dense recompute            {expect}; kernel launches {ran}")
    check(ran == cfg.n_layers * be.stats["sub_dispatches"],
          "the fp32 serve did not go through the kernel on every layer")
    check(got == expect, "fp32 served tokens differ from dense recompute")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="1,2,3,4,5")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    t_start = time.perf_counter()
    try:
        kind, card = phase_env()
        if 2 in phases:
            phase_build()
        shape_recs = (phase_kernel_vs_plain(np.random.default_rng(args.seed))
                      if 3 in phases else [])
        launches, main_recs = 0, []
        if 4 in phases:
            launches, main_recs = phase_serve(args.seed)
        if 5 in phases:
            phase_exact_fp32(args.seed)
    except PhaseFailed as e:
        log(f"FAILED: {e}")
        return 1
    # the record holds the main path's shapes whenever the main path ran
    recs = main_recs if 4 in phases else shape_recs
    entry = dict(
        name=pa.NAME, route="cuda",
        source="src/repro_torch/csrc/paged_chunk_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:291",
        launches=launches,
        max_abs_err=max((r["max_abs_err"] for r in recs), default=None),
        ms=sum(r["ms"] for r in recs) if recs else None,
        plain_ms=sum(r["plain_ms"] for r in recs) if recs else None,
        bound_ms=sum(r["bound_ms"] for r in recs) if recs else None,
        bound_by=None, library_ms=sum(r["library_ms"] for r in recs)
        if recs else None)
    if recs:
        t_b = sum(r["bytes_ms"] for r in recs)
        t_f = sum(r["ops_ms"] for r in recs)
        entry["bound_by"] = "bytes" if t_b >= t_f else "operations"
    log(f"done in {time.perf_counter() - t_start:.1f} s; kernel times are "
        f"one call of each distinct main-path shape, summed")
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
