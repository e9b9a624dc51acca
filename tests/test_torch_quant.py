"""The port's int8 KV tier against the JAX package's.

Kernel level, on the same numpy-seeded inputs:

* `quantize_int8` gives JAX's int8 codes and scales exactly;
* the plain quant attention (the quant tuple of `kernels.ref`) matches
  JAX's oracle and its Pallas quant kernel in interpret mode within 2e-4
  (float32) and 2e-2 (bfloat16), MHA and GQA, and with every flag clear it
  equals the fp plain version exactly;
* `compress_paged`, `fork_paged_quant` and `scatter_paged` write the same
  pools as JAX's.

Serving, as twins (`_torch_twin`): tests/test_quantized_kv.py's serving and
policy cases — quantize a finished session and decode through its int8
pages, equal to a twin whose pages were materialized to fp by a host round
trip; swap-out re-inflates; a CoW fork of a quantized donor page; the
in-place dequant; quantize-vs-swap under pressure with and without an
advisory; protected and pinned sessions are skipped — with the JAX
package's tokens, counters and ledger prices.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_twin import (GEN, PAGE, check_invariants, counters, recompute,
                         serve_to_end, twins)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.quant import dequantize_int8, quantize_int8
from repro_torch.serving.transfer import OUT

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
PROMPT = list(range(16)) + [100, 101, 102, 103, 104]   # 21 tokens
TURN2 = [31, 32, 33, 34]


# ---------------------------------------------------------------------------
# quantize_int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, 0, (1, 2, 3)])
def test_quantize_int8_codes_and_scales_equal_jax(axis):
    import jax.numpy as jnp
    from repro.kernels.quant import quantize_int8 as jq
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(5, PAGE, 2, 16)) * 3).astype(np.float32)
    x[0, 0, 0, :4] = [0.0, -0.0, 1e-30, -1e-30]         # tiny and zero
    x[1] = 0.0                                          # an all-zero page
    x[2, 0, 0, 0] = np.float32(127.0 * 0.5)             # .5 boundaries
    q, s = quantize_int8(torch.from_numpy(x), axis=axis)
    jqv, js = jq(jnp.asarray(x), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(4, PAGE, 2, 16)).astype(np.float32))
    qv, sc = quantize_int8(x, axis=(1, 2, 3))
    back = dequantize_int8(qv, sc[:, None, None, None])
    amax = x.abs().amax(dim=(1, 2, 3), keepdim=True)
    assert bool((back - x).abs().le(amax / 127.0).all())


# ---------------------------------------------------------------------------
# the plain quant attention
# ---------------------------------------------------------------------------

def _case(kind, seed=0, B=3, Sq=8, H=4, D=16, maxp=3):
    """Lanes over mixed-precision pools: lane 0 resumes mid-page, lane 1
    at a page boundary, the last lane is padded (ctx 0); about half the
    pages are flagged.  numpy arrays; the scales are JAX's."""
    import jax.numpy as jnp
    from repro.kernels.quant import quantize_int8 as jq
    Hkv = dict(mha=4, gqa=2)[kind]
    rng = np.random.default_rng(seed)
    P = B * maxp + 2
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, PAGE, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, PAGE, Hkv, D)).astype(np.float32)
    perm = rng.permutation(P - 1)
    tables = np.zeros((B, maxp), np.int32)
    qoff = np.asarray([3, 8, 0][:B], np.int32)
    ctx = qoff + Sq
    ctx[-1] = 0
    for b in range(B - 1):
        w = -(-int(ctx[b]) // PAGE)
        tables[b, :w] = perm[b * maxp:b * maxp + w]
        tables[b, w:] = tables[b, w - 1]
    kq, ks = (np.asarray(a) for a in jq(jnp.asarray(kp), axis=(1, 2, 3)))
    vq, vs = (np.asarray(a) for a in jq(jnp.asarray(vp), axis=(1, 2, 3)))
    flags = (rng.random(P) < 0.5).astype(np.int32)
    return (q, kp, vp, tables, qoff, ctx), (kq, vq, ks, vs, flags)


def _t(arrs, dtype):
    q, kp, vp, tables, qoff, ctx = arrs
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
            torch.from_numpy(vp).to(dtype), torch.from_numpy(tables),
            torch.from_numpy(qoff), torch.from_numpy(ctx))


def _tq(quant):
    return tuple(torch.from_numpy(np.array(a)) for a in quant)


def _j(arrs, dtype):
    import jax.numpy as jnp
    q, kp, vp, tables, qoff, ctx = arrs
    dt = getattr(jnp, dtype)
    return (jnp.asarray(q, dt), jnp.asarray(kp, dt), jnp.asarray(vp, dt),
            jnp.asarray(tables), jnp.asarray(qoff), jnp.asarray(ctx))


def _jq(quant):
    import jax.numpy as jnp
    return tuple(jnp.asarray(a) for a in quant)


def _real_rows(got, want, qoff, ctx, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    for b in range(got.shape[0]):
        if ctx[b] == 0:
            assert np.all(got[b] == 0), f"ctx=0 lane {b} not zero"
            continue
        n = int(ctx[b] - qoff[b])
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=tol,
                                   atol=tol)


@functools.lru_cache(maxsize=None)
def _jax_fns():
    import jax
    from repro.kernels import ref as jref
    from repro.kernels.paged_attention import paged_chunk_attention_quant
    return (jax.jit(jref.paged_chunk_attention_ref),
            functools.partial(paged_chunk_attention_quant, bq=4,
                              interpret=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_plain_quant_matches_jax_oracle_and_pallas(kind, dtype):
    arrs, quant = _case(kind, seed=dict(mha=1, gqa=2)[kind])
    jref_fn, pallas = _jax_fns()
    want_ref = jref_fn(*_j(arrs, dtype), quant=_jq(quant))
    q, kp, vp, tab, qo, cx = _j(arrs, dtype)
    want_pallas = pallas(q, kp, vp, *_jq(quant), tab, qo, cx)
    got = ops.paged_chunk_attention(*_t(arrs, getattr(torch, dtype)),
                                    quant=_tq(quant))
    assert got.dtype == getattr(torch, dtype)
    for want in (want_ref, want_pallas):
        _real_rows(got.float(), want, arrs[4], arrs[5], TOL[dtype])
    # the flags were applied: int8 reads moved the output off the fp one
    fp = ops.paged_chunk_attention(*_t(arrs, torch.float32))
    assert float((got.float() - fp).abs().max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_quant_with_flags_clear_equals_fp_exactly(dtype):
    arrs, (kq, vq, ks, vs, flags) = _case("gqa", seed=5)
    args = _t(arrs, getattr(torch, dtype))
    off = _tq((kq, vq, ks, vs, np.zeros_like(flags)))
    got = ops.paged_chunk_attention(*args, quant=off)
    assert torch.equal(got, ops.paged_chunk_attention(*args))
    assert torch.equal(got, tref.paged_chunk_attention_ref(*args, quant=off))


# ---------------------------------------------------------------------------
# compress_paged, fork_paged_quant, scatter_paged
# ---------------------------------------------------------------------------

def _pools(seed, L=2, P=6, Hkv=2, D=16):
    rng = np.random.default_rng(seed)
    shape = (L, P + 1, PAGE, Hkv, D)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def test_compress_fork_scatter_equal_jax():
    import jax.numpy as jnp
    jpkg, tpkg = twins("gqa")
    jm, tm = jpkg.model, tpkg.model
    k, v = _pools(11)
    L, P1 = k.shape[:2]
    qshape = k.shape
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    jkq, jvq = jnp.zeros(qshape, jnp.int8), jnp.zeros(qshape, jnp.int8)
    jks, jvs = jnp.zeros((L, P1), jnp.float32), jnp.zeros((L, P1),
                                                          jnp.float32)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tkq = torch.zeros(qshape, dtype=torch.int8)
    tvq = torch.zeros(qshape, dtype=torch.int8)
    tks = torch.zeros((L, P1), dtype=torch.float32)
    tvs = torch.zeros((L, P1), dtype=torch.float32)
    # compress 5 (layer, page) rows + 3 pad rows (layer 0, trash page)
    li = np.asarray([0, 0, 1, 1, 1, 0, 0, 0], np.int32)
    pg = np.asarray([1, 4, 0, 2, 5, P1 - 1, P1 - 1, P1 - 1], np.int32)
    jkq, jvq, jks, jvs = jm.compress_paged(jk, jv, jkq, jvq, jks, jvs,
                                           jnp.asarray(li), jnp.asarray(pg))
    tm.compress_paged(tk, tv, tkq, tvq, tks, tvs, torch.from_numpy(li),
                      torch.from_numpy(pg))
    for a, b in ((tkq, jkq), (tvq, jvq), (tks, jks), (tvs, jvs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # forks: a CoW copy of a quantized page, an fp copy, an in-place
    # dequant, one pad row
    li = np.asarray([0, 1, 1, 0], np.int32)
    src = np.asarray([1, 3, 5, P1 - 1], np.int32)
    dst = np.asarray([2, 4, 5, P1 - 1], np.int32)
    srcq = np.asarray([1, 0, 1, 0], np.int32)
    jk, jv = jm.fork_paged_quant(jk, jv, jkq, jvq, jks, jvs,
                                 *(jnp.asarray(a) for a in (li, src, dst,
                                                            srcq)))
    tm.fork_paged_quant(tk, tv, tkq, tvq, tks, tvs,
                        *(torch.from_numpy(a) for a in (li, src, dst, srcq)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # scatter 2 layers x 11 tokens, bucket-padded to 4 rows x 16 slots
    rng = np.random.default_rng(12)
    G, Gb, n, nb = 2, 4, 11, 16
    li = np.zeros((Gb, 1), np.int32)
    li[:G, 0] = [1, 0]
    pgs = np.full((Gb, nb), P1 - 1, np.int32)
    offs = np.zeros((Gb, nb), np.int32)
    pos = np.arange(n)
    pgs[:G, :n] = np.asarray([[3, 0], [5, 2]], np.int32)[:, pos // PAGE]
    offs[:G, :n] = pos % PAGE
    ks = np.zeros((Gb, nb) + k.shape[3:], np.float32)
    vs = np.zeros_like(ks)
    ks[:G, :n] = rng.normal(size=(G, n) + k.shape[3:])
    vs[:G, :n] = rng.normal(size=(G, n) + k.shape[3:])
    jk, jv = jm.scatter_paged(jk, jv, *(jnp.asarray(a) for a in (li, pgs,
                                                                 offs, ks,
                                                                 vs)))
    tm.scatter_paged(tk, tv, *(torch.from_numpy(a) for a in (li, pgs, offs,
                                                             ks, vs)))
    real = np.ones(P1, bool)
    real[-1] = False                      # the trash page: any pad wins
    np.testing.assert_array_equal(tk.numpy()[:, real], np.asarray(jk)[:, real])
    np.testing.assert_array_equal(tv.numpy()[:, real], np.asarray(jv)[:, real])
    assert tm.paged_compile_counts()["compress"] >= 1
    assert tm.paged_compile_counts()["scatter"] >= 1


# ---------------------------------------------------------------------------
# serving through quantized pages (twins)
# ---------------------------------------------------------------------------

def _first_turn(pkg, **backend_kw):
    """One finished session A on a fresh node."""
    _, mgr, be, eng = pkg.node(**backend_kw)
    r1 = pkg.Request(session_id="A", prompt_tokens=len(PROMPT),
                     max_new_tokens=GEN, prompt_ids=list(PROMPT))
    now = serve_to_end(eng, [r1], mgr, be)
    return mgr, be, eng, now, r1


def _materialize_fp(be, sid):
    """Round-trip ``sid`` through the host: the gather dequantizes on the
    way out and the scatter writes those fp values back, so its pages then
    hold EXACTLY what the int8 read computes."""
    be.swap_out(sid, be.session_tokens(sid))
    be.drain_transfers(OUT)
    be._ensure_resident(sid)
    be.drain_transfers()
    assert all(not a.quantized_pages_of(sid) for a in be.alloc)


def _turn2(pkg, eng, mgr, be, now, cached=None):
    r = pkg.Request(session_id="A", prompt_tokens=len(TURN2),
                    max_new_tokens=GEN, prompt_ids=list(TURN2),
                    cached_tokens=(be.session_tokens("A") if cached is None
                                   else cached))
    serve_to_end(eng, [r], mgr, be, now)
    return list(r.output_ids)


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_quantize_session_ledger_and_decode_parity(kind):
    def run(pkg):
        mgr, be, eng, now, r1 = _first_turn(pkg)
        full = be.seqs["A"].n_kv // PAGE
        assert full == 3
        in_use = be.kv_in_use(())
        freed = be.quantize_session("A")
        assert freed == pkg.cfg.n_layers * full * (
            be._layer_page_bytes - be._layer_page_bytes_q)
        for a in be.alloc:
            assert sorted(a.quantized) == sorted(a.seqs["A"].pages[:full])
        assert be.kv_in_use(()) == in_use - freed
        e = mgr.store.entries["A"]
        ledger = (e.quant_tokens, e.bytes_per_layer)
        assert be.quantize_session("A") == 0
        check_invariants(mgr, be)
        got = _turn2(pkg, eng, mgr, be, now)
        assert all(len(a.quantized_pages_of("A")) == full for a in be.alloc)
        # the twin: same compression, pages materialized to fp first
        mgr2, be2, eng2, now2, _ = _first_turn(pkg)
        assert be2.quantize_session("A") == freed
        _materialize_fp(be2, "A")
        got_fp = _turn2(pkg, eng2, mgr2, be2, now2)
        return list(r1.output_ids), got, got_fp, freed, ledger, counters(be)

    jpkg, tpkg = twins(kind)
    j, t = run(jpkg), run(tpkg)
    assert t == j
    assert t[1] == t[2]            # int8 read == materialized read, exactly
    assert [t[0], t[1]] == recompute(tpkg, [PROMPT, TURN2])
    assert t[5]["quant_dispatches"] == 1


def test_swap_out_reinflates_and_resume_is_exact():
    def run(pkg):
        mgr, be, eng, now, _ = _first_turn(pkg)
        freed = be.quantize_session("A")
        fp_pages = len(be.alloc[0].seqs["A"].pages)
        be.swap_out("A", be.session_tokens("A"))
        e = mgr.store.entries["A"]
        assert e.quant_tokens == 0
        assert e.bytes_per_layer == fp_pages * be._layer_page_bytes
        be.drain_transfers(OUT)
        assert all(not a.quantized for a in be.alloc)
        check_invariants(mgr, be)
        got = _turn2(pkg, eng, mgr, be, now, cached=GEN + len(PROMPT))
        mgr2, be2, eng2, now2, _ = _first_turn(pkg)
        assert be2.quantize_session("A") == freed
        got_q = _turn2(pkg, eng2, mgr2, be2, now2, cached=GEN + len(PROMPT))
        return got, got_q, counters(be)

    j, t = (run(p) for p in twins("gqa"))
    assert t == j
    assert t[0] == t[1]


def test_cow_fork_of_quantized_donor_rematerializes_fp():
    def adopt(pkg, materialize):
        mgr, be, eng, now, r1 = _first_turn(pkg)
        assert be.quantize_session("A") > 0
        if materialize:
            _materialize_fp(be, "A")
        hist = PROMPT + list(r1.output_ids[:GEN - 1])
        pd = hist[:18] + [210, 211, 212, 213]   # diverges INSIDE page 2
        rd = pkg.Request(session_id="D", prompt_tokens=len(pd),
                         max_new_tokens=GEN, prompt_ids=list(pd))
        serve_to_end(eng, [rd], mgr, be, now)
        a0 = be.alloc[0]
        donor = a0.seqs["A"].pages
        layout = (sorted(a0.quantized_pages_of("A")) == sorted(donor[:3]),
                  a0.seqs["D"].pages[:2] == donor[:2],
                  not a0.is_quantized(a0.seqs["D"].pages[2]))
        return list(rd.output_ids), counters(be), layout

    jpkg, tpkg = twins("mha")
    j = adopt(jpkg, False)
    t = adopt(tpkg, False)
    assert t == j
    assert t[1]["cow_forks"] == tpkg.cfg.n_layers
    assert t[2] == (True, True, True)
    assert adopt(tpkg, True)[0] == t[0]


def test_dequant_in_place_when_sole_holder_writes():
    def run(pkg):
        mgr, be, eng, now, r1 = _first_turn(pkg)
        hist = PROMPT + list(r1.output_ids[:GEN - 1])
        assert be.quantize_session("A") > 0
        pd = hist[:24] + [220, 221]             # boundary adoption: 3 pages
        rd = pkg.Request(session_id="D", prompt_tokens=len(pd),
                         max_new_tokens=GEN, prompt_ids=list(pd))
        serve_to_end(eng, [rd], mgr, be, now)
        a0 = be.alloc[0]
        shared = a0.seqs["D"].pages[:3]
        mgr.drop_session("A")                   # D inherits sole ownership
        assert sorted(a0.quantized_pages_of("D")) == sorted(shared)
        be._dequantize_session("D")
        assert not a0.quantized_pages_of("D")
        r2 = pkg.Request(session_id="D", prompt_tokens=2, max_new_tokens=GEN,
                         prompt_ids=[230, 231],
                         cached_tokens=be.session_tokens("D"))
        serve_to_end(eng, [r2], mgr, be, now)
        return list(rd.output_ids), list(r2.output_ids), counters(be)

    j, t = (run(p) for p in twins("gqa"))
    assert t == j
    assert t[2]["dequant_forks"] >= twins("gqa")[1].cfg.n_layers * 3


# ---------------------------------------------------------------------------
# policy: quantize-vs-swap under admission pressure (twins)
# ---------------------------------------------------------------------------

def _pressure(pkg, advisory):
    """hbm_pages=6 < n_pages=32: A (4 pages) + B (4 pages) overflow the fp
    budget but fit once A's 3 full pages go int8."""
    mgr, be, eng, now, _ = _first_turn(pkg, n_pages=32, hbm_pages=6)
    if advisory:
        mgr.on_advisory(pkg.Advisory(session_id="A", expected_arrival=0.01),
                        kv_node=0, now=now)
    rb = pkg.Request(session_id="B", prompt_tokens=len(PROMPT),
                     max_new_tokens=GEN,
                     prompt_ids=[200 + i for i in range(len(PROMPT))])
    now = serve_to_end(eng, [rb], mgr, be, now)
    stats = {k: mgr.stats[k] for k in ("quantized_sessions", "evictions",
                                       "quantize_freed_bytes",
                                       "evicted_bytes")}
    out = [list(rb.output_ids)]
    if advisory:
        assert all(len(a.quantized_pages_of("A")) == 3 for a in be.alloc)
        swaps = be.stats["swaps_in"]
        ra = pkg.Request(session_id="A", prompt_tokens=len(TURN2),
                         max_new_tokens=GEN, prompt_ids=list(TURN2),
                         cached_tokens=be.session_tokens("A"))
        serve_to_end(eng, [ra], mgr, be, now)
        assert be.stats["swaps_in"] == swaps    # the reuse cost no swap-in
        out.append(list(ra.output_ids))
    check_invariants(mgr, be)
    return out, stats, counters(be), mgr.store.entries["A"].quant_tokens


@pytest.mark.parametrize("advisory", [True, False])
def test_pressure_quantizes_with_advisory_and_swaps_without(advisory):
    j, t = (_pressure(p, advisory) for p in twins("gqa"))
    assert t == j
    out, stats, cnt, qtok = t
    if advisory:
        assert stats["quantized_sessions"] == 1 and stats["evictions"] == 0
        assert cnt["quantized_pages"] == 3 * twins("gqa")[1].cfg.n_layers
        assert qtok == 3 * PAGE
    else:
        assert stats["quantized_sessions"] == 0 and stats["evictions"] > 0
        assert cnt["quantized_pages"] == 0


def test_quantize_skips_protected_and_pinned_sessions():
    def run(pkg):
        mgr, be, eng, now, _ = _first_turn(pkg)
        mgr.note_reuse("A", now)
        e = mgr.store.entries["A"]
        mgr.on_memory_pressure(1.0, now, protect={"A"})
        assert mgr.stats["quantized_sessions"] == 0
        e.pinned = True
        mgr.on_memory_pressure(1.0, now)
        assert mgr.stats["quantized_sessions"] == 0
        e.pinned = False
        mgr.on_memory_pressure(1.0, now)
        assert sorted(be.alloc[0].quantized) == \
            sorted(be.alloc[0].seqs["A"].pages[:3])
        check_invariants(mgr, be)
        return mgr.stats["quantized_sessions"], counters(be)

    j, t = (run(p) for p in twins("gqa"))
    assert t == j and t[0] == 1
