"""The port's tier movement against the JAX package's, scenario by scenario.

Each test runs one scenario on the JAX `RealBackend` and on the port's
(`_torch_twin.twins`: the same weights, the same v5e cost figures) and
asserts the same tokens, the same counters and the allocator/store
invariants at every drain point — and that the port's tokens equal its
dense recompute.  The scenarios are tests/test_backend_parity.py's four and
the single-node cases of tests/test_transfer_engine.py: swap-out leases
until the copy lands, preemption with the swap-out in flight (drained or
not), churn under page pressure, crash poisoning of in-flight transfers,
stale-spool rejection, `LostKV`, a crash while a shared page's swap-out is
in flight, and the advisory-led residual stall.  Then export/import across
the two packages, the spool and export format of bfloat16 payloads, and
the in-place pool writes (the pools keep their storage, as the JAX package
gets from donation).

Float32 configs, page 8, CPU tensors: host copies complete when launched,
so on the CPU "in flight" means launched and not yet reaped.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twin import (GEN, check_invariants, counters, recompute,
                         serve_to_end, turns, twins)
from repro_torch.models.registry import get_model
from repro_torch.serving.backend import _host_tensor
from repro_torch.serving.transfer import IN, OUT, PERSIST


def _serve(pkg, eng, be, turn_ids, preempt_turn=None, sid="s0", gen=GEN):
    """Drive the engine turn by turn; optionally preempt mid-decode."""
    outs, now = [], 0.0
    for i, t in enumerate(turn_ids):
        req = pkg.Request(session_id=sid, prompt_tokens=len(t),
                          max_new_tokens=gen, prompt_ids=list(t),
                          cached_tokens=be.session_tokens(sid))
        eng.submit(req)
        preempted = False
        while eng.waiting or eng.running:
            now += eng.step(now)
            if (i == preempt_turn and not preempted and eng.running
                    and req.generated >= gen // 2):
                eng.preempt_one(now)
                preempted = True
        outs.append(list(req.output_ids))
    return outs


def _both(kind, fn):
    """Run ``fn(pkg)`` on the JAX package and the port; returns both."""
    jpkg, tpkg = twins(kind)
    return fn(jpkg), fn(tpkg), tpkg


# ---------------------------------------------------------------------------
# tests/test_backend_parity.py's four
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_multiturn_parity_with_preemption(kind):
    def run(pkg):
        _, mgr, be, eng = pkg.node()
        got = _serve(pkg, eng, be, turns(pkg.cfg, (11, 7, 9)),
                     preempt_turn=1)
        check_invariants(mgr, be)
        return got, counters(be), [lg for _, lg in be.logit_trace]

    (jt, jc, jl), (tt, tc, tl), tpkg = _both(kind, run)
    assert tt == jt == recompute(tpkg, turns(tpkg.cfg, (11, 7, 9)))
    assert tc == jc
    assert tc["swaps_out"] >= 1 and tc["swaps_in"] >= 1
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


def test_cooperative_evict_then_promote_preserves_kv():
    def run(pkg):
        _, mgr, be, eng = pkg.node()
        ts = turns(pkg.cfg, (10, 8), seed=3)
        got = _serve(pkg, eng, be, ts[:1])
        mgr.on_memory_pressure(be.hbm_kv_budget() * 10, now=1.0)
        assert be.stats["layer_evictions"] == pkg.cfg.n_layers
        assert all("s0" not in a.seqs for a in be.alloc)
        mgr.promote("s0", now=2.0)
        assert all("s0" in a.seqs for a in be.alloc)
        got += _serve(pkg, eng, be, ts[1:])
        check_invariants(mgr, be)
        return got, counters(be), dict(mgr.stats)

    j, t, tpkg = _both("gqa", run)
    assert t == j
    assert t[0] == recompute(tpkg, turns(tpkg.cfg, (10, 8), seed=3))
    assert t[1]["layer_promotions"] == tpkg.cfg.n_layers


def test_disk_spool_recovers_lost_host_tier(tmp_path):
    def run(pkg):
        _, mgr, be, eng = pkg.node(spool_dir=str(tmp_path / pkg.name))
        ts = turns(pkg.cfg, (12, 6), seed=5)
        got = _serve(pkg, eng, be, ts[:1])
        assert be.persist("s0")
        assert be.transfers.pending_for("s0", PERSIST)
        be.drain_transfers()
        assert (tmp_path / pkg.name / "s0.npz").exists()
        be.swap_out("s0", be.session_tokens("s0"))
        be.drain_transfers()
        be.host.clear()                       # lose the fast tiers
        got += _serve(pkg, eng, be, ts[1:])
        return got, counters(be)

    j, t, tpkg = _both("gqa", run)
    assert t == j
    assert t[0] == recompute(tpkg, turns(tpkg.cfg, (12, 6), seed=5))


def test_batched_decode_two_sessions():
    def run(pkg):
        _, mgr, be, eng = pkg.node()
        reqs = {}
        for s, seed, n in (("a", 7, 9), ("b", 8, 13)):
            p = turns(pkg.cfg, (n,), seed=seed)[0]
            reqs[s] = pkg.Request(session_id=s, prompt_tokens=n,
                                  max_new_tokens=GEN, prompt_ids=p)
        serve_to_end(eng, reqs.values(), mgr, be)
        return {s: list(r.output_ids) for s, r in reqs.items()}

    j, t, tpkg = _both("mha", run)
    assert t == j
    for s, seed, n in (("a", 7, 9), ("b", 8, 13)):
        assert t[s] == recompute(tpkg, turns(tpkg.cfg, (n,), seed=seed))[0]


# ---------------------------------------------------------------------------
# tests/test_transfer_engine.py's single-node cases
# ---------------------------------------------------------------------------

def test_swap_out_leases_pages_until_drain():
    def run(pkg):
        _, mgr, be, eng = pkg.node()
        p = turns(pkg.cfg, (12,), seed=1)[0]
        serve_to_end(eng, [pkg.Request("s0", prompt_tokens=12,
                                       max_new_tokens=GEN, prompt_ids=p)],
                     mgr, be)
        used = be.alloc[0].used_pages
        be.swap_out("s0", be.session_tokens("s0"))
        assert be.transfers.pending_for("s0", OUT)
        assert all("s0" not in a.seqs for a in be.alloc)
        assert be.alloc[0].used_pages == used and be.alloc[0].leased
        check_invariants(mgr, be)
        assert mgr.store.hbm_resident_layers("s0") == pkg.cfg.n_layers
        be.drain_transfers()
        assert be.alloc[0].used_pages == 0 and not be.alloc[0].leased
        assert isinstance(be.host[("s0", 0)], dict)
        assert mgr.store.hbm_resident_layers("s0") == 0
        check_invariants(mgr, be)
        return used, counters(be), be.host[("s0", 0)]

    (ju, jc, jp), (tu, tc, tp), _ = _both("mha", run)
    assert (tu, tc) == (ju, jc)
    # the host payload: full-head (n, Hkv, D) in the model dtype, the same
    # KV up to the two frameworks' float32 matmul rounding
    assert tp["k"].dtype == torch.float32 and tp["n_tokens"] == jp["n_tokens"]
    for side in ("k", "v"):
        assert tuple(tp[side].shape) == np.asarray(jp[side]).shape
        np.testing.assert_allclose(tp[side].numpy(), np.asarray(jp[side]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("drain_between", [False, True])
def test_preempt_with_swap_out_in_flight_token_exact(drain_between):
    def run(pkg):
        _, mgr, be, eng = pkg.node(n_pages=48)
        got, now = [], 0.0
        for i, t in enumerate(turns(pkg.cfg, (11, 9), seed=3)):
            req = pkg.Request("s0", prompt_tokens=len(t), max_new_tokens=GEN,
                              prompt_ids=list(t),
                              cached_tokens=be.session_tokens("s0"))
            state = dict(preempted=False)

            def hook(_now):
                if (i == 1 and not state["preempted"] and eng.running
                        and req.generated >= GEN // 2):
                    eng.preempt_one(_now)
                    assert be.transfers.pending_for("s0", OUT)
                    if drain_between:
                        be.drain_transfers()
                    check_invariants(mgr, be)
                    state["preempted"] = True

            now = serve_to_end(eng, [req], mgr, be, now, hook)
            got.append(list(req.output_ids))
        assert be.transfers.stats["completed"] \
            == be.transfers.stats["launched"]
        return got, counters(be)

    j, t, tpkg = _both("mha", run)
    assert t == j
    assert t[0] == recompute(tpkg, turns(tpkg.cfg, (11, 9), seed=3))
    assert t[1]["swaps_out"] >= 1 and t[1]["swaps_in"] >= 1


def test_churn_under_page_pressure_reclaims_leases():
    def run(pkg):
        _, mgr, be, eng = pkg.node(n_pages=5, engine_kw=dict(token_budget=8))
        rng = np.random.default_rng(7)
        reqs = {f"s{i}": pkg.Request(
            session_id=f"s{i}", prompt_tokens=12 + i, max_new_tokens=GEN,
            prompt_ids=list(map(int, rng.integers(0, pkg.cfg.vocab, 12 + i))))
            for i in range(2)}
        serve_to_end(eng, reqs.values(), mgr, be)
        assert eng.stats["preemptions"] >= 1
        return ({s: list(r.output_ids) for s, r in reqs.items()},
                counters(be), eng.stats["preemptions"])

    j, t, tpkg = _both("mha", run)
    assert t == j
    rng = np.random.default_rng(7)
    for i in range(2):
        p = list(map(int, rng.integers(0, tpkg.cfg.vocab, 12 + i)))
        assert t[0][f"s{i}"] == recompute(tpkg, [p])[0]


def test_crash_poisons_inflight_persist_and_swap_out(tmp_path):
    def run(pkg):
        d = tmp_path / pkg.name
        _, mgr, be, eng = pkg.node(spool_dir=str(d))
        p = turns(pkg.cfg, (10,), seed=4)[0]
        serve_to_end(eng, [pkg.Request("s0", prompt_tokens=10,
                                       max_new_tokens=GEN, prompt_ids=p)],
                     mgr, be)
        assert be.persist("s0")
        be.swap_out("s0", be.session_tokens("s0"))
        assert be.transfers.pending_for("s0", PERSIST)
        assert be.transfers.pending_for("s0", OUT)
        be.crash()
        assert not (d / "s0.npz").exists()
        assert be.host == {} and be.seqs == {}
        assert be.recover_session("s0") is None
        assert be.transfers.pending == 0
        for a in be.alloc:
            a.check()
        return be.transfers.stats["poisoned"], be._quant_active

    j, t, _ = _both("mha", run)
    assert t == j == (2, False)


def test_recovery_rejects_stale_spool_snapshot(tmp_path):
    def run(pkg):
        _, mgr, be, eng = pkg.node(spool_dir=str(tmp_path / pkg.name / "d"))
        ts = turns(pkg.cfg, (12, 6), seed=5)
        now = serve_to_end(eng, [pkg.Request(
            "s0", prompt_tokens=12, max_new_tokens=GEN,
            prompt_ids=list(ts[0]))], mgr, be)
        mgr.flush_session("s0", now)
        be.drain_transfers()                  # turn-1 npz lands
        now = serve_to_end(eng, [pkg.Request(
            "s0", prompt_tokens=6, max_new_tokens=GEN,
            prompt_ids=list(ts[1]), cached_tokens=be.session_tokens("s0"))],
            mgr, be, now)
        mgr.flush_session("s0", now)          # turn-2 write launched ...
        n_after = mgr.store.entries["s0"].n_tokens
        be.crash()                            # ... and poisoned
        mgr.crash()
        e = mgr.store.entries["s0"]
        assert e.on_disk and e.n_tokens == n_after
        _, mgr2, _, _ = pkg.node(node_id=1,
                                 spool_dir=str(tmp_path / pkg.name / "l"))
        ok = mgr2.recover_from_spool("s0", mgr, now=now + 1.0)
        assert "s0" not in mgr2.store.entries
        mgr2.store.check()
        return ok

    assert _both("mha", run)[:2] == (False, False)


def test_poisoned_payload_raises_lost_kv_not_phantom():
    def run(pkg):
        _, mgr, be, eng = pkg.node()
        p = turns(pkg.cfg, (10,), seed=8)[0]
        serve_to_end(eng, [pkg.Request("s0", prompt_tokens=10,
                                       max_new_tokens=GEN, prompt_ids=p)],
                     mgr, be)
        be.swap_out("s0", be.session_tokens("s0"))
        be.transfers.poison(release=True)
        eng.submit(pkg.Request("s0", prompt_tokens=4, max_new_tokens=2,
                               prompt_ids=[1, 2, 3, 4],
                               cached_tokens=be.session_tokens("s0")))
        with pytest.raises(pkg.LostKV):
            eng.step(0.0)
        return True

    assert _both("mha", run)[:2] == (True, True)


def test_crash_with_shared_page_swap_out_in_flight(tmp_path):
    """Donor X persisted; sharer A adopted X's 16-token prefix; A's
    swap-out is in flight over pages X still holds when the node crashes.
    Nothing phantom survives and X recovers token-exact on a fresh node."""
    def run(pkg):
        dead = tmp_path / pkg.name / "dead"
        _, mgr, be, eng = pkg.node(n_pages=48, spool_dir=str(dead))
        donor = turns(pkg.cfg, (16,), seed=12)[0]
        rx = pkg.Request("X", prompt_tokens=16, max_new_tokens=GEN,
                         prompt_ids=list(donor))
        now = serve_to_end(eng, [rx], mgr, be)
        mgr.flush_session("X", now)
        be.drain_transfers()
        assert (dead / "X.npz").exists()
        donor_tokens = be.session_tokens("X")
        suffix = [(rx.output_ids[0] + 1) % pkg.cfg.vocab, 7, 7, 7]
        ra = pkg.Request("A", prompt_tokens=20, max_new_tokens=GEN,
                         prompt_ids=list(donor) + suffix)
        now = serve_to_end(eng, [ra], mgr, be, now)
        a0 = be.alloc[0]
        shared = list(a0.seqs["X"].pages[:2])
        assert all(a0.refcount_of(p) == 2 for p in shared)
        be.swap_out("A", be.session_tokens("A"))
        assert be.transfers.pending_for("A", OUT)
        assert all(p in a0.leased for p in shared)
        check_invariants(mgr, be)
        be.crash()
        assert be.transfers.pending == 0 and be.host == {}
        assert not be.prefix.chains and not be.prefix.by_sid
        for a in be.alloc:
            assert a.used_pages == 0 and not a.leased
            a.check()
        assert not (dead / "A.npz").exists()
        assert be.recover_session("A") is None
        mgr.crash()
        assert "A" not in mgr.store.entries and mgr.store.entries["X"].on_disk
        _, mgr2, be2, eng2 = pkg.node(node_id=1,
                                      spool_dir=str(tmp_path / pkg.name / "l"))
        assert mgr2.recover_from_spool("X", mgr, now=now + 1.0)
        rx2 = pkg.Request("X", prompt_tokens=3, max_new_tokens=GEN,
                          prompt_ids=[9, 8, 7], cached_tokens=donor_tokens)
        serve_to_end(eng2, [rx2], mgr2, be2, now + 2.0)
        return (list(rx.output_ids), list(ra.output_ids),
                list(rx2.output_ids), counters(be2))

    j, t, tpkg = _both("mha", run)
    assert t == j
    donor = turns(tpkg.cfg, (16,), seed=12)[0]
    assert [t[0], t[2]] == recompute(tpkg, [donor, [9, 8, 7]])
    assert t[3]["migrations_in"] == 1


def test_advisory_prefetch_leaves_residual_stall_only():
    """The advisory-led swap-in's stall is a residual next to the cold
    swap-in's full copy (timing: the port only), with the manager's
    counters equal to the JAX package's."""
    def run(pkg):
        _, mgr, be, eng = pkg.node(n_pages=96)
        rng = np.random.default_rng(2)
        now = serve_to_end(eng, [pkg.Request(
            "vip", prompt_tokens=256, max_new_tokens=4,
            prompt_ids=list(map(int, rng.integers(0, pkg.cfg.vocab, 256))))],
            mgr, be)
        eng.submit(pkg.Request("bg", prompt_tokens=8, max_new_tokens=200,
                               prompt_ids=list(map(int, rng.integers(
                                   0, pkg.cfg.vocab, 8)))))
        for _ in range(4):
            now += eng.step(now)
        stalls = []
        for lead in (0, 0, 2):
            be.swap_out("vip", be.session_tokens("vip"))
            be.drain_transfers()
            stall0 = eng.stats["stall_s"]
            if lead:
                mgr.promote("vip", now)
                assert be.transfers.pending_for("vip", IN)
                for _ in range(lead):
                    now += eng.step(now)
            eng.submit(pkg.Request(
                "vip", prompt_tokens=4, max_new_tokens=2,
                prompt_ids=list(map(int, rng.integers(0, pkg.cfg.vocab, 4))),
                cached_tokens=be.session_tokens("vip")))
            while any(r.req.session_id == "vip" for r in eng.running) \
                    or "vip" in [r.session_id for r in eng.waiting]:
                now += eng.step(now)
            stalls.append(eng.stats["stall_s"] - stall0)
        return stalls, counters(be), (mgr.stats["swaps_in"],
                                      mgr.stats["promoted_layers"])

    (_, jc, jm), (stalls, tc, tm), tpkg = _both("mha", run)
    assert (tc, tm) == (jc, jm)
    assert tm[0] >= 1 and tm[1] >= tpkg.cfg.n_layers
    cold, warm = stalls[1], stalls[2]
    assert cold > 0
    assert warm <= max(0.5 * cold, 0.005), (warm, cold)


# ---------------------------------------------------------------------------
# migration across the packages, payload formats, in-place pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_export_import_across_packages(direction):
    """A session served for one turn on one package is exported, imported
    by the other, promoted, and serves its next turn token-exact."""
    jpkg, tpkg = twins("gqa")
    src, dst = (jpkg, tpkg) if direction == "jax_to_torch" else (tpkg, jpkg)
    ts = turns(tpkg.cfg, (13, 5), seed=21)
    _, smgr, sbe, seng = src.node()
    now = serve_to_end(seng, [src.Request("m", prompt_tokens=13,
                                          max_new_tokens=GEN,
                                          prompt_ids=list(ts[0]))],
                       smgr, sbe)
    tokens = sbe.session_tokens("m")
    payload = sbe.export_session("m")
    assert "m" not in sbe.seqs and payload["n_kv"] == tokens - 1
    _, dmgr, dbe, deng = dst.node(node_id=1)
    dbe.import_session("m", payload)
    dmgr.mark_resident("m", tokens, dbe._layer_page_bytes * 2)
    for l in range(dst.cfg.n_layers):
        dmgr.store.move_layer("m", l, "host")
    dmgr.promote("m", now)
    assert all("m" in a.seqs for a in dbe.alloc)
    r2 = dst.Request("m", prompt_tokens=5, max_new_tokens=GEN,
                     prompt_ids=list(ts[1]), cached_tokens=tokens)
    serve_to_end(deng, [r2], dmgr, dbe, now + 1.0)
    assert dbe.stats["migrations_in"] == 1
    assert dbe.stats["layer_promotions"] == dst.cfg.n_layers
    assert list(r2.output_ids) == recompute(tpkg, ts)[1]


def test_bf16_payloads_are_uint16_bits_beside_their_dtype(tmp_path):
    """bfloat16 host payloads leave the port with a ``dtype`` entry (numpy
    has no bfloat16): in the spool as their 16-bit pattern, on export
    widened to float32 (which the JAX package casts back exactly); they
    come back bit-exact (into another node too), and a JAX-made bfloat16
    array is read by its bits."""
    _, tpkg = twins("gqa")
    cfg = dataclasses.replace(tpkg.cfg, dtype="bfloat16")
    model = get_model(cfg, device="cpu")
    params = {k: ({n: t.to(torch.bfloat16) for n, t in v.items()}
                  if isinstance(v, dict) else v.to(torch.bfloat16))
              for k, v in tpkg.params.items()}
    pkg = dataclasses.replace(tpkg, cfg=cfg, model=model, params=params)
    _, mgr, be, eng = pkg.node(spool_dir=str(tmp_path))
    serve_to_end(eng, [pkg.Request("b", prompt_tokens=11, max_new_tokens=4,
                                   prompt_ids=turns(cfg, (11,))[0])],
                 mgr, be)
    want = be.k_pool[0][torch.as_tensor(be.alloc[0].seqs["b"].pages)]
    want = want.reshape(-1, cfg.n_kv_heads, cfg.d_head)[:be.seqs["b"].n_kv]
    assert be.persist("b")
    be.drain_transfers()
    with np.load(tmp_path / "b.npz") as z:
        assert z["k0"].dtype == np.uint16 and str(z["dtype"]) == "bfloat16"
        spooled = _host_tensor(z["k0"], torch.bfloat16)
    assert torch.equal(spooled, want)
    payload = be.export_session("b")
    lay = payload["layers"][0]
    assert lay["k"].dtype == np.float32 and lay["dtype"] == "bfloat16"
    assert torch.equal(_host_tensor(lay["k"], torch.bfloat16), want)
    _, _, be2, _ = pkg.node(node_id=1)
    be2.import_session("b", payload)
    assert torch.equal(be2.host[("b", 0)]["k"], want)
    jax_made = np.asarray(jnp.asarray(want.float().numpy(), jnp.bfloat16))
    assert torch.equal(_host_tensor(jax_made, torch.bfloat16), want)


def test_bf16_export_imports_into_jax_bit_for_bit():
    """A bf16 session exported by the port's RealBackend and imported and
    promoted by the JAX package's holds the same KV bits in every layer."""
    jpkg, tpkg = twins("gqa", 0, "bfloat16")
    _, mgr, be, eng = tpkg.node()
    now = serve_to_end(eng, [tpkg.Request("b", prompt_tokens=11,
                                          max_new_tokens=4,
                                          prompt_ids=turns(tpkg.cfg,
                                                           (11,))[0])],
                       mgr, be)
    n_kv, tokens = be.seqs["b"].n_kv, be.session_tokens("b")

    def bits(pool, alloc):
        pages = np.asarray(alloc.seqs["b"].pages)
        a = pool.view(torch.int16).numpy() if isinstance(
            pool, torch.Tensor) else np.asarray(pool).view(np.int16)
        return a[pages].reshape(-1, *a.shape[2:])[:n_kv]

    want = [(bits(be.k_pool[l], be.alloc[l]), bits(be.v_pool[l], be.alloc[l]))
            for l in range(tpkg.cfg.n_layers)]
    payload = be.export_session("b")
    _, jmgr, jbe, _ = jpkg.node(node_id=1)
    jbe.import_session("b", payload)
    jmgr.mark_resident("b", tokens, jbe._layer_page_bytes * 2)
    for l in range(jpkg.cfg.n_layers):
        jmgr.store.move_layer("b", l, "host")
    jmgr.promote("b", now)
    jbe.drain_transfers()
    for l, (k, v) in enumerate(want):
        np.testing.assert_array_equal(bits(jbe.k_pool[l], jbe.alloc[l]), k)
        np.testing.assert_array_equal(bits(jbe.v_pool[l], jbe.alloc[l]), v)


def test_pool_writes_keep_the_pools_storage():
    """The torch twin of the donation census: the swap-in scatter of an
    advisory prefetch, the compress and the in-place dequant write the
    pools in place — no second pool is made — and the round trip keeps the
    KV exact (the next turn equals dense recompute)."""
    _, tpkg = twins("mha")
    _, mgr, be, eng = tpkg.node(n_pages=37)
    p = turns(tpkg.cfg, (20,), seed=6)[0]
    serve_to_end(eng, [tpkg.Request("s0", prompt_tokens=20,
                                    max_new_tokens=GEN, prompt_ids=p)],
                 mgr, be)
    ptrs = (be.k_pool.data_ptr(), be.v_pool.data_ptr())
    be.swap_out("s0", be.session_tokens("s0"))
    be.drain_transfers()
    mgr.promote("s0", now=1.0)                     # prefetch scatter
    be.drain_transfers()
    assert be.compile_counts()["scatter"] >= 1
    assert (be.k_pool.data_ptr(), be.v_pool.data_ptr()) == ptrs
    r2 = tpkg.Request("s0", prompt_tokens=3, max_new_tokens=GEN,
                      prompt_ids=[5, 6, 7],
                      cached_tokens=be.session_tokens("s0"))
    serve_to_end(eng, [r2], mgr, be, 2.0)
    assert list(r2.output_ids) == recompute(tpkg, [p, [5, 6, 7]])[1]
    assert be.quantize_session("s0") > 0           # compress
    qptrs = (be.kq_pool.data_ptr(), be.vq_pool.data_ptr(),
             be.k_scale.data_ptr(), be.v_scale.data_ptr())
    be._dequantize_session("s0")                   # in-place dequant fork
    assert be.quantize_session("s0") > 0
    assert (be.kq_pool.data_ptr(), be.vq_pool.data_ptr(),
            be.k_scale.data_ptr(), be.v_scale.data_ptr()) == qptrs
    assert (be.k_pool.data_ptr(), be.v_pool.data_ptr()) == ptrs
    assert be.compile_counts()["compress"] >= 1
