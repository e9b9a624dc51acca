"""The port's recurrent and hybrid serving against the JAX package.

A twin of tests/test_recurrent_parity.py for the mamba2, xlstm and hybrid
families: the same multi-turn greedy conversations go through the JAX
`StateBackend` and the port's, over the same weights (tests/_torch_twin.py,
``.reduced(dtype="float32")`` configs), and must give the same tokens and
tier counters, with the port's tokens equal to the port's dense
prefill/decode recompute — across preemption, whole-blob eviction and
promotion, disk-spool resume, crash recovery, batched decode and slot
exhaustion.  Contexts stay below the reduced sliding window (128), where
the dense reference's windowed attention equals the served full-causal
paged attention.

Beside the scenarios: one mixed decode/chunk `step_slots` against JAX's
(logits and every pool), the trash slot and trash page never leaking into
real lanes, a hybrid session exported by each package and imported by the
other, and the converter keeping the float32 Mamba leaves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twin import (GEN, check_invariants, recompute, recurrent_twins,
                         turns)
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models.registry import get_model
from repro_torch.serving.state_backend import StateBackend

FAMILIES = ("mamba2", "hybrid", "xlstm")
TOL = dict(rtol=2e-3, atol=2e-3)          # test_recurrent_parity's logits
KEYS = ("prefills", "decode_steps", "swaps_out", "swaps_in",
        "layer_evictions", "layer_promotions", "migrations_in",
        "disk_writes", "copied_bytes")


def _node(pkg, **kw):
    return pkg.node(**{**dict(n_slots=4, n_pages=32, page_size=8), **kw})


def _serve(pkg, eng, be, mgr, turn_ids, gen=GEN, preempt_turn=None,
           sid="s0", now=0.0):
    """test_recurrent_parity's `_serve`: each turn to the end, preempting
    once mid-decode in ``preempt_turn``; invariants at every drain."""
    outs, cached = [], be.session_tokens(sid)
    for i, t in enumerate(turn_ids):
        req = pkg.Request(session_id=sid, prompt_tokens=len(t),
                          max_new_tokens=gen, prompt_ids=list(t),
                          cached_tokens=cached)
        eng.submit(req)
        preempted = False
        while eng.waiting or eng.running:
            now += eng.step(now)
            check_invariants(mgr, be)
            if (i == preempt_turn and not preempted and eng.running
                    and req.generated >= gen // 2):
                eng.preempt_one(now)
                preempted = True
        outs.append(list(req.output_ids))
        cached = be.session_tokens(sid)
        be.drain_transfers()
        check_invariants(mgr, be)
    return outs


def _counters(be):
    return {k: be.stats[k] for k in KEYS}


def _both(family, scenario, seed=0):
    """Run ``scenario(pkg)`` on both packages; returns {name: result}."""
    return {pkg.name: scenario(pkg) for pkg in recurrent_twins(family, seed)}


@pytest.mark.parametrize("family", FAMILIES)
def test_multiturn_parity_with_preemption(family):
    def scenario(pkg):
        _, mgr, be, eng = _node(pkg)
        assert type(be).__name__ == "StateBackend"
        got = _serve(pkg, eng, be, mgr, turns(pkg.cfg, (11, 7, 9)),
                     preempt_turn=1)
        trace = np.stack([lg for _, lg in be.logit_trace])
        return got, _counters(be), trace

    res = _both(family, scenario)
    (jt, jc, jl), (tt, tc, tl) = res["jax"], res["torch"]
    tpkg = recurrent_twins(family)[1]
    assert tt == jt == recompute(tpkg, turns(tpkg.cfg, (11, 7, 9)))
    assert tc == jc
    assert tc["swaps_out"] >= 1 and tc["swaps_in"] >= 1
    np.testing.assert_allclose(tl, jl, **TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_evict_then_promote_preserves_state(family):
    """Whole-blob eviction (cooperative purge of the one store 'layer')
    then advisory promotion physically round-trips the state."""
    def scenario(pkg):
        _, mgr, be, eng = _node(pkg)
        t = turns(pkg.cfg, (10, 8), seed=3)
        got = _serve(pkg, eng, be, mgr, t[:1])
        mgr.on_memory_pressure(be.hbm_kv_budget() * 10, now=1.0)
        be.drain_transfers()
        assert be.stats["layer_evictions"] == 1
        assert "s0" not in be.slots.seqs
        check_invariants(mgr, be)
        mgr.promote("s0", now=2.0)
        assert be.stats["layer_promotions"] == 1 and "s0" in be.slots.seqs
        got += _serve(pkg, eng, be, mgr, t[1:], now=3.0)
        return got, _counters(be)

    res = _both(family, scenario, seed=2)
    tpkg = recurrent_twins(family, 2)[1]
    assert res["torch"] == res["jax"]
    assert res["torch"][0] == recompute(tpkg, turns(tpkg.cfg, (10, 8),
                                                    seed=3))


@pytest.mark.parametrize("family", FAMILIES)
def test_disk_spool_recovers_lost_host_tier(family, tmp_path):
    def scenario(pkg):
        spool = tmp_path / pkg.name
        _, mgr, be, eng = _node(pkg, spool_dir=str(spool))
        t = turns(pkg.cfg, (12, 6), seed=5)
        got = _serve(pkg, eng, be, mgr, t[:1])
        assert be.persist("s0")
        be.drain_transfers()
        assert (spool / "s0.npz").exists()
        be.swap_out("s0", be.session_tokens("s0"))
        be.drain_transfers()
        check_invariants(mgr, be)
        be.host.clear()                       # lose the fast tiers
        got += _serve(pkg, eng, be, mgr, t[1:])
        return got, _counters(be)

    res = _both(family, scenario, seed=4)
    tpkg = recurrent_twins(family, 4)[1]
    assert res["torch"] == res["jax"]
    assert res["torch"][0] == recompute(tpkg, turns(tpkg.cfg, (12, 6),
                                                    seed=5))


@pytest.mark.parametrize("family", FAMILIES)
def test_crash_recovers_from_spool(family, tmp_path):
    """Node crash mid-conversation: pools, allocators and host tier die;
    the persisted spool blob resumes the session token-exactly."""
    def scenario(pkg):
        _, mgr, be, eng = _node(pkg, spool_dir=str(tmp_path / pkg.name))
        t = turns(pkg.cfg, (9, 7), seed=7)
        got = _serve(pkg, eng, be, mgr, t[:1])
        assert be.persist("s0")
        be.drain_transfers()
        before = be.session_tokens("s0")
        be.crash()
        mgr.crash(now=10.0)
        assert be.spool_exists("s0")
        payload = be.recover_session("s0")
        assert payload["n_kv"] + (payload["last_token"] is not None) \
            == before
        be.import_session("s0", payload)
        mgr.mark_resident("s0", before, be.session_kv_bytes(before),
                          priority=0)
        got += _serve(pkg, eng, be, mgr, t[1:])
        return got, _counters(be)

    res = _both(family, scenario, seed=6)
    tpkg = recurrent_twins(family, 6)[1]
    assert res["torch"] == res["jax"]
    assert res["torch"][0] == recompute(tpkg, turns(tpkg.cfg, (9, 7),
                                                    seed=7))


@pytest.mark.parametrize("family", FAMILIES)
def test_batched_decode_two_sessions(family):
    """Batched slot decode over sessions of different lengths matches each
    session's own dense reference."""
    def scenario(pkg):
        _, mgr, be, eng = _node(pkg)
        prompts = {"a": turns(pkg.cfg, (9,), seed=7)[0],
                   "b": turns(pkg.cfg, (13,), seed=8)[0]}
        reqs = {s: pkg.Request(session_id=s, prompt_tokens=len(p),
                               max_new_tokens=GEN, prompt_ids=list(p))
                for s, p in prompts.items()}
        for r in reqs.values():
            eng.submit(r)
        now = 0.0
        while eng.waiting or eng.running:
            now += eng.step(now)
            check_invariants(mgr, be)
        assert len(eng.completed) == 2
        return {s: list(r.output_ids) for s, r in reqs.items()}, \
            _counters(be)

    res = _both(family, scenario, seed=1)
    assert res["torch"] == res["jax"]
    tpkg = recurrent_twins(family, 1)[1]
    for s, seed in (("a", 7), ("b", 8)):
        p = turns(tpkg.cfg, (9 if s == "a" else 13,), seed=seed)
        assert res["torch"][0][s] == recompute(tpkg, p)[0], s


@pytest.mark.parametrize("family", FAMILIES)
def test_slot_exhaustion_preempts_not_corrupts(family):
    """More concurrent sessions than slots: the engine's pressure path
    (reclaim leases -> cooperative purge -> preempt) keeps every session's
    output identical to its solo reference."""
    def scenario(pkg):
        _, mgr, be, eng = _node(pkg, n_slots=2, max_batch=2)
        prompts = {f"s{i}": turns(pkg.cfg, (7 + i,), seed=20 + i)[0]
                   for i in range(4)}
        reqs = {s: pkg.Request(session_id=s, prompt_tokens=len(p),
                               max_new_tokens=GEN, prompt_ids=list(p))
                for s, p in prompts.items()}
        for r in reqs.values():
            eng.submit(r)
        now = 0.0
        while eng.waiting or eng.running:
            now += eng.step(now)
        be.drain_transfers()
        check_invariants(mgr, be)
        return {s: list(r.output_ids) for s, r in reqs.items()}, \
            _counters(be)

    res = _both(family, scenario, seed=9)
    assert res["torch"] == res["jax"]
    tpkg = recurrent_twins(family, 9)[1]
    for i in range(4):
        p = turns(tpkg.cfg, (7 + i,), seed=20 + i)
        assert res["torch"][0][f"s{i}"] == recompute(tpkg, p)[0]


# ---------------------------------------------------------------------------
# the fused step against JAX's
# ---------------------------------------------------------------------------

def _slot_batch(cfg, model, rng, page=8, n_slots=5, n_pages=24):
    """A mixed batch of 4 lanes in an 8-lane bucket: two decode lanes, two
    chunk lanes of different lengths, four padded lanes on the trash slot;
    random pool contents; for the hybrid, per-application paged KV with
    each lane's earlier context on permuted pages.  xLSTM pools are drawn
    at scale 0.3 (conv tails and stabilizers at 1), with the sLSTM
    normalizer s_n positive, as a served state holds it."""
    B, Sq = 8, 8
    n_valid = np.array([1, 8, 5, 1, 0, 0, 0, 0], np.int32)
    slots = np.array([3, 0, 4, 1] + [n_slots] * 4, np.int32)
    ids = rng.integers(0, cfg.vocab, (B, Sq)).astype(np.int32)
    last = np.maximum(n_valid - 1, 0).astype(np.int32)
    if cfg.family == "xlstm":
        pools = {k: rng.normal(scale=1.0 if k in ("m_conv", "m_m", "s_m")
                               else 0.3, size=tuple(v.shape)
                               ).astype(np.float32)
                 for k, v in model.init_slot_pools(n_slots).items()}
        pools["s_n"] = np.abs(pools["s_n"]) + 0.5
    else:
        s = cfg.ssm
        pools = dict(
            conv=rng.normal(size=(cfg.n_layers, n_slots + 1, model.conv_dim,
                                  s.d_conv - 1)).astype(np.float32),
            ssm=rng.normal(scale=0.3, size=(cfg.n_layers, n_slots + 1,
                                            model.nh, s.d_state, s.head_dim)
                           ).astype(np.float32))
    batch = dict(ids=ids, slots=slots, n_valid=n_valid, last=last,
                 pools=pools)
    if model.has_attn:
        na = model.n_groups_outer
        prior = np.array([13, 0, 9, 20, 0, 0, 0, 0])
        T = 4
        perm = rng.permutation(n_pages)
        tables = np.zeros((na, B, T), np.int32)
        pg = np.full((na, B, Sq), n_pages, np.int32)
        off = np.zeros((na, B, Sq), np.int32)
        used = 0
        for b in range(4):
            ctx = prior[b] + n_valid[b]
            w = -(-ctx // page)
            tables[:, b, :w] = perm[used:used + w]
            tables[:, b, w:] = tables[:, b, w - 1:w]
            used += w
            pos = prior[b] + np.arange(n_valid[b])
            pg[:, b, :n_valid[b]] = tables[:, b, pos // page]
            off[:, b, :n_valid[b]] = pos % page
        kv = (na, n_pages + 1, page, cfg.n_kv_heads, cfg.d_head)
        batch.update(
            k_pool=rng.normal(size=kv).astype(np.float32),
            v_pool=rng.normal(size=kv).astype(np.float32),
            tables=tables, qoff=prior.astype(np.int32),
            ctx=np.where(np.arange(B) < 4, prior + n_valid, 0
                         ).astype(np.int32), pg=pg, off=off)
    return batch


def _jax_step(jpkg, b):
    args = [jpkg.params, jnp.asarray(b["ids"]),
            {k: jnp.asarray(v) for k, v in b["pools"].items()},
            jnp.asarray(b["slots"]), jnp.asarray(b["n_valid"]),
            jnp.asarray(b["last"])]
    if getattr(jpkg.model, "has_attn", False):   # JAX XLSTMLM has none
        args += [jnp.asarray(b[k]) for k in ("k_pool", "v_pool", "tables",
                                             "qoff", "ctx", "pg", "off")]
    out = jpkg.model.step_slots(*args, kernel_mode="ref")
    out = jax.tree.map(np.asarray, out)
    pools = dict(out[2])
    if getattr(jpkg.model, "has_attn", False):
        pools.update(k_pool=out[3], v_pool=out[4])
    return out[1], pools


def _torch_step(tpkg, b):
    t = torch.from_numpy
    pools = {k: t(v.copy()) for k, v in b["pools"].items()}
    kw = {}
    if tpkg.model.has_attn:
        kw = dict(k_pool=t(b["k_pool"].copy()), v_pool=t(b["v_pool"].copy()),
                  tables=t(b["tables"]), q_offsets=t(b["qoff"]),
                  ctx_lens=t(b["ctx"]), slot_pages=t(b["pg"]),
                  slot_offs=t(b["off"]))
    _, logits = tpkg.model.step_slots(
        tpkg.params, t(b["ids"]), pools, t(b["slots"]), t(b["n_valid"]),
        t(b["last"]), **kw)
    out = {k: v.numpy() for k, v in pools.items()}
    if tpkg.model.has_attn:
        out.update(k_pool=kw["k_pool"].numpy(), v_pool=kw["v_pool"].numpy())
    return logits.numpy(), out


@pytest.mark.parametrize("family", FAMILIES)
def test_step_slots_matches_jax_on_mixed_batch(family):
    """One fused step over decode and chunk lanes (and padded lanes):
    logits of the real lanes and every pool row outside the trash slot and
    trash page equal JAX's within 2e-4."""
    jpkg, tpkg = recurrent_twins(family)
    b = _slot_batch(tpkg.cfg, tpkg.model, np.random.default_rng(31))
    jl, jpools = _jax_step(jpkg, b)
    tl, tpools = _torch_step(tpkg, b)
    np.testing.assert_allclose(tl[:4], jl[:4], rtol=2e-4, atol=2e-4)
    for k in b["pools"]:
        np.testing.assert_allclose(tpools[k][:, :-1], jpools[k][:, :-1],
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    if tpkg.model.has_attn:
        for k in ("k_pool", "v_pool"):
            np.testing.assert_allclose(tpools[k][:, :-1], jpools[k][:, :-1],
                                       rtol=2e-4, atol=2e-4, err_msg=k)
    assert tpkg.model.slot_compile_counts()["slots"] >= 1


@pytest.mark.parametrize("family", FAMILIES)
def test_trash_slot_and_page_never_reach_real_lanes(family):
    """Padded lanes all read and write the trash slot (and the hybrid's
    trash page): duplicate writes land there in no defined order, and what
    it holds never reaches a real lane's logits or state."""
    _, tpkg = recurrent_twins(family)
    b = _slot_batch(tpkg.cfg, tpkg.model, np.random.default_rng(37))
    base_l, base_p = _torch_step(tpkg, b)
    junk = dict(b, pools={k: v.copy() for k, v in b["pools"].items()})
    for v in junk["pools"].values():
        v[:, -1] = 1e4                        # the trash slot
    if tpkg.model.has_attn:
        for k in ("k_pool", "v_pool"):
            junk[k] = b[k].copy()
            junk[k][:, -1] = 1e4              # the trash page
    got_l, got_p = _torch_step(tpkg, junk)
    np.testing.assert_array_equal(got_l[:4], base_l[:4])
    for k, v in got_p.items():
        np.testing.assert_array_equal(v[:, :-1], base_p[k][:, :-1],
                                      err_msg=k)


# ---------------------------------------------------------------------------
# migration across packages, converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
def test_hybrid_session_migrates_between_packages(direction):
    """A hybrid session served for one turn by one package, exported, and
    imported by the other serves its next turn with the tokens of dense
    recompute (state blob, conv tail and paged KV all carried across)."""
    jpkg, tpkg = recurrent_twins("hybrid", 3)
    src, dst = (jpkg, tpkg) if direction == "jax->torch" else (tpkg, jpkg)
    t = turns(tpkg.cfg, (11, 8), seed=41)
    _, mgr_a, be_a, eng_a = _node(src)
    got = _serve(src, eng_a, be_a, mgr_a, t[:1])
    tokens = be_a.session_tokens("s0")
    payload = be_a.export_session("s0")
    _, mgr_b, be_b, eng_b = _node(dst)
    be_b.import_session("s0", payload)
    mgr_b.mark_resident("s0", tokens, be_b.session_kv_bytes(tokens),
                        priority=0)
    got += _serve(dst, eng_b, be_b, mgr_b, t[1:])
    assert be_b.stats["migrations_in"] == 1 and be_b.stats["swaps_in"] == 1
    assert got == recompute(tpkg, t)


def test_bf16_spool_keeps_the_bits(tmp_path):
    """A bf16 hybrid session persisted to the spool stores bf16 as uint16
    beside its dtype and recovers bit for bit."""
    cfg = tconfigs.get_config("zamba2-2.7b").reduced(dtype="bfloat16")
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(5))
    _, tpkg = recurrent_twins("hybrid")
    pkg = dataclasses.replace(tpkg, cfg=cfg, model=model, params=params)
    _, mgr, be, eng = _node(pkg, spool_dir=str(tmp_path))
    _serve(pkg, eng, be, mgr, turns(cfg, (9,), seed=43))
    slot = be.slots.slot_of("s0")
    conv = be.pools["conv"][:, slot].clone()
    assert be.persist("s0")
    be.drain_transfers()
    with np.load(tmp_path / "s0.npz") as z:
        assert z["s_conv"].dtype == np.uint16 and str(z["dtype"]) == \
            "bfloat16"
        assert z["s_ssm"].dtype == np.float32
    payload = be.recover_session("s0")
    back = torch.from_numpy(payload["state"]["conv"].view(np.int16)
                            ).view(torch.bfloat16)
    assert torch.equal(back, conv)
    assert isinstance(be, StateBackend)


def test_converter_keeps_the_float32_mamba_leaves():
    """The JAX package keeps a_log, dt_bias and d_skip in float32 whatever
    the model dtype; the converter must too, and cast everything else."""
    from repro import configs as jconfigs
    from repro.models.registry import get_model as jax_model
    jcfg = jconfigs.get_config("zamba2-2.7b").reduced(dtype="bfloat16")
    cfg = tconfigs.get_config("zamba2-2.7b").reduced(dtype="bfloat16")
    jp = jax_model(jcfg).init(jax.random.key(0))
    tp = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    for k, v in tp["mamba"].items():
        want = torch.float32 if k in ("a_log", "dt_bias", "d_skip") \
            else torch.bfloat16
        assert v.dtype == want, k
        assert str(jp["mamba"][k].dtype) == str(want).split(".")[-1], k
    assert tp["shared"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["mamba"]["a_log"].numpy(),
                                  np.asarray(jp["mamba"]["a_log"]))
