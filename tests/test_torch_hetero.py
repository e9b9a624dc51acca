"""Heterogeneous-skew batches on the port's dense serving path.

A twin of the backend cases of tests/test_hetero_skew.py: one resumed
long-context lane riding many short decode lanes through the port's
`RealBackend`, whose context-aware lane packing (`_pack_lanes`) splits a
skewed step into at most two sub-dispatches on the power-of-two bucket
lattice.  Every session's tokens must equal its own dense prefill/decode
recompute — MHA and GQA, across the lane-count bucket boundary, with a
chunked prefill lane mixed in, and with the long lane served from int8
pages — and the split must fire.  The skewed scenario also runs on the JAX
`RealBackend` over the same weights (tests/_torch_twin.py), which must
emit the same tokens and make the same packing decisions.
"""
import numpy as np
import pytest

from _torch_twin import recompute, twins
from repro_torch.serving.backend import _bucket
from repro_torch.serving.kv_cache import PagedAllocator

GEN = 4
LONG = 150          # long lane's prompt: ~19 pages, Tb bucket 32
SHORTS = [6, 7, 8, 9, 10, 11, 12, 9, 8, 7, 6, 10, 11, 12, 9]  # 1-2 pages


def _engine(pkg, n_pages=96, max_batch=16, token_budget=512):
    _, mgr, be, eng = pkg.node(n_pages=n_pages, page_size=8,
                               max_batch=max_batch,
                               engine_kw=dict(token_budget=token_budget))
    return be, eng


def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return {f"s{i}": list(map(int, rng.integers(0, cfg.vocab, n)))
            for i, n in enumerate(lens)}


def _serve_all(pkg, eng, prompts, gen=GEN):
    """Submit every session at t=0 and run the node to completion."""
    reqs = {sid: pkg.Request(session_id=sid, prompt_tokens=len(ids),
                             max_new_tokens=gen, prompt_ids=list(ids))
            for sid, ids in prompts.items()}
    for r in reqs.values():
        eng.submit(r)
    now = 0.0
    while eng.waiting or eng.running:
        now += max(eng.step(now), 1e-9)
    return {sid: list(r.output_ids) for sid, r in reqs.items()}


def _dense(tpkg, ids, gen=GEN):
    """One session's greedy continuation by dense recompute, alone: lanes
    never interact numerically, so this is ground truth for any batch."""
    return recompute(tpkg, [ids], gen)[0]


# ---------------------------------------------------------------------------
# packing policy (pure unit)
# ---------------------------------------------------------------------------

def test_pack_lanes_policy():
    be, _ = _engine(twins("mha")[1])
    # skewed: 15 short lanes + 1 long -> exactly two groups, shorts together
    groups = be._pack_lanes([2] * 15 + [30])
    assert len(groups) == 2
    assert sorted(groups[0]) == list(range(15)) and list(groups[1]) == [15]
    assert sorted(np.concatenate(groups).tolist()) == list(range(16))
    # homogeneous batches never split (short or long)
    assert len(be._pack_lanes([2] * 16)) == 1
    assert len(be._pack_lanes([30] * 16)) == 1
    # the split threshold is >= split_skew (4x) on bucketed widths
    assert len(be._pack_lanes([2] * 15 + [4])) == 1
    assert len(be._pack_lanes([2] * 15 + [8])) == 2
    # growth within a bucket can never flip the split between steps
    assert len(be._pack_lanes([2] * 15 + [17])) == \
        len(be._pack_lanes([2] * 15 + [31]))
    # single lane / disabled skew -> one group
    assert len(be._pack_lanes([30])) == 1
    be.split_skew = 1.0
    assert len(be._pack_lanes([2] * 15 + [30])) == 1


def test_block_table_pads_with_last_valid_page():
    a = PagedAllocator(n_pages=16, page_size=4)
    a.allocate("s", 10)                       # 3 pages
    tbl = a.block_table("s", 8)
    assert (tbl[:3] == np.asarray(a.seqs["s"].pages)).all()
    assert (tbl[3:] == tbl[2]).all(), "padding must repeat the last page"
    a.allocate("empty", 0)
    assert (a.block_table("empty", 4) == 0).all()
    stacked = a.batch_block_tables(["s", "empty"], 8)
    assert (stacked[0] == tbl).all() and (stacked[1] == 0).all()


# ---------------------------------------------------------------------------
# token-exact parity, skewed batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_hetero_skew_token_exact(kind):
    """1 long lane + 15 short lanes served concurrently: every session's
    tokens equal its dense recompute and the JAX backend's, the skew split
    fires in both packages alike, and the page walk stays per-lane
    proportional."""
    jpkg, tpkg = twins(kind)
    prompts = _prompts(tpkg.cfg, [LONG] + SHORTS)
    out = {}
    for pkg in (jpkg, tpkg):
        be, eng = _engine(pkg)
        got = _serve_all(pkg, eng, prompts)
        out[pkg.name] = (got, {k: be.stats[k] for k in (
            "split_steps", "sub_dispatches", "decode_steps", "grid_pages")})
    got, stats = out["torch"]
    assert out["jax"] == out["torch"]
    for sid, ids in prompts.items():
        assert got[sid] == _dense(tpkg, ids), f"{sid} diverged ({kind})"
    assert stats["split_steps"] > 0, "skew split never fired"
    assert stats["sub_dispatches"] > stats["decode_steps"]
    assert be.stats["kv_pages"] <= be.stats["grid_pages"]
    n_dispatch_steps = stats["sub_dispatches"] - stats["split_steps"]
    fused_walk = n_dispatch_steps * _bucket(16) * _bucket(LONG // 8 + 2)
    assert stats["grid_pages"] < 0.3 * fused_walk


@pytest.mark.parametrize("n_short", [7, 15])
def test_hetero_across_lane_bucket_boundary(n_short):
    """Same skew on both sides of the lane-count bucket boundary (8 lanes
    -> Bb 8, 16 lanes -> Bb 16): packing and parity hold."""
    tpkg = twins("mha")[1]
    be, eng = _engine(tpkg)
    prompts = _prompts(tpkg.cfg, [LONG] + SHORTS[:n_short], seed=5)
    got = _serve_all(tpkg, eng, prompts)
    for sid, ids in prompts.items():
        assert got[sid] == _dense(tpkg, ids)
    assert be.stats["split_steps"] > 0


def test_hetero_chunked_prefill_lane_mixed_in():
    """A small token budget makes the long prompt CHUNK through the same
    steps the short lanes decode in; the split groups the chunk lane with
    its width-peers and every lane stays token-exact."""
    tpkg = twins("mha")[1]
    be, eng = _engine(tpkg, token_budget=24)
    prompts = _prompts(tpkg.cfg, [LONG] + SHORTS, seed=7)
    got = _serve_all(tpkg, eng, prompts)
    for sid, ids in prompts.items():
        assert got[sid] == _dense(tpkg, ids)
    assert eng.stats["chunks"] > 2, "long prompt never chunked"
    assert be.stats["split_steps"] > 0


def test_hetero_quantized_long_lane():
    """The long session's KV compresses to int8 pages between turns; its
    decode rides the skewed batch through the int8 attention path.  Short
    fp lanes stay token-exact (another lane's precision cannot leak across
    lanes) and the long lane finishes its turn."""
    tpkg = twins("mha")[1]
    be, eng = _engine(tpkg)
    long_ids = _prompts(tpkg.cfg, [LONG], seed=9)["s0"]
    got1 = _serve_all(tpkg, eng, {"long": long_ids})
    assert be.quantize_session("long") > 0
    shorts = _prompts(tpkg.cfg, SHORTS, seed=11)
    follow = got1["long"] + _prompts(tpkg.cfg, [5], seed=13)["s0"]
    reqs = {"long": tpkg.Request(
        session_id="long", prompt_tokens=len(follow), max_new_tokens=GEN,
        prompt_ids=list(follow), cached_tokens=be.session_tokens("long"))}
    for sid, ids in shorts.items():
        reqs[sid] = tpkg.Request(session_id=sid, prompt_tokens=len(ids),
                                 max_new_tokens=GEN, prompt_ids=list(ids))
    for r in reqs.values():
        eng.submit(r)
    now = 0.0
    while eng.waiting or eng.running:
        now += max(eng.step(now), 1e-9)
    for sid, ids in shorts.items():
        assert reqs[sid].output_ids == _dense(tpkg, ids), \
            f"quantized neighbor perturbed fp lane {sid}"
    assert be._quant_active and len(reqs["long"].output_ids) == GEN
    assert be.stats["split_steps"] > 0
