"""Tensor-parallel serving on the head-feature rung: a pool cut along D.

Where neither the kv heads nor a page's rows divide over the shards,
`ShardingPlan.pool_spec` puts the pool (L, P+1, page, Hkv, D) on
``(None, None, None, None, "model")``: shard r holds features [r·dr,
(r+1)·dr) of every row.  The port computes attention there as GSPMD
partitions the reference's oracle: each shard's partial scores q_r · k_r
(F1, ``ops.paged_chunk_scores_partial``), summed, then each shard's softmax
at 1 / sqrt(D) of the full head times its V features (F2,
``ops.paged_chunk_softmax_pv``), its D slice of the output.

On the CPU: the plain F1 and F2, summed over shards and concatenated,
equal the plain unsharded attention and JAX's Pallas kernels in interpret
mode (2e-4 in float32, 2e-2 in bfloat16, real rows; ctx = 0 lanes exact
zeros), with padded tables, int8 pages and dr in {2, 4, 8}; the GQA twin
served at tp 4, page 2 and tp 8, page 4 with a mid-decode preemption
gives JAX's single-device tokens and JAX's tokens on the same mesh; an
export at tp 4 (this rung) resumes at tp 2 (the heads rung); the int8
tier's scales and codes equal one device's bit for bit; a call tiled over
lanes equals the untiled one.  On the card (``gpu``): F1 and F2 against
their plain versions at yi-6b's, minicpm-2b's and llama3-8b's shapes at
tp 16.  The card has no JAX: this module imports it only inside the CPU
tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import unshard
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as tref
from repro_torch.launch.mesh import make_serving_mesh
from test_torch_kernels import _assert_real_rows, _case, _jax, _quant, _torch

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _features(t, n):
    dr = t.shape[-1] // n
    return [t[..., r * dr:(r + 1) * dr].contiguous() for r in range(n)]


def _feature_attention(q, kp, vp, tables, qoff, ctx, n, quant=None,
                       mode="ref"):
    """F1 over every shard summed into one buffer in shard order, F2 on
    each shard, the outputs concatenated along D: the rung's attention."""
    D = q.shape[-1]
    ks, vs = _features(kp, n), _features(vp, n)
    qs = [q[..., r * (D // n):(r + 1) * (D // n)] for r in range(n)]
    sh = [None] * n if quant is None else [
        (a, b) + tuple(quant[2:]) for a, b in zip(_features(quant[0], n),
                                                   _features(quant[1], n))]
    ws, lanes = ops.scores_workspace(q, kp, tables, [q.device] * n)
    assert lanes == q.shape[0]
    for r in range(n):
        got = ops.paged_chunk_scores_partial(
            qs[r], ks[r], tables, qoff, ctx, mode=mode, quant=sh[r], out=ws,
            accumulate=r > 0)
        assert got is ws
    outs = [ops.paged_chunk_softmax_pv(ws, vs[r], tables, qoff, ctx, D,
                                       q.dtype, mode=mode, quant=sh[r])
            for r in range(n)]
    for o in outs:
        assert o.dtype == q.dtype and o.shape == q.shape[:3] + (D // n,)
    return torch.cat(outs, dim=-1)


# B, Sq, H, Hkv, D, page, maxp, shards (dr = D / shards)
CASES = [
    (4, 8, 4, 2, 16, 2, 6, 8),      # the CPU serving twin at tp 8: dr 2
    (4, 8, 4, 2, 16, 2, 6, 4),      # ... at tp 4, page 2: dr 4
    (3, 6, 8, 1, 32, 4, 5, 4),      # MQA, dr 8
    (3, 1, 32, 4, 64, 8, 6, 16),    # a yi-6b-like decode: G 8, dr 4
    (4, 9, 6, 2, 32, 8, 4, 4),      # G 3, ragged chunks, dr 8
    (3, 5, 4, 4, 16, 1, 12, 2),     # 1-row pages, MHA, dr 8
]


@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,maxp,n", CASES)
def test_plain_features_equal_the_unsharded_plain(B, Sq, H, Hkv, D, page,
                                                  maxp, n, dtype, quant):
    """Every shard's F1 summed, each shard's F2, concatenated: the plain
    unsharded attention on real rows, ctx = 0 lanes exact zeros, padded
    table columns never read (they repeat the lane's last page)."""
    arrs = _case(B * 13 + Sq + n, B, Sq, H, Hkv, D, page, maxp)
    args = _torch(arrs, getattr(torch, dtype))
    qt = None
    if quant:
        kq, vq, ks, vs, fl = _quant(arrs[1], arrs[2], seed=B + n)
        qt = (kq, vq, ks, vs, fl)
        assert 0 < int(fl.sum()) < fl.numel()
    got = _feature_attention(*args, n, quant=qt)
    want = tref.paged_chunk_attention_ref(*args, quant=qt)
    _assert_real_rows(got.float(), want.float(), arrs[4], arrs[5],
                      TOL[dtype])


@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_plain_features_equal_pallas_interpret(n, dtype, quant):
    """JAX's Pallas `paged_chunk_attention` / `_quant` in interpret mode,
    as the JAX package's tests run them on the CPU, on the full pool; the
    port's rung over n shards (dr = 16 / n)."""
    from repro.kernels.paged_attention import (paged_chunk_attention,
                                               paged_chunk_attention_quant)
    import jax.numpy as jnp
    arrs = _case(70 + n, 3, 8, 4, 2, 16, 2, 8)
    jargs = _jax(arrs, dtype)
    args = _torch(arrs, getattr(torch, dtype))
    qt = None
    if quant:
        qt = _quant(arrs[1], arrs[2], seed=n)
        jq = tuple(jnp.asarray(t.numpy()) for t in qt)
        want = paged_chunk_attention_quant(*jargs[:3], *jq, *jargs[3:], bq=4,
                                           interpret=True)
    else:
        want = paged_chunk_attention(*jargs, bq=4, interpret=True)
    got = _feature_attention(*args, n, quant=qt)
    _assert_real_rows(got.float(), np.asarray(want, np.float32), arrs[4],
                      arrs[5], TOL[dtype])


def test_ctx0_lane_is_zeros_and_scale_is_the_full_heads():
    """A lane of ctx 0 gives zeros, not the NaN of a softmax over masked
    keys only; the softmax scale is 1 / sqrt(D) of the full head, not of
    a shard's dr: F2 with head_dim = dr differs."""
    arrs = _case(5, 3, 4, 4, 2, 16, 2, 4)
    q, kp, vp, tab, qoff, ctx = _torch(arrs, torch.float32)
    assert int(ctx[-1]) == 0
    s = ops.paged_chunk_scores_partial(q, kp, tab, qoff, ctx)
    o = ops.paged_chunk_softmax_pv(s, vp, tab, qoff, ctx, 16, q.dtype)
    assert torch.equal(o[-1], torch.zeros_like(o[-1]))
    assert torch.isfinite(o).all()
    wrong = ops.paged_chunk_softmax_pv(s, vp, tab, qoff, ctx, 4, q.dtype)
    assert (wrong[0] - o[0]).abs().max() > 1e-3


def test_scores_workspace_tiles_lanes_and_shares_a_device(monkeypatch):
    """One buffer on shard 0's device when the shards share it, None
    across devices; the lanes a tile shrink so that a buffer stays within
    SCORES_CAP (at least one)."""
    q = torch.zeros(6, 4, 8, 2)
    kp = torch.zeros(10, 4, 2, 2)
    tab = torch.zeros(6, 5, dtype=torch.int32)
    ws, lanes = ops.scores_workspace(q, kp, tab, ["cpu"] * 4)
    assert lanes == 6 and ws.shape == (6, 8, 4, 20)
    assert ws.dtype == torch.float32
    monkeypatch.setattr(ops, "SCORES_CAP", 2 * 8 * 4 * 20 * 4 + 5)
    ws, lanes = ops.scores_workspace(q, kp, tab, ["cpu"] * 4)
    assert lanes == 2 and ws.shape == (2, 8, 4, 20)
    monkeypatch.setattr(ops, "SCORES_CAP", 1)
    assert ops.scores_workspace(q, kp, tab, ["cpu"] * 4)[1] == 1
    ws, lanes = ops.scores_workspace(q, kp, tab, ["cpu", "meta"])
    assert ws is None and lanes == 1


# (B, Sq, H, Hkv, table width, page): run G's decode and chunk calls at
# yi-6b's tp 16 (H 32, Hkv 4), llama3-8b's (Hkv 8), minicpm-2b's (MHA 36),
# the CPU twin's, 1-row pages and one long table
PLAN_SHAPES = [(B, 1, 32, 4, w, 8) for B in (1, 2, 4) for w in (128, 256, 512)]
PLAN_SHAPES += [(1, 1024, 32, 4, 256, 8), (1, 32, 32, 4, 128, 8),
                (4, 512, 32, 4, 512, 8), (2, 512, 32, 8, 256, 8),
                (5, 1, 36, 36, 40, 8), (3, 37, 36, 36, 12, 8),
                (3, 9, 4, 2, 8, 2), (3, 9, 8, 1, 20, 1),
                (1, 1, 16, 1, 4096, 1), (1, 3, 48, 3, 7, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dr", pa.FEATURE_DIMS)
def test_feature_pv_plan_covers_every_key_once(dr, dtype):
    """F2's launch plan (what the card kernel checks on its side): every
    key of a lane falls in exactly one split of whole 128-key warp tiles,
    every (row, head) pair in one tile; a cluster of at most 8 CTAs, a CTA
    of at most 8 warps, no more key warps than its split has warp tiles,
    shared memory within 227 KB."""
    npw = pa.feature_pv_pairs(dr)
    for B, Sq, H, Hkv, W, page in PLAN_SHAPES:
        for n_sm in (132, 16, 1):
            p = pa.feature_pv_plan(B, Sq, H, Hkv, W, page, dr, dtype, n_sm)
            keys = W * page
            assert p.npg in (1, 2, 4, 8) and p.kw >= 1
            assert p.npg * p.kw <= pa.FEATURE_MAX_WARPS
            assert 1 <= p.n_split <= pa.FEATURE_MAX_SPLIT
            assert p.split % pa.FEATURE_TILE == 0
            owner = np.arange(keys) // p.split
            assert owner.max() == p.n_split - 1
            assert np.bincount(owner, minlength=p.n_split).min() > 0
            assert pa.FEATURE_TILE * p.kw * dr <= pa.FEATURE_STAGE_FLOATS
            assert p.kw * pa.FEATURE_TILE <= max(p.split, pa.FEATURE_TILE)
            assert p.pairs == p.npg * npw
            G = H // Hkv
            assert (p.tiles - 1) * p.pairs < Sq * G <= p.tiles * p.pairs
            assert p.grid == p.n_split * p.tiles * B * Hkv
            assert p.smem <= pa.SMEM_PER_CTA


def test_feature_plans_fill_the_card():
    """At run G's largest decode call (B 4, Hkv 4, G 8, 512 pages of 8:
    4096 keys) F2's grid reaches the SMs; at B 1 each lane's keys go over
    the whole 8-CTA cluster; a long chunk needs no split.  F1 cuts a key
    tile's rows into parts of 256 (row, head) pairs, 16 rows at least, and
    shorter ones, 4 rows at least, where its grid would not fill the
    card."""
    for n_sm in (132, 114, 66):
        p = pa.feature_pv_plan(4, 1, 32, 4, 512, 8, 8, torch.bfloat16, n_sm)
        assert p.grid >= n_sm and p.n_split > 1
    p = pa.feature_pv_plan(1, 1, 32, 4, 512, 8, 8, torch.bfloat16, 132)
    assert p.n_split == pa.FEATURE_MAX_SPLIT
    p = pa.feature_pv_plan(1, 1, 32, 4, 4, 8, 8, torch.bfloat16, 132)
    assert p.n_split == 1                      # 32 keys: one warp tile
    p = pa.feature_pv_plan(4, 512, 32, 4, 512, 8, 8, torch.bfloat16, 132)
    assert p.n_split == 1 and p.grid >= 132
    assert pa.feature_scores_plan(4, 1, 32, 4, 512, 8, 132) == 1
    for B, Sq, W in ((1, 1, 128), (1, 32, 128), (4, 37, 12), (2, 512, 256),
                     (4, 512, 512), (1, 1024, 256)):
        for G in (1, 3, 4, 8, 16):
            r = pa.feature_scores_plan(B, Sq, 4 * G, 4, W, 8, 132)
            part = -(-Sq // r)
            assert 1 <= r <= -(-Sq // pa.FEATURE_SCORES_FILL_ROWS)
            assert part * G <= max(pa.FEATURE_SCORES_PAIRS,
                                   pa.FEATURE_SCORES_MIN_ROWS * G)
    # run G's 32-row chunk of one lane over 1024 keys: 32 CTAs uncut
    assert pa.feature_scores_plan(1, 32, 32, 4, 128, 8, 132) == 8


def test_all_reduce_path_equals_the_workspace():
    """Shards on distinct devices keep their own scores and sum them with
    `collectives.all_reduce_sum`: the same result as the shared buffer."""
    arrs = _case(9, 4, 6, 4, 2, 16, 2, 6)
    q, kp, vp, tab, qoff, ctx = _torch(arrs, torch.float32)
    ks, vs = _features(kp, 4), _features(vp, 4)
    parts = [ops.paged_chunk_scores_partial(q[..., 4 * r:4 * r + 4], ks[r],
                                            tab, qoff, ctx)
             for r in range(4)]
    summed = C.all_reduce_sum(parts)
    got = torch.cat([ops.paged_chunk_softmax_pv(summed[r], vs[r], tab, qoff,
                                                ctx, 16, q.dtype)
                     for r in range(4)], dim=-1)
    want = _feature_attention(q, kp, vp, tab, qoff, ctx, 4)
    assert torch.equal(got, want)


def test_feature_dispatch_follows_the_tensor_device():
    """CPU tensors take the plain versions whatever the mode; the card
    wrappers refuse CPU tensors (no fallback); a bad mode raises."""
    arrs = _case(3, 3, 4, 4, 2, 16, 2, 4)
    q, kp, vp, tab, qoff, ctx = _torch(arrs, torch.float32)
    q2, k2, v2 = q[..., :8], kp[..., :8].contiguous(), vp[..., :8].contiguous()
    s = ops.paged_chunk_scores_partial(q2, k2, tab, qoff, ctx)
    assert torch.equal(s, tref.paged_chunk_scores_partial_ref(q2, k2, tab,
                                                              qoff, ctx))
    o = ops.paged_chunk_softmax_pv(s, v2, tab, qoff, ctx, 16, q.dtype,
                                   mode="ref")
    assert torch.equal(o, tref.paged_chunk_softmax_pv_ref(
        s, v2, tab, qoff, ctx, 16, q.dtype))
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_chunk_scores(q2, k2, tab, qoff, ctx)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_chunk_softmax_pv(s, v2, tab, qoff, ctx, 16, q.dtype)
    with pytest.raises(ValueError, match="kernel mode"):
        ops.paged_chunk_scores_partial(q2, k2, tab, qoff, ctx, mode="x")


# -- serving on the rung -------------------------------------------------------

def _mesh(tp):
    return None if tp is None else make_serving_mesh(tp, devices=["cpu"] * tp)


def _node(pkg, tp=None, page=2, **kw):
    """(mgr, backend, engine) of a node of ``pkg`` at tp (None: one
    device), page ``page``, 256 token rows."""
    from repro.launch.mesh import make_serving_mesh as jax_mesh
    mesh = None if tp is None else (jax_mesh(tp) if pkg.name == "jax"
                                    else _mesh(tp))
    _, mgr, be, eng = pkg.node(mesh=mesh, page_size=page,
                               n_pages=256 // page, **kw)
    return mgr, be, eng


def _serve(pkg, eng, be, turns, preempt_turn=None, sid="s0", cached=0):
    from _torch_twin import GEN
    outs, now = [], 0.0
    for i, t in enumerate(turns):
        req = pkg.Request(session_id=sid, prompt_tokens=len(t),
                          max_new_tokens=GEN, prompt_ids=list(t),
                          cached_tokens=cached)
        eng.submit(req)
        preempted = False
        while eng.waiting or eng.running:
            now += eng.step(now)
            if (i == preempt_turn and not preempted and eng.running
                    and req.generated >= GEN // 2):
                eng.preempt_one(now)
                preempted = True
        outs.append(list(req.output_ids))
        cached = be.session_tokens(sid)
    return outs


def _turns(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, cfg.vocab, n))) for n in lens]


@pytest.mark.parametrize("tp,page,kind", [
    pytest.param(4, 2, "gqa", id="4-2"),
    pytest.param(8, 4, "gqa", id="8-4"),
    pytest.param(4, 2, "minicpm", id="minicpm-4-2")])
def test_serving_on_the_rung_equals_jax(monkeypatch, tp, page, kind):
    """The GQA twin (2 kv heads, D 16) at tp 4, page 2 (dr 4) and tp 8,
    page 4 (dr 2), and minicpm-2b's MHA with tied embeddings (6 heads, each
    its own kv head, as 36 % 16 is not 0 at the card's tp 16, and an odd
    vocab, 257, as its 122753) at tp 4, page 2 (dr 4, by the cp.async
    gather, as minicpm-2b's dr 4 on the card): two turns with a
    mid-decode preemption (swap-out and swap-in through the shards'
    feature gather and scatter) give JAX's single-device tokens and JAX's
    tokens on the same mesh, whose pool lies on the same spec.  The shards
    share the CPU, so every layer takes the one-call route
    (`ops.paged_chunk_attention_features`) and no F1 runs."""
    from _torch_twin import minicpm_twins, twins
    jpkg, tpkg = (twins("gqa") if kind == "gqa" else minicpm_twins(
        n_heads=6, n_kv_heads=6, vocab=257))
    n_kv = tpkg.cfg.n_kv_heads
    turns = _turns(tpkg.cfg, (11, 7), seed=3)
    _, jbe, jeng = _node(jpkg, page=page)
    want = _serve(jpkg, jeng, jbe, turns, preempt_turn=1)
    _, jbe_m, jeng_m = _node(jpkg, tp=tp, page=page)
    assert tuple(jbe_m.k_pool.sharding.spec) == \
        (None, None, None, None, "model")
    assert _serve(jpkg, jeng_m, jbe_m, turns, preempt_turn=1) == want
    _, be, eng = _node(tpkg, tp=tp, page=page)
    lay = be._layout
    assert lay.rung == "features" and lay.dr == 16 // tp
    assert lay.spec == (None, None, None, None, "model")
    assert be.k_pool[0].shape == (tpkg.cfg.n_layers, 256 // page + 1, page,
                                  n_kv, 16 // tp)
    assert be.pool_device_bytes() * tp == 2 * sum(
        p.numel() * p.element_size() for p in be.k_pool)
    calls, producers = [], []

    def record(name, f):
        def call(*a, **k):
            calls.append(name)
            if name == "paged_chunk_attention_features":
                producers.append(pa.features_producer(*a[:3]))
            return f(*a, **k)
        return call
    for name in ("paged_chunk_attention_features",
                 "paged_chunk_scores_partial"):
        monkeypatch.setattr(ops, name, record(name, getattr(ops, name)))
    got = _serve(tpkg, eng, be, turns, preempt_turn=1)
    assert got == want
    assert be.stats["swaps_out"] >= 1 and be.stats["swaps_in"] >= 1
    assert calls == ["paged_chunk_attention_features"] * (
        tpkg.cfg.n_layers * be.stats["sub_dispatches"])
    if kind == "minicpm":
        assert tpkg.cfg.tie_embeddings and "lm_head" not in tpkg.params
        assert producers == ["gather"] * len(calls)


def test_lane_tiles_serve_the_same_tokens(monkeypatch):
    """On the per-shard route (the shards taken as on distinct devices,
    where the scores buffer exists), a cap that cuts every call into
    one-lane tiles serves the tokens of the untiled calls (two sessions in
    one batch)."""
    from _torch_twin import twins
    _, tpkg = twins("gqa")
    monkeypatch.setattr(ops, "one_device", lambda devices: False)
    prompts = _turns(tpkg.cfg, (9, 13), seed=8)

    def run():
        _, be, eng = _node(tpkg, tp=4)
        reqs = [tpkg.Request(session_id=f"s{i}", prompt_tokens=len(p),
                             max_new_tokens=4, prompt_ids=list(p))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        now = 0.0
        while eng.waiting or eng.running:
            now += eng.step(now)
        return [list(r.output_ids) for r in reqs]
    want = run()
    monkeypatch.setattr(ops, "SCORES_CAP", 1)
    assert run() == want


def test_export_on_the_rung_imports_on_the_heads_rung():
    """Served and exported at tp 4, page 2 (the head-feature rung; the
    payload full-head numpy), resumed at tp 2 (the kv-head rung, 2 kv heads
    over 2 shards) with JAX's single-device tokens."""
    from _torch_twin import twins
    jpkg, tpkg = twins("gqa")
    cfg = tpkg.cfg
    turns = _turns(cfg, (9, 6), seed=5)
    _, jbe, jeng = _node(jpkg)
    want = _serve(jpkg, jeng, jbe, turns)
    _, be4, eng4 = _node(tpkg, tp=4)
    got = _serve(tpkg, eng4, be4, turns[:1])
    tokens = be4.session_tokens("s0")
    payload = be4.export_session("s0")
    for p in payload["layers"].values():
        for side in ("k", "v"):
            assert isinstance(p[side], np.ndarray)
            assert p[side].shape == (tokens - 1, cfg.n_kv_heads, cfg.d_head)
    mgr2, be2, eng2 = _node(tpkg, tp=2)
    assert be2._layout.rung == "heads"
    be2.import_session("s0", payload)
    mgr2.mark_resident("s0", tokens, be2.session_kv_bytes(tokens),
                       priority=0)
    got += _serve(tpkg, eng2, be2, turns[1:], cached=tokens)
    assert got == want


PROMPT = list(range(16)) + [100, 101, 102, 103, 104]   # 21 tokens
TURN2 = [31, 32, 33, 34]


def test_int8_tier_on_the_rung_is_bit_equal_to_one_device():
    """One payload imported on one device and at tp 4, page 2, quantized:
    the per-page scales (a maximum over every shard's features of the
    page) and codes equal one device's bit for bit, and the turns decoded
    from the int8 pages (B.2's feature mode) give the same tokens."""
    from _torch_twin import check_invariants, recompute, serve_to_end, twins
    _, tpkg = twins("gqa")
    _, be0, eng0 = _node(tpkg)
    r1 = tpkg.Request(session_id="A", prompt_tokens=len(PROMPT),
                      max_new_tokens=6, prompt_ids=list(PROMPT))
    now = serve_to_end(eng0, [r1], be0.mgr, be0)
    tokens = be0.session_tokens("A")
    payload = be0.export_session("A")

    def run(tp):
        mgr, be, eng = _node(tpkg, tp=tp)
        be.import_session("A", payload)
        mgr.mark_resident("A", tokens, be.session_kv_bytes(tokens),
                          priority=0)
        be._ensure_resident("A")
        be.drain_transfers()
        assert be.quantize_session("A") > 0
        pages = be.alloc[0].seqs["A"].pages[:len(PROMPT) // 2]
        lay = be._layout
        if lay is None:
            codes = (be.kq_pool, be.vq_pool)
            scales = (be.k_scale, be.v_scale)
        else:
            codes = (unshard(be.kq_pool, lay.spec),
                     unshard(be.vq_pool, lay.spec))
            scales = (be.k_scale[0], be.v_scale[0])
        snap = [t[:, pages].clone() for t in codes + scales]
        outs, t = [], now
        for turn in (TURN2, TURN2):
            r = tpkg.Request(session_id="A", prompt_tokens=len(turn),
                             max_new_tokens=6, prompt_ids=list(turn),
                             cached_tokens=be.session_tokens("A"))
            t = serve_to_end(eng, [r], mgr, be, t)
            outs.append(list(r.output_ids))
            be.swap_out("A", be.session_tokens("A"))
            be.drain_transfers()
        check_invariants(mgr, be)
        assert be.stats["quant_dispatches"] == 1
        return snap, outs, be

    want_snap, want, _ = run(None)
    snap, got, be = run(4)
    assert be._layout.rung == "features"
    for a, b in zip(snap, want_snap):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got == want
    assert got == recompute(tpkg, [PROMPT, TURN2, TURN2])[1:]


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    yield torch.device("cuda")


# B, Sq, H, Hkv, D, page, maxp, shards: the published models at tp 16,
# page 8 (yi-6b dr 8 G 8; minicpm-2b dr 4 G 1; llama3-8b dr 8 G 4), decode
# and chunks
CARD_CASES = [
    (5, 1, 32, 4, 128, 8, 40, 16),
    (3, 37, 32, 4, 128, 8, 12, 16),
    (5, 1, 36, 36, 64, 8, 40, 16),
    (3, 37, 36, 36, 64, 8, 12, 16),
    (5, 1, 32, 8, 128, 8, 40, 16),
    (3, 150, 32, 8, 128, 8, 30, 16),
    (3, 9, 4, 2, 16, 2, 8, 8),          # the CPU twin's dr 2, page 2
    (3, 9, 8, 1, 64, 1, 20, 4),         # 1-row pages, dr 16
]


def _shards(arrs, n, dtype, qt=None):
    """The card's tensors of a case and its ``n`` shards' (q features,
    K pool, V pool, int8 shadows) along D; ``qt`` the full pools' int8
    state (CPU), or None."""
    q, kp, vp, tab, qoff, ctx = (t.cuda() for t in _torch(
        arrs, getattr(torch, dtype)))
    if qt is not None:
        qt = tuple(t.cuda() for t in qt)
    dr = q.shape[-1] // n
    shards = []
    for r in range(n):
        f = slice(r * dr, (r + 1) * dr)
        sq = None if qt is None else (qt[0][..., f].contiguous(),
                                      qt[1][..., f].contiguous(), *qt[2:])
        shards.append((q[..., f], kp[..., f].contiguous(),
                       vp[..., f].contiguous(), sq))
    return (q, kp, vp, tab, qoff, ctx), qt, shards


def _shard_case(seed, B, Sq, H, Hkv, D, page, maxp, n, dtype, quant):
    arrs = _case(seed, B, Sq, H, Hkv, D, page, maxp)
    qt = _quant(arrs[1], arrs[2], seed=seed) if quant else None
    return (arrs,) + _shards(arrs, n, dtype, qt)


def _lanes(seed, Sq, H, Hkv, D, page, maxp, ctxs, qoffs):
    """A case whose lanes have the given ctx and q_offsets (their chunk
    rows past ctx are bucket padding), on permuted tables padded with each
    lane's last page."""
    rng = np.random.default_rng(seed)
    B = len(ctxs)
    P = maxp * B + 3
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, page, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, page, Hkv, D)).astype(np.float32)
    perm = rng.permutation(P - 1)
    tables = np.zeros((B, maxp), np.int32)
    for b, c in enumerate(ctxs):
        w = max(1, -(-c // page))
        tables[b, :w] = perm[b * maxp:b * maxp + w]
        tables[b, w:] = tables[b, w - 1]
    return (q, kp, vp, tables, np.asarray(qoffs, np.int32),
            np.asarray(ctxs, np.int32))


def _visible(qoff, ctx, Sq, T):
    return tref._visible(qoff, ctx, Sq, T, qoff.device)


def _hold_on_card(arrs, full, qt, shards, dtype):
    """F1 of every shard into one buffer filled with NaN (shard 0 writes,
    the others add) against the plain partial scores summed, on every
    entry a row sees, and every other entry still NaN; each shard's F2 on
    the summed scores against its plain version on real rows, padding rows
    zeros; the shards' outputs joined against the unsharded plain
    attention.  Launch counts: one per call."""
    q, kp, vp, tab, qoff, ctx = full
    B, Sq, H, D = q.shape
    n = len(shards)
    page = kp.shape[1]
    T = tab.shape[1] * page
    vis = _visible(qoff, ctx, Sq, T)[:, None].expand(B, H, Sq, T)
    vis = vis & (qoff.long()[:, None] + torch.arange(Sq, device=q.device)
                 < ctx.long()[:, None])[:, None, :, None]
    ws = torch.full((B, H, Sq, T), float("nan"), device=q.device)
    want_s = torch.zeros_like(ws)
    before = (pa.scores_launches, pa.quant_scores_launches)
    for r, (sq, sk, _, sqt) in enumerate(shards):
        pa.paged_chunk_scores(sq, sk, tab, qoff, ctx, quant=sqt, out=ws,
                              accumulate=r > 0)
        want_s += tref.paged_chunk_scores_partial_ref(sq, sk, tab, qoff, ctx,
                                                      quant=sqt)
    torch.cuda.synchronize()
    got_n = (pa.scores_launches - before[0],
             pa.quant_scores_launches - before[1])
    assert got_n == ((0, n) if qt is not None else (n, 0))
    assert bool(torch.isnan(ws[~vis]).all()), "F1 wrote an entry no row sees"
    if bool(vis.any()):
        scale = want_s[vis].abs().max().item()
        assert torch.isfinite(ws[vis]).all()
        assert (ws[vis] - want_s[vis]).abs().max().item() <= \
            1e-5 * max(scale, 1)
    before = (pa.pv_launches, pa.quant_pv_launches)
    outs = []
    for r, (_, _, sv, sqt) in enumerate(shards):
        o = pa.paged_chunk_softmax_pv(ws, sv, tab, qoff, ctx, D, q.dtype,
                                      quant=sqt)
        w = tref.paged_chunk_softmax_pv_ref(ws, sv, tab, qoff, ctx, D,
                                            q.dtype, quant=sqt)
        _assert_real_rows(o.float().cpu(), w.float().cpu(), arrs[4], arrs[5],
                          TOL[dtype])
        for b in range(B):
            nb = int(arrs[5][b] - arrs[4][b]) if arrs[5][b] else 0
            assert bool((o[b, nb:] == 0).all())
        outs.append(o)
    torch.cuda.synchronize()
    got_n = (pa.pv_launches - before[0], pa.quant_pv_launches - before[1])
    assert got_n == ((0, n) if qt is not None else (n, 0))
    got = torch.cat(outs, dim=-1)
    want = tref.paged_chunk_attention_ref(q, kp, vp, tab, qoff, ctx,
                                          quant=qt)
    _assert_real_rows(got.float().cpu(), want.float().cpu(), arrs[4],
                      arrs[5], TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,maxp,n", CARD_CASES)
def test_cuda_features_match_plain(cuda, B, Sq, H, Hkv, D, page, maxp, n,
                                   dtype, quant):
    """F1 (each shard, written then accumulated) against the plain partial
    scores on every visible entry, the rest untouched; F2 on the summed
    scores against its plain version on real rows; the shards' outputs
    concatenated against the unsharded plain attention.  Launch counts:
    one per call."""
    arrs, full, qt, shards = _shard_case(B * 31 + Sq, B, Sq, H, Hkv, D, page,
                                         maxp, n, dtype, quant)
    _hold_on_card(arrs, full, qt, shards, dtype)


def _alternate(arrs, seed):
    """int8 state of a case's pools, flagged on every other page."""
    kq, vq, ks, vs, fl = _quant(arrs[1], arrs[2], seed=seed)
    return kq, vq, ks, vs, (torch.arange(fl.numel()) % 2).int()


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,side", [(1, "below"), (1, "above"), (4, None)])
def test_cuda_features_decode_split_over_a_cluster(cuda, B, side, dtype,
                                                   quant):
    """Decode at yi-6b's tp-16 shape (G 8, dr 8, pages of 8, a table of 512
    pages): F2's plan cuts each lane's keys over the CTAs of a cluster, and
    a lane's ctx sits one key below or above a split's edge (B = 1), or
    the lanes sit at both sides of the first and the last edge and at the
    table's end (B = 4); int8 pages flagged on alternate pages."""
    H, Hkv, dr, page, maxp = 32, 4, 8, 8, 512
    plan = pa.feature_pv_plan(B, 1, H, Hkv, maxp, page, dr,
                              getattr(torch, dtype), pa._sm_count(0))
    assert 1 < plan.n_split <= pa.FEATURE_MAX_SPLIT
    first, last = plan.split, plan.split * (plan.n_split - 1)
    if B == 1:
        ctxs = [first + (1 if side == "above" else -1)]
    else:
        ctxs = [first - 1, first + 1, last + 1, maxp * page]
    arrs = _lanes(B * 7 + len(side or ""), 1, H, Hkv, 4 * dr, page, maxp,
                  ctxs, [c - 1 for c in ctxs])
    qt = _alternate(arrs, seed=B) if quant else None
    _hold_on_card(arrs, *_shards(arrs, 4, dtype, qt), dtype)


# Sq, H, Hkv, dr, shards, page, table width, ctx, q_offsets: chunks whose
# rows start past a key tile's first key (q_offset > 0, not a multiple of
# 128), G 1, 4 and 8 at dr 2, 4, 8 and 16, a long chunk of one lane (F1's
# rows cut over CTAs), padding rows and a ctx = 0 lane; dr 32 and 64,
# pages of 32 and a decode step at G 16
GEOMETRY_CASES = [
    (40, 8, 8, 2, 4, 4, 128, [333, 290, 0], [300, 280, 0]),
    (40, 16, 4, 4, 4, 8, 64, [333, 150], [300, 130]),
    (37, 32, 4, 8, 4, 8, 64, [500, 137, 0], [470, 100, 0]),
    (24, 8, 1, 16, 4, 16, 16, [250, 31], [229, 20]),
    (300, 32, 4, 8, 4, 8, 64, [467], [167]),
    (9, 36, 36, 4, 16, 8, 32, [200, 129, 5], [191, 128, 0]),
    # the wrapper's widest: dr 32 and 64, pages of 16 and 32, G 16
    (20, 16, 1, 32, 2, 32, 8, [230, 0], [215, 0]),
    (9, 4, 2, 64, 2, 16, 16, [250, 100], [241, 95]),
    (1, 16, 1, 8, 4, 8, 64, [500, 1], [499, 0]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,H,Hkv,dr,n,page,maxp,ctxs,qoffs",
                         GEOMETRY_CASES)
def test_cuda_features_chunk_geometry(cuda, Sq, H, Hkv, dr, n, page, maxp,
                                      ctxs, qoffs, dtype, quant):
    """Chunks past a key tile's first key, every G and dr of the main path
    and beside it up to the wrapper's widest (dr 64, pages of 32, G 16),
    int8 pages flagged on alternate pages: F1 summed over the shards with
    every entry a row cannot see left untouched, F2 and the joined output
    held to their plain versions."""
    arrs = _lanes(Sq + dr * 3 + H, Sq, H, Hkv, dr * n, page, maxp, ctxs,
                  qoffs)
    qt = _alternate(arrs, seed=dr) if quant else None
    _hold_on_card(arrs, *_shards(arrs, n, dtype, qt), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
def test_cuda_features_accumulate_sixteen_shards(cuda, quant):
    """yi-6b's tp-16 shards (dr 8) of a 3-lane chunk step summed into one
    buffer: 16 launches of F1, the first writing and 15 adding, entries no
    row sees still the NaN the buffer was filled with."""
    arrs = _lanes(16, 33, 32, 4, 128, 8, 40, [300, 64, 0], [280, 40, 0])
    qt = _alternate(arrs, seed=16) if quant else None
    _hold_on_card(arrs, *_shards(arrs, 16, "bfloat16", qt), "bfloat16")


@pytest.mark.gpu
def test_cuda_features_reject_what_they_cannot_take(cuda):
    arrs, full, _, shards = _shard_case(3, 3, 5, 8, 2, 64, 8, 4, 4,
                                        "float32", False)
    q, kp, vp, tab, qoff, ctx = full
    sq, sk, sv, _ = shards[0]
    with pytest.raises(ValueError, match="features a shard"):
        pa.paged_chunk_scores(q[..., :12], kp[..., :12].contiguous(), tab,
                              qoff, ctx)
    with pytest.raises(ValueError, match="page size"):
        pa.paged_chunk_scores(sq, sk[:, :3].contiguous(), tab, qoff, ctx)
    with pytest.raises(ValueError, match="accumulate needs out"):
        pa.paged_chunk_scores(sq, sk, tab, qoff, ctx, accumulate=True)
    s = pa.paged_chunk_scores(sq, sk, tab, qoff, ctx)
    with pytest.raises(ValueError, match="do not divide"):
        pa.paged_chunk_softmax_pv(s, sv, tab, qoff, ctx, 60, q.dtype)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_chunk_scores(sq, sk, tab.long(), qoff, ctx)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_chunk_softmax_pv(s.transpose(2, 3), sv, tab, qoff, ctx, 64,
                                  q.dtype)
