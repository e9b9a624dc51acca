"""The head-feature rung on one device: one launch a call.

When every shard's pools live on one device, `DenseLM._feature_attention`
calls ``ops.paged_chunk_attention_features`` once a layer: kernel 1 (B.2
with the int8 state) with each key row's D columns gathered from the tp
shards' pools (dr features each), so the sum over the shards is the depth
of Q·Kᵀ and no float32 scores buffer exists.  Its plain version is the
plain attention on the pools concatenated along D; the kernel's output is
the unsharded kernel's on those pools, bit for bit.

On the CPU: the plain route equals ``paged_chunk_attention_ref`` on the
concatenated pools exactly, and the per-shard route (F1 summed, F2,
concatenated) and JAX's Pallas kernels in interpret mode within 2e-4
(float32) / 2e-2 (bfloat16) on real rows, over padded tables, ctx = 0
lanes, 1-row pages, dr 2-8, G 1-8 and mixed int8 flags; the GQA twin
served on the rung through the per-shard route (the shards taken as on
distinct devices) gives JAX's tokens.  On the card (``gpu``): the kernel
against its plain version and bit-equal to kernel 1 / B.2 on the
concatenated pools at yi-6b's, llama3-8b's and minicpm-2b's shapes at tp
16, decode and chunks, and what it refuses.  The card has no JAX: this
module imports it only inside the CPU tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as tref
from test_torch_features import (CASES, _feature_attention, _features,
                                 _node, _serve, _turns)
from test_torch_kernels import _assert_real_rows, _case, _jax, _quant, _torch

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _shards(args, n, quant=None):
    """(q, k_pools, v_pools, tables, q_offsets, ctx_lens) and the shards'
    int8 state of the full-pool case ``args`` cut into n feature shards."""
    q, kp, vp, tab, qoff, ctx = args
    qt = None if quant is None else (
        _features(quant[0], n), _features(quant[1], n), *quant[2:])
    return (q, _features(kp, n), _features(vp, n), tab, qoff, ctx), qt


def _args(B, Sq, H, Hkv, D, page, maxp, n, dtype, quant, seed):
    arrs = _case(seed, B, Sq, H, Hkv, D, page, maxp)
    args = _torch(arrs, getattr(torch, dtype))
    qt = None
    if quant:
        qt = _quant(arrs[1], arrs[2], seed=seed)
        assert 0 < int(qt[4].sum()) < qt[4].numel()
    return arrs, args, qt


@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,maxp,n", CASES)
def test_plain_route_is_the_plain_attention_on_concatenated_pools(
        B, Sq, H, Hkv, D, page, maxp, n, dtype, quant):
    """The entry on CPU tensors (auto and ref) is exactly the plain
    attention on the shards' pools concatenated along D."""
    arrs, args, qt = _args(B, Sq, H, Hkv, D, page, maxp, n, dtype, quant,
                           B * 17 + Sq + n)
    sh, sqt = _shards(args, n, qt)
    want = tref.paged_chunk_attention_ref(*args, quant=qt)
    for mode in ("auto", "ref"):
        got = ops.paged_chunk_attention_features(*sh, mode=mode, quant=sqt)
        assert got.dtype == args[0].dtype and got.shape == args[0].shape
        assert torch.equal(got, want)


@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,maxp,n", CASES)
def test_plain_route_equals_the_per_shard_route(B, Sq, H, Hkv, D, page,
                                                maxp, n, dtype, quant):
    """The one-call route against F1 summed over the shards and F2 on each
    (the distinct-device route), on real rows; ctx = 0 lanes exact
    zeros."""
    arrs, args, qt = _args(B, Sq, H, Hkv, D, page, maxp, n, dtype, quant,
                           B * 29 + Sq + n)
    sh, sqt = _shards(args, n, qt)
    got = ops.paged_chunk_attention_features(*sh, quant=sqt)
    want = _feature_attention(*args, n, quant=qt)
    _assert_real_rows(got.float(), want.float(), arrs[4], arrs[5],
                      TOL[dtype])


@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_plain_route_equals_pallas_interpret(n, dtype, quant):
    """JAX's Pallas `paged_chunk_attention` / `_quant` in interpret mode on
    the full pool, as the JAX package's tests run them on the CPU."""
    from repro.kernels.paged_attention import (paged_chunk_attention,
                                               paged_chunk_attention_quant)
    import jax.numpy as jnp
    arrs = _case(90 + n, 3, 8, 4, 2, 16, 2, 8)
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
    sh, sqt = _shards(args, n, qt)
    got = ops.paged_chunk_attention_features(*sh, quant=sqt)
    _assert_real_rows(got.float(), np.asarray(want, np.float32), arrs[4],
                      arrs[5], TOL[dtype])


def test_dispatch_follows_the_tensor_device():
    """CPU tensors take the plain version whatever the mode, meta tensors
    give shapes only; the card wrapper refuses CPU tensors (no fallback);
    a bad mode raises."""
    arrs = _case(4, 3, 4, 4, 2, 16, 2, 4)
    args = _torch(arrs, torch.float32)
    sh, _ = _shards(args, 4)
    want = tref.paged_chunk_attention_ref(*args)
    assert torch.equal(ops.paged_chunk_attention_features(*sh), want)
    meta = [t.to("meta") if isinstance(t, torch.Tensor)
            else [p.to("meta") for p in t] for t in sh]
    got = ops.paged_chunk_attention_features(*meta)
    assert got.device.type == "meta" and got.shape == want.shape
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_chunk_attention_features(*sh)
    with pytest.raises(ValueError, match="kernel mode"):
        ops.paged_chunk_attention_features(*sh, mode="x")


def test_one_device():
    assert ops.one_device(["cpu"] * 4)
    assert not ops.one_device(["cpu", "meta"])


def _pools(n, dr, page, one, dtype=torch.bfloat16, P=3, hkv=4):
    """n shard pools (P, page, hkv, dr): slices of one allocation at one
    stride (``one``) or each its own."""
    t = torch.zeros((n, P, page, hkv, dr), dtype=dtype)
    return list(t) if one else [u.clone() for u in t]


@pytest.mark.parametrize("B,Sq", [(4, 1), (64, 1), (2, 512)],
                         ids=["decode", "wide-decode", "chunk"])
def test_features_producer_takes_tma_where_open(B, Sq):
    """bf16 at dr 8, pages of 8 rows, pools at one stride (slices of one
    allocation): TMA, at decode and chunk shapes alike."""
    q = torch.zeros((B, Sq, 32, 128), dtype=torch.bfloat16)
    kp, vp = _pools(16, 8, 8, True), _pools(16, 8, 8, True)
    assert pa.pools_stride(kp) == kp[0].numel() * 2
    assert pa.features_producer(q, kp, vp) == "tma"


@pytest.mark.parametrize("what", ["separate", "float32", "dr 4", "page 4",
                                  "v apart"])
def test_features_producer_gathers_where_tma_is_closed(what):
    """The gather wherever a TMA box cannot span the shards' rows: pools
    not at one stride, float32, dr other than 8, pages under 8 rows."""
    dtype = torch.float32 if what == "float32" else torch.bfloat16
    n, dr = (32, 4) if what == "dr 4" else (16, 8)
    page = 4 if what == "page 4" else 8
    q = torch.zeros((1, 1, 32, 128), dtype=dtype)
    kp = _pools(n, dr, page, what != "separate", dtype)
    vp = _pools(n, dr, page, what not in ("separate", "v apart"), dtype)
    assert pa.pools_stride(vp) == (0 if what in ("separate", "v apart")
                                   else vp[0].numel() * vp[0].element_size())
    assert pa.features_producer(q, kp, vp) == "gather"


# -- serving on the rung -------------------------------------------------------

def _count_calls(monkeypatch, name):
    calls = []
    fn = getattr(ops, name)

    def counted(*a, **k):
        calls.append(name)
        return fn(*a, **k)
    monkeypatch.setattr(ops, name, counted)
    return calls


def test_serving_through_the_per_shard_route_equals_jax(monkeypatch):
    """The GQA twin at tp 4, page 2 with the shards taken as on distinct
    devices: F1, the all-reduce of the scores, F2 and the all-gather on
    every layer, none of the one-call route; two turns with a mid-decode
    preemption give JAX's single-device tokens."""
    tp, page = 4, 2
    from _torch_twin import twins
    jpkg, tpkg = twins("gqa")
    turns = _turns(tpkg.cfg, (11, 7), seed=3)
    _, jbe, jeng = _node(jpkg, page=page)
    want = _serve(jpkg, jeng, jbe, turns, preempt_turn=1)
    monkeypatch.setattr(ops, "one_device", lambda devices: False)
    fused = _count_calls(monkeypatch, "paged_chunk_attention_features")
    f1 = _count_calls(monkeypatch, "paged_chunk_scores_partial")
    f2 = _count_calls(monkeypatch, "paged_chunk_softmax_pv")
    _, be, eng = _node(tpkg, tp=tp, page=page)
    assert be._layout.rung == "features"
    assert _serve(tpkg, eng, be, turns, preempt_turn=1) == want
    steps = tpkg.cfg.n_layers * be.stats["sub_dispatches"]
    assert not fused and len(f1) == len(f2) == steps * tp


def test_one_device_serves_one_call_a_layer(monkeypatch):
    """Shards on one device: one call of the one-call route a layer and
    sub-dispatch, no F1 or F2."""
    from _torch_twin import twins
    _, tpkg = twins("gqa")
    fused = _count_calls(monkeypatch, "paged_chunk_attention_features")
    f1 = _count_calls(monkeypatch, "paged_chunk_scores_partial")
    _, be, eng = _node(tpkg, tp=4)
    _serve(tpkg, eng, be, _turns(tpkg.cfg, (9,), seed=6))
    assert len(fused) == tpkg.cfg.n_layers * be.stats["sub_dispatches"]
    assert not f1


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    yield torch.device("cuda")


# B, Sq, H, Hkv, D, page, maxp, shards: the published models at tp 16,
# page 8 (yi-6b dr 8 G 8; llama3-8b dr 8 G 4; minicpm-2b dr 4 G 1), decode
# and chunks; then the kernel's other edges (dr 2 and 64, D 80 and 96,
# pages of 1, 2 and 4 rows)
CARD_CASES = [
    (5, 1, 32, 4, 128, 8, 40, 16),
    (3, 150, 32, 4, 128, 8, 30, 16),
    (5, 1, 32, 8, 128, 8, 40, 16),
    (3, 37, 32, 8, 128, 8, 12, 16),
    (5, 1, 36, 36, 64, 8, 40, 16),
    (3, 37, 36, 36, 64, 8, 12, 16),
    (3, 9, 8, 2, 64, 8, 12, 32),        # dr 2
    (3, 20, 8, 2, 128, 16, 6, 2),       # dr 64
    (3, 9, 4, 4, 80, 8, 8, 5),          # zamba2-2.7b's D, dr 16
    (4, 33, 32, 4, 128, 16, 20, 8),     # dr 16, pages of 16 rows
    (3, 9, 4, 4, 96, 32, 4, 3),         # phi-3-vision's D, dr 32
    (3, 9, 8, 1, 64, 1, 80, 4),         # 1-row pages
    (3, 70, 8, 2, 128, 2, 60, 16),      # 2-row pages
    (3, 9, 8, 2, 128, 4, 30, 16),       # 4-row pages
    (3, 40, 32, 4, 128, 16, 20, 16),    # dr 8, pages of 16 rows
    (2, 70, 8, 8, 64, 32, 6, 8),        # dr 8, pages of 32 rows, D 64
    (3, 9, 4, 4, 80, 8, 8, 10),         # dr 8 at D 80
    (3, 9, 4, 4, 96, 8, 8, 12),         # dr 8 at D 96
]


def _card_case(seed, B, Sq, H, Hkv, D, page, maxp, n, dtype, quant, dev,
               one=False):
    """The case on the card, its pools cut into n feature shards: each its
    own tensor, or with ``one`` slices of one allocation at one stride (as
    a card's shards hold them: the kernel reads them by TMA where dr = 8
    and the pages hold a multiple of 8 rows)."""
    arrs = _case(seed, B, Sq, H, Hkv, D, page, maxp)
    args = [t.to(dev) for t in _torch(arrs, getattr(torch, dtype))]
    qt = None
    if quant:
        qt = [t.to(dev) for t in _quant(arrs[1], arrs[2], seed=seed,
                                        share=0.5)]
    sh, sqt = _shards(args, n, qt)
    if one:
        sh = (sh[0], list(torch.stack(sh[1])), list(torch.stack(sh[2])),
              *sh[3:])
        if sqt is not None:
            sqt = (list(torch.stack(sqt[0])), list(torch.stack(sqt[1])),
                   *sqt[2:])
    return arrs, args, qt, sh, sqt


LAYOUTS = pytest.mark.parametrize("one", [False, True],
                                  ids=["separate", "one-allocation"])


@pytest.mark.gpu
@LAYOUTS
@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,maxp,n", CARD_CASES)
def test_cuda_matches_plain_and_the_unsharded_kernel(cuda, B, Sq, H, Hkv, D,
                                                     page, maxp, n, dtype,
                                                     quant, one):
    """The kernel against its plain version on real rows (padding rows and
    ctx = 0 lanes zeros), one launch counted; at pages of 8 rows or more
    (the unsharded kernel's) bit-equal to kernel 1 / B.2 on the
    concatenated pools, whether it gathers the shards' rows or reads them
    by TMA."""
    arrs, args, qt, sh, sqt = _card_case(B * 7 + Sq + n, B, Sq, H, Hkv, D,
                                         page, maxp, n, dtype, quant, cuda,
                                         one)
    before = (pa.features_launches, pa.quant_features_launches)
    got = pa.paged_chunk_attention_features(*sh, quant=sqt)
    torch.cuda.synchronize()
    assert (pa.features_launches - before[0],
            pa.quant_features_launches - before[1]) == \
        ((0, 1) if quant else (1, 0))
    want = tref.paged_chunk_attention_features_ref(*sh, quant=sqt)
    _assert_real_rows(got.float().cpu(), want.float().cpu(), arrs[4],
                      arrs[5], TOL[dtype])
    for b, m in enumerate(arrs[5] - arrs[4]):
        assert bool((got[b, max(int(m), 0):] == 0).all()), f"lane {b}"
    if page in pa.PAGE_SIZES:
        whole = (ops.paged_chunk_attention(*args) if qt is None else
                 ops.paged_chunk_attention(*args, quant=qt))
        assert torch.equal(got, whole)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,maxp,n", CARD_CASES)
def test_cuda_producers_are_bit_equal(cuda, B, Sq, H, Hkv, D, page, maxp, n,
                                      dtype, quant):
    """The shards' pools in one allocation, as a card's shards hold them:
    the call by `features_producer`'s choice equals the cp.async gather's
    and, where TMA is open (bf16, dr 8, pages of 8 rows or more), the TMA
    producer's bit for bit; elsewhere TMA is refused."""
    arrs, args, qt, sh, sqt = _card_case(B * 5 + Sq + n, B, Sq, H, Hkv, D,
                                         page, maxp, n, dtype, quant, cuda,
                                         one=True)
    fn = pa.paged_chunk_attention_features
    got = fn(*sh, quant=sqt)
    assert torch.equal(fn(*sh, quant=sqt, producer="gather"), got)
    tma = dtype == "bfloat16" and D // n == 8 and page % 8 == 0
    assert (pa.features_producer(*sh[:3]) == "tma") == tma
    if tma:
        assert torch.equal(fn(*sh, quant=sqt, producer="tma"), got)
    else:
        with pytest.raises(ValueError, match="no TMA producer"):
            fn(*sh, quant=sqt, producer="tma")


@pytest.mark.gpu
@LAYOUTS
@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_never_reads_irrelevant_pages(cuda, quant, dtype, one):
    """Every shard's pages outside the lanes' relevant ones NaN (and with
    ``quant`` their scales, half of them flagged), the table columns past
    the relevant pages pointing at them: the output is unchanged."""
    B, Sq, H, Hkv, D, page, maxp, n = 4, 40, 32, 4, 128, 8, 16, 16
    arrs, args, qt, sh, sqt = _card_case(31, B, Sq, H, Hkv, D, page, maxp,
                                         n, dtype, quant, cuda, one)
    want = pa.paged_chunk_attention_features(*sh, quant=sqt)
    tab = args[3]
    ctx = arrs[5]
    used = {int(tab[b, p]) for b in range(B) if ctx[b]
            for p in range(-(-int(ctx[b]) // page))}
    junk = torch.tensor([p for p in range(args[1].shape[0])
                         if p not in used], device=cuda)
    bad_tab = tab.clone()
    for b in range(B):
        bad_tab[b, -(-int(ctx[b]) // page):] = junk[b % len(junk)]
    for pools in (sh[1], sh[2]):
        for p in pools:
            p[junk] = float("nan")
    if quant:
        sqt[2][junk] = float("nan")
        sqt[3][junk] = float("nan")
        sqt[4][junk[::2]] = 1
    got = pa.paged_chunk_attention_features(sh[0], sh[1], sh[2], bad_tab,
                                            sh[4], sh[5], quant=sqt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_rejects_what_it_cannot_take(cuda):
    arrs, args, qt, sh, sqt = _card_case(5, 3, 5, 8, 2, 64, 8, 4, 4,
                                         "float32", True, cuda)
    q, kps, vps, tab, qoff, ctx = sh
    fn = pa.paged_chunk_attention_features
    q96 = torch.zeros(q.shape[:3] + (96,), device=cuda)
    p12 = [torch.zeros(kps[0].shape[:3] + (12,), device=cuda)] * 8
    with pytest.raises(ValueError, match="features a shard"):
        fn(q96, p12, p12, tab, qoff, ctx)
    with pytest.raises(ValueError, match="do not match"):
        fn(q, kps[:3], vps[:3], tab, qoff, ctx)
    with pytest.raises(ValueError, match="K and"):
        fn(q, kps, vps[:3], tab, qoff, ctx)
    with pytest.raises(ValueError, match="page size"):
        fn(q, [p[:, :3].contiguous() for p in kps],
           [p[:, :3].contiguous() for p in vps], tab, qoff, ctx)
    with pytest.raises(TypeError, match="int32"):
        fn(q, kps, vps, tab.long(), qoff, ctx)
    with pytest.raises(ValueError, match="every shard's pool"):
        fn(q, kps[:3] + [kps[3].transpose(1, 2)], vps, tab, qoff, ctx)
    with pytest.raises(ValueError, match="every shard's pool"):
        fn(q, kps[:3] + [kps[3].cpu()], vps, tab, qoff, ctx)
    with pytest.raises(ValueError, match="int8 pools"):
        fn(q, kps, vps, tab, qoff, ctx, quant=(sqt[0][:2], *sqt[1:]))
    with pytest.raises(TypeError, match="int8"):
        fn(q, kps, vps, tab, qoff, ctx,
           quant=([t.float() for t in sqt[0]], *sqt[1:]))
    with pytest.raises(ValueError, match="CUDA"):
        fn(q.cpu(), kps, vps, tab, qoff, ctx)
    with pytest.raises(ValueError, match="producer"):
        fn(q, kps, vps, tab, qoff, ctx, producer="x")
    # 8 bf16 pools of dr 8, not at one stride (slice 1 of 9 left out)
    block = torch.zeros((9,) + kps[0].shape[:3] + (8,), dtype=torch.bfloat16,
                        device=cuda)
    p8 = [block[0]] + list(block[2:])
    assert pa.pools_stride(p8) == 0
    with pytest.raises(ValueError, match="no TMA producer"):
        fn(q.bfloat16(), p8, p8, tab, qoff, ctx, producer="tma")
