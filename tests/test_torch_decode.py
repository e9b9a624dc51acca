"""The port's single-token decode attention (B.3) against the JAX package.

``repro_torch.kernels.ops.paged_attention`` on CPU tensors runs the plain
version (``kernels.ref.paged_attention_ref``); the same numpy inputs go
through the JAX oracle (``repro.kernels.ref.paged_attention_ref``) and the
JAX Pallas kernel in interpret mode.  Twins of tests/test_kernels.py's
decode sweep, property and page-permutation tests (tolerances 2e-4 in
float32, 2e-2 in bfloat16) and of tests/test_kv_allocator.py's allocator
tables feeding the kernel.

The two JAX functions disagree on a lane with ctx = 0: the Pallas kernel
returns zeros (its page walk skips every page), the oracle the mean of the
gathered V rows (every score masked, a flat softmax).  The port follows the
kernel, so it is held to the oracle on lanes with ctx >= 1 and to the
Pallas kernel on every lane.

The ``gpu`` tests hold the hand-written CUDA kernel against the plain
version and against kernel 1 at Sq = 1 on the card; they skip where there
is no card.  The machine with the card has no JAX, so this module imports
JAX only inside the CPU tests.
"""
import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as tref
from repro_torch.serving.kv_cache import PagedAllocator

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# tests/test_kernels.py's decode geometries: (B, H, Hkv, D, page, maxp)
SWEEP = [
    (2, 4, 4, 32, 8, 3),       # MHA
    (3, 8, 2, 64, 16, 4),      # GQA 4:1
    (1, 8, 1, 128, 32, 2),     # MQA
    (2, 36, 36, 64, 8, 2),     # minicpm-like head count
]


@functools.lru_cache(maxsize=None)
def _jax():
    """(the JAX oracle, the JAX Pallas kernel in interpret mode)."""
    import jax
    from repro.kernels import paged_attention as jpa
    from repro.kernels import ref as jref
    return (jax.jit(jref.paged_attention_ref),
            functools.partial(jpa.paged_attention, interpret=True))


def _mk_paged(rng, B, H, Hkv, D, page, maxp):
    """tests/test_kernels.py's `_mk_paged` in numpy: permuted tables whose
    columns past a lane's pages hold other pages, ctx in [1, maxp * page]."""
    P = maxp * B + 2
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, page, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, page, Hkv, D)).astype(np.float32)
    tables = rng.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    ctx = rng.integers(1, maxp * page + 1, (B,)).astype(np.int32)
    return q, kp, vp, tables, ctx


def _torch(arrs, dtype=torch.float32):
    q, kp, vp, tables, ctx = (torch.from_numpy(np.ascontiguousarray(a))
                              for a in arrs)
    return q.to(dtype), kp.to(dtype), vp.to(dtype), tables, ctx


def _jnp(arrs, dtype="float32"):
    import jax.numpy as jnp
    q, kp, vp, tables, ctx = arrs
    return (jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
            jnp.asarray(vp, dtype), jnp.asarray(tables), jnp.asarray(ctx))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# ---------------------------------------------------------------------------
# the plain version against the JAX oracle and the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,page,maxp", SWEEP)
def test_decode_sweep_matches_jax_oracle(B, H, Hkv, D, page, maxp, dtype):
    rng = np.random.default_rng(B * 1000 + H * 10 + D)
    arrs = _mk_paged(rng, B, H, Hkv, D, page, maxp)
    got = ops.paged_attention(*_torch(arrs, getattr(torch, dtype)))
    want = _jax()[0](*_jnp(arrs, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, H, D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@settings(max_examples=12, deadline=None)
@given(B=st.integers(1, 3), G=st.sampled_from([1, 2, 4]),
       Hkv=st.sampled_from([1, 2, 4]), page=st.sampled_from([8, 16]),
       maxp=st.integers(1, 4), seed=st.integers(0, 10**6))
def test_decode_property(B, G, Hkv, page, maxp, seed):
    """Property: plain B.3 == the JAX oracle for any GQA geometry and any
    context lengths."""
    arrs = _mk_paged(np.random.default_rng(seed), B, Hkv * G, Hkv, 32, page,
                     maxp)
    got = ops.paged_attention(*_torch(arrs))
    want = _jax()[0](*_jnp(arrs))
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_decode_page_permutation_invariance():
    """Physical page placement does not matter: permuting the pool and
    remapping the tables gives the same output (what makes KV migration
    transparent to attention)."""
    rng = np.random.default_rng(7)
    q, kp, vp, tables, ctx = _torch(_mk_paged(rng, 2, 8, 4, 32, 8, 3))
    out1 = ops.paged_attention(q, kp, vp, tables, ctx)
    perm = torch.from_numpy(np.random.default_rng(8).permutation(
        kp.shape[0]))
    inv = torch.argsort(perm).to(torch.int32)
    out2 = ops.paged_attention(q, kp[perm], vp[perm], inv[tables.long()],
                               ctx)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,page,maxp", [
    (4, 8, 2, 32, 8, 3), (3, 32, 8, 128, 16, 2)])
def test_decode_matches_pallas_interpret_on_every_lane(B, H, Hkv, D, page,
                                                       maxp, dtype):
    """Every lane, ctx = 0 included, with last-valid-padded tables: the
    port's plain version equals the JAX Pallas kernel (interpret); the
    JAX oracle differs from both only on the ctx = 0 lane."""
    rng = np.random.default_rng(B + D)
    q, kp, vp, tables, ctx = _mk_paged(rng, B, H, Hkv, D, page, maxp)
    ctx[1] = 0
    ctx[0] = maxp * page                      # a full table
    for b in range(B):                        # last-valid padding
        w = max(-(-int(ctx[b]) // page), 1)
        tables[b, w:] = tables[b, w - 1]
    arrs = (q, kp, vp, tables, ctx)
    got = _np(ops.paged_attention(*_torch(arrs, getattr(torch, dtype))))
    oracle, kernel = _jax()
    want = _np(kernel(*_jnp(arrs, dtype)))
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    assert not got[1].any() and not want[1].any()       # ctx = 0: zeros
    flat = _np(oracle(*_jnp(arrs, dtype)))
    assert np.abs(flat[1]).max() > 0.05                 # the oracle's mean
    real = np.arange(B) != 1
    np.testing.assert_allclose(got[real], flat[real], rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_allocator_tables_drive_decode():
    """The port's `PagedAllocator` tables and context lengths feed
    `ops.paged_attention` directly (tests/test_kv_allocator.py's twin),
    and it agrees with the JAX Pallas kernel on the same tables."""
    rng = np.random.default_rng(0)
    page, Hkv, D, H = 8, 2, 32, 4
    a = PagedAllocator(n_pages=12, page_size=page)
    a.allocate("x", 19)
    a.allocate("y", 7)
    tables = a.batch_block_tables(["x", "y"])
    ctx = a.ctx_lens(["x", "y"])
    kp = rng.normal(size=(12, page, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(12, page, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(2, H, D)).astype(np.float32)
    arrs = (q, kp, vp, tables, ctx)
    got = ops.paged_attention(*_torch(arrs))
    want = _jax()[1](*_jnp(arrs))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=2e-5)
    assert tables.dtype == np.int32 and ctx.tolist() == [19, 7]


@pytest.mark.parametrize("B,H,Hkv,D,page,maxp", SWEEP)
def test_plain_decode_is_plain_kernel1_at_one_token(B, H, Hkv, D, page,
                                                    maxp):
    """B.3's plain version is kernel 1's at Sq = 1 with q_offset = ctx - 1
    (a ctx = 0 lane is zeros in both)."""
    rng = np.random.default_rng(D + maxp)
    q, kp, vp, tables, ctx = _torch(_mk_paged(rng, B + 1, H, Hkv, D, page,
                                              maxp))
    ctx[-1] = 0
    got = ops.paged_attention(q, kp, vp, tables, ctx, mode="ref")
    want = tref.paged_chunk_attention_ref(
        q[:, None], kp, vp, tables, (ctx - 1).clamp(min=0), ctx)[:, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert not got[-1].any()


# (B, H, Hkv, D, page, maxp, ctxs, split): the split-KV decode's edges
SPLIT_CASES = [
    (3, 8, 2, 32, 8, 8, [31, 32, 33], 32),     # ctx straddling a split edge
    (2, 4, 2, 64, 16, 4, [5, 17], 64),         # ctx shorter than one split
    (3, 8, 4, 32, 8, 4, [0, 9, 32], 32),       # ctx = 0 (zeros)
    (2, 16, 1, 32, 8, 6, [47, 48], 32),        # G = 16, straddling
    (2, 4, 4, 32, 16, 8, [128, 97], 32),       # D = 32, four splits, full
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,page,maxp,ctxs,split", SPLIT_CASES)
def test_split_decode_matches_plain_and_jax(B, H, Hkv, D, page, maxp, ctxs,
                                            split, dtype):
    """B.3's split-KV arithmetic (`ref.paged_attention_split_ref`: float32
    partials over shares of the context, then the merge) equals the plain
    B.3 and the JAX Pallas kernel (interpret) on every lane, ctx = 0
    included (zeros), and the JAX oracle on lanes with ctx >= 1;
    tolerance 2e-4 (float32) / 2e-2 (bfloat16)."""
    rng = np.random.default_rng(sum(ctxs) + D)
    q, kp, vp, tables, _ = _mk_paged(rng, B, H, Hkv, D, page, maxp)
    ctx = np.asarray(ctxs, np.int32)
    for b in range(B):                        # last-valid padding
        w = max(-(-int(ctx[b]) // page), 1)
        tables[b, w:] = tables[b, w - 1]
    arrs = (q, kp, vp, tables, ctx)
    tdt = getattr(torch, dtype)
    got = tref.paged_attention_split_ref(*_torch(arrs, tdt), split)
    assert got.dtype == tdt and got.shape == (B, H, D)
    tol = dict(rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ops.paged_attention(
        *_torch(arrs, tdt))), **tol)
    oracle, kernel = _jax()
    np.testing.assert_allclose(_np(got), _np(kernel(*_jnp(arrs, dtype))),
                               **tol)
    real = ctx > 0
    np.testing.assert_allclose(_np(got)[real],
                               _np(oracle(*_jnp(arrs, dtype)))[real], **tol)
    assert not _np(got)[~real].any()


@pytest.mark.parametrize("B,Hkv,T,page", [
    (1, 8, 256, 16), (8, 8, 256, 16), (32, 8, 256, 16), (1, 8, 32, 16),
    (4, 32, 9, 8), (1, 1, 1, 8), (2, 8, 0, 16), (64, 8, 1024, 32)])
def test_decode_split_plan_covers_the_table(B, Hkv, T, page):
    """The wrapper's split plan: whole 32-key CTA tiles, the table covered,
    no split shorter than MIN_SPLIT unless there is one split, and about
    SPLIT_CTAS_PER_SM CTAs per SM of an H100 (132 SMs) where the table is
    long enough to give them."""
    n, split = pa.decode_split_plan(B, Hkv, T, page, 132)
    keys = T * page
    assert n >= 1 and split % pa.SPLIT_ALIGN == 0 and split > 0
    assert n * split >= keys and (n - 1) * split < max(keys, 1)
    assert n == 1 or split >= pa.MIN_SPLIT
    target = pa.SPLIT_CTAS_PER_SM * 132
    if keys >= pa.MIN_SPLIT * target:
        assert B * Hkv * n >= min(target, B * Hkv * (keys // split))


def test_entry_point_dispatch_on_the_cpu():
    """On CPU tensors the entry point takes the plain version (no launch);
    the wrapper itself refuses them, and an unknown mode raises."""
    q, kp, vp, tables, ctx = _torch(_mk_paged(np.random.default_rng(3), 2,
                                              8, 2, 64, 16, 2))
    before = pa.decode_launches
    auto = ops.paged_attention(q, kp, vp, tables, ctx)
    assert torch.equal(auto, ops.paged_attention(q, kp, vp, tables, ctx,
                                                 mode="ref"))
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(q, kp, vp, tables, ctx)
    with pytest.raises(ValueError, match="mode"):
        ops.paged_attention(q, kp, vp, tables, ctx, mode="pallas")
    assert pa.decode_launches == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _card_case(seed, B, H, Hkv, D, page, maxp):
    """Random inputs with last-valid-padded permuted tables, one full
    table, and the last lane empty (ctx 0)."""
    rng = np.random.default_rng(seed)
    q, kp, vp, tables, ctx = _mk_paged(rng, B, H, Hkv, D, page, maxp)
    ctx[0] = maxp * page
    ctx[-1] = 0
    for b in range(B):
        w = max(-(-int(ctx[b]) // page), 1)
        tables[b, w:] = tables[b, w - 1]
    return q, kp, vp, tables, ctx


# (B, H, Hkv, D, page, maxp): every head dim, page size and a G of 1 to 16
CARD_GEOMETRIES = [
    (3, 4, 4, 32, 8, 3),           # MHA at D = 32
    (4, 8, 2, 64, 16, 4),          # GQA 4:1
    (3, 8, 1, 128, 32, 2),         # MQA, G = 8
    (3, 36, 36, 64, 8, 5),         # minicpm's heads, G = 1
    (5, 32, 8, 128, 16, 9),        # llama3-8b
    (5, 32, 32, 80, 16, 9),        # zamba2-2.7b's shared attention
    (3, 16, 1, 80, 32, 3),         # G = 16
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,page,maxp", CARD_GEOMETRIES)
def test_cuda_decode_matches_plain_and_kernel1(cuda, B, H, Hkv, D, page,
                                               maxp, dtype):
    arrs = _card_case(B * 13 + D, B, H, Hkv, D, page, maxp)
    q, kp, vp, tables, ctx = [t.to(cuda) for t in
                              _torch(arrs, getattr(torch, dtype))]
    before = pa.decode_launches
    got = ops.paged_attention(q, kp, vp, tables, ctx)
    torch.cuda.synchronize()
    assert pa.decode_launches == before + 1
    assert torch.isfinite(got.float()).all()
    assert bool((got[-1] == 0).all())                   # ctx = 0: zeros
    want = tref.paged_attention_ref(q, kp, vp, tables, ctx).float()
    k1 = tref.paged_chunk_attention_ref(
        q[:, None], kp, vp, tables, (ctx - 1).clamp(min=0), ctx)[:, 0]
    if D in pa.HEAD_DIMS:                # kernel 1 on the card as well
        k1 = ops.paged_chunk_attention(q[:, None].contiguous(), kp, vp,
                                       tables, (ctx - 1).clamp(min=0), ctx
                                       )[:, 0]
    for ref_out in (want, k1.float()):
        lim = TOL[dtype] * float(ref_out[:-1].abs().max())
        err = float((got[:-1].float() - ref_out[:-1]).abs().max())
        assert err <= lim, (err, lim)


def _regime_case(seed, B, H, Hkv, D, page, T, ctxs):
    """Pools and tables where each lane's relevant pages are its own and its
    other columns repeat its last page (a ctx = 0 lane names page 0), and
    the mask of the pages no lane reads."""
    rng = np.random.default_rng(seed)
    need = [-(-c // page) for c in ctxs]
    P = sum(need) + 4
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, page, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, page, Hkv, D)).astype(np.float32)
    tables = np.zeros((B, T), np.int32)
    used = np.zeros(P, bool)
    nxt = 1
    for b, n in enumerate(need):
        if n:
            tables[b, :n] = np.arange(nxt, nxt + n)
            tables[b, n:] = nxt + n - 1
            used[nxt:nxt + n] = True
            nxt += n
    return (q, kp, vp, tables, np.asarray(ctxs, np.int32)), ~used


# (B, H, Hkv, D, page, T, ctxs): one split (a short table), a few long
# splits (many lanes), many short splits (one lane); each with a lane at
# the table's full width, one inside the first split, one just past a split
# edge and a ctx = 0 lane where there is room
SPLIT_REGIMES = [
    (3, 32, 8, 128, 16, 4, [64, 7, 0]),
    (32, 32, 8, 128, 16, 256, [4096, 30, 1377, 0] + [2048] * 28),
    (2, 32, 8, 128, 16, 256, [4096, 129]),
    (4, 16, 1, 80, 8, 40, [320, 33, 97, 0]),
    (3, 36, 36, 64, 32, 16, [512, 1, 129]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,page,T,ctxs", SPLIT_REGIMES)
def test_cuda_decode_split_regimes(cuda, B, H, Hkv, D, page, T, ctxs, dtype):
    """B.3 in every split-count regime: within tolerance of the plain
    version on the real lanes, ctx = 0 lanes exact zeros, one count per
    call; and bit for bit unchanged when every page no lane reads is NaN."""
    n_split, split = pa.decode_split_plan(
        B, Hkv, T, page,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    arrs, unused = _regime_case(B * 7 + T, B, H, Hkv, D, page, T, ctxs)
    q, kp, vp, tables, ctx = [t.to(cuda) for t in
                              _torch(arrs, getattr(torch, dtype))]
    before = pa.decode_launches
    got = pa.paged_attention(q, kp, vp, tables, ctx)
    torch.cuda.synchronize()
    assert pa.decode_launches == before + 1
    real = ctx > 0
    assert bool((got[~real] == 0).all())
    want = tref.paged_attention_ref(q, kp, vp, tables, ctx).float()
    lim = TOL[dtype] * float(want[real].abs().max())
    err = float((got[real].float() - want[real]).abs().max())
    assert err <= lim, (n_split, split, err, lim)
    mask = torch.from_numpy(unused).to(cuda)
    kp[mask] = float("nan")
    vp[mask] = float("nan")
    again = pa.paged_attention(q, kp, vp, tables, ctx)
    torch.cuda.synchronize()
    assert torch.equal(again, got), (n_split, split)


@pytest.mark.gpu
def test_cuda_decode_rejects_what_it_cannot_take(cuda):
    q, kp, vp, tables, ctx = [t.to(cuda) for t in _torch(
        _card_case(1, 2, 8, 2, 64, 8, 3))]
    with pytest.raises(TypeError):
        pa.paged_attention(q.half(), kp.half(), vp.half(), tables, ctx)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_attention(q[..., :48].contiguous(),
                           kp[..., :48].contiguous(),
                           vp[..., :48].contiguous(), tables, ctx)
    with pytest.raises(ValueError, match="kv heads"):
        pa.paged_attention(q.repeat(1, 5, 1), kp[:, :, :1].contiguous(),
                           vp[:, :, :1].contiguous(), tables, ctx)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           kp, vp, tables, ctx)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, kp, vp, tables.long(), ctx)
