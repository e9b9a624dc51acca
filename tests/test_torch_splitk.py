"""Kernel 1's and B.2's split-K partial mode (tensor-parallel serving on a
pool whose kv heads do not divide over the shards).

Shard r of n holds rows [r·pl, (r+1)·pl) of every page (pl = page / n,
1 to 32 rows); its partial attends over those rows only, at their global
positions, cut into splits of its keys, and returns float32 partials
(each split's o normalised over its keys, and their lse).  On the CPU: the
plain partial versions of every shard, and of every split of each shard's
table, merged by ``ops.merge_partials``, equal the unsharded plain
version on real rows (2e-4 in float32) — with ctx = 0 lanes, lanes that
end inside shard 0's rows, chunks that straddle pages, int8-flagged pages
and rows that no shard or split sees — and a row a shard holds no visible
key for gets o = 0, lse = -inf.  On the card (``gpu``): the kernels'
partial mode, its splits merged, against its plain version (2e-4 in
float32, 2e-2 x max|plain| in bfloat16, real rows only; lse within 1e-2),
at contexts long enough to split too; with one shard and one split its o
is the unsplit kernel's bit for bit; the merge kernel against the plain
merge on the same partials.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as tref
from test_torch_kernels import _assert_real_rows, _case, _quant, _torch

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _edge_case(seed, B, Sq, H, Hkv, D, page, maxp):
    """`_case` with lane 0 ending inside shard 0's rows of its last page
    (ctx = k·page + 1), lane 1 a chunk straddling a page edge, the last
    lane padding (ctx 0)."""
    q, kp, vp, tables, qoff, ctx = _case(seed, B, Sq, H, Hkv, D, page, maxp)
    c0 = page * (maxp - 1) + 1
    n0 = min(Sq, c0)
    qoff[0], ctx[0] = c0 - n0, c0
    if B > 2 and Sq > 1:
        c1 = page + Sq // 2                 # its chunk crosses page 0 -> 1
        qoff[1], ctx[1] = c1 - Sq, c1
    P = kp.shape[0]
    rng = np.random.default_rng(seed + 1)
    for b in (0, 1):
        w = -(-int(ctx[b]) // page)
        tables[b, :w] = rng.choice(P - 1, w, replace=False)
        tables[b, w:] = tables[b, w - 1]
    return q, kp, vp, tables, qoff, ctx


def _shards(t, n):
    pl = t.shape[1] // n
    return [t[:, r * pl:(r + 1) * pl].contiguous() for r in range(n)]


def _plain_splits(q, kp, vp, tables, qoff, ctx, r, n, cols, quant=None):
    """Shard r's plain partials cut into splits of ``cols`` table columns
    (cols x pl local keys), as the kernel cuts its keys: split j is the
    plain partial over columns [j·cols, (j+1)·cols) with the positions
    moved by j·cols·page (q_offsets and ctx_lens shifted alike), so a row
    whose horizon ends before the split sees none of its keys."""
    page_g = kp.shape[1] * n
    os_, ls = [], []
    for c0 in range(0, tables.shape[1], cols):
        shift = c0 * page_g
        o, lse = tref.paged_chunk_attention_partial_ref(
            q, kp, vp, tables[:, c0:c0 + cols].contiguous(), qoff - shift,
            ctx - shift, r, n, quant=quant)
        os_.append(o)
        ls.append(lse)
    return torch.cat(os_), torch.cat(ls)


def _merged(args, n, quant=None, mode="ref", cols=None):
    """Every shard's partials (with ``cols``, the plain splits of
    `_plain_splits`), merged by ``ops.merge_partials``."""
    q, kp, vp, tables, qoff, ctx = args
    ks, vs = _shards(kp, n), _shards(vp, n)
    qs = None if quant is None else (_shards(quant[0], n),
                                     _shards(quant[1], n))
    outs, lses = [], []
    for r in range(n):
        qt = None if quant is None else (qs[0][r], qs[1][r]) + tuple(
            quant[2:])
        if cols is None:
            o, lse = ops.paged_chunk_attention_partial(
                q, ks[r], vs[r], tables, qoff, ctx, r, n, mode=mode, quant=qt)
        else:
            o, lse = _plain_splits(q, ks[r], vs[r], tables, qoff, ctx, r, n,
                                   cols, quant=qt)
        assert o.dtype == lse.dtype == torch.float32
        assert lse.shape == o.shape[:4] and o.shape[1:] == q.shape
        outs.append(o)
        lses.append(lse)
    return (ops.merge_partials(*C.gather_partials(outs, lses), q.dtype,
                               mode=mode), outs, lses)


CASES = [
    # B, Sq, H, Hkv, D, page, maxp, n_shards, table columns a split
    (4, 8, 4, 2, 16, 8, 4, 4, None),    # the CPU serving tests' split-K rung
    (4, 6, 8, 1, 32, 16, 5, 8, None),   # 2-row shard pages, MQA
    (3, 1, 32, 4, 64, 16, 6, 8, None),  # yi-6b-like decode at tp 8
    (4, 9, 6, 2, 32, 32, 3, 2, None),   # 16-row shard pages, G = 3
    (3, 5, 4, 4, 16, 8, 4, 1, None),    # no split: the kernel itself
    (4, 6, 8, 2, 32, 8, 5, 8, None),    # 1-row shard pages (page 8, tp 8)
    (3, 1, 32, 4, 64, 8, 6, 8, None),   # 1-row pages, decode
    (3, 7, 8, 2, 32, 16, 4, 16, None),  # 1-row pages of page 16, tp 16
    (4, 1, 16, 2, 32, 16, 5, 16, None),  # 1-row pages of page 16, decode
    # shards x splits: each shard's table cut into splits of 2 or 3
    # columns; rows whose horizon ends before a split see none of it
    (4, 9, 8, 2, 32, 8, 7, 8, 2),       # 1-row pages, chunks
    (3, 1, 32, 4, 64, 16, 8, 8, 3),     # 2-row pages, decode
    (4, 6, 6, 2, 32, 32, 5, 2, 2),      # 16-row pages, G = 3
]


@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,maxp,n,cols", CASES)
def test_plain_partials_merge_to_the_unsharded_plain(B, Sq, H, Hkv, D, page,
                                                    maxp, n, cols, quant):
    arrs = _edge_case(B * 31 + n, B, Sq, H, Hkv, D, page, maxp)
    args = _torch(arrs, torch.float32)
    qt = _quant(arrs[1], arrs[2], seed=n) if quant else None
    want = tref.paged_chunk_attention_ref(*args, quant=qt)
    got, outs, lses = _merged(args, n, quant=qt, cols=cols)
    _assert_real_rows(got, want, arrs[4], arrs[5], 2e-4)
    ctx, qoff = arrs[5], arrs[4]
    for b in range(B):                  # padding rows: zeros, lse -inf
        real = int(ctx[b] - qoff[b]) if ctx[b] else 0
        assert bool((got[b, real:] == 0).all())
        for o, lse in zip(outs, lses):
            assert bool((o[:, b, real:] == 0).all())
            assert bool(torch.isneginf(lse[:, b, real:]).all())
    if cols is not None:                # some split saw nothing of a row
        assert any(bool(torch.isneginf(lse[:, b, :1]).any())
                   for lse in lses for b in range(B) if ctx[b])


def test_a_shard_without_visible_keys_gives_zeros_and_neg_inf():
    """Lane 0's context is one key (in shard 0's rows): the other shards
    see nothing for it; the merged row is shard 0's."""
    B, Sq, H, Hkv, D, page, maxp, n = 2, 1, 4, 2, 16, 8, 2, 4
    arrs = list(_case(5, B, Sq, H, Hkv, D, page, maxp, pad_lane=False,
                      decode=True))
    arrs[4][0], arrs[5][0] = 0, 1
    args = _torch(arrs, torch.float32)
    got, outs, lses = _merged(args, n)
    for r in range(1, n):
        assert bool(torch.isneginf(lses[r][0, 0]).all())
        assert bool((outs[r][0, 0] == 0).all())
    assert bool(torch.isfinite(lses[0][0, 0]).all())
    # one key: the softmax is 1 on it, so the output is that key's value
    v0 = args[2][int(args[3][0, 0]), 0]                      # (Hkv, D)
    np.testing.assert_allclose(
        got[0, 0].numpy(), v0.repeat_interleave(H // Hkv, 0).numpy(),
        atol=1e-6)


def test_partial_lse_is_the_log_sum_exp_of_visible_scores():
    """With one shard, o is the unsharded attention and lse the natural
    log-sum-exp of q.k / sqrt(D) over the visible keys."""
    B, Sq, H, Hkv, D, page, maxp = 3, 4, 4, 2, 16, 8, 3
    arrs = _case(9, B, Sq, H, Hkv, D, page, maxp)
    args = _torch(arrs, torch.float32)
    o, lse = ops.paged_chunk_attention_partial(*args, 0, 1)
    assert o.shape[0] == lse.shape[0] == 1      # the plain version: 1 split
    o, lse = o[0], lse[0]
    want = tref.paged_chunk_attention_ref(*args)
    _assert_real_rows(o, want, arrs[4], arrs[5], 1e-6)
    q, kp = args[0], args[1]
    b, i, h = 0, int(arrs[5][0] - arrs[4][0]) - 1, 3
    pos = int(arrs[4][0]) + i
    keys = kp[args[3][b].long()].reshape(-1, Hkv, D)[:pos + 1, h // 2]
    s = keys @ q[b, i, h] / np.sqrt(D)
    np.testing.assert_allclose(float(lse[b, i, h]),
                               float(torch.logsumexp(s, 0)), rtol=1e-6)


def test_partial_dispatch_follows_the_tensor_device():
    """CPU tensors take the plain partial (no launch counted); the kernel
    wrapper refuses them, and ops refuses an unknown mode."""
    arrs = _case(3, 2, 2, 4, 2, 16, 8, 2)
    args = _torch(arrs, torch.float32)
    before = (pa.partial_launches, pa.quant_partial_launches,
              pa.merge_launches)
    ks = _shards(args[1], 4)
    vs = _shards(args[2], 4)
    o, lse = ops.paged_chunk_attention_partial(args[0], ks[1], vs[1],
                                               *args[3:], 1, 4)
    assert o.device.type == "cpu"
    ws, slots = ops.partial_workspace(args[0], ks[1], args[3],
                                      [args[0].device] * 4)
    assert ws[0].shape[0] == 4 and slots[1][0].shape == o.shape
    m = ops.merge_partials(o, lse, torch.float32)
    assert m.shape == args[0].shape
    assert (pa.partial_launches, pa.quant_partial_launches,
            pa.merge_launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_chunk_attention_partial(args[0], ks[1], vs[1], *args[3:],
                                         1, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.merge_partials(o, lse, torch.float32)
    with pytest.raises(ValueError, match="kernel mode"):
        ops.paged_chunk_attention_partial(args[0], ks[1], vs[1], *args[3:],
                                          1, 4, mode="fast")


@pytest.mark.parametrize("B,Sq,T,pl,dtype,want", [
    (4, 1, 128, 2, torch.bfloat16, 4),      # yi-6b decode at tp 8, page 16
    (1, 1, 512, 1, torch.float32, 8),       # 1-row pages, float32 body
    (2, 24, 64, 2, torch.bfloat16, 2),      # a short chunk
    (4, 512, 256, 2, torch.bfloat16, 1),    # a 512-token chunk fills the card
    (1, 1, 8192, 1, torch.bfloat16, 128),   # a long table: at most 128
])
def test_partial_split_plan(B, Sq, T, pl, dtype, want):
    """A shard's keys (T x pl) are cut like B.3's decode splits when its
    grid (B x Hkv x query tiles, yi-6b's 32 / 4 heads) is short of the 132
    SMs, into whole 64-key stages that cover them; a grid that fills the
    card keeps one split."""
    n, split = pa.partial_split_plan(B, Sq, 32, 4, T, pl, dtype, 132)
    assert n == want and split % pa.PARTIAL_SPLIT_ALIGN == 0
    assert n * split >= T * pl and (n - 1) * split < T * pl


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    yield torch.device("cuda")


CARD_CASES = [
    # B, Sq, H, Hkv, D, page, maxp, n_shards
    (5, 1, 32, 4, 128, 16, 9, 8),       # yi-6b decode at tp 8: 2-row pages
    (3, 37, 32, 4, 128, 16, 6, 8),      # yi-6b chunk at tp 8
    (3, 150, 32, 4, 128, 16, 14, 8),    # a chunk of several query tiles
    (4, 9, 8, 2, 64, 8, 6, 4),          # page 8 at tp 4
    (3, 40, 32, 8, 128, 32, 5, 4),      # 8-row shard pages
    (3, 37, 32, 2, 128, 16, 6, 2),      # 8-row shard pages of page 16
    (3, 9, 32, 4, 96, 16, 6, 8),        # D = 96
    (3, 9, 32, 4, 80, 16, 6, 8),        # D = 80
    (5, 1, 32, 4, 128, 8, 17, 8),       # yi-6b decode at tp 8, page 8: 1 row
    (3, 37, 32, 4, 128, 8, 12, 8),      # 1-row pages, a chunk
    (4, 1, 16, 2, 64, 16, 9, 16),       # page 16 at tp 16: 1 row, decode
    (3, 21, 16, 2, 64, 16, 7, 16),      # page 16 at tp 16: 1 row, chunks
]


def _card_args(cuda, arrs, dtype, quant, n):
    args = [t.to(cuda) for t in _torch(arrs, getattr(torch, dtype))]
    qt = None
    if quant:
        qt = tuple(t.to(cuda) for t in _quant(arrs[1], arrs[2], seed=n))
    return args, qt


def _shard_args(args, qt, r, n):
    ks, vs = _shards(args[1], n)[r], _shards(args[2], n)[r]
    qr = None if qt is None else (_shards(qt[0], n)[r],
                                  _shards(qt[1], n)[r]) + qt[2:]
    return ks, vs, qr


def _assert_partial(o, lse, wo, wl, arrs, dtype):
    """A shard's partials (its splits merged) against its plain version:
    real rows within TOL x max|plain|, padding rows zeros, the same rows
    without a key, lse within 1e-4 relative and min(TOL, 1e-2)
    absolute."""
    o, lse = tref.combine_partials(o, lse)
    wo, wl = wo[0], wl[0]
    scale = max(float(wo.abs().max()), 1.0)
    _assert_real_rows(o.cpu(), wo.cpu(), arrs[4], arrs[5], TOL[dtype] * scale)
    for b in range(o.shape[0]):
        real = int(arrs[5][b] - arrs[4][b]) if arrs[5][b] else 0
        assert bool((o[b, real:] == 0).all()), "padding rows not zeros"
    ok = torch.isfinite(wl)
    assert torch.equal(ok, torch.isfinite(lse)), "empty rows differ"
    np.testing.assert_allclose(lse[ok].cpu().numpy(), wl[ok].cpu().numpy(),
                               rtol=1e-4, atol=min(TOL[dtype], 1e-2))


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,maxp,n", CARD_CASES)
def test_cuda_partial_matches_plain(cuda, B, Sq, H, Hkv, D, page, maxp, n,
                                    dtype, quant):
    arrs = _edge_case(B * 13 + Sq, B, Sq, H, Hkv, D, page, maxp)
    args, qt = _card_args(cuda, arrs, dtype, quant, n)
    counter = "quant_partial_launches" if quant else "partial_launches"
    for r in (0, n // 2, n - 1):
        ks, vs, qr = _shard_args(args, qt, r, n)
        before = getattr(pa, counter)
        o, lse = ops.paged_chunk_attention_partial(
            args[0], ks, vs, *args[3:], r, n, quant=qr)
        torch.cuda.synchronize()
        assert getattr(pa, counter) == before + 1
        assert o.shape[0] * n == ops.partial_workspace(
            args[0], ks, args[3], [cuda] * n)[0][0].shape[0]
        wo, wl = tref.paged_chunk_attention_partial_ref(
            args[0], ks, vs, *args[3:], r, n, quant=qr)
        _assert_partial(o, lse, wo, wl, arrs, dtype)


SPLIT_CASES = [
    # B, Sq, H, Hkv, D, page, maxp, n_shards: contexts of 512 to 2048
    # keys on grids short of the card, so that each shard's keys split
    (4, 1, 32, 4, 128, 8, 256, 8),      # yi-6b decode, 1-row pages
    (4, 1, 32, 4, 128, 16, 96, 8),      # yi-6b decode, 2-row pages
    (2, 24, 32, 4, 128, 16, 64, 8),     # a short chunk
    (3, 5, 16, 2, 64, 16, 128, 16),     # 1-row pages of page 16
]


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,maxp,n", SPLIT_CASES)
def test_cuda_split_partial_matches_plain(cuda, B, Sq, H, Hkv, D, page, maxp,
                                          n, dtype, quant):
    """Long contexts: each shard's partial is cut into several splits,
    and its merged splits match its plain partial; every shard's splits
    merged by the merge kernel match the unsharded plain version."""
    arrs = _edge_case(B * 7 + maxp, B, Sq, H, Hkv, D, page, maxp)
    args, qt = _card_args(cuda, arrs, dtype, quant, n)
    outs, lses = [], []
    for r in range(n):
        ks, vs, qr = _shard_args(args, qt, r, n)
        o, lse = ops.paged_chunk_attention_partial(
            args[0], ks, vs, *args[3:], r, n, quant=qr)
        assert o.shape[0] > 1, "the shard's keys did not split"
        wo, wl = tref.paged_chunk_attention_partial_ref(
            args[0], ks, vs, *args[3:], r, n, quant=qr)
        _assert_partial(o, lse, wo, wl, arrs, dtype)
        outs.append(o)
        lses.append(lse)
    before = pa.merge_launches
    got = ops.merge_partials(*C.gather_partials(outs, lses), args[0].dtype)
    torch.cuda.synchronize()
    assert pa.merge_launches == before + 1
    want = tref.paged_chunk_attention_ref(*args, quant=qt).float()
    scale = max(float(want.abs().max()), 1.0)
    _assert_real_rows(got.float().cpu(), want.cpu(), arrs[4], arrs[5],
                      TOL[dtype] * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,B,Sq,H,D", [(32, 4, 1, 32, 128), (8, 2, 70, 8, 64),
                                        (24, 3, 5, 32, 96),
                                        (16, 2, 9, 32, 80)])
def test_cuda_merge_matches_plain(cuda, N, B, Sq, H, D, dtype):
    """The merge kernel against the plain merge on the same float32
    partials, with partials and whole rows that saw no key (lse -inf, o
    zeros): 1e-5 x max|plain| in float32 (only the order of the float32
    sums differs), one bf16 rounding in bfloat16; the rows no partial saw
    exactly zero."""
    rng = np.random.default_rng(N * 100 + Sq)
    o = torch.from_numpy(rng.normal(size=(N, B, Sq, H, D)).astype(np.float32))
    lse = torch.from_numpy((3 * rng.normal(size=(N, B, Sq, H)))
                           .astype(np.float32))
    empty = torch.from_numpy(rng.random((N, B, Sq, H)) < 0.3)
    empty[:, 0, 0, :2] = True                # rows no partial saw
    lse[empty] = -torch.inf
    o[empty] = 0.0
    o, lse = o.to(cuda), lse.to(cuda)
    dt = getattr(torch, dtype)
    want = tref.merge_partials_ref(o, lse, dt).float()
    before = pa.merge_launches
    got = ops.merge_partials(o, lse, dt)
    torch.cuda.synchronize()
    assert pa.merge_launches == before + 1 and got.dtype == dt
    assert bool((got[0, 0, :2] == 0).all())
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.float().cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=tol * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_one_shard_is_the_unsplit_kernel(cuda, dtype):
    """n_shards = 1 on a chunk whose grid fills the card (one split): the
    partial mode's float32 o, rounded to q's dtype, is kernel 1's, bit for
    bit."""
    arrs = _case(21, 3, 150, 32, 8, 128, 16, 12)
    args = [t.to(cuda) for t in _torch(arrs, getattr(torch, dtype))]
    want = ops.paged_chunk_attention(*args)
    o, _ = ops.paged_chunk_attention_partial(*args, 0, 1)
    torch.cuda.synchronize()
    assert o.shape[0] == 1
    assert torch.equal(o[0].to(want.dtype), want)


@pytest.mark.gpu
def test_cuda_partial_rejects_what_it_cannot_take(cuda):
    arrs = _case(2, 2, 4, 8, 2, 64, 16, 3)
    args = [t.to(cuda) for t in _torch(arrs, torch.bfloat16)]
    with pytest.raises(ValueError, match="shard 4 not in"):
        pa.paged_chunk_attention_partial(args[0], args[1][:, :4].contiguous(),
                                         args[2][:, :4].contiguous(),
                                         *args[3:], 4, 4)
    with pytest.raises(ValueError, match="pages of 1 x 65537 rows"):
        pa.paged_chunk_attention_partial(args[0], args[1][:, :1].contiguous(),
                                         args[2][:, :1].contiguous(),
                                         *args[3:], 0, 2 ** 16 + 1)
    q48 = args[0][..., :48].contiguous()
    with pytest.raises(ValueError, match="head dim 48 not in"):
        pa.paged_chunk_attention_partial(q48, args[1][:, :2, :, :48]
                                         .contiguous(),
                                         args[2][:, :2, :, :48].contiguous(),
                                         *args[3:], 0, 8)
