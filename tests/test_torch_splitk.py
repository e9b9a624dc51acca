"""Kernel 1's and B.2's split-K partial mode (tensor-parallel serving on a
pool whose kv heads do not divide over the shards).

Shard r of n holds rows [r·pl, (r+1)·pl) of every page (pl = page / n);
its partial attends over those rows only, at their global positions, and
returns (o normalised over its keys, lse).  On the CPU: the plain partial
versions of every shard, merged by ``collectives.merge_partials``, equal
the unsharded plain version on real rows (2e-4 in float32) — with ctx = 0
lanes, lanes that end inside shard 0's rows, chunks that straddle pages
and int8-flagged pages — and a row a shard holds no visible key for gets
o = 0, lse = -inf.  On the card (``gpu``): the kernels' partial mode
against its plain version (2e-4 in float32, 2e-2 x max|plain| in
bfloat16, real rows only), with one shard bit for bit the unsplit kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed.collectives import merge_partials
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


def _merged(args, n, quant=None, mode="ref"):
    q, kp, vp, tables, qoff, ctx = args
    ks, vs = _shards(kp, n), _shards(vp, n)
    qs = None if quant is None else (_shards(quant[0], n),
                                     _shards(quant[1], n))
    outs, lses = [], []
    for r in range(n):
        qt = None if quant is None else (qs[0][r], qs[1][r]) + tuple(
            quant[2:])
        o, lse = ops.paged_chunk_attention_partial(
            q, ks[r], vs[r], tables, qoff, ctx, r, n, mode=mode, quant=qt)
        assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
        outs.append(o)
        lses.append(lse)
    return merge_partials(outs, lses), outs, lses


CASES = [
    # B, Sq, H, Hkv, D, page, maxp, n_shards
    (4, 8, 4, 2, 16, 8, 4, 4),          # the CPU serving tests' split-K rung
    (4, 6, 8, 1, 32, 16, 5, 8),         # 2-row shard pages, MQA
    (3, 1, 32, 4, 64, 16, 6, 8),        # yi-6b-like decode at tp 8
    (4, 9, 6, 2, 32, 32, 3, 2),         # 16-row shard pages, G = 3
    (3, 5, 4, 4, 16, 8, 4, 1),          # no split: the kernel itself
]


@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,maxp,n", CASES)
def test_plain_partials_merge_to_the_unsharded_plain(B, Sq, H, Hkv, D, page,
                                                    maxp, n, quant):
    arrs = _edge_case(B * 31 + n, B, Sq, H, Hkv, D, page, maxp)
    args = _torch(arrs, torch.float32)
    qt = _quant(arrs[1], arrs[2], seed=n) if quant else None
    want = tref.paged_chunk_attention_ref(*args, quant=qt)
    got, outs, lses = _merged(args, n, quant=qt)
    _assert_real_rows(got, want, arrs[4], arrs[5], 2e-4)
    ctx, qoff = arrs[5], arrs[4]
    for b in range(B):                  # padding rows: zeros, lse -inf
        real = int(ctx[b] - qoff[b]) if ctx[b] else 0
        for o, lse in zip(outs, lses):
            assert bool((o[b, real:] == 0).all())
            assert bool(torch.isneginf(lse[b, real:]).all())


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
        assert bool(torch.isneginf(lses[r][0]).all())
        assert bool((outs[r][0] == 0).all())
    assert bool(torch.isfinite(lses[0][0]).all())
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
    before = (pa.partial_launches, pa.quant_partial_launches)
    ks = _shards(args[1], 4)
    vs = _shards(args[2], 4)
    o, lse = ops.paged_chunk_attention_partial(args[0], ks[1], vs[1],
                                               *args[3:], 1, 4)
    assert o.device.type == "cpu"
    assert (pa.partial_launches, pa.quant_partial_launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_chunk_attention_partial(args[0], ks[1], vs[1], *args[3:],
                                         1, 4)
    with pytest.raises(ValueError, match="kernel mode"):
        ops.paged_chunk_attention_partial(args[0], ks[1], vs[1], *args[3:],
                                          1, 4, mode="fast")


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
]


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,maxp,n", CARD_CASES)
def test_cuda_partial_matches_plain(cuda, B, Sq, H, Hkv, D, page, maxp, n,
                                    dtype, quant):
    arrs = _edge_case(B * 13 + Sq, B, Sq, H, Hkv, D, page, maxp)
    dt = getattr(torch, dtype)
    args = [t.to(cuda) for t in _torch(arrs, dt)]
    qt = None
    if quant:
        qt = tuple(t.to(cuda) for t in _quant(arrs[1], arrs[2], seed=n))
    counter = "quant_partial_launches" if quant else "partial_launches"
    for r in (0, n // 2, n - 1):
        ks, vs = _shards(args[1], n)[r], _shards(args[2], n)[r]
        qr = None if qt is None else (_shards(qt[0], n)[r],
                                      _shards(qt[1], n)[r]) + qt[2:]
        before = getattr(pa, counter)
        o, lse = ops.paged_chunk_attention_partial(
            args[0], ks, vs, *args[3:], r, n, quant=qr)
        torch.cuda.synchronize()
        assert getattr(pa, counter) == before + 1
        wo, wl = tref.paged_chunk_attention_partial_ref(
            args[0], ks, vs, *args[3:], r, n, quant=qr)
        scale = max(float(wo.float().abs().max()), 1.0)
        _assert_real_rows(o.float().cpu(), wo.float().cpu(), arrs[4],
                          arrs[5], TOL[dtype] * scale)
        ok = torch.isfinite(wl)
        assert torch.equal(ok, torch.isfinite(lse)), "empty rows differ"
        np.testing.assert_allclose(lse[ok].cpu().numpy(),
                                   wl[ok].cpu().numpy(), rtol=1e-4,
                                   atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_one_shard_is_the_unsplit_kernel(cuda, dtype):
    """n_shards = 1: the partial mode's o is kernel 1's, bit for bit."""
    arrs = _case(21, 3, 37, 32, 8, 128, 16, 6)
    args = [t.to(cuda) for t in _torch(arrs, getattr(torch, dtype))]
    want = ops.paged_chunk_attention(*args)
    o, _ = ops.paged_chunk_attention_partial(*args, 0, 1)
    torch.cuda.synchronize()
    assert torch.equal(o, want)


@pytest.mark.gpu
def test_cuda_partial_rejects_what_it_cannot_take(cuda):
    arrs = _case(2, 2, 4, 8, 2, 64, 16, 3)
    args = [t.to(cuda) for t in _torch(arrs, torch.bfloat16)]
    with pytest.raises(ValueError, match="shard 4 not in"):
        pa.paged_chunk_attention_partial(args[0], args[1][:, :4].contiguous(),
                                         args[2][:, :4].contiguous(),
                                         *args[3:], 4, 4)
    with pytest.raises(ValueError, match="page size 1"):
        pa.paged_chunk_attention_partial(args[0], args[1][:, :1].contiguous(),
                                         args[2][:, :1].contiguous(),
                                         *args[3:], 0, 16)
