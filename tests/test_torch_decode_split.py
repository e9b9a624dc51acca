"""Kernel 1 and B.2 on a small grid: each lane's keys split over a cluster.

When the unsplit grid of kernel 1 (``paged_chunk_attention``) or B.2
(``paged_chunk_attention_quant``) holds fewer CTAs than the card has SMs
(decode, short chunks of few lanes), ``paged_attention.chunk_split_plan``
cuts each (query tile, kv head, lane)'s keys into whole 64-key stages over
the CTAs of one thread-block cluster, which the kernel merges over
distributed shared memory in the same launch.

On the CPU: the plan covers the table once in whole stages, stays within
the portable cluster size, keeps one split where the grid fills the card
(and for float32), and the three wrappers (kernel 1, B.2 and their
head-feature route) pass the same plan for the same call.  On the card
(``gpu``): kernel 1 and B.2 against their plain versions at split shapes
(B 1, 2, 8; ctx 0 to 4096, some not a multiple of the page; pages of 8 and
16; D 64, 80, 96, 128; G 1, 3, 4, 8; a short chunk with bucket padding),
B.2 with every flag clear bit-identical to kernel 1 there, and the
head-feature route bit-equal to kernel 1 / B.2 on the concatenated pools
at a decode shape that splits.  This module does not import JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as tref

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


# ---------------------------------------------------------------------------
# the plan, on the CPU
# ---------------------------------------------------------------------------

def _recorded_plans(monkeypatch, B, Sq, H, Hkv, T, page, n_sm):
    """The (split, n_split) that kernel 1's, B.2's and the head-feature
    route's wrappers pass to their launch functions for one bf16 call,
    recorded through a stand-in for the library (CPU tensors: nothing is
    launched)."""
    calls = {}

    def entry(symbol, n_ptrs, n_ints=10, lib=pa.NAME):
        def fn(*args):
            calls[symbol] = args
            return 0
        return fn
    monkeypatch.setattr(pa, "_entry", entry)
    monkeypatch.setattr(pa, "_sm_count", lambda dev: n_sm)
    monkeypatch.setattr(pa, "_stream", lambda dev: 0)
    monkeypatch.setattr(pa, "_check", lambda *a, **k: None)
    monkeypatch.setattr(pa, "_check_quant", lambda *a, **k: None)
    D, dr, P = 64, 8, 4
    bf = torch.bfloat16
    q = torch.zeros((B, Sq, H, D), dtype=bf)
    kp = torch.zeros((P, page, Hkv, D), dtype=bf)
    tables = torch.zeros((B, T), dtype=torch.int32)
    lanes = torch.zeros((B,), dtype=torch.int32)
    quant = (torch.zeros(kp.shape, dtype=torch.int8),) * 2 + \
        (torch.ones(P), torch.ones(P), torch.zeros(P, dtype=torch.int32))
    pa.paged_chunk_attention(q, kp, kp, tables, lanes, lanes)
    pa.paged_chunk_attention_quant(q, kp, kp, *quant, tables, lanes, lanes)
    shards = [torch.zeros((P, page, Hkv, dr), dtype=bf)] * (D // dr)
    pa.paged_chunk_attention_features(q, shards, shards, tables, lanes,
                                      lanes, producer="gather")
    # the ints before (dtype, device) and the stream: ..., split, n_split
    return {s: tuple(a[-5:-3]) for s, a in calls.items()}


# B, Sq, H, Hkv, T (table width), page, SMs, the splits expected
PLAN_CASES = [
    (1, 1, 32, 8, 256, 16, 132, 8),     # llama3-8b decode, one lane: 8 CTAs
    (8, 1, 32, 8, 256, 16, 132, 4),     # 64 CTAs: 4 in a wave of 264
    (32, 1, 32, 8, 256, 16, 132, 1),    # 256 CTAs fill the card
    (1, 512, 32, 8, 32, 16, 132, 1),    # a long chunk of one lane: 256 CTAs
    (2, 40, 32, 8, 64, 16, 132, 1),     # a short chunk of two lanes: 48
                                        # CTAs, 1024 keys: 2 splits, too few
    (2, 1, 24, 8, 3, 8, 132, 1),        # 24 keys: one stage
    (1, 1, 32, 32, 32, 16, 132, 1),     # 32 heads' 512 keys: too short
    (1, 1, 32, 8, 64, 16, 132, 1),      # 1024 keys: two splits, too few
    (4, 1, 32, 32, 256, 16, 132, 1),    # 128 CTAs: a wave holds two splits
    (2, 1, 32, 32, 128, 16, 132, 4),    # 64 CTAs: four splits of 512 keys
    (3, 1, 8, 1, 256, 8, 78, 4),        # another card's SM count, G 8
]


@pytest.mark.parametrize("B,Sq,H,Hkv,T,page,n_sm,want", [
    pytest.param(*c, id="-".join(map(str, c[:-1]))) for c in PLAN_CASES])
def test_chunk_split_plan(monkeypatch, B, Sq, H, Hkv, T, page, n_sm, want):
    """The splits expected; whole 64-key stages covering the table, every
    split starting inside it; at most the portable cluster size; where it
    splits, at least CHUNK_MIN_SPLITS splits of at least CHUNK_MIN_SPLIT
    keys within one wave of two CTAs an SM, on a grid short of the card;
    one split for float32; and the same plan from kernel 1's, B.2's and
    the head-feature route's wrappers."""
    n, split = pa.chunk_split_plan(B, Sq, H, Hkv, T, page, torch.bfloat16,
                                   n_sm)
    assert n == want
    keys = T * page
    assert split >= 64 and split % 64 == 0
    assert n * split >= keys and (n - 1) * split < keys
    assert 1 <= n <= pa.CHUNK_MAX_SPLITS <= 8
    base = -(-Sq // (64 // (H // Hkv))) * Hkv * B   # CTAs without a split
    if n > 1:
        assert base < n_sm and n * base <= 2 * n_sm
        assert n >= pa.CHUNK_MIN_SPLITS and split >= pa.CHUNK_MIN_SPLIT
    assert pa.chunk_split_plan(B, Sq, H, Hkv, T, page, torch.float32,
                               n_sm) == (1, -(-keys // 64) * 64)
    got = _recorded_plans(monkeypatch, B, Sq, H, Hkv, T, page, n_sm)
    assert set(got.values()) == {(split, n)}, got
    assert len(got) == 3


def test_cluster_cap_is_the_plans():
    """The kernel's cluster cap (kMaxCluster in its source) is the plan's
    CHUNK_MAX_SPLITS, the portable cluster size."""
    import re
    from pathlib import Path
    src = (Path(pa.__file__).resolve().parents[1] / "csrc" /
           "paged_chunk_attention.cu").read_text()
    cap = re.findall(r"constexpr int kMaxCluster = (\d+);", src)
    assert cap == [str(pa.CHUNK_MAX_SPLITS)] and pa.CHUNK_MAX_SPLITS == 8


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    yield torch.device("cuda")


# B, Sq, H, Hkv, D, page, T (table width), ctxs, chunk lengths (None: decode)
SPLIT_CASES = [
    (1, 1, 32, 8, 128, 16, 256, [4096], None),       # llama3-8b, one lane
    (1, 1, 32, 8, 128, 16, 256, [1000], None),       # most splits past ctx
    (2, 1, 24, 8, 64, 8, 256, [511, 0], None),       # G 3, a ctx = 0 lane
    (8, 1, 64, 8, 96, 16, 128, [2048, 1, 17, 0, 333, 1024, 2047, 5],
     None),                                          # G 8, D 96
    (2, 1, 8, 8, 80, 16, 128, [1024, 63], None),     # G 1, D 80
    (8, 1, 4, 4, 128, 8, 512, [4096, 4095, 3000, 64, 65, 1, 0, 2500],
     None),                                          # G 1, pages of 8
    (1, 1, 8, 1, 64, 8, 512, [4096], None),          # G 8, one kv head
    (2, 40, 32, 8, 128, 16, 128, [700, 300], [40, 13]),  # a chunk, padding
]


def _split_case(seed, B, Sq, H, Hkv, D, page, T, ctxs, q_lens, dev):
    """bf16 q and pools drawn from ``seed`` with numpy; lane b holds
    ctxs[b] keys on permuted pages (its table row padded with its last
    page id), its last q_lens[b] (decode: 1) tokens the chunk."""
    rng = np.random.default_rng(seed)
    need = [-(-c // page) for c in ctxs]
    P = sum(need) + 4
    q = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), dtype=np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), dtype=np.float32)
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
        qoff[b] = c - (1 if q_lens is None else q_lens[b])
    bf = lambda a: torch.from_numpy(a).to(dev, torch.bfloat16)  # noqa: E731
    it = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (bf(q), bf(kp), bf(vp), it(tables), it(qoff),
            it(np.asarray(ctxs, np.int32)))


def _int8(kp, vp, tables, ctx, share, seed):
    """The int8 shadows of kp / vp, their scales, and flags on about
    ``share`` of every lane's relevant pages."""
    from repro_torch.kernels.quant import quantize_int8
    kq, ks = quantize_int8(kp, axis=(1, 2, 3))
    vq, vs = quantize_int8(vp, axis=(1, 2, 3))
    rng = np.random.default_rng(seed)
    flags = torch.from_numpy((rng.random(kp.shape[0]) < share)
                             .astype(np.int32)).to(kp.device)
    return kq, vq, ks, vs, flags


def _held(got, want, qoff, ctx, what):
    """got within TOL x max|plain| of want on every lane's real rows; its
    padding rows and ctx = 0 lanes exactly zero."""
    err, scale = 0.0, 0.0
    for b in range(got.shape[0]):
        n = max(int(ctx[b]) - int(qoff[b]), 0) if int(ctx[b]) else 0
        assert bool((got[b, n:] == 0).all()), f"{what}: lane {b} padding"
        if n:
            err = max(err, float((got[b, :n].float() - want[b, :n].float())
                                 .abs().max()))
            scale = max(scale, float(want[b, :n].float().abs().max()))
    assert err <= TOL[torch.bfloat16] * scale, (what, err, scale)


def _splits(args):
    q, kp, _, tab = args[:4]
    B, Sq, H, _ = q.shape
    return pa.chunk_split_plan(B, Sq, H, kp.shape[2], tab.shape[1],
                               kp.shape[1], q.dtype,
                               pa._sm_count(q.get_device()))[0]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,T,ctxs,q_lens", SPLIT_CASES)
def test_cuda_split_kernel_matches_plain(cuda, B, Sq, H, Hkv, D, page, T,
                                         ctxs, q_lens):
    """Kernel 1 at a split shape against its plain version, one launch
    counted."""
    args = _split_case(B + 3 * D + T, B, Sq, H, Hkv, D, page, T, ctxs,
                       q_lens, cuda)
    assert _splits(args) > 1
    before = pa.launches
    got = ops.paged_chunk_attention(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    assert torch.isfinite(got.float()).all()
    _held(got, tref.paged_chunk_attention_ref(*args), args[4].cpu(),
          args[5].cpu(), "kernel 1")


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,T,ctxs,q_lens", SPLIT_CASES)
def test_cuda_split_quant_kernel(cuda, B, Sq, H, Hkv, D, page, T, ctxs,
                                 q_lens):
    """B.2 at a split shape: with every flag clear bit-identical to kernel
    1 (the same plan), with about half the pages flagged against its plain
    version, one launch counted each."""
    args = _split_case(B + 5 * D + T, B, Sq, H, Hkv, D, page, T, ctxs,
                       q_lens, cuda)
    q, kp, vp, tab, qoff, ctx = args
    quant = _int8(kp, vp, tab, ctx, 0.5, B + D)
    clear = quant[:4] + (torch.zeros_like(quant[4]),)
    before = pa.quant_launches
    got_clear = ops.paged_chunk_attention(*args, quant=clear)
    got = ops.paged_chunk_attention(*args, quant=quant)
    torch.cuda.synchronize()
    assert pa.quant_launches == before + 2
    assert torch.equal(got_clear, ops.paged_chunk_attention(*args))
    assert torch.isfinite(got.float()).all()
    _held(got, tref.paged_chunk_attention_ref(*args, quant=quant),
          qoff.cpu(), ctx.cpu(), "B.2")


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
def test_cuda_split_features_are_the_kernel(cuda, quant):
    """The head-feature route (16 shards of 8 features, one allocation,
    read by TMA) at a decode shape that splits: bit-equal to kernel 1 /
    B.2 on the concatenated pools, since it takes the same plan."""
    args = _split_case(61, 2, 1, 32, 8, 128, 8, 256, [2048, 700], None,
                       cuda)
    q, kp, vp, tab, qoff, ctx = args
    assert _splits(args) > 1
    n, dr = 16, 8

    def cut(t):
        return list(torch.stack([t[..., r * dr:(r + 1) * dr]
                                 for r in range(n)]))
    qt = sqt = None
    if quant:
        qt = _int8(kp, vp, tab, ctx, 0.5, 7)
        sqt = (cut(qt[0]), cut(qt[1]), *qt[2:])
    got = pa.paged_chunk_attention_features(q, cut(kp), cut(vp), tab, qoff,
                                            ctx, quant=sqt, producer="tma")
    want = ops.paged_chunk_attention(*args, quant=qt) if quant else \
        ops.paged_chunk_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
