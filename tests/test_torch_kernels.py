"""The port's paged chunk attention against the JAX package.

The same numpy inputs go through the JAX oracle
(``repro.kernels.ref.paged_chunk_attention_ref``), the Pallas kernel in
interpret mode, and the port's plain version, which is what the port runs
for CPU tensors.  Tolerances are tests/test_kernels.py's: 2e-4 in float32
and 2e-2 in bfloat16, compared on each lane's real query rows (padded rows
are garbage by contract); ctx = 0 lanes must be exactly zero.

The int8 kernel (``paged_chunk_attention_quant``) gets the same treatment
through ``ops.paged_chunk_attention(..., quant=...)``: its plain version is
the quant tuple of ``kernels.ref`` (held to JAX in tests/test_torch_quant.py).

The ``gpu`` tests hold the hand-written CUDA kernels against the plain
versions on the card, and the int8 kernel with every flag clear bit-exact
against the fp kernel; they skip where there is no card.  The machine with
the card has no JAX, so this module imports JAX only inside the CPU tests
(``python -m pytest -m gpu`` deselects them there).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as tref
from repro_torch.kernels.quant import quantize_int8

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@functools.lru_cache(maxsize=None)
def _jax_oracle():
    import jax
    from repro.kernels import ref as jref
    return jax.jit(jref.paged_chunk_attention_ref)


def _case(seed, B, Sq, H, Hkv, D, page, maxp, *, pad_lane=True,
          decode=False):
    """Random inputs with permuted tables padded with each lane's last
    valid page id; the last lane is padded (ctx 0) when ``pad_lane``."""
    rng = np.random.default_rng(seed)
    P = maxp * B + 3
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, page, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, page, Hkv, D)).astype(np.float32)
    perm = rng.permutation(P - 1)          # page P-1 stays out of every table
    tables = np.zeros((B, maxp), np.int32)
    qoff = np.zeros((B,), np.int32)
    ctx = np.zeros((B,), np.int32)
    for b in range(B - 1 if pad_lane else B):
        n = 1 if decode else int(rng.integers(1, Sq + 1))
        c = int(rng.integers(n, maxp * page + 1))
        qoff[b], ctx[b] = c - n, c
        w = -(-c // page)
        tables[b, :w] = perm[b * maxp:b * maxp + w]
        tables[b, w:] = tables[b, w - 1]
    return q, kp, vp, tables, qoff, ctx


def _torch(arrs, dtype):
    q, kp, vp, tables, qoff, ctx = arrs
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return (t(q), t(kp), t(vp), torch.from_numpy(tables),
            torch.from_numpy(qoff), torch.from_numpy(ctx))


def _quant(kp, vp, seed, share=0.75):
    """int8 shadow pools of float32 pools, their scales, and flags on about
    ``share`` of the pages (torch, CPU)."""
    kq, ks = quantize_int8(torch.from_numpy(kp), axis=(1, 2, 3))
    vq, vs = quantize_int8(torch.from_numpy(vp), axis=(1, 2, 3))
    rng = np.random.default_rng(seed)
    flags = torch.from_numpy((rng.random(kp.shape[0]) < share)
                             .astype(np.int32))
    return kq, vq, ks, vs, flags


def _jax(arrs, dtype: str):
    import jax.numpy as jnp
    q, kp, vp, tables, qoff, ctx = arrs
    dt = getattr(jnp, dtype)
    return (jnp.asarray(q, dt), jnp.asarray(kp, dt), jnp.asarray(vp, dt),
            jnp.asarray(tables), jnp.asarray(qoff), jnp.asarray(ctx))


def _assert_real_rows(got, want, qoff, ctx, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    for b in range(got.shape[0]):
        if ctx[b] == 0:
            assert np.all(got[b] == 0), f"ctx=0 lane {b} not zero"
            continue
        n = int(ctx[b] - qoff[b])
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=tol,
                                   atol=tol)


GEOMETRIES = [
    (3, 8, 4, 4, 32, 8, 4),        # MHA, mixed chunks
    (4, 16, 8, 2, 64, 16, 4),      # GQA 4:1
    (2, 8, 8, 1, 128, 32, 2),      # MQA
    (3, 5, 6, 2, 64, 8, 5),        # G = 3, ragged Sq
    (3, 9, 4, 4, 80, 16, 4),       # zamba2-2.7b's head dim, MHA
    (3, 9, 4, 4, 96, 16, 4),       # phi-3-vision's head dim, MHA
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,maxp", GEOMETRIES)
def test_plain_matches_jax_oracle(B, Sq, H, Hkv, D, page, maxp, dtype):
    arrs = _case(B * 100 + Sq, B, Sq, H, Hkv, D, page, maxp)
    want = _jax_oracle()(*_jax(arrs, dtype))
    got = ops.paged_chunk_attention(*_torch(arrs, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _assert_real_rows(got.float(), want, arrs[4], arrs[5], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_lanes_match_jax_oracle(dtype):
    """Sq = 1 lanes (decode is the one-token chunk) with a padded lane."""
    arrs = _case(5, 5, 1, 8, 2, 64, 16, 6, decode=True)
    want = _jax_oracle()(*_jax(arrs, dtype))
    got = ops.paged_chunk_attention(*_torch(arrs, getattr(torch, dtype)))
    _assert_real_rows(got.float(), want, arrs[4], arrs[5], TOL[dtype])


def test_plain_matches_pallas_interpret():
    """The Pallas kernel itself, run as the JAX package's tests run it on
    the CPU (interpret mode), on one small GQA case."""
    from repro.kernels.paged_attention import paged_chunk_attention
    arrs = _case(11, 3, 8, 8, 2, 32, 8, 4)
    want = paged_chunk_attention(*_jax(arrs, "float32"), bq=4,
                                 interpret=True)
    got = ops.paged_chunk_attention(*_torch(arrs, torch.float32))
    _assert_real_rows(got, want, arrs[4], arrs[5], TOL["float32"])


def test_plain_ignores_table_padding_and_page_placement():
    """What the last-valid padding holds never matters, and neither does
    where the pages sit in the pool."""
    arrs = _case(13, 3, 8, 8, 4, 32, 8, 5)
    q, kp, vp, tables, qoff, ctx = arrs
    base = ops.paged_chunk_attention(*_torch(arrs, torch.float32))
    junk = tables.copy()
    for b in range(3):
        w = -(-int(ctx[b]) // 8)
        junk[b, w:] = kp.shape[0] - 1              # any other page id
    perm = np.random.default_rng(3).permutation(kp.shape[0])
    inv = np.argsort(perm).astype(np.int32)
    for t, k, v in ((junk, kp, vp), (inv[tables], kp[perm], vp[perm])):
        got = ops.paged_chunk_attention(*_torch((q, k, v, t, qoff, ctx),
                                                torch.float32))
        _assert_real_rows(got, base, qoff, ctx, 1e-6)


def test_dispatch_follows_the_tensor_device():
    """CPU tensors take the plain version; the kernel wrapper refuses them
    (no fallback) and counts nothing; unknown modes raise."""
    args = _torch(_case(17, 2, 4, 4, 2, 64, 8, 3), torch.float32)
    before = pa.launches
    torch.testing.assert_close(ops.paged_chunk_attention(*args),
                               ops.paged_chunk_attention(*args, mode="ref"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_chunk_attention(*args)
    with pytest.raises(ValueError, match="kernel mode"):
        ops.paged_chunk_attention(*args, mode="cuda")
    assert pa.launches == before


def test_quant_dispatch_follows_the_tensor_device():
    """The int8 entry the same way: CPU tensors take the plain quant
    version, the kernel wrapper refuses them and counts nothing."""
    arrs = _case(19, 2, 4, 4, 2, 64, 8, 3)
    args = _torch(arrs, torch.float32)
    quant = _quant(arrs[1], arrs[2], 19)
    before = pa.quant_launches
    torch.testing.assert_close(
        ops.paged_chunk_attention(*args, quant=quant),
        tref.paged_chunk_attention_ref(*args, quant=quant))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_chunk_attention_quant(*args[:3], *quant, *args[3:])
    assert pa.quant_launches == before


def test_library_name_follows_the_headers(tmp_path, monkeypatch):
    """The built library is named by a hash of the source, of every shared
    header beside it and of the flags: an edited header must give another
    library (an edit to one source leaves the others' names alone)."""
    import shutil
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    names = (pa.NAME, "flash_prefill", pa.DECODE_NAME)
    before = {n: build.source_digest(n, csrc) for n in names}
    assert before == {n: build.source_digest(n) for n in names}
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "// an edit\n")
    after = {n: build.source_digest(n, csrc) for n in names}
    assert all(after[n] != before[n] for n in names)
    src = csrc / f"{pa.NAME}.cu"
    src.write_text(src.read_text() + "// an edit\n")
    again = {n: build.source_digest(n, csrc) for n in names}
    assert again[pa.NAME] != after[pa.NAME]
    assert all(again[n] == after[n] for n in names[1:])
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    cmd = build.nvcc_command(src, tmp_path / "x.so")
    assert cmd[cmd.index("-I") + 1] == str(build.CSRC)   # sees the headers


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


CARD_GEOMETRIES = [
    (3, 8, 4, 4, 64, 8, 4),        # MHA
    (4, 16, 8, 2, 64, 16, 4),      # GQA 4:1
    (2, 8, 8, 1, 128, 32, 2),      # MQA
    (3, 37, 32, 8, 128, 16, 6),    # llama3-8b heads, ragged Sq
    (5, 1, 32, 8, 128, 16, 9),     # llama3-8b decode
    (3, 37, 32, 32, 80, 16, 6),    # zamba2-2.7b's shared attention
    (5, 1, 32, 32, 80, 16, 9),     # its decode
    # the bf16 tensor-core tile's edges (64 rows of 64 / G positions, 64
    # keys a ring stage); every lane's chunk is ragged, crosses a tile
    # boundary at a q_offset that is not a multiple of the page, and its
    # context ends inside a stage
    (3, 9, 64, 4, 128, 16, 4),     # G = 16: 4 positions a tile
    (3, 30, 10, 2, 64, 16, 5),     # G = 5: 60 of 64 rows real
    (3, 40, 32, 8, 128, 8, 12),    # page 8: 8 pages a stage
    (3, 40, 32, 8, 128, 32, 5),    # page 32: 2 pages a stage
    (3, 150, 32, 32, 80, 16, 14),  # D = 80, a chunk of 2-3 query tiles
    (3, 37, 32, 32, 96, 16, 6),    # phi-3-vision's attention (D = 96)
    (5, 1, 32, 32, 96, 16, 9),     # its decode
    (3, 150, 32, 32, 96, 16, 14),  # D = 96, a chunk of 2-3 query tiles
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,maxp", CARD_GEOMETRIES)
def test_cuda_kernel_matches_plain(cuda, B, Sq, H, Hkv, D, page, maxp,
                                   dtype):
    arrs = _case(B * 7 + Sq, B, Sq, H, Hkv, D, page, maxp,
                 decode=(Sq == 1))
    args = [t.to(cuda) for t in _torch(arrs, getattr(torch, dtype))]
    before = pa.launches
    got = ops.paged_chunk_attention(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    want = tref.paged_chunk_attention_ref(*args)
    assert torch.isfinite(got.float()).all()
    _assert_real_rows(got.float().cpu(), want.float().cpu(), arrs[4],
                      arrs[5], TOL[dtype])
    for b, n in enumerate(arrs[5] - arrs[4]):     # bucket padding: zeros
        assert bool((got[b, max(int(n), 0):] == 0).all()), f"lane {b}"


@pytest.mark.gpu
def test_cuda_kernel_rejects_what_it_cannot_take(cuda):
    args = [t.to(cuda) for t in _torch(_case(1, 2, 4, 4, 2, 64, 8, 3),
                                       torch.float32)]
    q, kp, vp, tables, qoff, ctx = args
    with pytest.raises(TypeError):
        pa.paged_chunk_attention(q.half(), kp.half(), vp.half(), tables,
                                 qoff, ctx)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_chunk_attention(q[..., :32].contiguous(),
                                 kp[..., :32].contiguous(),
                                 vp[..., :32].contiguous(), tables, qoff, ctx)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_chunk_attention(q.transpose(1, 2), kp, vp, tables, qoff,
                                 ctx)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_chunk_attention(q, kp, vp, tables.long(), qoff, ctx)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,H,Hkv,D,page,maxp", CARD_GEOMETRIES)
def test_cuda_quant_kernel_matches_plain(cuda, B, Sq, H, Hkv, D, page, maxp,
                                         dtype):
    arrs = _case(B * 11 + Sq, B, Sq, H, Hkv, D, page, maxp,
                 decode=(Sq == 1))
    args = [t.to(cuda) for t in _torch(arrs, getattr(torch, dtype))]
    quant = [t.to(cuda) for t in _quant(arrs[1], arrs[2], B + Sq)]
    before = (pa.launches, pa.quant_launches)
    got = ops.paged_chunk_attention(*args, quant=quant)
    torch.cuda.synchronize()
    assert (pa.launches, pa.quant_launches) == (before[0], before[1] + 1)
    want = tref.paged_chunk_attention_ref(*args, quant=quant)
    assert torch.isfinite(got.float()).all()
    _assert_real_rows(got.float().cpu(), want.float().cpu(), arrs[4],
                      arrs[5], TOL[dtype])
    for b, n in enumerate(arrs[5] - arrs[4]):     # bucket padding: zeros
        assert bool((got[b, max(int(n), 0):] == 0).all()), f"lane {b}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_quant_kernel_with_flags_clear_is_the_fp_kernel(cuda, dtype):
    arrs = _case(23, 5, 37, 32, 8, 128, 16, 6)
    args = [t.to(cuda) for t in _torch(arrs, getattr(torch, dtype))]
    quant = [t.to(cuda) for t in _quant(arrs[1], arrs[2], 23, share=0.0)]
    assert not bool(quant[4].any())
    got = ops.paged_chunk_attention(*args, quant=quant)
    want = ops.paged_chunk_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _relevant_pages(tables, ctx, page):
    """The pool pages the lanes' first ceil(ctx / page) columns name."""
    out = set()
    for b in range(tables.shape[0]):
        w = -(-int(ctx[b]) // page)
        out.update(int(p) for p in tables[b, :w])
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["kernel1", "int8"])
def test_cuda_kernel_never_reads_irrelevant_pages(cuda, quant, dtype):
    """Every pool page outside the lanes' relevant pages is NaN, and so are
    the pages that the table columns past the relevant ones (and the ctx =
    0 lane's row) point at; with ``quant`` their int8 scales are NaN and
    half of them are flagged.  The kernel's output stays finite and equals
    the plain version on the clean pools."""
    B, Sq, H, Hkv, D, page, maxp = 4, 40, 32, 8, 128, 8, 16
    arrs = _case(29, B, Sq, H, Hkv, D, page, maxp)
    q, kp, vp, tables, qoff, ctx = arrs
    P = kp.shape[0]
    used = _relevant_pages(tables, ctx, page)
    junk = [p for p in range(P) if p not in used]
    tables = tables.copy()
    for b in range(B):
        w = -(-int(ctx[b]) // page)
        tables[b, w:] = junk[(7 * b) % len(junk)]
    clean = [t.to(cuda) for t in _torch((q, kp, vp, tables, qoff, ctx),
                                        getattr(torch, dtype))]
    bad = [t.clone() for t in clean]
    junk_t = torch.tensor(junk, device=cuda)
    bad[1][junk_t] = float("nan")
    bad[2][junk_t] = float("nan")
    if quant:
        qs = [t.to(cuda) for t in _quant(kp, vp, 29, share=0.5)]
        bad_q = [t.clone() for t in qs]
        bad_q[2][junk_t] = float("nan")
        bad_q[3][junk_t] = float("nan")
        bad_q[4][junk_t[::2]] = 1
        got = ops.paged_chunk_attention(*bad, quant=bad_q)
        want = tref.paged_chunk_attention_ref(*clean, quant=qs)
    else:
        got = ops.paged_chunk_attention(*bad)
        want = tref.paged_chunk_attention_ref(*clean)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _assert_real_rows(got.float().cpu(), want.float().cpu(), qoff, ctx,
                      TOL[dtype])
    for b, n in enumerate(ctx - qoff):            # bucket padding: zeros
        assert bool((got[b, max(int(n), 0):] == 0).all()), f"lane {b}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_quant_kernel_mixes_pages_within_a_stage(cuda, dtype):
    """Pages alternate between int8 and fp in each lane's table order, so
    every 64-key stage (4 pages of 16, 8 of 8) holds both kinds."""
    for page, maxp in ((16, 10), (8, 20)):
        arrs = _case(31 + page, 3, 50, 32, 8, 128, page, maxp)
        args = [t.to(cuda) for t in _torch(arrs, getattr(torch, dtype))]
        quant = [t.to(cuda) for t in _quant(arrs[1], arrs[2], 31, share=0)]
        tables, ctx = arrs[3], arrs[5]
        for b in range(tables.shape[0]):
            for i in range(-(-int(ctx[b]) // page)):
                quant[4][int(tables[b, i])] = i % 2
        got = ops.paged_chunk_attention(*args, quant=quant)
        torch.cuda.synchronize()
        want = tref.paged_chunk_attention_ref(*args, quant=quant)
        assert torch.isfinite(got.float()).all()
        _assert_real_rows(got.float().cpu(), want.float().cpu(), arrs[4],
                          ctx, TOL[dtype])
        fp_only = ops.paged_chunk_attention(*args)
        assert not torch.equal(got, fp_only)      # the int8 pages were read


@pytest.mark.gpu
def test_cuda_kernel_resources(cuda):
    """The bf16 bodies are one consumer warpgroup and one producer warp
    (B.2: a producer warpgroup, the producer and three warps that convert
    flagged pages' codes, launched at 128 registers a thread, which the
    two warpgroups trade by setmaxnreg) with two CTAs resident per SM, and
    do not spill, at pages of 2 rows or more and at pages of 1 row (the
    split-K partial mode's); the float32 bodies are 128 threads."""
    for quant in (False, True):
        for d in pa.HEAD_DIMS:
            for one_row in (False, True):
                tc = pa.resources(torch.bfloat16, d, quant, one_row=one_row)
                assert tc["threads"] == (256 if quant else 160), tc
                if quant:
                    assert tc["registers"] == 128, tc
                assert tc["ctas_per_sm"] >= 2, tc
                assert tc["local_bytes"] == 0, (d, quant, one_row, tc)
            assert pa.resources(torch.float32, d, quant)["threads"] == 128


@pytest.mark.gpu
def test_cuda_quant_kernel_rejects_what_it_cannot_take(cuda):
    arrs = _case(2, 2, 4, 4, 2, 64, 8, 3)
    q, kp, vp, tables, qoff, ctx = [t.to(cuda)
                                    for t in _torch(arrs, torch.float32)]
    kq, vq, ks, vs, flags = [t.to(cuda)
                             for t in _quant(arrs[1], arrs[2], 2)]
    with pytest.raises(TypeError, match="int8"):
        pa.paged_chunk_attention_quant(q, kp, vp, kq.float(), vq, ks, vs,
                                       flags, tables, qoff, ctx)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_chunk_attention_quant(q, kp, vp, kq, vq, ks, vs,
                                       flags.long(), tables, qoff, ctx)
    with pytest.raises(ValueError, match="P="):
        pa.paged_chunk_attention_quant(q, kp, vp, kq, vq, ks[:-1], vs,
                                       flags, tables, qoff, ctx)
