"""The port's SSD scan against the JAX package.

The port's plain chunked scan (``kernels/ref.py::ssd_scan_chunked_ref``,
what the port runs for CPU tensors and the CUDA kernel's plain version) is
held to the Pallas ``ssd_scan`` in interpret mode and to the sequential
oracle ``repro.kernels.ref.ssd_scan_ref`` on tests/test_kernels.py's sweep,
with its tolerances (2e-4 in float32, 3e-2 in bfloat16).  The model's
``Zamba2LM._ssd_scan`` (padding to a chunk multiple, the decay and dt
scaling, an initial state, per-group B/C) is held to JAX's at an S that is
not a chunk multiple, and a scan continued from its own final state equals
one pass.

The ``gpu`` tests hold the CUDA kernel against the plain version on the
card; they skip where there is no card.  JAX is imported only inside the
CPU tests (the machine with the card has none).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.models.registry import get_model

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
SWEEP = [                                  # tests/test_kernels.py's sweep
    (2, 64, 2, 16, 8, 16),
    (1, 128, 4, 32, 16, 64),
    (3, 96, 1, 8, 4, 32),
]


def _inputs(seed, B, S, H, P, G, N, init=False):
    """numpy inputs with the TPU sweep's distributions."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dA = -np.abs(rng.normal(scale=0.1, size=(B, S, H))).astype(np.float32)
    Bm = rng.normal(size=(B, S, G, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, G, N)).astype(np.float32)
    h0 = rng.normal(size=(B, H, N, P)).astype(np.float32) if init else None
    return x, dA, Bm, Cm, h0


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_chunked_plain_matches_pallas_and_oracle(B, S, H, P, N, chunk,
                                                 dtype):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.ssd_scan import ssd_scan
    x, dA, Bm, Cm, _ = _inputs(hash((B, S, H)) % 2**32, B, S, H, P, H, N)
    jdt = getattr(jnp, dtype)
    jx, jB, jC = (jnp.asarray(a, jdt) for a in (x, Bm, Cm))
    want = ssd_scan(jx, jnp.asarray(dA), jB, jC, chunk=chunk,
                    interpret=True)
    want_o, want_h = jref.ssd_scan_ref(jx, jnp.asarray(dA), jB, jC)
    tdt = getattr(torch, dtype)
    y, h = ops.ssd_scan(_t(x, tdt), _t(dA), _t(Bm, tdt), _t(Cm, tdt), chunk)
    assert y.dtype == tdt and h.dtype == torch.float32
    tol = dict(rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want_o, np.float32), **tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **tol)


def test_sequential_oracle_matches_jax():
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    x, dA, Bm, Cm, _ = _inputs(3, 2, 40, 3, 8, 3, 4)
    want = jref.ssd_scan_ref(*(jnp.asarray(a) for a in (x, dA, Bm, Cm)))
    got = tref.ssd_scan_ref(*(_t(a) for a in (x, dA, Bm, Cm)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("init", [False, True])
def test_model_ssd_scan_matches_jax(init):
    """Zamba2LM._ssd_scan, port vs JAX, at S = 45 (chunk 32: one full
    chunk and a padded one) with one B/C group, with and without an
    initial state."""
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models.registry import get_model as jax_model
    cfg = tconfigs.get_config("zamba2-2.7b").reduced(dtype="float32")
    jm = jax_model(jconfigs.get_config("zamba2-2.7b").reduced(
        dtype="float32"))
    tm = get_model(cfg, device="cpu")
    H, P, N = tm.nh, cfg.ssm.head_dim, cfg.ssm.d_state
    rng = np.random.default_rng(7)
    B, S = 2, 45
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.abs(rng.normal(scale=0.3, size=(B, S, H))).astype(np.float32)
    Bm = rng.normal(size=(B, S, 1, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, 1, N)).astype(np.float32)
    a_log = np.log(np.arange(1, H + 1)).astype(np.float32)
    h0 = rng.normal(size=(B, H, N, P)).astype(np.float32) if init else None
    yj, hj = jm._ssd_scan(*(jnp.asarray(a) for a in (xh, dt, Bm, Cm, a_log)),
                          init_state=None if h0 is None else jnp.asarray(h0))
    yt, ht = tm._ssd_scan(*(_t(a) for a in (xh, dt, Bm, Cm, a_log)),
                          init_state=_t(h0))
    assert tuple(yt.shape) == (B, S, H, P)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("split", [1, 17, 32, 50])
def test_two_stage_continuation_equals_one_pass(split):
    """Scanning S1 steps, then the rest from the S1 state, gives the one
    pass's outputs and final state (what serving a prompt in chunks, or a
    decode step after a prefill, relies on)."""
    x, dA, Bm, Cm, h0 = _inputs(11, 2, 64, 4, 8, 2, 16, init=True)
    args = [_t(a) for a in (x, dA, Bm, Cm)]
    y, h = tref.ssd_scan_chunked_ref(*args, 16, init_state=_t(h0))
    first = [a[:, :split] for a in args]
    rest = [a[:, split:] for a in args]
    y1, h1 = tref.ssd_scan_chunked_ref(*first, 16, init_state=_t(h0))
    y2, h2 = tref.ssd_scan_chunked_ref(*rest, 16, init_state=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(h2, h, rtol=2e-4, atol=2e-4)


def test_chunk_length_does_not_change_the_function():
    """Any chunk length gives the same scan up to rounding (the CUDA kernel
    walks its own inner chunk of 32), and so does the token-by-token
    recurrence; padded steps (dA = 0, zero inputs) leave the state as it
    was."""
    x, dA, Bm, Cm, h0 = _inputs(13, 2, 70, 4, 8, 1, 16, init=True)
    args = [_t(a) for a in (x, dA, Bm, Cm)]
    y, h = tref.ssd_scan_chunked_ref(*args, 64, init_state=_t(h0))
    for chunk in (1, 7, 32, 256):
        yc, hc = tref.ssd_scan_chunked_ref(*args, chunk, init_state=_t(h0))
        torch.testing.assert_close(yc, y, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(hc, h, rtol=2e-4, atol=2e-4)
    pad = [torch.cat([a, torch.zeros_like(a[:, :5])], 1) for a in args]
    yp, hp = tref.ssd_scan_chunked_ref(*pad, 64, init_state=_t(h0))
    torch.testing.assert_close(yp[:, :70], y, rtol=0, atol=0)
    torch.testing.assert_close(hp, h, rtol=1e-6, atol=1e-6)
    heads = [a.repeat_interleave(4, dim=2) if a.dim() == 4
             and a.shape[2] == 1 else a for a in args]
    yo, ho = tref.ssd_scan_ref(heads[0], heads[1], heads[2], heads[3])
    y0, hz = tref.ssd_scan_chunked_ref(*args, 64)
    torch.testing.assert_close(y0, yo, rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(hz, ho, rtol=5e-4, atol=5e-4)


def _prefixed(x, dA, Bm, Cm, h0):
    """The same scan with no initial state: N steps put h0 into the state
    first (dA = 0, B_t the unit vector e_t, x_t = h0[:, :, t]), so y past
    them and the final state are the original's.  Per-head B/C (G = H), as
    the JAX kernel and oracle take them."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Bh = np.repeat(Bm, H // Bm.shape[2], axis=2)
    Ch = np.repeat(Cm, H // Cm.shape[2], axis=2)
    if h0 is None:
        return x, dA, Bh, Ch, 0
    eye = np.broadcast_to(np.eye(N, dtype=np.float32)[None, :, None, :],
                          (B, N, H, N))
    return (np.concatenate([h0.transpose(0, 2, 1, 3), x], 1),
            np.concatenate([np.zeros((B, N, H), np.float32), dA], 1),
            np.concatenate([eye, Bh], 1),
            np.concatenate([np.zeros((B, N, H, N), np.float32), Ch], 1), N)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S", [1, 2, 31, 32, 33, 513])
def test_state_passing_and_recurrence_match_jax(S, G, init):
    """The CUDA scan's two paths written out plainly — the three-pass
    state-passing scan (chunk 16: chunk-local states, the pass over the
    chunks, the output correction) and the step-by-step recurrence of the
    decode path — against the JAX Pallas ssd_scan (interpret, one chunk)
    and the JAX sequential oracle, with and without an initial state
    (given to JAX as N leading steps that build it); tolerance 2e-4."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.ssd_scan import ssd_scan
    B, H, P, N = 2, 4, 8, 16
    x, dA, Bm, Cm, h0 = _inputs(S * 10 + G + 100 * init, B, S, H, P, G, N,
                                init=init)
    px, pdA, pB, pC, lead = _prefixed(x, dA, Bm, Cm, h0)
    jargs = [jnp.asarray(a) for a in (px, pdA, pB, pC)]
    want_k = np.asarray(ssd_scan(*jargs, chunk=px.shape[1],
                                 interpret=True))[:, lead:]
    want_y, want_h = (np.asarray(a) for a in jref.ssd_scan_ref(*jargs))
    want_y = want_y[:, lead:]
    targs = [_t(a) for a in (x, dA, Bm, Cm)]
    y3, h3 = tref.ssd_scan_state_passing_ref(*targs, 16, init_state=_t(h0))
    Bh, Ch = (a.repeat_interleave(H // G, dim=2) for a in targs[2:])
    yr, hr = tref.ssd_scan_ref(targs[0], targs[1], Bh, Ch,
                               init_state=_t(h0))
    tol = dict(rtol=2e-4, atol=2e-4)
    for y, h in ((y3, h3), (yr, hr)):
        assert tuple(y.shape) == (B, S, H, P) and h.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), want_k, **tol)
        np.testing.assert_allclose(y.numpy(), want_y, **tol)
        np.testing.assert_allclose(h.numpy(), want_h, **tol)


def test_dispatch_follows_the_tensor_device():
    """CPU tensors take the plain version; the kernel wrapper refuses them
    (no fallback) and counts nothing; unknown modes raise."""
    x, dA, Bm, Cm, h0 = _inputs(17, 2, 20, 4, 8, 2, 8, init=True)
    args = [_t(a) for a in (x, dA, Bm, Cm)]
    before = kssd.launches
    got = ops.ssd_scan(*args, 8, init_state=_t(h0))
    want = ops.ssd_scan(*args, 8, init_state=_t(h0), mode="ref")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kssd.ssd_scan(*args, init_state=_t(h0))
    with pytest.raises(ValueError, match="kernel mode"):
        ops.ssd_scan(*args, 8, mode="cuda")
    assert kssd.launches == before


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


CARD_SHAPES = [                            # B, S, H, P, G, N
    (2, 64, 2, 16, 2, 8),                  # per-head B/C (the TPU contract)
    (3, 45, 8, 16, 1, 16),                 # one group, ragged S
    (8, 1, 80, 64, 1, 64),                 # zamba2-2.7b decode
    (1, 300, 80, 64, 1, 128),              # mamba2-2.7b's d_state, a chunk
    (2, 33, 6, 24, 3, 40),                 # P not a multiple of 16
]


@pytest.mark.gpu
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,G,N", CARD_SHAPES)
def test_cuda_ssd_scan_matches_plain(cuda, B, S, H, P, G, N, dtype, init):
    x, dA, Bm, Cm, h0 = _inputs(B * 31 + S, B, S, H, P, G, N, init=init)
    tdt = getattr(torch, dtype)
    args = [_t(a, d).to(cuda) for a, d in ((x, tdt), (dA, torch.float32),
                                           (Bm, tdt), (Cm, tdt))]
    h0 = None if h0 is None else _t(h0).to(cuda)
    before = kssd.launches
    y, h = ops.ssd_scan(*args, 16, init_state=h0)
    torch.cuda.synchronize()
    assert kssd.launches == before + 1
    yr, hr = tref.ssd_scan_chunked_ref(*args, 16, init_state=h0)
    for got, want in ((y, yr), (h, hr)):
        assert torch.isfinite(got.float()).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[dtype] * want.float().abs().max().item()


def _card_args(cuda, seed, B, S, H, P, G, N, dtype, init=True):
    x, dA, Bm, Cm, h0 = _inputs(seed, B, S, H, P, G, N, init=init)
    tdt = getattr(torch, dtype)
    args = [_t(a, d).to(cuda) for a, d in ((x, tdt), (dA, torch.float32),
                                           (Bm, tdt), (Cm, tdt))]
    return args, None if h0 is None else _t(h0).to(cuda)


def _close(got, want, dtype):
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * want.float().abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,P,G,N", [(4, 80, 64, 1, 64), (2, 6, 24, 3, 40),
                                       (1, 8, 18, 2, 128)])
def test_cuda_ssd_decode_path_equals_chunk_path(cuda, B, H, P, G, N, dtype):
    """One step through the decode path equals the same step through the
    chunk path: the S = 1 input followed by DECODE_MAX_S steps that change
    nothing (dA = 0, zero x, B and C), which makes S long enough for the
    chunk path; y of the first step and the final state agree."""
    (x, dA, Bm, Cm), h0 = _card_args(cuda, B * 5 + N, B, 1, H, P, G, N,
                                     dtype)
    y1, h1 = kssd.ssd_scan(x, dA, Bm, Cm, init_state=h0)
    pad = kssd.DECODE_MAX_S

    def ext(t):
        return torch.cat([t, torch.zeros_like(t[:, :1]).repeat(
            1, pad, *([1] * (t.dim() - 2)))], 1).contiguous()
    yc, hc = kssd.ssd_scan(ext(x), ext(dA), ext(Bm), ext(Cm), init_state=h0)
    torch.cuda.synchronize()
    _close(y1, yc[:, :1], dtype)
    _close(h1, hc, dtype)
    yr, hr = tref.ssd_scan_chunked_ref(x, dA, Bm, Cm, 16, init_state=h0)
    _close(y1, yr, dtype)
    _close(h1, hr, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 2, 16, 17, 64, 65])
def test_cuda_ssd_paths_meet_at_the_boundary(cuda, S, dtype):
    """S on both sides of DECODE_MAX_S and of a 64-step chunk, against the
    plain version; and S steps equal S - 1 steps continued by one."""
    assert kssd.DECODE_MAX_S == 16
    (x, dA, Bm, Cm), h0 = _card_args(cuda, S, 2, S, 8, 64, 1, 64, dtype)
    y, h = kssd.ssd_scan(x, dA, Bm, Cm, init_state=h0)
    yr, hr = tref.ssd_scan_chunked_ref(x, dA, Bm, Cm, 16, init_state=h0)
    _close(y, yr, dtype)
    _close(h, hr, dtype)
    if S > 1:
        head = [a[:, :S - 1].contiguous() for a in (x, dA, Bm, Cm)]
        tail = [a[:, S - 1:].contiguous() for a in (x, dA, Bm, Cm)]
        _, hp = kssd.ssd_scan(*head, init_state=h0)
        yl, hl = kssd.ssd_scan(*tail, init_state=hp)
        torch.cuda.synchronize()
        _close(yl, y[:, S - 1:], dtype)
        _close(hl, h, dtype)


@pytest.mark.gpu
def test_cuda_ssd_decode_continues_a_long_scan(cuda):
    """A decode step (S = 1) continued from the state of 1023 steps equals
    step 1024 of the 1024-step scan, y and the final state, at zamba2-2.7b's
    SSD widths in float32."""
    (x, dA, Bm, Cm), h0 = _card_args(cuda, 1024, 2, 1024, 80, 64, 1, 64,
                                     "float32")
    y, h = kssd.ssd_scan(x, dA, Bm, Cm, init_state=h0)
    _, hp = kssd.ssd_scan(*[a[:, :1023].contiguous() for a in
                            (x, dA, Bm, Cm)], init_state=h0)
    yl, hl = kssd.ssd_scan(*[a[:, 1023:].contiguous() for a in
                             (x, dA, Bm, Cm)], init_state=hp)
    torch.cuda.synchronize()
    _close(yl, y[:, 1023:], "float32")
    _close(hl, h, "float32")


@pytest.mark.gpu
def test_cuda_ssd_scan_rejects_what_it_cannot_take(cuda):
    x, dA, Bm, Cm, h0 = _inputs(1, 2, 8, 4, 16, 2, 8, init=True)
    x, dA, Bm, Cm, h0 = (_t(a).to(cuda) for a in (x, dA, Bm, Cm, h0))
    with pytest.raises(TypeError, match="float32"):
        kssd.ssd_scan(x, dA.double(), Bm, Cm)
    with pytest.raises(TypeError):
        kssd.ssd_scan(x.half(), dA, Bm.half(), Cm.half())
    with pytest.raises(ValueError, match="H % G"):
        kssd.ssd_scan(x, dA, torch.cat([Bm, Bm[:, :, :1]], 2),
                      torch.cat([Cm, Cm[:, :, :1]], 2))
    with pytest.raises(ValueError, match="contiguous"):
        kssd.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dA,
                      Bm, Cm)
    with pytest.raises(ValueError, match="init_state"):
        kssd.ssd_scan(x, dA, Bm, Cm, init_state=h0[:, :2])
    with pytest.raises(ValueError, match="state size"):
        big = torch.zeros(2, 8, 2, 129, device=cuda)
        kssd.ssd_scan(x, dA, big, big)
