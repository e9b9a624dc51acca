"""The port's prefill attention against the JAX package.

The port's plain ``flash_prefill_ref`` (``kernels/ref.py``: what the port
runs for CPU tensors and the CUDA kernel's plain version) and the
dispatcher ``ops.flash_prefill`` on CPU tensors are held to the Pallas
``flash_prefill`` in interpret mode and to ``repro.kernels.ref``'s
``flash_prefill_ref`` on tests/test_kernels.py's sweep (MHA, GQA, MQA,
q_offset > 0), with its tolerances: 2e-4 in float32, 2e-2 in bfloat16.  A
ragged Sq and Skv, which the Pallas kernel cannot tile, are held to JAX's
``layers.flash_attention``; the two-stage continuation of
test_kernels.py:183 holds on the port; and ``DenseLM.prefill`` (which now
runs ``ops.flash_prefill`` on every layer) matches JAX's logits and cache
on converted weights in both kernel modes.

The ``gpu`` tests hold the CUDA kernel against the plain version on the
card, at the same tolerances scaled by max |plain| (the bf16 tensor-core
body at the edges of its tile: ragged Sq at q_offset > 0, key tiles across
row horizons, G of 1, 3, 5, 8, 16 and 64, D of 64, 96 and 128, one token
over 4096 keys), kernel 1
on the same input seen as pages, the float32 body bit for bit to digests
recorded before the bf16 body changed, and the bodies' resources; they
skip where there is no card.  JAX is imported only inside the CPU tests
(the machine with the card has none).
"""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_prefill as kfp
from repro_torch.kernels import flash_tiles
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as kpa
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as L
from repro_torch.models.registry import get_model

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
SWEEP = [                                   # tests/test_kernels.py:151-155
    (2, 64, 64, 4, 4, 32, 0),               # plain causal
    (1, 32, 96, 8, 2, 64, 64),              # continuation: 64 cached + 32 new
    (2, 16, 48, 4, 1, 32, 32),              # MQA continuation
]


def _inputs(seed, B, Sq, Skv, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32))


def _t(a, dtype="float32"):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,qo", SWEEP)
def test_flash_prefill_sweep_matches_jax(B, Sq, Skv, H, Hkv, D, qo, dtype):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.flash_prefill import flash_prefill as pallas
    q, k, v = _inputs(3, B, Sq, Skv, H, Hkv, D)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    tq, tk, tv = (_t(a, dtype) for a in (q, k, v))
    kern = pallas(jq, jk, jv, q_offset=qo, bq=16, bk=16, interpret=True)
    oracle = jref.flash_prefill_ref(jq, jk, jv, qo)
    before = kfp.launches
    for got in (tref.flash_prefill_ref(tq, tk, tv, qo),
                ops.flash_prefill(tq, tk, tv, qo)):
        assert got.dtype == tq.dtype and got.shape == tq.shape
        _close(got, kern, dtype)
        _close(got, oracle, dtype)
    assert kfp.launches == before           # CPU tensors: the plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,qo", [
    (1, 37, 37, 4, 2, 0),                   # ragged prompt, no prefix
    (2, 13, 59, 8, 2, 40),                  # ragged continuation, padded keys
    (1, 1, 20, 4, 1, 19),                   # one new token (MQA)
])
def test_ragged_lengths_match_jax_flash_attention(B, Sq, Skv, H, Hkv, qo,
                                                  dtype):
    """Lengths the Pallas kernel cannot tile (it asks Sq % bq == 0): held
    to JAX's chunked ``flash_attention``, which the JAX model runs."""
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    q, k, v = _inputs(B * 7 + Sq, B, Sq, Skv, H, Hkv, 16)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    want = jlayers.flash_attention(jq, jk, jv, causal=True, q_offset=qo)
    tq, tk, tv = (_t(a, dtype) for a in (q, k, v))
    _close(ops.flash_prefill(tq, tk, tv, qo), want, dtype)
    _close(L.flash_attention(tq, tk, tv, q_offset=qo), want, dtype)


def test_two_stage_continuation():
    """tests/test_kernels.py:183 on the port: prefill of [prefix + new]
    equals the prefix's K/V cached and the new tokens at q_offset."""
    q, k, v = (_t(a) for a in _inputs(11, 1, 64, 64, 4, 2, 32))
    full = ops.flash_prefill(q, k, v, 0)
    cont = ops.flash_prefill(q[:, 32:].contiguous(), k, v, 32)
    np.testing.assert_allclose(_np(full[:, 32:]), _np(cont), rtol=1e-5,
                               atol=1e-5)


def test_mode_and_window_dispatch():
    """``mode`` is auto | ref; ``DenseLM.prefill`` runs the prefill kernel
    (the plain version on CPU tensors) on every layer unless the config has
    a sliding window, which keeps ``layers.flash_attention``."""
    q, k, v = (_t(a) for a in _inputs(0, 1, 4, 4, 2, 1, 16))
    with pytest.raises(ValueError, match="kernel mode"):
        ops.flash_prefill(q, k, v, 0, mode="cuda")
    calls = []
    orig = tref.flash_prefill_ref

    def counted(*args):
        calls.append(args[0].shape)
        return orig(*args)

    tokens = torch.tensor([[1, 2, 3, 4, 5]])
    for window, per_layer in ((None, 1), (3, 0)):
        cfg = tconfigs.get_config("llama3-8b").reduced(
            dtype="float32", sliding_window=window)
        model = get_model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        calls.clear()
        tref.flash_prefill_ref = counted
        try:
            model.prefill(params, tokens)
        finally:
            tref.flash_prefill_ref = orig
        assert len(calls) == per_layer * cfg.n_layers, (window, calls)


@pytest.mark.parametrize("kernel_mode", ["auto", "ref"])
@pytest.mark.parametrize("n_kv", [4, 2, 1])
def test_dense_prefill_matches_jax(n_kv, kernel_mode):
    """The port's DenseLM.prefill (B.4's path) against JAX's, on JAX's
    weights carried across: last logits and the cache within 2e-4."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model
    from repro_torch import convert
    jcfg = jax_config("llama3-8b").reduced(dtype="float32", n_kv_heads=n_kv)
    cfg = tconfigs.get_config("llama3-8b").reduced(dtype="float32",
                                                   n_kv_heads=n_kv)
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.key(n_kv))
    tm = get_model(cfg, device="cpu")
    tp = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    toks = np.random.default_rng(n_kv).integers(0, cfg.vocab, (2, 21),
                                                dtype=np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), kernel_mode=kernel_mode)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=2e-4, atol=2e-4)
    for side in ("k", "v"):
        np.testing.assert_allclose(_np(tc[side]), np.asarray(jc[side]),
                                   rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_resources_and_tile_variants_need_no_card():
    """``resources`` rejects a dtype or head dim with no body before it
    touches the card; every tile variant of ``kernels/flash_tiles.py``
    replaces exactly one constant of the checked-in source."""
    with pytest.raises(ValueError, match="head dim"):
        kfp.resources(torch.bfloat16, 80)
    with pytest.raises(ValueError, match="no body"):
        kfp.resources(torch.float16, 128)
    src = flash_tiles.variant_source({})
    for consts in flash_tiles.VARIANTS.values():
        got = flash_tiles.variant_source(consts)
        for name, value in consts.items():
            assert f"constexpr int {name} = {value};" in got
            assert f"constexpr int {name} = {value};" not in src
    with pytest.raises(ValueError, match="kNoSuchTile"):
        flash_tiles.variant_source(dict(kNoSuchTile=1))


def test_paged_resources_need_no_card():
    """Kernel 1's ``resources`` imports with the port and rejects a dtype or
    head dim with no body before it touches the card or the compiler."""
    with pytest.raises(ValueError, match="head dim"):
        kpa.resources(torch.bfloat16, 112)
    with pytest.raises(ValueError, match="no body"):
        kpa.resources(torch.float16, 128, quant=True)


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


CARD_SHAPES = [                             # B, Sq, Skv, H, Hkv, D, q_offset
    (1, 100, 100, 32, 8, 128, 0),           # llama3-8b, ragged prompt
    (2, 256, 1024, 32, 8, 128, 512),        # continuation, padded keys
    (1, 1, 77, 32, 8, 128, 76),             # one new token
    (3, 70, 90, 8, 8, 64, 5),               # MHA, D = 64
    (1, 130, 130, 36, 36, 64, 0),           # minicpm-2b's heads, G = 1
    (2, 33, 40, 16, 1, 128, 7),             # MQA, G = 16
    # the tensor-core body's edges (64-row tile of 64 / G positions, keys
    # 64 a ring stage):
    (2, 45, 300, 32, 8, 128, 200),          # Sq % 16 != 0, padding keys
    (1, 200, 330, 8, 1, 64, 100),           # G = 8: key tiles cross horizons
    (1, 3, 200, 64, 1, 128, 150),           # G = 64: one position a tile
    (1, 50, 60, 10, 2, 64, 3),              # G = 5: 60 of 64 rows real
    (1, 1, 4096, 32, 8, 128, 4095),         # one token over 4096 keys
    (1, 1000, 4000, 36, 36, 64, 2900),      # D = 64 at a long Skv
    # phi-3-vision (D = 96), granite-moe (G = 3: 21 positions, 63 of 64
    # rows real) and qwen3-moe (G = 8, D = 128), at Sq not a multiple of
    # the tile's positions
    (2, 704, 704, 32, 32, 96, 0),           # phi-3: 576 patches + 128 text
    (1, 77, 300, 32, 32, 96, 223),          # D = 96 continuation
    (2, 130, 130, 24, 8, 64, 0),            # G = 3 prompt
    (1, 50, 400, 24, 8, 64, 350),           # G = 3 continuation
    (2, 99, 99, 32, 4, 128, 0),             # G = 8 prompt
    (1, 1, 513, 32, 4, 128, 512),           # G = 8, one token
]
# sha256 (first 16 hex digits) of the float32 output on _card_inputs,
# recorded on the card from the CUDA-core body as it was before the bfloat16
# body moved to the tensor cores: the float32 body keeps its arithmetic, so
# its bits must not move
FP32_DIGESTS = {
    (1, 100, 100, 32, 8, 128, 0): "82d6ecd8df03bce2",
    (3, 70, 90, 8, 8, 64, 5): "8e379e1eb1c410e8",
    (2, 33, 40, 16, 1, 128, 7): "62f51044386a3212",
}


def _card_inputs(dev, dtype, B, Sq, Skv, H, Hkv, D):
    q, k, v = _inputs(B * 131 + Sq, B, Sq, Skv, H, Hkv, D)
    return tuple(_t(a, dtype).to(dev) for a in (q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,qo", CARD_SHAPES)
def test_cuda_flash_prefill_matches_plain(cuda, B, Sq, Skv, H, Hkv, D, qo,
                                          dtype):
    q, k, v = _card_inputs(cuda, dtype, B, Sq, Skv, H, Hkv, D)
    before = kfp.launches
    out = ops.flash_prefill(q, k, v, qo)
    torch.cuda.synchronize()
    assert kfp.launches == before + 1
    want = tref.flash_prefill_ref(q, k, v, qo)
    assert out.dtype == q.dtype and torch.isfinite(out.float()).all()
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * want.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(FP32_DIGESTS))
def test_cuda_flash_prefill_float32_bits_unchanged(cuda, shape):
    q, k, v = _card_inputs(cuda, "float32", *shape[:6])
    out = kfp.flash_prefill(q, k, v, shape[6])
    got = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
    assert got == FP32_DIGESTS[shape]


@pytest.mark.gpu
def test_cuda_flash_prefill_resources(cuda):
    """The bf16 body is one producer warp and one consumer warpgroup with
    two CTAs resident per SM; neither body spills."""
    for d in kfp.HEAD_DIMS:
        tc = kfp.resources(torch.bfloat16, d)
        assert tc["threads"] == 160 and tc["ctas_per_sm"] >= 2, tc
        assert tc["local_bytes"] == 0, tc
        assert kfp.resources(torch.float32, d)["local_bytes"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_prefill_equals_kernel1_on_identity_tables(cuda, dtype):
    """Dense K/V seen as pages with identity tables, q_offsets = q_offset
    and ctx_lens = q_offset + Sq is kernel 1's input: same function."""
    B, Sq, Skv, H, Hkv, D, qo, page = 2, 96, 256, 32, 8, 128, 100, 16
    q, k, v = _card_inputs(cuda, dtype, B, Sq, Skv, H, Hkv, D)
    out = kfp.flash_prefill(q, k, v, qo)
    n = Skv // page
    tables = torch.arange(B * n, dtype=torch.int32, device=cuda).view(B, n)
    qoffs = torch.full((B,), qo, dtype=torch.int32, device=cuda)
    ctx = torch.full((B,), qo + Sq, dtype=torch.int32, device=cuda)
    k1 = kpa.paged_chunk_attention(q, k.view(B * n, page, Hkv, D),
                                   v.view(B * n, page, Hkv, D), tables,
                                   qoffs, ctx)
    torch.cuda.synchronize()
    err = (out.float() - k1.float()).abs().max().item()
    assert err <= TOL[dtype] * k1.float().abs().max().item()


@pytest.mark.gpu
def test_cuda_dense_prefill_launches_on_every_layer(cuda):
    cfg = tconfigs.get_config("llama3-8b").reduced(
        dtype="float32", n_heads=8, n_kv_heads=2, d_head=64, d_model=128)
    model = get_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (1, 45), device=cuda)
    before = kfp.launches
    logits, cache = model.prefill(params, tokens)
    assert kfp.launches == before + cfg.n_layers
    plain, pcache = model.prefill(params, tokens, kernel_mode="ref")
    assert kfp.launches == before + cfg.n_layers
    err = (logits - plain).abs().max().item()
    assert err <= TOL["float32"] * plain.abs().max().item()


@pytest.mark.gpu
def test_cuda_flash_prefill_rejects_what_it_cannot_take(cuda):
    q, k, v = _card_inputs(cuda, "float32", 1, 8, 16, 8, 2, 64)
    with pytest.raises(ValueError, match="q_offset"):
        kfp.flash_prefill(q, k, v, 9)
    with pytest.raises(TypeError):
        kfp.flash_prefill(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="k is"):
        kfp.flash_prefill(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head dim"):
        kfp.flash_prefill(q[..., :32].contiguous(), k[..., :32].contiguous(),
                          v[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kfp.flash_prefill(q.transpose(1, 2).contiguous().transpose(1, 2),
                          k, v)
    with pytest.raises(ValueError, match="kv heads"):
        kfp.flash_prefill(q, torch.cat([k, k[:, :, :1]], 2),
                          torch.cat([v, v[:, :, :1]], 2))
    with pytest.raises(ValueError, match="CUDA"):
        kfp.flash_prefill(q.cpu(), k.cpu(), v.cpu())
