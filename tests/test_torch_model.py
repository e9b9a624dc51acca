"""The port's DenseLM against the JAX package's, on the same weights.

JAX initialises the parameters, a numpy copy of them goes through
``repro_torch.convert.params_from_numpy``, and both models run the same
numpy inputs: the dense ``prefill`` / ``decode_step`` reference and the
serving path's mixed-batch ``step_paged`` (decode lanes, chunks at
q_offset > 0, a fresh chunk and a padded lane in one call).  Float32
configs; tokens must be equal, logits and KV pools within 2e-4 (the fp32
kernel tolerance of tests/test_kernels.py).  JAX's step runs its attention
through the plain jnp oracle (``kernel_mode="ref"``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro_torch import convert
from repro_torch.configs import TRAIN_4K, get_config
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import DenseLM

TOL = dict(rtol=2e-4, atol=2e-4)
KV_HEADS = dict(mha=4, gqa=2)


def _pair(kind, dtype="float32", seed=0):
    n_kv = KV_HEADS[kind]
    jcfg = jax_config("llama3-8b").reduced(dtype=dtype, n_kv_heads=n_kv)
    cfg = get_config("llama3-8b").reduced(dtype=dtype, n_kv_heads=n_kv)
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    tm = get_model(cfg, device="cpu")
    tp = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return cfg, jm, jp, tm, tp


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def test_params_carry_across_with_layout_and_count():
    cfg, jm, jp, tm, tp = _pair("gqa")
    assert tm.param_count() == jm.param_count()
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t = tp
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == tuple(leaf.shape), keys
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_bf16_params_carry_across_bit_exact():
    cfg, jm, jp, tm, tp = _pair("gqa", dtype="bfloat16")
    assert tp["emb"].dtype == torch.bfloat16
    want = np.asarray(jp["blocks"]["wq"]).view(np.uint16)
    got = tp["blocks"]["wq"].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_prefill_and_decode_match_jax(kind):
    cfg, jm, jp, tm, tp = _pair(kind)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 13),
                                             dtype=np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for side in ("k", "v"):
        np.testing.assert_allclose(_np(tc[side]), np.asarray(jc[side]), **TOL)
    jc, tc = jm.grow_cache(jc, 4), tm.grow_cache(tc, 4)
    decode = jax.jit(jm.decode_step)
    for _ in range(3):
        jn = jnp.argmax(jl[:, :cfg.vocab], -1).astype(jnp.int32)
        tn = torch.argmax(tl[:, :cfg.vocab], -1).to(torch.int32)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jl, jc = decode(jp, jc, jn)
        tl, tc = tm.decode_step(tp, tc, tn)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def _mixed_steps(cfg, page=8, n_pages=16, seed=2):
    """Two step_paged calls' inputs over one pool: step 1 prefills lanes 0
    and 1 (lanes 2 and 3 padded); step 2 mixes a decode lane (0), a chunk
    at q_offset 6 (1), a fresh chunk (2) and a padded lane (3)."""
    rng = np.random.default_rng(seed)
    L = cfg.n_layers
    perm = rng.permutation(n_pages)
    pages = {0: list(perm[0:2]), 1: list(perm[2:4]), 2: list(perm[4:5])}
    plans = [
        {0: (0, 11), 1: (0, 6)},                   # lane: (q_offset, q_len)
        {0: (11, 1), 1: (6, 5), 2: (0, 7)},
    ]
    steps = []
    for plan in plans:
        Sq = max(n for _, n in plan.values())
        Sq = 1 << (Sq - 1).bit_length()
        B, T = 4, 2
        ids = np.zeros((B, Sq), np.int32)
        qoff = np.zeros((B,), np.int32)
        ctx = np.zeros((B,), np.int32)
        last = np.zeros((B,), np.int32)
        tables = np.zeros((L, B, T), np.int32)
        sp = np.full((L, B, Sq), n_pages, np.int32)      # trash page
        so = np.zeros((L, B, Sq), np.int32)
        for b, (o, n) in plan.items():
            ids[b, :n] = rng.integers(0, cfg.vocab, n)
            qoff[b], ctx[b], last[b] = o, o + n, n - 1
            w = -(-(o + n) // page)
            pg = np.asarray(pages[b][:w], np.int32)
            tables[:, b, :w] = pg
            tables[:, b, w:] = pg[-1]
            pos = o + np.arange(n)
            sp[:, b, :n] = pg[pos // page]
            so[:, b, :n] = pos % page
        steps.append((ids, tables, qoff, ctx, last, sp, so))
    return steps


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_step_paged_mixed_batch_matches_jax(kind):
    cfg, jm, jp, tm, tp = _pair(kind)
    page, n_pages = 8, 16
    shape = (cfg.n_layers, n_pages + 1, page, cfg.n_kv_heads, cfg.d_head)
    jk = jnp.zeros(shape, jnp.float32)
    jv = jnp.zeros(shape, jnp.float32)
    tk = torch.zeros(shape)
    tv = torch.zeros(shape)
    for ids, tables, qoff, ctx, last, sp, so in _mixed_steps(cfg, page,
                                                             n_pages):
        jt, jl, jk, jv = jm.step_paged(
            jp, jnp.asarray(ids), jk, jv, jnp.asarray(tables),
            jnp.asarray(qoff), jnp.asarray(ctx), jnp.asarray(last),
            jnp.asarray(sp), jnp.asarray(so), kernel_mode="ref")
        tt, tl = tm.step_paged(
            tp, torch.from_numpy(ids), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(qoff), torch.from_numpy(ctx),
            torch.from_numpy(last), torch.from_numpy(sp),
            torch.from_numpy(so))
        live = ctx > 0
        np.testing.assert_array_equal(tt.numpy()[live], np.asarray(jt)[live])
        np.testing.assert_allclose(_np(tl)[live], np.asarray(jl)[live], **TOL)
        # every real page matches; the trash page (index n_pages) is
        # written in an undefined order and never read
        np.testing.assert_allclose(_np(tk)[:, :n_pages],
                                   np.asarray(jk)[:, :n_pages], **TOL)
        np.testing.assert_allclose(_np(tv)[:, :n_pages],
                                   np.asarray(jv)[:, :n_pages], **TOL)
    assert tm.paged_compile_counts()["step"] == 2


def test_fork_paged_copies_pages_in_place_like_jax():
    cfg, jm, jp, tm, tp = _pair("gqa")
    rng = np.random.default_rng(4)
    shape = (cfg.n_layers, 9, 8, cfg.n_kv_heads, cfg.d_head)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    li = np.array([0, 1, 0, 0], np.int32)
    src = np.array([2, 3, 8, 8], np.int32)          # pad rows: trash -> trash
    dst = np.array([5, 6, 8, 8], np.int32)
    jk, jv = jm.fork_paged(jnp.asarray(k), jnp.asarray(v), jnp.asarray(li),
                           jnp.asarray(src), jnp.asarray(dst))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    ptr = tk.data_ptr()
    tm.fork_paged(tk, tv, torch.from_numpy(li), torch.from_numpy(src),
                  torch.from_numpy(dst))
    assert tk.data_ptr() == ptr                     # in place: pool stays 1x
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_default_device_is_the_card():
    cfg = get_config("llama3-8b").reduced(dtype="float32")
    if torch.cuda.is_available():
        assert DenseLM(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            DenseLM(cfg)
    assert DenseLM(cfg, device="cpu").device.type == "cpu"


def _finite_loss(model, params):
    """`loss` on a small seeded batch of the model's family: a finite 0-d
    float32 tensor."""
    cfg = model.cfg
    rng = np.random.default_rng(0)
    batch = dict(targets=rng.integers(0, cfg.vocab, (2, 16)))
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(2, 16, cfg.d_frontend)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (2, 16))
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(2, cfg.n_patches, cfg.d_frontend)).astype(np.float32)
    loss = model.loss(params, batch)
    return loss.shape == () and loss.dtype == torch.float32 \
        and bool(torch.isfinite(loss))


@pytest.mark.parametrize("arch,cls", [
    ("phi-3-vision-4.2b", "DenseLM"), ("qwen3-moe-30b-a3b", "MoELM"),
    ("seamless-m4t-medium", "EncDecLM")])
def test_vlm_moe_encdec_resolve_to_their_models(arch, cls):
    """The vlm family resolves to `DenseLM` (with ``patch_proj``), moe to
    `MoELM` (its router float32 in every dtype), encdec to `EncDecLM`; at
    full size on the meta device for their counts, as the JAX package's.
    Their training loss is a finite scalar; the dry-run entry point gives
    meta tensors."""
    assert type(get_model(get_config(arch), device="meta")).__name__ == cls
    cfg = get_config(arch).reduced(dtype="bfloat16")
    model = get_model(cfg, device="cpu")
    assert type(model).__name__ == cls
    params = model.init(torch.Generator().manual_seed(0))
    if cfg.family == "vlm":
        assert tuple(params["patch_proj"].shape) == (cfg.d_frontend,
                                                     cfg.d_model)
    if cfg.family == "moe":
        assert params["blocks"]["router"].dtype == torch.float32
        assert "w1" not in params["blocks"]
    if cfg.family == "encdec":
        assert {"enc", "dec", "frame_proj"} <= set(params)
    assert _finite_loss(model, params)
    _meta_specs(model)


def test_xlstm_resolves_to_xlstmlm():
    """The xlstm family is ported: it resolves to `XLSTMLM`, which has no
    paged KV; its training loss is a finite scalar, and its dry-run entry
    point gives meta tensors."""
    from repro_torch.models.xlstm import XLSTMLM
    model = get_model(get_config("xlstm-1.3b").reduced(dtype="float32"),
                      device="cpu")
    assert isinstance(model, XLSTMLM) and not model.has_attn
    assert _finite_loss(model, model.init(torch.Generator().manual_seed(0)))
    _meta_specs(model)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-2.7b"])
def test_recurrent_families_resolve_to_zamba2lm(arch):
    """The hybrid and mamba2 families are ported: both resolve to
    `Zamba2LM` (the shared attention blocks only for the hybrid); its
    training loss is a finite scalar, and its dry-run entry point gives
    meta tensors."""
    from repro_torch.models.mamba2 import Zamba2LM
    cfg = get_config(arch).reduced(dtype="float32")
    model = get_model(cfg, device="cpu")
    assert isinstance(model, Zamba2LM)
    assert model.has_attn == (cfg.family == "hybrid")
    assert _finite_loss(model, model.init(torch.Generator().manual_seed(0)))
    _meta_specs(model)


def _meta_specs(model):
    """The train cell's inputs: meta tensors of the global batch, the
    targets int32 (tests/test_torch_dryrun.py holds every cell to JAX's)."""
    specs = model.input_specs(TRAIN_4K)
    assert specs["targets"].dtype == torch.int32
    assert specs["targets"].shape[0] == TRAIN_4K.global_batch
    assert all(t.device.type == "meta" for t in specs.values())


def test_init_draws_the_jax_scales():
    cfg = get_config("llama3-8b").reduced(dtype="float32", d_model=256)
    p = DenseLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert abs(p["emb"].std().item() - 0.02) < 2e-3
    assert abs(p["blocks"]["wq"].std().item() - 256 ** -0.5) < 5e-3
    assert torch.equal(p["blocks"]["ln1"], torch.ones_like(p["blocks"]["ln1"]))
