"""Every registered architecture through the port, as tests/test_smoke_archs.py
takes it through the JAX package, and the vlm, moe and encdec families
against the JAX package on the same weights.

* the registry resolves every config at full size (on the meta device) to a
  model whose analytic ``param_count`` and ``active_param_count`` equal the
  JAX model's and fit the size its name advertises;
* on reduced configs ``init`` draws finite weights whose count is the
  analytic one (within JAX's 1 % slack: MoE expert padding);
* a prefill then two decode steps stay finite, and a decode step after a
  prefill of n tokens gives the logits of a prefill of n + 1 (the JAX test's
  tolerance, 0.15, in the reduced configs' bfloat16);
* phi-3-vision (with patch embeddings), granite-moe, qwen3-moe and
  seamless-m4t in float32 on JAX-initialised weights (carried across by
  ``convert.params_from_numpy``): the prefill logits, the caches and three
  decode steps within 1e-4 of max |JAX|, and eight greedy tokens equal;
* phi-3-vision served text-only through ``make_backend`` (`RealBackend` in
  both packages) with a preemption: the JAX backend's tokens and the dense
  recompute's.

On CPU tensors the port's prefill takes the prefill kernel's plain version.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twin import recompute, turns, vlm_twins
from repro.configs import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.registry import get_model
from test_torch_tiers import _serve

A9 = ["phi-3-vision-4.2b", "granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
      "seamless-m4t-medium"]
REL = 1e-4


def _inputs(cfg, rng, B, S, src=None):
    """(tokens, extra): extra is the patches (vlm) or frames (encdec) as
    float32 numpy, or None."""
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extra = None
    if cfg.family == "vlm":
        extra = rng.normal(size=(B, cfg.n_patches, cfg.d_frontend))
    elif cfg.family == "encdec":
        extra = rng.normal(size=(B, src or S, cfg.d_frontend))
    return toks, None if extra is None else extra.astype(np.float32)


def _prefill(model, params, cfg, toks, extra):
    """The port's prefill of ``toks`` (and the family's extra input)."""
    t = torch.from_numpy(toks)
    if cfg.family == "vlm":
        return model.prefill(params, t, torch.from_numpy(extra))
    if cfg.family == "encdec":
        return model.prefill(params, torch.from_numpy(extra), t)
    return model.prefill(params, t)


def _jax_prefill(jm, jp, cfg, toks, extra):
    t = jnp.asarray(toks)
    if cfg.family == "vlm":
        return jax.jit(jm.prefill)(jp, t, jnp.asarray(extra))
    if cfg.family == "encdec":
        return jax.jit(jm.prefill)(jp, jnp.asarray(extra), t)
    return jax.jit(jm.prefill)(jp, t)


def _jax_grow(jm, cfg, cache, extra):
    if cfg.family != "encdec":
        return jm.grow_cache(cache, extra)
    S = cache["k"].shape[2]
    big = jm.init_cache(cache["k"].shape[1], S + extra)
    for key in ("k", "v"):
        big[key] = big[key].at[:, :, :S].set(cache[key])
    big.update(xk=cache["xk"], xv=cache["xv"], len=cache["len"])
    return big


def _finite(t):
    return bool(torch.isfinite(t.float()).all())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_registry_resolves_config(arch):
    cfg = get_config(arch)
    model = get_model(cfg, device="meta")
    jm = jax_model(jax_config(arch))
    n = model.param_count()
    assert n == jm.param_count()
    assert model.active_param_count() == jm.active_param_count()
    assert 0 < model.active_param_count() <= n
    m = re.search(r"(\d+(?:\.\d+)?)b(?:-|$)", arch)
    if m:
        advertised = float(m.group(1)) * 1e9
        assert 0.5 * advertised <= n <= 1.6 * advertised, (arch, n)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_matches_init(arch):
    cfg = get_config(arch).reduced()
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(params)
    assert leaves and all(_finite(l) for l in leaves), arch
    real = sum(l.numel() for l in leaves)
    assert abs(model.param_count() - real) <= 0.01 * real, (arch, real)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_then_decode(arch):
    cfg = get_config(arch).reduced()
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    B, S = 2, 32
    rng = np.random.default_rng(1)
    toks, extra = _inputs(cfg, rng, B, S)
    logits, cache = _prefill(model, params, cfg, toks, extra)
    assert tuple(logits.shape) == (B, cfg.padded_vocab) and _finite(logits)
    cache = model.grow_cache(cache, 8)
    n0 = int(cache["len"][0])
    new = torch.from_numpy(rng.integers(0, cfg.vocab, (B,)).astype(np.int32))
    for i in range(2):
        logits, cache = model.decode_step(params, cache, new)
        assert tuple(logits.shape) == (B, cfg.padded_vocab)
        assert _finite(logits), arch
        assert int(cache["len"][0]) == n0 + i + 1


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_matches_prefill(arch):
    """Prefill(n + 1 tokens) last logits == prefill(n) + decode_step(token
    n): continuing from cached state equals recomputing."""
    cfg = get_config(arch).reduced()
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(2))
    S = 16
    toks, extra = _inputs(cfg, np.random.default_rng(2), 1, S + 1, src=8)
    full, _ = _prefill(model, params, cfg, toks, extra)
    part, cache = _prefill(model, params, cfg, toks[:, :S], extra)
    cache = model.grow_cache(cache, 4)
    step, _ = model.decode_step(params, cache, torch.from_numpy(toks[:, S]))
    np.testing.assert_allclose(step.float().numpy(), full.float().numpy(),
                               rtol=0.15, atol=0.15)


def _rel(got, want):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


@pytest.mark.parametrize("arch", A9)
def test_float32_matches_jax(arch):
    """Prefill, caches and three decode steps within 1e-4 of max |JAX|;
    then eight greedy tokens of both packages equal."""
    jcfg = jax_config(arch).reduced(dtype="float32")
    cfg = get_config(arch).reduced(dtype="float32")
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = get_model(cfg, device="cpu")
    tp = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    toks, extra = _inputs(cfg, np.random.default_rng(7), 2, 13, src=11)
    jl, jc = _jax_prefill(jm, jp, cfg, toks, extra)
    tl, tc = _prefill(tm, tp, cfg, toks, extra)
    assert _rel(tl, jl) <= REL
    for key in ("k", "v", "xk", "xv"):
        if key in jc:
            assert _rel(tc[key], jc[key]) <= REL, key
    jc, tc = _jax_grow(jm, cfg, jc, 8), tm.grow_cache(tc, 8)
    decode = jax.jit(jm.decode_step)
    jtoks, ttoks = [], []
    for i in range(8):
        jn = jnp.argmax(jl[:, :cfg.vocab], -1).astype(jnp.int32)
        tn = torch.argmax(tl[:, :cfg.vocab], -1).to(torch.int32)
        jtoks.append(np.asarray(jn))
        ttoks.append(tn.numpy())
        jl, jc = decode(jp, jc, jn)
        tl, tc = tm.decode_step(tp, tc, tn)
        if i < 3:
            assert _rel(tl, jl) <= REL, i
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_vlm_backend_twin_with_preemption():
    """phi-3-vision served text-only by ``make_backend`` in both packages,
    three turns with a preemption mid-decode of the second: the tokens of
    the JAX backend, of the port's dense recompute, and the counters."""
    jpkg, tpkg = vlm_twins()
    ids = turns(tpkg.cfg, (11, 7, 9), seed=3)
    outs = {}
    for pkg in (jpkg, tpkg):
        _, mgr, be, eng = pkg.node()
        outs[pkg.name] = _serve(pkg, eng, be, ids, preempt_turn=1)
        for a in be.alloc:
            a.check()
        mgr.store.check()
        assert type(be).__name__ == "RealBackend"
        assert be.stats["swaps_out"] >= 1 and be.stats["swaps_in"] >= 1
    assert outs["torch"] == outs["jax"] == recompute(tpkg, ids)
