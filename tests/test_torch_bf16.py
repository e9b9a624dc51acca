"""The port against the JAX package in bfloat16, for the families that carry
attention: dense llama (MHA and GQA), the zamba2 hybrid, and mamba2 beside
them; phi-3-vision (vlm), qwen3-moe (moe) and seamless-m4t (encdec) through
their prefill and decode steps.

The float32 twins (tests/test_torch_model.py, tests/test_torch_recurrent.py)
hold tokens and values to 2e-4, but a bf16 cast or promotion fault (a
cache or pool left in float32, a norm computed in bf16) does not show in
float32.  Here the same reduced configs run in bf16 on the
same JAX-initialised weights (tests/_torch_twin.py) and the same numpy
inputs through both packages, JAX's attention on its jnp oracle
(``kernel_mode="ref"``): the dense prefill of two prompts and three
decode steps, and the fused serving steps (``step_paged`` for dense, whose
tokens must be equal; ``step_slots`` for the recurrent families).  Every
logit, cache and pool must have JAX's dtype; values are held as
max |port - JAX| over max |JAX|.  The dense bf16 prefill is the function
the prefill kernel computes on the card.

Limits.  Measured gaps (printed with ``-s``): logits 1.3e-2 to 3.8e-2 of
their largest value (the hybrid's prefill and decode the largest), caches
and pools 1.1e-2 to 2.7e-2 — the floor of two frameworks rounding bf16 at
different places (XLA's CPU bf16 products are not always exactly rounded).
Logits are held to 5e-2 and states to 4e-2.  What that catches, by faults
planted in a copy of the port: a cache or logits in float32 where JAX has
bf16 (the dtype checks), RMSNorm computed in bf16 (the hybrid's gaps reach
5.6e-2).  What it does not: one extra bf16 rounding of an intermediate
(attention scores, the SSM state, the SSM output before its projection)
stays inside the floor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twin import recurrent_twins, same_weights, twins
from test_torch_archs import _jax_grow
from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from test_torch_model import _mixed_steps
from test_torch_recurrent import _slot_batch

LOGITS = 5e-2
STATES = 4e-2
FAMILIES = dict(mha=twins, gqa=twins, mamba2=recurrent_twins,
                hybrid=recurrent_twins)


def _pkgs(kind):
    return FAMILIES[kind](kind, 0, "bfloat16")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want):
    """max |got - want| over max |want|, both read as float32."""
    g, w = _f32(got), _f32(want)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _dtype(a):
    return str(a.dtype).split(".")[-1]


def _t(a):
    return torch.from_numpy(np.asarray(a))


class Gaps:
    """Dtypes asserted equal at once; value gaps collected, held at the
    end against their limit."""

    def __init__(self, label):
        self.label, self.logits, self.states = label, [], []

    def hold(self, name, got, want, states=False):
        assert _dtype(got) == _dtype(want), (name, got.dtype, want.dtype)
        assert tuple(got.shape) == tuple(want.shape), name
        (self.states if states else self.logits).append((name, _rel(got,
                                                                    want)))

    def check(self):
        worst = {k: max(v for _, v in g) for k, g in
                 (("logits", self.logits), ("states", self.states)) if g}
        print(f"bf16 {self.label} gaps: {worst}")
        for name, gap in self.logits:
            assert gap <= LOGITS, (name, gap)
        for name, gap in self.states:
            assert gap <= STATES, (name, gap)


def _cache_names(tpkg):
    if tpkg.cfg.family == "dense":
        return ("k", "v")
    names = ("conv", "ssm")
    return names + (("attn_k", "attn_v") if tpkg.model.has_attn else ())


@pytest.mark.parametrize("kind", ["mha", "gqa", "mamba2", "hybrid"])
def test_bf16_prefill_and_decode_match_jax(kind):
    """The dense prefill of two 40-token prompts, then three decode steps
    on the same (random) tokens in both packages: logits and every cache
    entry after each call."""
    jpkg, tpkg = _pkgs(kind)
    cfg = tpkg.cfg
    gaps = Gaps(f"{kind} prefill/decode")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    jl, jc = jax.jit(jpkg.model.prefill)(jpkg.params, jnp.asarray(toks))
    tl, tc = tpkg.model.prefill(tpkg.params, _t(toks))

    def hold(step):
        gaps.hold(f"{step} logits", tl, jl)
        for name in _cache_names(tpkg):
            gaps.hold(f"{step} {name}", tc[name], jc[name], states=True)
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jc["len"]))

    hold("prefill")
    jc, tc = jpkg.model.grow_cache(jc, 3), tpkg.model.grow_cache(tc, 3)
    decode = jax.jit(jpkg.model.decode_step)
    for i in range(3):
        nxt = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
        jl, jc = decode(jpkg.params, jc, jnp.asarray(nxt))
        tl, tc = tpkg.model.decode_step(tpkg.params, tc, _t(nxt))
        hold(f"decode {i}")
    gaps.check()


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "qwen3-moe-30b-a3b",
                                  "seamless-m4t-medium"])
def test_bf16_vlm_moe_encdec_prefill_and_decode_match_jax(arch):
    """The vlm (with patch embeddings), moe and encdec families: the dense
    prefill of two prompts, then three decode steps on the same tokens in
    both packages; logits and every cache entry (the encoder's cross K/V
    too) after each call.

    The moe family's routing is discontinuous: where two router
    probabilities are within the bf16 noise of the two frameworks (this
    input has two tokens at layer 1 whose second and third probabilities
    differ by 1.1e-5 and 2.9e-5), the packages pick different experts and
    the following layers' states differ by up to a third of their largest
    value.  So for moe the values held are each FFN call's, on the port's
    own input of that call (every layer of the prefill and of the decode
    steps): JAX's ``_ffn`` on the same bf16 input within the logits limit,
    with the same dtype; the end-to-end logits and caches are held by
    dtype and shape."""
    jm, jp, tm, tp = same_weights(jconfigs.get_config(arch).reduced(
        dtype="bfloat16"), tconfigs.get_config(arch).reduced(
        dtype="bfloat16"), 0)
    cfg = tm.cfg
    gaps = Gaps(f"{arch} prefill/decode")
    moe = cfg.family == "moe"
    ffn_calls = []
    if moe:
        ffn = tm._ffn

        def recorded(x, w):
            out = ffn(x, w)
            ffn_calls.append((x, w, out[0]))
            return out
        tm._ffn = recorded
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    if cfg.family == "vlm":
        extra = rng.normal(size=(2, cfg.n_patches, cfg.d_frontend))
    else:
        extra = rng.normal(size=(2, 24, cfg.d_frontend))
    jx = jnp.asarray(extra.astype(np.float32), jnp.bfloat16)
    tx = _t(extra.astype(np.float32)).to(torch.bfloat16)
    if cfg.family == "encdec":
        jl, jc = jax.jit(jm.prefill)(jp, jx, jnp.asarray(toks))
        tl, tc = tm.prefill(tp, tx, _t(toks))
    elif cfg.family == "vlm":
        jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks), jx)
        tl, tc = tm.prefill(tp, _t(toks), tx)
    else:
        jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks))
        tl, tc = tm.prefill(tp, _t(toks))
    names = [k for k in ("k", "v", "xk", "xv") if k in jc]

    def hold(step):
        for name, got, want in [("logits", tl, jl)] + [
                (n, tc[n], jc[n]) for n in names]:
            if moe:
                assert _dtype(got) == _dtype(want), name
                assert tuple(got.shape) == tuple(want.shape), name
            else:
                gaps.hold(f"{step} {name}", got, want,
                          states=name != "logits")
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jc["len"]))

    hold("prefill")
    jc, tc = _jax_grow(jm, cfg, jc, 3), tm.grow_cache(tc, 3)
    decode = jax.jit(jm.decode_step)
    for i in range(3):
        nxt = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, _t(nxt))
        hold(f"decode {i}")
    if moe:
        del tm._ffn
        jffn = jax.jit(jm._ffn)
        assert len(ffn_calls) == 4 * cfg.n_layers
        for n, (x, w, out) in enumerate(ffn_calls):
            l = n % cfg.n_layers
            want, _ = jffn(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                           {k: v[l] for k, v in jp["blocks"].items()})
            gaps.hold(f"ffn call {n}", out, want)
    gaps.check()


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_bf16_step_paged_matches_jax(kind):
    """Two fused dense serving steps over one bf16 pool (a decode lane, a
    chunk at q_offset > 0, a fresh chunk, a padded lane): the tokens and
    logits of live lanes and every real page (the trash page is written in
    an undefined order and never read)."""
    jpkg, tpkg = _pkgs(kind)
    cfg, n_pages, page = tpkg.cfg, 16, 8
    gaps = Gaps(f"{kind} step_paged")
    shape = (cfg.n_layers, n_pages + 1, page, cfg.n_kv_heads, cfg.d_head)
    jk = jnp.zeros(shape, jnp.bfloat16)
    jv = jnp.zeros(shape, jnp.bfloat16)
    tk = torch.zeros(shape, dtype=torch.bfloat16)
    tv = torch.zeros(shape, dtype=torch.bfloat16)
    for n, (ids, tables, qoff, ctx, last, sp, so) in enumerate(
            _mixed_steps(cfg, page, n_pages)):
        jt, jl, jk, jv = jpkg.model.step_paged(
            jpkg.params, *(jnp.asarray(a) for a in (ids,)), jk, jv,
            *(jnp.asarray(a) for a in (tables, qoff, ctx, last, sp, so)),
            kernel_mode="ref")
        tt, tl = tpkg.model.step_paged(
            tpkg.params, _t(ids), tk, tv,
            *(_t(a) for a in (tables, qoff, ctx, last, sp, so)))
        live = ctx > 0
        np.testing.assert_array_equal(tt.numpy()[live], np.asarray(jt)[live])
        gaps.hold(f"step {n} logits", tl[live], np.asarray(jl)[live])
        gaps.hold(f"step {n} k pool", tk[:, :n_pages],
                  jk[:, :n_pages], states=True)
        gaps.hold(f"step {n} v pool", tv[:, :n_pages],
                  jv[:, :n_pages], states=True)
    gaps.check()


@pytest.mark.parametrize("family", ["mamba2", "hybrid"])
def test_bf16_step_slots_matches_jax(family):
    """One fused recurrent serving step (two decode lanes, two chunks, four
    padded lanes on the trash slot; for the hybrid, per-application paged
    KV at q_offset > 0): logits of the real lanes, every pool row outside
    the trash slot and the trash page."""
    jpkg, tpkg = _pkgs(family)
    tm = tpkg.model
    gaps = Gaps(f"{family} step_slots")
    b = _slot_batch(tpkg.cfg, tm, np.random.default_rng(31))
    tpools = {"conv": _t(b["pools"]["conv"]).to(tm.dtype),
              "ssm": _t(b["pools"]["ssm"])}
    kw = {}
    if tm.has_attn:
        kw = dict(k_pool=_t(b["k_pool"]).to(tm.dtype),
                  v_pool=_t(b["v_pool"]).to(tm.dtype), tables=_t(b["tables"]),
                  q_offsets=_t(b["qoff"]), ctx_lens=_t(b["ctx"]),
                  slot_pages=_t(b["pg"]), slot_offs=_t(b["off"]))

    def jax_of(t):
        return jnp.asarray(t.float().numpy()).astype(_dtype(t))

    args = [jpkg.params, jnp.asarray(b["ids"]),
            {k: jax_of(v) for k, v in tpools.items()},
            *(jnp.asarray(b[k]) for k in ("slots", "n_valid", "last"))]
    if tm.has_attn:
        args += [jax_of(kw["k_pool"]), jax_of(kw["v_pool"])] + [
            jnp.asarray(b[k]) for k in ("tables", "qoff", "ctx", "pg", "off")]
    out = jpkg.model.step_slots(*args, kernel_mode="ref")
    _, tl = tm.step_slots(tpkg.params, _t(b["ids"]), tpools, _t(b["slots"]),
                          _t(b["n_valid"]), _t(b["last"]), **kw)
    gaps.hold("logits", tl[:4], out[1][:4])
    for k, v in tpools.items():
        gaps.hold(k, v[:, :-1], out[2][k][:, :-1], states=True)
    if tm.has_attn:
        gaps.hold("k pool", kw["k_pool"][:, :-1], out[3][:, :-1],
                  states=True)
        gaps.hold("v pool", kw["v_pool"][:, :-1], out[4][:, :-1],
                  states=True)
    gaps.check()
