"""The port's xLSTM model (`repro_torch.models.xlstm.XLSTMLM`) against the
JAX package's, over the same weights (tests/_torch_twin.py,
``xlstm-1.3b.reduced(dtype="float32")``) and the same numpy inputs, at
2e-4: the chunked mLSTM with and without a carried state and at lengths
that are not a multiple of the chunk, the sLSTM scan with padded steps,
the dense prefill/decode, the fused serving step over more than one chunk,
the parameter count and state shapes at the full config (on the meta
device), the converter's float32 gate biases, and a session exported by
either package's `StateBackend` and imported by the other.  In bf16 (the
served dtype): dtypes equal to JAX's everywhere, the mLSTM projections,
the sLSTM block, the whole model and the serving step against JAX's bf16
model within limits set from measured gaps, the serving step against the
port's own dense prefill, and the state's round trips bit for bit.  The
serving
scenarios (preemption, eviction, spool, crash, batched decode, slot
exhaustion) are the xlstm cases of tests/test_torch_recurrent.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twin import GEN, check_invariants, recompute, recurrent_twins, \
    turns
from repro import configs as jconfigs
from repro.models.registry import get_model as jax_model
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import xlstm as txl
from repro_torch.models.registry import get_model

TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _twins(seed=0):
    return recurrent_twins("xlstm", seed)


def _mlstm_inputs(rng, B, S, NH=2, dqk=16, dv=32, pad_from=None):
    """q, k, v and log gates as the block makes them; lanes padded from
    ``pad_from[b]`` on get the serving step's log_f = 0, log_i = -1e30."""
    q = rng.normal(size=(B, S, NH, dqk)).astype(np.float32)
    k = rng.normal(scale=0.25, size=(B, S, NH, dqk)).astype(np.float32)
    v = rng.normal(size=(B, S, NH, dv)).astype(np.float32)
    log_i = rng.normal(size=(B, S, NH)).astype(np.float32)
    log_f = -np.log1p(np.exp(-rng.normal(2.0, 1.0, (B, S, NH)))
                      ).astype(np.float32)
    if pad_from is not None:
        for b, n in enumerate(pad_from):
            log_f[b, n:] = 0.0
            log_i[b, n:] = -1e30
    return q, k, v, log_i, log_f


def _mlstm_state(rng, B, NH=2, dqk=16, dv=32):
    return (rng.normal(scale=0.3, size=(B, NH, dqk, dv)).astype(np.float32),
            rng.normal(scale=0.3, size=(B, NH, dqk)).astype(np.float32),
            rng.normal(size=(B, NH)).astype(np.float32))


@pytest.mark.parametrize("S", [7, 256, 300, 600])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_jax(S, with_state):
    """The stabilized chunkwise mLSTM (CHUNK = 256): one chunk, exactly
    one, and more than one with an identity-padded tail; fresh or seeded;
    one lane padded from mid-sequence as the serving step pads it."""
    jpkg, tpkg = _twins()
    rng = np.random.default_rng(S + with_state)
    args = _mlstm_inputs(rng, 2, S, pad_from=(S, max(1, S // 2)))
    state = _mlstm_state(rng, 2) if with_state else None
    jh, (jC, jn, jm) = jpkg.model._mlstm_chunked(
        *map(jnp.asarray, args),
        None if state is None else tuple(map(jnp.asarray, state)))
    th, (tC, tn, tm) = tpkg.model._mlstm_chunked(
        *map(_t, args), None if state is None else tuple(map(_t, state)))
    for got, want in ((th, jh), (tC, jC), (tn, jn), (tm, jm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mlstm_step_matches_jax():
    """The recurrent decode step the dense reference takes."""
    jpkg, tpkg = _twins()
    rng = np.random.default_rng(5)
    q, k, v, li, lf = (a[:, 0] for a in _mlstm_inputs(rng, 3, 1))
    state = _mlstm_state(rng, 3)
    jh, jst = jpkg.model._mlstm_step(*map(jnp.asarray, (q, k, v, li, lf)),
                                     tuple(map(jnp.asarray, state)))
    th, tst = tpkg.model._mlstm_step(*map(_t, (q, k, v, li, lf)),
                                     tuple(map(_t, state)))
    for got, want in zip((th, *tst), (jh, *jst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_slstm_scan_with_seq_mask_matches_jax():
    """The sLSTM recurrence over three lanes, two of them padded at the
    end (the carry frozen there, the emitted h not), from a random
    state."""
    jpkg, tpkg = _twins()
    tm = tpkg.model
    rng = np.random.default_rng(11)
    B, S, nh, ph = 3, 9, tm.nh, tm.d_head_s
    gx = rng.normal(size=(B, S, 4, nh, ph)).astype(np.float32)
    gx[:, :, 1] += 3.0                             # forget gates open
    mask = (np.arange(S)[None] < np.array([[9], [4], [1]])).astype(
        np.float32)
    state = (rng.normal(scale=0.3, size=(B, nh, ph)),
             np.abs(rng.normal(size=(B, nh, ph))) + 0.5,
             rng.normal(scale=0.3, size=(B, nh, ph)),
             rng.normal(size=(B, nh, ph)))
    state = tuple(a.astype(np.float32) for a in state)
    jw = {k: v[0] for k, v in jpkg.params["slstm"].items()}
    tw = {k: v[0] for k, v in tpkg.params["slstm"].items()}
    jh, jst = jpkg.model._slstm_scan(jnp.asarray(gx), jw,
                                     tuple(map(jnp.asarray, state)),
                                     jnp.asarray(mask))
    th, tst = tm._slstm_scan(_t(gx), tw, tuple(map(_t, state)), _t(mask))
    for got, want in zip((th, *tst), (jh, *jst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the carry of the lane padded after one step is its first step's
    np.testing.assert_array_equal(tst[2][2].numpy(), th[2, 0].numpy())


def test_prefill_and_decode_logits_match_jax():
    """Dense prefill of two 300-token prompts (two mLSTM chunks) and three
    recurrent decode steps: logits and every cache tensor."""
    jpkg, tpkg = _twins()
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tpkg.cfg.vocab, (2, 300)).astype(np.int32)
    jl, jc = jpkg.model.prefill(jpkg.params, jnp.asarray(toks))
    tl, tc = tpkg.model.prefill(tpkg.params, _t(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in tpkg.model.state_pool_names:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   err_msg=k, **TOL)
    for step in range(3):
        nxt = rng.integers(0, tpkg.cfg.vocab, (2,)).astype(np.int32)
        jl, jc = jpkg.model.decode_step(jpkg.params, jc, jnp.asarray(nxt))
        tl, tc = tpkg.model.decode_step(tpkg.params, tc, _t(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"decode {step}", **TOL)
    assert tc["len"].tolist() == [303, 303]


def test_step_slots_over_two_chunks_matches_jax():
    """One fused serving step whose longest lane (300 tokens) spans two
    mLSTM chunks, beside a decode lane, a 5-token lane and a padded lane
    on the trash slot, over random pools: the real lanes' logits and every
    pool row outside the trash slot."""
    jpkg, tpkg = _twins()
    cfg, tm = tpkg.cfg, tpkg.model
    rng = np.random.default_rng(17)
    n_slots, B, Sq = 3, 4, 300
    n_valid = np.array([300, 1, 5, 0], np.int32)
    slots = np.array([2, 0, 1, n_slots], np.int32)
    last = np.maximum(n_valid - 1, 0).astype(np.int32)
    ids = rng.integers(0, cfg.vocab, (B, Sq)).astype(np.int32)
    pools = {k: rng.normal(scale=0.3, size=tuple(v.shape)).astype(np.float32)
             for k, v in tm.init_slot_pools(n_slots).items()}
    pools["s_n"] = np.abs(pools["s_n"]) + 0.5
    out = jpkg.model.step_slots(
        jpkg.params, jnp.asarray(ids), {k: jnp.asarray(v) for k, v in
                                        pools.items()},
        jnp.asarray(slots), jnp.asarray(n_valid), jnp.asarray(last),
        kernel_mode="ref")
    jtoks, jl, jpools = jax.tree.map(np.asarray, out)
    tpools = {k: _t(v.copy()) for k, v in pools.items()}
    ttoks, tl = tm.step_slots(tpkg.params, _t(ids), tpools, _t(slots),
                              _t(n_valid), _t(last))
    np.testing.assert_allclose(tl[:3].numpy(), jl[:3], **TOL)
    assert ttoks[:3].tolist() == jtoks[:3].tolist()
    for k, v in tpools.items():
        np.testing.assert_allclose(v[:, :n_slots].numpy(),
                                   jpools[k][:, :n_slots], err_msg=k, **TOL)
    assert tm.slot_compile_counts()["slots"] >= 1


def test_full_config_counts_and_state_shapes():
    """At xlstm-1.3b itself (meta device: no weights, no memory): the
    parameter count equals JAX's, the sLSTM FFN is 2752 wide (_round64),
    and the slot pools have JAX's shapes and dtypes, 352 MB of float32
    m_C a session."""
    jm = jax_model(jconfigs.get_config("xlstm-1.3b"))
    cfg = tconfigs.get_config("xlstm-1.3b")
    tm = get_model(cfg, device="meta")
    assert isinstance(tm, txl.XLSTMLM)
    assert tm.param_count() == jm.param_count() == cfg.param_count()
    assert tm.active_param_count() == jm.active_param_count()
    assert tm.d_ffn_s == 2752 and (tm.n_m, tm.n_s) == (42, 6)
    jpools = jax.eval_shape(lambda: jm.init_slot_pools(2))
    tpools = tm.init_slot_pools(2)
    assert set(tpools) == set(jpools) == set(tm.state_pool_names)
    for k, v in tpools.items():
        assert tuple(v.shape) == tuple(jpools[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(jpools[k].dtype), k
    m_c = tpools["m_C"][:, 0].numel() * 4
    assert m_c == 42 * 4 * 512 * 1024 * 4 == 352_321_536


def test_converter_keeps_the_float32_gate_biases():
    """The JAX package keeps b_if and b_ifzo in float32 whatever the model
    dtype; the converter must too (a bf16 bias would shift every gate),
    and cast everything else."""
    jcfg = jconfigs.get_config("xlstm-1.3b").reduced(dtype="bfloat16")
    cfg = tconfigs.get_config("xlstm-1.3b").reduced(dtype="bfloat16")
    jp = jax_model(jcfg).init(jax.random.key(0))
    tp = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    assert set(tp) == {"emb", "ln_f", "lm_head", "mlstm", "slstm"}
    for kind, keep in (("mlstm", "b_if"), ("slstm", "b_ifzo")):
        for k, v in tp[kind].items():
            want = torch.float32 if k == keep else torch.bfloat16
            assert v.dtype == want, (kind, k)
            assert str(jp[kind][k].dtype) == str(want).split(".")[-1], k
        np.testing.assert_array_equal(tp[kind][keep].numpy(),
                                      np.asarray(jp[kind][keep]))
    # the port's own init keeps them float32 too
    own = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert own["mlstm"]["b_if"].dtype == own["slstm"]["b_ifzo"].dtype \
        == torch.float32


def _node(pkg, **kw):
    return pkg.node(**{**dict(n_slots=4, n_pages=32, page_size=8), **kw})


def _serve(pkg, node, sid, turn_ids, now=0.0):
    _, mgr, be, eng = node
    outs = []
    for t in turn_ids:
        req = pkg.Request(session_id=sid, prompt_tokens=len(t),
                          max_new_tokens=GEN, prompt_ids=list(t),
                          cached_tokens=be.session_tokens(sid))
        eng.submit(req)
        while eng.waiting or eng.running:
            now += eng.step(now)
            check_invariants(mgr, be)
        outs.append(list(req.output_ids))
        be.drain_transfers()
    return outs


@pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
def test_xlstm_session_migrates_between_packages(direction):
    """An xlstm session served for one turn by one package's
    `StateBackend`, exported, and imported by the other's serves its next
    turn with the tokens of dense recompute (every state pool carried
    across, the model-dtype conv tail and the float32 rest)."""
    jpkg, tpkg = _twins(3)
    src, dst = (jpkg, tpkg) if direction == "jax->torch" else (tpkg, jpkg)
    t = turns(tpkg.cfg, (11, 8), seed=41)
    a = _node(src)
    got = _serve(src, a, "s0", t[:1])
    tokens = a[2].session_tokens("s0")
    payload = a[2].export_session("s0")
    assert set(payload["state"]) == set(tpkg.model.state_pool_names)
    b = _node(dst)
    b[2].import_session("s0", payload)
    b[1].mark_resident("s0", tokens, b[2].session_kv_bytes(tokens),
                       priority=0)
    got += _serve(dst, b, "s0", t[1:])
    assert b[2].stats["migrations_in"] == 1 and b[2].stats["swaps_in"] == 1
    assert got == recompute(tpkg, t)


def test_reused_slot_starts_from_the_blank_state():
    """On a one-slot node, session b takes the slot session a held (a
    leaves it to admit b): b's state must start from the model's blank
    state (stabilizers m_m and s_m at -1e30), not from zeros, so the
    slot's pools after b's turn equal the JAX backend's (token parity
    alone cannot show it: the xLSTM stabilizers cancel out of h except
    at their clamps)."""
    def scenario(pkg):
        _, mgr, be, eng = _node(pkg, n_slots=1)
        for sid, n in (("a", 7), ("b", 9)):
            ids = turns(pkg.cfg, (n,), seed=n)[0]
            eng.submit(pkg.Request(session_id=sid, prompt_tokens=n,
                                   max_new_tokens=GEN, prompt_ids=ids))
            now = 0.0
            while eng.waiting or eng.running:
                now += eng.step(now)
                check_invariants(mgr, be)
        be.drain_transfers()
        assert be.slots.slot_of("b") == 0 and "a" not in be.slots.seqs
        return {k: np.asarray(v)[:, 0] for k, v in be.pools.items()}

    jpkg, tpkg = _twins(5)
    want, got = scenario(jpkg), scenario(tpkg)
    for k in tpkg.model.state_pool_names:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# bfloat16: the served dtype, against JAX's bf16 XLSTMLM
# ---------------------------------------------------------------------------
#
# bf16 values cannot agree to 2e-4 across packages: XLA's bf16 silu rounds
# x * sigmoid(x) twice where torch rounds once, and its bf16 products are
# not always the exactly rounded ones, so every bf16 tensor differs in the
# last bit here and there, and the exponential gates carry that through
# the stack to a few percent of the largest logit.  So the dtypes are held
# exactly; the float32 paths that see identical bf16 inputs (the sLSTM
# recurrence), the serving step against the port's own prefill at the same
# shapes, and the state's round trips tightly; the rest against limits set
# above the largest gap measured on this model and, where a dtype fault
# moves a value by a bf16 rounding, below it (each test prints its gaps,
# and its docstring gives them).


def _bf16_twins(seed=0):
    return recurrent_twins("xlstm", seed, "bfloat16")


def _rel(got, want):
    """max |got - want| over max |want|, both read as float32."""
    g = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _dtype(a):
    return str(a.dtype).split(".")[-1]


def test_bf16_mlstm_projections_match_jax():
    """`_mlstm_qkvif` on bf16 weights and inputs, continuing a conv window,
    with per-lane valid lengths: every output has JAX's dtype (k is float32
    there: the product is divided by a numpy float32 scalar), v, z and the
    conv tail agree to 2e-3 of their largest value (measured 1.3e-5,
    4.0e-4, 0), the log gates to 2e-3 (measured 8.4e-4 / 1.1e-3; the gate
    bias added in bf16 instead of float32 gives 3.8e-3 / 7.0e-3), q and k,
    which read the silu, to 1.5e-2 (measured 4.2e-3 / 5.6e-3)."""
    jpkg, tpkg = _bf16_twins()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 300, tpkg.cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(3, tpkg.model.d_inner,
                            tpkg.cfg.xlstm.conv_kernel - 1)).astype(
        np.float32)
    nv = np.array([300, 120, 1], np.int32)
    jw = {k: v[0] for k, v in jpkg.params["mlstm"].items()}
    tw = {k: v[0] for k, v in tpkg.params["mlstm"].items()}
    want = jpkg.model._mlstm_qkvif(
        jnp.asarray(x, jnp.bfloat16), jw, jnp.asarray(conv, jnp.bfloat16),
        jnp.asarray(nv))
    got = tpkg.model._mlstm_qkvif(_t(x).bfloat16(), tw, _t(conv).bfloat16(),
                                  _t(nv))
    limit = dict(q=1.5e-2, k=1.5e-2, v=2e-3, log_i=2e-3, log_f=2e-3,
                 z=2e-3, tail=2e-3)
    gaps = {name: _rel(g, w) for name, g, w in zip(limit, got, want)}
    print("bf16 mLSTM projection gaps", gaps)
    for name, g, w in zip(limit, got, want):
        assert _dtype(g) == _dtype(w), name
        assert gaps[name] <= limit[name], (name, gaps[name])


def test_bf16_slstm_block_matches_jax():
    """One sLSTM block on bf16 weights and inputs, two lanes padded: the
    float32 recurrence sees the same bf16 gate inputs in both packages, so
    the carried state agrees to 2e-4 (measured 2.9e-7; the gate bias added
    in bf16 gives 3.7e-3); the bf16 block output's update to 2e-2 of its
    largest value (measured 7.0e-3: one bf16 rounding of x + update)."""
    jpkg, tpkg = _bf16_twins()
    rng = np.random.default_rng(4)
    B, S = 3, 40
    x = rng.normal(size=(B, S, tpkg.cfg.d_model)).astype(np.float32)
    mask = (np.arange(S)[None] < np.array([[40], [17], [1]])).astype(
        np.float32)
    jw = {k: v[0] for k, v in jpkg.params["slstm"].items()}
    tw = {k: v[0] for k, v in tpkg.params["slstm"].items()}
    jx, tx = jnp.asarray(x, jnp.bfloat16), _t(x).bfloat16()
    jo, jst = jpkg.model._slstm_block(jx, jw, seq_mask=jnp.asarray(mask))
    to, tst = tpkg.model._slstm_block(tx, tw, seq_mask=_t(mask))
    assert _dtype(to) == _dtype(jo) == "bfloat16"
    out_gap = _rel(to.float() - tx.float(),
                   np.asarray(jo, np.float32) - np.asarray(jx, np.float32))
    print("bf16 sLSTM block gaps: output", out_gap, "state",
          max(_rel(g, w) for g, w in zip(tst, jst)))
    assert out_gap <= 2e-2
    for g, w in zip(tst, jst):
        assert _dtype(g) == _dtype(w) == "float32"
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("path", ["prefill_decode", "step_slots"])
def test_bf16_model_matches_jax(path):
    """The whole reduced model in bf16: the dense prefill of two 300-token
    prompts and three decode steps, or one fused serving step over random
    pools (a 300-token lane, a decode lane, a 5-token lane, a padded
    lane).  Logits, caches and pools have JAX's dtypes (a conv tail left
    in float32 fails here); logits agree to 5e-2 of their largest value
    (measured 2.0e-2 over prefill and decode, 1.7e-2 for the serving
    step), every state tensor to 1e-1 of its largest (measured 2.6e-2,
    3.2e-2)."""
    jpkg, tpkg = _bf16_twins()
    cfg, tm = tpkg.cfg, tpkg.model
    logit_gaps, state_gaps = [], []

    def hold(tl, jl, tstate, jstate):
        assert _dtype(tl) == _dtype(jl)
        logit_gaps.append(_rel(tl, jl))
        for k in tm.state_pool_names:
            assert _dtype(tstate[k]) == _dtype(jstate[k]), k
            state_gaps.append(_rel(tstate[k], jstate[k]))

    if path == "prefill_decode":
        rng = np.random.default_rng(2)
        toks = rng.integers(0, cfg.vocab, (2, 300)).astype(np.int32)
        jl, jc = jpkg.model.prefill(jpkg.params, jnp.asarray(toks))
        tl, tc = tm.prefill(tpkg.params, _t(toks))
        hold(tl, jl, tc, jc)
        for _ in range(3):
            nxt = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
            jl, jc = jpkg.model.decode_step(jpkg.params, jc, jnp.asarray(nxt))
            tl, tc = tm.decode_step(tpkg.params, tc, _t(nxt))
            hold(tl, jl, tc, jc)
    else:
        rng = np.random.default_rng(17)
        n_slots = 3
        n_valid = np.array([300, 1, 5, 0], np.int32)
        slots = np.array([2, 0, 1, n_slots], np.int32)
        last = np.maximum(n_valid - 1, 0).astype(np.int32)
        ids = rng.integers(0, cfg.vocab, (4, 300)).astype(np.int32)
        pools = {k: rng.normal(scale=0.3, size=tuple(v.shape)).astype(
                     np.float32) for k, v in tm.init_slot_pools(n_slots).items()}
        pools["s_n"] = np.abs(pools["s_n"]) + 0.5
        tpools = {k: _t(v).to(tm.dtype if k == "m_conv" else torch.float32)
                  for k, v in pools.items()}
        jpools = {k: jnp.asarray(v.float().numpy()).astype(_dtype(v))
                  for k, v in tpools.items()}
        _, jl, jpools = jpkg.model.step_slots(
            jpkg.params, jnp.asarray(ids), jpools, jnp.asarray(slots),
            jnp.asarray(n_valid), jnp.asarray(last), kernel_mode="ref")
        _, tl = tm.step_slots(tpkg.params, _t(ids), tpools, _t(slots),
                              _t(n_valid), _t(last))
        real = slice(0, n_slots)
        hold(tl[:3], jl[:3],
             {k: v[:, real] for k, v in tpools.items()},
             {k: v[:, real] for k, v in jpools.items()})
    print(f"bf16 {path} gaps: logits {max(logit_gaps)}, states "
          f"{max(state_gaps)}")
    assert max(logit_gaps) <= 5e-2, logit_gaps
    assert max(state_gaps) <= 1e-1, state_gaps


def test_bf16_step_slots_equals_dense_prefill():
    """Within the port, in bf16: the serving step of one 300-token lane on
    a blank slot gives the logits and the state of the dense prefill of
    the same prompt (the same shapes, so the same bf16 roundings), to 2e-4
    (measured: all equal; a slot write that rounds the float32 state
    through bf16 is off by 3.5e-3 to 2.9e-2)."""
    _, tpkg = _bf16_twins()
    cfg, tm, params = tpkg.cfg, tpkg.model, tpkg.params
    ids = np.random.default_rng(9).integers(0, cfg.vocab, (1, 300)).astype(
        np.int32)
    slot = _t(np.array([1], np.int32))
    pools = tm.init_slot_pools(2)
    tm.scatter_slots(pools, slot, {k: v[:, None] for k, v in
                                   tm.blank_state().items()})
    _, logits = tm.step_slots(params, _t(ids), pools, slot,
                              _t(np.array([300], np.int32)),
                              _t(np.array([299], np.int32)))
    want, cache = tm.prefill(params, _t(ids))
    print("bf16 serving step vs prefill, max abs gaps: logits",
          float((logits.float() - want.float()).abs().max()), {
              k: float((pools[k][:, 1].float() - cache[k][:, 0].float())
                       .abs().max()) for k in tm.state_pool_names})
    np.testing.assert_allclose(logits.float().numpy(),
                               want.float().numpy(), **TOL)
    for k in tm.state_pool_names:
        assert pools[k].dtype == cache[k].dtype, k
        np.testing.assert_allclose(pools[k][:, 1].float().numpy(),
                                   cache[k][:, 0].float().numpy(),
                                   err_msg=k, **TOL)


def _bits(a):
    """The bit patterns of a torch or JAX array (bf16 as uint16)."""
    a = a.view(torch.int16) if isinstance(a, torch.Tensor) and \
        a.dtype == torch.bfloat16 else a
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint16 if a.itemsize == 2 else np.uint32)


def _slot_bits(be, sid):
    slot = be.slots.slot_of(sid)
    return {k: _bits(be.pools[k])[:, slot] for k in be.pools}


@pytest.mark.parametrize("route", ["swap", "spool", "jax->torch",
                                   "torch->jax"])
def test_bf16_state_round_trips_bit_for_bit(route, tmp_path):
    """A bf16 xlstm session's slot state (m_conv in bf16, the rest float32)
    comes back bit for bit after a swap to the host and back, after a
    persist, a crash and the spool's recovery, and after an export by one
    package's `StateBackend` and an import by the other's."""
    jpkg, tpkg = _bf16_twins(7)
    src, dst = (jpkg, tpkg) if route == "jax->torch" else (tpkg, jpkg) \
        if route == "torch->jax" else (tpkg, tpkg)
    a = _node(src, spool_dir=str(tmp_path / "a"))
    _serve(src, a, "s0", turns(src.cfg, (13,), seed=8))
    _, mgr, be, _ = a
    want = _slot_bits(be, "s0")
    tokens = be.session_tokens("s0")
    if route == "swap":
        be.swap_out("s0", tokens)
        be.drain_transfers()
        assert "s0" not in be.slots.seqs
        dst_be = be
    else:
        if route == "spool":
            assert be.persist("s0")
            be.drain_transfers()
            be.crash()
            mgr.crash(now=10.0)
            payload = be.recover_session("s0")
        else:
            payload = be.export_session("s0")
        _, mgr_b, dst_be, _ = _node(dst)
        dst_be.import_session("s0", payload)
        mgr_b.mark_resident("s0", tokens, dst_be.session_kv_bytes(tokens),
                            priority=0)
    assert dst_be.prefetch("s0", [0]) == [0]
    dst_be.drain_transfers()
    got = _slot_bits(dst_be, "s0")
    assert {k: v.dtype for k, v in got.items()} == \
        {k: v.dtype for k, v in want.items()}
    assert got["m_conv"].dtype == np.uint16
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
