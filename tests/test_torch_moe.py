"""The port's MoE FFN (``MoELM._ffn``) against the JAX package's, on the same
weights and inputs.

Settings, each on one layer of a reduced config (8 experts, top-2, 64 wide):

* ``overflow``: capacity_factor 0.5 (C = 8 for 16 assignments an expert on
  average), so experts overflow.  This holds the reference's dump: every
  dropped assignment writes the dump row into (expert, C - 1), the cell of
  the expert's last kept one, and JAX's scatter keeps the last write, so
  that token loses this expert's output (ROADMAP §C);
* ``two_groups``: S0 = 4096, two dispatch groups of 2048 tokens;
* ``bfloat16``: the model dtype bf16 (``einsum32`` returns float32; the
  output is bf16);
* ``ties``: a zero router, every probability equal: top-k takes the lower
  experts first, as ``lax.top_k`` does.

Output within 1e-5 of max |JAX| in float32 (the port sums each token's
experts in the order of JAX's scatter-add) and 1e-2 in bf16; the aux loss
within 1e-6 relative.  Then the expert padding, the capacity, the router's
float32 leaf through the converter, and the dispatch counts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models.registry import get_model

SETTINGS = dict(                  # dtype, capacity factor, B, S0, zero router
    overflow=("float32", 0.5, 2, 64, False),
    two_groups=("float32", None, 1, 4096, False),
    bfloat16=("bfloat16", 0.5, 2, 64, False),
    ties=("float32", None, 2, 16, True),
)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _cf(cfg, cf):
    if cf is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _pair(arch, dtype, cf):
    jcfg = _cf(jax_config(arch).reduced(dtype=dtype), cf)
    cfg = _cf(get_config(arch).reduced(dtype=dtype), cf)
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = get_model(cfg, device="cpu")
    tp = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return cfg, jm, jp, tm, tp


def _layer(params, zero_router):
    w = {k: v[0] for k, v in params["blocks"].items()}
    if zero_router:
        w["router"] = w["router"] * 0
    return w


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_ffn_matches_jax(arch, setting):
    dtype, cf, B, S0, zero = SETTINGS[setting]
    cfg, jm, jp, tm, tp = _pair(arch, dtype, cf)
    x = np.random.default_rng(3).normal(size=(B, S0, cfg.d_model))
    jx = jnp.asarray(x.astype(np.float32), jnp.dtype(dtype))
    jo, ja = jax.jit(jm._ffn)(jx, _layer(jp, zero))
    tx = convert._tensor(np.asarray(jx), tm.dtype, torch.device("cpu"))
    to, ta = tm._ffn(tx, _layer(tp, zero))
    assert to.dtype == tx.dtype and tuple(to.shape) == tuple(jo.shape)
    want = np.asarray(jo.astype(jnp.float32))
    err = np.abs(to.float().numpy() - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), err
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    stats = tm.route_stats(tx, _layer(tp, zero))
    assert stats["assignments"] == B * S0 * cfg.moe.top_k
    if setting in ("overflow", "bfloat16"):
        assert stats["dropped"] > 0 and stats["dumped"] > 0, stats
    else:
        assert stats["dropped"] == stats["dumped"] == 0, stats


def test_einsum32_accumulates_and_returns_float32():
    a = torch.full((4, 256), 1.0 / 3, dtype=torch.bfloat16)
    b = torch.ones((256, 2), dtype=torch.bfloat16)
    out = L.einsum32("ik,kj->ij", a, b)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, a.float() @ b.float())


@pytest.mark.parametrize("arch,e_pad", [("granite-moe-3b-a800m", 48),
                                        ("qwen3-moe-30b-a3b", 128)])
def test_expert_padding_and_capacity_match_jax(arch, e_pad):
    tm = get_model(get_config(arch), device="meta")
    jm = jax_model(jax_config(arch))
    assert tm.e_pad == jm.e_pad == e_pad
    for s in (1, 7, 512, 2048):
        assert tm._capacity(s) == jm._capacity(s)


def test_router_stays_float32_through_the_converter():
    cfg, jm, jp, tm, tp = _pair("qwen3-moe-30b-a3b", "bfloat16", None)
    assert tp["blocks"]["router"].dtype == torch.float32
    assert tp["blocks"]["we1"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["blocks"]["router"].numpy(),
                                  np.asarray(jp["blocks"]["router"]))
    assert tm.param_count() == jm.param_count()
