"""The port's sharding plan, meshes and collectives against the JAX
package's (src/repro/distributed/sharding.py, src/repro/launch/mesh.py).

* every leaf of the abstract parameter tree of every registered config
  (JAX: ``jax.eval_shape`` of ``init``; the port: ``init`` on the meta
  device) gets the same spec from both plans at tp in {2, 4, 8, 16};
* the pool and cache ladder of tests/test_sharded_serving.py;
* ZeRO-1 optimizer, data and logits specs on a (data=2, model=4) debug
  mesh, against JAX's ``make_debug_mesh`` (the root conftest forces 8 host
  devices);
* ``make_serving_mesh`` raises without enough cards unless ``devices=``
  names the placement; ``shard`` / ``unshard`` round trips; the
  collectives and the split-K merge.

A spec compares as a tuple: ``tuple(PartitionSpec(...))`` on the JAX side.
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.distributed.sharding import ShardingPlan as JaxPlan
from repro.launch.mesh import make_debug_mesh as jax_debug_mesh
from repro.models.registry import get_model as jax_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (ShardingPlan, Spec,
                                              mesh_signature, shard, unshard)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (dp_axes, make_debug_mesh,
                                     make_serving_mesh, mp_axis)
from repro_torch.models.registry import get_model

TPS = (2, 4, 8, 16)


def _jax_mesh(tp):
    """A stand-in for a 1-D ("model",) JAX mesh: the plan reads only the
    axis names and the device grid's shape (16 devices are more than the
    forced host count)."""
    return types.SimpleNamespace(axis_names=("model",),
                                 devices=np.empty((tp,), object))


def _cpu_mesh(tp):
    return make_serving_mesh(tp, devices=["cpu"] * tp)


def _jax_leaves(tree):
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(k.key) if hasattr(k, "key") else f"[{k.idx}]"
                for k in path]
        out["/".join(keys)] = (keys[-1], tuple(x.shape))
    return out


def _torch_leaves(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_torch_leaves(v, prefix + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_torch_leaves(v, prefix + (f"[{i}]",)))
    else:
        out["/".join(prefix)] = (prefix[-1], tuple(tree.shape))
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_jax_for_every_leaf(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    jtree = jax.eval_shape(jax_model(jcfg).init, jax.random.key(0))
    ttree = get_model(cfg, device="meta").init(None)
    jl, tl = _jax_leaves(jtree), _torch_leaves(ttree)
    assert jl == tl, "the two parameter trees differ in paths or shapes"
    for tp in TPS:
        jplan = JaxPlan(jcfg, _jax_mesh(tp))
        plan = ShardingPlan(cfg, _cpu_mesh(tp))
        assert plan.tp == tp
        js = jplan.params_specs(jtree)
        ts = plan.params_specs(ttree)
        flat_j = {"/".join(str(k.key) if hasattr(k, "key") else f"[{k.idx}]"
                           for k in path): tuple(s)
                  for path, s in jax.tree_util.tree_flatten_with_path(
                      js, is_leaf=lambda x: isinstance(x, P))[0]}
        flat_t = {}

        def walk(t, pre=()):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, pre + (str(k),))
            elif isinstance(t, list):
                for i, v in enumerate(t):
                    walk(v, pre + (f"[{i}]",))
            else:
                assert isinstance(t, Spec)
                flat_t["/".join(pre)] = t
        walk(ts)
        assert flat_t.keys() == flat_j.keys()
        for path, spec in flat_t.items():
            assert spec == flat_j[path], (arch, tp, path)
            name, shape = tl[path]
            assert spec == tuple(jplan.param_spec(name, shape))


def test_pool_and_cache_ladder_equals_jax():
    """Twin of test_pool_spec_divisibility_ladder: Hkv -> model when
    divisible, else the page-row (split-K) dim, else D, else replicated;
    layer and page-index dims never sharded; the same ladder in
    cache_spec's kv-like branch on a model-only mesh."""
    cfg, jcfg = get_config("llama3-8b"), jax_config("llama3-8b")
    shapes = [(4, 33, 8, 4, 16), (4, 33, 8, 2, 16), (4, 33, 6, 2, 16),
              (4, 33, 6, 2, 6), (32, 65, 16, 4, 128), (32, 65, 16, 8, 128),
              (40, 65, 16, 36, 64), (40, 65, 8, 36, 64)]
    rungs = {}
    for tp in TPS:
        plan = ShardingPlan(cfg, _cpu_mesh(tp))
        jplan = JaxPlan(jcfg, _jax_mesh(tp))
        for s in shapes:
            assert plan.pool_spec(s) == tuple(jplan.pool_spec(s)), (tp, s)
            rungs[(tp, s)] = plan.pool_rung(s)
            cs = (s[0], 1) + s[2:]
            for key in ("k", "v", "xk", "attn_v", "ssm", "len"):
                assert plan.cache_spec(key, cs) == \
                    tuple(jplan.cache_spec(key, cs)), (tp, key, cs)
    assert rungs[(2, (4, 33, 8, 4, 16))] == "heads"
    assert rungs[(4, (4, 33, 8, 2, 16))] == "rows"
    assert rungs[(4, (4, 33, 6, 2, 16))] == "features"
    assert rungs[(4, (4, 33, 6, 2, 6))] == "replicated"
    assert rungs[(8, (32, 65, 16, 4, 128))] == "rows"        # yi-6b, tp 8
    assert rungs[(4, (32, 65, 16, 8, 128))] == "heads"       # llama3-8b
    assert rungs[(16, (40, 65, 8, 36, 64))] == "features"    # minicpm, page 8
    p4 = ShardingPlan(cfg, _cpu_mesh(4))
    assert p4.pool_spec((4, 33, 8, 2, 16)) == P(None, None, "model", None,
                                                None)
    assert p4.cache_spec("k", (4, 1, 8, 2, 16)) == (None, None, "model",
                                                    None, None)


def test_debug_mesh_specs_equal_jax():
    """ZeRO-1, data and logits specs on a (data=2, model=4) mesh."""
    cfg, jcfg = get_config("yi-6b"), jax_config("yi-6b")
    jmesh = jax_debug_mesh(data=2, model=4)
    mesh = make_debug_mesh(2, 4, devices=["cpu"] * 8)
    assert mesh.shape == dict(jmesh.shape)
    assert dp_axes(mesh) == ("data",) and mp_axis(mesh) == "model"
    plan, jplan = ShardingPlan(cfg, mesh), JaxPlan(jcfg, jmesh)
    assert (plan.tp, plan.dp, plan.dp_axes) == (jplan.tp, jplan.dp,
                                                jplan.dp_axes)
    ttree = get_model(cfg, device="meta").init(None)
    specs = plan.params_specs(ttree)
    for name, leaf in ttree["blocks"].items():
        shape = tuple(leaf.shape)
        s = specs["blocks"][name]
        assert s == tuple(jplan.param_spec(name, shape))
        assert plan.opt_spec_from_param(s, shape) == tuple(
            jplan.opt_spec_from_param(P(*s), shape)), name
    for shape in [(), (8,), (8, 4096), (6, 16), (3, 5, 7), (16, 1)]:
        assert plan.data_spec(shape) == tuple(jplan.data_spec(shape)), shape
    for shape in [(8, 64000), (8, 16, 64000), (3, 64000), (8, 100)]:
        assert plan.logits_spec(shape) == tuple(jplan.logits_spec(shape))
    batch = dict(tokens=np.zeros((8, 16)), targets=np.zeros((8, 16)))
    assert plan.batch_specs(batch) == {
        k: tuple(v) for k, v in jplan.batch_specs(batch).items()}


def test_serving_mesh_needs_cards_or_named_devices():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(ValueError, match="0 CUDA devices"):
        make_serving_mesh(2)
    with pytest.raises(ValueError, match="CUDA devices"):
        make_debug_mesh(2, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        make_serving_mesh(2, devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="2 devices needed"):
        make_serving_mesh(2, devices=["cpu"])
    m = make_serving_mesh(4, devices=["cpu"] * 4)
    assert m.tp == 4 and m.shape == {"model": 4}
    assert m.axis_names == ("model",)
    assert all(d == torch.device("cpu") for d in m.devices)


@pytest.mark.parametrize("spec", [Spec(None, "model"), Spec("model", None),
                                  Spec()])
def test_shard_and_unshard_round_trip(spec):
    mesh = _cpu_mesh(4)
    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    parts = shard(t, spec, mesh)
    assert len(parts) == 4
    d = spec.dim_of("model")
    if d is None:
        assert all(p is t for p in parts)      # same device: no copy
    else:
        assert parts[1].shape[d] == t.shape[d] // 4
        assert parts[1].untyped_storage().data_ptr() \
            == t.untyped_storage().data_ptr()   # a view of t
        assert torch.equal(parts[2], t.narrow(d, 2 * t.shape[d] // 4,
                                              t.shape[d] // 4))
    assert torch.equal(unshard(parts, spec), t)
    with pytest.raises(ValueError, match="only the model axis"):
        shard(t, Spec("data", None), mesh)


def test_shard_tree_cuts_each_leaf_by_its_spec():
    cfg = get_config("llama3-8b").reduced(dtype="float32", n_kv_heads=2)
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    plan = ShardingPlan(cfg, _cpu_mesh(4))
    sp = plan.shard_params(params)
    shards, specs = sp.shards, sp.specs
    assert len(shards) == 4
    assert specs == plan.params_specs(params)
    for name in params["blocks"]:
        s = specs["blocks"][name]
        got = unshard([sh["blocks"][name] for sh in shards], s)
        assert torch.equal(got, params["blocks"][name]), name
    assert shards[3]["emb"].shape == (cfg.padded_vocab // 4, cfg.d_model)
    assert shards[1]["blocks"]["wk"].shape[-1] == cfg.kv_dim // 4
    assert shards[1]["blocks"]["ln1"] is params["blocks"]["ln1"]
    assert mesh_signature(plan.mesh, plan.pool_spec((4, 33, 8, 2, 16))) \
        == ((("model", 4),), "Spec(None, None, 'model', None, None)")


def test_collectives_in_shard_order():
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
          for _ in range(4)]
    s = C.all_reduce_sum(xs)
    assert all(t is s[0] for t in s)
    assert torch.equal(s[0], ((xs[0] + xs[1]) + xs[2]) + xs[3])
    m = C.all_reduce_max(xs)
    assert torch.equal(m[2], torch.stack(xs).max(dim=0).values)
    g = C.all_gather(xs, dim=1)
    assert g[0].shape == (3, 20) and torch.equal(g[3][:, 5:10], xs[1])


def test_merge_partials_is_the_full_softmax():
    """Attention over n disjoint key sets merged by their log-sum-exp
    equals the attention over their union (float32, 1e-6); a row that no
    shard saw a key for is zeros, never NaN."""
    rng = np.random.default_rng(1)
    B, Sq, H, D, S, n = 2, 3, 4, 8, 24, 4
    q = torch.from_numpy(rng.normal(size=(B, Sq, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(np.float32))
    s = torch.einsum("bqhd,bkhd->bqhk", q, k)
    s[1, 2] = -torch.inf                          # one row sees no key
    owner = torch.from_numpy(rng.integers(0, n, S))
    owner[:] = torch.where(torch.arange(S) % 5 == 0, 1, owner)
    outs, lses = [], []
    for r in range(n):
        sr = torch.where(owner == r, s, torch.tensor(-torch.inf))
        lse = torch.logsumexp(sr, dim=-1)
        p = torch.where(torch.isfinite(lse)[..., None],
                        torch.exp(sr - torch.where(torch.isfinite(lse), lse,
                                                   0)[..., None]), 0)
        outs.append(torch.einsum("bqhk,bkhd->bqhd", p, v))
        lses.append(lse)
    got = ops.merge_partials(
        *C.gather_partials([o[None] for o in outs], [l[None] for l in lses]),
        torch.float32)
    want = torch.einsum("bqhk,bkhd->bqhd", torch.softmax(s, dim=-1)
                        .nan_to_num(0.0), v)
    assert torch.isfinite(got).all()
    assert torch.equal(got[1, 2], torch.zeros(H, D))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
