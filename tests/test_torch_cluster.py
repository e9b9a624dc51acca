"""The port's cluster runtime against the JAX package's.

Sim mode: the port's `ClusterRuntime` (scheduler, placement policies, node
managers, engines over `SimBackend`) gives JAX's metrics exactly on the
ShareGPT and MetaGPT traces for each of the four policies.  Both runtimes
get one explicit `HardwareSpec`, field by field (the port's defaults are
the H100 data sheet, JAX's a TPU's, so their numbers would differ by
design).

Real mode: twins of tests/test_cluster_runtime.py, of
tests/test_cluster_mixed.py and of the cluster case of
tests/test_prefix_sharing.py.  The port's nodes are torch `RealBackend` /
`StateBackend`s on the CPU, over the JAX package's weights carried across
(tests/_torch_twin.py), on ``.reduced(dtype="float32")`` configs; served
tokens must equal both packages' `dense_reference` exactly.  Step
durations are measured wall time in real mode, so counters that depend on
timing are held to the JAX tests' own bounds, not to JAX's values.
"""
import dataclasses
from types import SimpleNamespace

import pytest

from _torch_twin import V5E, same_weights, twins
from repro import configs as jconfigs
from repro.core import advisory as jadvisory
from repro.core import memory as jmemory
from repro.core import node_manager as jnode_manager
from repro.core import policies as jpolicies
from repro.core import scheduler as jscheduler
from repro.serving import cost_model as jcost_model
from repro.serving import scenario as jscenario
from repro.serving import simulator as jsimulator
from repro.traces import agents as jagents
from repro.traces import sharegpt as jsharegpt
from repro_torch import configs as tconfigs
from repro_torch.core import advisory as tadvisory
from repro_torch.core import memory as tmemory
from repro_torch.core import node_manager as tnode_manager
from repro_torch.core import policies as tpolicies
from repro_torch.core import scheduler as tscheduler
from repro_torch.core.memory import HBM
from repro_torch.serving import cost_model as tcost_model
from repro_torch.serving import scenario as tscenario
from repro_torch.serving import simulator as tsimulator
from repro_torch.serving.backend import RealBackend
from repro_torch.serving.engine import NodeEngine
from repro_torch.traces import agents as tagents
from repro_torch.traces import sharegpt as tsharegpt

PKGS = {
    name: SimpleNamespace(
        configs=c, advisory=a, memory=m, node_manager=nm, policies=po,
        scheduler=sc, cost_model=cm, scenario=scn, simulator=si, agents=ag,
        sharegpt=sg)
    for name, (c, a, m, nm, po, sc, cm, scn, si, ag, sg) in dict(
        jax=(jconfigs, jadvisory, jmemory, jnode_manager, jpolicies,
             jscheduler, jcost_model, jscenario, jsimulator, jagents,
             jsharegpt),
        torch=(tconfigs, tadvisory, tmemory, tnode_manager, tpolicies,
               tscheduler, tcost_model, tscenario, tsimulator, tagents,
               tsharegpt)).items()}
# tests/test_cluster_runtime.py's HW, as explicit fields for both packages
HW = dataclasses.asdict(jcost_model.HardwareSpec(chips_per_replica=2,
                                                 host_dram=64e9))
POLICY_NAMES = ("symphony", "sticky", "stateless", "priority")


def _hw(p, fields=HW):
    return p.cost_model.HardwareSpec(**fields)


def _both(fn):
    """``fn(pkg)`` for the JAX package and the port: {name: result}."""
    return {name: fn(p) for name, p in PKGS.items()}


# --------------- sim mode: the port's metrics are JAX's ---------------------

TRACES = {
    "sharegpt": lambda p: p.sharegpt.ShareGPTTrace(n_users=16,
                                                   n_sessions=40, seed=3),
    "metagpt": lambda p: p.agents.MetaGPTTrace(n_projects=4, seed=3),
}


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_sim_metrics_equal_jax(policy, trace):
    def run(p):
        rt = p.simulator.ClusterRuntime(p.configs.get_config("llama3-8b"),
                                        n_nodes=4, policy=policy, hw=_hw(p))
        res = rt.run(TRACES[trace](p))
        return res.metrics(), res.node_load_samples
    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["completed"] > 0


# --------------- twins of tests/test_cluster_runtime.py ---------------------

def _route_one(p, sched, sid, now):
    req = p.advisory.InferenceRequest(session_id=sid, prompt_tokens=10,
                                      max_new_tokens=5)
    return req, sched.route(req, now)


def test_route_zeroes_cached_tokens_when_kv_lost():
    def run(p):
        sched = p.scheduler.SymphonyScheduler(2, p.policies.POLICIES[
            "symphony"])
        r1, n1 = _route_one(p, sched, "s0", 0.0)
        sched.on_request_complete(r1, 500)
        r2, n2 = _route_one(p, sched, "s0", 1.0)
        cached2 = r2.cached_tokens
        sched.on_request_complete(r2, 515)
        sched.mark_failed(sched.session("s0").kv_node)
        r3, n3 = _route_one(p, sched, "s0", 2.0)
        return (n1, n2, n3, cached2, r3.cached_tokens,
                sched.nodes[n3].alive)
    got = _both(run)
    assert got["torch"] == got["jax"]
    *_, cached2, cached3, alive = got["torch"]
    assert cached2 == 500 and cached3 == 0 and alive


def test_route_keeps_recompute_accounting_for_stateless():
    def run(p):
        sched = p.scheduler.SymphonyScheduler(2, p.policies.POLICIES[
            "stateless"])
        r1, _ = _route_one(p, sched, "s0", 0.0)
        sched.on_request_complete(r1, 500)
        r2, node = _route_one(p, sched, "s0", 1.0)
        return node, r2.cached_tokens
    got = _both(run)
    assert got["torch"] == got["jax"] and got["torch"][1] == 500


def _sim_run(p, fail):
    rt = p.simulator.ClusterRuntime(p.configs.get_config("llama3-8b"),
                                    n_nodes=4, policy="symphony", hw=_hw(p))
    res = rt.run(p.sharegpt.ShareGPTTrace(n_users=64, n_sessions=150, seed=3),
                 fail_node_at=(1, 60.0) if fail else None)
    return rt, res


def test_failure_recovery_pays_its_cost_and_accounting_holds():
    rt0, r0 = _sim_run(PKGS["torch"], False)
    rt1, r1 = _sim_run(PKGS["torch"], True)
    _, j1 = _sim_run(PKGS["jax"], True)
    assert r1.metrics() == j1.metrics()
    assert not rt1.sched.nodes[1].alive
    assert rt1.sched.nodes[1].outstanding == 0
    assert len(r1.completed) >= 0.9 * len(r0.completed)
    m0, m1 = r0.metrics(), r1.metrics()
    assert m1["ttft_mean_s"] >= m0["ttft_mean_s"], (m1, m0)
    assert m1["norm_latency_mean_s"] >= 0.99 * m0["norm_latency_mean_s"]
    recoveries = sum(n["recoveries"] for n in m1["per_node"].values())
    pre0 = sum(e["prefill_tokens"] for e in r0.stats["engine"].values())
    pre1 = sum(e["prefill_tokens"] for e in r1.stats["engine"].values())
    assert recoveries > 0 or pre1 > pre0
    for mgr in rt1.managers.values():
        mgr.store.check()


def test_advisory_promotion_into_full_hbm_is_best_effort_real():
    """The port's RealBackend under a plan the store cannot see is
    fragmented: promotion stops at the first layer that does not fit, and
    the store says HBM exactly where pages exist (JAX's case, same
    weights; JAX's plan is run too and must promote the same layers)."""
    jpkg, tpkg = twins("gqa", 0)

    def run(pkg):
        _, mgr, be, eng = pkg.node(n_pages=16)
        req = pkg.Request("s0", prompt_tokens=12, max_new_tokens=4,
                          prompt_ids=list(range(12)))
        eng.submit(req)
        now = 0.0
        while eng.waiting or eng.running:
            now += eng.step(now)
        be.swap_out("s0", be.session_tokens("s0"))
        be.drain_transfers()
        for l, a in enumerate(be.alloc):
            a.allocate("hog", a.page_size * (a.n_pages - (4 if l == 0
                                                          else 1)))
        mgr.promote("s0", now=1.0)
        e = mgr.store.entries["s0"]
        promoted = [l for l in range(pkg.cfg.n_layers)
                    if e.tier[l] == HBM]
        placed = [(e.tier[l] == HBM) == ("s0" in be.alloc[l].seqs)
                  for l in range(pkg.cfg.n_layers)]
        mgr.store.check()
        for a in be.alloc:
            a.check()
            a.free("hog")
        req2 = pkg.Request("s0", prompt_tokens=4, max_new_tokens=3,
                           prompt_ids=[1, 2, 3, 4],
                           cached_tokens=be.session_tokens("s0"))
        eng.submit(req2)
        while eng.waiting or eng.running:
            now += eng.step(now)
        mgr.store.check()
        return promoted, placed, list(req.output_ids), list(req2.output_ids)

    assert HBM == jmemory.HBM
    got = {pkg.name: run(pkg) for pkg in (jpkg, tpkg)}
    assert got["torch"] == got["jax"]
    promoted, placed, _, out2 = got["torch"]
    assert promoted == [0] and all(placed) and len(out2) == 3


def test_promotion_plan_bounded_by_accounting_sim():
    def run(p):
        cfg = p.configs.get_config("llama3-8b")
        m = p.node_manager.NodeManager(0, cfg, p.cost_model.CostModel(
            cfg, _hw(p)))
        m.store = p.memory.TieredKVStore(hbm_budget=50, host_budget=10_000)
        m.store.admit("a", n_tokens=10, bytes_per_layer=10, n_layers=8,
                      tier="host")
        m.promote("a", now=0.0)
        m.store.check()
        return m.store.hbm_resident_layers("a")
    got = _both(run)
    assert got["torch"] == got["jax"] == 5


def _real_runtime(cfg, model, params, **kw):
    """A real-mode port runtime on the CPU, with the JAX tests' settings
    (v5e cost figures, 48 pages of 8 tokens, batches of 4)."""
    kw = {**dict(max_batch=4), **kw}
    return tsimulator.ClusterRuntime(
        cfg, policy="symphony", hw=tcost_model.HardwareSpec(**V5E),
        mode="real", model=model, params=params, n_pages=48, page_size=8,
        device="cpu", **kw)


def _reduced(name, **kw):
    return (jconfigs.get_config(name).reduced(dtype="float32", **kw),
            tconfigs.get_config(name).reduced(dtype="float32", **kw))


def test_real_cluster_migration_failure_recovery_token_exact():
    """2 sessions on 3 torch RealBackend nodes: the idle node attracts a
    turn-2 advisory (a cross-node migration with real page copies); after
    s0's turn 2 its node is killed (an orphan recovered from the spool).
    Tokens equal the port's and JAX's dense reference exactly."""
    jcfg, cfg = _reduced("llama3-8b")
    jm, jp, tm, tp = same_weights(jcfg, cfg, 1)
    rt = _real_runtime(cfg, tm, tp, n_nodes=3)
    trace = tscenario.MultiTurnRealTrace(cfg, n_sessions=2, n_turns=3,
                                         prompt_len=8, gen=4, seed=5,
                                         fail_after_turn=2)
    jtrace = jscenario.MultiTurnRealTrace(jcfg, n_sessions=2, n_turns=3,
                                          prompt_len=8, gen=4, seed=5)
    assert trace.prompts == jtrace.prompts
    try:
        res = rt.run(trace)
        got = tscenario.session_outputs(res)
        want = tscenario.dense_reference(cfg, tm, tp, trace.prompts, 4)
        assert got == want, (got, want)
        assert want == jscenario.dense_reference(jcfg, jm, jp,
                                                 jtrace.prompts, 4)
        m = res.metrics()
        assert m["mode"] == "real" and m["completed"] == 6
        assert sum(n["migrations"] for n in m["per_node"].values()) >= 1
        assert sum(n["recoveries"] for n in m["per_node"].values()) >= 1
        dead = [i for i, st in rt.sched.nodes.items() if not st.alive]
        assert len(dead) == 1
        assert rt.sched.nodes[dead[0]].outstanding == 0
        for mgr in rt.managers.values():
            mgr.store.check()
        for i in rt.backends:
            if i not in dead:
                for a in rt.backends[i].alloc:
                    a.check()
    finally:
        rt.cleanup()


def test_real_runtime_takes_the_device_it_is_given():
    """Real mode builds every backend on ``device`` (the card by default)
    and refuses a model that lives elsewhere; sim mode has no device."""
    jcfg, cfg = _reduced("llama3-8b")
    _, _, tm, tp = same_weights(jcfg, cfg, 0)
    rt = _real_runtime(cfg, tm, tp, n_nodes=2)
    try:
        assert all(isinstance(be, RealBackend) and be.device.type == "cpu"
                   for be in rt.backends.values())
        assert all(isinstance(e, NodeEngine) for e in rt.engines.values())
    finally:
        rt.cleanup()
    with pytest.raises(ValueError, match="lives on"):
        tsimulator.ClusterRuntime(cfg, n_nodes=2, mode="real", model=tm,
                                  params=tp, device="meta")
    tsimulator.ClusterRuntime(cfg, n_nodes=2)          # sim: no device


@pytest.mark.parametrize("name", ["llama3-8b", "mamba2-2.7b"])
def test_dense_reference_equals_jax(name):
    jcfg, cfg = _reduced(name)
    jm, jp, tm, tp = same_weights(jcfg, cfg, 2)
    trace = tscenario.MultiTurnRealTrace(cfg, n_sessions=2, n_turns=2,
                                         prompt_len=9, gen=5, seed=4)
    got = tscenario.dense_reference(cfg, tm, tp, trace.prompts, 5)
    assert got == jscenario.dense_reference(jcfg, jm, jp, trace.prompts, 5)
    assert [len(t) for s in got.values() for t in s] == [5] * 4


# --------------- twins of tests/test_cluster_mixed.py -----------------------

def test_route_respects_group_even_against_stale_plan():
    def run(p):
        sched = p.scheduler.SymphonyScheduler(
            4, p.policies.POLICIES["symphony"],
            node_groups={0: "default", 1: "default", 2: "mamba2",
                         3: "mamba2"})
        req = p.advisory.InferenceRequest("m0", prompt_tokens=8,
                                          max_new_tokens=4, group="mamba2")
        sched.bind_group("m0", "default")
        sched.plan("m0", 0)
        node = sched.route(req, 0.0)
        sched.on_request_complete(req, 12)
        req2 = p.advisory.InferenceRequest("m0", prompt_tokens=4,
                                           max_new_tokens=4)
        node2 = sched.route(req2, 1.0)
        return (sched.nodes[node].group, sched.nodes[node2].group,
                req2.group)
    got = _both(run)
    assert got["torch"] == got["jax"] == ("mamba2",) * 3


def test_placement_raises_when_group_has_no_live_node():
    sched = tscheduler.SymphonyScheduler(
        2, tpolicies.POLICIES["symphony"],
        node_groups={0: "default", 1: "mamba2"})
    sched.mark_failed(1)
    with pytest.raises(RuntimeError, match="mamba2"):
        sched.route(tadvisory.InferenceRequest(
            "m0", prompt_tokens=8, max_new_tokens=4, group="mamba2"), 0.0)


def test_sim_mixed_cluster_group_isolated_routing():
    def run(p):
        tcfg = p.configs.get_config("llama3-8b")
        mcfg = p.configs.get_config("mamba2-2.7b")
        rt = p.simulator.ClusterRuntime(
            tcfg, policy="symphony", hw=_hw(p), node_groups={
                "default": dict(cfg=tcfg, n_nodes=2),
                "mamba2": dict(cfg=mcfg, n_nodes=2)})
        trace = p.scenario.MixedTrace(
            p.scenario.MultiTurnRealTrace(tcfg, n_sessions=3, n_turns=3,
                                          prompt_len=64, gen=32, seed=11,
                                          sid_prefix="t"),
            p.scenario.MultiTurnRealTrace(mcfg, n_sessions=3, n_turns=3,
                                          prompt_len=64, gen=32, seed=12,
                                          group="mamba2", sid_prefix="m"))
        res = rt.run(trace)
        for mgr in rt.managers.values():
            mgr.store.check()
        stores = {i: {sid: (len(e.tier), e.kind)
                      for sid, e in mgr.store.entries.items()}
                  for i, mgr in rt.managers.items()}
        placed = [(r.session_id, rt.node_group[r.node_id])
                  for r in res.completed]
        mcost = rt.costs[2]
        return (rt.node_group, res.metrics(), stores, placed,
                mcost.kv_bytes_token, mcost.fixed_state_bytes)
    got = _both(run)
    assert got["torch"] == got["jax"]
    groups, metrics, stores, placed, kv_tok, state_bytes = got["torch"]
    assert groups == {0: "default", 1: "default", 2: "mamba2", 3: "mamba2"}
    assert metrics["completed"] == 18
    assert all(g == ("mamba2" if sid.startswith("m") else "default")
               for sid, g in placed)
    n_layers = tconfigs.get_config("llama3-8b").n_layers
    kinds = [(groups[i], v) for i, s in stores.items() for v in s.values()]
    assert any(g == "mamba2" for g, _ in kinds)
    assert any(g == "default" for g, _ in kinds)
    assert all(v == ((1, "state") if g == "mamba2" else (n_layers, "kv"))
               for g, v in kinds)
    assert kv_tok == 0 and state_bytes > 0


def test_real_mixed_cluster_migration_and_crash_token_exact():
    """2 torch RealBackend + 2 StateBackend nodes behind one scheduler: the
    recurrent session's turn-2 advisory migrates its state to the idle
    peer, then the node that served its turn 2 is killed.  Every session's
    tokens equal its family's dense reference, the port's and JAX's."""
    jtcfg, tcfg = _reduced("llama3-8b")
    jmcfg, mcfg = _reduced("mamba2-2.7b")
    jtm, jtp, tm, tp = same_weights(jtcfg, tcfg, 0)
    jmm, jmp, mm, mp = same_weights(jmcfg, mcfg, 1)
    rt = _real_runtime(tcfg, None, None, node_groups={
        "default": dict(cfg=tcfg, n_nodes=2, model=tm, params=tp),
        "mamba2": dict(cfg=mcfg, n_nodes=2, model=mm, params=mp)})
    ttrace = tscenario.MultiTurnRealTrace(tcfg, n_sessions=2, n_turns=2,
                                          prompt_len=8, gen=4, seed=5,
                                          sid_prefix="t")
    mtrace = tscenario.MultiTurnRealTrace(mcfg, n_sessions=1, n_turns=3,
                                          prompt_len=8, gen=4, seed=6,
                                          group="mamba2", sid_prefix="m",
                                          fail_after_turn=2,
                                          fail_session="m0")
    try:
        res = rt.run(tscenario.MixedTrace(ttrace, mtrace))
        got = tscenario.session_outputs(res)
        want = tscenario.dense_reference(tcfg, tm, tp, ttrace.prompts, 4)
        want.update(tscenario.dense_reference(mcfg, mm, mp, mtrace.prompts,
                                              4))
        assert got == want, (got, want)
        jwant = jscenario.dense_reference(jtcfg, jtm, jtp, ttrace.prompts, 4)
        jwant.update(jscenario.dense_reference(jmcfg, jmm, jmp,
                                               mtrace.prompts, 4))
        assert want == jwant
        for r in res.completed:
            wantg = "mamba2" if r.session_id.startswith("m") else "default"
            assert rt.node_group[r.node_id] == wantg, r.session_id
        mnodes = [i for i, g in rt.node_group.items() if g == "mamba2"]
        moved = sum(rt.managers[i].stats.get("migrations", 0)
                    for i in mnodes)
        recovered = sum(rt.managers[i].stats.get("recoveries", 0)
                        for i in mnodes)
        assert moved + recovered >= 1
        dead = [i for i, st in rt.sched.nodes.items() if not st.alive]
        assert len(dead) == 1 and dead[0] in mnodes
        assert rt.sched.nodes[dead[0]].outstanding == 0
        for i in rt.managers:
            if i in dead:
                continue
            be = rt.backends[i]
            if hasattr(be, "slots"):
                be.slots.check()
                allocs = be.kv_alloc
            else:
                allocs = be.alloc
            for a in allocs:
                a.check()
            rt.managers[i].store.check()
    finally:
        rt.cleanup()


# --------------- the cluster case of tests/test_prefix_sharing.py -----------

def test_cluster_route_prefers_prefix_node_and_saves_prefill():
    """A shared-prefix cohort: the donor finishes first, then every sharer
    routes to the donor's node and adopts the 16-token aligned prefix."""
    jpkg, tpkg = twins("gqa", 5)
    cfg = tpkg.cfg
    rt = _real_runtime(cfg, tpkg.model, tpkg.params, n_nodes=3,
                       max_batch=8)
    trace = tscenario.SharedPrefixTrace(cfg, n_sessions=4, shared_len=16,
                                        suffix_len=4, gen=4, seed=7)
    try:
        res = rt.run(trace)
        got = tscenario.session_outputs(res)
        want = tscenario.dense_reference(cfg, tpkg.model, tpkg.params,
                                         trace.prompts, 4)
        assert got == want, (got, want)
        assert want == jscenario.dense_reference(jpkg.cfg, jpkg.model,
                                                 jpkg.params, trace.prompts,
                                                 4)
        nodes = {r.node_id for r in res.completed}
        assert len(nodes) == 1, f"cohort split across nodes {nodes}"
        node = nodes.pop()
        eng = rt.engines[node]
        assert eng.stats["shared_prefix_tokens"] == 3 * 16
        total_prompt = sum(len(t[0]) for t in trace.prompts.values())
        assert eng.stats["prefill_tokens"] == total_prompt - 3 * 16
        assert rt.backends[node].stats["prefix_hits"] == 3
        for a in rt.backends[node].alloc:
            a.check()
        for mgr in rt.managers.values():
            mgr.store.check()
    finally:
        rt.cleanup()
