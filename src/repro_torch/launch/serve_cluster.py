"""The full multi-node SYMPHONY scenario on the real backend, through the
same `ClusterRuntime` event loop that runs the paper-scale simulations:
the counterpart of ``examples/serve_cluster.py``.

A 3-node cluster serves 2 interleaved sessions of 4 turns (8 tokens
generated a turn) with real tokens and real paged KV migrating through the
tiered store (device pools, host staging, per-node disk spools).  Each
turn an advisory fires first, the scheduler plans placement, and the
target node's manager migrates and promotes the session's KV off the
critical path.  Turn 1 occupies nodes 0 and 1, so the first turn-2
advisory plans the idle node 2 and its session's KV migrates; after
session s0's turn 2 the node that served it is killed, its stranded
requests are replayed and its sessions recovered from its spool (or
recomputed).

Checks, as the example's: every session's tokens equal the dense
full-recompute reference (`dense_reference`), at least one migration
happened, a node is dead, and every live node's store passes ``check()``.

Models: with ``device="cpu"`` the reduced llama3-8b in float32, as the
example serves it.  On the card (the default) its head dim 16 has no
kernel body (``kernels/paged_attention.py`` ``HEAD_DIMS``), so it serves
llama3-8b at its published widths, 2 layers, float32: the paged attention
kernel (kernel 1) on every layer of every dispatch, the prefill kernel
(B.4) on every layer of the reference's prefills.
"""
from __future__ import annotations

import dataclasses

N_NODES, N_SESSIONS, N_TURNS, GEN = 3, 2, 4, 8


def model_config(device):
    """The served config: the reduced llama3-8b on the CPU, llama3-8b at
    published widths and 2 layers elsewhere; float32 both."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config("llama3-8b")
    if torch.device(device).type == "cpu":
        return cfg.reduced(dtype="float32")
    return dataclasses.replace(cfg, n_layers=2, dtype="float32",
                               name="llama3-8b-2layer-fp32")


def main(device="cuda") -> dict:
    """Serve the scenario on ``device`` and verify it; returns a summary
    (raises RuntimeError when a check fails)."""
    import torch
    from repro_torch.models.registry import get_model
    from repro_torch.serving.cost_model import HardwareSpec
    from repro_torch.serving.scenario import MultiTurnRealTrace
    from repro_torch.serving.simulator import ClusterRuntime

    cfg = model_config(device)
    model = get_model(cfg, device=device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    rt = ClusterRuntime(cfg, n_nodes=N_NODES, policy="symphony",
                        hw=HardwareSpec(chips_per_replica=1), max_batch=8,
                        mode="real", model=model, params=params,
                        n_pages=64, page_size=8, trace_logits=False,
                        device=model.device)
    trace = MultiTurnRealTrace(cfg, n_sessions=N_SESSIONS, n_turns=N_TURNS,
                               prompt_len=10, gen=GEN, seed=1,
                               fail_after_turn=2)
    try:
        return _run_and_verify(rt, trace, cfg, model, params)
    finally:
        rt.cleanup()       # drop the spool even when verification fails


def _run_and_verify(rt, trace, cfg, model, params):
    from repro_torch.serving.scenario import dense_reference, session_outputs
    res = rt.run(trace)
    m = res.metrics()
    migrations = sum(n["migrations"] for n in m["per_node"].values())
    recoveries = sum(n["recoveries"] for n in m["per_node"].values())
    copied = sum(n.get("copied_bytes", 0) for n in m["per_node"].values())
    dead = sorted(i for i, st in rt.sched.nodes.items() if not st.alive)
    dispatches = sum(be.stats["sub_dispatches"]
                     for be in rt.backends.values())
    print(f"served {m['completed']} turns across {N_NODES} real nodes "
        f"(node {dead} failed mid-run) on {model.device}")
    print(f"real page traffic: {migrations} session migrations, "
        f"{recoveries} spool recoveries, {copied / 1024:.0f} KiB copied")

    got = session_outputs(res)
    want = dense_reference(cfg, model, params, trace.prompts, GEN)
    if got != want:
        raise RuntimeError(f"served tokens differ from the dense "
                           f"recompute: {got} != {want}")
    if migrations < 1:
        raise RuntimeError("expected at least one advisory-driven "
                           "migration")
    if not dead:
        raise RuntimeError("expected the injected node failure to have "
                           "happened")
    for mgr in rt.managers.values():
        mgr.store.check()
    print(f"all {N_SESSIONS} sessions match the dense recompute reference "
        f"across {N_TURNS} turns (incl. cross-node migration + failure "
        f"recovery: {recoveries} from spool)")
    return dict(completed=m["completed"], migrations=migrations,
                recoveries=recoveries, copied_bytes=copied, dead=dead,
                sub_dispatches=dispatches,
                reference_prefills=N_SESSIONS * N_TURNS,
                n_layers=cfg.n_layers, tokens_match=True)


if __name__ == "__main__":
    main()
