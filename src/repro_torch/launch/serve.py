"""Serving launcher: a simulated cluster at paper scale, or the real
3-node cluster (``serve_cluster``): the counterpart of
``src/repro/launch/serve.py``.

  python -m repro_torch.launch.serve --arch llama3-8b --policy symphony \
      --nodes 8 --users 256                     # simulation, no device
  python -m repro_torch.launch.serve --real     # real tokens, on the card
  python -m repro_torch.launch.serve --real --device cpu

The simulation touches no device: every timing comes from the cost
model's `HardwareSpec`.  `PAPER_HW` is one H100 (80 GB) a node with 128 GB
of host DRAM: the paper's testbed serves one 80 GB GPU a node.  (The JAX
package's benchmark uses a 2-chip replica only because a v5e holds 16 GB.)
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.serving.cost_model import HardwareSpec

PAPER_HW = HardwareSpec(chips_per_replica=1, host_dram=128e9)


def run_policy(arch: str, policy: str, *, n_nodes=8, users=256, sessions=None,
               seed=0, miss=0.0, prefill_heavy=False, priority_frac=0.0,
               hw=PAPER_HW, max_batch=32, advisory_to_hbm=True):
    """One simulated cluster run of ``policy`` on a ShareGPT trace (the
    JAX package's ``benchmarks/common.py::run_policy``)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.simulator import ClusterRuntime
    from repro_torch.traces.sharegpt import ShareGPTTrace

    cfg = get_config(arch)
    sim = ClusterRuntime(cfg, n_nodes=n_nodes, policy=policy, hw=hw,
                         max_batch=max_batch, advisory_to_hbm=advisory_to_hbm)
    trace = ShareGPTTrace(n_users=users,
                          n_sessions=sessions or max(users * 2, 200),
                          seed=seed, advisory_miss_rate=miss,
                          prefill_heavy=prefill_heavy,
                          priority_frac=priority_frac)
    t0 = time.time()
    res = sim.run(trace)
    res.stats["wall_s"] = time.time() - t0
    res.stats["advisory_lead_mean"] = (
        sum(trace.advisory_leads) / max(len(trace.advisory_leads), 1))
    return res


def summary(policy: str, r) -> dict:
    """The launcher's JSON record of one simulated run."""
    return dict(
        policy=policy, completed=len(r.completed),
        normalized_latency_ms=r.mean("normalized_latency") * 1e3,
        ttft_s=r.mean("ttft"), tpot_ms=r.mean("tpot") * 1e3,
        req_per_s=r.throughput, load_imbalance=r.load_imbalance(),
        advisory_lead_s=r.stats["advisory_lead_mean"])


def main(argv=None):
    """Run the launcher; returns what it printed (the simulation's record,
    or the real cluster's summary)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--policy", default="symphony",
                    choices=["symphony", "sticky", "stateless", "priority"])
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--users", type=int, default=256)
    ap.add_argument("--sessions", type=int, default=None)
    ap.add_argument("--miss", type=float, default=0.0)
    ap.add_argument("--real", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="--real only: the card (default) or cpu")
    args = ap.parse_args(argv)

    if args.real:
        from repro_torch.launch.serve_cluster import main as real_main
        out = real_main(device=args.device)
        print(json.dumps(out, indent=1))
        return out

    r = run_policy(args.arch, args.policy, n_nodes=args.nodes,
                   users=args.users, sessions=args.sessions, miss=args.miss)
    out = summary(args.policy, r)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
