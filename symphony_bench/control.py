#!/usr/bin/env python3
"""The readings a cell's correctness limit is set from.

    python3 symphony_bench/control.py --workload <cell> --seconds <s> \
        --seeds 1,2,3,... --control 3

Runs the cell once for each seed, one after another in one process, with
a short window at the cell's own load, and prints for each the widest gap
of the program's served tokens below the float32 reference's best (the
lower reading) and, for the first ``--control`` seeds, the widest gap of
the tokens the float8 reference puts first at the same positions (the
control: the upper reading).  The benchmark's own runs never run the
control; the limit in ``cells/<cell>.json`` lies between the two."""
import argparse
import gc
import json
import sys

import run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args()
    sys.path[:0] = [str(run.ROOT), str(run.ROOT / "src")]
    import torch

    from symphony_bench import judge
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    worst = judge.worst_gap
    for i, seed in enumerate(int(x) for x in args.seeds.split(",")):
        got = {}

        def both(weights, cfg, turns, precision="fp32", i=i, got=got, **kw):
            got["program"] = worst(weights, cfg, turns, **kw)
            if i < args.control:
                got["control"] = worst(weights, cfg, turns, "fp8", **kw)
            return got["program"]
        judge.worst_gap = both
        out = run.run_cell(args.workload, seed, args.seconds, False,
                           "cuda:0", t_origin=run.clock())
        print(json.dumps(dict(seed=seed, correct=out["correct"],
                              program=got.get("program"),
                              control=got.get("control"),
                              attempted=out["attempted"],
                              counters=out["window_counters"])),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
