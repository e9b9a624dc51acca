"""The dry run: every (arch x shape x mesh) cell's step at production size
on the ``meta`` device, counted: the counterpart of
``src/repro/launch/dryrun.py``.

The JAX package lowers and compiles each cell's jitted step for 256 (and
512) virtual XLA devices and reads XLA's memory analysis and the HLO.  The
port runs on one controller and has no SPMD partitioner, so a cell here
is the step itself — ``make_train_step`` (the JAX package's microbatch
counts), ``prefill`` or ``decode_step`` — run once on meta tensors at the
cell's global shapes under ``roofline.cost.Counter(fold=True)``.  Every
operation's shapes are checked at production size, with no card and no
memory.  Per device:

  flops, hbm_bytes  the global count over ``n_devices`` ("split": "even"
                    in the artifact);
  argument_gb       parameters, AdamW state (train: float32 moments and
                    masters, ZeRO-1 specs), cache and batch: each leaf's
                    bytes over the product of the mesh axes its spec
                    shards it on (``distributed/sharding.py``);
  temp_gb           the counter's peak of live bytes (its own liveness
                    accounting: each result's storage from creation to the
                    last tensor on it, autograd's saved tensors included)
                    over ``n_devices``;
  fits_hbm_80gb     argument_gb + temp_gb <= 80.
  coll_bytes        the ring bytes of the collectives the plan's specs
                    imply, with tp = |model|, dp = |data|, P = |pod|, R =
                    dp·P replicas, and ring(g) = (g-1)/g:
                    * Megatron: a product with a row-parallel weight (model
                      on its input dim) as stored, and one with a
                      column-parallel weight (model on its output dim)
                      transposed (the backward pass's input gradient), is
                      summed over model: all-reduce, 2·(A/R)·ring(tp) for a
                      product of A global bytes;
                    * vocab-sharded embeddings: the lookup's rows and the
                      unembedding's input gradient are summed over model
                      (all-reduce as above); the logits' softmax needs each
                      row's max and sum, 2·(rows/R)·4·2·ring(tp);
                    * ZeRO-1 (train): each leaf's float32 gradient, its
                      model shard's G bytes, reduce-scattered over data
                      (G·ring(dp)), its data shard all-reduced over pods
                      (2·(G/dp)·ring(P)), and its parameter shard's W bytes
                      all-gathered over data after the update
                      (W·ring(dp)); a leaf whose optimizer spec has no data
                      axis is all-reduced over data and pods instead
                      (2·G·ring(R)).
                    A product is seen through its weight's storage; a
                    weight copied before its product (a float32 cast,
                    einsum's copy of a permuted expert stack) is not, and
                    the experts' all-to-all when experts are sharded over
                    model is not charged.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k
  python -m repro_torch.launch.dryrun --all      # every cell, subprocess each
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
N_MICRO = {"seamless-m4t-medium": 16, "zamba2-2.7b": 16, "xlstm-1.3b": 16}
SKIP_REASON = ("long_500k needs sub-quadratic attention; skipped for pure "
               "full-attention archs (DESIGN.md)")
HBM_GB = 80.0


def _shards(spec, plan) -> int:
    n = 1
    for part in spec:
        if part is None:
            continue
        for axis in (part if isinstance(part, tuple) else (part,)):
            n *= plan._axis_size(axis)
    return n


def _leaves(tree, specs):
    """(tensor, spec) pairs of a tree and its specs, in order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)):
        for t, s in zip(tree, specs):
            yield from _leaves(t, s)
    else:
        yield tree, specs


def per_device_bytes(tree, specs, plan) -> float:
    """Bytes a device holds of ``tree`` placed by ``specs``."""
    return sum(t.numel() * t.element_size() / _shards(s, plan)
               for t, s in _leaves(tree, specs))


def opt_specs(plan, params, p_specs):
    """ZeRO-1 specs of the AdamW state's moments and masters."""
    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        return plan.opt_spec_from_param(s, tuple(p.shape))
    return walk(params, p_specs)


def _ring(g: int) -> float:
    return (g - 1) / g if g > 1 else 0.0


def zero1_collectives(plan, params, p_specs, o_specs):
    """(coll_bytes, coll_counts) per device of ZeRO-1's gradient and
    parameter traffic (module docstring)."""
    dp, pod, R = plan.dp, plan.pod, plan.dp_total
    by, counts = {}, {}

    def add(kind, b):
        by[kind] = by.get(kind, 0.0) + b
        counts[kind] = counts.get(kind, 0) + 1
    for (p, ps), (_, os_) in zip(_leaves(params, p_specs),
                                 _leaves(params, o_specs)):
        n = p.numel() / _shards(ps, plan)
        g, w = 4 * n, p.element_size() * n
        if _shards(os_, plan) > _shards(ps, plan):
            add("reduce-scatter", g * _ring(dp))
            if pod > 1:
                add("all-reduce", 2 * g / dp * _ring(pod))
            add("all-gather", w * _ring(dp))
        elif R > 1:
            add("all-reduce", 2 * g * _ring(R))
    return by, counts


def _weight_kinds(plan, params, p_specs):
    """Storage of each sharded weight -> "row", "col" or "vocab"."""
    from repro_torch.distributed.sharding import _VOCAB
    kinds = {}

    def walk(p, s, name=None):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], s[k], k)
            return
        d = s.dim_of("model")
        if d is None:
            return
        nd = p.dim()
        kind = ("vocab" if name in _VOCAB else "row" if d == nd - 2
                else "col" if d == nd - 1 else None)
        if kind:
            kinds[p.untyped_storage()._cdata] = kind
    walk(params, p_specs)
    return kinds


def _plan_counter(kinds, plan):
    """A `Counter` that also charges the Megatron and vocab all-reduces of
    the products it sees (module docstring)."""
    import torch
    from repro_torch.roofline.cost import Counter

    aten = torch.ops.aten
    products = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
    gathers = {aten.index, aten.embedding}
    scale = 2 * _ring(plan.tp) / plan.dp_total

    class PlanCounter(Counter):
        def _count(self, func, args, kwargs, out):
            super()._count(func, args, kwargs, out)
            if plan.tp <= 1:
                return
            packet = func._overloadpacket
            if packet not in products and packet not in gathers:
                return
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            if packet is aten.index:
                ts = ts[:1]
            for t in ts:
                kind = kinds.get(t.untyped_storage()._cdata)
                if kind is None:
                    continue
                nbytes = out.numel() * out.element_size()
                stored = t.dim() < 2 or t.stride(-1) == 1
                if packet in gathers:
                    link = nbytes
                elif kind == "row":
                    link = nbytes if stored else 0
                elif kind == "col":
                    link = 0 if stored else nbytes
                elif stored:                  # vocab: the input gradient
                    link = nbytes
                else:                         # vocab: the logits' softmax
                    link = out.numel() // out.shape[-1] * 4 * 2
                if link:
                    self.charge_link("all-reduce", link * scale)
                return
    return PlanCounter(fold=True)


def _step(model, cfg, cell, arch, params, specs):
    """(the callable, its arguments) of the cell's step."""
    from repro_torch.training.optimizer import adamw_init, make_train_step
    if cell.kind == "train":
        step = make_train_step(model, n_microbatches=N_MICRO.get(arch, 8))
        return step, (params, adamw_init(params), specs)
    if cell.kind == "prefill":
        if cfg.family == "encdec":
            args = (specs["frames"], specs["tokens"])
        elif cfg.family == "vlm":
            args = (specs["tokens"], specs["patches"])
        else:
            args = (specs["tokens"],)
        return model.prefill, (params,) + args
    return model.decode_step, (params, specs["cache"], specs["tokens"])


def _write(out_dir: Path, res: dict) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{res['arch']}__{res['shape']}__{res['mesh']}.json") \
        .write_text(json.dumps(res, indent=1))
    return res


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: Path,
             cfg=None) -> dict:
    """Run one cell and write its artifact.  ``cfg`` replaces the arch's
    published config (a reduced one, for tests); the cell keeps its name."""
    from repro_torch.configs import SHAPES_BY_NAME, get_config, shapes_for
    from repro_torch.distributed.sharding import ShardingPlan
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.registry import get_model

    cfg = cfg or get_config(arch)
    cell = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    if cell.name not in {s.name for s in shapes_for(cfg)}:
        return _write(Path(out_dir), dict(arch=arch, shape=cell.name,
                                          mesh=mesh_kind, skipped=True,
                                          reason=SKIP_REASON))
    model = get_model(cfg, device="meta")
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    plan = ShardingPlan(cfg, mesh)
    n_dev = len(mesh.devices)
    specs = model.input_specs(cell)
    params = model.init(None)
    p_specs = plan.params_specs(params)

    arg = per_device_bytes(params, p_specs, plan)
    coll, counts = {}, {}
    if cell.kind == "train":
        o_specs = opt_specs(plan, params, p_specs)
        arg += 3 * per_device_bytes(_f32(params), o_specs, plan) + 4
        arg += per_device_bytes(specs, plan.batch_specs(specs), plan)
        coll, counts = zero1_collectives(plan, params, p_specs, o_specs)
    elif cell.kind == "prefill":
        arg += per_device_bytes(specs, plan.batch_specs(specs), plan)
    else:
        arg += per_device_bytes(specs["cache"],
                                plan.cache_specs(specs["cache"]), plan)
        arg += per_device_bytes(specs["tokens"],
                                plan.data_spec(tuple(specs["tokens"].shape)),
                                plan)

    fn, args = _step(model, cfg, cell, arch, params, specs)
    counter = _plan_counter(_weight_kinds(plan, params, p_specs), plan)
    t0 = time.time()
    with counter:
        fn(*args)
    run_s = time.time() - t0
    c = counter.cost
    for k, v in coll.items():
        c.coll_bytes[k] = c.coll_bytes.get(k, 0.0) + v
        c.coll_counts[k] = c.coll_counts.get(k, 0) + counts[k]

    n_params = model.param_count()
    n_active = model.active_param_count()
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    model_flops = (6 if cell.kind == "train" else 2) * n_active * tokens
    mem = dict(argument_gb=arg / 1e9,
               temp_gb=c.peak_live_bytes / n_dev / 1e9)
    mem["total_gb"] = mem["argument_gb"] + mem["temp_gb"]
    return _write(Path(out_dir), dict(
        arch=arch, shape=cell.name, mesh=mesh_kind, ok=True,
        n_devices=n_dev, split="even", run_s=round(run_s, 2),
        memory=mem, fits_hbm_80gb=mem["total_gb"] <= HBM_GB,
        per_device=dict(
            flops=c.flops / n_dev, hbm_bytes=c.hbm_bytes / n_dev,
            coll_bytes=dict(c.coll_bytes),
            coll_counts={k: int(v) for k, v in c.coll_counts.items()},
            total_coll_bytes=c.total_coll_bytes,
            unknown_trip_whiles=c.unknown_trip_whiles),
        counted=c.to_json(), model_flops_global=model_flops,
        params=n_params, active_params=n_active))


def _f32(params):
    """The parameter tree as float32 meta leaves (the AdamW state's
    shapes)."""
    import torch

    def walk(p):
        if isinstance(p, dict):
            return {k: walk(v) for k, v in p.items()}
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return walk(params)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--missing-only", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.all:
        from repro_torch.configs import ALL_SHAPES, ARCHS
        cells = [(a, s.name, m) for a in sorted(ARCHS)
                 for s in ALL_SHAPES for m in ("single", "multi")]
        t_start = time.time()
        n_ok = n_skip = n_fail = 0
        for arch, shape, mesh_kind in cells:
            tgt = out_dir / f"{arch}__{shape}__{mesh_kind}.json"
            if args.missing_only and tgt.exists():
                prev = json.loads(tgt.read_text())
                if prev.get("ok") or prev.get("skipped"):
                    n_ok += bool(prev.get("ok"))
                    n_skip += bool(prev.get("skipped"))
                    continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
                   "--out", str(out_dir)]
            t0 = time.time()
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=1800)
            ok = r.returncode == 0
            skipped = ok and json.loads(tgt.read_text()).get("skipped")
            n_ok += ok and not skipped
            n_skip += bool(skipped)
            n_fail += not ok
            print(f"[{time.time() - t_start:7.0f}s] {arch:22s} {shape:12s} "
                  f"{mesh_kind:6s} "
                  f"{'SKIP' if skipped else 'OK' if ok else 'FAIL'} "
                  f"({time.time() - t0:.0f}s)", flush=True)
            if not ok:
                err = (r.stderr or "")[-2000:]
                _write(out_dir, dict(arch=arch, shape=shape, mesh=mesh_kind,
                                     ok=False, error=err))
                print(err[-800:], flush=True)
        print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} fail in "
              f"{time.time() - t_start:.0f} s")
        return 1 if n_fail else 0

    try:
        res = run_cell(args.arch, args.shape, args.mesh, out_dir)
        print(json.dumps(res, indent=1))
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
