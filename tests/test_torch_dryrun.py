"""The port's dry run (repro_torch/launch/dryrun.py) and what it reads.

* every model's ``input_specs`` equals the JAX package's (keys, shapes,
  dtypes; JAX's side through ``jax.eval_shape``) for all 11 archs and
  every ``shapes_for`` cell;
* the per-device bytes of the parameters and of the AdamW state on the
  (2, 4) debug mesh equal those the JAX package's plan implies for the
  same mesh (its 8 host devices forced by the root conftest);
* `run_cell` on three reduced cells (train, prefill, decode) writes the
  keys `analysis.load_row` reads, and a cell `shapes_for` excludes writes
  the skip record;
* `make_production_mesh` has the JAX package's shapes over meta devices;
* `cost_model.load_roofline_calibration` reads the port's artifacts.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.distributed.sharding import ShardingPlan as JaxPlan
from repro.launch.mesh import make_debug_mesh as jax_debug_mesh
from repro.models.registry import get_model as jax_model
from repro_torch.configs import (ARCHS, LONG_500K, ShapeCell, get_config,
                                 shapes_for)
from repro_torch.distributed.sharding import ShardingPlan
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models.registry import get_model
from repro_torch.roofline import analysis
from repro_torch.serving.cost_model import load_roofline_calibration


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    return {pre: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_equal_jax(arch):
    jm = jax_model(jax_config(arch))
    tm = get_model(get_config(arch), device="meta")
    cpu = get_model(get_config(arch).reduced(), device="cpu")
    for cell in shapes_for(get_config(arch)):
        want = _flat(jax.eval_shape(lambda: jm.input_specs(cell)))
        specs = tm.input_specs(cell)
        assert _flat(specs) == want, (arch, cell.name)
        for t in _flat_tensors(specs):
            assert t.device.type == "meta"
        # a model on the CPU gives meta specs too (its cache from a meta
        # twin), of its own config's shapes
        for t in _flat_tensors(cpu.input_specs(cell)):
            assert t.device.type == "meta"


def _flat_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat_tensors(v)
    else:
        yield tree


def _jax_bytes(specs, shapes, mesh, itemsize):
    total = 0.0
    for spec, shape in zip(jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec)), shapes):
        n = int(np.prod(shape)) * itemsize(shape)
        for part in spec:
            for axis in (part if isinstance(part, tuple) else (part,)):
                if axis is not None:
                    n /= mesh.shape[axis]
        total += n
    return total


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_optimizer_bytes_equal_jax_plan(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    jm = jax_model(jcfg)
    jmesh = jax_debug_mesh(2, 4)
    jplan = JaxPlan(jcfg, jmesh)
    abstract = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    leaves = jax.tree.leaves(abstract)
    shapes = [x.shape for x in leaves]
    sizes = {x.shape: x.dtype.itemsize for x in leaves}
    jp = jplan.params_specs(abstract)
    jo = jax.tree.map(jplan.opt_spec_from_param, jp,
                      jax.tree.map(lambda x: x.shape, abstract))
    want_p = _jax_bytes(jp, shapes, jmesh, lambda s: sizes[s])
    want_o = _jax_bytes(jo, shapes, jmesh, lambda s: 4)

    model = get_model(cfg, device="meta")
    params = model.init(None)
    plan = ShardingPlan(cfg, make_debug_mesh(2, 4, devices=["meta"] * 8))
    p_specs = plan.params_specs(params)
    got_p = dryrun.per_device_bytes(params, p_specs, plan)
    got_o = dryrun.per_device_bytes(dryrun._f32(params),
                                    dryrun.opt_specs(plan, params, p_specs),
                                    plan)
    assert got_p == pytest.approx(want_p, rel=1e-12)
    assert got_o == pytest.approx(want_o, rel=1e-12)
    assert got_p < sum(t.numel() * t.element_size()
                       for t in _flat_tensors(params))


CELLS = [("llama3-8b", ShapeCell("train_4k", "train", 64, 16), "single"),
         ("xlstm-1.3b", ShapeCell("prefill_32k", "prefill", 96, 2), "multi"),
         ("zamba2-2.7b", ShapeCell("decode_32k", "decode", 64, 4), "single")]


@pytest.mark.parametrize("arch,cell,mesh", CELLS,
                         ids=[c[1].kind for c in CELLS])
def test_run_cell_writes_what_load_row_reads(tmp_path, arch, cell, mesh):
    cfg = get_config(arch).reduced()
    res = dryrun.run_cell(arch, cell, mesh, tmp_path, cfg=cfg)
    f = tmp_path / f"{arch}__{cell.name}__{mesh}.json"
    assert json.loads(f.read_text()) == res
    n_dev = 512 if mesh == "multi" else 256
    assert res["ok"] and res["n_devices"] == n_dev
    assert res["split"] == "even"
    p = res["per_device"]
    assert p["flops"] == pytest.approx(res["counted"]["flops"] / n_dev)
    assert p["hbm_bytes"] == pytest.approx(res["counted"]["hbm_bytes"]
                                           / n_dev)
    assert p["flops"] > 0 and p["unknown_trip_whiles"] == 0
    assert res["memory"]["temp_gb"] > 0 and res["fits_hbm_80gb"]
    assert res["memory"]["total_gb"] == pytest.approx(
        res["memory"]["argument_gb"] + res["memory"]["temp_gb"])
    if cell.kind == "train":         # ZeRO-1 over data
        assert p["coll_bytes"]["reduce-scatter"] > 0
    row = analysis.load_row(arch, cell.name, mesh=mesh, results=tmp_path)
    assert row is not None and row.fits
    assert row.compute_s == pytest.approx(p["flops"] / 989e12)
    assert row.memory_s == pytest.approx(p["hbm_bytes"] / 3.35e12)
    # a kernel entry on the cell's path is charged on the meta route
    kernels = res["counted"]["kernels"]
    want = {"llama3-8b": "flash_prefill", "xlstm-1.3b": None,
            "zamba2-2.7b": None}[arch]
    if want:
        assert kernels[want]["calls"] > 0


def test_run_cell_skips_what_shapes_for_excludes(tmp_path):
    res = dryrun.run_cell("llama3-8b", LONG_500K.name, "single", tmp_path)
    assert res["skipped"] and "long_500k" in res["reason"]
    assert analysis.load_row("llama3-8b", "long_500k",
                             results=tmp_path) is None


def test_production_mesh_shapes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert len(multi.devices) == 512
    assert all(d.type == "meta" for d in single.devices)
    plan = ShardingPlan(get_config("llama3-8b"), multi)
    assert plan.tp == 16 and plan.dp_total == 32
    assert plan.data_spec((32, 4096)) == (("pod", "data"), None)


def test_load_roofline_calibration_reads_port_artifacts(tmp_path):
    assert load_roofline_calibration("llama3-8b", tmp_path) is None
    art = dict(arch="llama3-8b", shape="decode_32k", mesh="single", ok=True,
               per_device=dict(flops=1.0))
    (tmp_path / "llama3-8b__decode_32k__single.json").write_text(
        json.dumps(art))
    (tmp_path / "llama3-8b__prefill_32k__single.json").write_text(
        json.dumps(dict(art, shape="prefill_32k", ok=False)))
    assert load_roofline_calibration("llama3-8b", tmp_path) == {
        "decode_32k": art}
    assert "dryrun_torch" in str(
        load_roofline_calibration.__defaults__[0])
