"""The port's serving launcher (repro_torch/launch/serve.py,
serve_cluster.py) against the JAX package's, and the headline claim on the
port's own H100 spec.

* the simulation's JSON equals ``repro.launch.serve``'s when the port is
  given the JAX package's ``PAPER_HW`` field by field (the port's own is
  one 80 GB card a node);
* ``--real --device cpu`` passes the example's checks (tokens equal the
  dense recompute, a migration, a dead node, every store consistent);
  ``--real`` without a card raises;
* tests/test_regression_claims.py's trace and asserts through the port's
  ``ClusterSim`` with its default (H100) spec.
"""
import contextlib
import dataclasses
import io
import json
import sys

import pytest
import torch

from benchmarks import common as jax_common
from repro.launch import serve as jax_serve
from repro_torch.configs import get_config
from repro_torch.launch import serve, serve_cluster
from repro_torch.serving.cost_model import HardwareSpec
from repro_torch.serving.simulator import ClusterSim
from repro_torch.traces.sharegpt import ShareGPTTrace

ARGS = ["--nodes", "2", "--users", "16", "--sessions", "20"]


@pytest.mark.parametrize("policy", ["symphony", "stateless"])
def test_sim_json_equals_jax_launcher(monkeypatch, policy):
    argv = ["--policy", policy] + ARGS
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_serve.main()
    want = json.loads(buf.getvalue())
    hw = HardwareSpec(**dataclasses.asdict(jax_common.PAPER_HW))
    got = serve.summary(policy, serve.run_policy(
        "llama3-8b", policy, n_nodes=2, users=16, sessions=20, hw=hw))
    assert got == want
    assert got["completed"] > 0
    with contextlib.redirect_stdout(io.StringIO()) as out:
        mine = serve.main(argv)                       # the port's PAPER_HW
    assert json.loads(out.getvalue()) == mine
    assert mine.keys() == want.keys() and mine["completed"] > 0


def test_paper_hw_is_one_card_a_node():
    assert serve.PAPER_HW.chips_per_replica == 1
    assert serve.PAPER_HW.host_dram == 128e9
    assert serve.PAPER_HW.hbm_bytes == 80e9
    assert serve.PAPER_HW.peak_flops == 989e12


def test_real_cluster_on_cpu_passes_its_checks():
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = serve.main(["--real", "--device", "cpu"])
    text = out.getvalue()
    assert json.loads(text[text.index("\n{") + 1:]) == res
    assert res["tokens_match"] and res["migrations"] >= 1 and res["dead"]
    assert res["completed"] == serve_cluster.N_SESSIONS * serve_cluster.N_TURNS
    assert res["sub_dispatches"] > 0
    cfg = serve_cluster.model_config("cpu")
    assert cfg.d_head == 16 and cfg.dtype == "float32"
    card = serve_cluster.model_config("cuda")
    assert (card.n_layers, card.d_model, card.d_head, card.dtype) == (
        2, 4096, 128, "float32")


def test_real_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--real"])


def _run(policy):
    sim = ClusterSim(get_config("llama3-8b"), n_nodes=4, policy=policy)
    res = sim.run(ShareGPTTrace(n_users=64, n_sessions=120, seed=0,
                                prefill_heavy=True))
    busy = sum(e["busy_s"] for e in res.stats["engine"].values())
    return res, len(res.completed) / busy


def test_headline_claim_on_the_ports_h100_spec():
    """tests/test_regression_claims.py's asserts, on the port's default
    HardwareSpec (one H100 a node)."""
    r_sym, cap_sym = _run("symphony")
    r_vllm, cap_vllm = _run("stateless")
    print(f"\nH100 spec (data sheet, not measured): symphony "
          f"{cap_sym:.4g} req/busy-s, stateless {cap_vllm:.4g}: "
          f"{cap_sym / cap_vllm:.3f}x")
    assert len(r_sym.completed) >= 0.9 * len(r_vllm.completed)
    assert len(r_sym.completed) > 500
    assert cap_sym >= 2.0 * cap_vllm, (cap_sym, cap_vllm)
    assert r_sym.mean("ttft") < r_vllm.mean("ttft")
    red = sum(e["redundant_tokens"] for e in r_vllm.stats["engine"].values())
    pre = sum(e["prefill_tokens"] for e in r_vllm.stats["engine"].values())
    assert red / pre > 0.5
    assert sum(e["redundant_tokens"]
               for e in r_sym.stats["engine"].values()) == 0
