"""The port's serving path against the JAX package's, on the same weights.

* the quickstart twin: examples/quickstart.py's 3-turn conversation served
  by the port's NodeEngine + RealBackend must give the tokens of the JAX
  RealBackend (attention through its jnp oracle, ``kernel_mode="ref"``)
  and of the port's dense prefill/decode recompute; a second pass adds no
  new shape bucket;
* a shared system prompt: a second session adopts the first one's prefix
  and forks a page mid-way (copy-on-write), with the JAX backend's tokens
  and counters;
* guards: the port imports neither JAX nor the JAX package, runs on the
  card by default, and raises for the families the reference serves with
  no paged step (moe, encdec).

Float32 configs (bf16 rounds differently in the two frameworks on the
CPU), page 8, CPU tensors: the port's attention takes its plain version.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.advisory import InferenceRequest as JaxRequest
from repro.core.node_manager import NodeManager as JaxManager
from repro.models.registry import get_model as jax_model
from repro.serving.backend import RealBackend as JaxBackend
from repro.serving.cost_model import CostModel as JaxCost
from repro.serving.cost_model import HardwareSpec as JaxHardware
from repro.serving.engine import NodeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.advisory import InferenceRequest
from repro_torch.core.node_manager import NodeManager
from repro_torch.models.registry import get_model
from repro_torch.serving.backend import RealBackend, make_backend
from repro_torch.serving.cost_model import CostModel, HardwareSpec
from repro_torch.serving.engine import NodeEngine

ROOT = Path(__file__).resolve().parents[1]
GEN = 8
PAGE = 8


def _models(n_kv_heads=None, seed=0):
    over = {} if n_kv_heads is None else dict(n_kv_heads=n_kv_heads)
    jcfg = jax_config("llama3-8b").reduced(dtype="float32", **over)
    cfg = get_config("llama3-8b").reduced(dtype="float32", **over)
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    tm = get_model(cfg, device="cpu")
    tp = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return (jcfg, jm, jp), (cfg, tm, tp)


def _torch_engine(cfg, model, params, **kw):
    cost = CostModel(cfg, HardwareSpec(chips_per_replica=1))
    cost.set_param_count(model.param_count())
    mgr = NodeManager(0, cfg, cost)
    be = RealBackend(cfg, model, params, n_pages=64, page_size=PAGE, mgr=mgr,
                     device="cpu", **kw)
    return NodeEngine(0, cfg, cost, mgr, max_batch=4, backend=be), be, mgr


def _jax_engine(cfg, model, params, **kw):
    cost = JaxCost(cfg, JaxHardware(chips_per_replica=1))
    cost.set_param_count(model.param_count())
    mgr = JaxManager(0, cfg, cost)
    be = JaxBackend(cfg, model, params, n_pages=64, page_size=PAGE, mgr=mgr,
                    kernel_mode="ref", **kw)
    return JaxEngine(0, cfg, cost, mgr, max_batch=4, backend=be), be, mgr


def _serve_turns(eng, be, request_cls, turns, sid="chat"):
    out, now = [], 0.0
    for turn in turns:
        req = request_cls(session_id=sid, prompt_tokens=len(turn),
                          max_new_tokens=GEN, prompt_ids=list(turn),
                          cached_tokens=be.session_tokens(sid))
        eng.submit(req)
        while eng.waiting or eng.running:
            now += eng.step(now)
        out.append(list(req.output_ids))
    return out


def _recompute(cfg, model, params, turns):
    history, out = [], []
    for turn in turns:
        history += turn
        logits, cache = model.prefill(params, torch.tensor([history]))
        cache = model.grow_cache(cache, GEN)
        outs = []
        for _ in range(GEN):
            nxt = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
            outs.append(int(nxt[0]))
            logits, cache = model.decode_step(params, cache, nxt)
        out.append(outs)
        history += outs
    return out


def test_quickstart_twin_matches_jax_and_recompute():
    (jcfg, jm, jp), (cfg, tm, tp) = _models()
    rng = np.random.default_rng(0)
    turns = [list(map(int, rng.integers(0, cfg.vocab, rng.integers(8, 16))))
             for _ in range(3)]
    eng, be, mgr = _torch_engine(cfg, tm, tp, trace_logits=False)
    got = _serve_turns(eng, be, InferenceRequest, turns)
    jeng, jbe, _ = _jax_engine(jcfg, jm, jp, trace_logits=False)
    want_jax = _serve_turns(jeng, jbe, JaxRequest, turns)
    assert got == want_jax
    assert got == _recompute(cfg, tm, tp, turns)
    assert be.stats["prefills"] == 3
    assert eng.stats["prefill_tokens"] == jeng.stats["prefill_tokens"]
    for a in be.alloc:
        a.check()
    mgr.store.check()
    # a second conversation of the same shape lands in the same buckets
    buckets = dict(be.compile_counts())
    eng2, be2, _ = _torch_engine(cfg, tm, tp, trace_logits=False)
    assert _serve_turns(eng2, be2, InferenceRequest, turns) == got
    assert be2.compile_counts() == buckets


def test_shared_system_prompt_adopts_and_forks_like_jax():
    """A finishes; B shares its 16-token page-aligned prefix and C diverges
    two tokens into A's third page, so C's first write forks that page on
    every layer.  Tokens and sharing counters equal the JAX backend's."""
    (jcfg, jm, jp), (cfg, tm, tp) = _models(n_kv_heads=2)
    shared = list(range(16))
    prompts = dict(A=shared + [100, 101, 102, 103, 104],
                   B=shared + [120, 121, 122, 123, 124],
                   C=shared + [100, 101, 200, 201, 202])
    outs = {}
    for name, (make, req_cls) in dict(
            torch=(lambda: _torch_engine(cfg, tm, tp), InferenceRequest),
            jax=(lambda: _jax_engine(jcfg, jm, jp), JaxRequest)).items():
        eng, be, mgr = make()
        reqs = {s: req_cls(session_id=s, prompt_tokens=len(p),
                           max_new_tokens=GEN, prompt_ids=list(p))
                for s, p in prompts.items()}
        now = 0.0
        for wave in (["A"], ["B", "C"]):
            for s in wave:
                eng.submit(reqs[s])
            while eng.waiting or eng.running:
                now += eng.step(now)
                for a in be.alloc:
                    a.check()
        outs[name] = dict(
            tokens={s: list(r.output_ids) for s, r in reqs.items()},
            shared=eng.stats["shared_prefix_tokens"],
            **{k: be.stats[k] for k in ("prefix_hits", "shared_tokens",
                                        "cow_forks")})
        mgr.store.check()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"]["shared"] == 16 + 18
    assert outs["torch"]["cow_forks"] == cfg.n_layers


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or\n"
        "             n.startswith('jax.') or n == 'repro' or\n"
        "             n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for m in ('serving.backend', 'serving.state_backend',\n"
        "          'models.mamba2', 'models.moe', 'models.encdec',\n"
        "          'kernels.ssd_scan', 'distributed.sharding',\n"
        "          'distributed.collectives', 'launch.mesh',\n"
        "          'kernels.flash_prefill', 'serving.simulator',\n"
        "          'serving.scenario', 'core.scheduler',\n"
        "          'traces.agents', 'training.train_loop',\n"
        "          'training.checkpoint', 'training.compression',\n"
        "          'launch.train'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_backend_runs_on_the_card_by_default():
    cfg = get_config("llama3-8b").reduced(dtype="float32")
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        RealBackend(cfg, model, params)
    with pytest.raises(RuntimeError, match="cuda"):
        make_backend(cfg, model, params)
    be = make_backend(cfg, model, params, device="cpu")
    assert be.k_pool.device.type == "cpu"
    assert be.pool_device_bytes() == 2 * be.k_pool.numel() * 4


def test_unported_paths_raise_naming_the_roadmap():
    """What the reference does not serve raises: the moe and encdec
    families raise from ``make_backend``, which says that the reference
    has no paged step for them; tier movement and the int8 tier are ported
    and answer for an unknown session without raising.  (The mesh's
    head-feature rung serves: tests/test_torch_features.py.)"""
    cfg = get_config("llama3-8b").reduced(dtype="float32")
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    for arch in ("qwen3-moe-30b-a3b", "seamless-m4t-medium"):
        with pytest.raises(NotImplementedError,
                           match="no paged serving step"):
            make_backend(get_config(arch), model, params, device="cpu")
    be = RealBackend(cfg, model, params, device="cpu")
    assert be.quantize_session("s") == 0
    assert be.prefetch("s", [0]) == []
    assert be.export_session("s") is None
    assert be.recover_session("s") is None
    assert be.persist("s") is False                 # no spool: nothing claimed
    assert not be.spool_exists("s")
    be.swap_out("s", 4)
    be.evict_layer("s", 0)
    be.crash()
    assert be.stats["swaps_out"] == be.stats["layer_evictions"] == 0


def test_cost_model_defaults_are_one_h100():
    hw = HardwareSpec()
    assert (hw.chips_per_replica, hw.peak_flops, hw.hbm_bw, hw.hbm_bytes) \
        == (1, 989e12, 3.35e12, 80e9)
    cfg = get_config("llama3-8b")
    cost = CostModel(cfg)
    assert cost.param_bytes() == 2 * get_model(cfg, device="meta").param_count()
    assert 0 < cost.hbm_kv_budget() < hw.hbm_bytes
