"""Twin harness of the port's serving tests: one scenario, two packages.

`twins(kind)` gives the JAX package (attention through its jnp oracle,
``kernel_mode="ref"``) and the port (CPU tensors, plain attention) as two
`Pkg`s over the SAME weights — JAX-initialised, carried across by
`convert.params_from_numpy` — on ``llama3-8b.reduced(dtype="float32")``
with 4 kv heads (MHA) or 2 (GQA).  `recurrent_twins(family)` does the same
for the mamba2, xlstm and hybrid families (``mamba2-2.7b`` /
``xlstm-1.3b`` / ``zamba2-2.7b`` ``.reduced(dtype="float32")``, or
bfloat16 on request), whose backend is the factory ``make_backend``
(`StateBackend` for all three); `vlm_twins` for phi-3-vision, which
``make_backend`` serves text-only through `RealBackend`; `minicpm_twins`
for minicpm-2b (MHA, tied embeddings).  A test runs its
scenario once per `Pkg` and asserts the two agree (tokens, counters,
invariants) and that the port's tokens equal the port's dense
prefill/decode recompute.

Both cost models get the JAX package's v5e figures (`V5E`): the port's
defaults are the H100 data sheet, so its quantize-or-swap and stall
decisions would otherwise differ from JAX's on the same trace.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import jax
import numpy as np
import torch

from repro import configs as jconfigs
from repro.core import advisory as jadvisory
from repro.core.node_manager import NodeManager as JaxManager
from repro.models.registry import get_model as jax_model
from repro.serving import backend as jbackend
from repro.serving.cost_model import CostModel as JaxCost
from repro.serving.cost_model import HardwareSpec as JaxHardware
from repro.serving.engine import NodeEngine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import advisory as tadvisory
from repro_torch.core.node_manager import NodeManager
from repro_torch.models.registry import get_model
from repro_torch.serving import backend as tbackend
from repro_torch.serving.cost_model import CostModel, HardwareSpec
from repro_torch.serving.engine import NodeEngine

GEN = 6
PAGE = 8
V5E = dataclasses.asdict(JaxHardware(chips_per_replica=1))


@dataclasses.dataclass
class Pkg:
    """One package's entry points and the model it serves."""
    name: str
    cfg: Any
    model: Any
    params: Any
    Request: Any
    Advisory: Any
    Manager: Any
    Engine: Any
    Cost: Any
    Hardware: Any
    Backend: Any
    LostKV: Any
    backend_kw: Dict

    def cost(self):
        cost = self.Cost(self.cfg, self.Hardware(**V5E))
        cost.set_param_count(self.model.param_count())
        return cost

    def node(self, n_pages=32, page_size=PAGE, node_id=0, max_batch=4,
             engine_kw=None, **backend_kw):
        """(cost, manager, backend, engine) of one serving node."""
        cost = self.cost()
        mgr = self.Manager(node_id, self.cfg, cost)
        be = self.Backend(self.cfg, self.model, self.params, mgr=mgr,
                          n_pages=n_pages, page_size=page_size,
                          **self.backend_kw, **backend_kw)
        eng = self.Engine(node_id, self.cfg, cost, mgr, max_batch=max_batch,
                          backend=be, **(engine_kw or {}))
        return cost, mgr, be, eng


def same_weights(jcfg, cfg, seed):
    """(JAX model, JAX params, port model, port params) over the same
    weights: JAX initialises them from ``seed`` and the port (on the CPU)
    takes a numpy copy through `convert.params_from_numpy`."""
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    tm = get_model(cfg, device="cpu")
    tp = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jm, jp, tm, tp


def _pkgs(jcfg, cfg, jbackend_cls, tbackend_cls, seed):
    jm, jp, tm, tp = same_weights(jcfg, cfg, seed)
    jpkg = Pkg("jax", jcfg, jm, jp, jadvisory.InferenceRequest,
               jadvisory.AdvisoryRequest, JaxManager, JaxEngine, JaxCost,
               JaxHardware, jbackend_cls, jbackend.LostKV,
               dict(kernel_mode="ref"))
    tpkg = Pkg("torch", cfg, tm, tp, tadvisory.InferenceRequest,
               tadvisory.AdvisoryRequest, NodeManager, NodeEngine, CostModel,
               HardwareSpec, tbackend_cls, tbackend.LostKV,
               dict(device="cpu"))
    return jpkg, tpkg


RECURRENT = {"mamba2": "mamba2-2.7b", "hybrid": "zamba2-2.7b",
             "xlstm": "xlstm-1.3b"}


@functools.lru_cache(maxsize=None)
def recurrent_twins(family: str, seed: int = 0, dtype: str = "float32"):
    """(JAX Pkg, port Pkg) of a recurrent family with the same weights;
    family: mamba2 | hybrid | xlstm."""
    name = RECURRENT[family]
    jcfg = jconfigs.get_config(name).reduced(dtype=dtype)
    cfg = tconfigs.get_config(name).reduced(dtype=dtype)
    return _pkgs(jcfg, cfg, jbackend.make_backend, tbackend.make_backend,
                 seed)


@functools.lru_cache(maxsize=None)
def vlm_twins(seed: int = 0, dtype: str = "float32"):
    """(JAX Pkg, port Pkg) of ``phi-3-vision-4.2b.reduced()`` with the same
    weights, served text-only through ``make_backend`` (`RealBackend` in
    both packages)."""
    name = "phi-3-vision-4.2b"
    jcfg = jconfigs.get_config(name).reduced(dtype=dtype)
    cfg = tconfigs.get_config(name).reduced(dtype=dtype)
    return _pkgs(jcfg, cfg, jbackend.make_backend, tbackend.make_backend,
                 seed)


@functools.lru_cache(maxsize=None)
def twins(kind: str = "gqa", seed: int = 0, dtype: str = "float32",
          n_layers: int = 4):
    """(JAX Pkg, port Pkg) with the same weights; kind: mha | gqa."""
    n_kv = dict(mha=4, gqa=2)[kind]
    jcfg = jconfigs.get_config("llama3-8b").reduced(
        dtype=dtype, n_kv_heads=n_kv, n_layers=n_layers)
    cfg = tconfigs.get_config("llama3-8b").reduced(
        dtype=dtype, n_kv_heads=n_kv, n_layers=n_layers)
    return _pkgs(jcfg, cfg, jbackend.RealBackend, tbackend.RealBackend, seed)


@functools.lru_cache(maxsize=None)
def minicpm_twins(seed: int = 0, dtype: str = "float32", **cut):
    """(JAX Pkg, port Pkg) of ``minicpm-2b.reduced(dtype=dtype, **cut)``
    with the same weights: MHA (every head its own kv head) with tied
    embeddings, served by `RealBackend`."""
    name = "minicpm-2b"
    jcfg = jconfigs.get_config(name).reduced(dtype=dtype, **cut)
    cfg = tconfigs.get_config(name).reduced(dtype=dtype, **cut)
    return _pkgs(jcfg, cfg, jbackend.RealBackend, tbackend.RealBackend, seed)


def turns(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, cfg.vocab, n))) for n in lens]


def recompute(tpkg: Pkg, turn_ids, gen=GEN):
    """Greedy multi-turn serve by full recompute each turn, on the port's
    dense prefill/decode."""
    cfg, model, params = tpkg.cfg, tpkg.model, tpkg.params
    history, out = [], []
    for t in turn_ids:
        history = history + list(t)
        logits, cache = model.prefill(params, torch.tensor([history]))
        cache = model.grow_cache(cache, gen)
        outs = []
        for _ in range(gen):
            nxt = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
            outs.append(int(nxt[0]))
            logits, cache = model.decode_step(params, cache, nxt)
        out.append(outs)
        history = history + outs
    return out


def check_invariants(mgr, be):
    """Allocator and store conservation at a drain point (slot and
    per-application page allocators for a `StateBackend`)."""
    if hasattr(be, "slots"):
        be.slots.check()
        allocs = be.kv_alloc
    else:
        allocs = be.alloc
    for a in allocs:
        a.check()
    mgr.store.check()


def serve_to_end(eng, reqs, mgr, be, now=0.0, hook=None):
    """Submit ``reqs`` and step until the engine is idle, checking the
    allocator and store invariants at every step edge (a drain point)."""
    for r in reqs:
        eng.submit(r)
    while eng.waiting or eng.running:
        now += eng.step(now)
        check_invariants(mgr, be)
        if hook is not None:
            hook(now)
    return now


def counters(be, keys=("swaps_out", "swaps_in", "layer_evictions",
                       "layer_promotions", "migrations_in", "disk_writes",
                       "prefix_hits", "shared_tokens", "cow_forks",
                       "quantized_pages", "quant_dispatches", "dequant_forks",
                       "admit_quantized", "prefills", "decode_steps",
                       "sub_dispatches", "split_steps", "copied_bytes")):
    return {k: be.stats[k] for k in keys}
