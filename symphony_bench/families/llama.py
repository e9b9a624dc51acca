"""The llama-shaped dense decoder (``LlamaForCausalLM`` and the models
that share its block): the port's ``DenseLM`` serving it, its weights made
from the seed, and the plain reference that judges it (``reference.py``).

A family file gives a run everything that depends on the model's kind,
found by the configuration file's ``family``:

- ``sizes(cfile)``: the sizes a run builds from, with the port's names;
- ``build(cfg, device)``: the port's model config and model;
- ``weights(cfg, seed, device, dtype)``: the weights, drawn on ``device``;
- ``logits_at`` and ``gaps``: the plain reference (it imports nothing of
  the program).
"""
from __future__ import annotations

from typing import Dict

from symphony_bench.reference import gaps, logits_at  # noqa: F401


def sizes(cfile: Dict) -> Dict:
    p = cfile["published"]
    H = p["num_attention_heads"]
    return dict(name=cfile["name"], n_layers=p["num_hidden_layers"],
                d_model=p["hidden_size"], n_heads=H,
                n_kv_heads=p["num_key_value_heads"],
                d_head=p["hidden_size"] // H, d_ff=p["intermediate_size"],
                vocab=p["vocab_size"], rope_theta=float(p["rope_theta"]),
                norm_eps=float(p["rms_norm_eps"]),
                max_context=p["max_position_embeddings"],
                dtype=cfile["dtype"])


def build(cfg: Dict, device):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.transformer import DenseLM
    mcfg = ModelConfig(family="dense", **cfg)
    return mcfg, DenseLM(mcfg, device=device)


def weights(cfg: Dict, seed: int, device, dtype) -> Dict:
    """Random weights from ``seed``, drawn on ``device`` in ``dtype`` one
    stacked tensor a kind (the port's layout: (in, out) matrices stacked
    over the layers, embeddings (padded vocab, d_model)): normal with
    1/sqrt(fan_in), the embeddings at 0.02, the norms' gains about 1."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    L, d, ff = cfg["n_layers"], cfg["d_model"], cfg["d_ff"]
    q, kv = cfg["n_heads"] * cfg["d_head"], cfg["n_kv_heads"] * cfg["d_head"]
    vp = -(-cfg["vocab"] // 256) * 256

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dtype).mul_(scale)

    def gain(shape):
        return normal(shape, 0.1).add_(1.0)

    return dict(
        emb=normal((vp, d), 0.02), lm_head=normal((vp, d), 0.02),
        ln_f=gain((d,)),
        blocks=dict(
            ln1=gain((L, d)), ln2=gain((L, d)),
            wq=normal((L, d, q), d ** -0.5), wk=normal((L, d, kv), d ** -0.5),
            wv=normal((L, d, kv), d ** -0.5), wo=normal((L, q, d), q ** -0.5),
            w1=normal((L, d, ff), d ** -0.5), w3=normal((L, d, ff), d ** -0.5),
            w2=normal((L, ff, d), ff ** -0.5)))
