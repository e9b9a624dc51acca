"""granite-moe-3b-a800m — 40 experts top-8, per-expert d_ff=512
[hf:ibm-granite/granite-3.0-*-base family]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_head=64,
    d_ff=512, vocab=49155, rope_theta=10_000.0, max_context=4_096,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert_ff=512),
)
