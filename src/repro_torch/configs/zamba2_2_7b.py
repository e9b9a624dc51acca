"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].
54 Mamba2 layers; a shared (attn+MLP) block (2 alternating parameter sets)
runs before every 6th Mamba layer. Attention uses a 4096 sliding window at
long context (sub-quadratic adaptation, see DESIGN.md)."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10240, vocab=32000, rope_theta=10_000.0, max_context=524_288,
    sliding_window=4096, shared_every=6, n_shared_blocks=2,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
)
