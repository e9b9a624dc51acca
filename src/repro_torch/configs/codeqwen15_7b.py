"""codeqwen1.5-7b — qwen1.5 arch (MHA kv=32) [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128,
    d_ff=13440, vocab=92416, rope_theta=1_000_000.0, max_context=65_536,
)
