"""minicpm-2b — llama-like, MHA 36 heads (WSD schedule) [arXiv:2404.06395]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_head=64,
    d_ff=5760, vocab=122753, rope_theta=10_000.0, max_context=32_768,
    tie_embeddings=True,
)
