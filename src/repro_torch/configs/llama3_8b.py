"""llama3-8b — dense GQA, 128K vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=128256, rope_theta=500_000.0, max_context=131_072,
)
