"""seamless-m4t-medium — enc-dec, multimodal backbone [arXiv:2308.11596].
Audio frontend is a STUB: input_specs() provides precomputed 1024-d frame
embeddings. 12 encoder + 12 decoder layers (the assigned 12L is per stack)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=24, n_enc_layers=12, n_dec_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=4096, vocab=256206, rope_theta=10_000.0, max_context=32_768,
    d_frontend=1024,
)
