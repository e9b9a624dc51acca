"""phi-3-vision-4.2b — phi3-mini backbone + CLIP patch stub
[hf:microsoft/Phi-3-vision-128k-instruct]. Modality frontend is a STUB:
input_specs() provides 576 precomputed 1024-d patch embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
    d_ff=8192, vocab=32064, rope_theta=10_000.0, max_context=131_072,
    n_patches=576, d_frontend=1024,
)
