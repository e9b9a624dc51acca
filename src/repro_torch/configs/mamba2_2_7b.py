"""mamba2-2.7b — pure Mamba2 (SSD) backbone, no attention [arXiv:2405.21060].
64 Mamba2 layers, O(1) recurrent state per session: the extreme SYMPHONY
case — session state is a fixed-size blob (SSM heads + conv tail), so
migration is one atomic copy and recompute is maximally redundant.
``shared_every`` only sets the layer-group scan width (divides n_layers);
there are no shared attention blocks in this family."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="mamba2",
    n_layers=64, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=0, vocab=32000, max_context=524_288,
    shared_every=8, n_shared_blocks=0,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
)
