"""xlstm-1.3b — sLSTM + mLSTM blocks, xLSTM[7:1] [arXiv:2405.04517].
48 blocks = 6 groups x (7 mLSTM + 1 sLSTM). d_ff=0: blocks carry their own
projections (mLSTM proj_factor=2; sLSTM ffn factor 4/3)."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="xlstm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_head=512,
    d_ff=0, vocab=50304, max_context=524_288,
    xlstm=XLSTMConfig(m_per_group=7, s_per_group=1, proj_factor=2.0),
)
