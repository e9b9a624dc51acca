"""Model/shape configuration substrate.

Every assigned architecture instantiates :class:`ModelConfig`; every
benchmark/dry-run cell instantiates :class:`ShapeCell`.  These are plain
frozen dataclasses so they can be hashed into cache keys and serialized
into result JSON.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int          # per-expert FFN hidden dim
    n_shared_experts: int = 0
    router_jitter: float = 0.0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block parameters (zamba2)."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256           # SSD chunk length


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block pattern: ``m_per_group`` mLSTM then ``s_per_group`` sLSTM."""
    m_per_group: int = 7
    s_per_group: int = 1
    proj_factor: float = 2.0   # mLSTM up-projection
    slstm_proj_factor: float = 4.0 / 3.0
    conv_kernel: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str        # dense | moe | encdec | hybrid | mamba2 | xlstm | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # --- options ---
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    qk_norm: bool = False
    max_context: int = 131_072
    sliding_window: Optional[int] = None   # used by hybrid attn at long ctx
    dtype: str = "bfloat16"
    # --- family-specific ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # enc-dec (seamless)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    d_frontend: int = 0        # stub frame/patch embedding dim
    # hybrid (zamba2): a shared attn+mlp block applied every `shared_every`
    # mamba layers, alternating between `n_shared_blocks` parameter sets.
    shared_every: int = 6
    n_shared_blocks: int = 2
    # vlm (phi-3-vision)
    n_patches: int = 0
    # parallel-friendly layer grouping: n_layers must be divisible by
    # scan_group for scanned stacks; configs set this appropriately.

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 (Megatron-style) so embeddings/logits shard
        cleanly over TP=16; loss targets never index the padding."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline MODEL_FLOPS)."""
        from repro_torch.models.registry import get_model
        return get_model(self, device="meta").param_count()

    def active_param_count(self) -> int:
        from repro_torch.models.registry import get_model
        return get_model(self, device="meta").active_param_count()

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads // max(1, self.n_heads // 4))),
            d_head=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            max_context=512,
        )
        if self.family == "encdec":
            small.update(n_enc_layers=2, n_dec_layers=2, d_frontend=32)
        if self.family == "vlm":
            small.update(n_patches=8, d_frontend=32)
        if self.moe is not None:
            # capacity_factor=4 => dropless at smoke sizes, so cached-decode
            # exactly matches full-recompute (the invariant under test).
            small["moe"] = MoEConfig(
                n_experts=min(8, self.moe.n_experts), top_k=min(2, self.moe.top_k),
                d_expert_ff=64, n_shared_experts=self.moe.n_shared_experts,
                capacity_factor=4.0)
        if self.ssm is not None:
            small["ssm"] = SSMConfig(d_state=16, head_dim=16, chunk=32)
            small.update(shared_every=2, n_shared_blocks=2, n_layers=4,
                         sliding_window=self.sliding_window and 128)
        if self.xlstm is not None:
            small["xlstm"] = XLSTMConfig(m_per_group=2, s_per_group=1)
            small.update(n_layers=3, n_heads=2, n_kv_heads=2, d_head=32)
        small.update(overrides)
        return dataclasses.replace(self, name=self.name + "-smoke", **small)


# ---------------------------------------------------------------------------
# Shape cells (assigned): every LM arch is paired with these four.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeCell("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeCell("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeCell("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeCell("long_500k", "decode", 524_288, 1)

ALL_SHAPES: Tuple[ShapeCell, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(config: ModelConfig) -> Tuple[ShapeCell, ...]:
    """long_500k only for sub-quadratic (SSM/hybrid) archs — see DESIGN.md."""
    if config.family in ("hybrid", "mamba2", "xlstm"):
        return ALL_SHAPES
    return (TRAIN_4K, PREFILL_32K, DECODE_32K)
