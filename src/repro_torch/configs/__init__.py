"""Architecture config registry: --arch <id> resolution."""
from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                XLSTMConfig, ShapeCell, ALL_SHAPES,
                                SHAPES_BY_NAME, shapes_for,
                                TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

from repro_torch.configs.llama3_8b import CONFIG as LLAMA3_8B
from repro_torch.configs.codeqwen15_7b import CONFIG as CODEQWEN15_7B
from repro_torch.configs.yi_6b import CONFIG as YI_6B
from repro_torch.configs.minicpm_2b import CONFIG as MINICPM_2B
from repro_torch.configs.phi3_vision_4_2b import CONFIG as PHI3_VISION_4_2B
from repro_torch.configs.granite_moe_3b import CONFIG as GRANITE_MOE_3B
from repro_torch.configs.qwen3_moe_30b import CONFIG as QWEN3_MOE_30B
from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS_M4T_MEDIUM
from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA2_2_7B
from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA2_2_7B
from repro_torch.configs.xlstm_1_3b import CONFIG as XLSTM_1_3B

ARCHS = {
    c.name: c for c in [
        LLAMA3_8B, CODEQWEN15_7B, YI_6B, MINICPM_2B, PHI3_VISION_4_2B,
        GRANITE_MOE_3B, QWEN3_MOE_30B, SEAMLESS_M4T_MEDIUM, ZAMBA2_2_7B,
        MAMBA2_2_7B, XLSTM_1_3B,
    ]
}
# short aliases for --arch
ALIASES = {
    "llama3-8b": "llama3-8b",
    "codeqwen1.5-7b": "codeqwen1.5-7b",
    "yi-6b": "yi-6b",
    "minicpm-2b": "minicpm-2b",
    "phi-3-vision-4.2b": "phi-3-vision-4.2b",
    "granite-moe-3b-a800m": "granite-moe-3b-a800m",
    "qwen3-moe-30b-a3b": "qwen3-moe-30b-a3b",
    "seamless-m4t-medium": "seamless-m4t-medium",
    "zamba2-2.7b": "zamba2-2.7b",
    "mamba2-2.7b": "mamba2-2.7b",
    "xlstm-1.3b": "xlstm-1.3b",
}


def get_config(arch: str) -> ModelConfig:
    key = ALIASES.get(arch, arch)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[key]
