"""arch family -> model class resolution, as in the JAX package: the dense
and vlm families resolve to `DenseLM`, moe to `MoELM`, encdec to
`EncDecLM`, hybrid and mamba2 to `Zamba2LM`, xlstm to `XLSTMLM`."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def get_model(cfg: ModelConfig, device="cuda"):
    """The model of ``cfg`` on ``device`` ("meta" builds one for its
    analytic counts only, with no weights and no card)."""
    if cfg.family in ("dense", "vlm"):
        from repro_torch.models.transformer import DenseLM
        return DenseLM(cfg, device=device)
    if cfg.family == "moe":
        from repro_torch.models.moe import MoELM
        return MoELM(cfg, device=device)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg, device=device)
    if cfg.family in ("hybrid", "mamba2"):
        from repro_torch.models.mamba2 import Zamba2LM
        return Zamba2LM(cfg, device=device)
    if cfg.family == "xlstm":
        from repro_torch.models.xlstm import XLSTMLM
        return XLSTMLM(cfg, device=device)
    raise KeyError(cfg.family)
