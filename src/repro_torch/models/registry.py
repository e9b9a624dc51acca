"""arch family -> model class resolution.  The dense family resolves to
`DenseLM`, the hybrid and mamba2 families to `Zamba2LM`, the xlstm family
to `XLSTMLM`; every other family raises, naming the ROADMAP item that
ports it."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

# the families still to port, each with the ROADMAP item that ports it
_NOT_PORTED = {
    "vlm": "ROADMAP A.9 (the vlm patch path of DenseLM)",
    "moe": "ROADMAP A.9 (models/moe.py)",
    "encdec": "ROADMAP A.9 (models/encdec.py)",
}


def get_model(cfg: ModelConfig, device="cuda"):
    """The model of ``cfg`` on ``device`` ("meta" builds one for its
    analytic counts only, with no weights and no card)."""
    if cfg.family == "dense":
        from repro_torch.models.transformer import DenseLM
        return DenseLM(cfg, device=device)
    if cfg.family in ("hybrid", "mamba2"):
        from repro_torch.models.mamba2 import Zamba2LM
        return Zamba2LM(cfg, device=device)
    if cfg.family == "xlstm":
        from repro_torch.models.xlstm import XLSTMLM
        return XLSTMLM(cfg, device=device)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: {_NOT_PORTED[cfg.family]}")
    raise KeyError(cfg.family)
