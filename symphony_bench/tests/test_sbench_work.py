"""The benchmark's frozen work formulas equal the port's at sample shapes
(the test may import the port; the benchmark may not)."""
import numpy as np
import pytest
import torch

from repro_torch.roofline import cost
from symphony_bench import work


def _lanes(rng, B, page, T, P):
    ctx = rng.integers(0, T * page + 1, B)
    ctx[0] = T * page
    qn = np.minimum(ctx, rng.integers(1, 40, B))
    qoff = ctx - qn
    tables = rng.integers(0, P, (B, T))
    return qoff, ctx, qn, tables


@pytest.mark.parametrize("B,Sq,H,hkv,D,page,quant", [
    (4, 64, 32, 32, 128, 16, False), (8, 1, 32, 4, 128, 16, False),
    (16, 32, 32, 32, 128, 16, True), (3, 512, 32, 4, 128, 16, True)])
def test_attention_work_matches_the_port(B, Sq, H, hkv, D, page, quant):
    rng = np.random.default_rng(B * Sq)
    T, P = 12, 200
    qoff, ctx, qn, tables = _lanes(rng, B, page, T, P)
    flags = rng.integers(0, 2, P + 1) if quant else None
    q = torch.empty((B, Sq, H, D), dtype=torch.bfloat16)
    ours = work.attention_work(q.shape, tables, qoff, ctx, page, hkv, D, 2,
                               qn.tolist(), flags)
    theirs = cost.attention_work(
        q, torch.as_tensor(tables), torch.as_tensor(qoff),
        torch.as_tensor(ctx), page, hkv, D, 2, qn.tolist(),
        None if flags is None else torch.as_tensor(flags))
    assert ours == theirs


def test_peaks_match_the_port():
    assert work.PEAK_BF16_FLOPS == cost.PEAK_FLOPS[torch.bfloat16]
    assert work.HBM_BYTES_PER_S == cost.HBM_BYTES_PER_S


def test_step_flops_counts_real_rows_only():
    cfg = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
               d_ff=128, vocab=512)
    qoff = np.array([0, 10, 7, 0])
    ctx = np.array([5, 11, 7, 0])          # lane 3 is padding
    per_tok = 2 * 2 * work.layer_matmul_params(cfg)
    seen = sum(range(1, 6)) + 11           # lane 2 carries no row
    want = (per_tok * 6 + 4 * 2 * 4 * 16 * seen + 2 * 64 * 512 * 3)
    assert work.step_flops(cfg, qoff, ctx) == want
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.transformer import DenseLM
    m = DenseLM(ModelConfig(name="t", family="dense", **cfg), device="cpu")
    blocks = m.param_count() - 2 * cfg["vocab"] * 64 - 64
    assert 2 * work.layer_matmul_params(cfg) + 2 * 2 * 64 == blocks
