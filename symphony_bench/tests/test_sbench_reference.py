"""The plain reference agrees with the port's plain CPU path at a tiny
size, and its float8 control does not."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import DenseLM
from symphony_bench import reference, run

CFG = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=128, vocab=512, rope_theta=10000.0,
           norm_eps=1e-5, max_context=4096, dtype="float32")


@pytest.fixture(scope="module")
def model_and_weights():
    m = DenseLM(ModelConfig(family="dense", **CFG), device="cpu")
    w = run.family("llama").weights(CFG, 2**31 + 3, "cpu", torch.float32)
    return m, w


def test_reference_matches_the_port_prefill(model_and_weights):
    m, w = model_and_weights
    toks = np.random.default_rng(0).integers(0, 512, 70).tolist()
    pos = [9, 40, 69]
    ref = reference.logits_at(w, CFG, toks, pos, block=16)
    with torch.no_grad():
        for i, p in enumerate(pos):
            port, _ = m.prefill(w, torch.tensor([toks[:p + 1]]),
                                kernel_mode="ref")
            assert torch.allclose(ref[i], port[0, :512].float(), atol=2e-5,
                                  rtol=1e-4)


def test_blocks_do_not_change_the_answer(model_and_weights):
    _, w = model_and_weights
    toks = np.random.default_rng(1).integers(0, 512, 50).tolist()
    a = reference.logits_at(w, CFG, toks, [20, 49], block=7)
    b = reference.logits_at(w, CFG, toks, [20, 49], block=1024)
    assert torch.allclose(a, b, atol=1e-5)


def test_fp8_control_departs(model_and_weights):
    _, w = model_and_weights
    toks = np.random.default_rng(2).integers(0, 512, 60).tolist()
    pos = list(range(20, 60))
    hi = reference.logits_at(w, CFG, toks, pos)
    lo = reference.logits_at(w, CFG, toks, pos, precision="fp8")
    err = (hi - lo).abs().max() / hi.abs().max()
    assert err > 1e-2
    served = hi.argmax(-1).tolist()
    assert float(reference.gaps(hi, served).max()) == 0.0
