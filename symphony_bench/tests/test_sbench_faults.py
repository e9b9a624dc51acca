"""The comparison that decides ``correct`` fails a run whose served tokens
are altered where they are produced, or whose steps leave the cache as
they found it, and its float8 control reads above the limit while the
program reads below it (the test size's own limit)."""
import pytest
import torch

from repro_torch.models.transformer import DenseLM
from symphony_bench import judge, run
from symphony_bench.tests.test_sbench_run import DATA



@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the whole-run tests time a window on the
    wall clock, and several test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _altered_token(step):
    """The served token changed where the step produces it."""
    def faulty(self, *a, **k):
        toks, logits = step(self, *a, **k)
        toks = toks.clone()
        toks[0] = (toks[0] + 1) % self.cfg.vocab
        return toks, logits
    return faulty


def _state_unchanged(step):
    """The step returns the cache as it found it: its KV never lands in
    the pools (arguments 3 and 4 of ``step_paged``)."""
    def faulty(self, params, token_ids, k_pool, v_pool, *a, **k):
        k0, v0 = k_pool.clone(), v_pool.clone()
        out = step(self, params, token_ids, k_pool, v_pool, *a, **k)
        k_pool.copy_(k0)
        v_pool.copy_(v0)
        return out
    return faulty


@pytest.mark.parametrize("cell", ["tiny-agent", "tiny-chat"])
@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged],
                         ids=["altered_token", "state_unchanged"])
def test_fault_is_not_correct(monkeypatch, fault, cell):
    monkeypatch.setattr(DenseLM, "step_paged", fault(DenseLM.step_paged))
    out = run.run_cell(cell, 2**31 + 33, 3.0, False, "cpu",
                       root=DATA, data=DATA, t_origin=run.clock())
    assert out["correct"] is False
    gap = out["checks"]["max_logit_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("cell", ["tiny-agent", "tiny-chat"])
def test_control_reads_above_the_limit(monkeypatch, cell):
    seen = {}
    worst = judge.worst_gap

    def both(weights, cfg, turns, precision="fp32", **kw):
        seen["program"] = worst(weights, cfg, turns, **kw)
        seen["control"] = worst(weights, cfg, turns, "fp8", **kw)
        return seen["program"]
    monkeypatch.setattr(judge, "worst_gap", both)
    out = run.run_cell(cell, 2**31 + 45, 3.0, False, "cpu", root=DATA,
                       data=DATA, t_origin=run.clock())
    lim = out["checks"]["max_logit_gap"]["limit"]
    assert seen["program"][0] <= lim < seen["control"][0]
