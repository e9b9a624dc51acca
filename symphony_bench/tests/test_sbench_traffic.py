"""The traffic generator repeats exactly from a seed, deals every seed the
same bank of sizes, and matches the distributions its files state."""
import json
from pathlib import Path

import numpy as np
import pytest

from symphony_bench import gen

MIXES = Path(__file__).resolve().parents[1] / "traffic"
TEST_MIXES = Path(__file__).resolve().parent / "data" / "traffic"


def mix(name):
    path = MIXES / f"{name}.json"
    if not path.exists():
        path = TEST_MIXES / f"{name}.json"
    return json.loads(path.read_text())


@pytest.mark.parametrize("name", ["tiny-agent", "docchat-resident"])
def test_seed_repeats_and_deals_one_bank(name):
    m = mix(name)
    a, b, c = (gen.Deal(m, s, 1000) for s in (2**31 + 11, 2**31 + 11, 5))
    assert a.system == b.system and a.system != c.system
    ia, ib, ic = a.initial(), b.initial(), c.initial()
    assert len(ia) == m["sessions"]
    # every seed deals the same sessions; only the token ids differ
    assert [s.turns for s in ia] == [s.turns for s in ib] == \
        [s.turns for s in ic]
    assert [(s.age, s.offset) for s in ia] == [(s.age, s.offset) for s in ic]
    ids = [a.turn_ids(a.token_rng(3), s.turns[0]) for s in ia[:3]]
    assert ids == [b.turn_ids(b.token_rng(3), s.turns[0]) for s in ib[:3]]
    assert ids != [c.turn_ids(c.token_rng(3), s.turns[0]) for s in ic[:3]]
    fa = [a.fresh().turns for _ in range(3)]
    assert fa == [c.fresh().turns for _ in range(3)]
    assert fa[0] == a.scripts[m["sessions"]].turns


@pytest.mark.parametrize("spec", [
    {"dist": "lognormal", "mu": 6.643789733147672, "sigma": 0.8,
     "lo": 128, "hi": 4096},
    {"dist": "lognormal", "mu": 3.4, "sigma": 0.9, "lo": 4, "hi": 2048},
    {"dist": "lognormal", "mu": 5.3, "sigma": 0.7, "lo": 8, "hi": 2048},
    {"dist": "lognormal", "mu": 0.6931471805599453, "sigma": 0.8,
     "lo": 0.5, "hi": 10.0, "unit": "s"}])
def test_lognormal_draws(spec):
    x = gen.draw(spec, np.random.default_rng(0), 200_000)
    assert x.min() >= spec["lo"] and x.max() <= spec["hi"]
    # token counts are truncated to whole tokens, as in ShareGPT's draws
    med = np.exp(spec["mu"])
    assert abs(np.median(x) - med) <= max(0.02 * med, 1.0)
    inside = x[(x > spec["lo"] * 1.01) & (x < spec["hi"] * 0.99)]
    # the spread of the log between the quartiles is 1.349 sigma
    q1, q3 = np.quantile(np.log(inside), [0.25, 0.75])
    assert abs((q3 - q1) / 1.349 / spec["sigma"] - 1) < 0.1


def test_uniform_and_scale():
    x = gen.draw({"dist": "uniform_int", "lo": 2, "hi": 8, "scale": 128},
                 np.random.default_rng(1), 100_000)
    assert set(np.unique(x)) == {128 * k for k in range(2, 9)}
    assert abs(x.mean() / 640 - 1) < 0.01


def test_agent_sessions():
    m = mix("tiny-agent")
    b = gen.bank(m)
    assert {len(s.turns) for s in b} == set(range(2, 5))
    for s in b:
        assert 0 <= s.age < len(s.turns) and s.done == -1
        assert s.turns[0].think == 0
        for t in s.turns[1:]:
            assert 0.02 <= t.think <= 0.3 and t.lead == t.think
            assert 8 <= t.prompt <= 64
        assert 16 <= s.turns[0].prompt <= 64
        assert all(4 <= t.reply <= 12 for t in s.turns)


@pytest.mark.parametrize("name", ["tiny-chat", "docchat-resident"])
def test_in_flight_sessions(name):
    """The first ``in_flight`` sessions are mid-reply, due at once, with at
    least one reply token left after the one set-up emits; the bank's
    sizes and the other sessions are as without them."""
    m = mix(name)
    k = m["in_flight"]
    b = gen.bank(m)
    plain = gen.bank(dict(m, in_flight=0))
    assert [s.turns for s in b] == [s.turns for s in plain]
    assert [(s.age, s.offset) for s in b[k:]] == \
        [(s.age, s.offset) for s in plain[k:]]
    for s in b[:k]:
        assert s.offset == 0.0
        assert 0 <= s.done <= s.turns[s.age].reply - 2
    assert all(s.done == -1 for s in b[k:])
    assert k <= m["sessions"] and k <= m["max_batch"]


def test_docchat_sessions():
    m = mix("docchat-resident")
    for s in gen.bank(m):
        ctx = m["system_prompt"] + sum(t.prompt + t.reply for t in s.turns)
        assert ctx <= m["context_cap"] or len(s.turns) == 1
        for prev, t in zip(s.turns, s.turns[1:]):
            assert t.lead == pytest.approx(t.typed / 3.5)
            assert t.think == pytest.approx(prev.reply / 4.9 + t.typed / 3.5)
            assert (t.prompt - t.typed) % 128 == 0
            assert 2 <= (t.prompt - t.typed) // 128 <= 8
