"""BENCHMARK.json and every file it names load by name and keep to the
benchmark's contract."""
import json
import re
from pathlib import Path

import pytest

from symphony_bench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden_size", "intermediate_size", "head_dim")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["symphony_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    f = run.config_file(BENCH, c["name"], ROOT)
    assert NAME.match(c["name"]) and f["name"] == c["name"]
    assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
    assert not set(c["reduced"]) & set(WIDTHS)
    cfg = run.family(f["family"]).sizes(f)
    assert cfg["n_heads"] % cfg["n_kv_heads"] == 0
    assert c["file"].startswith("symphony_bench/")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files(w):
    assert NAME.match(w["name"]) and w["chips"] in (1, 4)
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    mix = run.traffic_file(w["traffic"])
    assert mix["sessions"] > 0 and mix["pool"]["hbm_pages"] <= \
        mix["pool"]["n_pages"]
    lim = run.cell_file(w["name"])
    assert lim["max_logit_gap"] > 0 and lim["sample_tokens"] > 0
    run.config_file(BENCH, w["config"], ROOT)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", names)) <= names
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert run.end_to_end(m["name"], {"turn_tok_s": 1.0, "setup_s": 1.0},
                              {"ttft": [1.0], "tbt": [1.0]}) is not None
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert callable(run.metric_reader(m["name"]))
