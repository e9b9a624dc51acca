"""run.py: no result without a card, nothing of JAX or the JAX package on
its import path, and, with the chip check skipped, whole runs at a test
size on the CPU."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from symphony_bench import run

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"



@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the whole-run tests time a window on the
    wall clock, and several test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli(cwd, env=None):
    e = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {}))
    return subprocess.run(
        [sys.executable, "symphony_bench/run.py", "--workload",
         "yi6b-docchat-resident", "--seed", str(2**31 + 9), "--seconds",
         "1", "--trace", "0"], cwd=cwd, env=e, capture_output=True,
        text=True, timeout=120)


def test_no_card_no_result():
    p = _cli(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "symphony_bench", tmp_path / "symphony_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_import_path_holds_no_jax():
    """The modules a run imports, loaded in a fresh interpreter (free of
    the root conftest.py, which imports the JAX package)."""
    code = (
        "import sys, runpy; "
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]; "
        "g = runpy.run_path('symphony_bench/run.py', run_name='guard'); "
        "g['program_modules'](); "
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    top = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "symphony_bench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def _run(cell, seed, trace=False):
    return run.run_cell(cell, seed, 3.0, trace, "cpu", root=DATA, data=DATA,
                        t_origin=run.clock())


@pytest.mark.parametrize("cell", ["tiny-agent", "tiny-chat"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run(cell, trace):
    out = _run(cell, 2**31 + 21, trace)
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    names = set(out["metrics"])
    if trace:
        assert "engine.step_ms" in names
        assert ("rows.real_share" in names) == (cell == "tiny-chat")
    else:
        lat = ({"tbt_p50_ms"} if cell == "tiny-agent"
               else {"ttft_p95_ms", "tbt_p99_ms"})
        assert names == lat | {"turn_tok_s", "setup_s"}
    json.dumps(out)
    tiered = out["window_counters"]["quantized_pages"] > 0
    assert tiered == (cell == "tiny-agent")
