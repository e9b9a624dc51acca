"""Puts the repository's root and ``src/`` on the path (the benchmark is
the package ``symphony_bench``, the program ``repro_torch``) and registers
the ``gpu`` marker: tests that need an NVIDIA card skip, with a reason,
where ``torch.cuda.is_available()`` is false.  Run them on the card with
``python3 -m pytest --confcutdir=. -m gpu tests`` from ``symphony_bench/``."""
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips where there is none")
