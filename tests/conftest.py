"""Registers the ``gpu`` marker: tests that need an NVIDIA card (they skip,
with a reason, where ``torch.cuda.is_available()`` is false).  Run them on
the card with ``python -m pytest -m gpu tests/test_torch_kernels.py``."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips where there is none")
