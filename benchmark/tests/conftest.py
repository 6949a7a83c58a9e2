"""Settings of the benchmark's own tests (``python -m pytest
benchmark/tests``; on a card machine ``-m gpu`` runs those that need it)."""

import os

# the port's and the reference's CPU runs share the test process's cores
os.environ.setdefault("OMP_NUM_THREADS", "2")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where none is visible")
