"""Tests of the benchmark.  Run on the CPU with ``python -m pytest
benchmark/tests -q``; the ones marked ``card`` need a CUDA card and skip
without one (decided inside each test)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")
