"""Settings of the benchmark's own tests (``python -m pytest
perfbench/tests``). They run on the CPU at tiny sizes; a test that needs
the card carries the ``cuda`` marker and decides in a fixture."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped without one")
