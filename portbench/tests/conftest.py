"""Tests of the benchmark harness.  They run on the CPU at tiny sizes;
the ones marked `cuda` need a GPU and skip without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (skips without one)")
