import os
import sys

# make tests/ importable from nested test dirs (tests/kernels/...) so the
# shared _hypothesis_fallback stub resolves everywhere
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    # tests that need an NVIDIA card; they skip from inside a fixture
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")
