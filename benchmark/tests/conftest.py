"""Tests of the benchmark itself, on the CPU at tiny sizes (the card tests
are marked `cuda` and skip without one):

    python -m pytest benchmark/tests -q -p no:cacheprovider

They import neither JAX nor the JAX package.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips inside the test where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def tiny_cell():
    from bench_cases import tiny
    from benchmark.harness import spec
    return lambda name, bf16=False: tiny(spec.cell(name), bf16)
