"""Fixtures of the benchmark's tests: small copies of each cell on the
CPU, and the card for the tests that need one (decided inside the
fixture, never while a module is imported)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell at a size a test run holds, on the CPU
SMALL = {
    "orbmap.seq00": {
        "config": {"frames": 6, "slots": 64, "least_valid_slots": 48},
        "params": {"pool_per_second": 2000, "check_queries": 4,
                   "traced_requests": 2, "flip_block_rows": 128}},
}


@pytest.fixture(autouse=True, scope="session")
def one_host_thread():
    """One host thread for PyTorch's CPU ops, as ``run.py`` sets it: test
    workers side by side would otherwise oversubscribe the cores, and a
    short window could then hold a single request."""
    import torch

    torch.set_num_threads(1)


@pytest.fixture
def card():
    """The first CUDA card; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
