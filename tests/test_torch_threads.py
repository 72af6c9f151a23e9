"""torch's intra-op threads, capped per test worker.

The tier-1 run spreads the test files over several pytest-xdist workers
on one machine, and each worker's torch would start a thread per CPU.
With six workers on eight CPUs, test_torch_cull.py took 793 s of one
worker where it takes seconds alone. Every tests/test_torch_*.py file
calls `cap_torch_threads()` when it is imported, which gives each worker
an equal share of the CPUs (all of them in a run without workers).
"""

import os

import torch


def cap_torch_threads():
    """Set torch's intra-op threads to the CPUs / the xdist workers
    (at least 1); returns the count."""
    workers = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    n = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(n)
    return n


def test_threads_capped():
    n = cap_torch_threads()
    assert torch.get_num_threads() == n >= 1
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert n * max(workers, 1) <= max(os.cpu_count() or 1, workers)
