"""Torch's intra-op thread count for one test process.

The suite runs under pytest-xdist with several workers on one machine,
and every worker's torch starts one OpenMP thread per core. Their
threads then contend for the same cores and the port's tests spend
their time spinning, not computing. Each ``tests/test_torch_*.py`` file
calls ``torch.set_num_threads(worker_threads())`` at import: the cores
shared out among the workers (all of them when pytest runs alone).
"""
import os


def worker_threads() -> int:
    """The machine's cores divided among the xdist workers, at least 1."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)
