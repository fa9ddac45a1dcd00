"""Torch's CPU threads in a pytest-xdist worker: one share of the cores.

The tier-1 command runs six xdist workers on the machine's cores. Left at
its default, torch in every worker starts one intra-op thread per core, so
six workers oversubscribe the cores about six times: six concurrent runs
of tests/test_torch_sobol_recurrence.py and tests/test_torch_rng.py took
115 s at the default threads against 52 s at one thread a worker and 49 s
at two, on an 8-core machine. Every port test module imports this module,
so from collection on each worker runs torch on ceil(cores / workers)
threads. A run without xdist keeps torch's default.
"""

import os

import torch


def cpu_share(workers: int, cores: int) -> int:
    """Threads a worker gets: ceil(cores / workers), at least one."""
    return max(1, -(-cores // max(1, workers)))


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if WORKERS > 1:
    torch.set_num_threads(cpu_share(WORKERS, _cores()))
