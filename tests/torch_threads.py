"""Each test worker's share of the CPU for torch.

pytest-xdist runs the suite in several worker processes (each is told
their number in ``PYTEST_XDIST_WORKER_COUNT``), and torch's CPU ops, and
the example scripts the tests start, each use as many threads as the
machine has cores: six workers on eight cores run ~48 compute threads on
tensors a few kilobytes wide.  On an 8-core host six concurrent runs of
``tests/test_torch_obs.py`` took 103 s with torch's default threads and
18 s with one thread each.
The fixture, which every port test module imports, gives a module's tests
``cores // workers`` threads (at least one), for torch and, through
``OMP_NUM_THREADS``, for the processes they start, and restores both after
the module; a run in one process keeps torch's defaults.  Results do not
depend on it: the comparisons hold at any thread count (the port's test
files pass with one thread, with several workers and with one).
"""
from __future__ import annotations

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    if workers <= 1:
        yield
        return
    share = max(1, (os.cpu_count() or 1) // workers)
    prev_threads, prev_env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(share)
    os.environ["OMP_NUM_THREADS"] = str(share)
    try:
        yield
    finally:
        torch.set_num_threads(prev_threads)
        if prev_env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = prev_env
