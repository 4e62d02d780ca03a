"""Ranks of a ``torch.distributed`` gloo fleet on the CPU, for the port's
tests: ``run_ranks(fn, n, *args)`` spawns ``n`` processes (``spawn``, never
``fork``), joins them in one process group over a free localhost port,
calls ``fn(rank, n, *args)`` on each and returns the results in rank order.
``start_ranks`` does the same without waiting, so that several fleets run
at once; its ``Fleet.result()`` waits.  A rank that raises fails the call
with its traceback; the wait is bounded by ``timeout`` seconds from the
start.  Each rank gets ``threads`` torch threads, by default the test
worker's divided by ``n`` (``tests/torch_threads.py``).  ``fn`` and its
results must pickle: a module-level function of a module under ``tests/``
that imports no JAX, and CPU tensors or plain values.
"""
from __future__ import annotations

import queue
import socket
import time
import traceback

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, n: int, port: int, threads: int, out, fn, args) -> None:
    torch.set_num_threads(threads)
    dist = torch.distributed
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=n)
        try:
            out.put((rank, "ok", fn(rank, n, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        out.put((rank, "error", traceback.format_exc()))


class Fleet:
    """``n`` started ranks of one process group; ``result()`` waits for them."""

    def __init__(self, fn, n: int, args: tuple, timeout: float, threads: int):
        ctx = mp.get_context("spawn")
        self.n, self.out = n, ctx.Queue()
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        port = free_port()
        self.procs = [ctx.Process(target=_entry, args=(r, n, port, threads, self.out, fn, args),
                                  daemon=True) for r in range(n)]
        for p in self.procs:
            p.start()

    def result(self) -> list:
        n, procs = self.n, self.procs
        results: dict = {}
        try:
            while len(results) < n:
                try:
                    rank, status, value = self.out.get(timeout=1.0)
                except queue.Empty:
                    if time.monotonic() > self.deadline:
                        raise TimeoutError(f"{n - len(results)} of {n} ranks gave no result "
                                           f"within {self.timeout} s") from None
                    if all(p.exitcode is not None for p in procs):  # died without a word
                        raise RuntimeError("ranks exited without a result: exit codes "
                                           f"{[p.exitcode for p in procs]}") from None
                    continue
                if status != "ok":
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                results[rank] = value
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        return [results[r] for r in range(n)]


def start_ranks(fn, n: int, *args, timeout: float = 300.0,
                threads: int | None = None) -> Fleet:
    return Fleet(fn, n, args, timeout,
                 threads or max(1, torch.get_num_threads() // n))


def run_ranks(fn, n: int, *args, timeout: float = 300.0) -> list:
    return start_ranks(fn, n, *args, timeout=timeout).result()
