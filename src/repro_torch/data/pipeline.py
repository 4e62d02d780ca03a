"""Sharded data pipeline with background prefetch (port of
``data/pipeline.py``).

Each process makes only its shard (``batch_fn(step, shard)``); a daemon
thread keeps ``prefetch`` batches ahead of the training loop.  Batches are
a pure function of the step, so a restart is a seek: ``pipeline.seek(step)``.
The shard defaults to ``torch.distributed.get_rank()`` when a process group
is initialised, else 0.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import torch


class DataPipeline:
    def __init__(
        self,
        batch_fn: Callable[[int, int], dict],  # (step, shard) -> batch
        *,
        start_step: int = 0,
        prefetch: int = 2,
        shard: Optional[int] = None,
    ):
        self.batch_fn = batch_fn
        if shard is None:
            dist = torch.distributed
            shard = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        self.shard = shard
        self._step = start_step
        self._queue: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _worker(self, stop: threading.Event, out: queue.Queue) -> None:
        while not stop.is_set():
            with self._lock:
                if stop.is_set():  # a seek moved the stream on: take no step of it
                    return
                step = self._step
                self._step += 1
            batch = self.batch_fn(step, self.shard)
            while not stop.is_set():
                try:
                    out.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def start(self) -> "DataPipeline":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker, args=(self._stop, self._queue), daemon=True)
            self._thread.start()
        return self

    def seek(self, step: int) -> None:
        """Restart the stream at ``step`` (restore / elastic resume)."""
        self.stop()
        with self._lock:
            self._step = step
        self._queue = queue.Queue(maxsize=self._queue.maxsize)
        self._stop = threading.Event()
        self.start()

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        self.start()
        while True:
            yield self._queue.get()

    def next(self) -> tuple[int, dict]:
        self.start()
        return self._queue.get()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
