"""Checkpoint lifecycle: rotation, async save, preemption flush (port of
``checkpoint/manager.py``).

Concurrency contract: ``save`` may hand the write (and the rotation that
follows it) to a background thread while the train loop keeps stepping and
— on a crash path — while ``latest_step``/``restore`` scan the same
directory.  All directory mutation and scanning therefore runs under one
instance lock, and every filename check is a *full* match anchored to the
``step_N.{npz,json}`` pattern, so in-flight temp files (``.tmp_step_N.npz``)
and stray droppings never masquerade as restorable checkpoints.

Restore is fall-back-capable: a torn or corrupted newest checkpoint (power
loss mid-fsync, an injected ``torn@step`` fault) is skipped with a warning
and the previous rotated step is loaded instead — a damaged artifact costs
recomputed steps, never the run.

The async save's snapshot is a real host copy taken on the calling thread
(``checkpointer.snapshot_state``) before the writer thread starts: the
port's step and optimizer write tensors in place, so the writer must own
values that the next step cannot touch.  The ``checkpoint_saved`` event
carries a save's snapshot and write seconds and its bytes, the
``checkpoint_restored`` event a restore's seconds.
A step this manager has already saved is not written again: the loop's
exit save after a checkpoint step (or a preemption save) would rewrite the
same state, and at full width that costs seconds of disk.
"""
from __future__ import annotations

import pathlib
import re
import threading
import time
import zlib
import zipfile
from typing import Any, Callable, Optional

from repro_torch.checkpoint.checkpointer import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    snapshot_state,
)
from repro_torch.obs.events import emit_event
from repro_torch.utils.logging import get_logger

log = get_logger("ckpt-manager")
_STEP_RE = re.compile(r"step_(\d+)\.(npz|json)")

# what a torn/corrupt artifact raises out of np.load / unflatten: zip-layer
# damage, truncated members, bad headers, missing leaves.  FileNotFoundError
# (a step rotated away between scan and open) is an OSError and also lands
# here — fall back rather than die.
CORRUPT_CHECKPOINT_ERRORS = (
    zipfile.BadZipFile,
    zlib.error,
    EOFError,
    OSError,
    ValueError,
    KeyError,
)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        *,
        save_every: int = 100,
        keep: int = 3,
        async_save: bool = True,
        on_saved: Optional[Callable[[int, pathlib.Path], None]] = None,
    ):
        self.dir = pathlib.Path(directory)
        self.save_every = save_every
        self.keep = keep
        self.async_save = async_save
        # test/CI seam (runtime.inject): called with (step, npz_path) after
        # the write + rotation complete — on the writer thread when async
        self.on_saved = on_saved
        self._pending: Optional[threading.Thread] = None
        # serializes directory mutation (write+rotate, possibly on the
        # writer thread) against scans (latest/restore/available_steps)
        self._io_lock = threading.Lock()
        self._last_saved: Optional[int] = None

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, state: Any, *, force: bool = False) -> None:
        if step == self._last_saved or not (force or self.should_save(step)):
            return
        self._last_saved = step
        # Snapshot to host BEFORE handing to the writer thread: the next
        # step writes the parameters and optimizer state in place.
        t0 = time.perf_counter()
        host_state = snapshot_state(state)
        snapshot_s = time.perf_counter() - t0
        self.wait()
        if self.async_save and not force:
            self._pending = threading.Thread(
                target=self._write, args=(step, host_state, snapshot_s), daemon=True
            )
            self._pending.start()
        else:
            self._write(step, host_state, snapshot_s)

    def _write(self, step: int, state: Any, snapshot_s: float) -> None:
        t0 = time.perf_counter()
        with self._io_lock:
            path = save_checkpoint(self.dir, step, state)
            self._rotate()
        write_s = time.perf_counter() - t0
        nbytes = path.stat().st_size
        if self.on_saved is not None:
            self.on_saved(step, path)
        # after on_saved: a torn/corrupt injector has already mangled the
        # artifact, so the event describes what is actually on disk.  The
        # JSONL sink is lock-serialized — this may run on the writer thread.
        emit_event("checkpoint_saved", step=step, path=str(path),
                   async_save=self.async_save, snapshot_s=snapshot_s,
                   write_s=write_s, bytes=nbytes)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _steps_on_disk(self) -> list[int]:
        """Sorted completed-checkpoint steps; temp/stray files skipped."""
        if not self.dir.exists():
            return []
        steps = set()
        for p in self.dir.iterdir():
            m = _STEP_RE.fullmatch(p.name)
            if m:
                steps.add(int(m.group(1)))
        return sorted(steps)

    def available_steps(self) -> list[int]:
        with self._io_lock:
            return self._steps_on_disk()

    def _rotate(self) -> None:
        # caller holds _io_lock
        steps = self._steps_on_disk()
        for old in steps[: -self.keep] if self.keep else []:
            for suffix in ("npz", "json"):
                p = self.dir / f"step_{old}.{suffix}"
                try:
                    p.unlink(missing_ok=True)
                except OSError as e:  # a racing scan/unlink is not fatal
                    log.warning("rotation could not remove %s: %s", p, e)
            log.info("rotated out checkpoint step=%d", old)

    def latest(self) -> Optional[int]:
        with self._io_lock:
            return latest_step(self.dir)

    def restore(self, *, cast_to: Any = None, fill: tuple[str, ...] = (),
                step: Optional[int] = None):
        """Restore ``step`` (or the newest *readable* checkpoint); with
        ``cast_to`` each leaf as that state holds it (``cast_state``; the
        subtrees in ``fill`` may be missing).

        With ``step=None`` a torn/corrupt newest artifact falls back to the
        previous rotated step; an explicit ``step`` is the caller asserting
        that exact artifact, so damage propagates as the raw error.
        """
        with self._io_lock:
            if step is not None:
                t0 = time.perf_counter()
                out = restore_checkpoint(self.dir, step, cast_to=cast_to, fill=fill)
                emit_event("checkpoint_restored", step=step,
                           directory=str(self.dir),
                           restore_s=time.perf_counter() - t0)
                return out
            candidates = self._steps_on_disk()
            for s in reversed(candidates):
                try:
                    t0 = time.perf_counter()
                    out = restore_checkpoint(self.dir, s, cast_to=cast_to, fill=fill)
                    emit_event("checkpoint_restored", step=s,
                               directory=str(self.dir),
                               fell_back=s != candidates[-1],
                               restore_s=time.perf_counter() - t0)
                    return out
                except CORRUPT_CHECKPOINT_ERRORS as e:
                    log.warning(
                        "checkpoint step=%d unreadable (%s: %s); falling back "
                        "to the previous step", s, type(e).__name__, e,
                    )
            raise FileNotFoundError(
                f"no readable checkpoints under {self.dir} "
                f"(scanned steps {candidates})"
            )
