"""Minimal structured logging (port of ``utils/logging.py``).

Two fleet-scale ergonomics live here:

* the level is re-read from ``REPRO_LOG_LEVEL`` on every ``get_logger``
  call and on ``reconfigure()``: it is not frozen at the first call, so a
  supervisor (or a test) can turn debug logging on between ``--auto-restart``
  attempts without restarting the process;
* once a ``torch.distributed`` process group is initialised with more than
  one rank, every record is prefixed with this process's rank (``p0 ``,
  ``p1 ``, ...) so interleaved multi-process output stays attributable.  The
  rank is resolved lazily through ``sys.modules``: this module never imports
  torch and never initialises a process group, because ``launch/env.py``
  pins the environment before torch is imported.
"""
from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(rank)s%(name)s] %(message)s"
_LEVEL_ENV = "REPRO_LOG_LEVEL"
# every name handed out, so reconfigure() can re-level the whole family
_LOGGERS: set[str] = set()


def _rank_prefix() -> str:
    """``"p<rank> "`` on a multi-process group, else ``""``; no torch import."""
    dist = sys.modules.get("torch.distributed")
    if dist is None:
        return ""
    try:
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            return f"p{dist.get_rank()} "
    except (RuntimeError, ValueError):  # a group torn down mid-record
        return ""
    return ""


class _RankFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        record.rank = _rank_prefix()
        return True


def _env_level() -> str:
    return os.environ.get(_LEVEL_ENV, "INFO")


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        handler.addFilter(_RankFilter())
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(_env_level())
    _LOGGERS.add(name)
    return logger


def reconfigure() -> None:
    """Re-apply ``REPRO_LOG_LEVEL`` to every logger this module handed out.

    Module-level ``log = get_logger(...)`` bindings read the env once, at
    import; callers that change the level afterwards (restart supervisors,
    tests) call this to push the new level to the whole family.
    """
    level = _env_level()
    for name in _LOGGERS:
        logging.getLogger(name).setLevel(level)
