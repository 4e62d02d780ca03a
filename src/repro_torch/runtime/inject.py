"""Deterministic fault injection for the fleet runtime (a copy of
``runtime/inject.py``).

The elastic/auto-restart machinery is only trustworthy if its failure paths
are *executed*, not reasoned about — and executed the same way in a unit
test, a CLI subprocess, and CI.  This module is that seam: a small set of
injectors (crash, SIGTERM, slow step, torn/corrupt checkpoint, fleet
shrink) parsed from one spec string that can arrive via ``--inject`` or the
``REPRO_FAULT_INJECT`` environment variable, so a subprocess under test
exhibits the fault without any monkeypatching.

Spec grammar (comma-separated, each injector fires at most once)::

    crash@S         raise InjectedCrash at the start of step S (retryable)
    sigterm@S       deliver SIGTERM to this process at the start of step S
                    (exercises PreemptionHandler -> checkpoint -> exit 0)
    slow@S:SECS     sleep SECS seconds inside step S (trips StepWatchdog)
    torn@S          truncate the step-S checkpoint right after it is written
                    (a torn write: restore must fall back to an older step)
    corrupt@S       overwrite the step-S checkpoint with garbage bytes
    shrink@S:K      set REPRO_ELASTIC_SHARDS=K, then crash at step S — the
                    restart sees a smaller fleet and must replan via
                    ``runtime.elastic.elastic_plan``

The launcher builds ONE ``InjectionPlan`` per process (``--fail-at-step N``
is folded in as ``crash@N``) and threads it through every ``--auto-restart``
attempt, so an injector that fired before the crash does not re-fire after
the in-process restart — exactly like a real transient fault.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Optional

from repro_torch.obs.events import emit_event
from repro_torch.utils.logging import get_logger

log = get_logger("inject")

ENV_SPEC = "REPRO_FAULT_INJECT"

_STEP_KINDS = ("crash", "sigterm", "slow", "shrink")
_CKPT_KINDS = ("torn", "corrupt")


class InjectedCrash(RuntimeError):
    """A deliberately injected, *retryable* failure (tests/CI)."""


@dataclasses.dataclass
class Injector:
    kind: str
    step: int
    value: Optional[float] = None  # slow: seconds; shrink: new shard count
    fired: bool = False

    def spec(self) -> str:
        v = "" if self.value is None else f":{self.value:g}"
        return f"{self.kind}@{self.step}{v}"


def _parse_one(item: str) -> Injector:
    item = item.strip()
    if "@" not in item:
        raise ValueError(
            f"bad fault spec {item!r}: expected kind@step[:value] "
            f"(kinds: {', '.join(_STEP_KINDS + _CKPT_KINDS)})"
        )
    kind, _, rest = item.partition("@")
    kind = kind.strip()
    if kind not in _STEP_KINDS + _CKPT_KINDS:
        raise ValueError(
            f"unknown fault kind {kind!r} in {item!r} "
            f"(kinds: {', '.join(_STEP_KINDS + _CKPT_KINDS)})"
        )
    step_s, _, value_s = rest.partition(":")
    step = int(step_s)
    value = float(value_s) if value_s else None
    if kind == "slow" and value is None:
        raise ValueError(f"slow injector needs a duration: slow@{step}:SECS")
    if kind == "shrink" and (value is None or value < 1 or value != int(value)):
        raise ValueError(
            f"shrink injector needs an integer shard count: shrink@{step}:K"
        )
    return Injector(kind=kind, step=step, value=value)


class InjectionPlan:
    """One process's fault schedule; hooks called from the train loop."""

    def __init__(self, injectors: Optional[list[Injector]] = None):
        self.injectors = injectors or []

    @classmethod
    def from_spec(
        cls, spec: Optional[str] = None, *, env: Optional[str] = None
    ) -> "InjectionPlan":
        """Parse ``--inject`` and/or ``$REPRO_FAULT_INJECT`` (both may be
        set; CLI items come first).  ``env=None`` reads the real environment
        — pass ``env=""`` to ignore it."""
        if env is None:
            env = os.environ.get(ENV_SPEC, "")
        items = [s for src in (spec or "", env) for s in src.split(",") if s.strip()]
        return cls([_parse_one(s) for s in items])

    def add_crash(self, step: int) -> None:
        self.injectors.append(Injector(kind="crash", step=step))

    def __bool__(self) -> bool:
        return bool(self.injectors)

    # -- hooks -------------------------------------------------------------
    def on_step(self, step: int) -> None:
        """Called at the start of every (logical) train step."""
        for inj in self.injectors:
            if inj.fired or inj.kind not in _STEP_KINDS or inj.step != step:
                continue
            inj.fired = True
            log.warning("fault injection: %s firing at step %d", inj.spec(), step)
            emit_event("fault_injected", step=step, spec=inj.spec(),
                       fault_kind=inj.kind)
            if inj.kind == "crash":
                raise InjectedCrash(f"injected fault at step {step}")
            if inj.kind == "shrink":
                # a shrink is a crash whose restart sees fewer hosts: mutate
                # the env the elastic replan reads, then die
                os.environ["REPRO_ELASTIC_SHARDS"] = str(int(inj.value))
                raise InjectedCrash(
                    f"injected fleet shrink to {int(inj.value)} shard(s) "
                    f"at step {step}"
                )
            if inj.kind == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
            elif inj.kind == "slow":
                time.sleep(float(inj.value))

    def on_checkpoint_saved(self, step: int, path) -> None:
        """Called after a checkpoint file is durably written (and rotated).

        Runs on the async writer thread in production configs — torn-write
        injection therefore also exercises the manager's thread-safety.
        """
        for inj in self.injectors:
            if inj.fired or inj.kind not in _CKPT_KINDS or inj.step != step:
                continue
            inj.fired = True
            log.warning(
                "fault injection: %s mangling checkpoint %s", inj.spec(), path
            )
            emit_event("fault_injected", step=step, spec=inj.spec(),
                       fault_kind=inj.kind, path=str(path))
            if inj.kind == "torn":
                tear_file(path)
            else:  # corrupt
                path.write_bytes(b"\x00garbage\x00" * 16)


def tear_file(path) -> None:
    """Truncate ``path`` to a strict prefix — a realistic torn write.

    Shared between the ``torn@S`` checkpoint injector and the obs tests
    that prove ``sinks.read_jsonl`` survives a crash-torn final line: both
    need "a prefix of the true bytes", not a missing or zeroed file.
    """
    import pathlib

    path = pathlib.Path(path)
    data = path.read_bytes()
    path.write_bytes(data[: max(1, len(data) // 3)])
