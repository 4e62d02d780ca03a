"""Elastic scaling (a copy of ``runtime/elastic.py``): recompute the run
layout when the fleet size changes.

Checkpoints store logical arrays (see checkpoint/), so a restart on a
different mesh only needs (a) new shardings, (b) a data layout that keeps the
*logical* batch (and therefore the DP sampling rate q — the privacy
accounting is unchanged) while re-splitting it across the surviving hosts.

The launcher (``launch/train.py``) calls ``elastic_plan`` on every start —
including every ``--auto-restart`` attempt — with the shard count of the
fleet it actually has (``current_data_shards``: ``--data-shards`` or the
``REPRO_ELASTIC_SHARDS`` environment the scheduler sets).  A shrink never
changes the logical batch: lost parallelism becomes extra gradient
accumulation, so the microbatch stream (per-shard batch, order) is
preserved and a resumed run is bit-identical to an uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

from repro_torch.utils.logging import get_logger

log = get_logger("elastic")

ENV_SHARDS = "REPRO_ELASTIC_SHARDS"


def current_data_shards(cli_value: Optional[int] = None) -> int:
    """The data-parallel degree of the fleet this process launched into.

    Precedence: an explicit CLI value, then ``$REPRO_ELASTIC_SHARDS`` (the
    restart-time seam — the scheduler, or a ``shrink@step`` fault injector,
    updates it between attempts), then 1.
    """
    if cli_value:
        return int(cli_value)
    env = os.environ.get(ENV_SHARDS, "").strip()
    return int(env) if env else 1


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data_shards: int
    per_shard_batch: int
    accumulation_steps: int
    note: str

    def execution(self, n_processes: int = 1) -> tuple[int, int]:
        """Map the fleet plan onto ``n_processes`` as (microbatch, accum).

        With one process per shard the global physical microbatch is
        ``per_shard_batch * data_shards`` (the mesh shards it over the data
        axis).  With FEWER processes than shards — always, in single-host
        tests simulating a fleet — each process serializes its share of the
        shards into extra accumulation microsteps: the per-shard microbatch
        programs and their order are unchanged, which is exactly what makes
        a shrunk-fleet resume bit-identical to the uninterrupted run.
        """
        if n_processes < 1:
            raise ValueError(f"n_processes must be >= 1, got {n_processes}")
        par = min(self.data_shards, n_processes)
        if self.data_shards % par != 0:
            raise ValueError(
                f"data_shards={self.data_shards} does not divide over "
                f"{n_processes} process(es); choose a shard count that is a "
                "multiple of the process count"
            )
        serial = self.data_shards // par
        return self.per_shard_batch * par, self.accumulation_steps * serial


def elastic_plan(
    *, logical_batch: int, data_shards: int, max_per_shard: int
) -> ElasticPlan:
    """Keep the logical batch constant; grow accumulation when shards shrink.

    DP invariant: sampling rate q = logical_batch / N must not change across
    restarts, else the accountant's composition is wrong.  So the logical
    batch is held fixed and the lost throughput is absorbed by gradient
    accumulation (the paper's virtual-step machinery).

    Raises ``ValueError`` on impossible layouts (non-dividing shard counts)
    — a *config* error the ``--auto-restart`` supervisor classifies as
    non-retryable, since retrying a deterministic misconfiguration only
    burns the restart budget.
    """
    if data_shards < 1:
        raise ValueError(f"data_shards must be >= 1, got {data_shards}")
    if max_per_shard < 1:
        raise ValueError(f"max_per_shard must be >= 1, got {max_per_shard}")
    if logical_batch % data_shards != 0:
        raise ValueError(
            f"logical batch {logical_batch} must divide over {data_shards} "
            "shards; choose a shard count that divides it"
        )
    per_shard = logical_batch // data_shards
    accum = 1
    while per_shard > max_per_shard:
        if per_shard % 2 != 0:
            raise ValueError(
                f"per-shard batch {per_shard} exceeds max_per_shard="
                f"{max_per_shard} and is odd — cannot halve into equal "
                "accumulation microsteps; adjust the logical batch or cap"
            )
        accum *= 2
        per_shard //= 2
    plan = ElasticPlan(
        data_shards=data_shards,
        per_shard_batch=per_shard,
        accumulation_steps=accum,
        note=f"logical batch {logical_batch} preserved; q unchanged",
    )
    log.info("elastic plan: %s", plan)
    return plan
