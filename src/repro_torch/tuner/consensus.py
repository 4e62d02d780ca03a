"""Multi-process plan agreement: one ClipPlan, byte-identical on every rank
(port of ``tuner/consensus.py`` over ``torch.distributed``).

Every rank of a data-parallel fleet runs the same program, and the per-tap
branch choice (ghost vs instantiated norms, ghost book vs psg bank) decides
which collectives that program issues and in which order (the weight
gathers and reduce-scatters of ``parallel.reshard`` ride on the backward).
The branch choice is *measured*, and measurements differ between ranks by
timer noise or by device kind: two ranks running different branches for
one tap deadlock or silently diverge.  So every rank adopts one plan
before its first step.

Protocol (three phases, all deterministic given the gathered reports):

1. **roles**: every rank gathers ``(process_index, device_string)``; the
   lowest process index per device kind is that kind's leader, and only
   leaders measure.
2. **agree**: the leaders' plans (canonical JSON) are all-gathered and
   every rank runs the same pure function ``agree()`` over them: one
   fingerprint and one policy everywhere, the leader's plan with one device
   kind, the kind of lowest median step cost with several, the minimum
   certified physical batch, stamped with its provenance.
3. **certify**: every rank gathers its adopted plan's ``consensus_hash()``
   and fails unless all are equal.

The gather primitive is injectable (``gather_fn(payload) -> [payloads]``):
tests simulate whole fleets with plain lists.  ``default_gather`` is the
identity on one process; on a fleet it publishes each payload under a
sequenced key in the rendezvous store of the initialised process group
(the ``TCPStore`` that ``init_process_group`` or ``torch.distributed.run``
set up, under a ``PrefixStore``) and waits for every peer's key, bounded by
``$REPRO_CONSENSUS_TIMEOUT_MS``: control-plane bytes, no device
collective, on any backend, where the JAX package uses the coordination
service's key-value store.  A missing peer raises ``PlanConsensusError``.
Offline fleets use ``repro_torch.tuner --export-plan`` on one host and
``--import-plan`` with ``verify_adopted`` on the rest.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import json
import os
import statistics
from typing import Any, Callable, Mapping, Optional, Sequence

import torch

from repro_torch.core.taps import TapMeta
from repro_torch.obs.events import emit_event
from repro_torch.tuner.plan import (
    TUNED_MODES,
    ClipPlan,
    device_string,
    shape_fingerprint,
)
from repro_torch.utils.logging import get_logger

log = get_logger("tuner.consensus")

# gather_fn contract: given this rank's payload dict, return every rank's
# payload (own included), in any order.  Must be collective-consistent: all
# ranks see the same multiset.
GatherFn = Callable[[dict], list[dict]]


class PlanConsensusError(RuntimeError):
    """A fleet cannot agree on one ClipPlan; no step may run."""


@dataclasses.dataclass(frozen=True)
class RankReport:
    """One rank's contribution to the agreement phase."""

    process_index: int
    device: str  # plan.device_string() of this rank
    fingerprint: str  # shape_fingerprint of this rank's discovered taps
    plan_json: Optional[str] = None  # leader ranks carry their measured plan
    step_cost_us: Optional[float] = None  # cheapest tuned-mode cost, if known
    # ClipPolicy fingerprint this rank will run ("" = unspecified): a fleet
    # mixing clipping policies produces different updates per rank
    policy: str = ""

    def to_payload(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_payload(cls, d: Mapping[str, Any]) -> "RankReport":
        return cls(
            process_index=int(d["process_index"]),
            device=str(d["device"]),
            fingerprint=str(d["fingerprint"]),
            plan_json=d.get("plan_json"),
            step_cost_us=(
                None if d.get("step_cost_us") is None else float(d["step_cost_us"])
            ),
            policy=str(d.get("policy", "")),
        )


def plan_step_cost_us(plan: ClipPlan) -> Optional[float]:
    """The rank-local scalar the mixed-kind tie-break aggregates: the plan's
    cheapest tuned-mode per-step clipping cost (None without timings)."""
    if not plan.timings:
        return None
    return min(plan.mode_cost_us(m) for m in TUNED_MODES)


# -- gather primitives ----------------------------------------------------
# monotonically increasing gather id: every rank runs the consensus phases
# in the same order, so the n-th gather on one rank pairs with the n-th
# gather on every other rank
_GATHER_SEQ = itertools.count()

# a hung peer must fail the fleet loudly, not stall it: every blocking
# store read is bounded by this
ENV_GATHER_TIMEOUT_MS = "REPRO_CONSENSUS_TIMEOUT_MS"
DEFAULT_GATHER_TIMEOUT_MS = 120_000
STORE_PREFIX = "repro/consensus"


def _dist():
    dist = torch.distributed
    return dist if dist.is_available() and dist.is_initialized() else None


def _process_index() -> int:
    dist = _dist()
    return 0 if dist is None else int(dist.get_rank())


def _process_count() -> int:
    dist = _dist()
    return 1 if dist is None else int(dist.get_world_size())


def _rendezvous_store():
    """The initialised process group's key-value store, under a prefix.

    ``torch.distributed`` keeps it as the default group's store and has no
    public getter for it; reaching in is deliberate, as the JAX package
    reaches for its coordination client: a device collective would need the
    backend and the card, where the store is control-plane bytes.
    """
    from torch.distributed import PrefixStore
    from torch.distributed.distributed_c10d import _get_default_store

    return PrefixStore(STORE_PREFIX, _get_default_store())


def _store_allgather(payload: dict, store, idx: int, n: int) -> list[dict]:
    """All-gather JSON payloads through the rendezvous store: each rank sets
    its sequenced key, then waits (bounded) for every peer's; the last rank
    to finish reading removes the gather's keys."""
    seq = next(_GATHER_SEQ)
    timeout_ms = int(os.environ.get(ENV_GATHER_TIMEOUT_MS, DEFAULT_GATHER_TIMEOUT_MS))
    keys = [f"{seq}/{r}" for r in range(n)]
    store.set(keys[idx], json.dumps(payload, sort_keys=True))
    out = []
    for r, key in enumerate(keys):
        try:
            store.wait([key], datetime.timedelta(milliseconds=timeout_ms))
            out.append(json.loads(store.get(key)))
        except Exception as e:  # noqa: BLE001 - the store's timeout class varies
            raise PlanConsensusError(
                f"rank {r} did not publish its consensus payload within "
                f"{timeout_ms}ms (gather {seq}): {e}"
            ) from e
    try:  # bound the store's growth over long tuning sessions
        if store.add(f"{seq}/done", 1) == n:
            for key in keys + [f"{seq}/done"]:
                store.delete_key(key)
    except Exception:  # noqa: BLE001 - cleanup is best-effort; the gather happened
        pass
    return out


def default_gather(payload: dict) -> list[dict]:
    """All-gather one JSON-able payload per process over the fleet: the
    identity on one process, the rendezvous store on several."""
    n = _process_count()
    if n == 1:
        return [payload]
    return _store_allgather(payload, _rendezvous_store(), _process_index(), n)


# -- phase 1: roles -------------------------------------------------------
def elect_leaders(devices: Mapping[int, str]) -> dict[str, int]:
    """Lowest process index per device string = that kind's tuning leader."""
    leaders: dict[str, int] = {}
    for idx in sorted(devices):
        leaders.setdefault(devices[idx], idx)
    return leaders


@dataclasses.dataclass(frozen=True)
class FleetRoles:
    """Outcome of the role phase for this rank."""

    process_index: int
    device: str
    is_leader: bool
    leaders: tuple[tuple[str, int], ...]  # (device, leader index), sorted
    fleet: tuple[tuple[int, str], ...]  # (process index, device), sorted

    @property
    def n_ranks(self) -> int:
        return len(self.fleet)


def fleet_roles(
    *,
    gather_fn: Optional[GatherFn] = None,
    process_index: Optional[int] = None,
    device: Optional[str] = None,
) -> FleetRoles:
    """Phase 1: gather device kinds, elect one tuning leader per kind."""
    gather = gather_fn or default_gather
    idx = _process_index() if process_index is None else process_index
    dev = device_string() if device is None else device
    gathered = gather({"phase": "roles", "process_index": idx, "device": dev})
    fleet = {int(p["process_index"]): str(p["device"]) for p in gathered}
    if idx not in fleet:
        raise PlanConsensusError(
            f"role gather did not include this rank (process {idx}); "
            f"saw processes {sorted(fleet)}"
        )
    leaders = elect_leaders(fleet)
    return FleetRoles(
        process_index=idx,
        device=dev,
        is_leader=leaders[dev] == idx,
        leaders=tuple(sorted(leaders.items())),
        fleet=tuple(sorted(fleet.items())),
    )


# -- phase 2: agreement (pure) --------------------------------------------
def agree(reports: Sequence[RankReport]) -> ClipPlan:
    """Deterministically reduce a fleet's reports to the one adopted plan.

    Pure function of the report multiset: every rank that evaluates it over
    the same gathered reports computes a byte-identical ``ClipPlan`` (the
    certify phase then *checks* that rather than assuming it).  Raises
    ``PlanConsensusError`` on anything no step may run over:
    fingerprint mismatches, a device kind whose leader has no plan, or
    candidate plans that disagree with their own kind's duplicates.
    """
    if not reports:
        raise PlanConsensusError("no rank reports to agree over")
    ordered = sorted(reports, key=lambda r: r.process_index)
    if len({r.process_index for r in ordered}) != len(ordered):
        raise PlanConsensusError("duplicate process indices in rank reports")

    # one model everywhere: the fingerprint is batch-free, so it must be
    # identical across ranks regardless of device kind
    fps = {r.fingerprint for r in ordered}
    if len(fps) != 1:
        detail = ", ".join(
            f"process {r.process_index} ({r.device}): {r.fingerprint}"
            for r in ordered
        )
        raise PlanConsensusError(
            f"ranks disagree on the tap-shape fingerprint — they are not "
            f"running the same model: {detail}"
        )

    # one clipping policy everywhere: factors (and for quantile, the very
    # threshold trajectory) differ per policy, so mixing them across ranks
    # is mathematically divergent training, not a tuning detail
    pols = {r.policy for r in ordered}
    if len(pols) != 1:
        detail = ", ".join(
            f"process {r.process_index} ({r.device}): "
            f"{r.policy or '<unspecified>'}"
            for r in ordered
        )
        raise PlanConsensusError(
            f"ranks disagree on the clipping-policy fingerprint: {detail}"
        )

    by_kind: dict[str, list[RankReport]] = {}
    for r in ordered:
        by_kind.setdefault(r.device, []).append(r)

    # per kind: the leader's plan is the candidate; any other plan-carrying
    # rank of the same kind must agree byte-for-byte (same kind + same model
    # => a divergence is timer noise promoted to config state: reject it,
    # re-tune with consensus instead of importing stale per-rank artifacts)
    candidates: dict[str, tuple[RankReport, ClipPlan]] = {}
    for kind, rs in sorted(by_kind.items()):
        carriers = [r for r in rs if r.plan_json is not None]
        if not carriers:
            raise PlanConsensusError(
                f"device kind {kind!r} (processes "
                f"{[r.process_index for r in rs]}) reported no measured plan"
            )
        leader = carriers[0]
        plan = ClipPlan.from_json(leader.plan_json)
        if plan.fingerprint != leader.fingerprint:
            raise PlanConsensusError(
                f"process {leader.process_index} reported a plan whose "
                f"fingerprint {plan.fingerprint} does not match its model "
                f"({leader.fingerprint})"
            )
        for other in carriers[1:]:
            h0 = plan.consensus_hash()
            h1 = ClipPlan.from_json(other.plan_json).consensus_hash()
            if h0 != h1:
                raise PlanConsensusError(
                    f"processes {leader.process_index} and "
                    f"{other.process_index} ({kind}) hold different plans "
                    f"({h0} vs {h1}); a fleet must not adopt per-rank "
                    f"measurements — re-tune with consensus"
                )
        candidates[kind] = (leader, plan)

    # mixed kinds: the winning kind has the lowest median measured step cost
    # across its ranks; ties break on the device string, then leader index —
    # total order, so the choice is deterministic on every rank
    def kind_key(kind: str) -> tuple:
        leader, plan = candidates[kind]
        costs = [
            r.step_cost_us for r in by_kind[kind] if r.step_cost_us is not None
        ]
        if not costs:
            own = plan_step_cost_us(plan)
            costs = [own] if own is not None else [float("inf")]
        return (statistics.median(costs), kind, leader.process_index)

    winner = min(candidates, key=kind_key)
    leader, adopted = candidates[winner]
    if len(candidates) > 1:
        log.info(
            "mixed device kinds %s: adopting %s's plan (leader process %d, "
            "median step cost %.1fus)", sorted(candidates), winner,
            leader.process_index, kind_key(winner)[0],
        )

    # the weakest certified batch bounds the fleet (uniform data-axis shards).
    # That rule only holds when EVERY kind certified one: a kind without a
    # certificate must not inherit the winner's — its memory never ran
    # that batch — so the adopted plan drops the certificate instead and
    # consumers fall back to their own (per-host) re-certification.
    batches = [p.physical_batch for _, p in candidates.values()]
    if all(b is not None and b > 0 for b in batches):
        if min(batches) != adopted.physical_batch:
            adopted = dataclasses.replace(
                adopted.replace_batch(
                    physical_batch=min(batches),
                    logical_batch=adopted.logical_batch,
                    accumulation_steps=None,  # consumers re-derive per logical
                    budget_bytes=adopted.budget_bytes,
                ),
                # the winner's timings were re-measured at ITS batch, not
                # the fleet minimum the step will now run at
                measured_at_physical=False,
            )
    elif adopted.physical_batch is not None:
        log.warning(
            "device kind(s) without a batch certificate ratified the plan; "
            "dropping physical_batch=%s from the adopted plan",
            adopted.physical_batch,
        )
        adopted = dataclasses.replace(
            adopted, physical_batch=None, accumulation_steps=None,
            measured_at_physical=False,
        )

    return dataclasses.replace(
        adopted,
        devices=tuple(sorted({r.device for r in ordered})),
        agreed_hash=adopted.consensus_hash(),
        agreed_ranks=len(ordered),
        leader_process=leader.process_index,
    )


def reconcile_recertification(
    mode_ok: bool,
    physical_batch: Optional[int],
    *,
    gather_fn: Optional[GatherFn] = None,
    process_index: Optional[int] = None,
) -> tuple[bool, Optional[int]]:
    """Reduce each rank's post-adoption re-certification to one fleet verdict.

    ``--mode auto`` re-certifies the max batch under the recommended mode on
    *each rank's own device* — a kind-dependent result on mixed fleets.  The
    adopted mode must fit EVERY rank (one kind falling back alone would
    run a different program), and the fleet's physical batch is the
    minimum any rank re-certified, mirroring ``agree()``'s batch-min rule.
    Returns ``(all_ranks_fit, fleet_min_batch)``; deterministic on every
    rank.  Single process: the identity.
    """
    gather = gather_fn or default_gather
    idx = _process_index() if process_index is None else process_index
    got = gather({
        "phase": "recertify", "process_index": idx,
        "mode_ok": bool(mode_ok), "physical_batch": physical_batch,
    })
    ok = all(bool(p["mode_ok"]) for p in got)
    batches = [int(p["physical_batch"]) for p in got if p.get("physical_batch")]
    return ok, (min(batches) if batches else None)


# -- phase 3: certification -----------------------------------------------
def certify_fleet_value(
    tag: str,
    value: str,
    *,
    gather_fn: Optional[GatherFn] = None,
    process_index: Optional[int] = None,
) -> None:
    """Assert every rank derived the same ``value`` for ``tag``, or abort.

    The general form of the phase-3 gate, for decisions ranks derive
    *locally after* plan adoption (e.g. ``--mode auto``'s re-certified
    {mode, physical batch, accumulation}): a per-rank fallback that
    diverges from its peers must fail loudly before the first step, exactly like
    a diverging plan hash.
    """
    gather = gather_fn or default_gather
    idx = _process_index() if process_index is None else process_index
    gathered = gather({"phase": f"certify:{tag}", "process_index": idx,
                       "value": value})
    values = {int(p["process_index"]): str(p["value"]) for p in gathered}
    if len(set(values.values())) != 1:
        raise PlanConsensusError(
            f"ranks diverge on {tag}: {sorted(values.items())} — refusing "
            "to run"
        )


def certify_fleet_hash(
    plan: ClipPlan,
    *,
    gather_fn: Optional[GatherFn] = None,
    process_index: Optional[int] = None,
) -> None:
    """Every rank cross-checks the adopted plan's hash before any step."""
    gather = gather_fn or default_gather
    idx = _process_index() if process_index is None else process_index
    h = plan.consensus_hash()
    gathered = gather({"phase": "certify", "process_index": idx, "hash": h})
    hashes = {int(p["process_index"]): str(p["hash"]) for p in gathered}
    if len(set(hashes.values())) != 1:
        raise PlanConsensusError(
            f"adopted-plan hashes diverge across ranks: {sorted(hashes.items())}"
            " — refusing to run"
        )


def verify_adopted(
    plan: ClipPlan,
    metas: Mapping[str, TapMeta],
    device: Optional[Any] = None,
    policy_fingerprint: Optional[str] = None,
) -> None:
    """Loud, pre-step validity gate for an imported/adopted plan.

    Unlike ``plan.overrides_for`` (which *falls back* to the analytic rule —
    correct for a best-effort single-host cache hit), a fleet rank holding a
    stale plan must ABORT: its peers will run the plan's branches, and an
    analytic fallback on one rank is exactly the divergence consensus
    exists to prevent.  Raises ``PlanConsensusError`` on a fingerprint or
    device mismatch, or when a claimed agreement hash fails to re-verify.
    ``device`` accepts a torch device or an already-formatted device string.

    Scope of the hash check: ``consensus_hash`` covers the *measurement
    content* only, so it catches accidental edits to branches/timings/
    batch — NOT edits to the provenance fields themselves (``devices``,
    ``agreed_ranks``, ...), which are excluded by construction so stamping
    stays idempotent.  There is no signing anywhere: artifacts moved
    between offline hosts are integrity-checked, not authenticated —
    transport them over channels you trust.
    """
    dev = device if isinstance(device, str) else device_string(device)
    fp = shape_fingerprint(metas)
    if plan.fingerprint != fp:
        raise PlanConsensusError(
            f"plan fingerprint {plan.fingerprint} does not match the model's "
            f"taps ({fp}); importing it would run branches measured for a "
            "different model"
        )
    if not plan.ratified_on(dev):
        raise PlanConsensusError(
            f"plan was measured on {plan.device} and ratified by "
            f"{list(plan.devices) or 'no fleet'}; this rank is {dev} — "
            "re-run the fleet agreement to ratify this device kind"
        )
    if plan.agreed_hash is not None and plan.agreed_hash != plan.consensus_hash():
        raise PlanConsensusError(
            f"plan claims agreement hash {plan.agreed_hash} but hashes to "
            f"{plan.consensus_hash()}; the artifact was edited after the "
            "fleet certified it"
        )
    if (
        policy_fingerprint is not None
        and plan.policy_fingerprint
        and plan.policy_fingerprint != policy_fingerprint
    ):
        # an unstamped plan ("" — pre-v4 artifact or engine-less tuner run)
        # is accepted: branch measurements are policy-independent.  A plan
        # STAMPED for a different policy means the fleet certified a
        # different mechanism than this rank is about to run.
        raise PlanConsensusError(
            f"plan was agreed for clipping policy "
            f"{plan.policy_fingerprint!r} but this rank runs "
            f"{policy_fingerprint!r}; re-run the fleet agreement under one "
            "policy"
        )


# -- the one-call driver --------------------------------------------------
def fleet_agree(
    plan: Optional[ClipPlan],
    metas: Mapping[str, TapMeta],
    *,
    gather_fn: Optional[GatherFn] = None,
    process_index: Optional[int] = None,
    device: Optional[str] = None,
    policy_fingerprint: str = "",
) -> ClipPlan:
    """Phases 2+3: gather reports, agree, certify, validate — one call.

    ``plan`` is this rank's measured plan (None on non-leader ranks that
    skipped measuring).  ``policy_fingerprint`` is the clipping policy this
    rank will run (``repro.policies``); every rank — leader or not — must
    report the same one or the agreement aborts.  Returns the fleet-adopted
    plan, guaranteed byte-identical on every rank that returns, and already
    verified against this rank's ``metas``/device.  Raises
    ``PlanConsensusError`` otherwise.
    """
    gather = gather_fn or default_gather
    idx = _process_index() if process_index is None else process_index
    dev = device_string() if device is None else device
    report = RankReport(
        process_index=idx,
        device=dev,
        fingerprint=shape_fingerprint(metas),
        plan_json=None if plan is None else plan.to_json(),
        step_cost_us=None if plan is None else plan_step_cost_us(plan),
        policy=policy_fingerprint,
    )
    try:
        payloads = gather(dict(report.to_payload(), phase="agree"))
        reports = [RankReport.from_payload(p) for p in payloads]
        adopted = agree(reports)
        certify_fleet_hash(
            adopted, gather_fn=gather_fn, process_index=process_index
        )
        verify_adopted(
            adopted, metas, device=dev, policy_fingerprint=policy_fingerprint
        )
    except PlanConsensusError as e:
        emit_event("consensus_rejected", rank_index=idx, device=dev,
                   reason=str(e))
        raise
    log.info(
        "fleet agreement: %d rank(s), %d device kind(s), leader process %s, "
        "hash %s", adopted.agreed_ranks, len(adopted.devices),
        adopted.leader_process, adopted.agreed_hash,
    )
    emit_event("consensus_agreed", rank_index=idx,
               agreed_hash=adopted.agreed_hash,
               agreed_ranks=adopted.agreed_ranks,
               leader_process=adopted.leader_process,
               devices=sorted(adopted.devices))
    return adopted
