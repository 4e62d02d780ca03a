"""The ClipPlan artifact: a cached, device-specific clipping decision (port
of ``tuner/plan.py``).

The analytic rule Eq (4.1) predicts which branch (ghost norm or gradient
instantiation) is cheaper from operation counts alone.  On a real device
the winner also depends on launch overhead, tiling, dtype and fusion, so
the tuner measures the branches per tap (``measure.py``) and records the
winners here, with what tells when the plan is stale:

- a **shape fingerprint** over every tap's (kind, T, D, p, groups, stack,
  dtype) signature, batch size excluded, so one plan serves any physical
  microbatch (the max-batch search varies B);
- the **device string** (platform and device kind) it was measured on.

Plans are **mode-aware**: each matmul tap is timed on {ghost norm,
instantiated norm, book-keeping ghost bank, book-keeping psg bank, its
share of the second backward}, and two branch maps are kept: ``branches``
for the second-backward modes and ``bk_branches`` for ``bk_mixed`` (which
residual to bank).  ``recommended_mode()`` compares the measured per-step
totals of {mixed_ghost, bk_mixed}.  ``matches(metas)`` is the staleness
gate: ``overrides_for`` and ``kernels_for`` give the per-tap maps when the
plan matches the model and the device, and {} (the analytic rule, the
device default; logged) otherwise.  v5 carries the kernel map (per tap and
dispatch op, the measured impl); v2-v4 artifacts migrate with empty
defaults, v1 is rejected.

The schema is the JAX package's, field for field, with the same
``PLAN_VERSION``, so a plan crosses between the packages
(``repro_torch.interop.plan_from_jax`` maps the kernel impls).  The port's
own choices:

- ``device_string`` keeps the ``platform:device_kind`` form:
  ``gpu:<torch.cuda.get_device_name()>`` on the card, ``cpu:cpu`` on the
  CPU (what the JAX package writes for its CPU device); devices are torch
  devices (``None``: the GPU, as for every entry point);
- ``tap_signature`` writes dtypes in numpy's names (``float32``,
  ``bfloat16``), so the same model has the same ``shape_fingerprint`` in
  both packages;
- ``KERNEL_IMPLS`` is ``("cuda", "torch")`` (``kernels/dispatch.py``);
- the cache root is ``$REPRO_TUNER_CACHE`` or ``~/.cache/repro-torch-tuner``.

The consensus provenance fields (``devices``, ``agreed_hash``,
``agreed_ranks``, ``leader_process``) and the policy fingerprint stay in the
schema, round-trip and are covered by ``consensus_hash`` as in the
reference; the fleet agreement that stamps them comes with
``torch.distributed``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
from typing import Any, Mapping, Optional

import torch

from repro_torch.core.taps import TapMeta
from repro_torch.device import DeviceLike, resolve_device

log = logging.getLogger("repro_torch.tuner.plan")

PLAN_VERSION = 5
# older versions from_json still understands (migrated with empty defaults
# for the fields they predate); v1 predates the three-way branch maps and is
# stale by construction
COMPAT_VERSIONS = (2, 3, 4, PLAN_VERSION)
BRANCHES = ("ghost", "instantiate")
# kernel ops / impl values a v5 plan may record per tap; mirror
# repro_torch.kernels.dispatch.OPS / .IMPLS (duplicated so plan validation
# stays free of kernel imports; tests/test_torch_tuner.py asserts they agree)
KERNEL_OPS = (
    "ghost_norm", "embedding_ghost_norm", "psg_contract", "flash_attention"
)
KERNEL_IMPLS = ("cuda", "torch")
TUNED_MODES = ("mixed_ghost", "bk_mixed")
# ClipPlan fields that record consensus *provenance* rather than measurement:
# excluded from consensus_hash() so that stamping the agreement outcome onto
# the plan does not change the hash being agreed on
PROVENANCE_FIELDS = ("devices", "agreed_hash", "agreed_ranks", "leader_process")


def device_string(device: DeviceLike = None) -> str:
    """Stable identity of the accelerator a plan was measured on.

    ``platform:device_kind``, the reference's form: ``gpu:NVIDIA H100 80GB
    HBM3`` on the card, ``cpu:cpu`` on the CPU.  Two hosts with the same
    device kind see the same kernel costs, so a fleet needs one measurement
    per kind.  ``device`` is a torch device (``None``: the GPU).
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"gpu:{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}:{dev.type}"


def dtype_name(dtype: Any) -> str:
    """numpy's name of a torch dtype (``torch.bfloat16`` -> ``bfloat16``)."""
    return str(dtype).removeprefix("torch.")


def tap_signature(name: str, meta: TapMeta) -> dict:
    """Per-tap shape identity (batch-size free; see module docstring)."""
    return {
        "name": name,
        "kind": meta.kind,
        "T": int(meta.T),
        "D": int(meta.D),
        "p": int(meta.p),
        "n_groups": int(meta.n_groups),
        "stack_dims": [int(s) for s in meta.stack_dims],
        "dtype": dtype_name(meta.s_dtype),
        "conv": meta.conv is not None,
    }


def shape_fingerprint(metas: Mapping[str, TapMeta]) -> str:
    """Order-independent hash of every tap's shape signature (16 hex chars).

    This is the plan's model identity: two models whose taps agree on every
    (kind, T, D, p, groups, stack, dtype) tuple — batch size excluded — share
    a fingerprint and can share a plan.  Any change to a layer's shape, a new
    tap, or a dtype switch changes it, which is what makes stale-plan
    rejection (``ClipPlan.matches``) sound.
    """
    sigs = sorted(
        (tap_signature(name, m) for name, m in metas.items()),
        key=lambda s: s["name"],
    )
    blob = json.dumps(sigs, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class TapTiming:
    """Measured branch costs for one tap (microseconds, median-of-k).

    ``ghost_us`` / ``instantiate_us`` time the norm kernels of the
    second-backward modes; ``bk_ghost_us`` / ``bk_instantiate_us`` time the
    full book-keeping pipelines (norm + bank + weighted-grad contraction);
    ``second_bwd_us`` times the tap's share of a second backward pass (its
    dW + dX matmuls) — what book-keeping avoids paying.
    """

    ghost_us: float
    instantiate_us: float
    bk_ghost_us: float = 0.0
    bk_instantiate_us: float = 0.0
    second_bwd_us: float = 0.0

    @property
    def winner(self) -> str:
        """Measured norm branch for the second-backward modes (ties: ghost)."""
        return "ghost" if self.ghost_us <= self.instantiate_us else "instantiate"

    @property
    def bk_winner(self) -> str:
        """Measured bank branch for ``bk_mixed`` (ties: ghost)."""
        return "ghost" if self.bk_ghost_us <= self.bk_instantiate_us else "instantiate"

    def mode_cost_us(self, mode: str) -> float:
        """Measured per-tap cost of running this tap under ``mode``."""
        if mode == "bk_mixed":
            return min(self.bk_ghost_us, self.bk_instantiate_us)
        return min(self.ghost_us, self.instantiate_us) + self.second_bwd_us

    def as_tuple(self, name: str) -> tuple:
        """Flatten to the (name, *timings) row stored in ``ClipPlan.timings``."""
        return (name, self.ghost_us, self.instantiate_us,
                self.bk_ghost_us, self.bk_instantiate_us, self.second_bwd_us)


@dataclasses.dataclass(frozen=True)
class ClipPlan:
    """Serializable result of one tuning run (hashable: tuple fields only)."""

    fingerprint: str
    device: str
    # (tap_name, branch) pairs, sorted by name; matmul taps only — other
    # kinds have a forced branch the tuner never overrides.  ``branches``
    # serves the second-backward modes, ``bk_branches`` serves bk_mixed.
    branches: tuple[tuple[str, str], ...] = ()
    bk_branches: tuple[tuple[str, str], ...] = ()
    # (tap_name, dispatch_op, impl) triples, sorted: the measured impl per
    # clipping hot op (repro_torch.kernels.dispatch).
    # Like the branch maps: pure cost, never math; covered by the consensus
    # hash so a fleet cannot mix kernel choices.  Empty on pre-v5 artifacts
    # (the dispatch backend default applies).
    kernels: tuple[tuple[str, str, str], ...] = ()
    # Table-7 measurement reused as a runtime feature: the largest physical
    # microbatch that fits the memory budget, and the accumulation the tuning
    # run derived for its logical batch (informational — consumers re-derive
    # for their own logical batch via max_batch.derive_accumulation).
    physical_batch: Optional[int] = None
    logical_batch: Optional[int] = None
    accumulation_steps: Optional[int] = None
    # the budget the max-batch search ran under; a cached plan is only valid
    # for a re-run with the same budget
    budget_bytes: Optional[int] = None
    # True once branch timings were re-measured at the tuned physical batch
    # (the ROADMAP "profile at the tuned physical batch" loop)
    measured_at_physical: bool = False
    # provenance
    arch: Optional[str] = None
    # (name, ghost, inst, bk_ghost, bk_inst, second_bwd) microseconds
    timings: tuple[tuple[str, float, float, float, float, float], ...] = ()
    # clipping-policy identity (repro_torch.policies.ClipPolicy.fingerprint()),
    # stamped by PrivacyEngine.tune; "" on pre-v4 artifacts and plans built
    # outside an engine.  Covered by consensus_hash() — a fleet cannot mix
    # policies — but ignored by matches(): branch decisions are
    # policy-independent, so the *measurements* stay valid across policies.
    policy_fingerprint: str = ""
    # -- fleet consensus provenance (v3; the agreement comes later) --------
    # device strings that ratified this plan in a fleet agreement; matches()
    # accepts any of them (a mixed-kind fleet must trace ONE branch map, so
    # the agreed plan is deliberately consumable on every ratifying kind)
    devices: tuple[str, ...] = ()
    # consensus_hash() at agreement time, certified identical on all ranks
    agreed_hash: Optional[str] = None
    # fleet size at agreement time (None = never agreed / single-host plan)
    agreed_ranks: Optional[int] = None
    # process index of the rank whose measurement won the agreement
    leader_process: Optional[int] = None
    version: int = PLAN_VERSION

    # -- consumption -----------------------------------------------------
    def branch_map(self, mode: str = "mixed_ghost") -> dict[str, str]:
        """The per-tap branch decisions as a dict; ``mode`` picks which map."""
        return dict(self.bk_branches if mode == "bk_mixed" else self.branches)

    def kernel_map(self) -> dict[str, dict[str, str]]:
        """The recorded kernel choices as ``{tap: {op: impl}}``."""
        out: dict[str, dict[str, str]] = {}
        for name, op, impl in self.kernels:
            out.setdefault(name, {})[op] = impl
        return out

    @property
    def device_kind(self) -> str:
        """The accelerator kind (``device_string`` minus the platform prefix)."""
        return self.device.split(":", 1)[-1]

    def ratified_on(self, device: str) -> bool:
        """True when ``device`` measured this plan or agreed to adopt it."""
        return device == self.device or device in self.devices

    def consensus_bytes(self) -> bytes:
        """Canonical serialization for fleet agreement (provenance excluded).

        Two plans with identical measurements produce identical bytes
        regardless of who stamps which agreement fields onto them — the
        property the consensus hash certification rests on.
        """
        d = dataclasses.asdict(self)
        for f in PROVENANCE_FIELDS:
            d.pop(f, None)
        d["branches"] = [list(b) for b in self.branches]
        d["bk_branches"] = [list(b) for b in self.bk_branches]
        d["kernels"] = [list(k) for k in self.kernels]
        d["timings"] = [list(t) for t in self.timings]
        return json.dumps(d, sort_keys=True, separators=(",", ":")).encode()

    def consensus_hash(self) -> str:
        """16-hex-char hash of ``consensus_bytes()`` — the fleet handshake."""
        return hashlib.sha256(self.consensus_bytes()).hexdigest()[:16]

    def matches(
        self, metas: Mapping[str, TapMeta], device: DeviceLike = None
    ) -> bool:
        """True when this plan is valid on this device for these taps.

        Gate *every* plan consumption on this — branch overrides AND the
        tuned physical batch: a plan tuned on different hardware describes a
        different memory budget just as much as different branch costs.
        Valid means measured on this device OR ratified by it in a fleet
        agreement (``devices``): a mixed-kind fleet must trace one branch
        map everywhere, so adoption extends validity by construction.
        """
        return (
            self.ratified_on(device_string(device))
            and self.fingerprint == shape_fingerprint(metas)
        )

    def overrides_for(
        self,
        metas: Mapping[str, TapMeta],
        device: DeviceLike = None,
        mode: str = "mixed_ghost",
    ) -> dict[str, str]:
        """Per-tap branch overrides, or {} (analytic fallback) when stale.

        A plan is stale when it was measured on a different device or for
        different tap shapes; using it would apply timings that no longer
        describe the hardware about to run.  ``mode`` selects the branch
        map: ``bk_mixed`` banks residuals instead of paying the second
        backward, so its measured winners are stored separately.
        """
        dev = device_string(device)
        if not self.ratified_on(dev):
            log.warning(
                "ClipPlan measured on %s (ratified by %s) but running on %s; "
                "falling back to the analytic decision",
                self.device, list(self.devices) or "no fleet", dev,
            )
            return {}
        fp = shape_fingerprint(metas)
        if self.fingerprint != fp:
            log.warning(
                "ClipPlan fingerprint %s does not match model taps (%s); "
                "falling back to the analytic decision",
                self.fingerprint, fp,
            )
            return {}
        branches = self.bk_branches if mode == "bk_mixed" else self.branches
        return {name: b for name, b in branches if name in metas}

    def kernels_for(
        self, metas: Mapping[str, TapMeta], device: DeviceLike = None
    ) -> dict[str, dict[str, str]]:
        """Per-tap kernel-impl choices, or {} (dispatch default) when stale.

        STRICTER than ``overrides_for``: branch overrides are
        backend-portable cost hints (``matches`` accepts any *ratifying*
        device of a fleet agreement), but a kernel impl is backend-specific
        — a ``cuda`` winner measured on the fleet's GPU kind must never be
        applied by a ratifying rank of another kind.  So the map only
        applies on the device kind that measured it; every other kind
        (ratifying or not) falls back to its own dispatch backend default,
        which is deterministic per kind.
        """
        if not self.kernels:
            return {}
        if (
            self.device != device_string(device)
            or self.fingerprint != shape_fingerprint(metas)
        ):
            log.warning(
                "ClipPlan kernel map dropped (measured on %s for fingerprint "
                "%s); falling back to the dispatch backend default",
                self.device, self.fingerprint,
            )
            return {}
        return {
            name: ks for name, ks in self.kernel_map().items() if name in metas
        }

    def tap_timings(self) -> dict[str, TapTiming]:
        """The stored timing rows re-hydrated as ``TapTiming`` per tap."""
        return {
            name: TapTiming(g, i, bg, bi, sb)
            for name, g, i, bg, bi, sb in self.timings
        }

    def mode_cost_us(self, mode: str) -> float:
        """Measured per-step clipping cost (us) of running under ``mode``."""
        return sum(t.mode_cost_us(mode) for t in self.tap_timings().values())

    def recommended_mode(self) -> str:
        """The measured three-way verdict: cheapest tuned mode per step.

        Compares {ghost-or-instantiate norms + second backward} against
        {book-keeping banks + weighted einsums} using the per-tap timings.
        Memory is not in this comparison — book-keeping banks residuals, so
        callers on the edge of the budget should trust the max-batch search
        (which compiles the actual mode) over this time-only verdict.
        """
        if not self.timings:
            return "mixed_ghost"
        return min(TUNED_MODES, key=self.mode_cost_us)

    def replace_batch(
        self,
        *,
        physical_batch: int,
        logical_batch: Optional[int] = None,
        accumulation_steps: Optional[int] = None,
        budget_bytes: Optional[int] = None,
    ) -> "ClipPlan":
        """Copy with a new batch certificate (branch maps/timings untouched)."""
        return dataclasses.replace(
            self,
            physical_batch=physical_batch,
            logical_batch=logical_batch,
            accumulation_steps=accumulation_steps,
            budget_bytes=budget_bytes,
        )

    # -- serialization ---------------------------------------------------
    def to_json(self) -> str:
        """The on-disk artifact: deterministic, human-inspectable JSON.

        Keys are sorted and tuples listified, so two ``ClipPlan`` objects
        that compare equal serialize byte-identically — the property fleet
        consensus certifies across ranks.
        """
        d = dataclasses.asdict(self)
        d["branches"] = [list(b) for b in self.branches]
        d["bk_branches"] = [list(b) for b in self.bk_branches]
        d["kernels"] = [list(k) for k in self.kernels]
        d["timings"] = [list(t) for t in self.timings]
        d["devices"] = list(self.devices)
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ClipPlan":
        """Parse and validate a plan artifact; raises ``ValueError`` when stale.

        v5 is current; v4 (pre-kernel-map), v3 (pre-policy) and v2
        (pre-consensus) migrate with empty defaults for the fields they
        predate — their measurements are still sound on the device that
        took them, though a v3/v4 ``agreed_hash`` no longer re-verifies
        (the hash covered the older schema; re-run the agreement).
        v1 (pre-three-way) and unknown versions are rejected: their branch
        maps know nothing about the bk bank decision.
        """
        d = json.loads(text)
        version = int(d.get("version", 0))
        if version not in COMPAT_VERSIONS:
            raise ValueError(f"unsupported ClipPlan version {version}")
        branches = tuple((str(n), str(b)) for n, b in d.get("branches", ()))
        bk_branches = tuple((str(n), str(b)) for n, b in d.get("bk_branches", ()))
        for _, b in branches + bk_branches:
            if b not in BRANCHES:
                raise ValueError(f"invalid branch {b!r} in ClipPlan")
        kernels = tuple(
            (str(n), str(op), str(impl)) for n, op, impl in d.get("kernels", ())
        )
        for _, op, impl in kernels:
            if op not in KERNEL_OPS:
                raise ValueError(f"unknown kernel op {op!r} in ClipPlan")
            if impl not in KERNEL_IMPLS:
                raise ValueError(
                    f"invalid kernel impl {impl!r} for op {op!r} in ClipPlan"
                )
        return cls(
            fingerprint=str(d["fingerprint"]),
            device=str(d["device"]),
            branches=branches,
            bk_branches=bk_branches,
            kernels=kernels,
            physical_batch=d.get("physical_batch"),
            logical_batch=d.get("logical_batch"),
            accumulation_steps=d.get("accumulation_steps"),
            budget_bytes=d.get("budget_bytes"),
            measured_at_physical=bool(d.get("measured_at_physical", False)),
            arch=d.get("arch"),
            timings=tuple(
                (str(n), float(g), float(i), float(bg), float(bi), float(sb))
                for n, g, i, bg, bi, sb in d.get("timings", ())
            ),
            policy_fingerprint=str(d.get("policy_fingerprint", "")),
            devices=tuple(str(x) for x in d.get("devices", ())),
            agreed_hash=d.get("agreed_hash"),
            agreed_ranks=d.get("agreed_ranks"),
            leader_process=d.get("leader_process"),
            version=PLAN_VERSION,
        )

    def save(self, path: str) -> str:
        """Write the JSON artifact (parent dirs created); returns ``path``."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path: str) -> "ClipPlan":
        """Read + validate a plan artifact (see ``from_json`` for staleness)."""
        with open(path) as f:
            return cls.from_json(f.read())


def cache_dir() -> str:
    """Plan cache root: ``$REPRO_TUNER_CACHE`` or ``~/.cache/repro-torch-tuner``."""
    return os.environ.get(
        "REPRO_TUNER_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro-torch-tuner"),
    )


def default_plan_path(arch: Optional[str], fingerprint: str) -> str:
    """Cache path for an (arch, shape-fingerprint) pair's plan artifact."""
    stem = f"{arch or 'model'}-{fingerprint}"
    return os.path.join(cache_dir(), f"{stem}.json")


def load_cached_plan(arch: Optional[str], metas: Mapping[str, TapMeta]) -> Optional[ClipPlan]:
    """Look up a previously tuned plan for these shapes, if any."""
    path = default_plan_path(arch, shape_fingerprint(metas))
    if not os.path.exists(path):
        return None
    try:
        return ClipPlan.load(path)
    except (ValueError, KeyError, json.JSONDecodeError) as e:
        log.warning("ignoring unreadable cached plan %s (%s)", path, e)
        return None
