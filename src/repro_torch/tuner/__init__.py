"""repro_torch.tuner: measured-cost autotuning of the clipping branch
decision (port of ``repro.tuner``).

Replaces the analytic Eq-(4.1) rule with per-tap timings of the port's own
branch code on the device, caches the result as a ``ClipPlan`` (plan.py),
and certifies the largest physical microbatch under a memory budget by
trial (max_batch.py).  Consumed by ``ClipConfig(plan=...)``,
``DPTrainConfig(plan=...)`` and ``PrivacyEngine.tune``; the CLI
(``python -m repro_torch.tuner``, cli.py) profiles a registry arch.  The
fleet agreement (consensus.py) gives every rank of a ``torch.distributed``
fleet one byte-identical plan.
"""
from repro_torch.tuner.max_batch import (
    certify_max_batch,
    derive_accumulation,
    find_max_physical_batch,
    is_oom_error,
    max_batch_by_trial,
    trials_available,
)
from repro_torch.tuner.measure import (
    MeasureConfig,
    build_plan,
    close_physical_batch_loop,
    measure_branches,
    measure_kernels,
    measure_tap,
    measure_tap_kernels,
    remeasure_at_batch,
)
from repro_torch.tuner.plan import (
    ClipPlan,
    TapTiming,
    default_plan_path,
    device_string,
    load_cached_plan,
    shape_fingerprint,
    verify_plan,
)

__all__ = [
    "ClipPlan",
    "TapTiming",
    "MeasureConfig",
    "build_plan",
    "close_physical_batch_loop",
    "measure_branches",
    "measure_kernels",
    "measure_tap",
    "measure_tap_kernels",
    "remeasure_at_batch",
    "certify_max_batch",
    "derive_accumulation",
    "find_max_physical_batch",
    "is_oom_error",
    "max_batch_by_trial",
    "trials_available",
    "default_plan_path",
    "device_string",
    "load_cached_plan",
    "shape_fingerprint",
    "verify_plan",
]
