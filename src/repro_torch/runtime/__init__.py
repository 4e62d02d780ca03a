from repro_torch.runtime.fault import StepWatchdog, PreemptionHandler, retry
from repro_torch.runtime.elastic import ElasticPlan, current_data_shards, elastic_plan
from repro_torch.runtime.inject import InjectedCrash, InjectionPlan

__all__ = [
    "StepWatchdog",
    "PreemptionHandler",
    "retry",
    "ElasticPlan",
    "current_data_shards",
    "elastic_plan",
    "InjectedCrash",
    "InjectionPlan",
]
