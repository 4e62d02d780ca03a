"""The port's fleet agreement on live ``torch.distributed`` ranks
(``tests/torch_dist.py``), for ``tests/test_torch_consensus.py``: the
counterpart of ``tests/distributed/_worker.py``.  The gather is the
production ``default_gather`` over the process group's rendezvous store.
No JAX here: the ranks are spawned processes.
"""
from __future__ import annotations

import os

import torch


def consensus_fleet(rank: int, n: int) -> dict:
    from repro_torch.configs.registry import build_model, get_arch
    from repro_torch.core.clipping import discover_meta
    from repro_torch.data.synthetic import synthetic_arch_batch
    from repro_torch.tuner import consensus
    from repro_torch.tuner.measure import MeasureConfig, build_plan

    dist = torch.distributed
    results: dict = {"rank": dist.get_rank(), "n": dist.get_world_size()}

    # 1. the raw payload all-gather every phase rides on
    gathered = consensus.default_gather({"rank": rank, "token": f"tok-{rank}"})
    results["gather_tokens"] = sorted(p["token"] for p in gathered)
    results["gather_ranks"] = sorted(int(p["rank"]) for p in gathered)

    # 2. leader election over the live device reports
    roles = consensus.fleet_roles(device="cpu:cpu")
    results["is_leader"] = roles.is_leader
    results["leaders"] = list(map(list, roles.leaders))
    results["fleet"] = list(map(list, roles.fleet))

    # 3. adoption: the leader measures a real (tiny) plan, the other rank
    # contributes None and must adopt the same bytes
    cfg = get_arch("yi-6b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    probe = synthetic_arch_batch(cfg, batch=2, seq=16, device="cpu")
    metas = discover_meta(model.loss_with_ctx, params, probe)
    local_plan = None
    if roles.is_leader:
        local_plan = build_plan(metas, measure=MeasureConfig(repeats=1, warmup=0, max_rows=8),
                                arch=cfg.name, device="cpu")
    adopted = consensus.fleet_agree(local_plan, metas, device="cpu:cpu")
    results["plan_json"] = adopted.to_json()
    results["plan_hash"] = adopted.consensus_hash()
    results["agreed_ranks"] = adopted.agreed_ranks
    results["leader_process"] = adopted.leader_process

    # 4. certify: a uniform value passes, a rank-dependent one raises on
    # every rank (the gathers stay sequence-aligned)
    consensus.certify_fleet_value("uniform", "same-everywhere")
    results["certify_uniform_ok"] = True
    try:
        consensus.certify_fleet_value("divergent", f"rank-{rank}")
        results["divergence_detected"] = False
    except consensus.PlanConsensusError as e:
        results["divergence_detected"] = True
        results["divergence_error"] = str(e)[:200]

    # 5. a peer that never publishes: the waiting rank raises within the
    # bounded timeout instead of hanging
    os.environ[consensus.ENV_GATHER_TIMEOUT_MS] = "1500"
    if rank == 0:
        try:
            consensus.default_gather({"rank": rank, "token": "alone"})
            results["missing_peer"] = "no error"
        except consensus.PlanConsensusError as e:
            results["missing_peer"] = str(e)[:200]
    dist.barrier()
    return results
