"""The sharded DP step (data parallelism with FSDP of the parameters and the
Adam moments, ``launch.steps`` with ``shardings``) on 2, 3 and 4 gloo CPU
ranks against the one-process step and the JAX step.

Each fleet is spawned processes (``tests/torch_dist.py``) running
``tests/torch_dist_cases.step_case`` (every fused mode and ``*_taps``
executor, each of the four policies in ``mixed_ghost`` and ``bk_mixed``,
accumulation with and without a Poisson
mask, remat on and off, spread over three fleets: reduced Whisper-large-v3
and Mixtral on 2 ranks, reduced Yi-6B on 4 and on 3).
Held against the one-process step on the same inputs, fp32:

- loss, per-sample norms and clip factors: 1e-5 relative;
- the clipped gradient sum, the parameters and Adam moments after the
  step: each leaf within 1e-5 of its largest entry (a leaf whose gradient
  is zero up to rounding, under 1e-6 of the tree's largest entry, as the
  attention key biases, which the softmax ignores, within 1e-5 of the
  tree's largest);
- the noise drawn through the sharded path: bit for bit;
- the quantile policy's state after the step: 1e-5 relative.

Every rank's norms, clip factors and clipped sums also go against the JAX
package's ``dp_value_and_clipped_grad`` at 1e-5 (``mixed_ghost`` on
Whisper, ``bk_mixed`` on Mixtral, and ``bk_mixed`` under the quantile
policy with a Poisson mask on the 4-rank Yi-6B fleet).  The fleets run at
once, each rank on a share of the worker's threads.
Also: each rank stores 1/n of every leaf the rules shard (half the bytes of
one rank's on Whisper), a dim that does not divide (d_model 64 on 3 ranks)
stays whole on every rank, and the ``vmap`` oracle raises under n > 1.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import build_model as jbuild
from repro.core import clipping as jclip
from repro_torch.configs.registry import build_model, get_arch
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import make_train_state
from repro_torch.optim import adam
from repro_torch.parallel.fsdp import ShardLayout
from repro_torch.utils.tree import flatten_dict, unflatten_dict
from torch_dist import start_ranks
from torch_dist_cases import CLIP, Case, _batches, fleet_cases, step_case
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 1e-5
FIXED = ["non_private", "ghost", "fastgradclip", "mixed_ghost", "bk_mixed",
         "ghost_taps", "fastgradclip_taps", "mixed_ghost_taps", "bk_mixed_taps"]
FLEETS = {
    ("whisper-large-v3", 2): [Case(m) for m in FIXED] + [
        Case("mixed_ghost", "quantile", train_step=True),
        Case("bk_mixed", "quantile", accum=2, poisson=True)],
    ("yi-6b", 4): [Case("mixed_ghost", "automatic", train_step=True),
                   Case("bk_mixed", "automatic"), Case("bk_mixed", "quantile", poisson=True),
                   Case("ghost_taps", remat=False)],
    ("mixtral-8x7b", 2): [Case("bk_mixed"), Case("mixed_ghost", "per_layer"),
                          Case("bk_mixed", "per_layer", remat=False, train_step=True),
                          Case("bk_mixed_taps"), Case("mixed_ghost", accum=2)],
}


THREE = [Case("mixed_ghost", batch=6), Case("bk_mixed", batch=6)]
ALL_FLEETS = {**FLEETS, ("yi-6b", 3): THREE + [Case("vmap", batch=6)]}


CASES_PER_FLEET = 6


@functools.lru_cache(maxsize=None)
def _fleets() -> dict:
    """Every fleet's results, each rank's cases in one dict: all fleets run
    at once (a longer list of cases as several fleets of its size), each
    rank on one share of the worker's threads, while the one-process
    references run here."""
    jobs = [(key, cases[i:i + CASES_PER_FLEET]) for key, cases in ALL_FLEETS.items()
            for i in range(0, len(cases), CASES_PER_FLEET)]
    share = max(1, torch.get_num_threads() // sum(n for (_, n), _ in jobs))
    started = [(key, start_ranks(fleet_cases, key[1], key[0], cases, threads=share))
               for key, cases in jobs]
    for (arch, _), cases in ALL_FLEETS.items():
        for case in cases:
            if case.mode != "vmap":
                _reference(arch, case)
    out: dict = {}
    for key, fleet in started:
        ranks = out.setdefault(key, [{} for _ in range(key[1])])
        for mine, res in zip(ranks, fleet.result()):
            mine.update(res)
    return out


def _fleet(arch: str, n: int) -> list:
    return _fleets()[(arch, n)]


@functools.lru_cache(maxsize=None)
def _reference(arch: str, case: Case) -> dict:
    return step_case(arch, case)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _tree_err(got: dict, want: dict) -> float:
    """Max over leaves of the leafwise error (see the module docstring)."""
    assert got.keys() == want.keys()
    top = max(float(np.abs(v).max()) for v in want.values())
    worst = 0.0
    for k, w in want.items():
        leaf = float(np.abs(w).max())
        scale = leaf if leaf >= 1e-6 * top else top
        worst = max(worst, float(np.abs(got[k] - w).max()) / scale)
    return worst


def _check(got: dict, want: dict, key: str) -> None:
    assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"]), key
    assert abs(got["metric_loss"] - want["metric_loss"]) <= TOL * abs(want["metric_loss"]), key
    if not key.startswith("non_private"):
        assert _rel(got["norms"], want["norms"]) <= TOL, key
    assert _rel(got["factors"], want["factors"]) <= TOL, key
    for part in ("grads", "params", "m", "v"):
        assert _tree_err(got[part], want[part]) <= TOL, (key, part)
    for k, w in want["noise"].items():
        assert np.array_equal(got["noise"][k], w), (key, k)
    for k, w in want["policy"].items():
        assert _rel(got["policy"][k], w) <= TOL, (key, k)


@pytest.mark.parametrize("arch,n", sorted(FLEETS))
def test_fleet_step_matches_one_rank(arch, n):
    ranks = _fleet(arch, n)
    for case in FLEETS[(arch, n)]:
        want = _reference(arch, case)
        for r, res in enumerate(ranks):
            _check(res[case.key], want, f"{case.key} rank {r}")
        for a, b in zip(ranks, ranks[1:]):  # replicated results: equal on every rank
            assert np.array_equal(a[case.key]["norms"], b[case.key]["norms"])
            assert all(np.array_equal(a[case.key]["params"][k], v)
                       for k, v in b[case.key]["params"].items())


@pytest.mark.parametrize("arch,n", sorted(FLEETS))
def test_fleet_shards_are_real(arch, n):
    """Every leaf with a dividing "embed" dim is stored 1/n per rank, its
    Adam moments too; the rest whole."""
    from repro_torch.parallel.sharding import param_shardings

    cfg = get_arch(arch).reduced()
    places = flatten_dict(param_shardings(build_model(cfg, device="meta"),
                                          Mesh(("data", "model"), (n, 1)), cfg))
    res = _fleet(arch, n)[0][FLEETS[(arch, n)][0].key]
    sharded = {k for k, p in places.items() if "data" in p}
    assert sharded and any("embed" in k or "lm_head" in k for k in sharded)
    for k, frac in res["fraction"].items():
        assert frac == (1 / n if k in sharded else 1.0), k
        assert res["moment_fraction"][k] == frac, k
    if arch == "whisper-large-v3":  # every weight matrix shards: about half the bytes
        assert 0.5 <= res["stored_bytes"] < 0.51


def test_non_dividing_leaves_stay_whole():
    """d_model 64 on 3 ranks: nothing divides, every leaf is whole on every
    rank and its gradient is all-reduced; the step still equals one rank's."""
    for case in THREE:
        want = _reference("yi-6b", case)
        for res in _fleet("yi-6b", 3):
            assert set(res[case.key]["fraction"].values()) == {1.0}
            _check(res[case.key], want, case.key)


def test_vmap_raises_under_a_data_axis():
    for res in _fleet("yi-6b", 3):
        assert res[Case("vmap", batch=6).key] == "VmapUnderShardingError"


def _jax_step(arch: str, case: Case):
    """The JAX package's clipped call on the same weights and global batch
    (mask included), its policy built with the port's knobs."""
    from repro.policies import make_policy as jpolicy

    cfg = get_arch(arch).reduced()
    jmodel = jbuild(JARCHS[arch].reduced())
    params = make_train_state(build_model(cfg, device="cpu"), 0, adam())["params"]
    jparams = jax.tree_util.tree_map(
        jax.numpy.asarray, unflatten_dict({k: v.numpy() for k, v in flatten_dict(params).items()}))
    batch = {k: jax.numpy.asarray(v.numpy()) for k, v in _batches(cfg, case)[0].items()}
    policy = jpolicy(case.policy, clip_norm=CLIP, init_clip_norm=CLIP, gamma=0.01,
                     target_quantile=0.5, lr=0.2, release_sigma=1.0,
                     groups=("lm_head", "embed"))
    fn = jclip.dp_value_and_clipped_grad(
        jmodel.loss_with_ctx, jclip.ClipConfig(mode=case.mode, clip_norm=CLIP, policy=policy))
    loss, g, aux = jax.jit(fn)(jparams, batch, policy.init_state())
    return float(loss), np.asarray(aux["per_sample_norms"]), np.asarray(aux["clip_factors"]), {
        k: np.asarray(v, np.float32) for k, v in flatten_dict(g).items()}


@pytest.mark.parametrize("arch,n,case", [
    ("whisper-large-v3", 2, Case("mixed_ghost")),
    ("mixtral-8x7b", 2, Case("bk_mixed")),
    ("yi-6b", 4, Case("bk_mixed", "quantile", poisson=True)),
], ids=lambda v: v.key if isinstance(v, Case) else str(v))
def test_fleet_step_matches_jax(arch, n, case):
    loss, norms, factors, grads = _jax_step(arch, case)
    for r, res in enumerate(_fleet(arch, n)):
        res = res[case.key]
        assert abs(res["loss"] - loss) <= TOL * abs(loss), r
        assert _rel(res["norms"], norms) <= TOL, r
        assert _rel(res["factors"], factors) <= TOL, r
        assert _tree_err(res["grads"], grads) <= TOL, r


def test_batch_must_divide_over_the_data_axis():
    """A global batch whose rows do not divide over the data ranks raises:
    on a replicated batch every rank would count every sample."""
    mesh = Mesh(("data", "model"), (2, 1), groups={"data": None}, coords={"data": 0})
    layout = ShardLayout(mesh, {})
    with pytest.raises(ValueError, match="does not divide"):
        layout.local_rows({"tokens": torch.zeros((3, 16), dtype=torch.int64)})
    assert layout.local_rows({"tokens": torch.arange(4)})["tokens"].tolist() == [0, 1]
