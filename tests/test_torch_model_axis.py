"""The model axis in the DP-SGD step (tensor, expert and sequence
parallelism, and the model axis as batch): gloo CPU fleets of the sharded
step on live ``(data, model)`` meshes (``launch.mesh.make_mesh``) against
the one-process step, and the JAX package's step.

Fleets (spawned processes, ``tests/torch_dist.py``; the rank functions in
``tests/torch_model_axis_cases.py`` import no JAX), all started at once:

- reduced Mixtral on ``(2, 4)``, the JAX package's multidevice case (4
  experts, one a rank; ``ShapeConfig("t", 16, 4)``): ``mixed_ghost`` with
  the noise off under adam and ``warmup_cosine(1e-3, 2, 10)`` through
  ``make_train_step``, its loss, per-sample norms and clipped sum also
  against the JAX one-device clipped call on the same weights (1e-5; the
  JAX test allows 5e-4 between its sharded and one-device steps); a
  ``bk_mixed`` step with noise; ``vmap`` raises;
- reduced Mixtral on ``(1, 3)``: the fallbacks (4 experts do not divide,
  so their d_ff 96 splits; heads 4 x 16 and vocab 128 stay whole);
- reduced Qwen1.5-32B on ``(2, 2)`` and ``(1, 2)``: column- and
  row-parallel ``Dense``, the vocab-parallel embedding and loss,
  ``shard_seq`` under remat, in every fused mode, the ``*_taps``
  executors, a ``per_layer`` policy and a logical batch of 2 microsteps;
- reduced Yi-6B (``dp_only``) on ``(1, 2)``: the model axis as batch, and
  a batch of 3 that divides over data alone (the model ranks repeat it).

Held against the one-process step on the same inputs, fp32, at 1e-5:
the loss, per-sample norms and clip factors (relative), the clipped
gradient sum before the noise and the parameters after an SGD + momentum
step (each leaf within 1e-5 of its largest entry, a leaf that is zero up
to rounding against the tree's largest, as ``test_torch_dist_step.py``).
Adam's first step turns rounding noise in a near-zero gradient into
+-lr, so the Adam case gates the loss and norms and checks the parameters
finite.  Every rank returns the same replicated results, the same
fingerprint of the taps' full shapes as one rank, and stores its share.
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
from repro_torch.launch.steps import make_train_state
from repro_torch.optim import adam
from repro_torch.utils.tree import flatten_dict, unflatten_dict
from torch_dist import start_ranks
from torch_model_axis_cases import CLIP, Case, batches, fleet_cases, step_case
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 1e-5
QWEN = [Case(m) for m in ("non_private", "ghost", "fastgradclip", "mixed_ghost", "bk_mixed",
                          "mixed_ghost_taps", "bk_mixed_taps")] + [
    Case("mixed_ghost", "per_layer"), Case("bk_mixed", "per_layer"), Case("bk_mixed", accum=2)]
JAX_CASE = Case("mixed_ghost", seq=16, noise=0.0, opt="adam", train_step=True)
FLEETS = {
    ("mixtral-8x7b", (2, 4)): [JAX_CASE, Case("bk_mixed", seq=16), Case("vmap")],
    ("mixtral-8x7b", (1, 3)): [Case("mixed_ghost"), Case("bk_mixed_taps")],
    ("qwen1.5-32b", (2, 2)): QWEN,
    ("qwen1.5-32b", (1, 2)): QWEN,
    ("yi-6b", (1, 2)): [Case("mixed_ghost"), Case("bk_mixed", accum=2),
                        Case("mixed_ghost", batch=3)],  # 3 rows: over data alone
}


@functools.lru_cache(maxsize=None)
def _fleets() -> dict:
    """Every fleet's results, rank by rank: all fleets run at once, each rank
    on one share of the worker's threads, while the one-process references
    run here."""
    share = max(1, torch.get_num_threads() // sum(a * b for _, (a, b) in FLEETS))
    started = {key: start_ranks(fleet_cases, key[1][0] * key[1][1], key[0], key[1], cases,
                                threads=share)
               for key, cases in FLEETS.items()}
    for (arch, _), cases in FLEETS.items():
        for case in cases:
            if case.mode != "vmap":
                _reference(arch, case)
    return {key: fleet.result() for key, fleet in started.items()}


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


def _check(got: dict, want: dict, case: Case, where: str) -> None:
    assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"]), where
    assert abs(got["metric_loss"] - want["metric_loss"]) <= TOL * abs(want["metric_loss"]), where
    if case.mode != "non_private":
        assert _rel(got["norms"], want["norms"]) <= TOL, where
    assert _rel(got["factors"], want["factors"]) <= TOL, where
    assert _tree_err(got["grads"], want["grads"]) <= TOL, (where, "grads")
    if case.opt == "sgd":
        assert _tree_err(got["params"], want["params"]) <= TOL, (where, "params")
    else:
        assert all(np.isfinite(v).all() for v in got["params"].values()), where
    assert got["fingerprint"] == want["fingerprint"], where


@pytest.mark.parametrize("arch,shape", sorted(FLEETS), ids=str)
def test_model_axis_step_matches_one_rank(arch, shape):
    ranks = _fleets()[(arch, shape)]
    for case in FLEETS[(arch, shape)]:
        if case.mode == "vmap":
            assert all(r[case.key] == "VmapUnderShardingError" for r in ranks)
            continue
        want = _reference(arch, case)
        for r, res in enumerate(ranks):
            _check(res[case.key], want, case, f"{case.key} rank {r}")
        for a, b in zip(ranks, ranks[1:]):  # replicated results: equal on every rank
            assert np.array_equal(a[case.key]["norms"], b[case.key]["norms"])
            assert np.array_equal(a[case.key]["factors"], b[case.key]["factors"])


@pytest.mark.parametrize("arch,shape", sorted(FLEETS), ids=str)
def test_model_axis_shards_are_real(arch, shape):
    """Each rank stores its share: 1/data of every "embed" dim, 1/model of
    every model-axis dim; a leaf whole on the model axis comes out of the
    step the same on every model rank, a split one differs."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import param_shardings

    cfg = get_arch(arch).reduced()
    places = flatten_dict(param_shardings(build_model(cfg, device="meta"),
                                          Mesh(("data", "model"), shape), cfg))
    ranks = _fleets()[(arch, shape)]
    key = next(c.key for c in FLEETS[(arch, shape)] if c.mode != "vmap")
    for path, p in places.items():
        names = [a for e in p for a in (e if isinstance(e, tuple) else (e,))]
        share = (1 / shape[0] if "data" in names else 1) * (1 / shape[1] if "model" in names
                                                             else 1)
        assert ranks[0][key]["fraction"][path] == share, path
    on_model = {k for k, p in places.items() if "model" in str(p)}
    if cfg.parallelism == "dp_only":
        assert not on_model
        return
    assert on_model
    m = shape[1]
    for d in range(shape[0]):  # the model ranks of each data row
        row = [ranks[d * m + j][key]["local_grads"] for j in range(m)]
        for path in places:
            same = all(np.array_equal(row[0][path], r[path]) for r in row[1:])
            assert same == (path not in on_model), path


def test_model_axis_bytes_move_on_both_axes():
    """The (2, 4) fleet's collectives: the model axis all-reduces the
    activations; the data axis gathers the weights."""
    res = _fleets()[("mixtral-8x7b", (2, 4))][0][JAX_CASE.key]["bytes"]
    assert res["all_reduce"] > 0 and res["all_gather"] > 0 and res["reduce_scatter"] > 0


@functools.lru_cache(maxsize=None)
def _jax_clipped(arch: str, case: Case):
    """The JAX package's one-device clipped call (its step's loss) on the
    same weights and global batch."""
    cfg = get_arch(arch).reduced()
    jmodel = jbuild(JARCHS[arch].reduced())
    params = make_train_state(build_model(cfg, device="cpu"), 0, adam())["params"]
    jparams = jax.tree_util.tree_map(
        jax.numpy.asarray, unflatten_dict({k: v.numpy() for k, v in flatten_dict(params).items()}))
    batch = {k: jax.numpy.asarray(v.numpy()) for k, v in batches(cfg, case)[0].items()}
    fn = jclip.dp_value_and_clipped_grad(
        jmodel.loss_with_ctx, jclip.ClipConfig(mode=case.mode, clip_norm=CLIP))
    loss, g, aux = jax.jit(fn)(jparams, batch)
    return float(loss), np.asarray(aux["per_sample_norms"]), {
        k: np.asarray(v, np.float32) for k, v in flatten_dict(g).items()}


def test_model_axis_matches_jax_one_device():
    loss, norms, grads = _jax_clipped("mixtral-8x7b", JAX_CASE)
    for r, res in enumerate(_fleets()[("mixtral-8x7b", (2, 4))]):
        res = res[JAX_CASE.key]
        assert abs(res["loss"] - loss) <= TOL * abs(loss), r
        assert abs(res["metric_loss"] - loss) <= TOL * abs(loss), r
        assert _rel(res["norms"], norms) <= TOL, r
        assert _tree_err(res["grads"], grads) <= TOL, r
