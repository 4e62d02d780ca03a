"""The model axis for Mamba's heads (Jamba) in the DP-SGD step: gloo CPU
fleets of the sharded step on live ``(data, model)`` meshes against the
one-process step and the JAX package's one-device clipped call
(``tests/torch_model_axis_refs.py``; the rank functions in
``tests/torch_model_axis_conv_cases.py`` import no JAX).

Reduced Jamba (d_model 64, 16 SSM heads of 8, d_state 8), 4 x 16 tokens,
the same weights in both packages: one Mamba layer with its dense MLP, and
the ("mamba", "attn") period (MoE on the attention layer).  On the model
axis ``in_z`` / ``in_x`` and the depthwise conv split the heads,
``out_proj`` is row-parallel, ``in_bcdt`` and the dt stream stay whole.
Fleets: ``(1, 2)`` in ``non_private``, ``mixed_ghost``, ``bk_mixed`` and
``bk_mixed_taps``; ``(2, 2)`` with accumulation; ``(1, 4)``.  Held as the
convolutions' fleets are (``tests/test_torch_model_axis_conv.py``): at
1e-5 against one rank and the JAX call (``mixed_ghost``, or
``non_private``); each rank stores 1/model of the
Mamba projections, and the whole leaves come out equal on every model rank.

Units (2- and 4-rank fleets): a Mamba block's per-tap norms (the whole
``in_bcdt`` tap equal to one rank's on every rank, and off it when each
rank's cotangent is only its heads' part; the split taps adding up), its
whole leaves' gradients equal on every rank; the split ``RMSNorm`` over
``d_inner``.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

from torch_model_axis_conv_cases import Case, mamba_units
from torch_model_axis_refs import TOL, check_shards, check_step, rel, run_fleets, step_cases
from torch_threads import torch_threads_per_worker  # noqa: F401

MG, BK = Case("mixed_ghost"), Case("bk_mixed")
FLEETS = {
    (1, 2): {"mamba": [Case("non_private"), MG, BK, Case("bk_mixed_taps")],
             "jamba": [MG, BK]},
    (2, 2): {"jamba": [MG, Case("bk_mixed", accum=2)]},
    (1, 4): {"mamba": [MG, BK]},
}
CASES, IDS = step_cases(FLEETS)


@functools.lru_cache(maxsize=None)
def _fleets() -> dict:
    return run_fleets(FLEETS, mamba_units)


@pytest.mark.parametrize("shape,name,case", CASES, ids=IDS)
def test_mamba_model_axis_step_matches_one_rank_and_jax(shape, name, case):
    check_step(_fleets()[shape], name, case)


@pytest.mark.parametrize("shape", sorted(FLEETS), ids=str)
def test_mamba_model_axis_shards_are_real(shape):
    check_shards(_fleets()[shape], shape, FLEETS[shape],
                 lambda path: "mamba/in_" in path and "bcdt" not in path)


@functools.lru_cache(maxsize=None)
def _units_ref() -> dict:
    return mamba_units(0, 1)


@pytest.mark.parametrize("n", [2, 4])
def test_mamba_block_taps_against_one_rank(n):
    """Mamba's taps on n ranks: the split taps' norms add up to one rank's,
    the whole taps' (``in_bcdt``, ``dt_bias``, ``A_log``) equal it on every
    rank; the output, the input's gradient and the whole leaves' gradients
    (``in_bcdt``, ``D``, the norm's gain, ``dt_bias``, ``A_log``) are one
    rank's, equal on every rank."""
    want = _units_ref()["mamba"]
    ranks = [res["mamba"] for res in _fleets()[("units", n)]]
    for got in ranks:
        assert rel(got["y"], want["y"]) <= TOL and rel(got["dx"], want["dx"]) <= TOL
        for tap in ("in_bcdt/out", "dt_bias@out", "A_log@out"):
            assert not got["split"][tap]
            assert rel(got["norms"][tap], want["norms"][tap]) <= TOL, tap
        for path in ("in_bcdt/w", "D", "norm/g", "dt_bias", "A_log"):
            assert rel(got["grads"][path], want["grads"][path]) <= TOL, path
            assert np.array_equal(got["grads"][path], ranks[0]["grads"][path]), path
    split = [tap for tap, s in ranks[0]["split"].items() if s]
    assert set(split) == {"in_z/out", "in_x/out", "conv/out", "D@out", "norm/out",
                          "out_proj/out"}
    for tap in split:
        assert rel(sum(r["norms"][tap] for r in ranks), want["norms"][tap]) <= TOL, tap


def test_mamba_in_bcdt_needs_its_complete_cotangent():
    """Without ``copy_to_model`` on B and C each rank's ``in_bcdt``
    cotangent holds only its heads' part: neither a rank's norm of the tap
    nor the sum of the ranks' squared norms is one rank's."""
    want = _units_ref()["mamba"]["norms"]["in_bcdt/out"]
    partial = [res["mamba_partial"]["norms"]["in_bcdt/out"]
               for res in _fleets()[("units", 2)]]
    assert min(rel(p, want) for p in partial) > 1e-2
    assert rel(sum(partial), want) > 1e-2


@pytest.mark.parametrize("n", [2, 4])
def test_split_rmsnorm_over_d_inner(n):
    """RMSNorm given 12 / n channels: the sum of squares over all of them,
    each rank's output and input gradient its slices of one rank's, the
    whole gain's gradient complete on every rank, the tap split and its
    norms adding up to one rank's."""
    want = _units_ref()["rmsnorm"]
    ranks = [res["rmsnorm"] for res in _fleets()[("units", n)]]
    for r, got in enumerate(ranks):
        assert rel(got["y"], np.split(want["y"], n, axis=-1)[r]) <= TOL
        assert rel(got["dx"], np.split(want["dx"], n, axis=-1)[r]) <= TOL
        assert rel(got["dg"], want["dg"]) <= TOL
        assert np.array_equal(got["dg"], ranks[0]["dg"])
        assert got["local"] == (12 // n, 12 // n, 1)
    assert rel(sum(r["tap"] for r in ranks), want["tap"]) <= TOL
