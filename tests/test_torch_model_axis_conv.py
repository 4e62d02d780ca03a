"""The model axis for the convolutions in the DP-SGD step: gloo CPU fleets of
the sharded step on live ``(data, model)`` meshes (``launch.mesh
.make_mesh``) against the one-process step and the JAX package's
one-device clipped call (``tests/torch_model_axis_refs.py``; the rank
functions in ``tests/torch_model_axis_conv_cases.py`` import no JAX).

Models, with the same weights in both packages and the same numpy batch of
4:

- VGG-11 at 1/8 of its widths, 32 x 32: every conv split on its output
  channels and gathered, GroupNorm whole, 10 classes split on a model axis
  of 2 and whole on 4;
- a ResNet of two basic blocks (width 16), the second opening with a
  strided 1 x 1 ``proj`` shortcut, 16 x 16;
- the 2-layer reduced ViT (16 x 16 images, 4 x 4 patches): the split patch
  embedding, the whole ``pos_embed``, the blocks tensor-parallel.

Fleets, all started at once: ``(1, 2)`` in ``non_private``, ``ghost``,
``mixed_ghost``, ``bk_mixed``, a ``*_taps`` mode and accumulation;
``(2, 2)`` (the data axis too, FSDP of the "embed" dims); ``(1, 4)`` where
the widths divide.  Held at 1e-5, fp32: the loss, per-sample norms and clip
factors (relative), the clipped gradient sum before the noise and the
parameters after an SGD + momentum step (each leaf within 1e-5 of its
largest entry) against one rank; the loss, norms and clipped sum against
the JAX one-device clipped call on the whole batch (``mixed_ghost``: every
clipping mode computes the same clipped sum; ``non_private`` against JAX's
``non_private``).  Every rank returns the same norms and the fingerprint
of the taps' full shapes; each stores its share (1/model of every conv
weight), and a leaf whole on the model axis comes out of the step the same
on every model rank, bit for bit.

Units (2- and 4-rank fleets): a split ``Conv2d`` (its output, input
gradient, weight and split-bias gradients, recorded shapes, norms and
clipped sums in four engines) before a whole ``GroupNorm`` (its gradient
equal on every rank); channels gathered by ``reshard.whole_cols`` stored
contiguous, so the whole ``GroupNorm`` after them gives one rank's bits;
the tuner on a split conv tap.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from torch_model_axis_conv_cases import UNIT_MODES, Case, conv_units
from torch_model_axis_refs import TOL, check_shards, check_step, rel, run_fleets, step_cases
from torch_threads import torch_threads_per_worker  # noqa: F401

MG, BK = Case("mixed_ghost"), Case("bk_mixed")
FLEETS = {
    (1, 2): {"vgg11": [Case("non_private"), Case("ghost"), MG, BK, Case("bk_mixed_taps"),
                       Case("mixed_ghost", accum=2)],
             "resnet": [MG, BK], "vit": [MG, BK, Case("mixed_ghost_taps")]},
    (2, 2): {"vgg11": [MG, BK], "resnet": [BK], "vit": [MG]},
    (1, 4): {"vgg11": [MG, BK], "vit": [BK]},
}
CASES, IDS = step_cases(FLEETS)


@functools.lru_cache(maxsize=None)
def _fleets() -> dict:
    return run_fleets(FLEETS, conv_units)


@pytest.mark.parametrize("shape,name,case", CASES, ids=IDS)
def test_conv_model_axis_step_matches_one_rank_and_jax(shape, name, case):
    check_step(_fleets()[shape], name, case)


@pytest.mark.parametrize("shape", sorted(FLEETS), ids=str)
def test_conv_model_axis_shards_are_real(shape):
    check_shards(_fleets()[shape], shape, FLEETS[shape],
                 lambda path: path.endswith("/w") and any(
                     k in path for k in ("conv", "patch_embed", "/c1/", "/c2/", "/proj/",
                                         "stem")))


def test_conv_model_axis_moves_activations():
    """The (1, 2) VGG step all-gathers the conv outputs and all-reduces the
    inputs' gradients; the (2, 2) step also reduce-scatters the weights'."""
    vgg = _fleets()[(1, 2)][0][("vgg11", MG.key)]["bytes"]
    assert vgg["all_gather"] > 0 and vgg["all_reduce"] > 0
    assert _fleets()[(2, 2)][0][("vgg11", MG.key)]["bytes"]["reduce_scatter"] > 0


@functools.lru_cache(maxsize=None)
def _units_ref() -> dict:
    return conv_units(0, 1)


@pytest.mark.parametrize("n", [2, 4])
def test_split_conv_and_whole_groupnorm(n):
    """A split ``Conv2d`` then a whole ``GroupNorm``: the output and the
    input's gradient are one rank's, the conv's weight and bias gradients
    its slices, the GroupNorm's whole gradients equal on every rank; the
    tap keeps the full ``D``, ``p`` with its slice in ``local``; norms (the
    split bias counted on every rank) and clipped sums are one rank's."""
    want = _units_ref()["conv"]
    ranks = [res["conv"] for res in _fleets()[("units", n)]]
    for r, got in enumerate(ranks):
        assert rel(got["y"], want["y"]) <= TOL and rel(got["dx"], want["dx"]) <= TOL
        for path in ("conv/w", "conv/b"):
            assert rel(got["grads"][path], np.split(want["grads"][path], n)[r]) <= TOL, path
        for path in ("gn/g", "gn/b"):
            assert rel(got["grads"][path], want["grads"][path]) <= TOL, path
            assert np.array_equal(got["grads"][path], ranks[0]["grads"][path]), path
        assert got["meta"]["conv/out"][:3] == (27, 8, (27, 8 // n, 1))
        assert got["meta"]["conv/out"][3] == (3, 6, 6, 8 // n)
        assert got["meta"]["gn/out"][2] is None
        for mode in UNIT_MODES:
            assert rel(got[mode]["norms"], want[mode]["norms"]) <= TOL, mode
            for path, g in got[mode]["grads"].items():
                full = want[mode]["grads"][path]
                mine = np.split(full, n)[r] if path.startswith("conv") else full
                assert rel(g, mine) <= TOL, (mode, path)


@pytest.mark.parametrize("n", [2, 4])
def test_gathered_channels_keep_one_ranks_bits(n):
    """A split conv's gathered output is contiguous, as one rank's is, so
    the whole ``GroupNorm`` after it sums its statistics in one rank's
    order: its output is one rank's bit for bit (a channel-major view put
    ~1e-7 between them, and on the card flipped ReLUs of VGG-19)."""
    want = _units_ref()["gathered_gn"]["y"]
    for res in _fleets()[("units", n)]:
        assert res["gathered_gn"]["contiguous"]
        assert np.array_equal(res["gathered_gn"]["y"], want)


def test_tuner_times_a_split_conv_tap_at_its_slice():
    """A split conv tap is timed at this rank's slice of its output
    channels and keyed on its full shape; the decisions are the whole
    tap's (the bk_mixed rule reads the whole raw input)."""
    from repro_torch.core.decision import decide
    from repro_torch.core.taps import ConvInfo, TapMeta
    from repro_torch.tuner.measure import MeasureConfig, measure_tap
    from repro_torch.tuner.plan import tap_signature

    conv = ConvInfo(kernel=(3, 3), strides=(1, 1), padding="SAME")
    # 4 x 4 positions of 8 channels: the book of the raw input (128 + 256
    # floats a sample) is under the 1152-float gradient, the unfolded one
    # (1152 + 256) is not
    whole = TapMeta(kind="matmul", T=16, D=8 * 9, p=16, s_shape=(2, 4, 4, 16),
                    s_dtype=torch.float32, param_path="w", batch_size=2,
                    a_shape=(2, 4, 4, 8), a_dtype=torch.float32, conv=conv)
    split = dataclasses.replace(whole, s_shape=(2, 4, 4, 8), local=(72, 8, 1))
    timing = measure_tap(split, MeasureConfig(repeats=1, warmup=1), device="cpu")
    assert timing is not None and timing.ghost_us > 0 and timing.bk_instantiate_us > 0
    assert tap_signature("t", split) == tap_signature("t", whole)
    for mode in ("mixed_ghost", "bk_mixed"):
        assert decide(split, mode=mode) == decide(whole, mode=mode)
    assert decide(split, mode="bk_mixed") == "ghost"
