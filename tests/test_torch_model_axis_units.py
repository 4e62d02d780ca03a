"""The model axis's pieces, each on a small gloo fleet against one rank
(``tests/torch_model_axis_cases.py``; two fleets started at once):

- a column-parallel ``Dense`` feeding a row-parallel one, with and without
  biases: the output and the input's gradient equal to one rank's, each
  rank's weight gradients its slices of one rank's, the whole row-parallel
  bias's gradient whole on every rank; the taps keep the full ``D`` and
  ``p`` and record this rank's in ``local``;
- ``Attention`` with the rules' q/k/v/o placements: whole heads to a rank
  with their KV heads local, KV heads split inside a head (gathered, their
  gradients summed), heads split inside a head (every rank attends with
  all of them), KV heads whole (4 / 1, ``copy_to_model``) and GQA with 2
  local q heads on one KV head (8 / 2 on 4 ranks);
- ``vocab_parallel_xent`` against ``per_sample_xent``: loss and the
  logits' gradient, with ignored labels and a sample mask;
- ``shard_seq`` / ``unshard_seq``: each rank stores its T / n slice, the
  whole carry comes back, the gradient is one rank's;
- ``ShardLayout.reduce_grads`` on a (2, 2) mesh, a leaf split on both axes:
  the autograd route kept, the compute-shape route reduce-scattered over
  data only, a whole leaf all-reduced over data only;
- the clipping engines (fused, ``*_taps``) on that pair: per-sample norms
  and clipped sums equal to one rank's, the split bias's norm summed over
  the ranks, the whole one counted once;
- ``per_host_batch`` on a model axis that spans processes;
- the paths once refused, running and splitting: ``shard_heads``, a
  convolution (VGG-11: ``cfg`` None resolves as tensor-parallel), Jamba's
  Mamba, Mixtral's sharded prefill;
- the tuner on a split tap: timed at the slice, keyed on the full shape.

Tolerance 1e-5 relative (fp32; the sums run in another order).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.models.losses import per_sample_xent
from torch_dist import start_ranks
from torch_model_axis_cases import (
    ATTENTION,
    CLIP_UNIT_MODES,
    unit_attention,
    unit_clip,
    unit_dense,
    units,
)
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _fleets() -> dict:
    started = {n: start_ranks(units, n, threads=1) for n in (2, 4)}
    return {n: fleet.result() for n, fleet in started.items()}


def _rel(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _slice(full: np.ndarray, dim, n: int, r: int) -> np.ndarray:
    return full if dim is None else np.split(full, n, axis=dim)[r]


@pytest.mark.parametrize("bias", [False, True])
def test_column_then_row_dense(bias):
    want = unit_dense(0, 1, bias)
    ranks = _fleets()[2]
    for r, res in enumerate(ranks):
        got = res["dense"][bias]
        assert _rel(got["y"], want["y"]) <= TOL and _rel(got["dx"], want["dx"]) <= TOL
        dims = {"up/w": 1, "up/b": 0, "down/w": 0, "down/b": None}
        for k, w in want["grads"].items():
            assert _rel(got["grads"][k], _slice(w, dims[k], 2, r)) <= TOL, k
        assert got["meta"]["up/out"] == (8, 12, (8, 6, 1))
        assert got["meta"]["down/out"] == (12, 8, (6, 8, 1))
    if bias:  # the whole row-parallel bias: the same gradient on both ranks
        assert np.array_equal(ranks[0]["dense"][bias]["grads"]["down/b"],
                              ranks[1]["dense"][bias]["grads"]["down/b"])


@pytest.mark.parametrize("mode", CLIP_UNIT_MODES)
def test_split_and_whole_biases_in_the_norms(mode):
    """The clipping engines on a column- then row-parallel pair with biases:
    per-sample norms and clipped sums equal to one rank's (the split bias's
    part summed over the ranks, the whole bias's counted once)."""
    want = unit_clip(0, 1)[mode]
    dims = {"up/w": 1, "up/b": 0, "down/w": 0, "down/b": None}
    for r, res in enumerate(_fleets()[2]):
        got = res["clip"][mode]
        assert _rel(got["norms"], want["norms"]) <= TOL, r
        for k, w in want["grads"].items():
            assert _rel(got["grads"][k], _slice(w, dims[k], 2, r)) <= TOL, (r, k)


def test_per_host_batch_counts_the_model_axis():
    """A model axis that spans processes: the batch shards over data only
    under tensor parallelism (each process holds global / data samples),
    over data x model under dp_only."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import per_host_batch

    mesh = Mesh(("data", "model"), (2, 4), hosts=8)
    assert per_host_batch(16, mesh, get_arch("mixtral-8x7b")) == 8
    assert per_host_batch(16, mesh, get_arch("yi-6b")) == 2
    assert per_host_batch(12, mesh, get_arch("yi-6b")) == 12  # does not divide: whole


@pytest.mark.parametrize("n,config", [(n, c) for n, cs in ATTENTION.items() for c in cs],
                         ids=lambda v: str(v))
def test_attention_heads_on_the_model_axis(n, config):
    heads, kv, hd = config
    want = unit_attention(1, heads, kv, hd)
    for r, res in enumerate(_fleets()[n]):
        got = res["attention"][config]
        assert _rel(got["y"], want["y"]) <= TOL, r
        assert _rel(got["dx"], want["dx"]) <= TOL, r
        for k, w in want["grads"].items():
            assert _rel(got["grads"][k], _slice(w, got["split"][k[0]], n, r)) <= TOL, (r, k)
    split = _fleets()[n][0]["attention"][config]["split"]
    assert split["q"] == (1 if (heads * hd) % n == 0 else None)
    assert split["o"] == (0 if split["q"] == 1 else None)


def test_vocab_parallel_xent():
    gen = torch.Generator().manual_seed(7)
    logits = (4 * torch.randn(3, 5, 12, generator=gen)).requires_grad_(True)
    labels = torch.randint(0, 12, (3, 5), generator=gen)
    labels[0, :2] = -100
    loss = per_sample_xent(logits, labels, torch.tensor([1.0, 0.0, 1.0]))
    (loss * torch.arange(1.0, 4.0)).sum().backward()
    for r, res in enumerate(_fleets()[2]):
        assert _rel(res["xent"]["loss"], loss.detach().numpy()) <= TOL
        assert _rel(res["xent"]["grad"], logits.grad.chunk(2, dim=-1)[r].numpy()) <= TOL


def test_shard_seq_round_trip():
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 8, 3, generator=gen).requires_grad_(True)
    w = torch.randn(2, 8, 3, generator=gen)
    whole = torch.sin(x)
    (whole * w).sum().backward()
    for r, res in enumerate(_fleets()[2]):
        got = res["seq"]
        assert np.array_equal(got["part"], whole.detach()[:, 4 * r:4 * (r + 1)].numpy())
        assert np.array_equal(got["whole"], whole.detach().numpy())
        assert _rel(got["dx"], x.grad.numpy()) <= TOL


def test_reduce_grads_on_both_axes():
    ranks = [res["reduce"] for res in _fleets()[4]]
    for res in ranks:
        d, m = res["coords"]
        assert res["full_shape"] == (4, 6) and res["compute_shape"] == (4, 3)
        col = [i for i, o in enumerate(ranks) if o["coords"][1] == m]  # this model column
        mine = float(2 * d + m + 1)
        assert np.array_equal(res["stored"]["w"], np.full((2, 3), mine))  # already reduced
        total = sum(float(i + 1) for i in col) * np.arange(12.0).reshape(4, 3)
        assert np.array_equal(res["compute"]["w"], total[2 * d:2 * (d + 1)])
        assert np.array_equal(res["stored"]["b"], np.full(6, sum(float(i + 1) for i in col)))


@pytest.mark.parametrize("path", ["shard_heads", "conv", "mamba", "prefill"])
def test_refusals_name_the_next_slice(path):
    """The paths once refused on a model axis above one run and split: a
    tensor's heads, VGG-11's first conv (64 output channels, 32 a rank),
    Jamba's ``in_x`` (this rank's half of d_inner 128) beside its whole
    ``in_bcdt``, and Mixtral's prefill through ``make_prefill_step`` (its
    16-row cache by KV head, 2 of 4 a rank; every lane's logits over the
    whole vocabulary, the one-rank prefill's at 1e-5)."""
    for res in _fleets()[2]:
        msg = res["refusals"][path]
        assert msg == "ran", msg
        shards = res["refusals"]["shards"][path]
        if path == "prefill":
            assert shards["k"] == (4, 2, 16, 2, 16) and shards["logits"] == (2, 1, 128)
            assert shards["err"] <= TOL, shards
        elif path == "shard_heads":
            assert shards == (2, 4, 2, 8)
        elif path == "conv":
            assert shards == {"conv0/out": (27, 32, 1)}
        else:
            assert shards == {"layers/0/mamba/in_x/out": (64, 64, 1),
                              "layers/0/mamba/in_bcdt/out": None}


@pytest.mark.parametrize("local", [(16, 12, 1), (8, 24, 1), (16, 24, 2)],
                         ids=["column", "row", "experts"])
def test_tuner_times_a_split_tap_at_its_slice(local):
    """The tuner times a tap the model axis splits at this rank's slice and
    keys it on the full shape: the signature and the decisions are the
    whole tap's."""
    from repro_torch.core.decision import decide
    from repro_torch.core.taps import TapMeta
    from repro_torch.tuner.measure import MeasureConfig, measure_tap
    from repro_torch.tuner.plan import tap_signature

    d, p, groups = local
    g_full = 4 if groups > 1 else 1
    lead = (2, groups) if groups > 1 else (2,)
    split = TapMeta(kind="matmul", T=8, D=16, p=24, s_shape=lead + (8, p),
                    s_dtype=torch.float32, param_path="w", n_groups=g_full, batch_size=2,
                    a_shape=lead + (8, d), a_dtype=torch.float32, local=local)
    whole_lead = (2, g_full) if groups > 1 else (2,)
    whole = dataclasses.replace(split, local=None, s_shape=whole_lead + (8, 24),
                                a_shape=whole_lead + (8, 16))
    timing = measure_tap(split, MeasureConfig(repeats=1, warmup=1), device="cpu")
    assert timing is not None and timing.ghost_us > 0 and timing.second_bwd_us > 0
    assert tap_signature("t", split) == tap_signature("t", whole)
    assert (split.local_view().D, split.local_view().p, split.local_view().n_groups) == local
    for mode in ("mixed_ghost", "bk_mixed"):
        assert decide(split, mode=mode) == decide(whole, mode=mode)
