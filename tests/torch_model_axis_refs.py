"""The references of ``tests/test_torch_model_axis_conv.py`` and
``tests/test_torch_model_axis_mamba.py``: the models' numpy inputs, the
one-process step, the JAX package's one-device clipped call, the fleets and
the checks both files make (``tests/torch_model_axis_conv_cases.py`` holds
the rank functions, which import no JAX).

Both packages and every rank take the same numpy weights and batch
(``torch_model_axis_conv_cases.inputs``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.configs.paper_native import VIT_BASE as JVIT_BASE
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import build_model as jbuild
from repro.core import clipping as jclip
from repro.models import cnn as jcnn
from repro.models import vit as jvit
from repro_torch import interop
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel.sharding import param_shardings
from repro_torch.utils.tree import flatten_dict
from torch_dist import start_ranks
from torch_model_axis_conv_cases import (
    CLIP,
    MODELS,
    N_CLASSES,
    RESNET,
    SEED,
    VGG11_NARROW,
    VIT,
    Case,
    conv_step,
    fleet_steps,
    inputs,
    port_model,
)

TOL = 1e-5


@contextlib.contextmanager
def _narrow_plan():
    """VGG-11's narrow plan in the JAX package while its model is built."""
    jcnn.VGG_PLANS["vgg11_narrow"] = VGG11_NARROW
    try:
        yield
    finally:
        del jcnn.VGG_PLANS["vgg11_narrow"]


def _jax_model(name: str):
    if name == "vgg11":
        with _narrow_plan():
            return jcnn.VGG("vgg11_narrow", n_classes=N_CLASSES)
    if name == "resnet":
        return jcnn.ResNet(n_classes=N_CLASSES, **RESNET)
    if name == "vit":
        return jvit.ViT(dataclasses.replace(JVIT_BASE.reduced(), n_layers=2),
                        n_classes=N_CLASSES, **VIT)
    pattern = MODELS[name]
    return jbuild(dataclasses.replace(JARCHS["jamba-1.5-large-398b"].reduced(),
                                      block_pattern=pattern, n_layers=len(pattern)))


def run_fleets(fleets: dict, units_fn) -> dict:
    """Every fleet's results, rank by rank, and ``units_fn``'s fleets on 2
    and 4 ranks (keys ``("units", n)``); the references run here meanwhile."""
    share = max(1, torch.get_num_threads() // sum(a * b for a, b in fleets))
    started = {shape: start_ranks(fleet_steps, shape[0] * shape[1], shape,
                                  [(name, c) for name, cases in jobs.items() for c in cases],
                                  threads=share)
               for shape, jobs in fleets.items()}
    started.update({("units", n): start_ranks(units_fn, n, threads=1) for n in (2, 4)})
    for jobs in fleets.values():
        for name, cases in jobs.items():
            for c in cases:
                reference(name, c)
                jax_clipped(name, jax_mode(c))
    return {key: fleet.result() for key, fleet in started.items()}


@functools.lru_cache(maxsize=None)
def reference(name: str, case: Case) -> dict:
    return conv_step(name, case)


def jax_mode(case: Case) -> str:
    """The JAX call a case is held against: ``mixed_ghost`` for every
    clipped mode (the modes compute one function: each sample's gradient
    clipped, then summed), ``non_private`` for the unclipped sum."""
    return "non_private" if case.mode == "non_private" else "mixed_ghost"


@functools.lru_cache(maxsize=None)
def jax_clipped(name: str, mode: str):
    """The JAX package's one-device clipped call on the same weights and
    global batch: (loss, norms, clipped sum in the port's layout)."""
    params, batch = inputs(name)
    jmodel = _jax_model(name)
    fn = jclip.dp_value_and_clipped_grad(jmodel.loss_with_ctx,
                                         jclip.ClipConfig(mode=mode, clip_norm=CLIP))
    jp = jax.tree_util.tree_map(jax.numpy.asarray, params)
    loss, g, aux = jax.jit(fn)(jp, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    grads = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, g),
                                    port_model(name)[0].conv_weights, device="cpu")
    return float(loss), np.asarray(aux["per_sample_norms"]), {
        k: v.numpy() for k, v in flatten_dict(grads).items()}


def rel(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def tree_err(got: dict, want: dict) -> float:
    """Max over leaves of |got - want| over the leaf's largest |want| (a
    leaf zero up to rounding, under 1e-6 of the tree's largest entry, over
    the tree's largest)."""
    assert got.keys() == want.keys()
    top = max(float(np.abs(v).max()) for v in want.values())
    worst = 0.0
    for k, w in want.items():
        leaf = float(np.abs(w).max())
        scale = leaf if leaf >= 1e-6 * top else top
        worst = max(worst, float(np.abs(got[k] - w).max()) / scale)
    return worst


def step_cases(fleets: dict) -> list:
    """(shape, model, case) of every fleet job, and their ids."""
    cases = [(shape, name, c) for shape, jobs in fleets.items()
             for name, cs in jobs.items() for c in cs]
    return cases, [f"{s}-{n}-{c.key}" for s, n, c in cases]


def check_step(ranks: list, name: str, case: Case) -> None:
    """Every rank's results against one rank's and the JAX call's (1e-5):
    loss, norms, factors, the clipped sum, the parameters after the step,
    the fingerprint; the norms equal on every rank."""
    want = reference(name, case)
    jloss, jnorms, jgrads = jax_clipped(name, jax_mode(case))
    for r, res in enumerate(ranks):
        got, where = res[(name, case.key)], f"{name} {case.key} rank {r}"
        assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"]), where
        assert abs(got["loss"] - jloss) <= TOL * abs(jloss), where
        if case.mode != "non_private":
            assert rel(got["norms"], want["norms"]) <= TOL, where
            assert rel(got["norms"], jnorms) <= TOL, where
        if case.accum == 1:
            assert rel(got["factors"], want["factors"]) <= TOL, where
        assert tree_err(got["grads"], want["grads"]) <= TOL, (where, "grads")
        assert tree_err(got["grads"], jgrads) <= TOL, (where, "grads vs JAX")
        assert tree_err(got["params"], want["params"]) <= TOL, (where, "params")
        assert got["fingerprint"] == want["fingerprint"], where
    for a, b in zip(ranks, ranks[1:]):  # replicated results: equal on every rank
        assert np.array_equal(a[(name, case.key)]["norms"], b[(name, case.key)]["norms"])


def check_shards(ranks: list, shape: tuple, jobs: dict, split_weights) -> None:
    """Each rank stores its share of every leaf (1/data of each "embed"
    dim, 1/model of each model-axis dim; ``split_weights(path)`` names the
    weights that must be stored at most 1/model); a leaf whole on the model
    axis comes out of the step the same on every model rank, bit for bit,
    a split one differs."""
    m = shape[1]
    for name, cases in jobs.items():
        model, cfg = port_model(name)
        params = model.init(torch.Generator().manual_seed(SEED))
        places = flatten_dict(param_shardings(model, Mesh(("data", "model"), shape), cfg,
                                              params))
        key = (name, cases[0].key)
        for path, p in places.items():
            names = [a for e in p for a in (e if isinstance(e, tuple) else (e,))]
            share = (1 / shape[0] if "data" in names else 1) * (1 / m if "model" in names else 1)
            assert ranks[0][key]["fraction"][path] == share, (name, path)
        on_model = {k for k, p in places.items() if "model" in str(p)}
        split = [k for k in places if split_weights(k)]
        assert split, name
        for path in split:
            assert path in on_model and ranks[0][key]["fraction"][path] <= 1 / m, (name, path)
        for d in range(shape[0]):  # the model ranks of each data row
            row = [ranks[d * m + j][key]["local_grads"] for j in range(m)]
            for path in places:
                same = all(np.array_equal(row[0][path], r[path]) for r in row[1:])
                assert same == (path not in on_model), (name, path)
