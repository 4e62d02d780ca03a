"""Sharded prefill and decode on the model axis: gloo CPU fleets of
``launch.steps.make_prefill_step`` / ``make_decode_step`` on live ``(data,
model)`` meshes, each rank holding its slices of the parameters and of the
serve state (``parallel.sharding.local_serve_shardings``), against the
one-process steps and the JAX package's one-device ``prefill`` /
``decode_step`` on the same numpy weights (``interop.params_from_jax``).

Fleets (spawned processes, ``tests/torch_dist.py``; the rank functions in
``tests/torch_model_axis_serve_cases.py`` import no JAX), one a mesh shape,
all started at once, reduced archs, fp32, two decode steps a case:

- Mixtral-8x7B with a window of 8 over 16 rows (a ring by KV head), (1, 2):
  the ring prefill (12 tokens) and the ``s <= length`` prefill (6, then a
  decode that wraps the ring), 2 of 4 experts a rank; (1, 4) with 6
  experts (they do not divide: ``d_ff`` split);
- Qwen1.5-32B (MHA, q/k/v bias), (2, 2): the lanes over data, the cache
  by KV head, and a 32768-row cache by position, filled by a prefill (the
  second model rank holds no filled row); Mixtral at a quarter of its
  capacity factor, (2, 2): the lanes over data share the experts' capacity
  (the global dispatch routes every lane's tokens, and drops some);
- Qwen2-72B with 2 KV heads for 4 q heads: (1, 2) by KV head, and a
  32768-row cache (the flash decode form) loaded with 20000 rows over both
  ranks; (1, 4), where the KV heads do not divide (the cache whole), and a
  65536-row cache (the blocked form, 16 of its 64 blocks a rank) loaded
  with 40000 rows (the fourth rank holds none);
- Jamba-1.5-Large cut to a (mamba, attn) period (Mamba's SSM state by
  head, its conv state by channel; the attention layer with experts), (1,
  2): a prefill into 16 rows, and a 32768-row cache loaded over both ranks
  with random SSM and conv states;
- Yi-6B (``dp_only``, batch 1), (1, 2): the weights whole, a 32768-row
  cache by position, prefilled and loaded;
- Whisper-large-v3 (``dp_only``, cross-attention), (2, 1): the lanes over
  the data axis, a model axis of one.

Every rank returns the same logits (the vocabulary and the lanes
gathered); held at 1e-5 of the largest |logit| against the one-process
steps and against JAX fed the same tokens, every step (the loaded long
caches: against JAX at ``JAX_LONG_TOL``, and at 1e-5 against the
one-process steps in fp64 compute, the definition); the greedy tokens
equal the one-process steps'; the gathered state equal to the
one-process state (float leaves at 1e-5 of each leaf's largest entry,
positions and fill levels exactly) and, leaf for leaf where the trees
agree, to JAX's.  What a rank holds is checked against the placements,
and the placements of every registry arch at the production shapes
against the JAX rule with the port's three divergences.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import build_model as jbuild
from repro.launch import specs as jspecs
from repro.parallel import sharding as jsh
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS, build_model
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.fsdp import local_shape
from repro_torch.utils.tree import flatten_dict, unflatten_dict
from torch_dist import start_ranks
from torch_model_axis_serve_cases import (
    ServeCase,
    full_state,
    np_tree,
    prompt_batch,
    serve_fleet,
    serve_run,
    weights_key,
)
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 1e-5
# The JAX package's serving attention sums its softmax in fp32 whatever
# the compute dtype; over the loaded caches' 16390-40000 live rows of
# near-uniform scores its one-device logits read 5e-7 to 1.2e-4 from the
# fp64 definition (the port's one-process fp32 steps 3e-7 to 1.1e-6;
# measured here).  The loaded cases are held to the fp64 run at TOL and to
# JAX at this limit, which a merge that lost one rank's rows misses
# (``test_the_long_cache_limit_has_a_control``).
JAX_LONG_TOL = 5e-4
RING = (("window", 8),)
QWEN2 = (("n_kv", 2),)
# a quarter of the usual capacity: the prefill's global dispatch drops
# entries, so a rank that routed its own lanes alone would fill other slots
BINDING = (("capacity_factor", 0.25),)
JAMBA = (("block_pattern", ("mamba", "attn")), ("n_layers", 2))  # one Mamba, one attention
# fleets by mesh shape, each rank running its cases in turn
FLEETS = {
    (1, 2): [ServeCase("mixtral-8x7b", RING, prompt=12),
             ServeCase("mixtral-8x7b", RING, prompt=6, steps=3),  # the decode wraps the ring
             ServeCase("qwen2-72b", QWEN2, prompt=6),
             ServeCase("qwen2-72b", QWEN2, batch=1, max_len=32768, prompt=0, fill=20000),
             ServeCase("jamba-1.5-large-398b", JAMBA, prompt=6),
             ServeCase("jamba-1.5-large-398b", JAMBA, batch=1, max_len=32768, prompt=0,
                       fill=17000),
             ServeCase("yi-6b", batch=1, max_len=32768, prompt=8),
             ServeCase("yi-6b", batch=1, max_len=32768, prompt=0, fill=16390)],
    (1, 4): [ServeCase("mixtral-8x7b", RING + (("moe_experts", 6),), prompt=12),
             ServeCase("qwen2-72b", QWEN2, prompt=6),
             ServeCase("qwen2-72b", QWEN2, batch=1, max_len=65536, prompt=0, fill=40000)],
    (2, 2): [ServeCase("qwen1.5-32b", prompt=6),
             ServeCase("qwen1.5-32b", max_len=32768, prompt=8),
             ServeCase("mixtral-8x7b", RING + BINDING, prompt=12)],
    (2, 1): [ServeCase("whisper-large-v3", prompt=5)],
}
CASES = [(shape, i) for shape, cases in FLEETS.items() for i in range(len(cases))]


def _jcfg(case: ServeCase):
    return dataclasses.replace(JARCHS[case.arch].reduced(), **dict(case.over))


@functools.lru_cache(maxsize=None)
def _weights(wkey: str) -> dict:
    """The JAX init's weights (seed 0) of a configuration, as numpy."""
    case = next(c for cases in FLEETS.values() for c in cases if weights_key(c) == wkey)
    return np_tree(jax.tree_util.tree_map(np.asarray,
                                          jbuild(_jcfg(case)).init(jax.random.PRNGKey(0))))


@functools.lru_cache(maxsize=None)
def _fleets() -> dict:
    """Every fleet's results, rank by rank: all fleets run at once, each rank
    on one share of the worker's threads, while the one-process and JAX
    references run here."""
    share = max(1, torch.get_num_threads() // sum(a * b for a, b in FLEETS))
    started = {}
    with tempfile.TemporaryDirectory(prefix="serve_fleets_") as tmp:
        for shape, cases in FLEETS.items():
            path = os.path.join(tmp, f"{shape[0]}x{shape[1]}.pkl")
            with open(path, "wb") as f:
                pickle.dump({weights_key(c): _weights(weights_key(c)) for c in cases}, f)
            started[shape] = start_ranks(serve_fleet, shape[0] * shape[1], shape, cases, path,
                                         threads=share, timeout=600.0)
        for shape, i in CASES:
            case = FLEETS[shape][i]
            _jax_run(case)
            if not case.prompt:
                _one_process(case, "float64")
        return {shape: fleet.result() for shape, fleet in started.items()}


@functools.lru_cache(maxsize=None)
def _one_process(case: ServeCase, dtype: str = "float32") -> dict:
    weights = _weights(weights_key(case))
    if dtype == "float64":
        case = dataclasses.replace(case, over=case.over + (("dtype", dtype),
                                                           ("param_dtype", dtype)))
        weights = {k: v.astype(np.float64) if v.dtype.kind == "f" else v
                   for k, v in weights.items()}
    return serve_run(case, weights)


def _to_jax_state(state: dict) -> dict:
    """A one-lane port state as the JAX package holds it: one ``pos`` row
    and one ``idx`` a layer, a scalar ``pos``."""
    out = {}
    for path, x in flatten_dict(state).items():
        x = x.numpy()
        if path == "pos":
            out[path] = jnp.asarray(x[0], jnp.int32)
        elif path.endswith("/pos") or path.endswith("/idx"):
            out[path] = jnp.asarray(x[:, 0], jnp.int32)
        else:
            out[path] = jnp.asarray(x)
    return unflatten_dict(out)


@functools.lru_cache(maxsize=None)
def _jax_run(case: ServeCase) -> dict:
    """The JAX one-device prefill and decode steps, fed the one-process
    steps' tokens (the fleets' are held equal to them)."""
    given = _one_process(case)["given"]
    jmodel = jbuild(_jcfg(case))
    jparams = unflatten_dict(_weights(weights_key(case)))
    logits = []
    if case.prompt:
        jstate = jmodel.init_state(case.batch, case.max_len)
        batch = {k: jnp.asarray(v.numpy()) for k, v in prompt_batch(case, case.cfg()).items()}
        last, jstate = jmodel.prefill(jparams, batch, jstate)
        logits.append(np.asarray(last))
    else:
        tmodel = build_model(case.cfg(), device="cpu")
        jstate = _to_jax_state(full_state(tmodel, case))
    for tokens in given:
        step, jstate = jmodel.decode_step(jparams, jnp.asarray(tokens, jnp.int32), jstate)
        logits.append(np.asarray(step))
    return {"logits": logits, "state": {"/".join(str(getattr(k, "key", k)) for k in p):
                                        np.asarray(v) for p, v in
                                        jax.tree_util.tree_leaves_with_path(jstate)}}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape,i", CASES, ids=[f"{s}-{FLEETS[s][i].key}" for s, i in CASES])
def test_fleet_matches_one_process_and_jax(shape, i):
    case = FLEETS[shape][i]
    ranks = [res[case.key] for res in _fleets()[shape]]
    one, ref = _one_process(case), _jax_run(case)
    got = ranks[0]
    for res in ranks[1:]:  # every rank holds every lane's logits and tokens
        assert all(np.array_equal(a, b) for a, b in zip(res["logits"], got["logits"]))
        assert all(np.array_equal(a, b) for a, b in zip(res["tokens"], got["tokens"]))
    assert len(got["logits"]) == len(one["logits"]) == len(ref["logits"])
    jax_tol = TOL if case.prompt else JAX_LONG_TOL
    for step, (a, b, j) in enumerate(zip(got["logits"], one["logits"], ref["logits"])):
        assert _rel(a, b) <= TOL, (step, _rel(a, b))
        assert _rel(a, j) <= jax_tol, (step, _rel(a, j))
    if not case.prompt:
        for step, (a, d) in enumerate(zip(got["logits"],
                                          _one_process(case, "float64")["logits"])):
            assert _rel(a, d) <= TOL, (step, _rel(a, d))
    for a, b in zip(got["tokens"], one["tokens"]):
        assert np.array_equal(a, b)
    for a, b in zip(got["given"], one["given"]):
        assert np.array_equal(a, b)
    for res in ranks:  # the gathered state: one process's
        for path, want in one["state"].items():
            have = res["state"][path]
            assert have.shape == want.shape, path
            if want.dtype.kind == "f":
                assert np.abs(have - want).max() <= TOL * max(np.abs(want).max(), 1e-30), path
            else:
                assert np.array_equal(have, want), path
    for path, want in ref["state"].items():  # and JAX's, where the trees agree
        have = got["state"].get(path)
        if have is not None and have.shape == want.shape and want.dtype.kind == "f":
            assert np.abs(have - want).max() <= jax_tol * max(np.abs(want).max(), 1e-30), path


def test_the_binding_capacity_drops_entries():
    """The (2, 2) Mixtral case's prefill routes more entries than its
    experts have slots (B x T x top_k over E x capacity, the capacity of
    every lane's tokens), so which entries an expert keeps turns on every
    lane's tokens: the fleet meets one process and JAX only if its ranks
    route their lanes together."""
    case = next(c for c in FLEETS[(2, 2)] if BINDING[0] in c.over)
    cfg = case.cfg()
    moe = build_model(cfg, device="cpu").layers.block.moe
    tokens = case.batch * case.prompt
    assert tokens * cfg.moe_top_k > cfg.moe_experts * moe.capacity(tokens)
    # a rank that routed its own lane alone would give every expert
    # another capacity
    assert moe.capacity(tokens // 2) != moe.capacity(tokens)


def test_the_long_cache_limit_has_a_control():
    """The one-process steps on Qwen2-72B's loaded 32768-row cache with the
    second rank's rows emptied (what a merge that lost that rank's partial
    would attend over) miss the JAX steps by far more than JAX_LONG_TOL."""
    case = FLEETS[(1, 2)][3]
    control = serve_run(dataclasses.replace(case, empty_from=16384),
                        _weights(weights_key(case)))
    ref = _jax_run(case)
    assert min(_rel(a, j) for a, j in zip(control["logits"], ref["logits"])) > 10 * JAX_LONG_TOL


def _attention_layers(cfg) -> int:
    pattern = cfg.block_pattern or ("attn",)
    return cfg.n_layers // len(pattern) * sum(p == "attn" for p in pattern)


@pytest.mark.parametrize("shape", list(FLEETS), ids=[str(s) for s in FLEETS])
def test_each_rank_holds_its_placement(shape):
    """A rank's serve state at its local shapes: KV caches by KV head or
    by position as the cache's length says, SSM states by head, conv states
    by channel, ``pos`` following the rows, ``idx`` whole; every rank's
    prefill through the attention (one call a layer); the collectives'
    bytes."""
    d, m = shape
    for case in FLEETS[shape]:
        cfg = case.cfg()
        for rank, res in enumerate(_fleets()[shape]):
            got = res[case.key]
            shapes, places = got["local_shapes"], got["placements"]
            lanes = case.batch // d if case.batch % d == 0 and d > 1 else case.batch
            if cfg.parallelism == "dp_only" and case.batch % (d * m) == 0:
                lanes = case.batch // (d * m)
            for path, local in shapes.items():
                full = got["state"][path].shape
                name = path.rsplit("/", 1)[-1]
                want = list(full)
                if path == "pos":
                    want[0] = lanes
                elif name == "idx":
                    want[1] = lanes
                elif name in ("k", "v", "pos") and "xkv" not in path:
                    want[1] = lanes
                    rows = full[2]
                    long = rows >= 32768 and m > 1
                    if long:
                        want[2] = rows // m
                    elif (name != "pos" and cfg.parallelism != "dp_only"
                          and cfg.n_kv % m == 0):
                        want[3] = cfg.n_kv // m
                elif name in ("ssm", "conv"):
                    want[1] = lanes
                    if m > 1:
                        want[2 if name == "ssm" else 3] //= m
                elif "xkv" in path:
                    want[1] = lanes
                assert tuple(local) == tuple(want), (case.key, rank, path, places[path])
            if case.prompt and cfg.family != "audio":
                assert got["prefill_attention"] == _attention_layers(cfg), case.key
            if m > 1:
                assert got["decode_bytes"]["all_reduce"] > 0, case.key


PRODUCTION = {"prefill_32k": (32768, 32), "decode_32k": (32768, 128), "long_500k": (524288, 1)}


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


@pytest.mark.parametrize("shape_name", list(PRODUCTION))
def test_rank_placements_follow_jax_at_production_shapes(shape_name):
    """Every registry arch's serve state on the (16, 16) production mesh:
    the port's placements are the JAX rule's, but ``pos`` (one row a lane)
    follows its ``k``'s rows, a Mamba conv state its SSM state's heads by
    channel, under ``dp_only`` what the rule splits by head stays whole
    (the weights are whole there), as do cross-attention caches, and a
    cache's lanes split where the rule split a layer stack as long as the
    batch; a rank's local shape is the full shape over the placed axes."""
    seq, batch = PRODUCTION[shape_name]
    amesh, mesh = AbstractMesh((16, 16), ("data", "model")), make_production_mesh()
    seen = 0
    for name in sorted(ARCHS):
        cfg, jcfg = ARCHS[name], JARCHS[name]
        jshape = JShape(shape_name, seq, batch, "decode")
        if not jcfg.supports(jshape):
            continue
        jstate = jspecs.serve_state_specs(jbuild(jcfg), jcfg, jshape, batch)
        want = {"/".join(str(getattr(k, "key", k)) for k in p): tuple(s.spec)
                for p, s in jax.tree_util.tree_leaves_with_path(
                    jsh.serve_state_shardings(amesh, jcfg, jstate, batch),
                    is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))}
        tstate = specs.serve_state_specs(build_model(cfg, device="meta"), cfg,
                                         ShapeConfig(shape_name, seq, batch, "decode"), batch)
        got = flatten_dict(sh.local_serve_shardings(mesh, cfg, tstate, batch))
        dp_only = cfg.parallelism == "dp_only"
        for path, leaf in flatten_dict(tstate).items():
            leaf_name = path.rsplit("/", 1)[-1]
            parent = path[: -len(leaf_name) - 1]
            if path == "pos":  # (B,): the lanes, by the JAX rule on that leaf
                exp = tuple(jsh.serve_state_shardings(
                    amesh, jcfg, {"pos": jax.ShapeDtypeStruct((batch,), jnp.int32)},
                    batch)["pos"].spec)
            elif leaf_name in ("pos", "idx"):  # (L, B, S) and (L, B): the k's entries
                exp = want[f"{parent}/k"][:leaf.ndim]
            else:
                exp = list(want[path])
                if parent.endswith("/xkv") or (dp_only and leaf_name in ("k", "v")):
                    exp[-2] = None
                if dp_only and leaf_name == "ssm":
                    exp[-3] = None
                if leaf_name == "conv" and f"{parent}/ssm" in want and not dp_only:
                    exp[-1] = want[f"{parent}/ssm"][-3]
                exp = tuple(exp)
            if (path.startswith("cache/") and tuple(leaf.shape[:2]) == (batch, batch)
                    and exp[0] is not None and exp[1] is None):
                exp = (None, exp[0]) + tuple(exp[2:])  # the lanes, off the layer stack
            assert got[path] == tuple(exp), (name, path, got[path], exp)
            local = local_shape(tuple(leaf.shape), got[path], mesh)
            for dim, entry in enumerate(got[path]):
                n = int(np.prod([mesh.shape[a] for a in _names(entry) if a is not None]))
                assert local[dim] * n == leaf.shape[dim], (name, path)
            seen += 1
    assert seen > 0


def test_cross_attention_runs_with_a_model_axis_of_one():
    """Whisper's decoder (``dp_only``): on (2, 1) its lanes split over the
    data axis and its cross-attention cache stays whole: every rank holds
    one lane's cache of all 12 encoder rows and all heads."""
    case = FLEETS[(2, 1)][0]
    for res in _fleets()[(2, 1)]:
        shapes = res[case.key]["local_shapes"]
        xkv = {p: s for p, s in shapes.items() if "/xkv/" in p}
        cfg = case.cfg()
        assert xkv and all(s[1:] == (1, cfg.encoder_seq, cfg.n_kv, cfg.resolved_head_dim)
                           for s in xkv.values()), xkv
