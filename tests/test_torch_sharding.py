"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
JAX package's ``PartitionSpec``s, computed in process on
``jax.sharding.AbstractMesh``es (no devices needed on either side).

Every registry arch, reduced and at full width (the port's shapes from the
``meta`` device, JAX's from ``eval_shape``), on the meshes ``(1, 1)``,
``(8, 1)``, ``(2, 4)``, ``(16, 16)`` and ``(2, 16, 16)``, with the
registry's ``dp_only`` archs and a ``dp_only`` variant of every other one;
also the batch, train-state and serve-state placements and
``per_host_batch`` with fake host counts (the JAX ``test_per_host_batch_*``
cases).  Placements are compared exactly: they are rules, not numbers.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import build_model as jbuild
from repro.launch import mesh as jmesh_mod
from repro.launch import specs as jspecs
from repro.parallel import sharding as jsh
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS, build_model
from repro_torch.launch import specs
from repro_torch.launch.mesh import (
    Mesh,
    make_host_mesh,
    make_production_mesh,
    mesh_device_kinds,
    mesh_host_count,
)
from repro_torch.optim import adam
from repro_torch.parallel import sharding as sh
from repro_torch.utils.tree import flatten_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

MESHES = [
    ((1, 1), ("data", "model")),
    ((8, 1), ("data", "model")),
    ((2, 4), ("data", "model")),
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
]


def _pair(shape, names, hosts: int = 1):
    return AbstractMesh(shape, names), Mesh(names, shape, hosts=hosts)


def _jax_flat(tree) -> dict:
    """{path: PartitionSpec entries} of a NamedSharding tree."""
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
            for path, s in leaves}


def _cfgs(name: str, reduced: bool):
    cfg = ARCHS[name].reduced() if reduced else ARCHS[name]
    jcfg = JARCHS[name].reduced() if reduced else JARCHS[name]
    out = [(cfg, jcfg)]
    if cfg.parallelism != "dp_only":
        out.append((dataclasses.replace(cfg, parallelism="dp_only"),
                    dataclasses.replace(jcfg, parallelism="dp_only")))
    return out


@pytest.fixture
def jax_shapes_once(monkeypatch):
    """JAX's ``param_shardings`` traces ``model.init`` for every mesh; the
    shapes depend on the model only, so each model is traced once here."""
    real, cache = jax.eval_shape, {}

    def once(fn, *args, **kw):
        if args or kw or not fn.__closure__:
            return real(fn, *args, **kw)
        key = tuple(id(c.cell_contents) for c in fn.__closure__)
        if key not in cache:
            cache[key] = real(fn)
        return cache[key]

    monkeypatch.setattr(jsh.jax, "eval_shape", once)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_placements_equal_jax_partition_specs(name, reduced, jax_shapes_once):
    """Exact: one placement per leaf, every mesh, tp and dp_only (the
    port's shapes from one ``meta`` init; the rules take ``params``)."""
    params = None
    for cfg, jcfg in _cfgs(name, reduced):
        model, jmodel = build_model(cfg, device="meta"), jbuild(jcfg)
        params = params or model.init(torch.Generator())  # dp_only keeps the shapes
        for shape, names in MESHES:
            amesh, mesh = _pair(shape, names)
            got = flatten_dict(sh.param_shardings(model, mesh, cfg, params=params))
            want = _jax_flat(jsh.param_shardings(jmodel, amesh, jcfg))
            assert got == want, (cfg.parallelism, shape)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_state_and_batch_placements_equal_jax(name):
    """Train state (params, Adam moments, the rest replicated) and the
    train batch of a 16-sample global batch, on every mesh."""
    cfg, jcfg = ARCHS[name].reduced(), JARCHS[name].reduced()
    model, jmodel = build_model(cfg, device="meta"), jbuild(jcfg)
    params = model.init(torch.Generator())
    state = {"params": params, "opt": adam().init(params), "step": 0}
    jparams = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    jstate = {"params": jparams,
              "opt": {"m": jparams, "v": jparams},
              "step": jax.ShapeDtypeStruct((), jnp.int32)}
    shape = ShapeConfig("t", 16, 16, "train")
    jshape = JShape("t", 16, 16, "train")
    for mshape, names in MESHES:
        amesh, mesh = _pair(mshape, names)
        got = sh.state_shardings(model, mesh, cfg, state)
        want = jsh.state_shardings(jmodel, amesh, jcfg, jstate)
        assert flatten_dict(got["params"]) == _jax_flat(want["params"])
        for k in ("m", "v"):
            assert flatten_dict(got["opt"][k]) == _jax_flat(want["opt"][k])
        assert got["step"] == tuple(want["step"].spec) == ()
        for b in (16, 6, 1):
            got_b = flatten_dict(sh.batch_shardings(specs.train_batch_specs(cfg, shape, b),
                                                    mesh, cfg))
            want_b = _jax_flat(jsh.batch_shardings(jspecs.train_batch_specs(jcfg, jshape, b),
                                                   amesh, jcfg))
            assert got_b == want_b, (mshape, b)


@pytest.mark.parametrize("name", ["yi-6b", "jamba-1.5-large-398b", "whisper-large-v3"])
def test_serve_state_placements_equal_jax(name):
    """KV caches and SSM states at a long and a short cache length.  The
    rule reads paths and shapes; the port's serve state keeps per-lane
    positions where the JAX package's has one, so both rules take the JAX
    state's paths and shapes (as meta tensors), and the port's own state
    goes through the port's rule."""
    cfg, jcfg = ARCHS[name].reduced(), JARCHS[name].reduced()
    model, jmodel = build_model(cfg, device="meta"), jbuild(jcfg)
    for seq in (64, 32768):
        shape, jshape = ShapeConfig("s", seq, 8, "decode"), JShape("s", seq, 8, "decode")
        jstate = jspecs.serve_state_specs(jmodel, jcfg, jshape, 8)
        same = {k: torch.empty(v.shape, device="meta")
                for k, v in _jax_flat_leaves(jstate).items()}
        own = specs.serve_state_specs(model, cfg, shape, 8)
        for mshape, names in MESHES:
            amesh, mesh = _pair(mshape, names)
            got = flatten_dict(sh.serve_state_shardings(mesh, cfg, same, 8))
            want = _jax_flat(jsh.serve_state_shardings(amesh, jcfg, jstate, 8))
            assert got == want, (seq, mshape)
            placed = flatten_dict(sh.serve_state_shardings(mesh, cfg, own, 8))
            for k, leaf in flatten_dict(own).items():
                assert len(placed[k]) in (0, leaf.ndim), k


def _jax_flat_leaves(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_logical_rules_and_axes_equal_jax():
    for name in sorted(ARCHS):
        for cfg, jcfg in _cfgs(name, True):
            for mshape, names in MESHES:
                amesh, mesh = _pair(mshape, names)
                assert sh.mesh_axes(mesh, cfg) == jsh.mesh_axes(amesh, jcfg)
                assert sh.logical_rules(mesh, cfg) == jsh.logical_rules(amesh, jcfg)
    model = build_model(ARCHS["mixtral-8x7b"].reduced(), device="meta")
    jmodel = jbuild(JARCHS["mixtral-8x7b"].reduced())
    assert flatten_dict(model.axes(), sep="/") == _axes_flat(jmodel.axes())


def _axes_flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update({key: v} if sh.is_axes_leaf(v) else _axes_flat(v, key))
    return out


def test_meshes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert tuple(make_production_mesh(multi_pod=True).axis_names) == tuple(
        AbstractMesh((2, 16, 16), ("pod", "data", "model")).axis_names)
    host = make_host_mesh("cpu")  # no process group: (1, 1)
    assert host.shape == {"data": 1, "model": 1} and not host.live
    assert mesh_host_count(host) == 1 and mesh_device_kinds(host) == ("cpu:cpu",)
    mixed = Mesh(("data", "model"), (4, 1), hosts=4,
                 device_kinds=("gpu:b", "cpu:cpu", "gpu:b", "gpu:a"))
    assert mesh_device_kinds(mixed) == ("cpu:cpu", "gpu:a", "gpu:b")


def test_per_host_batch_single_host_identity():
    assert sh.per_host_batch(256, make_host_mesh("cpu")) == 256


@pytest.mark.parametrize("n_data", [1, 3, 8])
def test_per_host_batch_splits_across_fake_hosts(monkeypatch, n_data):
    """The JAX case with 4 fake hosts: a divisible data axis splits the
    batch min(hosts, shards) ways, a replicated batch stays whole, and a
    model axis spanning hosts leaves each host the larger slice."""
    amesh, mesh = _pair((n_data, 1), ("data", "model"), hosts=4)
    monkeypatch.setattr(jmesh_mod, "mesh_host_count", lambda m: 4)
    for batch in (256, 255, 8):
        assert sh.per_host_batch(batch, mesh) == jsh.per_host_batch(batch, amesh)
    if 256 % n_data == 0 and n_data > 1:
        assert sh.per_host_batch(256, mesh) == -(-256 // min(4, n_data))
    else:
        assert sh.per_host_batch(256, mesh) == 256
    monkeypatch.setattr(sh, "axis_size", lambda m, axes: 2)
    monkeypatch.setattr(jsh, "axis_size", lambda m, axes: 2)
    assert sh.per_host_batch(256, mesh) == jsh.per_host_batch(256, amesh) == 128


@pytest.mark.parametrize("name", ["yi-6b", "phi-3-vision-4.2b", "whisper-large-v3"])
def test_batch_specs_equal_jax(name):
    """Train, prefill and decode specs: the JAX package's shapes; dtypes
    by name (the port's tokens are int32 as the JAX package's)."""
    cfg, jcfg = ARCHS[name].reduced(), JARCHS[name].reduced()
    shape, jshape = ShapeConfig("t", 96, 8, "train"), JShape("t", 96, 8, "train")
    pairs = [(specs.train_batch_specs(cfg, shape, 4), jspecs.train_batch_specs(jcfg, jshape, 4)),
             (specs.prefill_batch_specs(cfg, shape, 4),
              jspecs.prefill_batch_specs(jcfg, jshape, 4)),
             ({"t": specs.decode_token_specs(4)}, {"t": jspecs.decode_token_specs(4)})]
    for got, want in pairs:
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), k
            assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
    assert specs.per_device_batch(shape, 4) == jspecs.per_device_batch(jshape, 4) == 2


def test_materialize_shapes_and_dtypes():
    cfg = ARCHS["whisper-large-v3"].reduced()
    sp = specs.train_batch_specs(cfg, ShapeConfig("t", 16, 4, "train"), 4)
    batch = specs.materialize(sp, torch.Generator().manual_seed(0), vocab=cfg.vocab)
    again = specs.materialize(sp, torch.Generator().manual_seed(0), vocab=cfg.vocab)
    for k, v in flatten_dict(batch).items():
        assert v.shape == sp[k].shape and v.dtype == sp[k].dtype and v.device.type == "cpu"
        assert torch.equal(v, again[k])
    assert int(batch["tokens"].max()) < cfg.vocab and torch.all(batch["mask"] == 1)


def test_reshard_rules_are_seen_from_other_threads():
    """Autograd runs a CUDA backward (and a checkpointed layer's
    recomputation, whose weights are gathered again) on a device thread of
    its own: the rules must hold there too, not only on the step's thread."""
    import threading

    from repro_torch.parallel import reshard

    mesh = Mesh(("data", "model"), (2, 1))
    seen = []
    with reshard.use_reshard_rules(mesh):
        t = threading.Thread(target=lambda: seen.append(reshard.active_mesh()))
        t.start()
        t.join()
    assert seen == [mesh] and reshard.active_mesh() is None
