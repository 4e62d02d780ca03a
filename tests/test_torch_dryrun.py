"""The dry run (``launch.dryrun``, ``launch.analysis``,
``launch.steps.abstract_train_state``) against the JAX package and against
live fleets, on the CPU.

- the abstract train state of every registry arch at full width against the
  JAX ``abstract_train_state`` (``jax.eval_shape``): paths, shapes, dtypes;
- each rank's argument bytes of every supported (arch x shape) cell on both
  production meshes against ``NamedSharding(AbstractMesh, spec)
  .shard_shape`` over the JAX ``state_shardings``, ``batch_shardings``,
  ``param_shardings`` and ``serve_state_shardings``: exact, and the port's
  serve-state divergences compared as such;
- the ring model (``CollectiveStats.from_records``) against the JAX
  ``parse_collectives`` on HLO lines of the same kinds, shapes and groups;
- rank 0's step over fake tensors and a fake process group against the same
  step run by rank 0 of a live gloo fleet (``tests/torch_dist.py``,
  ``tests/torch_dryrun_cases.py``): the collective record entry for entry,
  the tracked peak, the launches;
- the kernels' abstract evaluation (a fake tensor to each ``*_fake``);
- the CLI and the analytic FLOPs of a cell's JSON.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import SHAPES as JSHAPES
from repro.configs.registry import build_model as jbuild
from repro.core.clipping import discover_meta as jdiscover
from repro.core.taps import ClipRuntime
from repro.launch import analysis as janalysis
from repro.launch import analytic as janalytic
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.optim import adam as jadam
from repro.parallel import sharding as jsh
from repro_torch.configs.base import SHAPES, ShapeConfig, torch_dtype
from repro_torch.configs.registry import ARCHS, build_model
from repro_torch.core.taps import ConvInfo
from repro_torch.kernels import checks, dispatch, launches
from repro_torch.kernels.ghost_norm import ghost_norm as gk
from repro_torch.kernels.psg_contract import psg_contract as pk
from repro_torch.launch import analysis, dryrun, steps
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.specs import serve_state_specs, train_batch_specs
from repro_torch.optim import adam
from repro_torch.utils.tree import flatten_dict
from torch_dist import start_ranks
from torch_dryrun_cases import Step, case, live_step, policy, schedule
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PRODUCTION = {False: AbstractMesh((16, 16), ("data", "model")),
              True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
STEPS = [Step("mixtral-8x7b", (2, 2), "mixed_ghost"), Step("mixtral-8x7b", (1, 2), "bk_mixed"),
         Step("yi-6b", (1, 2), "mixed_ghost"), Step("vgg11", (1, 2), "mixed_ghost")]
CLI = ["-m", "repro_torch.launch.dryrun", "--arch", "yi-6b", "--shape", "train_4k",
       "--mesh", "single"]


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """The module's slow parts, started with its first test and run beside
    the others: the CLI on a full-width cell (a subprocess) and every
    case's live gloo fleet (each rank on one thread)."""
    out = tmp_path_factory.mktemp("dryrun_cli")
    proc = subprocess.Popen([sys.executable, *CLI, "--out", str(out)], cwd=out,
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    fleets = {s.key: start_ranks(live_step, s.shape[0] * s.shape[1], s, timeout=600.0,
                                 threads=1) for s in STEPS}
    yield {"cli": (proc, out), "fleets": fleets}
    if proc.poll() is None:
        proc.kill()
    proc.communicate()
    for fleet in fleets.values():  # ranks no test waited for
        for rank in fleet.procs:
            if rank.is_alive():
                rank.kill()
            rank.join()


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _jflat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _jflat_shardings(tree) -> dict:
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {"/".join(str(getattr(k, "key", k)) for k in path): s for path, s in leaves}


def _jbytes(leaves: dict, shardings: dict) -> dict:
    """{path: bytes} of each leaf's shard (``NamedSharding.shard_shape``)."""
    return {path: math.prod(shardings[path].shard_shape(leaf.shape)) * leaf.dtype.itemsize
            for path, leaf in leaves.items()}


# -- the abstract train state --------------------------------------------------
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_abstract_train_state_equals_jax(name):
    """Every params and Adam-moment leaf of the full-width state: the same
    path, shape (through the conv layout map) and dtype as the JAX
    ``abstract_train_state``'s; nothing allocated (``meta``); the policy
    state's leaves as JAX's; the step counter 0 and the generator where JAX
    has its key."""
    cfg, jcfg = ARCHS[name], JARCHS[name]
    model = build_model(cfg, device="meta")
    state = steps.abstract_train_state(model, adam(state_dtype=torch_dtype(cfg.opt_state_dtype)))
    jstate = jsteps.abstract_train_state(
        jbuild(jcfg), jadam(state_dtype=jnp.dtype(jcfg.opt_state_dtype)))
    convs = set(model.conv_weights)

    def jax_layout(path, x):
        shape = tuple(x.shape)
        return (shape[2], shape[3], shape[1], shape[0]) if path in convs else shape

    for key in ("params", "opt", "policy"):
        got = {p: (jax_layout(p.split("/", 1)[-1] if key == "opt" else p, x), _dtype(x))
               for p, x in flatten_dict(state[key]).items()}
        want = {p: (tuple(x.shape), str(x.dtype)) for p, x in _jflat(jstate[key]).items()}
        assert got == want, key
        assert all(x.device.type == "meta" for x in flatten_dict(state[key]).values())
    assert set(state) == set(jstate)
    assert state["step"] == 0 and isinstance(state["rng"], torch.Generator)
    assert jstate["rng"].shape == (2,)


# -- argument bytes per rank -----------------------------------------------------
@pytest.fixture
def jax_init_once(monkeypatch):
    """The JAX rules trace ``model.init`` for every mesh; it depends on the
    model only, so each model is traced once here."""
    real, cache = jax.eval_shape, {}

    def once(fn, *args, **kw):
        if args or kw or not fn.__closure__:
            return real(fn, *args, **kw)
        key = tuple(id(c.cell_contents) for c in fn.__closure__)
        if key not in cache:
            cache[key] = real(fn)
        return cache[key]

    monkeypatch.setattr(jsh.jax, "eval_shape", once)


def _serve_divergence(path: str, got: tuple, want: tuple, dp_only: bool) -> bool:
    """Whether a serve-state leaf's port placement ``got`` differs from the
    JAX rule's ``want`` by one of ``local_serve_shardings``' divergences."""
    name = path.rsplit("/", 1)[-1]
    lanes = tuple(want[:2]) == (want[0], None) and tuple(got[:2]) == (None, want[0])
    if lanes:  # the lanes' entry off a layer stack as long as the batch
        want = (None, want[0]) + tuple(want[2:])
        if got == want:
            return True
    if "/xkv/" in path or (dp_only and name in ("k", "v")):
        return got[-2] is None and want[-2] == "model" and got[:-2] == want[:-2]
    if dp_only and name == "ssm":
        return got[-3] is None and want[-3] == "model"
    return name == "conv" and got[-1] == "model" and want[-1] is None and not dp_only


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_argument_bytes_equal_jax_shard_shapes(name, jax_init_once):
    """Each rank's bytes of every supported cell's arguments on the (16, 16)
    and (2, 16, 16) meshes, as the dry run counts them (``train_arguments``,
    ``serve_arguments``), against the JAX shard shapes: the parameters,
    moments, policy state and batch exactly, leaf by leaf; the serve state
    exactly where the placements agree, and by the placement's axis where
    the port diverges (per-lane positions, whose shapes differ, listed)."""
    cfg, jcfg = ARCHS[name], JARCHS[name]
    model, jmodel = build_model(cfg, device="meta"), jbuild(jcfg)
    abstract = steps.abstract_train_state(model, adam(state_dtype=torch_dtype(cfg.opt_state_dtype)))
    jstate = jsteps.abstract_train_state(jmodel, jadam(state_dtype=jnp.dtype(jcfg.opt_state_dtype)))
    seen = 0
    for multi, amesh in PRODUCTION.items():
        mesh = make_production_mesh(multi_pod=multi)
        for sname, shape in SHAPES.items():
            jshape = JSHAPES[sname]
            if not cfg.supports(shape):
                assert not jcfg.supports(jshape)
                continue
            b = shape.global_batch
            if shape.kind == "train":
                batch = train_batch_specs(cfg, shape, b)
                _, got = dryrun.train_arguments(model, cfg, mesh, abstract, batch)
                jsh_state = jsh.state_shardings(jmodel, amesh, jcfg, jstate)
                jbatch = jspecs.train_batch_specs(jcfg, jshape, b)
                for key in ("params", "opt", "policy"):
                    want = _jbytes(_jflat(jstate[key]), _jflat_shardings(jsh_state[key]))
                    assert got[key] == want, (sname, multi, key)
                want = _jbytes(_jflat(jbatch),
                               _jflat_shardings(jsh.batch_shardings(jbatch, amesh, jcfg)))
                assert got["batch"] == want, (sname, multi)
                assert set(_jflat(jstate)) - {f"{k}/{p}" for k in ("params", "opt", "policy")
                                              for p in _jflat(jstate[k])} == {"rng", "step"}
            else:
                placements, got = dryrun.serve_arguments(model, cfg, shape, mesh)
                jparams = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
                want = _jbytes(_jflat(jparams),
                               _jflat_shardings(jsh.param_shardings(jmodel, amesh, jcfg)))
                assert got["params"] == want, (sname, multi)
                jbatch = (jspecs.prefill_batch_specs(jcfg, jshape, b)
                          if shape.kind == "prefill" else {"t": jspecs.decode_token_specs(b)})
                want = _jbytes(_jflat(jbatch),
                               _jflat_shardings(jsh.batch_shardings(jbatch, amesh, jcfg)))
                assert got["batch"] == want, (sname, multi)
                jserve = jspecs.serve_state_specs(jmodel, jcfg, jshape, b)
                jplaced = _jflat_shardings(jsh.serve_state_shardings(amesh, jcfg, jserve, b))
                jleaves, want = _jflat(jserve), _jbytes(_jflat(jserve), jplaced)
                ours = flatten_dict(placements["state"])
                pstate = flatten_dict(serve_state_specs(model, cfg, shape, b))
                per_lane = {p for p in got["state"] if p not in jleaves
                            or tuple(jleaves[p].shape) != tuple(pstate[p].shape)}
                assert per_lane == {p for p in got["state"] if p.endswith(("pos", "idx"))}
                for path, n in got["state"].items():
                    if path in per_lane:
                        continue
                    g, w = ours[path], tuple(jplaced[path].spec) + (None,) * (
                        len(ours[path]) - len(jplaced[path].spec))
                    if g == w:
                        assert n == want[path], (sname, multi, path)
                        continue
                    assert _serve_divergence(path, g, w, cfg.parallelism == "dp_only"), \
                        (sname, multi, path, g, w)
                    if g.count("model") > w.count("model"):
                        assert n * mesh.shape["model"] == want[path], (sname, path)
                    elif g.count("model") < w.count("model"):
                        assert n == want[path] * mesh.shape["model"], (sname, path)
                    else:
                        assert n == want[path], (sname, path)
            seen += 1
    assert seen >= 4


# -- the ring model ----------------------------------------------------------------
def test_ring_model_equals_parse_collectives():
    """Counts, raw bytes and wire bytes of records against the JAX parser on
    HLO lines of the same kinds, output shapes and replica groups (list and
    iota forms); a reduce-scatter's record holds its input, as BYTES does."""
    records = [("all_reduce", 4 * 1024 * 7, 4), ("all_gather", 2 * 4096 * 64, 16),
               ("reduce_scatter", 4 * 512 * 64, 16), ("all_reduce", 4 * 33, 2),
               ("all_gather", 2 * 8 * 3, 32), ("all-to-all", 4 * 64 * 8, 8),
               ("collective-permute", 2 * 128, 2)]
    hlo = "\n".join([
        "  %ar.1 = f32[1024,7]{1,0} all-reduce(f32[1024,7]{1,0} %x), "
        "replica_groups={{0,1,2,3}}, to_apply=%add",
        "  %ag.2 = bf16[4096,64]{1,0} all-gather(bf16[256,64]{1,0} %y), "
        "replica_groups=[16,16]<=[256], dimensions={0}",
        "  %rs.3 = f32[32,64]{1,0} reduce-scatter(f32[512,64]{1,0} %z), "
        "replica_groups=[16,16]<=[256], dimensions={0}, to_apply=%add",
        "  %ar.4 = f32[33]{0} all-reduce-start(f32[33]{0} %w), replica_groups={{0,1}}, "
        "to_apply=%add",
        "  %ag.5 = bf16[8,3]{1,0} all-gather(bf16[1,3]{1,0} %u), "
        "replica_groups=[16,32]<=[512], dimensions={0}",
        "  %a2a.6 = f32[64,8]{1,0} all-to-all(f32[64,8]{1,0} %v), replica_groups=[64,8]<=[512]",
        "  %cp.7 = bf16[128]{0} collective-permute(bf16[128]{0} %t), "
        "source_target_pairs={{0,1},{1,0}}",
    ])
    got = analysis.CollectiveStats.from_records(records).to_dict()
    want = janalysis.parse_collectives(hlo).to_dict()
    assert got["counts"] == want["counts"]
    assert got["raw_bytes"] == want["raw_bytes"]
    assert got["wire_bytes"] == pytest.approx(want["wire_bytes"], rel=1e-15)
    # a one-rank group's collective (a copy) is counted and moves nothing,
    # where the JAX parser floors a group at two devices
    one = analysis.CollectiveStats.from_records([("all_reduce", 64, 1)])
    assert one.counts == {"all-reduce": 1} and one.raw_bytes == {"all-reduce": 64}
    assert one.wire_bytes == 0.0


# -- fake against live -------------------------------------------------------------
@pytest.mark.parametrize("step", STEPS, ids=[s.key for s in STEPS])
def test_fake_step_matches_live_fleet(step, background):
    """Rank 0's step over fake tensors on a fake process group (on the CPU:
    the plain versions) records every collective of the live rank 0's,
    entry for entry (kind, bytes, group size), tracks the same peak and
    counts the same launches."""
    c = case(step.model)
    res = dryrun.evaluate_train(c["build"], c["cfg"], Mesh(("data", "model"), step.shape),
                                c["batch"], c["optimizer"], mode=step.mode,
                                schedule=schedule(), policy=policy(), target="cpu")
    live = background["fleets"][step.key].result()[0]
    assert live["rank"] == 0
    assert res["records"] == live["records"]
    assert len(res["records"]) > 0
    assert res["peak_bytes"] == live["peak"]
    assert res["launches"] == live["launches"]
    assert not torch.distributed.is_initialized()


# -- the kernels' abstract evaluation -----------------------------------------------
def _fake_calls(n: int) -> dict:
    """Each dispatched op once on fake tensors resolving as on the card:
    {op: (output shape, dtype, launches, the tracker's peak of the call)}."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    e = torch.empty
    calls = {
        "ghost_norm_sq": (dispatch.ghost_norm_sq, lambda: (e(n, 200, 64), e(n, 200, 32))),
        "conv": (lambda x, g: dispatch.conv_ghost_norm_sq(
            x, g, ConvInfo(kernel=(3, 3), strides=(2, 2), padding="SAME")),
            lambda: (e(n, 16, 16, 8), e(n, 64, 16))),
        "embedding_ghost_norm_sq": (dispatch.embedding_ghost_norm_sq, lambda: (
            e(n, 12000, dtype=torch.int64), e(n, 12000, 64))),
        "book_weighted_grad": (dispatch.book_weighted_grad, lambda: (
            e(1, 4096, 256), e(1, 4096, 10), e(1, 4096))),
        "psg_contract": (dispatch.psg_contract_grouped, lambda: (
            [e(n, 7)] * 300 + [e(n, 0)], e(n))),
        # q a view at an odd offset
        "flash_attention": (dispatch.flash_attention, lambda: (
            e(2 * 39 * 4 * 64 + 1)[1:].view(2, 39, 4, 64), e(2, 39, 2, 64), e(2, 39, 2, 64))),
    }
    out = {}
    with FakeTensorMode(), dispatch.abstract_cuda():
        for op, (fn, make) in calls.items():
            args = make()
            launches.reset()
            tracker = analysis.MemoryTracker()
            with tracker:
                y = fn(*args)
            out[op] = (tuple(y.shape), y.dtype, {k: v for k, v in launches.snapshot().items()
                                                 if any(v.values())}, tracker.peak)
    return out


def test_fake_kernels_allocate_as_their_wrappers():
    """A fake tensor resolving to the card goes to each kernel's abstract
    evaluation: the output, the wrapper's workspace at the target card's
    constants, and a ``fake`` launch where the wrapper launches."""
    n = 3
    got = _fake_calls(n)
    f32 = 4
    # ghost norm: T = 200 in 64-wide tiles, 4 x 5 / 2 = 10 tile pairs a sample
    assert got["ghost_norm_sq"][:3] == ((n,), torch.float32,
                                        {"ghost_norm_sq": {"cuda": 0, "torch": 0, "fake": 1}})
    assert got["ghost_norm_sq"][3] == n * 10 * f32 + n * f32
    # conv entry: 16 x 16 SAME stride 2 -> T = 64: one 64-tile pair, no partials
    assert got["conv"] == ((n,), torch.float32,
                           {"ghost_norm_sq": {"cuda": 0, "torch": 0, "fake": 1}}, n * f32)
    # embedding: T = 12000 above the target's shared-memory sort: its keys'
    # workspace (5 words a position) is part of the allocation
    slices, blocks = gk.embedding_plan(
        n, 12000, 64, 4, checks.TARGET_SM_COUNT * checks.TARGET_EMBED_BLOCKS_PER_SM[
            torch.float32])
    words = 4 + 3 * 12000 + n * slices * blocks * (64 * 4 + 2) + 5 * n * 12000
    assert 12000 > checks.TARGET_EMBED_SORT_CAPACITY
    assert got["embedding_ghost_norm_sq"][3] == words * f32
    # the book at M = 1: R split for the target's 132 SMs, a second launch sums
    splits, _ = pk.book_splits(1, 4096, 256, 10, checks.TARGET_SM_COUNT)
    assert splits > 1
    assert got["book_weighted_grad"][2] == {
        "book_weighted_grad": {"cuda": 0, "torch": 0, "fake": 2}}
    assert got["book_weighted_grad"][3] == (splits + 1) * 256 * 10 * f32
    # 300 non-empty banks: two launches of at most MAX_SEGMENTS
    assert got["psg_contract"] == ((300 * 7,), torch.float32,
                                   {"psg_contract": {"cuda": 0, "torch": 0, "fake": 2}},
                                   300 * 7 * f32)
    # a query view at an odd offset is copied, as the wrapper copies it
    assert got["flash_attention"][:3] == ((2, 39, 4, 64), torch.float32,
                                          {"flash_attention": {"cuda": 0, "torch": 0,
                                                               "fake": 1}})
    assert got["flash_attention"][3] == 2 * 2 * 39 * 4 * 64 * f32


def test_real_tensors_never_take_the_abstract_branch():
    """Inside ``abstract_cuda()`` a real CPU tensor still runs the plain
    version; a fake tensor outside it resolves by its device; a dry run
    targets the card or the CPU, nothing else."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    a, g = torch.randn(2, 5, 3), torch.randn(2, 5, 4)
    launches.reset()
    with dispatch.abstract_cuda():
        got = dispatch.ghost_norm_sq(a, g)
    assert launches.snapshot()["ghost_norm_sq"] == {"cuda": 0, "torch": 1, "fake": 0}
    torch.testing.assert_close(got, gk.ghost_norm_sq_plain(a, g), rtol=0, atol=0)
    with FakeTensorMode():
        assert dispatch.default_impl("ghost_norm", torch.empty(2, 5, 3)) == "torch"
        with dispatch.abstract_cuda():
            assert dispatch.default_impl("ghost_norm", torch.empty(2, 5, 3)) == "cuda"
    with pytest.raises(ValueError, match="target"):
        dryrun.lower_cell("yi-6b", "decode_32k", mesh_shape=(1, 1), target="tpu")


# -- the CLI and the analytic FLOPs -------------------------------------------------
JAX_KEYS = {"status", "arch", "shape", "mesh", "n_devices", "kind", "clipping_mode",
            "analytic_flops", "hlo_raw", "roofline", "elapsed_s"}  # repro/launch/dryrun.py


def _jax_cell_flops(name: str, sname: str, mode: str) -> dict:
    """The JAX dry run's ``analytic_flops`` of a cell (``repro.launch.dryrun``
    itself sets up 512 host devices on import)."""
    jcfg, jshape = JARCHS[name], JSHAPES[sname]
    jmodel = jbuild(jcfg)
    if jshape.kind == "train":
        params = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
        batch = jspecs.train_batch_specs(jcfg, jshape, jshape.global_batch)
        meta = jdiscover(jmodel.loss_with_ctx, params, batch, clip=ClipRuntime(mode=mode))
        return janalytic.cell_flops(meta, jcfg, jshape, mode).to_dict()
    fwd = janalytic.serve_matmul_flops(jmodel, jcfg, jshape) + janalytic.extra_fwd_flops(
        jcfg, jshape)
    return {"fwd": fwd, "total": fwd, "norms": 0.0}


def test_cli_writes_the_jax_schema(background, tmp_path):
    """``python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    --mesh single`` exits 0 and writes the JAX module's JSON schema (plus
    ``calibrated`` and ``launches``), its analytic FLOPs the JAX dry run's;
    a long_500k cell of a full-attention arch reads skipped."""
    proc, out = background["cli"]
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    assert "DRY-RUN SUMMARY: 1 ok / 0 skipped / 0 errors of 1 cells" in stdout
    meta = json.loads((out / "single" / "yi-6b__train_4k.json").read_text())
    assert set(meta) == JAX_KEYS | {"calibrated", "launches"}
    assert meta["status"] == "ok" and meta["mesh"] == "16x16" and meta["n_devices"] == 256
    assert meta["calibrated"] is False
    fields = {f.name for f in dataclasses.fields(janalysis.RooflineTerms)}
    assert set(meta["roofline"]) == fields
    assert set(meta["roofline"]["memory_stats"]) == {
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes_estimate"}
    assert set(meta["hlo_raw"]) == {"bytes", "wire_bytes", "collectives"}
    assert set(meta["hlo_raw"]["collectives"]) == {
        f.name for f in dataclasses.fields(janalysis.CollectiveStats)}
    assert meta["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert meta["analytic_flops"] == _jax_cell_flops("yi-6b", "train_4k", "mixed_ghost")
    assert set(meta["launches"]) == set(launches.KERNELS)
    skipped = dryrun.run_cell("yi-6b", "long_500k", multi_pod=False, mode="mixed_ghost",
                              out_dir=tmp_path)
    assert skipped["status"] == "skipped"
    assert json.loads((tmp_path / "single" / "yi-6b__long_500k.json").read_text())[
        "status"] == "skipped"


@pytest.mark.parametrize("name,sname", [("jamba-1.5-large-398b", "decode_32k"),
                                        ("whisper-large-v3", "prefill_32k"),
                                        ("mixtral-8x7b", "train_4k")])
def test_analytic_flops_equal_jax(name, sname):
    """A cell's analytic FLOPs: ``cell_flops`` for a train cell,
    ``serve_matmul_flops + extra_fwd_flops`` for a serve one, as the JAX dry
    run counts them."""
    got = dryrun.analytic_flops(ARCHS[name], SHAPES[sname], "bk_mixed")
    assert got == _jax_cell_flops(name, sname, "bk_mixed")


def test_one_device_cells_run_the_one_process_step():
    """A (1, 1) mesh evaluates the one-process step: no process group, no
    collective, the whole state as the argument."""
    cfg = dataclasses.replace(ARCHS["mixtral-8x7b"].reduced(), n_layers=1)
    res, meta = dryrun.lower_cell(cfg, ShapeConfig("t", 8, 2, "train"), mesh_shape=(1, 1),
                                  mode="bk_mixed", target="cpu")
    assert res["records"] == [] and meta["hlo_raw"]["wire_bytes"] == 0.0
    assert meta["mesh"] == "1x1" and meta["n_devices"] == 1
    assert meta["roofline"]["memory_stats"]["argument_bytes"] == res["argument_bytes"] > 0
    assert not torch.distributed.is_initialized()


def test_a_placement_that_names_pod_alone_is_refused():
    """The folded live mesh reads ("pod", "data") as "data"; a placement that
    names "pod" alone has no group there, and the dry run says so."""
    mesh = Mesh(("pod", "data", "model"), (2, 16, 16))
    dryrun.check_fold({"w": (("pod", "data"), "model")}, {"w": ("data", "model")}, mesh)
    with pytest.raises(ValueError, match="pod"):
        dryrun.check_fold({"w": ("pod", None)}, {"w": (None, None)}, mesh)
