"""One DP step of a reduced registry arch on a live ``(data, model)`` mesh,
as one rank of a gloo fleet (``tests/torch_dist.py``), or on one process,
for ``tests/test_torch_model_axis.py``; and the model-axis units (``Dense``,
``Attention``, the vocab-parallel loss) for ``tests/test_torch_model_axis_units.py``.

``step_case`` builds the model, the train state (seed 0) and a global batch
from seeded generators, so every rank and the one-process reference start
from the same values; on a fleet it shards the state by
``state_shardings`` and runs inside ``use_reshard_rules`` on
``launch.mesh.make_mesh(shape)``.  It returns numpy arrays: the global
loss, per-sample norms and clip factors of the clipped call, its gradient
sum before the noise and the parameters after the step (gathered to full
leaves), each leaf's stored fraction, the bytes each axis's collectives
moved, and the tap shapes' fingerprint.  No JAX here: the ranks are
spawned processes.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.configs.registry import build_model, get_arch
from repro_torch.core.clipping import VmapUnderShardingError, discover_meta
from repro_torch.data.synthetic import synthetic_arch_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (
    DPTrainConfig,
    make_accum_finalize,
    make_accum_init,
    make_accum_microstep,
    make_clipped_microstep,
    make_noise_finalize,
    make_train_state,
    make_train_step,
)
from repro_torch.optim import adam, sgd, warmup_cosine
from repro_torch.parallel import collectives, reshard
from repro_torch.parallel.fsdp import ShardLayout, sharded_fraction
from repro_torch.parallel.reshard import use_reshard_rules
from repro_torch.parallel.sharding import state_shardings
from repro_torch.policies import make_policy
from repro_torch.tuner.plan import shape_fingerprint
from repro_torch.utils.tree import flatten_dict

CLIP = 0.3


@dataclasses.dataclass(frozen=True)
class Case:
    mode: str
    policy: str = "fixed"
    accum: int = 1
    batch: int = 4
    seq: int = 8
    noise: float = 0.5
    opt: str = "sgd"  # SGD + momentum: the parameters inherit the gradient's tolerance
    train_step: bool = False  # the update through make_train_step (a second clipped call)

    @property
    def key(self) -> str:
        return (f"{self.mode}/{self.policy}/accum{self.accum}/b{self.batch}x{self.seq}"
                f"/noise{self.noise}/{self.opt}{'/step' if self.train_step else ''}")


def _policy(name: str):
    return make_policy(name, clip_norm=CLIP, init_clip_norm=CLIP, groups=("lm_head", "embed"))


def _np(tree) -> dict:
    return {k: v.detach().float().numpy() for k, v in flatten_dict(tree).items()}


def batches(cfg, case: Case) -> list:
    """The global batch of each microstep (every rank builds the same)."""
    micro = case.batch // case.accum
    out = []
    for i in range(case.accum):
        b = synthetic_arch_batch(cfg, batch=micro, seq=case.seq, step=3, shard=i, device="cpu")
        b["labels"][0, :3] = -100  # labels ignored at some positions, as real data has them
        out.append(b)
    return out


def step_case(arch: str, case: Case, shape=None) -> dict:
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, device="cpu")
    policy = _policy(case.policy)
    opt = sgd(momentum=0.9) if case.opt == "sgd" else adam()
    sched = warmup_cosine(1e-3, 2, 10) if case.opt == "adam" else (lambda step: 1e-2)
    dp = DPTrainConfig(clipping_mode=case.mode, clip_norm=CLIP, noise_multiplier=case.noise,
                       logical_batch=case.batch, accumulation_steps=case.accum, policy=policy)
    state = make_train_state(model, 0, opt, policy)
    bs = batches(cfg, case)
    shardings, layout, ctx = None, None, contextlib.nullcontext()
    if shape is not None:
        mesh = make_mesh(shape, "cpu")
        shardings = state_shardings(model, mesh, cfg, state)
        layout = ShardLayout(mesh, shardings["params"])
        full_bytes = layout.local_bytes(state["params"])
        state = layout.shard_state(state)
        ctx = use_reshard_rules(mesh, cfg)
    with ctx:
        fingerprint = shape_fingerprint(discover_meta(model.loss_with_ctx, state["params"],
                                                      layout.local_rows(bs[0]) if layout
                                                      else bs[0]))
        collectives.reset_bytes()
        loss, g, aux = make_clipped_microstep(model, dp, shardings)(
            state["params"], bs[0], state["policy"])
        moved = dict(collectives.BYTES)
        if case.train_step:
            new, metrics = make_train_step(model, opt, sched, dp, device="cpu",
                                           shardings=shardings)(state, bs[0])
        elif case.accum == 1:
            new = make_noise_finalize(opt, sched, dp, shardings=shardings)(
                state, g, aux["per_sample_norms"], bs[0].get("mask"))
            metrics = {"loss": loss}
        else:
            acc = make_accum_init(state["params"], case.batch)()
            micro = make_accum_microstep(model, dp, shardings=shardings)
            for i, b in enumerate(bs):
                acc = micro(state["params"], state["policy"], acc, b, i)
            new, metrics = make_accum_finalize(opt, sched, dp, shardings=shardings)(state, acc)
            g = acc["grads"]  # the logical batch's clipped sum before the noise
        out = {"loss": float(loss), "norms": aux["per_sample_norms"].numpy(),
               "factors": aux["clip_factors"].numpy(), "metric_loss": float(metrics["loss"]),
               "fingerprint": fingerprint, "bytes": moved}
        if layout is not None:
            out["fraction"] = sharded_fraction(layout, new["params"])
            out["stored_bytes"] = layout.local_bytes(new["params"]) / full_bytes
            out["local_grads"] = _np(g)  # this rank's shards, for the replicas' equality
            g, new = layout.gather(g), layout.gather_state(new)
    out.update(grads=_np(g), params=_np(new["params"]))
    return out


def fleet_cases(rank: int, n: int, arch: str, shape: tuple, cases: list) -> dict:
    """Every case on this rank of a ``shape`` fleet; one result dict per case
    key (a case that must raise gives the name of its error)."""
    del rank, n
    out = {}
    for c in cases:
        try:
            out[c.key] = step_case(arch, c, shape)
        except VmapUnderShardingError as e:
            out[c.key] = type(e).__name__
    return out


# -- units -------------------------------------------------------------------

def _rand(gen, *shape):
    return torch.randn(*shape, generator=gen)


def unit_dense(rank: int, n: int, bias: bool) -> dict:
    """A column-parallel ``Dense`` feeding a row-parallel one (each with a
    bias when ``bias``) on a ``(1, n)`` mesh: the output, the input's
    gradient and this rank's slices of the weight gradients, against one
    rank; the taps' recorded ``D``, ``p`` and ``local``."""
    from repro_torch.core.taps import Ctx
    from repro_torch.nn.module import Dense

    mesh = make_mesh((1, n), "cpu") if n > 1 else None
    gen = torch.Generator().manual_seed(3)
    del rank
    up = Dense("up", 8, 12, use_bias=bias, w_axes=("embed", "mlp"), device=torch.device("cpu"))
    down = Dense("down", 12, 8, use_bias=bias, w_axes=("mlp", "embed"),
                 device=torch.device("cpu"))
    params = {"up": up.init(gen), "down": down.init(gen)}
    for p in params.values():  # nonzero biases
        if "b" in p:
            p["b"] = _rand(gen, *p["b"].shape)
    x = _rand(gen, 2, 5, 8).requires_grad_(True)
    ctx = contextlib.nullcontext()
    if mesh is not None:
        ctx = use_reshard_rules(mesh, get_arch("qwen1.5-32b").reduced())
        r = mesh.coord("model")
        params = {"up": {k: v.chunk(n, dim=-1)[r].clone() for k, v in params["up"].items()},
                  "down": {"w": params["down"]["w"].chunk(n, dim=0)[r].clone(),
                           **({"b": params["down"]["b"]} if bias else {})}}
    leaves = {k: {kk: vv.requires_grad_(True) for kk, vv in v.items()} for k, v in params.items()}
    meta: dict = {}
    with ctx:
        tctx = Ctx(meta=meta)
        y = down(leaves["down"], torch.tanh(up(leaves["up"], x, tctx.scope("up"))),
                 tctx.scope("down"))
        y.square().sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "grads": {f"{k}/{kk}": vv.grad.numpy() for k, v in leaves.items()
                      for kk, vv in v.items()},
            "meta": {k: (m.D, m.p, m.local) for k, m in meta.items()}}


def unit_attention(n: int, heads: int, kv: int, hd: int, mesh=None) -> dict:
    """Grouped-query attention on ``mesh`` (its q/k/v/o placements from the
    rules: whole heads, heads split inside a head, KV heads split or whole):
    the output, the input's gradient and every weight's gradient (this
    rank's slices), and which dim of each projection is on "model"."""
    from repro_torch.core.taps import Ctx
    from repro_torch.nn.attention import Attention
    from repro_torch.parallel.sharding import param_shardings

    d = 16
    cfg = dataclasses.replace(get_arch("mixtral-8x7b").reduced(), d_model=d, n_heads=heads,
                              n_kv=kv, head_dim=hd)
    attn = Attention("attn", d, heads, kv, head_dim=hd, block_q=4, block_kv=4,
                     device=torch.device("cpu"))
    gen = torch.Generator().manual_seed(5)
    params = {"attn": attn.init(gen)}
    x = _rand(gen, 2, 6, d).requires_grad_(True)
    ctx = contextlib.nullcontext()
    if mesh is not None:
        class _Model:
            def axes(self):
                return {"attn": attn.axes()}

        params = ShardLayout(mesh, param_shardings(_Model(), mesh, cfg, params)).shard(params)
        ctx = use_reshard_rules(mesh, cfg)
    leaves = {k: {kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
              for k, v in params["attn"].items()}
    with ctx:
        y = attn(leaves, x, Ctx(meta={}))
        y.square().sum().backward()
        split = {k: reshard.model_dim(getattr(attn, f"w{k}").w_axes,
                                      (getattr(attn, f"w{k}").d_in, getattr(attn, f"w{k}").d_out))
                 for k in "qkvo"}
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "split": split,
            "grads": {f"{k}/{kk}": vv.grad.numpy() for k, v in leaves.items()
                      for kk, vv in v.items()}}


class _TwoDense:
    """A column-parallel ``Dense`` (bias split) feeding a row-parallel one
    (bias whole) on a ``(1, n)`` mesh, per-sample squared-output losses: the
    clipping engines' view of both bias kinds."""

    def __init__(self):
        from repro_torch.nn.module import Dense

        cpu = torch.device("cpu")
        self.up = Dense("up", 8, 12, w_axes=("embed", "mlp"), device=cpu)
        self.down = Dense("down", 12, 8, w_axes=("mlp", "embed"), device=cpu)

    def init(self, gen):
        params = {"up": self.up.init(gen), "down": self.down.init(gen)}
        for p in params.values():
            p["b"] = _rand(gen, *p["b"].shape)
        return params

    def axes(self):
        return {"up": self.up.axes(), "down": self.down.axes()}

    def loss_with_ctx(self, params, batch, ctx):
        h = torch.tanh(self.up(params["up"], batch["x"], ctx.scope("up")))
        return self.down(params["down"], h, ctx.scope("down")).square().sum(dim=(1, 2))


CLIP_UNIT_MODES = ("mixed_ghost", "bk_mixed", "mixed_ghost_taps", "bk_mixed_taps")


def unit_clip(rank: int, n: int) -> dict:
    """Per-sample norms and clipped sums of ``_TwoDense`` in CLIP_UNIT_MODES
    (one rank when ``n == 1``): the split bias's part of the norm adds up
    over the ranks, the whole one counts once."""
    from repro_torch.core.clipping import ClipConfig, dp_value_and_clipped_grad
    from repro_torch.parallel.sharding import param_shardings

    del rank
    model = _TwoDense()
    gen = torch.Generator().manual_seed(11)
    params = model.init(gen)
    batch = {"x": _rand(gen, 3, 5, 8)}
    ctx = contextlib.nullcontext()
    if n > 1:
        mesh = make_mesh((1, n), "cpu")
        cfg = get_arch("qwen1.5-32b").reduced()
        params = ShardLayout(mesh, param_shardings(model, mesh, cfg, params)).shard(params)
        ctx = use_reshard_rules(mesh, cfg)
    out = {}
    with ctx:
        for mode in CLIP_UNIT_MODES:
            fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode,
                                                                           clip_norm=0.5))
            _, g, aux = fn(params, batch)
            out[mode] = {"norms": aux["per_sample_norms"].numpy(), "grads": _np(g)}
    return out


def unit_xent(rank: int, n: int) -> dict:
    """``vocab_parallel_xent`` on this rank's vocabulary columns: the loss
    and the logits' gradient (its columns), against ``per_sample_xent``."""
    from repro_torch.models.losses import vocab_parallel_xent

    mesh = make_mesh((1, n), "cpu")
    gen = torch.Generator().manual_seed(7)
    logits = (4 * _rand(gen, 3, 5, 12)).chunk(n, dim=-1)[mesh.coord("model")].clone()
    labels = torch.randint(0, 12, (3, 5), generator=gen)
    labels[0, :2] = -100
    mask = torch.tensor([1.0, 0.0, 1.0])
    logits.requires_grad_(True)
    loss = vocab_parallel_xent(logits, labels, mask, mesh.group("model"))
    (loss * torch.arange(1.0, 4.0)).sum().backward()
    return {"loss": loss.detach().numpy(), "grad": logits.grad.numpy()}


def unit_seq(rank: int, n: int) -> dict:
    """``shard_seq`` then ``unshard_seq`` of a (B, T, d) carry around a
    per-position map on a ``(1, n)`` mesh: the slice each rank stores, the
    whole carry after, and the input's gradient."""
    mesh = make_mesh((1, n), "cpu")
    gen = torch.Generator().manual_seed(9)
    x = _rand(gen, 2, 4 * n, 3).requires_grad_(True)
    w = _rand(gen, 2, 4 * n, 3)
    with use_reshard_rules(mesh, get_arch("qwen1.5-32b").reduced()):
        part = reshard.shard_seq(torch.sin(x))
        whole = reshard.unshard_seq(part, x.shape[1])
        (whole * w).sum().backward()
    return {"part": part.detach().numpy(), "whole": whole.detach().numpy(),
            "dx": x.grad.numpy()}


def _sharded(model, cfg, mesh):
    """The model's seed-0 parameters as this rank stores them on ``mesh``."""
    from repro_torch.parallel.sharding import param_shardings

    params = model.init(torch.Generator().manual_seed(0))
    return ShardLayout(mesh, param_shardings(model, mesh, cfg, params)).shard(params)


def unit_refusals(rank: int, n: int) -> dict:
    """The paths once refused on a model axis larger than one: {path: "ran"
    or the error's message}, and under "shards" what each splits
    (``shard_heads``' output shape, the taps' ``local``, the sharded
    prefill's cache leaf and logits shapes and its error against one
    rank's)."""
    from repro_torch.core.taps import Ctx
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.cnn import VGG
    from repro_torch.parallel.sharding import local_serve_shardings

    mesh = make_mesh((1, n), "cpu")
    out = {"shards": {}}

    def attempt(name, fn):
        try:
            with torch.no_grad():
                out["shards"][name] = fn()
            out[name] = "ran"
        except (NotImplementedError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"

    def prefill(model, cfg, params, tokens, want):
        """The sharded prefill: the rank's first KV cache leaf, the logits'
        shape and their error against the one-rank prefill's ``want``."""
        state = model.init_state(2, 16)
        placements = local_serve_shardings(mesh, cfg, state, 2)
        logits, state = make_prefill_step(model, placements)(
            params, {"tokens": tokens}, ShardLayout(mesh, placements).shard(state))
        k = next(v for p, v in flatten_dict(state).items() if p.endswith("/kv/k"))
        return {"k": tuple(k.shape), "logits": tuple(logits.shape),
                "err": float((logits - want).abs().max() / want.abs().max())}

    def taps(model, params, batch, *names):
        """The ``local`` of the named taps, from one discovering forward."""
        meta: dict = {}
        model.loss_with_ctx(params, batch, Ctx(meta=meta))
        return {k: meta[k].local for k in names}

    vgg = VGG("vgg11", device="cpu")
    images = {"image": torch.zeros(2, 32, 32, 3), "label": torch.zeros(2, dtype=torch.long)}
    with use_reshard_rules(mesh, None):  # cfg None resolves as "tp": the CNNs and ViTs
        attempt("shard_heads", lambda: tuple(reshard.shard_heads(torch.zeros(2, 4, 4, 8)).shape))
        attempt("conv", lambda: taps(vgg, _sharded(vgg, None, mesh), images, "conv0/out"))
    for arch in ("jamba-1.5-large-398b", "mixtral-8x7b"):
        cfg = get_arch(arch).reduced()
        model = build_model(cfg, device="cpu")
        params = _sharded(model, cfg, mesh)
        batch = synthetic_arch_batch(cfg, batch=2, seq=8, device="cpu")
        if arch == "mixtral-8x7b":  # the one-rank prefill, outside the mesh's rules
            with torch.no_grad():
                want, _ = model.prefill(model.init(torch.Generator().manual_seed(0)),
                                        {"tokens": batch["tokens"]}, model.init_state(2, 16))
        with use_reshard_rules(mesh, cfg):
            if arch == "mixtral-8x7b":
                attempt("prefill", lambda: prefill(model, cfg, params, batch["tokens"], want))
            else:
                attempt("mamba", lambda: taps(model, params, batch,
                                              "layers/0/mamba/in_x/out",
                                              "layers/0/mamba/in_bcdt/out"))
    return out


def unit_reduce(rank: int) -> dict:
    """``ShardLayout.reduce_grads`` on a (2, 2) mesh, a (4, 6) leaf split on
    both axes and a (6,) leaf whole: each rank's gradients, at the stored
    shape (reduce-scattered already), at the compute shape (to be
    reduce-scattered over data) and whole (to be all-reduced over data)."""
    mesh = make_mesh((2, 2), "cpu")
    layout = ShardLayout(mesh, {"w": ("data", "model"), "b": (None,)})
    params = {"w": torch.zeros(2, 3), "b": torch.zeros(6)}
    mine = float(rank + 1)
    stored = layout.reduce_grads({"w": torch.full((2, 3), mine), "b": torch.full((6,), mine)},
                                 params)
    compute = layout.reduce_grads({"w": mine * torch.arange(12.0).reshape(4, 3),
                                   "b": torch.full((6,), mine)}, params)
    return {"coords": (mesh.coord("data"), mesh.coord("model")),
            "stored": _np(stored), "compute": _np(compute),
            "full_shape": layout.full_shape("w", (2, 3)),
            "compute_shape": layout.compute_shape("w", (2, 3))}


# (heads, KV heads, head dim) on a model axis of 2 and of 4: whole heads with
# their KV heads local; heads and KV heads split inside a head; KV heads
# whole; a GQA block of 2 q heads on one KV head; q heads whose KV heads
# are no block (6 / 3 on 2: heads 0-2 read KV heads 0, 0, 1)
ATTENTION = {2: [(4, 2, 8), (3, 3, 8), (4, 1, 6), (6, 3, 8)],
             4: [(4, 2, 8), (6, 2, 8), (8, 2, 4), (4, 1, 6)]}


def units(rank: int, n: int) -> dict:
    """Every unit on this rank of an ``n``-rank fleet, in one process group."""
    out = {"attention": {}}
    mesh = make_mesh((1, n), "cpu")
    for heads, kv, hd in ATTENTION[n]:
        out["attention"][(heads, kv, hd)] = unit_attention(n, heads, kv, hd, mesh)
    if n == 2:
        out["dense"] = {bias: unit_dense(rank, n, bias) for bias in (False, True)}
        out["xent"] = unit_xent(rank, n)
        out["seq"] = unit_seq(rank, n)
        out["refusals"] = unit_refusals(rank, n)
        out["clip"] = unit_clip(rank, n)
    if n == 4:
        out["reduce"] = unit_reduce(rank)
    return out
