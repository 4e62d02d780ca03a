"""The convolutions (VGG, ResNet, ViT) and Mamba's heads (Jamba) on a live
``(data, model)`` mesh, as one rank of a gloo fleet (``tests/torch_dist.py``),
or on one process, for ``tests/test_torch_model_axis_conv.py``; and their
units (a split ``Conv2d`` before a whole ``GroupNorm``, the Mamba block's
taps, the split ``RMSNorm`` over ``d_inner``).

``inputs`` makes a model's weights from a seed (the port's ``init``) as
numpy arrays in the JAX layout (``interop.grads_to_jax_layout``), zero
biases and tables shifted so every leaf's gradient carries signal, and its
global batch as numpy arrays (images and labels from a seeded generator, or
the LM's ``synthetic_arch_batch``): the test's JAX call and every rank take
the same ones, the port's tensors through ``interop.params_from_jax``.
``conv_step`` runs one step from them; on a fleet it shards the state by
``state_shardings`` and runs inside ``use_reshard_rules`` on
``launch.mesh.make_mesh(shape)``.  It returns numpy arrays: the global
loss, per-sample norms and clip factors of the clipped call, its gradient
sum before the noise and the parameters after the step (gathered to full
leaves, in the port's layout), each leaf's stored fraction, this rank's
gradient shards, the bytes each collective moved and the taps' fingerprint.
No JAX here: the ranks are spawned processes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs.paper_native import VIT_BASE
from repro_torch.configs.registry import build_model, get_arch
from repro_torch.core import ghost
from repro_torch.core.clipping import discover_meta
from repro_torch.core.taps import Ctx
from repro_torch.data.synthetic import synthetic_arch_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (
    DPTrainConfig,
    make_accum_finalize,
    make_accum_init,
    make_accum_microstep,
    make_clipped_microstep,
    make_noise_finalize,
)
from repro_torch.models import cnn as tcnn
from repro_torch.models.vit import ViT
from repro_torch.optim import sgd
from repro_torch.parallel import collectives
from repro_torch.parallel.fsdp import ShardLayout, sharded_fraction
from repro_torch.parallel.reshard import use_reshard_rules
from repro_torch.parallel.sharding import param_shardings, state_shardings
from repro_torch.policies import make_policy
from repro_torch.tuner.plan import shape_fingerprint
from repro_torch.utils.tree import flatten_dict, tree_map, unflatten_dict

CLIP = 0.3
N_CLASSES = 10
VGG11_NARROW = (8, "M", 16, "M", 16, 16, "M", 32, 32, "M", 32, 32, "M")  # VGG-11 at 1/8 width
# model name -> its image size, or the block pattern of the reduced Jamba
MODELS = {"vgg11": 32, "resnet": 16, "vit": 16, "mamba": ("mamba",),
          "jamba": ("mamba", "attn")}
RESNET = dict(blocks_per_stage=(1, 1), width=16)  # stage 1 opens with a strided proj
VIT = dict(image_size=16, patch=4)
LM_SEQ = 16
SEED = 3
BATCH = 4


@dataclasses.dataclass(frozen=True)
class Case:
    mode: str
    accum: int = 1
    batch: int = 4
    noise: float = 0.5

    @property
    def key(self) -> str:
        return f"{self.mode}/accum{self.accum}/b{self.batch}/noise{self.noise}"


def vit_cfg():
    return dataclasses.replace(VIT_BASE.reduced(), n_layers=2)


def jamba_cfg(pattern: tuple):
    return dataclasses.replace(get_arch("jamba-1.5-large-398b").reduced(),
                               block_pattern=pattern, n_layers=len(pattern))


def port_model(name: str):
    """(model, its ArchConfig or None) of the port on the CPU."""
    if name == "vgg11":  # the narrow plan registered while the model is built
        tcnn.VGG_PLANS["vgg11_narrow"] = VGG11_NARROW
        try:
            return tcnn.VGG("vgg11_narrow", n_classes=N_CLASSES, device="cpu"), None
        finally:
            del tcnn.VGG_PLANS["vgg11_narrow"]
    if name == "resnet":
        return tcnn.ResNet(n_classes=N_CLASSES, device="cpu", **RESNET), None
    if name == "vit":
        cfg = vit_cfg()
        return ViT(cfg, n_classes=N_CLASSES, device="cpu", **VIT), cfg
    cfg = jamba_cfg(MODELS[name])
    return build_model(cfg, device="cpu"), cfg


@functools.lru_cache(maxsize=None)
def inputs(name: str):
    """(numpy parameters in the JAX layout, numpy global batch) of model
    ``name``, as the module docstring says."""
    model, cfg = port_model(name)
    params = model.init(torch.Generator().manual_seed(SEED))
    flat = flatten_dict(interop.grads_to_jax_layout(params, model.conv_weights))
    rng = np.random.default_rng(SEED)
    for path, leaf in flat.items():
        if path.endswith("/b") or path.endswith("/e"):
            flat[path] = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    if cfg is None or name == "vit":
        image = MODELS[name]
        batch = {"image": rng.standard_normal((BATCH, image, image, 3)).astype(np.float32),
                 "label": rng.integers(0, N_CLASSES, size=(BATCH,)).astype(np.int32),
                 "mask": np.ones((BATCH,), np.float32)}
    else:
        b = synthetic_arch_batch(cfg, batch=BATCH, seq=LM_SEQ, step=3, device="cpu")
        b["labels"][0, :3] = -100  # labels ignored at some positions, as real data has them
        batch = {k: v.numpy() for k, v in b.items()}
    return unflatten_dict(flat), batch


def _np(tree) -> dict:
    return {k: v.detach().float().numpy() for k, v in flatten_dict(tree).items()}


def _state(model, np_params, opt, policy) -> dict:
    params = interop.params_from_jax(np_params, model.conv_weights, device="cpu")
    return {"params": params, "opt": opt.init(params), "step": 0,
            "rng": torch.Generator().manual_seed(1), "policy": policy.init_state(device="cpu")}


def conv_step(name: str, case: Case, shape=None) -> dict:
    """One clipped call and an SGD + momentum step of model ``name`` (one
    rank when ``shape`` is None), as the module docstring says."""
    model, cfg = port_model(name)
    np_params, np_batch = inputs(name)
    policy = make_policy("fixed", clip_norm=CLIP)
    opt = sgd(momentum=0.9)
    sched = lambda step: 1e-2  # noqa: E731
    dp = DPTrainConfig(clipping_mode=case.mode, clip_norm=CLIP, noise_multiplier=case.noise,
                       logical_batch=case.batch, accumulation_steps=case.accum, policy=policy)
    state = _state(model, np_params, opt, policy)
    batch = interop.batch_from_numpy(np_batch, device="cpu")
    micro = case.batch // case.accum
    bs = [tree_map(lambda x, i=i: x[i * micro:(i + 1) * micro], batch) for i in range(case.accum)]
    shardings, layout, ctx = None, None, contextlib.nullcontext()
    if shape is not None:
        mesh = make_mesh(shape, "cpu")
        shardings = state_shardings(model, mesh, cfg, state)
        layout = ShardLayout(mesh, shardings["params"])
        full_bytes = layout.local_bytes(state["params"])
        state = layout.shard_state(state)
        ctx = use_reshard_rules(mesh, cfg)
    with ctx:
        fingerprint = shape_fingerprint(discover_meta(
            model.loss_with_ctx, state["params"], layout.local_rows(bs[0]) if layout else bs[0]))
        collectives.reset_bytes()
        loss, g, aux = make_clipped_microstep(model, dp, shardings)(
            state["params"], bs[0], state["policy"])
        moved = dict(collectives.BYTES)
        if case.accum == 1:
            new = make_noise_finalize(opt, sched, dp, shardings=shardings)(
                state, g, aux["per_sample_norms"], bs[0].get("mask"))
            norms, factors = aux["per_sample_norms"], aux["clip_factors"]
        else:
            acc = make_accum_init(state["params"], case.batch)()
            step = make_accum_microstep(model, dp, shardings=shardings)
            for i, b in enumerate(bs):
                acc = step(state["params"], state["policy"], acc, b, i)
            norms = acc["norms"].clone()
            new, metrics = make_accum_finalize(opt, sched, dp, shardings=shardings)(state, acc)
            loss, g, factors = metrics["loss"], acc["grads"], None
        out = {"loss": float(loss), "norms": norms.numpy(), "fingerprint": fingerprint,
               "factors": None if factors is None else factors.numpy(), "bytes": moved}
        if layout is not None:
            out["fraction"] = sharded_fraction(layout, new["params"])
            out["stored_bytes"] = layout.local_bytes(new["params"]) / full_bytes
            out["local_grads"] = _np(g)
            g, new = layout.gather(g), layout.gather_state(new)
    out.update(grads=_np(g), params=_np(new["params"]))
    return out


def fleet_steps(rank: int, n: int, shape: tuple, jobs: list) -> dict:
    """Every job ``(name, case)`` on this rank of a ``shape`` fleet:
    {(name, case key): result}."""
    del rank, n
    return {(name, case.key): conv_step(name, case, shape) for name, case in jobs}


# -- units -------------------------------------------------------------------

UNIT_MODES = ("mixed_ghost", "bk_mixed", "mixed_ghost_taps", "bk_mixed_taps")


class _ConvGN:
    """A split ``Conv2d`` (with a bias) feeding a whole ``GroupNorm``,
    per-sample squared-output losses."""

    def __init__(self):
        from repro_torch.nn.conv import Conv2d
        from repro_torch.nn.module import GroupNorm

        cpu = torch.device("cpu")
        self.conv = Conv2d("conv", 3, 8, (3, 3), device=cpu)
        self.gn = GroupNorm("gn", 8, groups=4, device=cpu)
        self.conv_weights = ("conv/w",)

    def init(self, gen):
        p = {"conv": self.conv.init(gen), "gn": self.gn.init(gen)}
        p["conv"]["b"] = torch.randn(8, generator=gen)
        p["gn"] = {"g": 1 + 0.1 * torch.randn(8, generator=gen),
                   "b": 0.1 * torch.randn(8, generator=gen)}
        return p

    def axes(self):
        return {"conv": self.conv.axes(), "gn": self.gn.axes()}

    def loss_with_ctx(self, params, batch, ctx):
        h = self.conv(params["conv"], batch["x"], ctx.scope("conv"))
        return torch.tanh(self.gn(params["gn"], h, ctx.scope("gn"))).square().sum(dim=(1, 2, 3))


def _mesh_ctx(model, params, n: int, cfg=None):
    """(this rank's shards of ``params``, the rules' context) on a (1, n)
    mesh; one rank when ``n == 1``."""
    if n == 1:
        return params, contextlib.nullcontext()
    mesh = make_mesh((1, n), "cpu")
    layout = ShardLayout(mesh, param_shardings(model, mesh, cfg, params))
    return layout.shard(params), use_reshard_rules(mesh, cfg)


def unit_conv(rank: int, n: int) -> dict:
    """``_ConvGN``: the output and the input's gradient (autograd), this
    rank's weight and bias gradients, the whole GroupNorm's, the conv tap's
    recorded shapes, and per-sample norms and clipped sums in UNIT_MODES."""
    from repro_torch.core.clipping import ClipConfig, dp_value_and_clipped_grad

    del rank
    model = _ConvGN()
    gen = torch.Generator().manual_seed(13)
    params = model.init(gen)
    x = torch.randn(3, 6, 6, 3, generator=gen)
    params, ctx = _mesh_ctx(model, params, n)
    out: dict = {}
    with ctx:
        leaves = {k: {kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
                  for k, v in params.items()}
        xg = x.clone().requires_grad_(True)
        meta: dict = {}
        tctx = Ctx(meta=meta)
        y = model.gn(leaves["gn"], model.conv(leaves["conv"], xg, tctx.scope("conv")),
                     tctx.scope("gn"))
        y.square().sum().backward()
        out.update(y=y.detach().numpy(), dx=xg.grad.numpy(),
                   grads={f"{k}/{kk}": vv.grad.numpy() for k, v in leaves.items()
                          for kk, vv in v.items()},
                   meta={k: (m.D, m.p, m.local, m.s_shape) for k, m in meta.items()})
        for mode in UNIT_MODES:
            fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode,
                                                                           clip_norm=0.5))
            _, g, aux = fn(params, {"x": x})
            out[mode] = {"norms": aux["per_sample_norms"].numpy(), "grads": _np(g)}
    return out


def _mamba_block():
    from repro_torch.nn.mamba import MambaBlock

    return MambaBlock("mamba", 16, head_dim=4, d_state=4, chunk=4,
                      device=torch.device("cpu"))


class _Mamba:
    def __init__(self):
        self.block = _mamba_block()

    def axes(self):
        return {"mamba": self.block.axes()}


def unit_mamba(rank: int, n: int, complete: bool = True) -> dict:
    """A Mamba block (d_model 16, 8 heads of 4) alone: the output, the
    input's gradient and every parameter's gradient (this rank's slices of
    the split ones), and each tap's per-sample squared norm from its
    recorded activation and cotangent (the explicit engine's channel) with
    whether the tap is split.  ``complete=False`` runs the block with
    ``copy_to_model`` as the identity: each rank's ``in_bcdt`` cotangent is
    then only its heads' part."""
    del rank
    block = _mamba_block()
    gen = torch.Generator().manual_seed(17)
    params = {"mamba": block.init(gen)}
    params["mamba"]["D"] = params["mamba"]["D"] + 0.1 * torch.randn(8, generator=gen)
    params["mamba"]["conv"]["b"] = 0.1 * torch.randn(32, generator=gen)
    params["mamba"]["norm"]["g"] = 1 + 0.1 * torch.randn(32, generator=gen)
    x = torch.randn(2, 8, 16, generator=gen)
    w = torch.randn(2, 8, 16, generator=gen)
    params, ctx = _mesh_ctx(_Mamba(), params, n)
    saved = collectives.copy_to_model
    if not complete:
        collectives.copy_to_model = lambda t, group: t
    try:
        with ctx:
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in flatten_dict(params["mamba"]).items()}
            xg = x.clone().requires_grad_(True)
            meta, acts = {}, {}
            tctx = Ctx(meta=meta, acts=acts)
            y = block(unflatten_dict(leaves), xg, tctx)
            loss = (y * w).sum(dim=(1, 2))
            keys = list(tctx.zs)
            cots = torch.autograd.grad(loss.sum(), [tctx.zs[k] for k in keys],
                                       retain_graph=True)
            norms = {k[0]: ghost.tap_norm_sq(meta[k[0]], acts[k], g, mode="mixed_ghost"
                                             ).numpy() for k, g in zip(keys, cots)}
            loss.sum().backward()
    finally:
        collectives.copy_to_model = saved
    return {"y": y.detach().numpy(), "dx": xg.grad.numpy(),
            "grads": {k: v.grad.numpy() for k, v in leaves.items()},
            "norms": norms, "split": {k: m.split for k, m in meta.items()}}


def unit_rmsnorm(rank: int, n: int) -> dict:
    """``RMSNorm`` over 12 channels given this rank's 12 / n of them (one
    rank: all): the output, the input's gradient, the whole gain's gradient
    and the tap's per-sample squared norm (this rank's part)."""
    from repro_torch.nn.module import RMSNorm

    mesh = make_mesh((1, n), "cpu") if n > 1 else None
    r = mesh.coord("model") if mesh else 0
    norm = RMSNorm("norm", 12, device=torch.device("cpu"))
    gen = torch.Generator().manual_seed(19)
    g = (1 + 0.1 * torch.randn(12, generator=gen)).requires_grad_(True)
    x = torch.randn(2, 5, 12, generator=gen)
    w = torch.randn(2, 5, 12, generator=gen)
    xs = x.chunk(n, dim=-1)[r].clone().requires_grad_(True)
    meta, acts = {}, {}
    ctx = (use_reshard_rules(mesh, get_arch("jamba-1.5-large-398b").reduced()) if mesh
           else contextlib.nullcontext())
    with ctx:
        tctx = Ctx(meta=meta, acts=acts)
        y = norm({"g": g}, xs, tctx)
        loss = (y * w.chunk(n, dim=-1)[r]).sum(dim=(1, 2))
        (cot,) = torch.autograd.grad(loss.sum(), [tctx.zs[("out", None)]], retain_graph=True)
        tap = ghost.tap_norm_sq(meta["out"], acts[("out", None)], cot, mode="mixed_ghost")
        loss.sum().backward()
    return {"y": y.detach().numpy(), "dx": xs.grad.numpy(), "dg": g.grad.numpy(),
            "tap": tap.numpy(), "local": meta["out"].local}


def unit_gathered_groupnorm(rank: int, n: int) -> dict:
    """This rank's channels of a (4, 8, 8, 64) activation gathered by
    ``reshard.whole_cols`` (as a split conv's output is), then a whole
    ``GroupNorm``: whether the gathered tensor is contiguous, and the
    GroupNorm's output (one rank: on the activation itself)."""
    from repro_torch.nn.module import GroupNorm
    from repro_torch.parallel.reshard import whole_cols

    x = torch.randn(4, 8, 8, 64, generator=torch.Generator().manual_seed(17))
    gn = GroupNorm("gn", 64, groups=16, device=torch.device("cpu"))
    params = gn.init(torch.Generator().manual_seed(18))
    width = 64 // n
    with contextlib.nullcontext() if n == 1 else use_reshard_rules(make_mesh((1, n), "cpu"),
                                                                   None):
        y = whole_cols(x[..., rank * width:(rank + 1) * width].contiguous(), 64)
        return {"contiguous": y.is_contiguous(), "y": gn(params, y, Ctx.disabled()).numpy()}


def conv_units(rank: int, n: int) -> dict:
    """The convolution's units on this rank of an ``n``-rank fleet."""
    return {"conv": unit_conv(rank, n), "gathered_gn": unit_gathered_groupnorm(rank, n)}


def mamba_units(rank: int, n: int) -> dict:
    """Mamba's units on this rank of an ``n``-rank fleet, in one process
    group (with two ranks, also the block whose B and C are not completed)."""
    out = {"mamba": unit_mamba(rank, n), "rmsnorm": unit_rmsnorm(rank, n)}
    if n == 2:
        out["mamba_partial"] = unit_mamba(rank, n, complete=False)
    return out
