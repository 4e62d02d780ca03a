"""Prefill and greedy decode of a reduced registry LM on a live ``(data,
model)`` mesh, as one rank of a gloo fleet (``tests/torch_dist.py``), or on
one process, for ``tests/test_torch_model_axis_serve.py``.  No JAX here:
the ranks are spawned processes, and the weights come in as the numpy tree
the JAX package's init drew (``interop.params_from_jax``).

A case either prefills ``prompt`` tokens into an empty state (on a fleet
built at its local shapes, ``launch.specs.local_serve_state``) or starts
from a loaded state, ``fill`` rows of every KV cache and the recurrent
states drawn from a seeded generator (on a fleet its slices,
``parallel.fsdp.ShardLayout``), then takes ``steps`` greedy decode steps
through ``launch.steps.make_prefill_step`` / ``make_decode_step``.  It
returns every step's logits and tokens, the tokens each step was given,
the final state gathered to full leaves, the bytes the collectives moved
and the attention calls of the prefill.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pickle

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import build_model, get_arch
from repro_torch.kernels import launches
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import local_serve_state
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.parallel import collectives
from repro_torch.parallel.fsdp import ShardLayout
from repro_torch.parallel.reshard import use_reshard_rules
from repro_torch.parallel.sharding import local_serve_shardings, param_shardings
from repro_torch.utils.tree import flatten_dict, unflatten_dict


@dataclasses.dataclass(frozen=True)
class ServeCase:
    arch: str
    over: tuple = ()  # ArchConfig overrides, (field, value) pairs
    batch: int = 2
    max_len: int = 16
    prompt: int = 8  # prefill length; 0: a loaded state of ``fill`` rows
    fill: int = 0
    steps: int = 2
    empty_from: int = 0  # a control: the loaded rows from here on left empty

    @property
    def key(self) -> str:
        over = ",".join(f"{k}={v}" for k, v in self.over)
        start = f"prefill{self.prompt}" if self.prompt else f"fill{self.fill}"
        if self.empty_from:
            start += f"-empty{self.empty_from}"
        return f"{self.arch}[{over}]/b{self.batch}/S{self.max_len}/{start}/x{self.steps}"

    def cfg(self):
        return dataclasses.replace(get_arch(self.arch).reduced(), **dict(self.over))


def _gen(case: ServeCase, salt: int) -> torch.Generator:
    return torch.Generator().manual_seed(1000 * salt + case.max_len % 997 + case.fill % 991)


def prompt_batch(case: ServeCase, cfg) -> dict:
    """The prompts (B, prompt) and, for the audio family, the encoder's
    frames."""
    batch = {"tokens": torch.randint(1, cfg.vocab, (case.batch, case.prompt),
                                     generator=_gen(case, 1))}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(case.batch, cfg.encoder_seq, cfg.d_model,
                                      generator=_gen(case, 4))
    return batch


def first_tokens(case: ServeCase, vocab: int) -> torch.Tensor:
    """A loaded case's first decode input (B, 1)."""
    return torch.randint(1, vocab, (case.batch, 1), generator=_gen(case, 2))


def full_state(model, case: ServeCase) -> dict:
    """The one-process starting state: empty, or with a loaded case's first
    ``fill`` rows of every KV cache drawn (positions ``0..fill-1``, ``idx``
    and ``pos`` at ``fill``) and its recurrent states drawn, as a long
    prefill would leave them."""
    state = model.init_state(case.batch, case.max_len)
    if not case.prompt:
        gen = _gen(case, 3)
        flat = flatten_dict(state)
        for path, x in flat.items():
            name = path.rsplit("/", 1)[-1]
            if name in ("k", "v"):
                x[:, :, :case.fill] = torch.randn(x[:, :, :case.fill].shape, generator=gen)
            elif name == "pos" and path != "pos":
                x[:, :, :case.fill] = torch.arange(case.fill)
                if case.empty_from:
                    x[:, :, case.empty_from:case.fill] = -1
            elif name in ("idx", "pos"):
                x.fill_(case.fill)
            else:  # conv and SSM states
                x.copy_(0.5 * torch.randn(x.shape, generator=gen))
        state = unflatten_dict(flat)
    return state


def _np(tree) -> dict:
    return {k: v.detach().numpy() for k, v in flatten_dict(tree).items()}


def serve_run(case: ServeCase, params_np: dict, shape=None) -> dict:
    """The case on one process (``shape`` None) or on this rank of a live
    ``shape`` mesh."""
    cfg = case.cfg()
    model = build_model(cfg, device="cpu")
    params = interop.params_from_jax(params_np, model.conv_weights, device="cpu")
    state = full_state(model, case)
    placements, ctx, mesh = None, contextlib.nullcontext(), None
    out = {}
    if shape is not None:
        mesh = make_mesh(shape, "cpu")
        placements = local_serve_shardings(mesh, cfg, state, case.batch)
        params = ShardLayout(mesh, param_shardings(model, mesh, cfg, params)).shard(params)
        layout = ShardLayout(mesh, placements)
        if case.prompt:  # built at its local shapes
            state = local_serve_state(model, cfg, ShapeConfig("s", case.max_len, case.batch,
                                                              "decode"),
                                      case.batch, placements, mesh)
        else:
            state = layout.shard(state)
        out["local_shapes"] = {k: tuple(v.shape) for k, v in flatten_dict(state).items()}
        out["placements"] = flatten_dict(placements)
        ctx = use_reshard_rules(mesh, cfg)
    logits, tokens, given = [], [], []
    with ctx:
        prefill = make_prefill_step(model, placements)
        decode = make_decode_step(model, placements)
        collectives.reset_bytes()
        launches.reset()
        if case.prompt:
            last, state = prefill(params, prompt_batch(case, cfg), state)
            logits.append(last)
            nxt = last[:, -1:].argmax(dim=-1)
            tokens.append(nxt)
        else:
            nxt = first_tokens(case, cfg.vocab)
        out["prefill_attention"] = launches.snapshot()["flash_attention"]["torch"]
        out["prefill_bytes"] = dict(collectives.BYTES)
        for _ in range(case.steps):
            given.append(nxt)
            collectives.reset_bytes()
            nxt, step_logits, state = decode(params, nxt, state)
            logits.append(step_logits)
            tokens.append(nxt)
        out["decode_bytes"] = dict(collectives.BYTES)
        if mesh is not None:
            state = layout.gather(state)
    out.update(logits=[x.numpy() for x in logits], tokens=[x.numpy() for x in tokens],
               given=[x.numpy() for x in given], state=_np(state))
    return out


def serve_fleet(rank: int, n: int, shape: tuple, cases: list, params_file: str) -> dict:
    """Every case on this rank of a ``shape`` fleet ({case key: result});
    ``params_file`` holds the pickled map of each case's arch key to its
    numpy weights (a path, not the weights: a spawned rank reads its
    arguments only once its imports are done, and the parent's start of
    the next rank would wait for that)."""
    del rank, n
    with open(params_file, "rb") as f:
        params = pickle.load(f)
    return {c.key: serve_run(c, params[weights_key(c)], shape) for c in cases}


def weights_key(case: ServeCase) -> str:
    """The cases of one configuration share its weights."""
    return f"{case.arch}[{','.join(f'{k}={v}' for k, v in case.over if k != 'window')}]"


def np_tree(tree) -> dict:
    """A numpy tree's leaves as numpy arrays (for pickling to the ranks)."""
    return {k: np.asarray(v) for k, v in flatten_dict(tree).items()}


def prefill_launches(rank: int, n: int) -> dict:
    """A sharded prefill of reduced Mixtral (fp32, a 16-row cache by KV
    head) on a ``(1, n)`` mesh of ranks sharing the card: the attention
    kernel's launches counted around this rank's prefill, and its logits."""
    del rank
    cfg = get_arch("mixtral-8x7b").reduced()
    model = build_model(cfg, device="cuda")
    mesh = make_mesh((1, n), "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    state = model.init_state(2, 16)
    placements = local_serve_shardings(mesh, cfg, state, 2)
    tokens = torch.randint(1, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    with use_reshard_rules(mesh, cfg):
        params = ShardLayout(mesh, param_shardings(model, mesh, cfg, params)).shard(params)
        state = ShardLayout(mesh, placements).shard(state)
        launches.reset()
        logits, _ = make_prefill_step(model, placements)(params, {"tokens": tokens.cuda()},
                                                         state)
        counts = launches.snapshot()["flash_attention"]
    return {"launches": counts, "logits": logits.cpu().numpy(), "layers": cfg.n_layers}
