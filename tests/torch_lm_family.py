"""Shared set-up of ``test_torch_encdec.py`` (Whisper) and
``test_torch_vlm.py`` (Phi-3-vision): the reduced model in both packages
with the same numpy parameters, numpy batches with the family's frontend
input, and the comparisons both files make.

Parameters are the JAX init (seed 0) with every norm gain and bias spread
by 0.1 standard normal draws, so each leaf carries gradient signal; batches
hold 2 samples with some labels -100.  Tolerances: fp32 throughout, the
same math summed in another order (1e-5 against the JAX package, 5e-5
scaled by max(1, the largest reference) against the port's ``vmap``, as
``test_torch_oracle.py`` holds every other model).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import build_model as jbuild
from repro.core import clipping as jclip
from repro_torch import interop
from repro_torch.configs.registry import build_model, get_arch
from repro_torch.core import clipping as tclip
from repro_torch.utils.tree import flatten_dict, unflatten_dict

CLIP_NORM = 0.3
TOL = 1e-5
VMAP_TOL = 5e-5
# the modes held against the JAX package (one explicit-tap engine among
# them); every clipped mode is held against the port's vmap
JAX_MODES = ("non_private", "mixed_ghost", "bk_mixed", "bk_mixed_taps")
PORT_MODES = tuple(m for m in tclip.MODES if m not in ("vmap", "non_private"))


@functools.lru_cache(maxsize=None)
def pair(name: str, remat: bool = True):
    """(JAX model, JAX model without remat, port model, numpy params)."""
    jcfg = dataclasses.replace(JARCHS[name].reduced(), remat=remat)
    tcfg = dataclasses.replace(get_arch(name).reduced(), remat=remat)
    jmodel = jbuild(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    flat = flatten_dict(params)
    for path, leaf in flat.items():
        if path.endswith("/g") or path.endswith("/b"):
            flat[path] = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return (jmodel, jbuild(dataclasses.replace(jcfg, remat=False)),
            build_model(tcfg, device="cpu"), unflatten_dict(flat))


def np_batch(cfg, seed: int, b: int = 2, s: int = 20) -> dict:
    """``b`` samples of ``s`` tokens (some labels -100) and the family's
    ``frames`` or ``prefix``, standard normal."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -100
    labels[-1, -2:] = -100
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": labels, "mask": np.ones((b,), np.float32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        batch["prefix"] = rng.standard_normal((b, cfg.prefix_tokens, cfg.prefix_dim)).astype(
            np.float32)
    return batch


def port_params(name: str):
    return interop.params_from_jax(pair(name)[3], (), device="cpu")


def run_port(name: str, mode: str, batch: dict, *, model=None, **cfg):
    model = pair(name)[2] if model is None else model
    fn = tclip.dp_value_and_clipped_grad(
        model.loss_with_ctx, tclip.ClipConfig(mode=mode, clip_norm=CLIP_NORM, **cfg))
    return fn(port_params(name), interop.batch_from_numpy(batch, device="cpu"))


def run_jax(name: str, mode: str, batch: dict):
    """The JAX step; its explicit-tap engine runs without remat (it cannot
    trace its own checkpointed layers' taps), which computes the same
    function."""
    jmodel, jmodel_noremat, _, params = pair(name)
    jm = jmodel_noremat if mode.endswith("_taps") else jmodel
    fn = jclip.dp_value_and_clipped_grad(jm.loss_with_ctx,
                                         jclip.ClipConfig(mode=mode, clip_norm=CLIP_NORM))
    return jax.jit(fn)(jax.tree_util.tree_map(jnp.asarray, params), batch)


def grad_err(tg, jg) -> float:
    """Largest entry error of the port's tree against a JAX-layout one, over
    the largest reference entry."""
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jg))
    tflat = flatten_dict(interop.grads_to_jax_layout(tg, ()))
    assert tflat.keys() == jflat.keys()
    scale = max(float(np.abs(v).max()) for v in jflat.values())
    return max(float(np.abs(tflat[p] - w).max()) for p, w in jflat.items()) / scale


def assert_matches_jax(name: str, mode: str, batch: dict) -> None:
    jloss, jg, jaux = run_jax(name, mode, batch)
    tloss, tg, taux = run_port(name, mode, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    jn, tn = np.asarray(jaux["per_sample_norms"]), taux["per_sample_norms"].numpy()
    assert tn.shape == jn.shape == (2,)
    if mode != "non_private":  # C_i = 1 there: no norms
        assert float(np.abs(tn - jn).max()) <= TOL * float(np.abs(jn).max()), (tn, jn)
    assert grad_err(tg, jg) <= TOL


def assert_matches_port_vmap(name: str, mode: str, batch: dict) -> None:
    _, g_ref, aux_ref = run_port(name, "vmap", batch)
    _, g, aux = run_port(name, mode, batch)
    norms_ref = aux_ref["per_sample_norms"]
    scale = max(1.0, float(norms_ref.abs().max()))
    assert float((aux["per_sample_norms"] - norms_ref).abs().max()) <= VMAP_TOL * scale
    ref, got = flatten_dict(g_ref), flatten_dict(g)
    gscale = max(1.0, max(float(v.abs().max()) for v in ref.values()))
    for path, want in ref.items():
        assert float((got[path] - want).abs().max()) <= VMAP_TOL * gscale, (mode, path)


def assert_taps_match_jax(name: str, batch: dict) -> dict:
    """Same tap names, kinds, (T, D, p), param paths and stack dims in both
    packages, so a plan's fingerprint agrees; returns the port's meta."""
    from repro.tuner.plan import shape_fingerprint as jfingerprint
    from repro_torch.tuner.plan import shape_fingerprint as tfingerprint

    jmodel, _, tmodel, params = pair(name)
    jmeta = jclip.discover_meta(jmodel.loss_with_ctx, params, batch)
    tmeta = tclip.discover_meta(tmodel.loss_with_ctx, port_params(name),
                                interop.batch_from_numpy(batch, device="cpu"))
    assert tmeta.keys() == jmeta.keys()
    for key, jm in jmeta.items():
        tm = tmeta[key]
        assert (tm.kind, tm.T, tm.D, tm.p, tm.param_path, tm.bias_path, tm.stack_dims,
                tm.s_shape) == (jm.kind, jm.T, jm.D, jm.p, jm.param_path, jm.bias_path,
                                jm.stack_dims, tuple(jm.s_shape)), key
    assert tfingerprint(tmeta) == jfingerprint(jmeta)
    assert tclip.validate_coverage(tmeta, params) == []
    return tmeta


def serve_inputs(batch: dict, prompt: int) -> dict:
    """The prefill batch of a training batch's first ``prompt`` tokens."""
    out = {"tokens": batch["tokens"][:, :prompt]}
    for key in ("frames", "prefix"):
        if key in batch:
            out[key] = batch[key]
    return out


def assert_serving_matches_jax(name: str, batch: dict, prompt: int = 6,
                               steps: int = 3) -> None:
    """Prefill logits, then ``steps`` greedy decode steps' logits, at 1e-5
    of the largest entry."""
    jmodel, _, tmodel, params = pair(name)
    tparams = port_params(name)
    prefix = tmodel.cfg.prefix_tokens
    pb = serve_inputs(batch, prompt)
    jstate = jmodel.init_state(2, prompt + steps + 1 + prefix)
    tstate = tmodel.init_state(2, prompt + steps + 1 + prefix)
    jlog, jstate = jmodel.prefill(params, {k: jnp.asarray(v) for k, v in pb.items()}, jstate)
    with torch.no_grad():
        tlog, tstate = tmodel.prefill(tparams, interop.batch_from_numpy(pb, device="cpu"),
                                      tstate)
    assert tstate["pos"].tolist() == [prompt + prefix] * 2
    for _ in range(steps + 1):
        want = np.asarray(jlog)
        assert tlog.shape == want.shape
        assert float(np.abs(tlog.numpy() - want).max()) <= TOL * float(np.abs(want).max())
        nxt = np.argmax(want[:, -1:], axis=-1).astype(np.int32)
        jlog, jstate = jmodel.decode_step(params, jnp.asarray(nxt), jstate)
        with torch.no_grad():
            tlog, tstate = tmodel.decode_step(tparams, torch.as_tensor(nxt).long(), tstate)


def assert_decode_equals_teacher_forced(name: str, batch: dict, prompt: int = 5,
                                        new: int = 6) -> None:
    """Greedy prefill + decode against one cache-free forward of the same
    tokens: every step's logits at 1e-5, and the same greedy choices."""
    _, _, model, _ = pair(name)
    params = port_params(name)
    pb = interop.batch_from_numpy(serve_inputs(batch, prompt), device="cpu")
    with torch.no_grad():
        state = model.init_state(2, prompt + new + model.cfg.prefix_tokens)
        logits, state = model.prefill(params, pb, state)
        steps, tok = [logits], logits[:, -1:].argmax(dim=-1)
        fed = [pb["tokens"]]
        for _ in range(new - 1):
            fed.append(tok)
            logits, state = model.decode_step(params, tok, state)
            steps.append(logits)
            tok = logits[:, -1:].argmax(dim=-1)
        full = model.forward_logits(params, {**pb, "tokens": torch.cat(fed, dim=1)})
    want = full[:, prompt - 1:]
    got = torch.cat(steps, dim=1)
    assert got.shape == want.shape == (2, new, model.cfg.vocab)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    assert torch.equal(got.argmax(-1), want.argmax(-1))
