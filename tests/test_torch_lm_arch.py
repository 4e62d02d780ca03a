"""The port's LM zoo end to end on the CPU: counterparts of
``tests/test_arch_smoke.py::test_arch_train_and_serve_smoke`` (one DP train
step with ``adamw``, then prefill and decode, for each dense and MoE arch
at its reduced size) and of
``tests/test_clipping_exactness.py::test_scanned_stack_attention_moe_exactness``
(a rematerialised 2-layer stack of GQA attention and MoE, every clipping
mode against the ``vmap`` oracle at 5e-5, as the JAX test holds its own;
the port's ``vmap`` against the JAX package's at 1e-5 on the same numpy
weights); and ``examples/train_dp_lm_torch.py`` on the CPU.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs.registry import ARCHS, build_model
from repro_torch.core import clipping as tclip
from repro_torch.core.taps import Ctx
from repro_torch.data.synthetic import (
    SyntheticLMConfig,
    synthetic_arch_batch,
    synthetic_lm_batch,
)
from repro_torch.launch.steps import (
    DPTrainConfig,
    make_decode_step,
    make_prefill_step,
    make_train_state,
    make_train_step,
)
from repro_torch.nn.attention import Attention
from repro_torch.nn.module import Dense, Embedding, Module, RMSNorm
from repro_torch.nn.moe import MoE
from repro_torch.nn.stack import ScannedStack
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.utils.tree import flatten_dict
from test_clipping_exactness import _StackModel as JaxStackModel

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_arch_train_and_serve_smoke(name):
    cfg = ARCHS[name].reduced()
    model = build_model(cfg, device="cpu")
    optimizer = adamw()
    state = make_train_state(model, 0, optimizer)
    batch = synthetic_arch_batch(cfg, batch=2, seq=32, step=1, device="cpu")
    text = 32 - cfg.prefix_tokens  # a VLM's prefix takes the first positions
    assert batch["tokens"].shape == batch["labels"].shape == (2, text)
    dp = DPTrainConfig(clipping_mode="mixed_ghost", clip_norm=1.0, noise_multiplier=0.5,
                       logical_batch=2)
    step = make_train_step(model, optimizer, warmup_cosine(1e-3, 2, 10), dp, device="cpu")
    state2, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])
    assert state2["step"] == 1
    for path, leaf in flatten_dict(state2["params"]).items():
        assert not bool(torch.isnan(leaf).any()), path
    assert set(state2["opt"]) == {"m", "v"}

    # serving: prefill 16 tokens (and the family's frames or prefix) then decode 2
    with torch.no_grad():
        prompt = synthetic_arch_batch(cfg, batch=2, seq=16 + cfg.prefix_tokens, step=2,
                                      device="cpu")
        prompt = {k: v for k, v in prompt.items() if k in ("tokens", "frames", "prefix")}
        assert prompt["tokens"].shape == (2, 16)
        logits, sstate = make_prefill_step(model)(state2["params"], prompt,
                                                  model.init_state(2, 32 + cfg.prefix_tokens))
        assert logits.shape == (2, 1, cfg.vocab)
        decode = make_decode_step(model)
        tok = logits[:, -1:].argmax(dim=-1)
        for _ in range(2):
            tok, lg, sstate = decode(state2["params"], tok, sstate)
        assert lg.shape == (2, 1, cfg.vocab)
        assert not bool(torch.isnan(lg).any())


def test_synthetic_lm_batch_is_a_function_of_seed_step_shard():
    cfg = SyntheticLMConfig(vocab=50, seq_len=12, batch=3)
    a = synthetic_lm_batch(cfg, 4, 1, device="cpu")
    assert torch.equal(a["tokens"], synthetic_lm_batch(cfg, 4, 1, device="cpu")["tokens"])
    assert not torch.equal(a["tokens"], synthetic_lm_batch(cfg, 5, 1, device="cpu")["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])  # labels: the next token
    assert int(a["tokens"].max()) < 50 and int(a["tokens"].min()) >= 0
    # the chain's rule holds wherever no noise draw replaced the token
    follows = (a["tokens"] * 31 + 7) % 50 == a["labels"]
    assert float(follows.float().mean()) > 0.7
    # a VLM's batch: the prefix takes the first positions, the text the rest
    vlm = dataclasses.replace(ARCHS["yi-6b"].reduced(), family="vlm", prefix_tokens=4,
                              prefix_dim=16)
    b = synthetic_arch_batch(vlm, batch=2, seq=8, device="cpu")
    assert b["tokens"].shape == (2, 4) and b["prefix"].shape == (2, 4, 16)


class TorchStackModel(Module):
    """The port's counterpart of the JAX test's ``_StackModel``: embedding,
    a rematerialised 2-layer stack of RMSNorm + GQA attention (4 heads over
    2 KV heads, blocks of 4) + RMSNorm + MoE (4 experts, top 2), a head."""

    def __init__(self, d=16, vocab=13):
        dev = CPU

        class Block(Module):
            def __init__(self):
                self.n1 = RMSNorm("n1", d, device=dev)
                self.attn = Attention("attn", d, 4, 2, block_q=4, block_kv=4, device=dev)
                self.n2 = RMSNorm("n2", d, device=dev)
                self.moe = MoE("moe", d, 20, n_experts=4, top_k=2, device=dev)

            def __call__(self, params, x, ctx, **kw):
                x = x + self.attn(params["attn"], self.n1(params["n1"], x, ctx.scope("n1")),
                                  ctx.scope("attn"))
                return x + self.moe(params["moe"], self.n2(params["n2"], x, ctx.scope("n2")),
                                    ctx.scope("moe"))

        self.emb = Embedding("emb", vocab, d, device=dev)
        self.stack = ScannedStack("layers", Block(), 2, remat=True)
        self.head = Dense("head", d, vocab, use_bias=False, device=dev)

    def loss_with_ctx(self, params, batch, ctx):
        x = self.emb(params["emb"], batch["tokens"], ctx.scope("emb"))
        x = self.stack(params["layers"], x, ctx.scope("layers"))
        logits = self.head(params["head"], x, ctx.scope("head"))
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
        return nll.mean(dim=-1)


def test_scanned_stack_attention_moe_exactness():
    jmodel = JaxStackModel()
    np_params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    params = interop.params_from_jax(np_params, (), device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 13, (3, 6)).astype(np.int32),
             "labels": rng.integers(0, 13, (3, 6)).astype(np.int32)}
    model = TorchStackModel()
    meta = tclip.discover_meta(model.loss_with_ctx, params, interop.batch_from_numpy(batch, "cpu"))
    assert meta["layers/moe/wg@out"].n_groups == 4
    assert meta["layers/moe/wg@out"].stack_dims == (2,)
    results = {}
    for mode in tclip.MODES:
        if mode == "non_private":
            continue
        fn = tclip.dp_value_and_clipped_grad(model.loss_with_ctx,
                                             tclip.ClipConfig(mode=mode, clip_norm=0.3))
        results[mode] = fn(params, interop.batch_from_numpy(batch, "cpu"))
    ref_loss, ref_g, ref_aux = results["vmap"]
    ref_flat = flatten_dict(ref_g)
    scale = max(float(ref_aux["per_sample_norms"].max()), 1.0)
    for mode, (loss, g, aux) in results.items():
        assert torch.allclose(loss, ref_loss, rtol=1e-5), mode
        nerr = float((aux["per_sample_norms"] - ref_aux["per_sample_norms"]).abs().max())
        assert nerr / scale < 5e-5, (mode, nerr)
        gerr = max(float((v - ref_flat[k]).abs().max()) for k, v in flatten_dict(g).items())
        assert gerr < 5e-5, (mode, gerr)
    # the port's oracle against the JAX package's
    from repro.core.clipping import ClipConfig, dp_value_and_clipped_grad

    _, jg, jaux = jax.jit(dp_value_and_clipped_grad(
        jmodel.loss_with_ctx, ClipConfig(mode="vmap", clip_norm=0.3)))(jmodel.params, batch)
    np.testing.assert_allclose(ref_aux["per_sample_norms"].numpy(),
                               np.asarray(jaux["per_sample_norms"]), rtol=1e-5)
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jg))
    jscale = max(float(np.abs(v).max()) for v in jflat.values())
    for path, want in jflat.items():
        assert float(np.abs(ref_flat[path].numpy() - want).max()) <= 1e-5 * jscale, path


def test_ctx_disabled_loss_runs_without_taps():
    model = build_model(ARCHS["mixtral-8x7b"].reduced(), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = synthetic_arch_batch(model.cfg, batch=2, seq=8, device="cpu")
    with torch.no_grad():
        losses = model.loss_with_ctx(params, batch, Ctx.disabled())
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())


@pytest.mark.parametrize("arch,mode", [("yi-6b", "mixed_ghost"), ("mixtral-8x7b", "bk_mixed")])
def test_lm_example_runs_on_the_cpu(arch, mode):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_dp_lm_torch.py"), "--arch", arch,
         "--reduced", "--device", "cpu", "--mode", mode, "--steps", "1", "--seq", "16"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"{mode} on cpu" in out.stdout and "step 0: loss" in out.stdout
