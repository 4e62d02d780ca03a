"""The encoder-decoder family (Whisper-large-v3) in the port, held against the
JAX package and against itself on the CPU.

Reduced Whisper (d_model 64, 4 heads of 16, 2 encoder and 4 decoder
layers, 12 frames, vocab 128, attention blocks of 16) with the JAX
package's numpy parameters (``torch_lm_family``), 2 samples of 20 tokens:

- against the JAX package, fp32 at 1e-5: the loss, per-sample norms and
  clipped sums in ``non_private``, ``mixed_ghost``, ``bk_mixed`` and
  ``bk_mixed_taps`` (the JAX ``*_taps`` reference without remat), the taps
  and plan fingerprint, the prefill's and three decode steps' logits, the
  cross-attention module alone (training, Sq != Skv, gradients through
  ``flash_attention_train``; serving, the prefill filling ``xkv`` and a
  decode step reading it) and ``blocked_decode_attention``;
- within the port: every clipped mode against its ``vmap`` (5e-5), remat
  on == off bit for bit (the encoder's gradient comes through every
  decoder layer's checkpointed cross-attention), decode against the
  teacher-forced forward, the serve CLI's fixed wave, the tuner CLI, the
  engine's refusal, and ``synthetic_arch_batch``'s frames.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.taps import Ctx as JCtx
from repro.nn import attention as jattn
from repro_torch.configs.registry import build_model, get_arch
from repro_torch.core.taps import Ctx
from repro_torch.data.synthetic import synthetic_arch_batch
from repro_torch.launch import serve
from repro_torch.models.encdec import EncDecLM
from repro_torch.nn import attention as tattn
from repro_torch.serving import Engine
from repro_torch.tuner import cli as tuner_cli
from repro_torch.utils.tree import flatten_dict
from torch_lm_family import (
    JAX_MODES,
    PORT_MODES,
    TOL,
    assert_decode_equals_teacher_forced,
    assert_matches_jax,
    assert_matches_port_vmap,
    assert_serving_matches_jax,
    assert_taps_match_jax,
    np_batch,
    pair,
    run_port,
)
from torch_threads import torch_threads_per_worker  # noqa: F401

NAME = "whisper-large-v3"
ROOT = Path(__file__).resolve().parents[1]


def _batch(seed: int = 1) -> dict:
    return np_batch(get_arch(NAME).reduced(), seed)


@pytest.mark.parametrize("mode", JAX_MODES)
def test_whisper_clipped_step_matches_jax(mode):
    assert_matches_jax(NAME, mode, _batch())


@pytest.mark.parametrize("mode", PORT_MODES)
def test_whisper_mode_matches_port_vmap(mode):
    assert_matches_port_vmap(NAME, mode, _batch(2))


@pytest.mark.parametrize("mode", ["mixed_ghost", "bk_mixed", "mixed_ghost_taps"])
def test_whisper_remat_on_equals_off(mode):
    """Every gradient leaf, the encoder's included, bit for bit: enc_out is
    closed over by each checkpointed decoder layer, and the recomputation
    leaves the first forward's cross k/v records in place."""
    cfg = dataclasses.replace(get_arch(NAME).reduced(), remat=False)
    batch = _batch(3)
    on = run_port(NAME, mode, batch)
    off = run_port(NAME, mode, batch, model=build_model(cfg, device="cpu"))
    assert torch.equal(on[0], off[0])
    assert torch.equal(on[2]["per_sample_norms"], off[2]["per_sample_norms"])
    g_on, g_off = flatten_dict(on[1]), flatten_dict(off[1])
    assert any(p.startswith("encoder/") for p in g_on)
    for path, leaf in g_on.items():
        assert torch.equal(leaf, g_off[path]), path
    assert float(g_on["encoder/attn/q/w"].abs().max()) > 0


def test_whisper_taps_and_fingerprint_match_jax():
    meta = assert_taps_match_jax(NAME, _batch())
    cfg = get_arch(NAME).reduced()
    # the cross k/v taps run over the frames, q over the text
    assert meta["decoder/xattn/k/out"].T == cfg.encoder_seq
    assert meta["decoder/xattn/q/out"].T == 20
    assert meta["decoder/xattn/k/out"].stack_dims == (cfg.n_layers,)
    assert meta["encoder/attn/q/out"].stack_dims == (cfg.encoder_layers,)
    assert meta["enc_pos/out"].kind == "embedding"


def test_whisper_serving_matches_jax():
    assert_serving_matches_jax(NAME, _batch(4))


def test_whisper_decode_equals_teacher_forced():
    assert_decode_equals_teacher_forced(NAME, _batch(5))


def test_whisper_model_and_cache_layout():
    _, _, model, _ = pair(NAME)
    assert isinstance(model, EncDecLM) and model.conv_weights == ()
    cfg = model.cfg
    state = model.init_state(3, 10)
    hd = cfg.d_model // cfg.n_heads
    assert state["cache"]["xkv"]["k"].shape == (cfg.n_layers, 3, cfg.encoder_seq, cfg.n_kv, hd)
    assert state["cache"]["kv"]["k"].shape == (cfg.n_layers, 3, 10, cfg.n_kv, hd)
    assert state["pos"].shape == (3,)


# -- the cross-attention module alone ---------------------------------------
def _cross_pair(b=2, sq=7, skv=11, d=16, h=4, blocks=4):
    j = jattn.Attention("xattn", d, h, h, use_rope=False, causal=False, cross=True,
                        block_q=blocks, block_kv=blocks)
    t = tattn.Attention("xattn", d, h, h, use_rope=False, causal=False, cross=True,
                        block_q=blocks, block_kv=blocks, device=torch.device("cpu"))
    params = jax.tree_util.tree_map(np.asarray, j.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, sq, d)).astype(np.float32)
    src = rng.standard_normal((b, skv, d)).astype(np.float32)
    w = rng.standard_normal((b, sq, d)).astype(np.float32)
    return j, t, params, x, src, w


def _tparams(params, grad=False):
    return jax.tree_util.tree_map(
        lambda a: torch.tensor(np.array(a), requires_grad=grad), params)


def test_cross_attention_training_matches_jax():
    """Sq 7 != Skv 11, both off the 4-row blocks: outputs and the gradients
    of every weight, of x and of the encoder states."""
    j, t, params, x, src, w = _cross_pair()

    def jloss(p, xx, ss):
        return jnp.sum(j(p, xx, JCtx.disabled(), kv_src=ss)[0] * w)

    jy = np.asarray(j(params, x, JCtx.disabled(), kv_src=src)[0])
    jgp, jgx, jgs = jax.grad(jloss, argnums=(0, 1, 2))(params, x, src)
    tp = _tparams(params, grad=True)
    tx, ts = torch.tensor(x, requires_grad=True), torch.tensor(src, requires_grad=True)
    ty = t(tp, tx, Ctx.disabled(), kv_src=ts)
    (ty * torch.as_tensor(w)).sum().backward()
    scale = float(np.abs(jy).max())
    assert float(np.abs(ty.detach().numpy() - jy).max()) <= TOL * scale
    for got, want in [(tx.grad, jgx), (ts.grad, jgs)] + [
            (tp[k]["w"].grad, jgp[k]["w"]) for k in ("q", "k", "v", "o")]:
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= TOL * float(np.abs(want).max())


def test_cross_attention_serving_matches_jax():
    """A prefill with kv_src fills the cache with the projections; a decode
    step (kv_src None) reads them."""
    j, t, params, x, src, _ = _cross_pair()
    b, skv = src.shape[:2]
    zeros = np.zeros((b, skv, 4, 4), np.float32)
    jy, jcache = j(params, x, JCtx.disabled(), cache={"k": zeros, "v": zeros}, kv_src=src)
    tcache = {"k": torch.zeros(b, skv, 4, 4), "v": torch.zeros(b, skv, 4, 4)}
    tp = _tparams(params)
    with torch.no_grad():
        ty, tcache = t(tp, torch.as_tensor(x), Ctx.disabled(), cache=tcache,
                       kv_src=torch.as_tensor(src))
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
        x1 = x[:, -1:] * 0.5
        jy1, _ = j(params, x1, JCtx.disabled(), cache=jcache)
        ty1, _ = t(tp, torch.as_tensor(x1), Ctx.disabled(), cache=tcache)
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="kv_src"):
        t(tp, torch.as_tensor(x), Ctx.disabled())


# -- blocked_decode_attention -----------------------------------------------
def test_blocked_decode_attention_matches_jax():
    """Per-lane positions (a ring with empty slots, lanes at different
    fill levels), GQA 4/2, a window, against the JAX function lane by
    lane."""
    rng = np.random.default_rng(9)
    b, s, h, kh, hd, nb = 3, 32, 4, 2, 8, 4
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    pos = np.full((b, s), -1, np.int64)
    pos[0, :10] = np.arange(10)
    pos[1] = (np.arange(s) + 40) % 64  # ring slots, some past the query
    pos[2, :] = np.arange(s)
    qpos = np.array([9, 63, 31])
    for window in (None, 12):
        got = tattn.blocked_decode_attention(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(pos),
            torch.as_tensor(qpos), n_blocks=nb, window=window).numpy()
        for lane in range(b):
            want = np.asarray(jattn.blocked_decode_attention(
                q[lane:lane + 1], k[lane:lane + 1], v[lane:lane + 1],
                jnp.asarray(pos[lane], jnp.int32), jnp.asarray(qpos[lane], jnp.int32),
                n_blocks=nb, window=window))
            np.testing.assert_allclose(got[lane:lane + 1], want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        tattn.blocked_decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                       torch.as_tensor(v), torch.as_tensor(pos),
                                       torch.as_tensor(qpos), n_blocks=5)


def test_blocked_decode_attention_wired_into_decode():
    """A cache at or past ``cp_threshold`` decodes through the blocked
    form: the same logits as the serving form below it."""
    common = dict(block_q=4, block_kv=4, device=torch.device("cpu"))
    small = tattn.Attention("attn", 16, 4, 2, cp_threshold=16, cp_blocks=4, **common)
    plain = tattn.Attention("attn", 16, 4, 2, **common)
    params = small.init(torch.Generator().manual_seed(0))
    x = torch.randn(2, 6, 16, generator=torch.Generator().manual_seed(1))
    outs = []
    for attn in (small, plain):
        cache = tattn.make_kv_cache(2, 16, 2, 4, torch.float32, device=torch.device("cpu"))
        with torch.no_grad():
            _, cache = attn(params, x, Ctx.disabled(), cache=cache)
            ys = [attn(params, x[:, i:i + 1], Ctx.disabled(), cache=cache,
                       positions=cache["idx"][:, None].clone())[0] for i in range(3)]
        outs.append(torch.cat(ys, dim=1))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-6)


# -- entry points ----------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_arch_batch_frames(dtype):
    cfg = dataclasses.replace(get_arch(NAME).reduced(), dtype=dtype)
    a = synthetic_arch_batch(cfg, batch=3, seq=16, step=2, device="cpu")
    assert a["tokens"].shape == a["labels"].shape == (3, 16)
    assert a["tokens"].dtype == torch.int64
    assert a["frames"].shape == (3, cfg.encoder_seq, cfg.d_model)
    assert a["frames"].dtype == getattr(torch, dtype)
    assert "prefix" not in a
    again = synthetic_arch_batch(cfg, batch=3, seq=16, step=2, device="cpu")
    assert torch.equal(a["frames"], again["frames"])
    other = synthetic_arch_batch(cfg, batch=3, seq=16, step=3, device="cpu")
    assert not torch.equal(a["frames"], other["frames"])


def test_serve_cli_wave_whisper():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", NAME, "--reduced",
         "--device", "cpu", "--max-new", "6"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "prefill" in out.stdout and "request 1:" in out.stdout


def test_serve_wave_stops_counting_at_eos():
    """A lane that emits EOS keeps stepping but emits -1; the count stops
    there, and the wave ends when every lane is done."""
    _, _, model, _ = pair(NAME)
    params = model.init(torch.Generator().manual_seed(0))
    args = dataclasses.make_dataclass("A", ["slots", "prompt_len", "max_new", "eos"])
    free = serve._serve_wave(model, model.cfg, params, args(3, 5, 8, -1))
    assert free["n_tokens"] == 3 * 8 and (free["tokens"] == free["stepped"]).all()
    eos = int(free["stepped"][0, 2])
    cut = serve._serve_wave(model, model.cfg, params, args(3, 5, 8, eos), keep_logits=True)
    assert torch.equal(cut["stepped"], free["stepped"][:, :cut["stepped"].shape[1]])
    for lane in cut["tokens"].tolist():
        if eos in lane:
            first = lane.index(eos)
            assert all(t == -1 for t in lane[first + 1:])
    assert cut["n_tokens"] == int((cut["tokens"] != -1).sum())
    assert len(cut["logits"]) == cut["tokens"].shape[1]


def test_tuner_cli_profiles_whisper(tmp_path):
    path = tmp_path / "plan.json"
    assert tuner_cli.main(["--arch", NAME, "--reduced", "--device", "cpu", "--batch", "2",
                           "--seq", "16", "--repeats", "1", "--warmup", "1",
                           "--skip-max-batch", "--plan", str(path)]) == 0
    assert path.exists()


def test_engine_refuses_whisper():
    _, _, model, _ = pair(NAME)
    with pytest.raises(NotImplementedError, match="fixed wave"):
        Engine(model, model.init(torch.Generator().manual_seed(0)), n_slots=1)
