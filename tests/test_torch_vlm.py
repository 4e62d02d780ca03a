"""The VLM family (Phi-3-vision-4.2b) in the port, held against the JAX
package and against itself on the CPU.

Reduced Phi-3-vision (d_model 64, 4 heads of 16, 4 layers, a 4 x 16 patch
prefix, vocab 128, attention blocks of 16) with the JAX package's numpy
parameters (``torch_lm_family``), 2 samples of 4 prefix positions and 20
tokens:

- against the JAX package, fp32 at 1e-5: the loss, per-sample norms and
  clipped sums in ``non_private``, ``mixed_ghost``, ``bk_mixed`` and
  ``bk_mixed_taps`` (the JAX ``*_taps`` reference without remat), the taps
  (``prefix_proj`` over the prefix positions) and plan fingerprint, the
  prefill's and three decode steps' logits (``pos`` counting the prefix);
- within the port: every clipped mode against its ``vmap`` (5e-5), remat
  on == off bit for bit, decode against the teacher-forced forward, the
  serve CLI's fixed wave, the tuner CLI, the engine's refusal, and
  ``synthetic_arch_batch``'s prefix.

The head-dim-96 attention of the full config is held in
``test_torch_flash_attention.py`` (plain against the interpreted Pallas
kernel) and on the card in ``test_torch_cuda.py``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import interop
from repro_torch.configs.registry import build_model, get_arch
from repro_torch.core.taps import Ctx
from repro_torch.data.synthetic import synthetic_arch_batch
from repro_torch.models.losses import per_sample_xent
from repro_torch.models.lm import DecoderLM
from repro_torch.serving import Engine
from repro_torch.tuner import cli as tuner_cli
from repro_torch.utils.tree import flatten_dict
from torch_lm_family import (
    JAX_MODES,
    PORT_MODES,
    assert_decode_equals_teacher_forced,
    assert_matches_jax,
    assert_matches_port_vmap,
    assert_serving_matches_jax,
    assert_taps_match_jax,
    np_batch,
    pair,
    port_params,
    run_port,
)
from torch_threads import torch_threads_per_worker  # noqa: F401

NAME = "phi-3-vision-4.2b"
ROOT = Path(__file__).resolve().parents[1]


def _batch(seed: int = 1) -> dict:
    return np_batch(get_arch(NAME).reduced(), seed)


@pytest.mark.parametrize("mode", JAX_MODES)
def test_vlm_clipped_step_matches_jax(mode):
    assert_matches_jax(NAME, mode, _batch())


@pytest.mark.parametrize("mode", PORT_MODES)
def test_vlm_mode_matches_port_vmap(mode):
    assert_matches_port_vmap(NAME, mode, _batch(2))


@pytest.mark.parametrize("mode", ["mixed_ghost", "bk_mixed", "bk_mixed_taps"])
def test_vlm_remat_on_equals_off(mode):
    cfg = dataclasses.replace(get_arch(NAME).reduced(), remat=False)
    batch = _batch(3)
    on = run_port(NAME, mode, batch)
    off = run_port(NAME, mode, batch, model=build_model(cfg, device="cpu"))
    assert torch.equal(on[0], off[0])
    assert torch.equal(on[2]["per_sample_norms"], off[2]["per_sample_norms"])
    g_on, g_off = flatten_dict(on[1]), flatten_dict(off[1])
    for path, leaf in g_on.items():
        assert torch.equal(leaf, g_off[path]), path
    assert float(g_on["prefix_proj/w"].abs().max()) > 0


def test_vlm_taps_and_fingerprint_match_jax():
    meta = assert_taps_match_jax(NAME, _batch())
    cfg = get_arch(NAME).reduced()
    proj = meta["prefix_proj/out"]
    assert (proj.kind, proj.T, proj.D, proj.p) == ("matmul", cfg.prefix_tokens,
                                                   cfg.prefix_dim, cfg.d_model)
    assert proj.bias_path == "prefix_proj/b"
    # the layers run over prefix and text, the embedding over the text only
    assert meta["layers/attn/q/out"].T == cfg.prefix_tokens + 20
    assert meta["embed/out"].T == 20


def test_vlm_serving_matches_jax():
    assert_serving_matches_jax(NAME, _batch(4))


def test_vlm_decode_equals_teacher_forced():
    assert_decode_equals_teacher_forced(NAME, _batch(5))


def test_vlm_loss_drops_the_prefix_positions():
    """The loss is the cross-entropy of the text positions' logits: one row
    per token after the prefix, none for the prefix itself."""
    _, _, model, _ = pair(NAME)
    assert isinstance(model, DecoderLM)
    params = port_params(NAME)
    batch = interop.batch_from_numpy(_batch(6), device="cpu")
    with torch.no_grad():
        logits = model.forward_logits(params, batch)
        loss = model.loss_with_ctx(params, batch, Ctx.disabled())
    assert logits.shape == (2, 20, model.cfg.vocab)
    torch.testing.assert_close(loss, per_sample_xent(logits, batch["labels"], batch["mask"]),
                               rtol=0, atol=0)


# -- entry points ----------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_arch_batch_prefix(dtype):
    cfg = dataclasses.replace(get_arch(NAME).reduced(), dtype=dtype)
    a = synthetic_arch_batch(cfg, batch=3, seq=16, step=2, device="cpu")
    # the text fills the length the prefix leaves
    assert a["tokens"].shape == a["labels"].shape == (3, 16 - cfg.prefix_tokens)
    assert a["prefix"].shape == (3, cfg.prefix_tokens, cfg.prefix_dim)
    assert a["prefix"].dtype == getattr(torch, dtype)
    assert "frames" not in a
    again = synthetic_arch_batch(cfg, batch=3, seq=16, step=2, device="cpu")
    assert torch.equal(a["prefix"], again["prefix"])
    with pytest.raises(ValueError, match="no text"):
        synthetic_arch_batch(cfg, batch=1, seq=cfg.prefix_tokens, device="cpu")


def test_serve_cli_wave_vlm():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", NAME, "--reduced",
         "--device", "cpu", "--max-new", "6"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "prefill" in out.stdout and "request 1:" in out.stdout


def test_tuner_cli_profiles_vlm(tmp_path):
    path = tmp_path / "plan.json"
    assert tuner_cli.main(["--arch", NAME, "--reduced", "--device", "cpu", "--batch", "2",
                           "--seq", "16", "--repeats", "1", "--warmup", "1",
                           "--skip-max-batch", "--plan", str(path)]) == 0
    assert path.exists()


def test_engine_refuses_vlm():
    _, _, model, _ = pair(NAME)
    with pytest.raises(NotImplementedError, match="fixed wave"):
        Engine(model, model.init(torch.Generator().manual_seed(0)), n_slots=1)
