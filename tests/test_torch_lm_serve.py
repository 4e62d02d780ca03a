"""The port's serving path, held against the JAX package on the CPU.

Reduced ``yi-6b`` (also with 2 KV heads for 4 query heads: the reduced
config keeps 4 = 4, MHA) and ``codeqwen1.5-7b`` (MHA, QKV bias): 4 layers,
d_model 64, vocab 128, fp32, the same numpy weights in both packages
(``repro_torch.interop``).  The recurrent archs at their reduced period of
8 layers: ``jamba-1.5-large-398b`` (Mamba and one attention layer, MoE on
every other layer: paged KV for the attention layer, dense per-lane state
for the Mamba layers) and ``xlstm-350m`` (sLSTM and mLSTM: no KV leaf, an
empty page pool).  Compared: ``DecoderLM.prefill`` and
``decode_step`` logits within 1e-5 of the largest |logit| (fp32: the same
math summed in another order), 2e-2 in bf16 compute (bf16 activations
rounded at other places over 4 layers); the port's ``Engine`` against the
port's ``sequential_decode`` and against the JAX ``Engine``, token for
token; and ports of the paging, allocator and SLO-admission tests of
``tests/test_serving.py``.
"""
import dataclasses
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import build_model as jbuild
from repro.serving import Engine as JEngine
from repro_torch import interop
from repro_torch.configs.registry import build_model, get_arch
from repro_torch.kernels import launches
from repro_torch.launch import serve
from repro_torch.serving import (
    Engine,
    LatencyModel,
    PageAllocator,
    Request,
    RequestQueue,
    aggregate_metrics,
    sequential_decode,
)
from repro_torch.serving.kv_pages import (
    NULL_PAGE,
    gather_views,
    is_kv_node,
    kv_paths,
    make_pools,
    scatter_prefill,
    scatter_rows,
    strip_kv,
)
from repro_torch.utils.tree import flatten_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

ARCH_CASES = {  # id -> (arch, KV heads override)
    "yi-6b": ("yi-6b", None),
    "yi-6b-gqa": ("yi-6b", 2),
    "codeqwen1.5-7b": ("codeqwen1.5-7b", None),
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b", None),
    "xlstm-350m": ("xlstm-350m", None),
}


def _cfgs(case, dtype="float32"):
    name, kv = ARCH_CASES[case]
    jcfg, tcfg = JARCHS[name].reduced(), get_arch(name).reduced()
    over = {"dtype": dtype, **({"n_kv": kv} if kv else {})}
    return dataclasses.replace(jcfg, **over), dataclasses.replace(tcfg, **over)


@functools.lru_cache(maxsize=None)
def _pair(case, dtype="float32"):
    """The JAX model, the port's model and both packages' params, from one
    JAX init (seed 0)."""
    jcfg, tcfg = _cfgs(case, dtype)
    jmodel, tmodel = jbuild(jcfg), build_model(tcfg, device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tmodel.conv_weights, device="cpu")
    return jmodel, tmodel, jparams, tparams


def _prompts(lengths, vocab, seed=11):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in 1 + rng.integers(0, vocab - 1, size=n)] for n in lengths]


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


# -- the model: prefill and decode logits against the JAX DecoderLM --------
@pytest.mark.parametrize("case,dtype,tol", [
    ("yi-6b", "float32", 1e-5), ("yi-6b-gqa", "float32", 1e-5),
    ("codeqwen1.5-7b", "float32", 1e-5), ("yi-6b-gqa", "bfloat16", 2e-2),
    ("jamba-1.5-large-398b", "float32", 1e-5), ("xlstm-350m", "float32", 1e-5),
])
def test_prefill_and_decode_logits_match_jax(case, dtype, tol):
    jmodel, tmodel, jparams, tparams = _pair(case, dtype)
    tokens = np.asarray(_prompts([9, 9], 128, seed=3))
    jstate, tstate = jmodel.init_state(2, 24), tmodel.init_state(2, 24)
    jlog, jstate = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, jstate)
    tlog, tstate = tmodel.prefill(tparams, {"tokens": torch.as_tensor(tokens)}, tstate)
    assert tuple(tlog.shape) == (2, 1, 128) and tlog.dtype == tmodel.dtype
    assert _rel(tlog.float(), jlog) < tol
    for _ in range(4):  # greedy on the JAX logits, the same tokens into both
        nxt = np.argmax(np.asarray(jlog.astype(jnp.float32))[:, -1:], axis=-1)
        jlog, jstate = jmodel.decode_step(jparams, jnp.asarray(nxt, jnp.int32), jstate)
        tlog, tstate = tmodel.decode_step(tparams, torch.as_tensor(nxt), tstate)
        assert _rel(tlog.float(), jlog) < tol
    assert tstate["pos"].tolist() == [13, 13]


def test_prefill_and_decode_leave_the_callers_state_untouched():
    _, tmodel, _, tparams = _pair("yi-6b-gqa")
    state = tmodel.init_state(1, 16)
    before = {k: v.clone() for k, v in flatten_dict(state).items()}
    _, filled = tmodel.prefill(tparams, {"tokens": torch.tensor([[3, 4, 5]])}, state)
    tmodel.decode_step(tparams, torch.tensor([[6]]), filled)
    for k, v in flatten_dict(state).items():
        assert torch.equal(v, before[k]), k
    kv = filled["cache"]["kv"]
    assert kv["k"].shape == (4, 1, 16, 2, 16)  # (L, B, length, K, hd)
    assert kv["pos"][:, 0, :4].tolist() == [[0, 1, 2, -1]] * 4
    assert kv["idx"].tolist() == [[3]] * 4


def test_scanned_stack_init_draws_layer_by_layer():
    """The preallocated init equals stacking the layers' inits drawn in order."""
    _, tmodel, _, _ = _pair("yi-6b-gqa")
    stack = tmodel.layers
    got = flatten_dict(stack.init(torch.Generator().manual_seed(5)))
    gen = torch.Generator().manual_seed(5)
    layers = [flatten_dict(stack.block.init(gen)) for _ in range(stack.n)]
    for path, leaf in got.items():
        assert torch.equal(leaf, torch.stack([layer[path] for layer in layers])), path


def test_ring_prefill_matches_jax():
    """A window shorter than the cache: the prompt runs the ring prefill
    branch, then decode wraps around the ring."""
    jcfg, tcfg = _cfgs("yi-6b-gqa")
    jcfg, tcfg = (dataclasses.replace(c, window=6) for c in (jcfg, tcfg))
    jmodel, tmodel = jbuild(jcfg), build_model(tcfg, device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(1))
    tparams = interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tmodel.conv_weights, device="cpu")
    tokens = np.asarray(_prompts([10], 128, seed=2))
    jstate, tstate = jmodel.init_state(1, 16), tmodel.init_state(1, 16)
    assert tstate["cache"]["kv"]["k"].shape[2] == 6  # the ring holds the window
    jlog, jstate = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, jstate)
    tlog, tstate = tmodel.prefill(tparams, {"tokens": torch.as_tensor(tokens)}, tstate)
    assert _rel(tlog, jlog) < 1e-5
    for _ in range(3):
        nxt = np.argmax(np.asarray(jlog)[:, -1:], axis=-1)
        jlog, jstate = jmodel.decode_step(jparams, jnp.asarray(nxt, jnp.int32), jstate)
        tlog, tstate = tmodel.decode_step(tparams, torch.as_tensor(nxt), tstate)
        assert _rel(tlog, jlog) < 1e-5


def test_registry_builds_every_lm_family():
    """Every LM arch of the JAX registry builds: the dense, MoE, hybrid and
    SSM LMs and the VLM as ``DecoderLM``, Whisper (audio) as ``EncDecLM``,
    and the VLM and encoder-decoder prefill and decode; an unknown name
    is a KeyError."""
    from repro.configs.registry import ARCHS as JAX_ARCHS

    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.lm import DecoderLM

    assert get_arch("yi_6b").name == "yi-6b"
    assert get_arch("mixtral_8x7b").name == "mixtral-8x7b"
    lm_archs = {k for k, c in JAX_ARCHS.items() if c.family not in ("cnn", "vit")}
    assert lm_archs <= set(ARCHS)
    for name in ("jamba-1.5-large-398b", "xlstm-350m", "phi-3-vision-4.2b",
                 "whisper-large-v3"):
        model = build_model(get_arch(name).reduced(), device="cpu")
        assert model.cfg.name == name and model.device.type == "cpu"
        assert isinstance(model, EncDecLM if name == "whisper-large-v3" else DecoderLM)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    # a prefix on a dense config builds a VLM that prefills and decodes
    prefix = dataclasses.replace(get_arch("yi-6b").reduced(), family="vlm", prefix_tokens=4,
                                 prefix_dim=16)
    model = build_model(prefix, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits, state = model.prefill(params, {"tokens": torch.ones(2, 5, dtype=torch.long),
                                               "prefix": torch.randn(2, 4, 16)},
                                      model.init_state(2, 12))
        assert state["pos"].tolist() == [9, 9]  # the prefix counts
        logits, state = model.decode_step(params, logits.argmax(-1), state)
    assert logits.shape == (2, 1, prefix.vocab) and state["pos"].tolist() == [10, 10]
    with pytest.raises(ValueError, match="EncDecLM"):
        DecoderLM(get_arch("whisper-large-v3").reduced(), device="cpu")


# -- the engine: the port's Engine == its sequential_decode == the JAX Engine
def _engine_tokens(model, params, prompts, *, max_new, **kw):
    engine = Engine(model, params, **kw)
    for p in prompts:
        engine.submit(p, max_new=max_new)
    completions = engine.drain(max_steps=300)
    return engine, completions, [completions[i].tokens for i in range(len(prompts))]


@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_engine_matches_sequential_decode(case):
    """Slot-recycled, paged, mixed-length continuous batching == sequential
    greedy decode, token for token."""
    _, model, _, params = _pair(case)
    prompts = _prompts([5, 9, 3, 7, 4], 128)
    engine, completions, got = _engine_tokens(model, params, prompts, max_new=5,
                                              n_slots=2, page_size=8, max_len=24)
    want = sequential_decode(model, params, prompts, max_new=5, view_len=engine.view_len)
    assert got == want
    assert all(completions[i].finish == "length" for i in range(len(prompts)))


def test_engine_slot_recycled_on_next_step():
    """A freed slot takes the next queued request on the very next step."""
    _, model, _, params = _pair("codeqwen1.5-7b")
    p0, p1 = _prompts([4, 6], 128)
    engine = Engine(model, params, n_slots=1, page_size=8, max_len=16)
    engine.submit(p0, max_new=2)
    engine.submit(p1, max_new=2)
    first = engine.step()  # admit r0 (prefill token) + decode (finishes r0)
    assert [rid for rid, _ in first] == [0, 0]
    assert engine.completions[0].finish == "length"
    second = engine.step()  # the freed slot must host r1 immediately
    assert [rid for rid, _ in second] == [1, 1]
    assert engine.completions[1].finish == "length"


def test_engine_eos_stops_stream_exactly():
    """Post-EOS tokens are never emitted or counted; the truncated stream
    still matches the sequential oracle under the same EOS."""
    _, model, _, params = _pair("codeqwen1.5-7b")
    prompts = _prompts([6, 5, 8], 128, seed=23)
    view_len = Engine(model, params, n_slots=3, page_size=8, max_len=24).view_len
    free_run = sequential_decode(model, params, prompts, max_new=8, view_len=view_len)
    eos = next((t for out in free_run for t in out[:-1]), None)  # fires mid-stream
    assert eos is not None
    engine = Engine(model, params, n_slots=3, page_size=8, max_len=24, eos_id=eos)
    for p in prompts:
        engine.submit(p, max_new=8)
    completions = engine.drain(max_steps=300)
    want = sequential_decode(model, params, prompts, max_new=8, view_len=view_len, eos_id=eos)
    assert [completions[i].tokens for i in range(len(prompts))] == want
    for c in completions.values():
        assert eos not in c.tokens[:-1]  # nothing emitted past the EOS
        if c.finish == "eos":
            assert c.tokens[-1] == eos
    assert aggregate_metrics(completions)["tokens"] == sum(len(t) for t in want)


def test_engine_exact_with_starved_page_pool():
    """A pool too small for all slots at once forces requests to wait for
    page recycling; outputs still match sequential decode."""
    _, model, _, params = _pair("yi-6b-gqa")
    prompts = _prompts([7, 6, 5, 8], 128, seed=41)
    engine, _, got = _engine_tokens(model, params, prompts, max_new=4, n_slots=2,
                                    page_size=8, max_len=16, pool_pages=3)
    want = sequential_decode(model, params, prompts, max_new=4, view_len=engine.view_len)
    assert got == want


def test_engine_rejects_oversized_and_unsupported():
    _, model, _, params = _pair("codeqwen1.5-7b")
    engine = Engine(model, params, n_slots=1, page_size=8, max_len=16)
    with pytest.raises(ValueError):
        engine.submit(list(range(1, 14)), max_new=8)  # 13 + 7 > 16
    with pytest.raises(ValueError):
        engine.submit([], max_new=2)
    # the encoder-frontend families build, and the engine refuses them (they
    # serve as one fixed wave, launch/serve.py), as the JAX engine does
    for name in ("phi-3-vision-4.2b", "whisper-large-v3"):
        other = build_model(get_arch(name).reduced(), device="cpu")
        with pytest.raises(NotImplementedError, match="fixed wave"):
            Engine(other, other.init(torch.Generator().manual_seed(0)), n_slots=1)
    vlm = dataclasses.replace(model.cfg, family="vlm", prefix_tokens=4, prefix_dim=16)
    vlm_model = build_model(vlm, device="cpu")
    with pytest.raises(NotImplementedError):
        Engine(vlm_model, vlm_model.init(torch.Generator().manual_seed(0)), n_slots=1)


@pytest.mark.parametrize("case", ["yi-6b-gqa", "codeqwen1.5-7b", "jamba-1.5-large-398b",
                                  "xlstm-350m"])
def test_engine_matches_jax_engine(case):
    jmodel, tmodel, jparams, tparams = _pair(case)
    prompts = _prompts([5, 9, 3], 128, seed=7)
    kw = dict(n_slots=2, page_size=8, max_len=16)
    jengine = JEngine(jmodel, jparams, **kw)
    for p in prompts:
        jengine.submit(p, max_new=4)
    jdone = jengine.drain(max_steps=100)
    _, _, got = _engine_tokens(tmodel, tparams, prompts, max_new=4, **kw)
    assert got == [jdone[i].tokens for i in range(len(prompts))]


def test_engine_launches_one_flash_per_layer_per_prefill():
    """Every prefill runs the kernel's function once per layer (the plain
    version on the CPU); decode runs the serving form, which counts none."""
    _, model, _, params = _pair("yi-6b-gqa")
    launches.reset()
    _engine_tokens(model, params, _prompts([5, 9, 3], 128), max_new=4, n_slots=2,
                   page_size=8, max_len=16)
    assert launches.snapshot()["flash_attention"] == {"cuda": 0, "torch": 3 * 4, "fake": 0}


def test_engine_steps_leave_no_reference_cycles():
    """A step's KV views and states are freed when the step returns, not at
    the next garbage collection: a cycle holding them piled up ~0.5 GiB per
    decode step of Yi-6B on the card."""
    _, model, _, params = _pair("yi-6b-gqa")
    engine = Engine(model, params, n_slots=2, page_size=8, max_len=16)
    for p in _prompts([5, 9, 3], 128):
        engine.submit(p, max_new=4)
    gc.collect()
    gc.disable()
    try:
        for _ in range(3):
            engine.step()
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not cyclic


def test_serve_cli_on_cpu(capsys):
    assert serve.main(["--arch", "yi-6b", "--reduced", "--device", "cpu", "--requests", "3",
                       "--prompt-len", "6", "--max-new", "4", "--slots", "2"]) == 0
    assert "3 requests (0 shed): 12 tokens" in capsys.readouterr().out


# -- kv_pages ---------------------------------------------------------------
def test_kv_pages_roundtrip_and_classification():
    kv = {"k": torch.zeros(2, 1, 16, 2, 4), "v": torch.zeros(2, 1, 16, 2, 4),
          "pos": torch.full((2, 1, 16), -1), "idx": torch.zeros(2, 1, dtype=torch.long)}
    tree = {"blocks": {"kv": kv, "mamba": {"conv": torch.zeros(2, 1, 3)}}}
    assert is_kv_node(kv)
    assert not is_kv_node({"k": 0, "v": 0})
    assert kv_paths(tree) == [("blocks", "kv")]
    dense = strip_kv(tree)
    assert set(dense["blocks"]["kv"]) == {"pos", "idx"}
    assert dense["blocks"]["mamba"]["conv"].shape == (2, 1, 3)

    pools = make_pools(tree, n_pages=5, page=8)
    leaf = torch.randn(2, 1, 16, 2, 4, generator=torch.Generator().manual_seed(0))
    state_kv = {("blocks", "kv"): {"k": leaf, "v": 2.0 * leaf}}
    pools = scatter_prefill(pools, state_kv, torch.tensor([3, 1]))
    table = torch.tensor([[3, 1], [NULL_PAGE, NULL_PAGE]])
    views = gather_views(pools, table)
    got = views[("blocks", "kv")]["k"]
    assert got.shape == (2, 2, 16, 2, 4)  # (stack, n_slots, L, K, hd)
    assert torch.equal(got[:, 0], leaf[:, 0])
    # single-row decode writes land at (page, offset) derived from position
    row = {("blocks", "kv"): {"k": torch.ones(2, 2, 2, 4), "v": torch.ones(2, 2, 2, 4)}}
    pools = scatter_rows(pools, row, torch.tensor([1, NULL_PAGE]), torch.tensor([2, 0]))
    views = gather_views(pools, table)
    assert bool((views[("blocks", "kv")]["k"][:, 0, 10] == 1.0).all())


def test_page_allocator_reserve_release():
    alloc = PageAllocator(n_pages=5, page=8)  # pages 1..4 allocatable
    assert alloc.free_pages == 4
    got = alloc.reserve(17)  # 3 pages
    assert got is not None and len(got) == 3 and NULL_PAGE not in got
    assert alloc.reserve(17) is None  # only 1 left
    one = alloc.reserve(3)
    assert one is not None and len(one) == 1
    alloc.release(got)
    assert alloc.free_pages == 3
    with pytest.raises(ValueError):
        alloc.release([NULL_PAGE])


# -- SLO admission ----------------------------------------------------------
def test_slo_admission_sheds_on_projected_ttft():
    model = LatencyModel()
    q = RequestQueue(model)
    # cold start: no observations -> everything admits
    assert q.offer(Request(0, [1, 2, 3], slo_ttft_ms=0.001), free_slots=0,
                   active_remaining=[50])
    model.observe_prefill(10, 1.0)  # 100ms per prompt token
    model.observe_step(0.5)  # 500ms per decode step
    # slot free: projection is prefill-only (400ms)
    q2 = RequestQueue(model)
    assert q2.offer(Request(1, [1] * 4, slo_ttft_ms=500.0), free_slots=2, active_remaining=[])
    # no slot free, 3 steps until one frees: 3*500 + 2*100 = 1700ms
    q3 = RequestQueue(model)
    assert not q3.offer(Request(2, [1] * 2, slo_ttft_ms=1000.0), free_slots=0,
                        active_remaining=[3, 9])
    assert [r.rid for r in q3.shed] == [2]
    # a shed request never queues, so the next offer projects from the
    # front again: 1700ms clears a 2s deadline
    assert q3.offer(Request(3, [1] * 2, slo_ttft_ms=2000.0), free_slots=0,
                    active_remaining=[3, 9])
    # behind request 3 the projection is 9 steps (4700ms) and sheds
    assert not q3.offer(Request(4, [1] * 2, slo_ttft_ms=2000.0), free_slots=0,
                        active_remaining=[3, 9])
    # no deadline -> never shed
    assert q3.offer(Request(5, [1] * 64), free_slots=0, active_remaining=[9])


def test_engine_sheds_against_measured_latency():
    _, model, _, params = _pair("codeqwen1.5-7b")
    engine = Engine(model, params, n_slots=1, page_size=8, max_len=16)
    engine.latency.observe_prefill(1, 10.0)  # pretend prefill costs 10s/token
    engine.latency.observe_step(10.0)
    rid, admitted = engine.submit([3, 4, 5], max_new=2, slo_ttft_ms=1.0)
    assert not admitted
    assert engine.completions[rid].finish == "shed"
    rid2, admitted2 = engine.submit([3, 4, 5], max_new=2)  # no SLO: runs
    assert admitted2
    completions = engine.drain(max_steps=50)
    assert completions[rid2].finish == "length"
    m = aggregate_metrics(completions)
    assert m["shed"] == 1 and m["requests"] == 1
