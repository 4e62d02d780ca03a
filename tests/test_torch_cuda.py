"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and ``nvcc``; elsewhere they skip.  The file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs with the repository's conftest left out:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import dispatch, launches
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.ghost_norm import ghost_norm as gn
from repro_torch.kernels.psg_contract import psg_contract as pc

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,t,d,p", [
    (3, 37, 33, 7), (2, 1, 512, 10), (4, 100, 130, 70), (8, 16, 300, 40), (2, 256, 64, 32),
    (9, 4, 4608, 512),  # T = 4: 4 samples a packed tile, the last tile 1 of 4
    (7, 3, 70, 9),  # T = 3: 5 samples a tile, D and p odd (no pair loads)
    (4, 16, 4608, 512),  # T = 16 with VGG-19's widest fan-in
    (2, 196, 3072, 768),  # ViT-Base's MLP tap: 4 x 4 tiles of 64, 10 pairs
    (3, 65, 40, 24),  # T one past the 64 tile
    (2, 9, 17, 5),  # T = 9: one sample a tile
])
def test_ghost_norm_kernel(gen, n, t, d, p, dtype):
    a, g = _rnd(gen, n, t, d, dtype=dtype), _rnd(gen, n, t, p, dtype=dtype)
    launches.reset()
    got = gn.ghost_norm_sq_cuda(a, g)
    assert launches.snapshot()["ghost_norm_sq"] == {"cuda": 1, "torch": 0, "fake": 0}
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert _rel(got, gn.ghost_norm_sq_plain(a, g)) < 1e-4
    assert torch.equal(got, gn.ghost_norm_sq_cuda(a, g))  # deterministic


# (N, H, W, C), kernel, strides, padding: VGG-19's conv taps at T = 64, 16
# and 4 (3x3 SAME, C a multiple of the k-step: 16-byte chunks), stride 2
# (XLA's (0, 1) padding), C not a multiple of 4 or 8 (element loads), odd C
# (no pair loads), T = 1, explicit pads, a 1x1 kernel, and the ViT's 16x16 /
# 16 patch embedding (C = 3, VALID: 16-byte chunks along a patch row)
CONV_CASES = [
    ((3, 8, 8, 256), (3, 3), (1, 1), "SAME"),
    ((5, 4, 4, 512), (3, 3), (1, 1), "SAME"),
    ((9, 2, 2, 512), (3, 3), (1, 1), "SAME"),
    ((3, 16, 16, 128), (3, 3), (1, 1), "SAME"),
    ((3, 9, 9, 64), (3, 3), (2, 2), "SAME"),
    ((2, 11, 9, 6), (3, 3), (1, 1), "SAME"),
    ((2, 10, 7, 5), (3, 2), (2, 1), "VALID"),
    ((4, 3, 3, 12), (3, 3), (1, 1), "VALID"),
    ((2, 12, 12, 8), (3, 3), (1, 2), ((2, 0), (1, 1))),
    ((3, 5, 5, 33), (1, 1), (1, 1), "SAME"),
    ((2, 224, 224, 3), (16, 16), (16, 16), "VALID"),
]


@pytest.mark.parametrize("x_dtype,g_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("shape,kernel,strides,padding", CONV_CASES)
def test_conv_ghost_norm_kernel(gen, shape, kernel, strides, padding, x_dtype, g_dtype):
    """The conv entry (patches built on chip from the raw NHWC input) against
    ghost_norm_sq(unfold2d(x), g) within 1e-4, deterministic, one
    ghost_norm_sq launch."""
    from repro_torch.core.taps import ConvInfo
    from repro_torch.nn.conv import conv_padding

    info = ConvInfo(kernel=kernel, strides=strides, padding=padding)
    n, h, w, _ = shape
    (pt, pb), (pl, pr) = conv_padding(padding, (h, w), kernel, strides)
    t = (((h + pt + pb - kernel[0]) // strides[0] + 1)
         * ((w + pl + pr - kernel[1]) // strides[1] + 1))
    x, g = _rnd(gen, *shape, dtype=x_dtype), _rnd(gen, n, t, 24, dtype=g_dtype)
    launches.reset()
    got = gn.conv_ghost_norm_sq_cuda(x, g, info)
    assert launches.snapshot()["ghost_norm_sq"] == {"cuda": 1, "torch": 0, "fake": 0}
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert _rel(got, gn.conv_ghost_norm_sq_plain(x, g, info)) < 1e-4
    assert torch.equal(got, gn.conv_ghost_norm_sq_cuda(x, g, info))  # deterministic


def test_ghost_norm_kernel_mixed_dtypes(gen):
    """The activation and the cotangent may differ in dtype (a bf16 model's
    activation with an fp32 cotangent); the kernel reads each in its own."""
    a, g = _rnd(gen, 4, 196, 96, dtype=torch.bfloat16), _rnd(gen, 4, 196, 48)
    got = gn.ghost_norm_sq_cuda(a, g)
    assert _rel(got, gn.ghost_norm_sq_plain(a, g)) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,t,vocab,p,skewed", [
    (32, 196, 196, 64, False),  # the ViT's position ids: all distinct
    (3, 37, 5, 33, False),  # repeated ids, rows off the 16-byte copy
    (4, 100, 1000, 70, False),
    (2, 1, 3, 10, False),  # T = 1
    (5, 16, 4, 130, False),
    (4, 2048, 64000, 256, True),  # the LM shape at a reduced p, Zipf-skewed ids
    (2, 3000, 1, 64, False),  # every id equal: one segment over all the ranges
    (2, 8192, 1, 64, False),  # every id equal at a long T: the sort makes no pass
    (1, 8192, 64000, 128, False),  # N = 1 at a long T
    (2, 40000, 300, 8, False),  # T above the sort's shared memory: the workspace
    (1, 40000, 1, 8, False),  # the workspace, every id equal
])
def test_embedding_ghost_norm_kernel(gen, n, t, vocab, p, skewed, dtype, id_dtype):
    if vocab == t:
        ids = torch.arange(t, device="cuda").expand(n, t)
    elif skewed:  # P(id k) ~ (k + 1)^-1.1
        w = torch.arange(1, vocab + 1, device="cuda", dtype=torch.float64).pow(-1.1)
        ids = torch.multinomial(w, n * t, replacement=True, generator=gen).view(n, t)
    else:
        ids = torch.randint(0, vocab, (n, t), generator=gen, device="cuda")
    ids = ids.to(id_dtype).contiguous()
    g = _rnd(gen, n, t, p, dtype=dtype)
    launches.reset()
    got = gn.embedding_ghost_norm_sq_cuda(ids, g)
    assert launches.snapshot()["embedding_ghost_norm_sq"] == {"cuda": 1, "torch": 0, "fake": 0}
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert _rel(got, gn.embedding_ghost_norm_sq_plain(ids, g)) < 1e-4
    assert torch.equal(got, gn.embedding_ghost_norm_sq_cuda(ids, g))  # deterministic


BOOK_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("a_dtype,g_dtype", BOOK_PAIRS)
@pytest.mark.parametrize("m,r,d,p", [
    (3, 37, 33, 130), (1, 1, 5, 3), (2, 1000, 70, 9),
    (1, 8192, 130, 70),  # M = 1 at VGG-19's R: R split across blocks, D and p off the tile
    (2, 5, 70, 9),  # R under one 32-row k-step
    (3, 300, 129, 257),  # D and p one past the 128 tile
])
def test_book_weighted_grad_kernel(gen, m, r, d, p, a_dtype, g_dtype):
    """The tensor-core book kernel (split operands, split R) against the
    plain version within 1e-4 of the largest entry, deterministic, with one
    launch for the tiles and one more for the split sum where R is split."""
    a, g = _rnd(gen, m, r, d, dtype=a_dtype), _rnd(gen, m, r, p, dtype=g_dtype)
    w = torch.rand(m, r, generator=gen, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, _ = pc.book_splits(m, r, d, p, sms)
    launches.reset()
    got = pc.book_weighted_grad_cuda(a, g, w)
    assert launches.snapshot()["book_weighted_grad"] == {"cuda": 1 + (splits > 1), "torch": 0,
                                                          "fake": 0}
    assert _rel(got, pc.book_weighted_grad_plain(a, g, w)) < 1e-4
    assert torch.equal(got, pc.book_weighted_grad_cuda(a, g, w))  # deterministic
    if (m, r) == (1, 8192):
        assert splits > 1


def test_book_split_count_is_reproducible(gen):
    """The split of R is a pure function of (M, R, D, p, SM count): the same
    on every call, and the same result bits from a fresh copy of the inputs."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shape = (1, 8192, 1152, 256)  # VGG-19's conv taps at batch 128
    first = pc.book_splits(*shape, sms)
    assert all(pc.book_splits(*shape, sms) == first for _ in range(3))
    assert first[0] > 1 and first[0] * first[1] >= shape[1]
    m, r, d, p = shape
    a, g = _rnd(gen, m, r, d), _rnd(gen, m, r, p)
    w = torch.rand(m, r, generator=gen, device="cuda")
    got = pc.book_weighted_grad_cuda(a, g, w)
    assert torch.equal(got, pc.book_weighted_grad_cuda(a.clone(), g.clone(), w.clone()))


# (M, R, D, p) and dtype of every book contraction of one VGG-19 batch-128
# fp32 step and one ViT-Base/16 batch-32 bf16 step (M = 12 on the stacked
# layers), as the models' taps give them
BOOK_MAIN_SHAPES = [
    ((1, 128, 512, 10), torch.float32), ((1, 512, 4608, 512), torch.float32),
    ((1, 2048, 2304, 512), torch.float32), ((1, 2048, 4608, 512), torch.float32),
    ((1, 8192, 1152, 256), torch.float32), ((1, 8192, 2304, 256), torch.float32),
    ((1, 32, 768, 10), torch.bfloat16), ((1, 6272, 768, 768), torch.bfloat16),
    ((12, 6272, 768, 768), torch.bfloat16), ((12, 6272, 768, 3072), torch.bfloat16),
    ((12, 6272, 3072, 768), torch.bfloat16),
]


@pytest.mark.parametrize("shape,dtype", BOOK_MAIN_SHAPES)
def test_book_plain_form_matches_einsum(gen, shape, dtype):
    """The plain book contraction (a weighted bmm, the reference the kernel
    is held to) against the three-operand einsum it replaced, in fp64 and
    with ``w`` listed second so no (M, R, D, p) intermediate is formed."""
    m, r, d, p = shape
    a, g = _rnd(gen, m, r, d, dtype=dtype), _rnd(gen, m, r, p, dtype=dtype)
    w = torch.rand(m, r, generator=gen, device="cuda")
    want = torch.einsum("mrd,mr,mrp->mdp", a.double(), w.double(), g.double())
    assert _rel(pc.book_weighted_grad_plain(a, g, w).double(), want) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,f", [(5, 33), (1, 1), (130, 2049)])
def test_psg_contract_kernel(gen, n, f, dtype):
    psg = _rnd(gen, n, f, dtype=dtype)
    c = torch.rand(n, generator=gen, device="cuda")
    got = pc.psg_contract_cuda(psg, c)
    assert _rel(got, pc.psg_contract_plain(psg, c)) < 1e-5


def _bank(gen, n, f, off=0, dtype=torch.float32):
    """A contiguous (n, f) bank that starts ``off`` elements into its buffer."""
    return _rnd(gen, n * f + off, dtype=dtype)[off:].view(n, f)


BF = torch.bfloat16
# (N, [(F, element offset, dtype), ...]): F = 1, odd F, F a multiple of 4,
# banks off the 16-byte line, bf16 and mixed lists, N = 1 and 130
GROUPED_CASES = {
    "ragged": (5, [(33, 0, None), (1, 0, None), (7, 0, None), (1000, 0, None), (256, 0, None)]),
    "ragged_bf16": (5, [(33, 0, BF), (1, 0, BF), (7, 0, BF), (1000, 0, BF), (256, 0, BF)]),
    "n1": (1, [(1, 0, None), (4, 0, BF), (129, 0, None)]),
    "unaligned_mixed": (130, [(2049, 0, None), (64, 1, BF), (1, 0, None), (512, 3, None),
                              (4096, 0, BF), (8, 2, BF)]),
}


@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_psg_contract_grouped_kernel(gen, case):
    """One launch for the list, every segment within 1e-5 of the plain
    version's (relative to the largest entry), deterministic."""
    n, segs = GROUPED_CASES[case]
    psgs = [_bank(gen, n, f, off, dtype or torch.float32) for f, off, dtype in segs]
    c = torch.rand(n, generator=gen, device="cuda")
    launches.reset()
    got = pc.psg_contract_grouped_cuda(psgs, c)
    assert launches.snapshot()["psg_contract"] == {"cuda": 1, "torch": 0, "fake": 0}
    assert got.shape == (sum(f for f, _, _ in segs),)
    assert _rel(got, pc.psg_contract_grouped_plain(psgs, c)) < 1e-5
    assert torch.equal(got, pc.psg_contract_grouped_cuda(psgs, c))


def test_psg_contract_grouped_kernel_chunks_a_long_list(gen):
    """300 segments: more than one launch's parameter block holds
    (pc.MAX_SEGMENTS), so two launches; the sums as from the plain version."""
    sizes = [1 + (7 * i) % 50 for i in range(300)]
    psgs = [_bank(gen, 3, f) for f in sizes]
    c = torch.rand(3, generator=gen, device="cuda")
    launches.reset()
    got = pc.psg_contract_grouped_cuda(psgs, c)
    assert launches.snapshot()["psg_contract"]["cuda"] == -(-len(sizes) // pc.MAX_SEGMENTS) == 2
    assert _rel(got, pc.psg_contract_grouped_plain(psgs, c)) < 1e-5
    assert torch.equal(got, pc.psg_contract_grouped_cuda(psgs, c))


@pytest.mark.parametrize("n_rows", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_psg_contract_grouped_kernel_with_factor_rows(gen, case, n_rows):
    """A (G, N) factor matrix, each segment on its own row (interleaved):
    still one launch, within 1e-5 of the plain version, deterministic, and
    each segment equal to a one-bank call on its row."""
    n, segs = GROUPED_CASES[case]
    psgs = [_bank(gen, n, f, off, dtype or torch.float32) for f, off, dtype in segs]
    c = torch.rand(n_rows, n, generator=gen, device="cuda")
    rows = [i % n_rows for i in range(len(psgs))]
    launches.reset()
    got = pc.psg_contract_grouped_cuda(psgs, c, rows)
    assert launches.snapshot()["psg_contract"] == {"cuda": 1, "torch": 0, "fake": 0}
    assert _rel(got, pc.psg_contract_grouped_plain(psgs, c, rows)) < 1e-5
    assert torch.equal(got, pc.psg_contract_grouped_cuda(psgs, c, rows))
    for part, psg, r in zip(torch.split(got, [f for f, _, _ in segs]), psgs, rows):
        assert torch.equal(part, pc.psg_contract_cuda(psg, c[r].contiguous()))
    with pytest.raises(ValueError, match="row indices"):
        pc.psg_contract_grouped_cuda(psgs, c, [n_rows] * len(psgs))


def _step_segments(model, image, batch):
    """The grouped call's segment sizes of one bk_mixed step, from the taps."""
    from repro_torch.core import ghost
    from repro_torch.core.clipping import discover_meta
    from repro_torch.core.decision import decide
    from repro_torch.data.synthetic import synthetic_vision_batch

    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    data = synthetic_vision_batch(batch=2, image=image, channels=3, n_classes=10, step=0,
                                  device="cuda")
    meta = discover_meta(model.loss_with_ctx, params, data)
    return batch, [f for m in meta.values()
                   if m.kind in ("scale", "bias")
                   or (m.kind == "matmul" and decide(m, mode="bk_mixed") == "instantiate")
                   for f in ghost.psg_segment_sizes(m)]


@pytest.mark.parametrize("path", ["vgg19", "vit_base"])
def test_psg_contract_grouped_kernel_on_step_lists(gen, path):
    """The VGG-19 (batch 128: 40 banks) and ViT-Base (batch 32: 50 banks)
    bk_mixed steps' own segment lists, in one launch each."""
    from repro_torch.configs.paper_native import VIT_BASE
    from repro_torch.models.cnn import VGG
    from repro_torch.models.vit import ViT

    if path == "vgg19":
        n, sizes = _step_segments(VGG("vgg19", device="cuda"), 32, 128)
    else:
        n, sizes = _step_segments(ViT(VIT_BASE, image_size=224, patch=16, n_classes=10,
                                      device="cuda"), 224, 32)
    assert len(sizes) == {"vgg19": 40, "vit_base": 50}[path]
    psgs = [_bank(gen, n, f) for f in sizes]
    c = torch.rand(n, generator=gen, device="cuda")
    launches.reset()
    got = pc.psg_contract_grouped_cuda(psgs, c)
    assert launches.snapshot()["psg_contract"] == {"cuda": 1, "torch": 0, "fake": 0}
    assert _rel(got, pc.psg_contract_grouped_plain(psgs, c)) < 1e-5
    assert torch.equal(got, pc.psg_contract_grouped_cuda(psgs, c))


def test_cuda_tensors_dispatch_to_kernels(gen):
    a, g = _rnd(gen, 2, 5, 4), _rnd(gen, 2, 5, 3)
    launches.reset()
    dispatch.ghost_norm_sq(a, g)
    dispatch.embedding_ghost_norm_sq(torch.zeros(2, 5, dtype=torch.long, device="cuda"), g)
    dispatch.book_weighted_grad(a, g, torch.ones(2, 5, device="cuda"))
    dispatch.psg_contract(_rnd(gen, 4, 6), torch.ones(4, device="cuda"))
    dispatch.flash_attention(_rnd(gen, 1, 3, 2, 16), _rnd(gen, 1, 3, 1, 16),
                             _rnd(gen, 1, 3, 1, 16))
    snap = launches.snapshot()
    assert all(v == {"cuda": 1, "torch": 0, "fake": 0} for v in snap.values()), snap
    with pytest.raises(ValueError, match="contiguous"):
        gn.ghost_norm_sq_cuda(a.transpose(0, 1), g.transpose(0, 1))
    with pytest.raises(ValueError, match="dtype"):
        gn.ghost_norm_sq_cuda(a, g.to(torch.float16))
    with pytest.raises(ValueError, match="dtype"):
        gn.embedding_ghost_norm_sq_cuda(torch.zeros(2, 5, device="cuda"), g)


@pytest.mark.parametrize("mode", ["mixed_ghost", "bk_mixed"])
def test_bf16_vit_step_on_the_card(gen, mode):
    """A two-layer ViT in bf16 compute with fp32 parameters (ViT-Base's
    precision) through make_train_step: every clipping op launches its
    kernel, and the kernel path agrees with the plain path on the card.

    Norms: 1e-4 relative, and clipped gradient sums 1e-4 of the largest
    entry: the same bf16 steps, where only the kernels' fp32 summation
    order differs.
    """
    import dataclasses

    from repro_torch.configs.paper_native import VIT_BASE
    from repro_torch.core.clipping import ClipConfig, dp_value_and_clipped_grad
    from repro_torch.data.synthetic import synthetic_vision_batch
    from repro_torch.launch.steps import DPTrainConfig, make_train_state, make_train_step
    from repro_torch.models.vit import ViT
    from repro_torch.optim import constant, sgd
    from repro_torch.utils.tree import flatten_dict

    cfg = dataclasses.replace(VIT_BASE.reduced(), n_layers=2, dtype="bfloat16")
    # T = 16 patches: every dense and conv tap takes the ghost branch
    model = ViT(cfg, image_size=16, patch=4, n_classes=10, device="cuda")
    batch = synthetic_vision_batch(batch=4, image=16, channels=3, n_classes=10, step=0,
                                   device="cuda")
    opt = sgd()
    state = make_train_state(model, 0, opt)
    step = make_train_step(model, opt, constant(0.1), DPTrainConfig(
        clipping_mode=mode, noise_multiplier=0.0, logical_batch=4), device="cuda")
    launches.reset()
    new_state, metrics = step(state, batch)
    torch.cuda.synchronize()
    snap = launches.snapshot()
    assert all(v["torch"] == 0 for v in snap.values()), snap
    assert snap["ghost_norm_sq"]["cuda"] == 14 and snap["embedding_ghost_norm_sq"]["cuda"] == 1
    assert bool(torch.isfinite(metrics["loss"]))
    for path, leaf in flatten_dict(new_state["params"]).items():
        assert leaf.dtype == torch.float32 and bool(torch.isfinite(leaf).all()), path

    fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode, clip_norm=1.0))
    _, g_cuda, aux_cuda = fn(state["params"], batch)
    with dispatch.force_impl("torch"):
        _, g_torch, aux_torch = fn(state["params"], batch)
    assert _rel(aux_cuda["per_sample_norms"], aux_torch["per_sample_norms"]) < 1e-4
    flat_c, flat_t = flatten_dict(g_cuda), flatten_dict(g_torch)
    scale = max(float(v.abs().max()) for v in flat_t.values())
    for path, want in flat_t.items():
        assert float((flat_c[path] - want).abs().max()) <= 1e-4 * scale, path


# (B, Sq, Skv, H, K, hd, causal, window, q_offset): Sq and Skv off the
# 64-row and 32-key tiles, one query row at the end of the cache, a window
# smaller than Sq, non-causal, MHA, grouped heads, every head dim, and the
# longest Yi-6B prompt (rows of up to 2048 keys)
FLASH_CASES = [
    (1, 2048, 2048, 32, 4, 128, True, None, 0),
    (1, 131, 131, 32, 4, 128, True, None, 0),
    (2, 100, 100, 4, 2, 64, True, None, 0),
    (1, 1, 97, 8, 2, 128, True, None, 96),
    (1, 150, 150, 4, 1, 32, True, 40, 0),
    (2, 70, 45, 4, 4, 64, False, None, 0),
    (1, 33, 80, 2, 2, 16, True, None, 47),
    (3, 64, 64, 6, 3, 128, True, 64, 0),
    # the tensor-core instance's edges (16-row warp slices, 64-row q tiles,
    # 64-key K/V tiles): Sq and Skv off 16, 64 and 128; one query row at the
    # end of a 2049-key cache; hd 16 and 32; a window that cuts a 64-key
    # tile; 8 query heads per KV head; B = 3; non-causal off the tiles
    (1, 127, 129, 4, 2, 128, True, None, 2),
    (2, 65, 191, 8, 1, 64, True, None, 126),
    (1, 1, 2049, 32, 4, 128, True, None, 2048),
    (2, 100, 100, 4, 1, 16, True, None, 0),
    (1, 200, 200, 8, 2, 32, True, None, 0),
    (1, 300, 300, 8, 2, 128, True, 70, 0),
    (3, 150, 150, 16, 2, 64, True, 40, 0),
    (1, 17, 200, 8, 8, 128, False, None, 0),
    # the wgmma instance's edges (hd 64 and 128: 128-row blocks of two
    # 64-row consumer warpgroups, 16, 32 or 128 positions of the 8, 4 or 1
    # query heads that share a KV head; 128-key K/V tiles): g = 8, 4, 2 and
    # 1, Sq off the block (a consumer idle or partly live), a window across
    # the 128-key tiles, q_offset into a longer cache, B = 2, non-causal
    (1, 200, 200, 8, 8, 128, True, None, 0),
    (2, 129, 129, 16, 4, 128, True, None, 0),
    (1, 64, 64, 8, 1, 128, True, None, 0),
    (1, 300, 300, 4, 4, 64, True, None, 0),
    (1, 257, 257, 8, 1, 64, True, None, 0),
    (1, 777, 777, 8, 2, 64, True, 300, 0),
    (1, 90, 400, 8, 2, 128, True, None, 310),
    (2, 130, 250, 4, 2, 128, False, None, 0),
    # head dim 96 (Phi-3-vision; the mma.sync bf16 instance, the SIMT fp32
    # one): causal with Sq and Skv off the 64-row and 64-key tiles, a cross
    # shape, q_offset into a longer cache, GQA, and a 608-token prefill
    (1, 130, 130, 8, 8, 96, True, None, 0),
    (2, 70, 45, 4, 4, 96, False, None, 0),
    (1, 33, 150, 4, 2, 96, True, None, 117),
    (1, 608, 608, 32, 32, 96, True, None, 0),
    # Whisper's cross-attention at hd 64: 1500 keys (a ragged 128-key tail),
    # a prefill's 32 queries and a decode step's one
    (2, 32, 1500, 20, 20, 64, False, None, 0),
    (2, 1, 1500, 20, 20, 64, False, None, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kh,hd,causal,window,q_offset", FLASH_CASES)
def test_flash_attention_kernel(gen, b, sq, skv, h, kh, hd, causal, window, q_offset, dtype):
    """Against the plain version: fp32 within 1e-5 of the largest entry (the
    same fp32 products summed in another order); bf16 within 1e-2 of each
    query row's own largest entry (the kernel's bf16 P moves a row by less
    than one output step; both round the output to bf16, at most one step
    apart, 2^-7 of the entry; a long row's entries lie far below the largest
    entry of the whole output)."""
    q = _rnd(gen, b, sq, h, hd, dtype=dtype)
    k, v = _rnd(gen, b, skv, kh, hd, dtype=dtype), _rnd(gen, b, skv, kh, hd, dtype=dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, **kw)
    if dtype == torch.float32:
        assert _rel(got, want) < 1e-5
    else:
        diff, ref = (got.float() - want.float()).abs(), want.float().abs()
        assert float((diff.amax(-1) / ref.amax(-1).clamp_min(1e-30)).max()) < 1e-2
    assert torch.equal(got, fa.flash_attention_cuda(q, k, v, **kw))  # deterministic


def test_flash_attention_kernel_refuses(gen):
    q, k = _rnd(gen, 1, 4, 2, 16), _rnd(gen, 1, 4, 1, 16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(_rnd(gen, 1, 4, 2, 24), _rnd(gen, 1, 4, 1, 24),
                                _rnd(gen, 1, 4, 1, 24))
    with pytest.raises(ValueError, match="dtypes differ"):
        fa.flash_attention_cuda(q, k, k.to(torch.bfloat16))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_cuda(_rnd(gen, 1, 4, 3, 16), _rnd(gen, 1, 4, 2, 16),
                                _rnd(gen, 1, 4, 2, 16))
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(1, 2), k, k)


def test_reduced_yi_engine_on_the_card(gen):
    """A reduced Yi (4 layers, 4 query heads over 2 KV heads, head dim 16,
    fp32) served by the Engine on the card: every prefill launches the
    kernel once per layer and nothing runs the plain version; the kernel
    path gives the plain path's tokens, and prefill logits within 1e-5 of
    the largest (the kernel's fp32 sums in another order)."""
    import dataclasses

    from repro_torch.configs.registry import build_model, get_arch
    from repro_torch.serving import Engine

    cfg = dataclasses.replace(get_arch("yi-6b").reduced(), n_kv=2)
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.randint(1, cfg.vocab, (5, 11), generator=gen, device="cuda")
    prompts = [row[: 3 + 2 * i].tolist() for i, row in enumerate(prompts)]

    def run():
        engine = Engine(model, params, n_slots=2, page_size=8, max_len=24)
        for p in prompts:
            engine.submit(p, max_new=5)
        done = engine.drain(max_steps=200)
        return [done[i].tokens for i in range(len(prompts))]

    launches.reset()
    got = run()
    snap = launches.snapshot()
    assert snap["flash_attention"] == {"cuda": len(prompts) * cfg.n_layers, "torch": 0, "fake": 0}
    with dispatch.force_impl("torch"):
        want = run()
    assert got == want
    toks = torch.tensor([prompts[-1]], device="cuda")
    logits, _ = model.prefill(params, {"tokens": toks}, model.init_state(1, 24))
    with dispatch.force_impl("torch"):
        plain, _ = model.prefill(params, {"tokens": toks}, model.init_state(1, 24))
    assert _rel(logits, plain) < 1e-5


def _vit4(remat: bool):
    """A 4-layer ViT (ViT-Base's topology cut to d_model 256, 4 heads) on
    the card, fp32, 64x64 images in 8x8 patches (T = 64)."""
    import dataclasses

    from repro_torch.configs.paper_native import VIT_BASE
    from repro_torch.models.vit import ViT

    cfg = dataclasses.replace(VIT_BASE, n_layers=4, d_model=256, n_heads=4, n_kv=4, d_ff=1024,
                              dtype="float32", remat=remat)
    return ViT(cfg, image_size=64, patch=8, n_classes=10, device="cuda")


def _vit_batch(b: int, gen):
    return {"image": torch.randn(b, 64, 64, 3, generator=gen, device="cuda"),
            "label": torch.randint(0, 10, (b,), generator=gen, device="cuda"),
            "mask": torch.ones(b, device="cuda")}


@pytest.mark.parametrize("mode", ["non_private", "mixed_ghost", "bk_mixed"])
def test_remat_lowers_the_peak_at_equal_outputs(gen, mode):
    """Remat on: a lower max_memory_allocated for one clipped step of a
    4-layer ViT at batch 32, and the same loss, norms and clipped sum
    (relative 1e-6: the recomputed layer runs the same kernels).  bk_mixed
    is the exception for memory: its books keep every ghost-banked tap's
    activation and cotangent to the contraction, so remat saves nothing
    there (a 4% higher peak on the card, the recomputation's transients);
    its peak is held within 10% of remat off's."""
    from repro_torch.core.clipping import ClipConfig, dp_value_and_clipped_grad
    from repro_torch.utils.tree import flatten_dict

    batch = _vit_batch(32, gen)
    out, peaks = {}, {}
    for remat in (False, True):
        model = _vit4(remat)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode))
        fn(params, batch)  # warm-up: kernel builds, cuBLAS handles
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[remat] = fn(params, batch)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated()
    if mode == "bk_mixed":
        assert peaks[True] <= 1.1 * peaks[False], peaks
    else:
        assert peaks[True] < peaks[False], peaks
    (l0, g0, a0), (l1, g1, a1) = out[False], out[True]
    assert _rel(l1, l0) <= 1e-6
    assert _rel(a1["per_sample_norms"], a0["per_sample_norms"]) <= 1e-6
    f0, f1 = flatten_dict(g0), flatten_dict(g1)
    scale = max(float(v.abs().max()) for v in f0.values())
    assert max(float((f1[k] - f0[k]).abs().max()) for k in f0) <= 1e-6 * scale


def test_max_batch_by_trial_under_a_fraction(gen):
    """Under a 1 GiB budget the search certifies a batch whose mixed_ghost
    step of the 4-layer ViT runs: it runs again under the same cap, and a
    quarter more fails to allocate (within about a percent of the answer a
    trial's outcome also turns on the allocator's state, so the next batch
    is no sharp edge).  The process's memory fraction comes back
    afterwards."""
    from repro_torch.core.clipping import ClipConfig, dp_value_and_clipped_grad
    from repro_torch.tuner import max_batch as mb

    model = _vit4(True)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = _vit_batch(4, gen)
    fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode="mixed_ghost"))
    torch.cuda.set_per_process_memory_fraction(0.9)
    try:
        got = mb.max_batch_by_trial(fn, params, batch, budget_bytes=1 << 30, hi_cap=4096)
        assert torch.cuda.get_per_process_memory_fraction() == pytest.approx(0.9)
        assert 4 < got < 4096
        run = mb._default_runner(fn, params, batch)
        with mb._memory_fraction(torch.device("cuda", torch.cuda.current_device()), 1 << 30):
            assert mb.trial_survives(run, got, attempts=2)
            assert not mb.trial_survives(run, got + got // 4 + 1, attempts=2)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)


@pytest.mark.parametrize("mode", ["mixed_ghost", "bk_mixed"])
def test_plan_under_force_impl_runs_the_plain_versions(gen, mode):
    """A plan whose kernel map names the card's kernel for every tap does not
    bypass ``force_impl("torch")``: the planned step under it counts plain
    calls only, and without it kernel launches only."""
    from repro_torch.core.clipping import ClipConfig, discover_meta, dp_value_and_clipped_grad
    from repro_torch.tuner import ClipPlan, device_string, shape_fingerprint
    from repro_torch.tuner.measure import KERNEL_OPS_BY_KIND

    model = _vit4(True)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = _vit_batch(4, gen)
    metas = discover_meta(model.loss_with_ctx, params, batch)
    plan = ClipPlan(fingerprint=shape_fingerprint(metas), device=device_string(model.device),
                    kernels=tuple((n, op, "cuda") for n, m in sorted(metas.items())
                                  for op in KERNEL_OPS_BY_KIND.get(m.kind, ())))
    fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode, plan=plan))
    counts = {}
    for forced in (False, True):
        launches.reset()
        if forced:
            with dispatch.force_impl("torch"):
                fn(params, batch)
        else:
            fn(params, batch)
        snap = launches.snapshot()
        counts[forced] = {impl: sum(v[impl] for v in snap.values()) for impl in ("cuda", "torch")}
    assert counts[True]["cuda"] == 0 and counts[True]["torch"] > 0, counts
    assert counts[False]["torch"] == 0 and counts[False]["cuda"] > 0, counts


# -- the LM training shapes ---------------------------------------------------
@pytest.mark.parametrize("n,t,d,p", [
    (1, 4096, 4096, 11008),  # Yi-6B's MLP tap at T = 4096: 2080 tile pairs a sample
    (1, 4096, 4096, 64000),  # Yi-6B's head: bf16 g summed over p = 64000
    (16, 1280, 4096, 14336),  # Mixtral's experts: B = 2 x E = 8 groups of C = 1280 rows
    (16, 1280, 14336, 4096),  # the experts' down projection
])
def test_ghost_norm_kernel_at_lm_shapes(gen, n, t, d, p):
    a = _rnd(gen, n, t, d, dtype=torch.bfloat16)
    g = _rnd(gen, n, t, p, dtype=torch.bfloat16)
    launches.reset()
    got = gn.ghost_norm_sq_cuda(a, g)
    assert launches.snapshot()["ghost_norm_sq"] == {"cuda": 1, "torch": 0, "fake": 0}
    assert _rel(got, gn.ghost_norm_sq_plain(a, g)) < 1e-4
    assert torch.equal(got, gn.ghost_norm_sq_cuda(a, g))


def test_book_kernel_at_the_lm_head(gen):
    """Yi-6B's head book, (D, p) = (4096, 64000) fp32 (1.05 GB), over a
    4096-token sample's rows in bf16."""
    a = _rnd(gen, 1, 4096, 4096, dtype=torch.bfloat16)
    g = _rnd(gen, 1, 4096, 64000, dtype=torch.bfloat16)
    w = torch.rand(1, 4096, generator=gen, device="cuda")
    got = pc.book_weighted_grad_cuda(a, g, w)
    assert got.shape == (1, 4096, 64000)
    assert _rel(got, pc.book_weighted_grad_plain(a, g, w)) < 1e-4


def test_book_kernel_past_32_bit_offsets(gen):
    """R * p past 2^31 (the tuner's 64-sample book of Yi-6B's MLP taps at
    4096 tokens has R * p = 2.9e9): the kernel offsets elements in 64 bits
    and counts only rows in 32."""
    a = _rnd(gen, 1, 32769, 16, dtype=torch.bfloat16)
    g = _rnd(gen, 1, 32769, 65536, dtype=torch.bfloat16)
    w = torch.rand(1, 32769, generator=gen, device="cuda")
    got = pc.book_weighted_grad_cuda(a, g, w)
    assert _rel(got, pc.book_weighted_grad_plain(a, g, w)) < 1e-4


def test_embedding_norm_on_a_yi_batch(gen):
    """A Yi-6B token batch (the synthetic Markov stream, vocab 64000, 4 x
    4096) with a bf16 cotangent of the model's width."""
    from repro_torch.data.synthetic import SyntheticLMConfig, synthetic_lm_batch

    ids = synthetic_lm_batch(SyntheticLMConfig(vocab=64000, seq_len=4096, batch=4), 0,
                             device="cuda")["tokens"]
    g = _rnd(gen, 4, 4096, 4096, dtype=torch.bfloat16)
    got = gn.embedding_ghost_norm_sq_cuda(ids, g)
    assert _rel(got, gn.embedding_ghost_norm_sq_plain(ids, g)) < 1e-4


@pytest.mark.parametrize("mode", ["mixed_ghost", "bk_mixed"])
def test_reduced_mixtral_step_kernels_vs_plain(gen, mode):
    """A reduced Mixtral step (grouped expert taps) on the kernels against
    the plain versions: norms and clipped sums within 1e-4."""
    from repro_torch.configs.registry import build_model, get_arch
    from repro_torch.core.clipping import ClipConfig, dp_value_and_clipped_grad
    from repro_torch.data.synthetic import synthetic_arch_batch

    cfg = get_arch("mixtral-8x7b").reduced()
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = synthetic_arch_batch(cfg, batch=2, seq=64, device="cuda")
    fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode))
    launches.reset()
    _, g_k, aux_k = fn(params, batch)
    snap = launches.snapshot()
    assert sum(v["cuda"] for v in snap.values()) > 0  # bk_mixed at 64 tokens: psg banks
    assert all(v["torch"] == 0 for v in snap.values())
    with dispatch.force_impl("torch"):
        _, g_p, aux_p = fn(params, batch)
    assert _rel(aux_k["per_sample_norms"], aux_p["per_sample_norms"]) < 1e-4
    scale = max(float(v.abs().max()) for v in _leaves(g_p))
    err = max(float((x - y).abs().max()) for x, y in zip(_leaves(g_k), _leaves(g_p)))
    assert err <= 1e-4 * scale


@pytest.mark.parametrize("mode", ["mixed_ghost", "bk_mixed"])
@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "xlstm-350m"])
def test_reduced_recurrent_step_kernels_vs_plain(gen, name, mode):
    """A reduced Jamba or xLSTM step (the dw_conv and scale_grouped banks in
    the grouped psg launch, xLSTM's late wr tap booked) on the kernels
    against the plain versions: norms and clipped sums within 1e-4."""
    from repro_torch.configs.registry import build_model, get_arch
    from repro_torch.core.clipping import ClipConfig, dp_value_and_clipped_grad
    from repro_torch.data.synthetic import synthetic_arch_batch

    cfg = get_arch(name).reduced()
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = synthetic_arch_batch(cfg, batch=2, seq=32, device="cuda")  # ghost taps: 2T^2 < pD
    fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode))
    launches.reset()
    _, g_k, aux_k = fn(params, batch)
    snap = launches.snapshot()
    assert snap["embedding_ghost_norm_sq"]["cuda"] == 1
    assert snap["ghost_norm_sq" if mode == "mixed_ghost" else "psg_contract"]["cuda"] > 0
    assert all(v["torch"] == 0 for v in snap.values())
    with dispatch.force_impl("torch"):
        _, g_p, aux_p = fn(params, batch)
    assert _rel(aux_k["per_sample_norms"], aux_p["per_sample_norms"]) < 1e-4
    scale = max(float(v.abs().max()) for v in _leaves(g_p))
    err = max(float((x - y).abs().max()) for x, y in zip(_leaves(g_k), _leaves(g_p)))
    assert err <= 1e-4 * scale


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]



@pytest.mark.parametrize("name", ["whisper-large-v3", "phi-3-vision-4.2b"])
def test_reduced_wave_on_the_card(gen, name):
    """The reduced Whisper or Phi-3-vision served as one fixed wave on the
    card in fp32: the attention kernel launches once per self- and
    cross-attention layer a prefill and once per cross-attention layer a
    decode step (the self-attention decode runs the plain serving form),
    and every step's logits equal a teacher-forced forward's within 1e-4."""
    import types

    from repro_torch.configs.registry import build_model, get_arch
    from repro_torch.launch.serve import _serve_wave

    cfg = get_arch(name).reduced()
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    counts = []
    for method in ("prefill", "decode_step"):
        def spy(*a, _f=getattr(model, method), **kw):
            launches.reset()
            out = _f(*a, **kw)
            counts.append(launches.snapshot()["flash_attention"])
            return out
        setattr(model, method, spy)
    args = types.SimpleNamespace(slots=2, prompt_len=8, max_new=5, eos=-1)
    wave = _serve_wave(model, cfg, params, args, keep_logits=True)
    cross = cfg.n_layers if cfg.family == "audio" else 0
    assert counts[0] == {"cuda": cfg.n_layers + cross, "torch": 0, "fake": 0}
    assert all(c == {"cuda": cross, "torch": 0, "fake": 0} for c in counts[1:])
    assert len(counts) == args.max_new
    from repro_torch.launch.serve import wave_batch

    batch = wave_batch(cfg, 2, 8, "cuda")
    batch["tokens"] = torch.cat([batch["tokens"], wave["stepped"][:, :-1]], dim=1)
    with torch.no_grad():
        want = model.forward_logits(params, batch)[:, 7:]
    got = torch.cat(wave["logits"], dim=1)
    assert _rel(got, want) < 1e-4
    assert torch.equal(got.argmax(-1), wave["stepped"])


def test_sharded_prefill_launches_the_kernel(gen):
    """Reduced Mixtral's prefill on a (1, 2) mesh of two gloo ranks sharing
    the card (``make_prefill_step`` with the serve state's placements): each
    rank's prefill launches the attention kernel once a layer, no plain
    call, and both ranks return the same logits."""
    import numpy as np

    from torch_dist import run_ranks
    from torch_model_axis_serve_cases import prefill_launches

    ranks = run_ranks(prefill_launches, 2)
    for res in ranks:
        assert res["launches"] == {"cuda": res["layers"], "torch": 0, "fake": 0}, res["launches"]
    assert np.array_equal(ranks[0]["logits"], ranks[1]["logits"])
