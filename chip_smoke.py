#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py            # from the repository root; one CUDA device

The main paths: DP-SGD training of VGG-19 (CIFAR-10 widths, 32x32, 10
classes, GroupNorm, fp32) at batch 128, of ViT-Base/16 (full width, d_model
768, 4 of its 12 layers, 224x224, 10 classes; the dist phase's cnn part
runs all 12) and of BEiT-Large/16 (full width, d_model 1024,
3 of its 24 layers, 224x224, 1000 classes) at batch 32, both ViTs in bf16
compute with fp32 parameters and each layer rematerialised in the backward
(the configs' remat); DP training of the decoder LMs at full width, depth
cut: Yi-6B (1 of 32 layers since the tp part, 2 before, 8 until the
recurrent LMs came; d_model 4096,
32 query heads over 4 KV heads, d_ff 11008, vocab 64000; adamw) at batch 4
and Mixtral-8x7B (1 of 32 layers, 2 until then; 8 experts top 2, d_ff
14336, window 4096; sgd) at batch 2, both
at 4096 tokens in bf16 compute with fp32 parameters, remat on; the
recurrent LMs at full width: Jamba-1.5-Large cut to a two-layer period
(Mamba + MLP, attention + MoE with 2 of its 16 experts; 3.44B bf16
parameters; sgd) at batch 2 x 2048 (2 x 4096 until the tp part came) and
xLSTM-350M cut to a two-layer
period (one sLSTM and one mLSTM; adamw) at batch 4 x 1024 (2048 until the
tp part came), bf16 compute,
remat on;
the frontend families at full width: Whisper-large-v3 (1 of its 32 encoder
and 1 of its 32 decoder layers, 1500 stub frames) at batch 8 x 448 tokens
and Phi-3-vision-4.2b (1 of 32 layers, 32 heads of 96) at batch 4 x (576
prefix + 1472 text), bf16 compute, remat on, sgd;
serving Yi-6B (4 of 32 layers, full width, bf16 compute with fp32
parameters), Mixtral-8x7B (2 layers, fp32), the Jamba cut and the whole
xLSTM-350M (fp32) through the continuous-batching engine, and Whisper and
Phi-3-vision at full width and full depth as one fixed wave; the
tuner CLI on Yi-6B; and the train CLI (python -m repro_torch.launch.train)
on Whisper-large-v3 at full width, 1 encoder + 1 decoder layer, with
checkpoints, a crash and its auto-restart, a profile and the obs streams;
and, last, the same cut as a data-parallel fleet of two ranks that share
the card (gloo), with one NCCL rank, then Mixtral-8x7B at full width (1
layer) on a (1, 2) mesh of the same two ranks: tensor, expert and
sequence parallelism (the model axis), with VGG-19, ViT-Base/16 and
Jamba's Mamba layer, and its sharded prefill and decode (Mixtral-8x7B's
window ring by KV head; Jamba's period over a 32768-row cache by position).
Random weights from seed 0 throughout.  Phases, in order, each one's seconds printed; any
failure exits non-zero and prints no result:

1. card     the name and power limit, as nvidia-smi reports them;
2. build    the CUDA kernels from src/repro_torch/csrc with nvcc (timed);
            cuobjdump -sass must show warpgroup MMAs (HGMMA) in the two
            wgmma flash_attention instances (bf16, head dims 64 and 128),
            tensor-core instructions (HMMA or HGMMA) in the three mma.sync
            ones (head dims 16, 32 and 96), every book_weighted_grad instance
            and every instance of the two ghost-norm Gram kernels, and
            asynchronous copies (LDGSTS for cp.async, or UBLKCP) in both
            instances of the embedding norm's segment kernel; their
            register and spill counts (ptxas -v) are printed;
3. kernels  each CUDA kernel against its plain PyTorch version on the card,
            at the shapes and dtypes its path gives it (the training steps'
            from the models' own taps, the attention kernel's at the eight
            Yi-6B prompt lengths), at the shapes only the *_taps modes give
            (a stacked tap's rows at once, the books of instantiate-branch
            convs), with 1-3 factor rows (psg_contract, segments
            interleaved), and at ragged small shapes (T = 1, T off
            the tile, D and p off the tile, repeated ids, bf16; conv taps
            with SAME and VALID padding, stride 2, C off the 16-byte
            chunk, T = 1, the ViT patch; the embedding norm at T above its
            shared-memory sort; for the attention kernel Sq and
            Skv off the tiles, one query row at the end of the cache, a
            window, non-causal, MHA, hd 64, fp32; Mixtral's and Jamba's fp32
            serve prefills, timed against SDPA with the KV heads repeated
            and the masks as one mask; the wave_serve calls in bf16 and
            fp32: Phi-3-vision's prefill at hd 96, Whisper's self- and
            cross-attention prefill and its cross-attention decode over
            1500 frames), with CUDA-event times
            of the kernel (and, for the clipping kernels, its profiler
            device time), the plain version and one PyTorch library call
            that computes the same function (a yardstick the port never
            calls), the kernel's achieved TFLOP/s and its share of the
            bound; the embedding norm also at three LM shapes (Yi-6B's
            embedding at 4 x 2048 tokens with uniform and Zipf-skewed ids,
            one 8192-token sample) and against a second yardstick, the
            O(T p) unique + index_add_ segment sum; per path, the ghost
            norms' ms per step (dense and conv entries) against their
            yardsticks';
4. slice    per training path, DP-SGD steps through make_train_step in
            non_private, mixed_ghost, bk_mixed, vmap (the Opacus analogue),
            mixed_ghost_taps and bk_mixed_taps (BEiT-Large, the LMs, Whisper
            and Phi-3-vision: the first three; the LMs LM_STEPS timed steps, Jamba and xLSTM
            RECURRENT_STEPS):
            loss, kernel launches per
            step against the taps' expectation (and no plain-version call),
            step time (median and quartiles), peak memory, and one profiled
            step's device busy time and idle share (not measured where the
            trace lacks a launch's device event).  The launch counts are
            zeroed just before each path's steps and read just after them;
5. compare  per training path, one clipped step's per-sample norms and
            gradient sum on the kernels against the plain versions
            (force_impl("torch")) on the same card, and mixed_ghost against
            bk_mixed (the LMs gated in fp32 compute at 2 samples, their bf16
            readings reported beside the kernels' own run-to-run spread and
            gated on a witness: the plain versions given the kernels' clip
            factors, Jamba's bf16-stored gradients within one bf16 step);
6. oracle   per training path, every clipping mode through
            dp_value_and_clipped_grad against the vmap oracle (per-sample
            gradients by their definition): per-sample norms within
            NORM_TOL, clipped gradient sums within KERNEL_GRAD_TOL of the
            largest entry, under the fixed policy (every mode), per_layer
            with 3 groups (mixed_ghost, bk_mixed, mixed_ghost_taps,
            bk_mixed_taps; bk_mixed in one psg_contract launch) and
            automatic (mixed_ghost); the ViTs gated with fp32 compute, their
            bf16 readings reported beside (BEiT-Large: 8 samples, the fixed
            policy; the LMs in fp32 at a smaller cut: Yi-6B 2 layers, batch
            2, 512 tokens, Mixtral 1 layer, Jamba and xLSTM one period, batch
            2, 256 tokens, Whisper 1 + 1 layers, batch 2, 1500 frames and 64
            tokens, Phi-3-vision 1 layer, batch 2, 576 + 64 positions); VGG-19's
            fixed-policy modes also reported against vmap with cuDNN off and
            vmap in fp64 compute;
7. accum    VGG-19: a logical batch of 256 as 2 microbatches of 128 (4 until
            the dist phase's cnn and mamba parts came) through
            make_accum_* in mixed_ghost and bk_mixed, the microsteps under
            torch.cuda.set_sync_debug_mode("error"): norms, gradient sum and
            finalized update against two direct 128-sample clipped calls
            and make_noise_finalize (gated with cuDNN on and off), and
            against one direct 256-sample step and make_train_step on the
            same samples and generator seed (gated with PyTorch's own
            convolutions, reported with cuDNN: its algorithms differ by
            batch size, and the backward amplifies their rounding); every
            reading reported against the fp64 definition; both peaks; the
            quantile policy's step rises by 1 per logical batch;
8. remat    ViT-Base and BEiT-Large at batch 32 in non_private, mixed_ghost
            and bk_mixed with remat on and off, timed in interleaved rounds
            (on, off, off, on): step median (q1-q3) and each round's, the
            host's enqueue ms, device busy (remat on: the slice phase's
            profile) and peak memory each way; on and off gated equal in
            fp32 compute (norms and clipped sums within REMAT_TOL);
9. tune     PrivacyEngine.tune on VGG-19 and ViT-Base (no cache, the plan
            written to a temporary directory): per tap the five timings and
            where the measured winner differs from Eq. 4.1 (both maps), the
            recommended mode, the certified physical batch and its
            accumulation, the kernel map (the card's kernels only); a step
            under the adopted plan and one under the time rule (Remark 4.1)
            against the analytic step, gated within PLAN_TOL in fp32
            compute, reported in bf16, all timed;
10. max_batch  the paper's Table 7 on the card: the largest physical batch
            under the 16 GB budget by trial (the allocator capped with
            set_per_process_memory_fraction) for VGG-19 in non_private,
            vmap, mixed_ghost and bk_mixed and for both ViTs in non_private,
            mixed_ghost and bk_mixed; each certified batch must run again
            under the cap (whether the next one fails is reported), and at
            it the kernels must agree with the plain versions (the launch
            counters show each side ran only its own); ratios against vmap
            and non_private;
11. serve    Yi-6B through the port's Engine as launch/serve.py builds it (4
            slots, page 16, max_len 2080, no EOS), 8 requests of prompt
            lengths 2048 ... 131 with MAX_NEW new tokens each: tokens, tok/s,
            TTFT and per-token percentiles, peak memory, attention-kernel
            launches (zeroed just before the drain, read just after: one per
            layer per prefill), one profiled prefill and one profiled 4-lane
            decode step; then the 2048-token prefill's logits on the kernel
            against force_impl("torch") (gated in fp32 compute on the same
            parameters, reported in bf16), one batched 4-lane decode step
            against each lane's B=1 decode, every request's first token
            against sequential_decode's, the streams token for token
            (reported in bf16 compute, with the first diverging token
            diagnosed: the lane's state against a replay of the request,
            step by step, the logits' top-2 gaps), every batched decode
            step of a drain against B=1 decodes from each lane's own state
            (the first difference located layer by layer), and the same
            drain and oracle in fp32 compute, whose streams must all be
            equal;
12. moe_serve  Mixtral-8x7B (2 layers, full width, fp32) through the Engine:
            4 requests of 77-512 tokens, 16 new tokens each, one
            flash_attention launch per layer per prefill, the streams equal
            to sequential_decode's token for token, the longest prefill's
            logits kernel against plain;
13. hybrid_serve  the Jamba cut (2 layers, 2 experts) and the whole
            xLSTM-350M (24 layers) in fp32 compute through the Engine: 4
            requests of 77-512 tokens, 16 new tokens each; Jamba one
            flash_attention launch per prefill (its paged attention layer),
            xLSTM none (no KV leaf); the streams equal to
            sequential_decode's; Jamba's longest prefill's logits kernel
            against plain;
14. wave_serve  Whisper-large-v3 (32 + 32 layers) and Phi-3-vision-4.2b (32
            layers) at full width and depth through launch/serve's fixed
            wave: 4 prompts of 32 tokens, 16 new tokens, no EOS.  fp32
            compute gated: every step's logits against a teacher-forced
            forward (1e-4), the tokens its greedy choices, the attention
            launches per prefill and decode step as the code predicts
            (Whisper 64 and 32, Phi-3-vision 32 and 0); bf16 compute: the
            prefill logits kernel against plain (reported against
            SERVE_LOGIT_TOL; gated: no further from the fp32 logits than
            WAVE_BF16_WITNESS times the plain versions'); tok/s,
            prefill and decode-step medians, peak memory each way;
15. tuner_cli  python -m repro_torch.tuner on Yi-6B's full config at batch 4 x
            4096 (the max-batch search skipped), its table printed; the
            plan's step and the time rule's against the analytic step in
            fp32 compute on 2 samples;
16. train_cli  launch/train.py's main, in process, on Whisper-large-v3 at full
            width (1 + 1 layers, batch 4 x 448 over 1500 frames, bf16, adam),
            checkpoints in a temporary directory: a straight 4-step bk_mixed
            run under the quantile policy and the same run crashed at step 3
            and auto-restarted, their final checkpoints bit-identical leaf by
            leaf (generator and policy state included) with equal epsilon;
            every run's launches from the card's kernels only (the straight
            and a mixed_ghost run's per step as the taps predict); a
            mixed_ghost run with --profile-steps 2:3 (one step span per
            profiled step in the trace, python -m repro_torch.obs renders
            it); the synchronizing CUDA operations of a mixed_ghost step with
            and without --obs-dir equal; reported: the loop's step times
            beside the trace's, checkpoint bytes, snapshot, write and restore
            seconds, the deterministic embedding gradient's cost, peak
            memory, the four clipping kernels at this path's shapes;
17. dryrun   the dry run (python -m repro_torch.launch.dryrun's evaluation,
            launch/dryrun.py) in a subprocess of its own (its cells in a
            pool of processes, on the host's CPU): this torch's
            version, its fake process group and the trackers printed; one
            rank's step over fake tensors predicted for the card (the
            kernels' abstract evaluation at the H100's constants) for
            VGG-19 b128 mixed_ghost and bk_mixed, Yi-6B (1 layer, 4 x 4096)
            and Mixtral-8x7B (1 layer, 2 x 4096) bk_mixed: the kernels'
            launches per step and the state's bytes gated equal to the slice
            phase's live steps, the predicted peak reported against
            max_memory_allocated with their ratio; the dist phase's tp part
            (its fp32 steps on the (1, 2) mesh) predicted too, and after the
            dist phase its bytes a rank and launches gated equal to rank 0's
            readings; the target constants of the kernels' abstract
            evaluation (132 SMs, the embedding norm's occupancy and sort
            capacity) gated against this card's;
18. dist     data-parallel + FSDP DP-SGD (parallel/, launch/steps with
            shardings) on the train_cli cut, two gloo ranks spawned on the
            one card: a step in non_private, ghost, fastgradclip,
            mixed_ghost and bk_mixed and a quantile bk_mixed step with a
            Poisson mask against the one-rank step (fp32, 1e-5: loss, norms,
            factors, clipped sum, noised gradient, parameters after the
            update), each
            rank holding half of every sharded leaf, the launches and the
            bytes gathered and reduce-scattered, bf16 reported; rank 0
            alone in an NCCL group; the train CLI on both ranks with
            --consensus (one plan hash) and a crash-restart bit-identical
            to a straight run; then the tp part, the model axis on a (1, 2)
            mesh of the same ranks: Mixtral-8x7B at full width, 1 layer
            (4 experts, half the heads' columns and of the vocabulary a
            rank), non_private, mixed_ghost and bk_mixed in fp32 at 2 x
            1024 against the one-rank step at 1e-5 (loss, norms, factors,
            clipped sum, parameters after an SGD + momentum update),
            mixed_ghost and bk_mixed in bf16 at 2 x 4096 reported; the
            bytes all-reduced, each rank's stored share and peak, and the
            four clipping kernels against their plain versions at the
            shapes a rank gives them; the cnn and mamba parts the same way
            (VGG-19 and ViT-Base/16; Jamba's Mamba layer); and the serve
            part: sharded prefill and greedy decode of Mixtral-8x7B (its
            window ring split by KV head) and of Jamba's (mamba, attn)
            period (a 32768-row cache split by position, Mamba's heads
            split) against the one-rank steps, the attention kernel
            launched on every rank's prefill.  Ranks that share a card give
            no speed.

TF32 is off for cuDNN convolutions and for matmuls throughout, so the fp32
comparisons are in full fp32.  Details go to chiprun_out/chip_smoke.json.
The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"

# published H100 SXM peaks (NVIDIA data sheet, dense): the least time a
# function can take is the larger of bytes / HBM rate and operations /
# the peak rate of their operands' type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
# bf16 tensor-core products per multiply-add of the book contraction: w * g
# (fp32) is split in two bf16 terms beside a bf16 activation, which is exact
# (one bf16 product of it misses the 1e-4 gate); an fp32 activation and w * g
# are split in three each, six products (bf16x6: bf16x3 misses the fp32
# gates between equivalent steps, 1e-5, on a sum one product dominates)
BOOK_PRODUCTS = {("float32", "float32"): 6, ("float32", "bfloat16"): 6,
                 ("bfloat16", "float32"): 2, ("bfloat16", "bfloat16"): 2}
# bf16 tensor-core products per multiply-add of a ghost-norm Gram: a bf16
# operand is exact, an fp32 one is split (bf16x3, lo * lo dropped)
GRAM_PRODUCTS = {"float32": 3, "bfloat16": 1}
# kernels whose design rests on an instruction: (instances, the SASS
# instructions one of which each instance must hold); the build prints their
# registers and spills.  The bf16 attention: wgmma (HGMMA) for head dims 64
# and 128, mma.sync for 16, 32 and 96; the ghost-norm kernels: (a, g) dtypes x
# (dense, conv) row sources, on the tensor cores; the embedding norm's
# segment kernel (fp32 and bf16 g) gathers rows by asynchronous copies
MMA = ("HMMA", "HGMMA")
ASYNC_COPY = ("LDGSTS", "UBLKCP")
SASS_OPS = MMA + ASYNC_COPY
SASS_KERNELS = {"flash_attention_wgmma_kernel": (2, ("HGMMA",)),
                "flash_attention_bf16_kernel": (3, MMA),
                "book_weighted_grad_kernel": (8, MMA),
                "ghost_norm_tiles_kernel": (8, MMA), "ghost_norm_packed_kernel": (8, MMA),
                "embedding_segment_kernel": (2, ASYNC_COPY)}

MODES = ("non_private", "mixed_ghost", "bk_mixed", "vmap", "mixed_ghost_taps", "bk_mixed_taps")
# BEiT-Large's timed modes: vmap would hold 304M x 32 per-sample gradients
BEIT_MODES = ("non_private", "mixed_ghost", "bk_mixed")
LM_MODES = BEIT_MODES
LM_STEPS = 1  # timed steps per mode on the LM paths (seconds each; 3 before the
# recurrent paths came, cut with STEPS, REMAT_STEPS and the LM depths for the
# run's time; 2 until the dist phase came)
RECURRENT_STEPS = 1  # on the jamba and xlstm paths, cut for the run's time (2
# until the dist phase came)
STEPS = 1  # timed steps per mode and path (10 until the LM paths came, then 6,
# then 2 until the dist phase came)
# the oracle phase: every mode against vmap under the fixed policy; the
# grouped (per_layer: two prefixes and the catch-all) and automatic runs
ORACLE_MODES = ("ghost", "fastgradclip", "mixed_ghost", "bk_mixed", "ghost_taps",
                "fastgradclip_taps", "mixed_ghost_taps", "bk_mixed_taps")
GROUPED_MODES = ("mixed_ghost", "bk_mixed", "mixed_ghost_taps", "bk_mixed_taps")
GROUP_PREFIXES = {"vgg19": ("conv", "gn"), "vit_base": ("layers", "patch_embed"),
                  "yi_6b": ("layers", "embed"), "mixtral": ("layers", "embed"),
                  "jamba": ("layers", "embed"), "xlstm": ("layers", "embed"),
                  "whisper": ("decoder", "encoder"), "phi3v": ("layers", "embed")}
# the accum phase: a logical batch of ACCUM_MICRO * ACCUM_STEPS samples
# (4 microsteps until the dist phase's cnn and mamba parts came: cut for
# the run's time)
ACCUM_MICRO, ACCUM_STEPS = 128, 2
# the remat phase: these paths and modes with ScannedStack's remat on and
# off, REMAT_ROUNDS rounds of REMAT_STEPS timed steps each way, interleaved;
# their norms and clipped sums in fp32 compute within REMAT_TOL
REMAT_PATHS = ("vit_base", "beit_large")
# ViT-Base at full width, 4 of its 12 layers (all 12 until the dist
# phase's cnn and mamba parts came: cut for the run's time; the cnn part
# runs all 12)
VIT_BASE_LAYERS = 4
# BEiT-Large at full width, 3 of its 24 layers (all 24 until the recurrent
# LMs came, 12 until the dist phase came, 6 until its cnn and mamba parts
# came: cut for the run's time)
BEIT_LAYERS = 3
REMAT_MODES = ("non_private", "mixed_ghost", "bk_mixed")
REMAT_ROUNDS, REMAT_STEPS = 1, 2  # 2 rounds until the dist phase came
REMAT_TOL = 1e-6
# the tune phase: PrivacyEngine.tune on these paths (a logical batch of
# TUNE_LOGICAL samples, whose accumulation the certified batch gives); a
# step under the adopted plan, and one under the time rule, against the
# analytic step within PLAN_TOL (a plan moves cost, never the math)
TUNE_PATHS = ("vgg19", "vit_base")
TUNE_LOGICAL = 1024
# the tune phase's per-tap timings: 1 timed call after 1 warm-up (3 until
# the dist phase's cnn and mamba parts came; the MeasureConfig defaults, 5
# after 2, until the tp part came: cut for the run's time)
TUNE_MEASURE_REPEATS, TUNE_MEASURE_WARMUP = 1, 1
PLAN_TOL = 1e-4
# the max_batch phase (the paper's Table 7): the largest physical batch
# under the paper's 16 GB budget, by trial, per model and mode
TABLE7 = {"vgg19": ("non_private", "vmap", "mixed_ghost", "bk_mixed"),
          "vit_base": ("non_private", "mixed_ghost", "bk_mixed"),
          "beit_large": ("non_private", "mixed_ghost", "bk_mixed")}
MAX_BATCH_HI_CAP = 4096

# the serve phase: Yi-6B at full width, SERVE_LAYERS of its 32 layers (all
# 32 until the recurrent LMs came, cut with MAX_NEW for the run's time), 4
# slots, page 16, 8 requests of these prompt lengths with MAX_NEW new
# tokens each (32 until then), max_len = the longest prompt + MAX_NEW
SERVE_ARCH = "yi-6b"
SERVE_LAYERS = 2  # 4 until the model axis's cnn and mamba parts came, 8
# until the tp part came, 16 until the dist phase
PROMPT_LENS = (2048, 131, 1000, 517, 1536, 250, 777, 2000)
MAX_NEW = 16
SLOTS = 4
PAGE = 16

# relative tolerances of a kernel against its plain version (max |kernel -
# plain| / max |plain|): both sides sum the same fp32 products in
# different orders
TOL = {"ghost_norm_sq": 1e-4, "conv_ghost_norm_sq": 1e-4, "embedding_ghost_norm_sq": 1e-4,
       "book_weighted_grad": 1e-4, "psg_contract": 1e-5}
NORM_TOL = 1e-4  # per-sample norms, kernels vs plain and mixed_ghost vs bk_mixed
# a timed kernel reading takes 20 calls, or as many as fit this budget (at
# least 3): the LM paths' plain Grams take 0.1-0.8 s a call on an H100
# 80GB HBM3 at 700 W
TIMING_BUDGET_MS = 25.0
# clipped gradient sums, relative to the largest entry.  The kernel path
# against force_impl("torch") runs the same step with only the kernels'
# fp32 summation order changed, in either dtype (readings up to 2e-6)
KERNEL_GRAD_TOL = 1e-4
# mixed_ghost against bk_mixed: fp32 steps differ only in summation order;
# bf16 steps compare mixed_ghost's bf16 weight gradients of the second
# backward (each weighted cotangent rounded to about 2^-9) with bk_mixed's
# fp32 contractions of the stored activations
MODE_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the attention kernel against its plain version.  fp32: relative to the
# largest |plain| entry, since both sum the same fp32 products in another
# order.  bf16: relative to each query row's own largest |plain| entry (a
# row past a few hundred keys averages to |out| ~ sqrt(e / keys), far below
# the largest entry, v_0 in row 0).  The kernel rounds P to bf16 before P.V
# (as the Pallas kernel does; the plain version keeps it fp32), which moves
# a row by up to ~3e-3 of its scale, less than one output step; both round
# the output to bf16, so they differ by at most one step, 2^-7 of the entry
FLASH_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# Yi-6B logits, relative to the largest |logit|.  The kernel path against
# force_impl("torch") is gated in fp32 compute (the same fp32 parameters):
# the two differ only in the attention's fp32 summation order, which the
# layers (up to 32) amplify from ~1e-7 but not to 1e-4.  In bf16 that
# comparison is reported only: a one-step bf16 difference in an attention
# output grows through 32 layers to about 2e-2 on a correct kernel.  A batched decode
# step against each lane's B=1 step stays gated in bf16: bf16 activations
# pass through 32 layers and round differently where a GEMM's shape differs
SERVE_KERNEL_LOGIT_TOL = 1e-4
# Mixtral-8x7B served at full width, 2 layers, fp32 compute: 4 requests
MOE_SERVE_PROMPTS = (300, 77, 512, 129)
MOE_SERVE_NEW = 16
# the recurrent LMs served in fp32 compute (the jamba path's 2-layer cut and
# the whole xLSTM-350M): the same 4 prompt lengths, 16 new tokens each
HYBRID_SERVE_PROMPTS = MOE_SERVE_PROMPTS
HYBRID_SERVE_NEW = 16
# the tuner CLI on the lm_train model (Yi-6B, 2 layers, full width); the
# plan's step is gated on 2 samples (the fingerprint is batch-free)
TUNER_GATE_BATCH = 2
SERVE_LOGIT_TOL = 2e-2
# the jamba path's cut of Jamba-1.5-Large: a two-layer period (Jamba's
# layers 2-3: Mamba + MLP, then attention + MoE) with 2 of its 16 experts
JAMBA_PERIOD = ("mamba", "attn")
JAMBA_EXPERTS = 2
# the xlstm path's cut of xLSTM-350M: its period's sLSTM and 1 of its 7
# mLSTMs (3 until the tp part came, the whole period of 8 until the dist
# phase: cut for the run's time)
XLSTM_PERIOD = ("slstm", "mlstm")
# the whisper path's cut of Whisper-large-v3 (full width): this many of its
# 32 encoder and of its 32 decoder layers; the phi3v path's of
# Phi-3-vision's 32 layers (4 and 2 until the dist phase came; Whisper 2
# until the tp part came)
WHISPER_LAYERS = 1
PHI3V_LAYERS = 1
# the wave_serve phase: both models at full width and full depth through
# launch/serve._serve_wave, one wave of WAVE_SLOTS prompts of WAVE_PROMPT
# tokens (after Phi-3-vision's 576-patch prefix, beside Whisper's 1500
# frames), WAVE_NEW new tokens each, no EOS.  Each fp32 decode step's
# logits against a teacher-forced forward of the same tokens, relative to
# the largest |logit|: both sides compute the same fp32 function (the
# kernel's fp32 instance and the plain serving form against the training
# attention), so only summation order separates them, as in
# SERVE_KERNEL_LOGIT_TOL
WAVE_SLOTS, WAVE_PROMPT, WAVE_NEW = 4, 32, 16
WAVE_LOGIT_TOL = 1e-4
# bf16 compute: the prefill's logits on the kernel against the plain
# versions are reported against SERVE_LOGIT_TOL.  Through 32 layers that
# reading is bf16 rounding, not the kernel: Phi-3-vision read 2.86e-2 with
# the hd-96 kernel within its 1e-2 row gate at the same shapes (the serve
# phase's Yi-6B read 2.27e-2 at 32 layers).  The gate is a witness: the
# kernel's bf16 logits may lie no further than WAVE_BF16_WITNESS times the
# plain versions' bf16 logits from the fp32 logits of the same parameters
# and inputs.  Both carry the same activation roundings; the kernel adds
# its bf16 P, below one activation rounding a layer, so the two distances
# are alike, where a wrong head or mask moves logits by their own size
WAVE_BF16_WITNESS = 2.0
WAVE_ARCHS = ("whisper-large-v3", "phi-3-vision-4.2b")
# the train_cli phase: python -m repro_torch.launch.train's main, in process,
# on Whisper-large-v3 at full width cut to 1 encoder + 1 decoder layer, at
# batch 4 x 448 tokens over 1500 frames, bf16 compute, adam; TRAIN_CLI_STEPS
# steps with a checkpoint every TRAIN_CLI_CKPT_EVERY; the restarted run
# crashes at the start of step TRAIN_CLI_CRASH; the sync count compares
# TRAIN_CLI_SYNC_STEPS steps with and without --obs-dir; the profiled run
# takes TRAIN_CLI_PROFILE (inclusive) of TRAIN_CLI_PROFILE_STEPS steps
TRAIN_CLI_ARCH = "whisper-large-v3"
TRAIN_CLI_LAYERS = 1
TRAIN_CLI_BATCH, TRAIN_CLI_SEQ = 4, 448
TRAIN_CLI_STEPS, TRAIN_CLI_CKPT_EVERY, TRAIN_CLI_CRASH = 4, 2, 3  # 6, 3, 5 until the serve part
TRAIN_CLI_SYNC_STEPS = 3
TRAIN_CLI_PROFILE, TRAIN_CLI_PROFILE_STEPS = (2, 3), 4

KERNEL_INFO = {
    "ghost_norm_sq": ("src/repro_torch/csrc/ghost_norm.cu",
                      "src/repro/kernels/ghost_norm/ghost_norm.py:48"),
    "embedding_ghost_norm_sq": ("src/repro_torch/csrc/embedding_norm.cu",
                                "src/repro/kernels/ghost_norm/ghost_norm.py:135"),
    "book_weighted_grad": ("src/repro_torch/csrc/book_weighted_grad.cu",
                           "src/repro/kernels/psg_contract/psg_contract.py:48"),
    "psg_contract": ("src/repro_torch/csrc/psg_contract.cu",
                     "src/repro/kernels/psg_contract/psg_contract.py:110"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:40"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def device_ms(fn, iters: int):
    """Mean device time of ``fn`` per call from torch.profiler (kernel time
    only: where a call is short, cuda_ms also counts the host's enqueue).
    Each trace follows one traced warm-up call that it drops (without it a
    session's first kernel event went missing on the card).  One traced
    call counts the device events a call makes; the trace of ``iters``
    calls must hold exactly ``iters`` times as many, else (or with no
    device time) the reading is None, not measured, and the counts are
    printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    def traced(n: int) -> tuple[int, float]:
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        return (sum(e.count for e in events),
                sum(getattr(e, "self_device_time_total", 0) for e in events))

    fn()
    torch.cuda.synchronize()
    per_call, _ = traced(1)
    count, us = traced(iters)
    if per_call == 0 or count != iters * per_call or us <= 0:
        print(f"    device time not measured: the trace of {iters} calls holds {count} "
              f"device events, one call {per_call}")
        return None
    return us / 1e3 / iters


def cuda_ms(fn, iters: int, budget_ms: float = None) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (after a warm-up);
    with ``budget_ms``, fewer where a timed warm-up shows that ``iters``
    calls would take longer (at least 3)."""
    import torch

    if budget_ms is not None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        iters = max(3, min(iters, int(budget_ms / max(start.elapsed_time(end), 1e-3))))
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phases --
def phase_card() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    return {"nvidia_smi": line, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}


def phase_build() -> dict:
    from repro_torch.kernels import build

    info = build.build(force=True)
    build.library()
    print(f"build: {info.seconds:.1f} s -> {info.path.relative_to(ROOT)}")
    return {"seconds": info.seconds, "path": str(info.path.relative_to(ROOT)),
            "sass": _check_sass(info)}


def _ptxas_usage(log: str) -> dict:
    """{mangled kernel: (registers, spill store bytes, spill load bytes)}
    from nvcc's -Xptxas -v report."""
    import re

    usage, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name, spills = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            usage[name] = (int(m.group(1)),) + spills
    return usage


def _demangle(names: list) -> list:
    import shutil

    tool = shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return [o.replace("(anonymous namespace)::", "").split("(")[0] for o in out]


def _check_sass(info) -> list:
    """Every instance of SASS_KERNELS must hold one of its instructions in
    the built library's SASS (HGMMA for the wgmma kernels, HMMA or HGMMA for
    the other tensor-core kernels, LDGSTS or UBLKCP for the embedding's
    segment kernel); print each one's counts, registers and spills."""
    from repro_torch.kernels import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(info.path)], capture_output=True,
                          text=True, timeout=300)
    require(dump.returncode == 0, f"cuobjdump -sass failed: {dump.stderr.strip()[:500]}")
    sass = {}
    for chunk in dump.stdout.split("Function : ")[1:]:
        name = chunk.split(maxsplit=1)[0]
        sass[name] = {op: chunk.count(f" {op}") for op in SASS_OPS}
    usage = _ptxas_usage(info.log)
    rows = []
    for kernel, (instances, ops) in SASS_KERNELS.items():
        names = sorted(n for n in sass if kernel in n)
        require(len(names) == instances,
                f"{kernel}: {len(names)} instances in the SASS, expected {instances}")
        for name, label in zip(names, _demangle(names)):
            regs, st, ld = usage.get(name, (-1, -1, -1))
            counts = sass[name]
            shown = ", ".join(f"{counts[op]} {op}" for op in SASS_OPS if counts[op] or op in ops)
            print(f"  {label}: {shown}, {regs} registers, spill stores {st} B, loads {ld} B")
            require(sum(counts[op] for op in ops) > 0,
                    f"{label}: no {' or '.join(ops)} instruction in its SASS")
            rows.append({"kernel": label, **{op.lower(): counts[op] for op in SASS_OPS},
                         "registers": regs, "spill_stores": st, "spill_loads": ld})
    return rows


def main_path_shapes(model, params, batch) -> tuple[dict, dict, dict]:
    """Kernel call shapes and dtypes of one training step, with their calls
    per step, the kernel launches per step of each mode, and the shapes the
    *_taps modes add, from the model's own taps and the layerwise decisions.

    A stacked tap (ViT layers) launches its norm kernel once per layer in
    the fused modes and once for all layers (L * B rows) in the *_taps
    modes; its book contraction runs once for all layers.  Every per-sample
    gradient bank of a bk_mixed step (each layer of a stacked tap its own
    segment, weights and biases) contracts in one grouped psg_contract
    launch, recorded as (N, ((F, element offset), ...)) with one dtype per
    segment; bk_mixed_taps books every matmul tap (the instantiate-branch
    convs on unfolded patches too) and contracts scale taps in plain
    PyTorch.  vmap launches no kernel.  The ghost norm gets the activation
    and the cotangent in their stored dtypes (a conv tap's raw input through
    the conv entry, shape (N, H, W, C, kh, kw, s_h, s_w, padding, p), which
    launches as ghost_norm_sq); so does the embedding norm, ids and
    cotangent; the book holds both in the model dtype; banked per-sample
    gradients are fp32.  A book contraction whose R is split across blocks
    launches a second kernel that sums the splits (book_splits, from the
    card's SM count).  A late tap (the sLSTM's recurrent ``wr``) has no
    probe: every mode norms it once for all its layers from the explicit
    (a, g), on the branch the mode picks, and bk_mixed books it (never a
    psg bank).  The small kinds (scale, bias, dw_conv, scale_grouped) launch
    no norm kernel and are segments of the one psg_contract.
    """
    import torch

    from repro_torch.core.clipping import discover_meta
    from repro_torch.core.decision import decide
    from repro_torch.core.ghost import psg_segment_sizes
    from repro_torch.kernels.psg_contract.psg_contract import book_splits

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    meta = discover_meta(model.loss_with_ctx, params, batch)
    shapes = {k: {} for k in RAGGED}
    taps_shapes = {k: set() for k in RAGGED}
    expected = {mode: dict.fromkeys(KERNEL_INFO, 0.0) for mode in MODES}
    segments, n_psg = [], 0

    def add(kernel, shape, dtypes, calls=1):
        key = (shape, dtypes)
        shapes[kernel][key] = shapes[kernel].get(key, 0) + calls

    def book_launches(shape):
        return 1 + (book_splits(*shape, sms)[0] > 1)

    def conv_spec(m):
        return (m.batch_size,) + tuple(m.a_shape[-3:]) + tuple(m.conv.kernel) + tuple(
            m.conv.strides) + (m.conv.padding, m.p)

    for m in meta.values():
        b, layers = m.batch_size, m.n_stack
        # a grouped tap (MoE experts, n_groups = E): each sample's G expert
        # products are rows of its norm (N = B * G) and instances of its book
        # (M = L * G), as core/ghost.py folds them
        groups = max(m.n_groups, 1)
        s_dt = _name(m.s_dtype)
        a_dt = s_dt if m.a_dtype is None else _name(m.a_dtype)  # a late h: s's dtype
        if m.late:
            rows = (b * layers * groups, m.T, m.D, m.p)
            for mode in ("mixed_ghost", "bk_mixed"):
                if decide(m, mode=mode) == "ghost":
                    for run in (mode, f"{mode}_taps"):
                        expected[run]["ghost_norm_sq"] += 1
                    if mode == "mixed_ghost":
                        add("ghost_norm_sq", rows, (a_dt, s_dt))
                    else:
                        taps_shapes["ghost_norm_sq"].add((rows, (a_dt, s_dt)))
            shape = (layers * groups, b * m.T, m.D, m.p)
            for run in ("bk_mixed", "bk_mixed_taps"):
                expected[run]["book_weighted_grad"] += book_launches(shape)
            add("book_weighted_grad", shape, (a_dt, s_dt))
            continue
        if m.kind == "embedding":
            add("embedding_ghost_norm_sq", (b * layers, m.T, m.p, m.D), (a_dt, s_dt))
            for mode in ("mixed_ghost", "bk_mixed"):
                expected[mode]["embedding_ghost_norm_sq"] += layers
            for mode in ("mixed_ghost_taps", "bk_mixed_taps"):
                expected[mode]["embedding_ghost_norm_sq"] += 1
            continue
        for mode in ("mixed_ghost", "bk_mixed"):
            if m.kind == "matmul" and decide(m, mode=mode) == "ghost":
                expected[f"{mode}_taps"]["ghost_norm_sq"] += 1
                if m.conv is not None:
                    taps_shapes["conv_ghost_norm_sq"].add((conv_spec(m), (a_dt, s_dt)))
                else:
                    taps_shapes["ghost_norm_sq"].add(((b * layers * groups, m.T, m.D, m.p),
                                                      (a_dt, s_dt)))
        if m.kind == "matmul":
            shape = (layers * groups, b * m.T, m.D, m.p)
            expected["bk_mixed_taps"]["book_weighted_grad"] += book_launches(shape)
            taps_shapes["book_weighted_grad"].add((shape, (a_dt, s_dt)))
        if m.kind == "matmul" and decide(m, mode="mixed_ghost") == "ghost":
            if m.conv is not None:
                add("conv_ghost_norm_sq", conv_spec(m), (a_dt, s_dt), layers)
            else:
                add("ghost_norm_sq", (b * groups, m.T, m.D, m.p), (a_dt, s_dt), layers)
            expected["mixed_ghost"]["ghost_norm_sq"] += layers
        if m.kind == "matmul" and decide(m, mode="bk_mixed") == "ghost":
            expected["bk_mixed"]["ghost_norm_sq"] += layers
            shape = (layers * groups, b * m.T, m.D, m.p)
            expected["bk_mixed"]["book_weighted_grad"] += book_launches(shape)
            add("book_weighted_grad", shape, (a_dt, s_dt))
        else:
            segments += [(f, 0) for f in psg_segment_sizes(m)]
            n_psg = b
    if segments:  # every psg bank of a bk_mixed step: one grouped launch
        add("psg_contract", (n_psg, tuple(segments)), ("float32",) * len(segments))
        expected["bk_mixed"]["psg_contract"] = 1
    for kernel, extra in taps_shapes.items():  # only those the fused modes do not time
        taps_shapes[kernel] = sorted(extra - set(shapes[kernel]), key=str)
    return shapes, expected, taps_shapes


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _conv_pads(spec) -> tuple:
    """Explicit ((top, bottom), (left, right)) pads of a conv-entry spec."""
    from repro_torch.nn.conv import conv_padding

    _, h, w, _, kh, kw, sh, sw, padding, _ = spec
    return conv_padding(padding, (h, w), (kh, kw), (sh, sw))


def _gram_shape(kernel: str, shape) -> tuple:
    """(N, T, D, p) of a ghost-norm call, dense or conv entry."""
    if kernel == "ghost_norm_sq":
        return tuple(shape)
    n, h, w, c, kh, kw, sh, sw, _, p = shape
    (pt, pb), (pl, pr) = _conv_pads(shape)
    t = ((h + pt + pb - kh) // sh + 1) * ((w + pl + pr - kw) // sw + 1)
    return n, t, kh * kw * c, p


def _bound(kernel: str, shape, dtypes, segments: int = 0) -> tuple[float, str]:
    """Least time (ms) of one call: max(bytes / HBM rate, operations / the
    peak rate of their type), and which of the two bounds it.  ``segments``
    (embedding only): the distinct ids of this call's data, summed over
    samples."""
    import torch

    size = {name: torch.empty((), dtype=getattr(torch, name)).element_size()
            for name in set(dtypes)}
    rate = PEAK_FLOPS_PER_S
    fp32 = rate["float32"]
    if kernel in ("ghost_norm_sq", "conv_ghost_norm_sq"):
        # two lower-triangle Grams on the tensor cores (1 bf16 product per
        # multiply-add of a bf16 operand, 3 of an fp32 one), then their dot;
        # the conv entry reads the raw input, not the patches
        n, t, d, p = _gram_shape(kernel, shape)
        ops_s = ((GRAM_PRODUCTS[dtypes[0]] * d + GRAM_PRODUCTS[dtypes[1]] * p) * n * t * (t + 1)
                 / rate["bfloat16"] + 2 * n * t * t / fp32)
        a_values = math.prod(shape[:4]) if kernel == "conv_ghost_norm_sq" else n * t * d
        nbytes = a_values * size[dtypes[0]] + n * t * p * size[dtypes[1]] + 4 * n
    elif kernel == "embedding_ghost_norm_sq":
        # least work: out[n] = sum_v |sum_{t: id_t = v} g_t|^2, a segment sum
        # of g's rows (an add per row beyond its segment's first), then a
        # square and an add per entry of each segment's sum
        n, t, p, _ = shape
        ops_s = ((n * t - segments) * p + 2 * segments * p) / fp32
        nbytes = n * t * (size[dtypes[0]] + p * size[dtypes[1]]) + 4 * n
    elif kernel == "book_weighted_grad":  # a row-scaled GEMM per m, split operands
        m, r, d, p = shape
        ops_s = (BOOK_PRODUCTS[tuple(dtypes)] * 2 * m * r * d * p / rate["bfloat16"]
                 + m * r * p / fp32)
        nbytes = m * r * (d * size[dtypes[0]] + p * size[dtypes[1]] + 4) + 4 * m * d * p
    else:  # the grouped bank sums: each bank read once, c once, the sums written
        n, segs = shape
        fs = [f for f, _ in segs]
        ops_s = 2 * n * sum(fs) / fp32
        nbytes = sum(n * f * size[d] for f, d in zip(fs, dtypes)) + 4 * (n + sum(fs))
    t_ops, t_bytes = ops_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _flops(kernel: str, shape, segments: int = 0) -> float:
    """The function's own floating-point operations in one call (not those
    of any split of its operands): what an achieved TFLOP/s divides."""
    if kernel in ("ghost_norm_sq", "conv_ghost_norm_sq"):
        n, t, d, p = _gram_shape(kernel, shape)
        return n * t * (t + 1) * (d + p) + 2 * n * t * t
    if kernel == "embedding_ghost_norm_sq":
        n, t, p, _ = shape
        return (n * t - segments) * p + 2 * segments * p
    if kernel == "book_weighted_grad":
        m, r, d, p = shape
        return 2 * m * r * d * p + m * r * p
    n, segs = shape
    return 2 * n * sum(f for f, _ in segs)


def _timing(case: dict) -> str:
    device = device_share = ""
    if "device_ms" in case:
        dev = case["device_ms"]
        device = f" (device {dev:.4f})" if dev is not None else " (device not measured)"
        if dev is not None:
            device_share = f"; device {100 * case['bound_ms'] / dev:.1f}%"
    segment = f" segment_sum={case['segment_ms']:.4f}" if "segment_ms" in case else ""
    return (f" ms={case['ms']:.4f}{device} plain={case['plain_ms']:.4f} "
            f"library={case['library_ms']:.4f}{segment} bound={case['bound_ms']:.4f} "
            f"({case['tflops']:.1f} TFLOP/s, {100 * case['bound_share']:.1f}% of the bound"
            f"{device_share})")


def _fp32(x):
    """A floating tensor (or a list of them) in fp32, for the yardsticks."""
    if isinstance(x, list):
        return [_fp32(y) for y in x]
    return x.float() if x.is_floating_point() else x


def _label(kernel: str, shape, dtypes) -> str:
    """A call's shape and dtypes for the log; a grouped bank call in short."""
    if kernel != "psg_contract":
        return f"{tuple(shape)} {'/'.join(dtypes)}"
    n, segs = shape
    fs = [f for f, _ in segs]
    unaligned = sum(off != 0 for _, off in segs)
    return (f"N={n}, {len(segs)} segments, F {min(fs)}..{max(fs)} (sum {sum(fs)}), "
            f"{unaligned} unaligned, {'/'.join(sorted(set(dtypes)))}")


def _segments(ids) -> int:
    """Distinct ids per sample, summed over the samples of ``ids`` (N, T)."""
    s = ids.sort(dim=1).values
    return int(s.shape[0] + (s[:, 1:] != s[:, :-1]).sum())


def _embedding_ids(n: int, t: int, vocab: int, kind: str, gen):
    """(N, T) int64 ids on the card: the position ids arange(T) when vocab
    == T; else uniform over the vocabulary, or Zipf-skewed (P(id k) ~ (k +
    1)^-ZIPF_EXPONENT: a few ids fill long segments)."""
    import torch

    if vocab == t:
        return torch.arange(t, device="cuda").expand(n, t)
    if kind == "zipf":
        w = torch.arange(1, vocab + 1, device="cuda", dtype=torch.float64).pow(-ZIPF_EXPONENT)
        return torch.multinomial(w, n * t, replacement=True, generator=gen).view(n, t)
    return torch.randint(0, vocab, (n, t), generator=gen, device="cuda")


def _kernel_case(kernel: str, shape, dtypes, gen, timed: bool, ids_kind: str = "uniform",
                 n_rows: int = 0) -> dict:
    """One kernel call against its plain version (and, timed, against the
    library call).  ``n_rows`` (psg_contract): a (n_rows, N) factor matrix,
    the segments' rows interleaved (segment s on row s % n_rows); 0 is the
    shared (N,) vector of one global threshold."""
    import torch

    from repro_torch.kernels.ghost_norm import ghost_norm as gn
    from repro_torch.kernels.psg_contract import psg_contract as pc

    dev = torch.device("cuda")
    dt = [getattr(torch, name) for name in dtypes]

    def rnd(dtype, *s):
        return torch.randn(*s, generator=gen, device=dev).to(dtype)

    if kernel == "ghost_norm_sq":
        n, t, d, p = shape
        args = (rnd(dt[0], n, t, d), rnd(dt[1], n, t, p))
        kern, plain = gn.ghost_norm_sq_cuda, gn.ghost_norm_sq_plain

        def library(a, g):
            return (torch.bmm(a, a.mT) * torch.bmm(g, g.mT)).sum(dim=(1, 2))
    elif kernel == "conv_ghost_norm_sq":
        import torch.nn.functional as F

        from repro_torch.core.taps import ConvInfo
        from repro_torch.nn.conv import pad_nchw, unfold2d

        n, h, w, c, kh, kw, sh, sw, padding, p = shape
        info = ConvInfo(kernel=(kh, kw), strides=(sh, sw), padding=padding)
        pads = _conv_pads(shape)
        args = (rnd(dt[0], n, h, w, c), rnd(dt[1], n, _gram_shape(kernel, shape)[1], p))

        def kern(x, g):
            return gn.conv_ghost_norm_sq_cuda(x, g, info)

        def plain(x, g):
            return gn.conv_ghost_norm_sq_plain(x, g, info)

        def library(x, g):  # F.unfold, then the bmm Grams
            u = F.unfold(pad_nchw(x.permute(0, 3, 1, 2), pads), (kh, kw), stride=(sh, sw))
            return (torch.bmm(u.mT, u) * torch.bmm(g, g.mT)).sum(dim=(1, 2))
    elif kernel == "embedding_ghost_norm_sq":
        n, t, p, vocab = shape  # vocab == T: the position ids arange(T)
        ids = _embedding_ids(n, t, vocab, ids_kind, gen)
        args = (ids.to(dt[0]).contiguous(), rnd(dt[1], n, t, p))
        kern, plain = gn.embedding_ghost_norm_sq_cuda, gn.embedding_ghost_norm_sq_plain

        def library(ids, g):
            return (torch.bmm(g, g.mT) * (ids[:, :, None] == ids[:, None, :])).sum(dim=(1, 2))

        span = int(ids.max()) + 1

        def segment_sum(ids, g):  # the O(T p) form: distinct (sample, id), index_add_, squares
            key = ids + torch.arange(n, device=dev)[:, None] * span
            uniq, inv = torch.unique(key.reshape(-1), return_inverse=True)
            sums = torch.zeros((uniq.numel(), p), device=dev).index_add_(0, inv, g.reshape(-1, p))
            return torch.zeros(n, device=dev).index_add_(0, uniq // span, sums.square().sum(1))
    elif kernel == "book_weighted_grad":
        m, r, d, p = shape
        args = (rnd(dt[0], m, r, d), rnd(dt[1], m, r, p),
                torch.rand(m, r, generator=gen, device=dev))
        kern, plain = pc.book_weighted_grad_cuda, pc.book_weighted_grad_plain

        def library(a, g, w):
            return torch.einsum("mrd,mr,mrp->mdp", a, w, g)
    else:  # one grouped call; a segment's bank starts `off` elements into its buffer
        n, segs = shape
        rows = [i % n_rows for i in range(len(segs))] if n_rows else None

        def bank(f, off, dtype):
            return rnd(dtype, n * f + off)[off:].view(n, f)

        c = torch.rand(*((n_rows,) if n_rows else ()), n, generator=gen, device=dev)
        args = ([bank(f, off, d) for (f, off), d in zip(segs, dt)], c)

        def kern(psgs, c):
            return pc.psg_contract_grouped_cuda(psgs, c, rows)

        def plain(psgs, c):
            return pc.psg_contract_grouped_plain(psgs, c, rows)

        def library(psgs, c):  # one `c @ psg` per segment
            cs = [c[r] for r in rows] if rows else [c] * len(psgs)
            return [ci @ x for ci, x in zip(cs, psgs)]

    got = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{kernel} {shape}: non-finite output")
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / max(float(want.abs().max()), 1e-30)
    again = kern(*args)
    case = {
        "shape": list(shape), "dtypes": list(dtypes),
        **({"ids": ids_kind} if kernel == "embedding_ghost_norm_sq" else {}),
        **({"factor_rows": n_rows} if n_rows else {}),
        "max_abs_err": abs_err, "rel_err": rel_err, "tol": TOL[kernel],
        "deterministic": bool(torch.equal(got, again)),
    }
    if timed:
        # 20 calls a reading, fewer where they would pass TIMING_BUDGET_MS
        iters = 20
        case["ms"] = cuda_ms(lambda: kern(*args), iters, TIMING_BUDGET_MS)
        case["device_ms"] = device_ms(
            lambda: kern(*args), max(3, min(10, int(TIMING_BUDGET_MS / case["ms"]))))
        case["plain_ms"] = cuda_ms(lambda: plain(*args), iters, TIMING_BUDGET_MS)
        lib_args = tuple(_fp32(x) for x in args)
        case["library_ms"] = cuda_ms(lambda: library(*lib_args), iters, TIMING_BUDGET_MS)
        if kernel == "conv_ghost_norm_sq":  # the bmm Grams alone, on patches made beforehand
            patches = unfold2d(lib_args[0], info)
            case["bmm_ms"] = cuda_ms(lambda: (torch.bmm(patches, patches.mT) * torch.bmm(
                lib_args[1], lib_args[1].mT)).sum(dim=(1, 2)), iters, TIMING_BUDGET_MS)
            del patches
        if kernel == "embedding_ghost_norm_sq":  # the second yardstick
            case["segment_ms"] = cuda_ms(lambda: segment_sum(*lib_args), iters, TIMING_BUDGET_MS)
            got_segment = segment_sum(*lib_args)
            case["segment_rel_err"] = float((got_segment - want).abs().max()) / max(
                float(want.abs().max()), 1e-30)
        segments = _segments(args[0]) if kernel == "embedding_ghost_norm_sq" else 0
        case["bound_ms"], case["bound_by"] = _bound(kernel, shape, dtypes, segments)
        case["tflops"] = _flops(kernel, shape, segments) / case["ms"] / 1e9
        case["bound_share"] = case["bound_ms"] / case["ms"]
    status = "ok" if rel_err <= TOL[kernel] else "MISMATCH"
    timing = _timing(case) if timed else ""
    ids_note = (f" {ids_kind} ids" if kernel == "embedding_ghost_norm_sq" and shape[3] != shape[1]
                else f" {n_rows} factor rows" if n_rows else "")
    print(f"  {kernel} {_label(kernel, shape, dtypes)}{ids_note}: rel_err={rel_err:.2e} "
          f"(tol {TOL[kernel]:.0e}) deterministic={case['deterministic']}{timing} {status}")
    require(rel_err <= TOL[kernel], f"{kernel} {shape} {dtypes}: rel err {rel_err:.3e}")
    require(case["deterministic"], f"{kernel} {shape} {dtypes}: repeated calls differ")
    return case


FLOAT_PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32")]
# the embedding norm at LM shapes, timed (no path of the port runs them
# yet): Yi-6B's token embedding (vocab 64000, d_model 4096) at a 2048-token
# sequence and batch 4, with uniform and with Zipf-skewed ids (segments run
# long), and one sample of 8192 tokens (the split fills the SMs at N = 1);
# int64 ids, bf16 g (64 MB)
ZIPF_EXPONENT = 1.1
EMBED_LM = [((4, 2048, 4096, 64000), "uniform"), ((4, 2048, 4096, 64000), "zipf"),
            ((1, 8192, 4096, 64000), "uniform")]
EMBED_ABOVE_SORT = (2, 40000, 8, 300)
RAGGED = {
    # T off the tiles, T = 1, 3 and 4 (packed samples), several 64-row tiles
    "ghost_norm_sq": [((3, 37, 33, 7), FLOAT_PAIRS), ((2, 1, 5, 3), FLOAT_PAIRS),
                      ((4, 100, 130, 70), FLOAT_PAIRS), ((2, 17, 1, 40), FLOAT_PAIRS),
                      ((7, 3, 70, 9), FLOAT_PAIRS), ((9, 4, 4608, 512), FLOAT_PAIRS),
                      ((2, 200, 96, 40), FLOAT_PAIRS)],
    # (N, H, W, C, kh, kw, s_h, s_w, padding, p): SAME with C a multiple of
    # the 16-byte chunk, stride 2 (XLA's (0, 1) pads), C = 6 and 5 (element
    # and odd-C loads), VALID, T = 1, explicit pads, the ViT patch (C = 3)
    "conv_ghost_norm_sq": [
        (spec, FLOAT_PAIRS) for spec in (
            (3, 8, 8, 64, 3, 3, 1, 1, "SAME", 40), (3, 9, 9, 64, 3, 3, 2, 2, "SAME", 16),
            (2, 11, 9, 6, 3, 3, 1, 1, "SAME", 24), (2, 10, 7, 5, 3, 2, 2, 1, "VALID", 7),
            (4, 3, 3, 12, 3, 3, 1, 1, "VALID", 10), (9, 2, 2, 512, 3, 3, 1, 1, "SAME", 64),
            (2, 12, 12, 8, 3, 3, 1, 2, ((2, 0), (1, 1)), 9),
            (2, 64, 64, 3, 16, 16, 16, 16, "VALID", 48))
    ],
    # (N, T, p, vocab): repeated ids, p off the 16-byte row, T = 1, one id
    # over every position (vocab 1) at T = 3000 and 8192 (the sort makes no
    # pass), T above what the sort holds in shared memory (40000 > ~9.9k:
    # the device-memory workspace)
    "embedding_ghost_norm_sq": [
        (shape, [("int64", "float32"), ("int32", "bfloat16")])
        for shape in ((3, 37, 33, 5), (4, 100, 70, 1000), (2, 1, 10, 3),
                      (5, 16, 130, 4), (2, 300, 64, 50), (2, 3000, 40, 1),
                      (2, 8192, 64, 1), EMBED_ABOVE_SORT)
    ],
    # R split across blocks (M = 1, R = 8192), every dtype pair, R under one
    # k-step, R * p past 2^31 (the tuner's 64-sample book of Yi's MLP taps)
    "book_weighted_grad": [((3, 37, 33, 130), FLOAT_PAIRS[:2]), ((1, 1, 5, 3), FLOAT_PAIRS[:2]),
                           ((2, 100, 70, 9), FLOAT_PAIRS + [("float32", "bfloat16")]),
                           ((1, 8192, 130, 70), FLOAT_PAIRS + [("float32", "bfloat16")]),
                           ((1, 32769, 16, 65536), FLOAT_PAIRS[1:2])],
    # then grouped lists: F = 1, odd F, F a multiple of 4, N = 1 and 130, banks
    # that start off the 16-byte line (element offsets 1 and 3), fp32, bf16
    # and mixed; 300 segments, more than one launch's parameter block holds
    "psg_contract": [
        ((128, ((147456, 0),)), [("float32",)]),  # VGG-19's largest bank alone (timed)
        ((5, ((33, 0), (1, 0), (7, 0), (1000, 0), (256, 0))),
         [("float32",) * 5, ("bfloat16",) * 5]),
        ((1, ((1, 0), (4, 0), (129, 0))), [("float32",) * 3, ("bfloat16",) * 3]),
        ((130, ((2049, 0), (64, 1), (1, 0), (512, 3), (4096, 0))),
         [("float32",) * 5, ("float32", "bfloat16", "float32", "bfloat16", "bfloat16")]),
        ((3, tuple((1 + (7 * i) % 50, 0) for i in range(300))), [("float32",) * 300]),
    ],
}


def phase_kernels(paths: dict) -> dict:
    """Every kernel at every path's main shapes (timed), then the ragged ones."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for kernel in RAGGED:
        cases = []
        for tag, path in paths.items():
            if not path["shapes"][kernel]:
                continue
            print(f"kernel {kernel}: {tag} main-path shapes (calls per step)")
            for (shape, dtypes), calls in sorted(path["shapes"][kernel].items()):
                case = _kernel_case(kernel, shape, dtypes, gen, timed=True)
                case["path"], case["calls_per_step"] = tag, calls
                cases.append(case)
        if kernel == "embedding_ghost_norm_sq":
            from repro_torch.kernels.ghost_norm import ghost_norm as gn

            print(f"kernel {kernel}: LM shapes")
            t_above = EMBED_ABOVE_SORT[1]
            capacity = gn.embedding_sort_capacity(0)
            require(t_above > capacity, f"T = {t_above} fits the sort's shared memory "
                    f"({capacity} positions): the workspace goes untested")
            for shape, ids_kind in EMBED_LM:
                cases.append(_kernel_case(kernel, shape, ("int64", "bfloat16"), gen, timed=True,
                                          ids_kind=ids_kind))
        for tag, path in paths.items():
            if path["taps_shapes"][kernel]:
                print(f"kernel {kernel}: {tag} shapes only the *_taps modes give it")
            for shape, dtypes in path["taps_shapes"][kernel]:
                case = _kernel_case(kernel, shape, dtypes, gen, timed=False)
                case["path"], case["taps"] = tag, True
                cases.append(case)
        print(f"kernel {kernel}: ragged shapes")
        for shape, dtype_sets in RAGGED[kernel]:
            timed = kernel == "psg_contract" and shape == RAGGED[kernel][0][0]
            for dtypes in dtype_sets:
                cases.append(_kernel_case(kernel, shape, dtypes, gen, timed=timed))
        if kernel == "psg_contract":  # per-layer clipping: a factor row per segment
            print(f"kernel {kernel}: factor rows (1, 2, 3 rows, segments interleaved)")
            lists = [(shape, dtypes) for tag, path in paths.items()
                     for (shape, dtypes) in path["shapes"][kernel]]
            lists += [(shape, dtype_sets[-1]) for shape, dtype_sets in RAGGED[kernel][1:]]
            for shape, dtypes in lists:
                for n_rows in (1, 2, 3):
                    cases.append(_kernel_case(kernel, shape, dtypes, gen, timed=False,
                                              n_rows=n_rows))
        out[kernel] = cases
    out["ghost_norm_per_step"] = _ghost_per_step(out)
    return out


def _ghost_per_step(kernels: dict) -> dict:
    """Per path: the ghost norms' ms per mixed_ghost step (dense and conv
    entries) beside their yardsticks' (bmm Grams; F.unfold + bmm) and the
    bmm Grams alone (the conv taps' on patches unfolded beforehand)."""
    out = {}
    for entry in ("ghost_norm_sq", "conv_ghost_norm_sq"):
        for c in kernels[entry]:
            if "calls_per_step" not in c:
                continue
            row = out.setdefault(c["path"], dict.fromkeys(
                ("ms", "device_ms", "library_ms", "bmm_ms", "plain_ms", "bound_ms", "conv_ms",
                 "conv_library_ms"), 0.0))
            for key in ("ms", "device_ms", "library_ms", "plain_ms", "bound_ms"):
                if row[key] is not None:
                    row[key] = None if c[key] is None else row[key] + c[key] * c["calls_per_step"]
            row["bmm_ms"] += c.get("bmm_ms", c["library_ms"]) * c["calls_per_step"]
            if entry == "conv_ghost_norm_sq":
                row["conv_ms"] += c["ms"] * c["calls_per_step"]
                row["conv_library_ms"] += c["library_ms"] * c["calls_per_step"]
    for tag, row in out.items():
        dev = "not measured" if row["device_ms"] is None else f"{row['device_ms']:.3f}"
        print(f"ghost norms per {tag} mixed_ghost step: kernel {row['ms']:.3f} ms (device "
              f"{dev}; conv entry "
              f"{row['conv_ms']:.3f}), yardstick {row['library_ms']:.3f} ms (conv: F.unfold + "
              f"bmm {row['conv_library_ms']:.3f}), the bmm Grams alone {row['bmm_ms']:.3f}, "
              f"plain {row['plain_ms']:.3f}, bound {row['bound_ms']:.3f}")
    return out


def _profiled(fn, median_ms: float, host_ops: bool = True) -> dict:
    """One more call of ``fn`` (a step) under torch.profiler: device busy
    time by kernel name.

    The profiler's host-side tracing slows the step's wall clock, so the
    device's idle share is taken against the median of the unprofiled
    steps: 1 - device busy ms / median step ms.  The traced wall time is
    kept only to report that overhead.  ``host_ops=False`` traces the
    device activity alone and reads its raw events (the busy time is the
    kernels' either way): an xLSTM step's ~3.4e5 small launches took
    minutes to trace with the host ops on the H100 80GB HBM3 (700 W).  As
    ``device_ms`` counts its trace's device events, the trace must hold one
    device event for every kernel launch, copy and memset the host made,
    under the same correlation id (``_trace_complete``); else CUPTI dropped
    events, and the busy time and idle share are None, not measured, with
    the counts printed.  The trace follows a dropped warm-up holding one
    small kernel: a session's first device event goes missing on the card
    (each LM step's trace lacked exactly one without it).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    complete, ran, launched, unmatched = _trace_complete(prof)
    by_name, calls, kernels = {}, {}, 0
    if host_ops:
        events = ((evt.key, getattr(evt, "self_device_time_total", None), evt.count,
                   evt.device_type) for evt in prof.key_averages())
    else:  # the raw device events (parsing 3.4e5 into FunctionEvents took ~55 s, H100 host)
        events = ((e.name(), e.duration_ns() / 1e3, 1, e.device_type())
                  for e in prof.profiler.kineto_results.events())
    for key, us, count, device in events:
        if (us and us > 0 and device == torch.autograd.DeviceType.CUDA
                and not key.startswith("ProfilerStep")):
            by_name[key] = by_name.get(key, 0.0) + us / 1e3
            calls[key] = calls.get(key, 0) + count
            kernels += count
    busy = sum(by_name.values()) if complete else None
    idle = 1 - busy / median_ms if complete else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the patch copies (im2col) are listed whatever their rank
    im2col = {k: (by_name[k], calls[k]) for k in by_name if "im2col" in k}
    measured = (f"device busy {busy:.2f} ms of a {median_ms:.2f} ms median step (idle share "
                f"{idle:.2f})" if complete else
                f"device busy not measured: the trace holds {ran} device events for "
                f"{launched} launches, copies and memsets, not one each (unmatched: "
                f"{unmatched})")
    print(f"  traced step: {measured} in {kernels} device kernels; traced wall {wall_ms:.2f} "
          f"ms ({wall_ms / median_ms:.2f}x the median, profiler overhead); "
          "top kernels by device time:")
    for name, ms in top:
        print(f"    {ms:8.3f} ms  {calls[name]:4d} calls  {name[:100]}")
    for name, (ms, n) in im2col.items():
        print(f"  im2col: {ms:.3f} ms in {n} calls of {name[:60]}")
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": idle,
            "device_kernels": kernels, "top": [(k, ms, calls[k]) for k, ms in top],
            "im2col": im2col}


# the host calls whose device work a trace records under their correlation id
_TRACED_CALLS = ("Launch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


def _trace_complete(prof) -> tuple[bool, int, int, list]:
    """(complete, device events, host launches, copies and memsets, the
    first few names without a partner) of a profiler trace: complete where
    every such host call's correlation id has its device event and every
    device event its host call."""
    import torch

    ran, launched = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("ProfilerStep"):  # the schedule's step annotation
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ran[e.correlation_id()] = e.name()
        elif any(k in e.name() for k in _TRACED_CALLS) and "HostFunc" not in e.name():
            launched[e.correlation_id()] = e.name()
    unmatched = [name[:60] for c, name in {**ran, **launched}.items()
                 if (c in ran) != (c in launched)][:3]
    return bool(ran) and ran.keys() == launched.keys(), len(ran), len(launched), unmatched


def _time_train_steps(model, path: dict, mode: str, batches: list, n_steps: int,
                      profiled: bool = True) -> dict:
    """One make_train_step per call of ``batches[1:]`` after a warm-up on
    ``batches[0]``: losses, step times (median and quartiles), the host's
    share (ms until the step call returns, before the sync: the time to
    enqueue the step's work), peak memory, kernel launches per step by
    impl, and one profiled step (``profiled``)."""
    import torch

    from repro_torch.kernels import launches
    from repro_torch.launch.steps import DPTrainConfig, make_train_state, make_train_step
    from repro_torch.optim import constant, sgd
    from repro_torch.utils.tree import flatten_dict

    opt = path.get("optimizer", lambda: sgd(momentum=0.9))()
    state = make_train_state(model, 0, opt)
    step = make_train_step(
        model, opt, constant(path["lr"]["non_private" if mode == "non_private" else "dp"]),
        DPTrainConfig(clipping_mode=mode, clip_norm=1.0, noise_multiplier=1.0,
                      logical_batch=path["batch"]),
        device=model.device,
    )
    state, _ = step(state, batches[0])  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launches.snapshot()
    times, host, losses = [], [], []
    for i in range(1, n_steps + 1):
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        host.append((t1 - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    after = launches.snapshot()
    peak = torch.cuda.max_memory_allocated()
    median = statistics.median(times)
    q1, _, q3 = statistics.quantiles(times, n=4) if len(times) > 1 else (times[0],) * 3
    trace = (_profiled(lambda: step(state, batches[0]), median,
                       host_ops=path.get("profile_host_ops", True)) if profiled else None)
    n_params = sum(x.numel() for x in flatten_dict(state["params"]).values())
    state_bytes = sum(x.numel() * x.element_size()
                      for x in flatten_dict({"p": state["params"], "o": state["opt"]}).values())
    return {"losses": losses, "step_ms": times, "median_step_ms": median, "q1_step_ms": q1,
            "q3_step_ms": q3, "host_ms": host, "median_host_ms": statistics.median(host),
            "peak_bytes": peak, "trace": trace, "n_params": n_params,
            "state_bytes": state_bytes,
            "launches_per_step": {k: (after[k]["cuda"] - before[k]["cuda"]) / n_steps
                                  for k in KERNEL_INFO},
            "plain_calls": sum(after[k]["torch"] - before[k]["torch"] for k in KERNEL_INFO)}


def _path_batch(path: dict, b: int, step: int, device="cuda") -> dict:
    """Step ``step``'s synthetic batch of ``b`` samples: token sequences of
    the path's length for an LM path (with Whisper's frames or
    Phi-3-vision's patch prefix, in the config's bf16, from
    ``synthetic_arch_batch``: ``seq`` counts the prefix), else
    class-conditional images."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import synthetic

    if "arch" in path:  # the frontend families: frames or a prefix beside the tokens
        return synthetic.synthetic_arch_batch(get_arch(path["arch"]), batch=b, seq=path["seq"],
                                              step=step, device=device)
    if "seq" in path:
        return synthetic.synthetic_lm_batch(
            synthetic.SyntheticLMConfig(vocab=path["vocab"], seq_len=path["seq"], batch=b),
            step, device=device)
    return synthetic.synthetic_vision_batch(batch=b, image=path["image"], channels=3,
                                            n_classes=path["n_classes"], step=step,
                                            device=device)


def _batch_size(batch: dict) -> int:
    return int(batch["mask"].shape[0])


def _train_batches(path: dict, n: int, device) -> list:
    return [_path_batch(path, path["batch"], i, device) for i in range(n)]


def phase_slice(tag: str, path: dict, n_steps: int) -> dict:
    from repro_torch.kernels import launches

    model, expected = path["build"](), path["expected"]
    batches = _train_batches(path, n_steps + 1, model.device)
    out = {}
    launches.reset()  # this path's counts start here ...
    for mode in path["modes"]:
        row = _time_train_steps(model, path, mode, batches, n_steps,
                                profiled=mode in path.get("profile_modes", path["modes"]))
        losses, per_step = row.pop("losses"), row["launches_per_step"]
        print(f"slice {tag} {mode}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"step ms median {row['median_step_ms']:.2f} (q1 {row['q1_step_ms']:.2f}, q3 "
              f"{row['q3_step_ms']:.2f}), peak memory {row['peak_bytes'] / 2**20:.1f} MiB "
              f"({row['n_params']} parameters, {row['state_bytes'] / 2**30:.2f} GiB of "
              f"parameters and optimizer state), kernel launches per step {per_step}")
        require(all(math.isfinite(x) for x in losses), f"{tag} {mode}: non-finite loss")
        require(row["plain_calls"] == 0,
                f"{tag} {mode}: {row['plain_calls']} plain-version calls on the card")
        require(per_step == expected[mode],
                f"{tag} {mode}: launches per step {per_step}, expected {expected[mode]}")
        out[mode] = {"losses": losses, **row}
    counts = launches.snapshot()  # ... and are read here
    out["launches"] = {k: counts[k]["cuda"] for k in KERNEL_INFO}
    for kernel in KERNEL_INFO:
        wanted = any(expected[mode][kernel] for mode in path["modes"])
        require(not wanted or out["launches"][kernel] > 0,
                f"{tag}: {kernel} was never launched on its main path")
    if "recurrent" in path:
        out["recurrent"] = _recurrent_times(tag, path)
    return out


def _recurrent_times(tag: str, path: dict) -> dict:
    """Host-clock ms (one reading, synchronized) of the recurrent pieces alone
    at the path's shapes, in its bf16 compute: ``chunked_ssm`` at the Mamba
    or mLSTM layer's shapes and, on xLSTM, the sLSTM time loop
    (``SLSTMScan``), each forward and forward + backward, to set against a
    step (a step runs each layer's forward twice under remat, and its
    backward once or, with a second backward, twice)."""
    import torch

    from repro_torch.nn.ssm_scan import chunked_ssm
    from repro_torch.nn.xlstm import SLSTMScan

    gen = torch.Generator(device="cuda").manual_seed(2)
    b, t = path["batch"], path["seq"]
    out = {}

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        x = torch.randn(*shape, generator=gen, device="cuda") * scale
        return x.to(dtype).requires_grad_()

    def timed(name, fn, inputs):
        def fwd_bwd():
            outs = fn(*inputs)
            torch.autograd.backward([o for o in outs if o.requires_grad],
                                    [torch.ones_like(o) for o in outs if o.requires_grad])
        with torch.no_grad():
            out[f"{name} forward ms"] = _median_ms(lambda: fn(*inputs), 1)
        out[f"{name} forward+backward ms"] = _median_ms(fwd_bwd, 1)

    r = path["recurrent"]
    h, dk, dv = r["heads"], r["dk"], r["dv"]
    shared = r.get("shared_qk", False)  # Mamba: B and C broadcast over the heads
    qk = [rnd(b, t, 1 if shared else h, dk) for _ in range(2)]
    inputs = [qk[0], qk[1], rnd(b, t, h, dv),
              (-torch.rand(b, t, h, generator=gen, device="cuda") * 0.1).requires_grad_()]

    def scan(q, k, v, la):
        return chunked_ssm(q.expand(b, t, h, dk), k.expand(b, t, h, dk), v, la, chunk=256)

    timed(f"chunked_ssm (B {b}, T {t}, H {h}, dk {dk}, dv {dv})", scan, inputs)
    if "slstm_d" in r:
        d = r["slstm_d"]
        zeros = [torch.zeros(b, d, device="cuda", dtype=torch.bfloat16)] + [
            torch.zeros(b, d, device="cuda") for _ in range(2)] + [
            torch.full((b, d), -1e30, device="cuda")]
        timed(f"sLSTM time loop (B {b}, T {t}, d {d})", SLSTMScan.apply,
              [rnd(b, t, 4 * d), *zeros, rnd(d, 4 * d, scale=d**-0.5)])
    for k, v in out.items():
        print(f"  {tag} {k}: {v:.2f}")
    return out


def _max_rel(x, y) -> float:
    return float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)


def phase_compare(tag: str, path: dict, dtype=None, gated: bool = True,
                  batch_size: int = None) -> dict:
    """One clipped step's norms and gradient sum on the kernels against the
    plain versions (force_impl("torch")) in mixed_ghost and bk_mixed, and
    mixed_ghost against bk_mixed.  ``dtype`` overrides the compute dtype
    (the LM paths are gated in fp32 compute on ``compare_batch`` samples);
    ``gated=False`` reports the sides' own runs (the LMs in bf16, where the
    two sides' clip factors differ by ~1e-6 relative) beside the kernels'
    run against run, and gates the witness of where the difference comes
    from: the plain versions given the kernel side's clip factors (a policy
    that returns them) against the kernel side, at KERNEL_GRAD_TOL (bf16-stored
    leaves after one bf16 step an entry).  ``compare_on_host`` (Jamba in
    fp32 compute: 13.8 GB a gradient tree) keeps the held runs' trees in
    host memory."""
    import torch

    from repro_torch.core.clipping import ClipConfig, dp_value_and_clipped_grad
    from repro_torch.kernels import dispatch
    from repro_torch.policies.fixed import FixedPolicy
    from repro_torch.utils.tree import flatten_dict

    class GivenFactors(FixedPolicy):
        """Returns the factors it was given, whatever the norms."""

        def __init__(self, factors):
            super().__init__(clip_norm=1.0)
            self.factors = factors

        def clip_factors(self, norms, state, *, path_norms2=None):
            return self.factors

    model, params, batch = _model_params_batch(path, dtype, batch=batch_size)
    compute = _name(model.dtype)
    out = {}

    def check(got, ref, got_key, ref_key, grad_tol, gate=gated, witness=False):
        """``witness``: where the tree stores bf16 leaves (Jamba's
        param_dtype), each bf16 entry is forgiven one bf16 step before the
        ``grad_tol`` gate (``_bf16_excess``): the gradient is rounded to
        bf16 once at the end, which moves an entry whose two fp32 sums
        straddle a rounding boundary by a step, far above 1e-4 of the
        largest entry; the fp32 leaves keep the plain gate."""
        norm_err = _max_rel(got[1], ref[1])
        bf16 = witness and any(v.dtype == torch.bfloat16 for v in ref[0].values())
        grad_err = _grad_rel_err(got[0], ref[0])
        if bf16:
            raw, grad_err = grad_err, _grad_rel_err(
                got[0], {k: v for k, v in ref[0].items() if v.dtype != torch.bfloat16},
                scale_of=ref[0])
            grad_err = max(grad_err, _bf16_excess(got[0], ref[0]))
        factor_err = _max_rel(got[2], ref[2])
        name = f"{tag} ({compute}) {'/'.join(got_key)} vs {'/'.join(ref_key)}"
        print(f"compare {name}: norms rel err {norm_err:.2e} (tol {NORM_TOL:.0e}), "
              f"clip factors rel err {factor_err:.2e}, "
              f"clipped grad sum rel err {grad_err:.2e} (tol {grad_tol:.0e}"
              + (f"; one bf16 step an entry forgiven, {raw:.2e} without" if bf16 else "")
              + ")" + ("" if gate else " (reported, not gated)"))
        require(not gate or norm_err <= NORM_TOL, f"{name}: norms differ by {norm_err:.3e}")
        require(not gate or grad_err <= grad_tol,
                f"{name}: clipped gradients differ by {grad_err:.3e}")
        out[name] = {"norm_rel_err": norm_err, "factor_rel_err": factor_err,
                     "grad_rel_err": grad_err, "grad_tol": grad_tol, "gated": gate,
                     **({"grad_rel_err_unforgiven": raw} if bf16 else {})}

    # one run held per mode, each other run compared as it comes and dropped
    # (an LM's gradient trees are 7.6-12.7 GB each)
    kept = {}
    for mode in ("mixed_ghost", "bk_mixed"):
        fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode, clip_norm=1.0))

        def run(fn=fn):
            _, g, aux = fn(params, batch)
            return flatten_dict(g), aux["per_sample_norms"], aux["clip_factors"]

        kept[mode] = run()
        if path.get("compare_on_host") and compute == "float32":  # a tree fewer on the card
            kept[mode] = ({k: v.cpu() for k, v in kept[mode][0].items()}, *kept[mode][1:])
            _free()
        with dispatch.force_impl("torch"):
            check(kept[mode], run(), (mode, "cuda"), (mode, "torch"), KERNEL_GRAD_TOL)
        _free()
        if not gated:  # the kernels' own run-to-run spread, then the witness
            if path.get("compare_spread", True):
                check(run(), kept[mode], (mode, "cuda again"), (mode, "cuda"), KERNEL_GRAD_TOL)
                _free()
            given = dp_value_and_clipped_grad(
                model.loss_with_ctx, ClipConfig(mode=mode, policy=GivenFactors(kept[mode][2])))
            with dispatch.force_impl("torch"):
                check(run(given), kept[mode], (mode, "torch given the cuda factors"),
                      (mode, "cuda"), KERNEL_GRAD_TOL, gate=True, witness=True)
            _free()
    check(kept["mixed_ghost"], kept["bk_mixed"], ("mixed_ghost", "cuda"), ("bk_mixed", "cuda"),
          MODE_GRAD_TOL[compute])
    return out


def _launch_delta(before: dict, after: dict) -> dict:
    """Launches between two ``launches.snapshot()``s, summed per impl."""
    return {impl: sum(after[k][impl] - before[k][impl] for k in after)
            for impl in ("cuda", "torch")}


def _timed_clip(model, params, batch, mode: str, policy=None):
    """One dp_value_and_clipped_grad call: (result, host ms, peak bytes,
    kernel launches), the launch counts zeroed just before."""
    import torch

    from repro_torch.core.clipping import ClipConfig, dp_value_and_clipped_grad
    from repro_torch.kernels import launches

    fn = dp_value_and_clipped_grad(model.loss_with_ctx,
                                   ClipConfig(mode=mode, clip_norm=1.0, policy=policy))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.perf_counter()
    res = fn(params, batch)
    torch.cuda.synchronize()
    return (res, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated(),
            launches.snapshot())


def _grad_rel_err(got: dict, ref: dict, scale_of: dict = None) -> float:
    """max |got - ref| over every leaf of ``ref``, over the largest |entry| of
    ``scale_of`` (default ``ref``); leaf by leaf on the card (a tree kept on
    the host moves one leaf at a time)."""
    scale = max(float(v.abs().max()) for v in (ref if scale_of is None else scale_of).values())
    return max(float((got[k].cuda() - v.cuda()).abs().max())
               for k, v in ref.items()) / max(scale, 1e-30)


def _bf16_excess(got: dict, ref: dict) -> float:
    """Over the bf16 leaves: the largest |got - ref| left once one bf16 step
    at that entry is forgiven (2^(e - 8) for |x| in [2^(e-1), 2^e), x the
    larger of the two), over the largest |ref| entry of the tree.  Two fp32
    sums of one function in different orders, each rounded to bf16 once,
    differ by at most one step plus the fp32 sums' own difference."""
    import torch

    scale = max(float(v.abs().max()) for v in ref.values())
    worst = 0.0
    for k, v in ref.items():
        if v.dtype != torch.bfloat16:
            continue
        a, b = got[k].cuda().float(), v.cuda().float()
        _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
        step = torch.ldexp(torch.ones_like(a), exp - 8)
        worst = max(worst, float(((a - b).abs() - step).clamp_min(0).max()))
    return worst / max(scale, 1e-30)

def _fp64_definition(path: dict, params, batch: dict, chunk: int) -> tuple[dict, object]:
    """The per-sample definition as referee of fp32 readings: vmap in fp64
    compute with native convolutions (the fp32 parameters cast up, each
    sample's gradient rounded to fp32 once), ``chunk`` samples a call:
    (clipped gradient sum by path, per-sample norms)."""
    import torch

    from repro_torch.utils.tree import flatten_dict

    model = path["build"]("float64")
    norms, total = [], None
    with torch.backends.cudnn.flags(enabled=False, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        for lo in range(0, batch["label"].shape[0], chunk):
            part = {k: v[lo:lo + chunk] for k, v in batch.items()}
            (_, g, aux), _, _, _ = _timed_clip(model, params, part, "vmap")
            norms.append(aux["per_sample_norms"])
            g = flatten_dict(g)
            total = g if total is None else {k: total[k] + g[k] for k in g}
    return total, torch.cat(norms)


def _against(refs: dict, grads: dict, norms) -> dict:
    """{reference: {"norm_rel_err", "grad_rel_err"}} of one reading."""
    return {name: {"norm_rel_err": _max_rel(norms, r_norms),
                   "grad_rel_err": _grad_rel_err(grads, r_grads)}
            for name, (r_grads, r_norms) in refs.items()}


def _against_line(errs: dict) -> str:
    return "; ".join(f"vs {name}: norms {e['norm_rel_err']:.2e}, grad sum {e['grad_rel_err']:.2e}"
                     for name, e in errs.items())


def phase_oracle(tag: str, path: dict, dtype=None, gated: bool = True,
                 native_ref: bool = False, policies: bool = True) -> dict:
    """Every clipping mode against the vmap oracle at the path's full size:
    the fixed policy in every mode, per_layer (GROUP_PREFIXES and the
    catch-all: 3 groups) in GROUPED_MODES, automatic in mixed_ghost.  Norms
    within NORM_TOL, clipped gradient sums within KERNEL_GRAD_TOL of the
    largest entry, no plain-version call, and bk_mixed under per_layer in
    one psg_contract launch.  ``gated=False`` (the ViTs in bf16 compute)
    reports the fixed-policy readings only; ``policies=False`` (BEiT-Large)
    runs the fixed policy only.  The batch is the path's ``oracle_batch``
    where it has one (BEiT-Large: 8, as 304M x 8 fp32 per-sample gradients
    are 9.7 GB), else its training batch.  Times are one call each on the
    host clock (the first of its mode: informative, not a benchmark).

    ``native_ref`` (VGG-19) also runs the fixed-policy vmap once with cuDNN
    off (PyTorch's own convolutions, whose results do not move with the
    batch size) and once in fp64 compute (``_fp64_definition``), and
    reports the cuDNN vmap and every mode against both: the gated
    comparison above shares cuDNN's algorithms at this batch size on both
    sides, these say how far the path that trains sits from the per-sample
    definition."""
    import torch

    from repro_torch.policies import AutomaticPolicy, PerLayerPolicy
    from repro_torch.utils.tree import flatten_dict

    model, params, batch = _model_params_batch(path, dtype, batch=path.get("oracle_batch"))
    compute = _name(model.dtype)
    runs = [("fixed", None, ORACLE_MODES)]
    if gated and policies:
        runs += [("per_layer", PerLayerPolicy(groups=GROUP_PREFIXES[tag], clip_norm=1.0),
                  GROUPED_MODES),
                 ("automatic", AutomaticPolicy(gamma=0.01), ("mixed_ghost",))]
    out = {"compute": compute, "gated": gated, "batch": _batch_size(batch)}
    for pname, policy, modes in runs:
        (_, g_ref, aux_ref), ms, peak, _ = _timed_clip(model, params, batch, "vmap", policy)
        ref, norms_ref = flatten_dict(g_ref), aux_ref["per_sample_norms"]
        del g_ref, aux_ref
        print(f"oracle {tag} b{out['batch']} ({compute} compute, {pname} policy): vmap "
              f"{ms:.1f} ms, peak {peak / 2**20:.1f} MiB")
        rows = {"vmap": {"ms": ms, "peak_bytes": peak}}
        refs = {}
        if native_ref and pname == "fixed":
            with torch.backends.cudnn.flags(enabled=False, benchmark=False,
                                            deterministic=False, allow_tf32=False):
                (_, g_nat, aux_nat), ms_nat, peak_nat, _ = _timed_clip(
                    model, params, batch, "vmap", policy)
            refs["native"] = (flatten_dict(g_nat), aux_nat["per_sample_norms"])
            del g_nat, aux_nat
            refs["fp64"] = _fp64_definition(path, params, batch, path["batch"])
            rows["vmap"]["native_ms"], rows["vmap"]["native_peak_bytes"] = ms_nat, peak_nat
            rows["vmap"]["vs"] = _against(refs, ref, norms_ref)
            rows["vmap_native"] = {"vs": _against({"fp64": refs["fp64"]}, *refs["native"])}
            print(f"  vmap with native convolutions: {ms_nat:.1f} ms, peak "
                  f"{peak_nat / 2**20:.1f} MiB; {_against_line(rows['vmap_native']['vs'])} "
                  "(reported, not gated)")
            print(f"  vmap with cuDNN {_against_line(rows['vmap']['vs'])} (reported, not gated)")
        for mode in modes:
            (_, g, aux), ms, peak, counts = _timed_clip(model, params, batch, mode, policy)
            norm_err = _max_rel(aux["per_sample_norms"], norms_ref)
            grad_err = _grad_rel_err(flatten_dict(g), ref)
            vs = _against(refs, flatten_dict(g), aux["per_sample_norms"]) if refs else None
            del g, aux
            plain = sum(v["torch"] for v in counts.values())
            psg = counts["psg_contract"]["cuda"]
            verdict = ("ok" if norm_err <= NORM_TOL and grad_err <= KERNEL_GRAD_TOL
                       else "MISMATCH") if gated else "reported, not gated"
            print(f"  {mode}: norms rel err {norm_err:.2e} (tol {NORM_TOL:.0e}), clipped grad "
                  f"sum rel err {grad_err:.2e} (tol {KERNEL_GRAD_TOL:.0e}), {ms:.1f} ms, peak "
                  f"{peak / 2**20:.1f} MiB, psg_contract launches {psg} {verdict}")
            name = f"{tag} {compute} {pname} {mode} vs vmap"
            require(plain == 0, f"{name}: {plain} plain-version calls on the card")
            if gated:
                require(norm_err <= NORM_TOL, f"{name}: norms differ by {norm_err:.3e}")
                require(grad_err <= KERNEL_GRAD_TOL,
                        f"{name}: clipped gradients differ by {grad_err:.3e}")
            if pname == "per_layer" and mode == "bk_mixed":
                require(psg == 1, f"{name}: {psg} psg_contract launches, expected 1")
            if vs is not None:
                print(f"    {_against_line(vs)} (reported, not gated)")
            rows[mode] = {"norm_rel_err": norm_err, "grad_rel_err": grad_err, "ms": ms,
                          "peak_bytes": peak, "psg_contract_launches": psg, "vs": vs}
        out[pname] = rows
        del ref, norms_ref, refs
    return out


def phase_accum(path: dict) -> dict:
    """A logical batch of ACCUM_MICRO * ACCUM_STEPS samples through
    make_accum_* in mixed_ghost and bk_mixed, the microsteps under
    torch.cuda.set_sync_debug_mode("error") (a host sync raises), held
    against two references on the same samples:

    - ACCUM_STEPS direct clipped calls of ACCUM_MICRO samples each (their
      norms concatenated, their sums added), and make_noise_finalize over
      them against make_accum_finalize: the same convolution algorithms as
      the microsteps, so this isolates the accumulation.  Gated with cuDNN
      on (the path that trains) and off;
    - one direct clipped call of the whole logical batch, and make_train_step
      on it against make_accum_finalize.  Gated with cuDNN off (PyTorch's
      own convolutions), reported with it on: cuDNN picks its convolution
      algorithms by batch size, and VGG-19's backward at initialisation
      amplifies their ~1e-6 forward differences (512 vs 128 samples) to
      ~1e-3 in the per-sample norms, whatever the accumulation does.

    Each reading, with cuDNN and without, one call or accumulated, is also
    reported against the fp64 definition (``_fp64_definition``) of the same
    samples.

    Then two logical batches under the quantile policy (cuDNN on): its step
    counter reads 1, then 2."""
    import torch

    from repro_torch.data.synthetic import synthetic_vision_batch
    from repro_torch.launch.steps import (
        DPTrainConfig,
        make_accum_finalize,
        make_accum_init,
        make_accum_microstep,
        make_noise_finalize,
        make_train_state,
        make_train_step,
    )
    from repro_torch.optim import constant, sgd
    from repro_torch.policies import QuantilePolicy
    from repro_torch.utils.tree import flatten_dict, unflatten_dict

    model = path["build"]()
    logical = ACCUM_MICRO * ACCUM_STEPS
    batches = [synthetic_vision_batch(batch=logical, image=path["image"], channels=3,
                                      n_classes=10, step=i, device=model.device)
               for i in range(2)]
    lr = constant(path["lr"]["dp"])
    opt = sgd()

    def micro_rows(batch, i):
        rows = slice(i * ACCUM_MICRO, (i + 1) * ACCUM_MICRO)
        return {k: v[rows] for k, v in batch.items()}

    def accumulate(micro, init, params, pstate, batch, gate=True):
        acc = init()
        torch.cuda.synchronize()
        if gate:
            torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(ACCUM_STEPS):
                acc = micro(params, pstate, acc, micro_rows(batch, i), i)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return acc

    def update(new_state, p0):
        return {k: v - p0[k] for k, v in flatten_dict(new_state["params"]).items()}

    def against_direct(mode, dp):
        """The accumulated logical batch against the direct calls: errors,
        times and peaks, and the tensors compared."""
        state = make_train_state(model, 0, opt)
        params = state["params"]
        p0 = flatten_dict(params)
        _timed_clip(model, params, batches[1], mode)  # warm-up at the logical batch
        (_, g_direct, aux), direct_ms, direct_peak, _ = _timed_clip(model, params, batches[0],
                                                                   mode)
        g_direct = flatten_dict(g_direct)
        micro_norms, g_micro = [], None
        for i in range(ACCUM_STEPS):
            (_, g, a), _, _, _ = _timed_clip(model, params, micro_rows(batches[0], i), mode)
            micro_norms.append(a["per_sample_norms"])
            g = flatten_dict(g)
            g_micro = g if g_micro is None else {k: g_micro[k] + g[k] for k in g}
        micro_norms = torch.cat(micro_norms)
        init, micro = make_accum_init(params, logical), make_accum_microstep(model, dp)
        accumulate(micro, init, params, state["policy"], batches[1], gate=False)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        acc = accumulate(micro, init, params, state["policy"], batches[0])
        torch.cuda.synchronize()
        g_acc = flatten_dict(acc["grads"])
        row = {"accum_ms": (time.perf_counter() - t0) * 1e3,
               "accum_peak_bytes": torch.cuda.max_memory_allocated(),
               "direct_ms": direct_ms, "direct_peak_bytes": direct_peak,
               "norm_rel_err": _max_rel(acc["norms"], aux["per_sample_norms"]),
               "grad_rel_err": _grad_rel_err(g_acc, g_direct),
               "micro_norm_rel_err": _max_rel(acc["norms"], micro_norms),
               "micro_grad_rel_err": _grad_rel_err(g_acc, g_micro),
               "mask_equal": _equal(acc["mask"], batches[0]["mask"])}
        kept = {"direct_norms": aux["per_sample_norms"], "direct_grads": g_direct,
                "accum_norms": acc["norms"].clone(), "accum_grads": g_acc}
        # the finalized update against make_train_step's on the logical batch
        # and against make_noise_finalize over the microbatch-sized calls,
        # same samples and seeds
        new_a, _ = make_accum_finalize(opt, lr, dp)(state, acc)
        new_d, _ = make_train_step(model, opt, lr, dp, device=model.device)(
            make_train_state(model, 0, opt), batches[0])
        new_m = make_noise_finalize(opt, lr, dp)(
            make_train_state(model, 0, opt), unflatten_dict(g_micro), micro_norms,
            batches[0]["mask"])
        u_acc = update(new_a, p0)
        row["update_rel_err"] = _grad_rel_err(u_acc, update(new_d, p0))
        row["micro_update_rel_err"] = _grad_rel_err(u_acc, update(new_m, p0))
        return row, kept

    # the detector's own control: a host read of a device value must raise
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.ones((), device=model.device).item()
        detected = False
    except RuntimeError:
        detected = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(detected, "sync debug mode 'error' let a device-to-host read pass")
    out = {"sync_detector_control": detected}
    refs = {"fp64": _fp64_definition(path, make_train_state(model, 0, opt)["params"],
                                     batches[0], ACCUM_MICRO)}
    for mode in ("mixed_ghost", "bk_mixed"):
        dp = DPTrainConfig(clipping_mode=mode, clip_norm=1.0, noise_multiplier=1.0,
                           logical_batch=logical, accumulation_steps=ACCUM_STEPS)
        out[mode], kept = {}, {}
        for conv in ("native", "cudnn"):
            with torch.backends.cudnn.flags(enabled=conv == "cudnn", benchmark=False,
                                            deterministic=False, allow_tf32=False):
                r, kept[conv] = against_direct(mode, dp)
            logical_gated = conv == "native"
            print(f"accum vgg19 {mode} ({conv} convolutions): {ACCUM_STEPS} x {ACCUM_MICRO} "
                  f"vs {ACCUM_STEPS} direct {ACCUM_MICRO}-sample calls (gated): norms rel err "
                  f"{r['micro_norm_rel_err']:.2e} (tol {NORM_TOL:.0e}), clipped grad sum rel "
                  f"err {r['micro_grad_rel_err']:.2e} (tol {KERNEL_GRAD_TOL:.0e}), finalized "
                  f"update vs make_noise_finalize {r['micro_update_rel_err']:.2e} (tol "
                  f"{KERNEL_GRAD_TOL:.0e}); vs one {logical}-sample step "
                  f"({'gated' if logical_gated else 'reported, not gated'}): norms rel err "
                  f"{r['norm_rel_err']:.2e}, clipped grad sum rel err {r['grad_rel_err']:.2e}, "
                  f"finalized update vs make_train_step {r['update_rel_err']:.2e}; mask equal "
                  f"{r['mask_equal']}; microsteps {r['accum_ms']:.1f} ms under sync debug "
                  f"'error', peak {r['accum_peak_bytes'] / 2**20:.1f} MiB; direct "
                  f"{r['direct_ms']:.1f} ms, peak {r['direct_peak_bytes'] / 2**20:.1f} MiB")
            require(r["mask_equal"], f"accum {mode}: the accumulated mask differs")
            keys = ("micro_norm_rel_err", "micro_grad_rel_err", "micro_update_rel_err")
            if logical_gated:
                keys += ("norm_rel_err", "grad_rel_err", "update_rel_err")
            for key in keys:
                tol = NORM_TOL if key.endswith("norm_rel_err") else KERNEL_GRAD_TOL
                require(r[key] <= tol, f"accum {mode} ({conv}): {key} {r[key]:.3e}")
            out[mode][conv] = r
        # where each convolution path and batch size sits: every reading
        # against the fp64 definition of the same samples
        labels = {"direct": f"one {logical}-sample call",
                  "accum": f"{ACCUM_STEPS} x {ACCUM_MICRO} accumulated"}
        vs = {}
        for conv, k in kept.items():
            for kind, label in labels.items():
                vs[f"{conv}_{kind}"] = _against(refs, k[f"{kind}_grads"], k[f"{kind}_norms"])
                print(f"accum vgg19 {mode} {conv} convolutions, {label}: "
                      f"{_against_line(vs[f'{conv}_{kind}'])} (reported, not gated)")
        out[mode]["vs"] = vs
        del kept
        # the quantile policy: one update per logical batch
        policy = QuantilePolicy(release_sigma=1.0, init_clip_norm=1.0)
        dpq = dataclasses.replace(dp, policy=policy)
        sq = make_train_state(model, 0, opt, policy)
        init = make_accum_init(sq["params"], logical)
        micro_q, finalize_q = make_accum_microstep(model, dpq), make_accum_finalize(opt, lr, dpq)
        steps, radii = [], []
        for batch in batches:
            acc = accumulate(micro_q, init, sq["params"], sq["policy"], batch)
            sq, _ = finalize_q(sq, acc)
            steps.append(int(sq["policy"]["step"]))
            radii.append(float(sq["policy"]["clip_norm"]))
        print(f"accum vgg19 {mode} quantile policy: step {steps} after each logical batch, "
              f"R {radii}")
        require(steps == [1, 2], f"accum {mode}: quantile policy steps {steps}, expected [1, 2]")
        require(all(math.isfinite(r) for r in radii), f"accum {mode}: R {radii}")
        out[mode]["quantile_steps"], out[mode]["quantile_clip_norms"] = steps, radii
        del acc, sq
    return out


def _free() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


# Host seconds in the cyclic collector, from gc.callbacks.  ``_settle``
# collects, then freezes what outlives a phase (imports, the paths, earlier
# phases' results): the collections that follow (``_free``, the max-batch
# search's recovered allocator before every trial) scan what the phase made
# since, not the whole heap.  Objects frozen stay collectable by their
# reference counts; a cycle among them is kept to the end of the process.
GC_SECONDS = {"seconds": 0.0, "collections": 0, "start": None}


def _gc_timer(stage: str, info: dict) -> None:
    if stage == "start":
        GC_SECONDS["start"] = time.perf_counter()
    elif GC_SECONDS["start"] is not None:
        GC_SECONDS["seconds"] += time.perf_counter() - GC_SECONDS["start"]
        GC_SECONDS["collections"] += 1
        GC_SECONDS["start"] = None


def _settle() -> None:
    """Collect, then freeze every object still alive (``gc.freeze``)."""
    if _gc_timer not in gc.callbacks:
        gc.callbacks.append(_gc_timer)
    _free()
    gc.freeze()


def phase_remat(paths: dict, slices: dict) -> dict:
    """REMAT_PATHS in REMAT_MODES with ScannedStack's remat on and off, timed
    interleaved on two models held side by side (rounds on, off, off, on,
    ..., REMAT_STEPS steps each on the same batches, so the host's drift
    falls on both settings alike): each round's median step, the pooled
    median (q1-q3), the host's enqueue ms (the step call until it returns,
    before the sync), device busy (one profiled step with remat off; with
    it on, the slice phase's profile of the same step: device time does
    not drift with the host) and peak memory each way, in the path's
    compute dtype; then one clipped call each way in fp32 compute, norms
    and clipped sums gated equal within REMAT_TOL (remat recomputes the
    same layer with the same kernels: it changes memory, never a value)."""
    from repro_torch.core.clipping import ClipConfig, dp_value_and_clipped_grad
    from repro_torch.utils.tree import flatten_dict

    out = {}
    for tag in REMAT_PATHS:
        path = paths[tag]
        rows = out[tag] = {}
        models = {remat: path["build"](None, remat) for remat in (True, False)}
        batches = _train_batches(path, REMAT_STEPS + 1, models[True].device)
        for mode in REMAT_MODES:
            rounds = {True: [], False: []}
            order = [r for i in range(REMAT_ROUNDS) for r in ((True, False) if i % 2 == 0
                                                              else (False, True))]
            for remat in order:
                rounds[remat].append(_time_train_steps(
                    models[remat], path, mode, batches, REMAT_STEPS,
                    profiled=not remat and not rounds[remat]))
                _free()
            for remat in (True, False):
                rs = rounds[remat]
                times = [t for r in rs for t in r["step_ms"]]
                host = [t for r in rs for t in r["host_ms"]]
                q1, _, q3 = statistics.quantiles(times, n=4)
                row = {"median_step_ms": statistics.median(times), "q1_step_ms": q1,
                       "q3_step_ms": q3, "round_median_ms": [r["median_step_ms"] for r in rs],
                       "median_host_ms": statistics.median(host),
                       "peak_bytes": max(r["peak_bytes"] for r in rs),
                       "trace": slices[tag][mode]["trace"] if remat else rs[0]["trace"],
                       "losses": [x for r in rs for x in r["losses"]],
                       "plain_calls": sum(r["plain_calls"] for r in rs)}
                busy = row["trace"]["device_busy_ms"]
                row["idle_share"] = None if busy is None else 1 - busy / row["median_step_ms"]
                key = f"{mode} remat {'on' if remat else 'off'}"
                print(f"remat {tag} b{path['batch']} {key}: step ms median "
                      f"{row['median_step_ms']:.2f} (q1 {row['q1_step_ms']:.2f}, q3 "
                      f"{row['q3_step_ms']:.2f}; round medians "
                      + " ".join(f"{x:.2f}" for x in row["round_median_ms"])
                      + f"), host enqueue {row['median_host_ms']:.2f} ms, device busy "
                      + (f"{busy:.2f} ms (idle share {row['idle_share']:.2f})"
                         if busy is not None else "not measured")
                      + f", peak {row['peak_bytes'] / 2**20:.1f} MiB")
                require(all(math.isfinite(x) for x in row["losses"]), f"remat {tag} {key}: loss")
                require(row["plain_calls"] == 0, f"remat {tag} {key}: plain-version calls")
                rows[key] = row
            on, off = rows[f"{mode} remat on"], rows[f"{mode} remat off"]
            on_busy, off_busy = on["trace"]["device_busy_ms"], off["trace"]["device_busy_ms"]
            print(f"remat {tag} {mode}: on / off peak {on['peak_bytes'] / off['peak_bytes']:.3f}, "
                  f"median step {on['median_step_ms'] / off['median_step_ms']:.3f} "
                  f"({on['median_step_ms'] - off['median_step_ms']:+.2f} ms), host enqueue "
                  f"{on['median_host_ms'] / off['median_host_ms']:.3f} "
                  f"({on['median_host_ms'] - off['median_host_ms']:+.2f} ms), device busy "
                  + (f"{on_busy / off_busy:.3f} ({on_busy - off_busy:+.2f} ms)"
                     if on_busy is not None and off_busy is not None else "not measured"))
        del models, batches
        _free()
        for mode in REMAT_MODES:
            res = {}
            for remat in (True, False):
                model, params, batch = _model_params_batch(path, "float32", remat)
                fn = dp_value_and_clipped_grad(model.loss_with_ctx,
                                               ClipConfig(mode=mode, clip_norm=1.0))
                _, g, aux = fn(params, batch)
                res[remat] = (flatten_dict(g), aux["per_sample_norms"])
                del model, params, batch, fn, g, aux
                _free()
            norm_err = _max_rel(res[True][1], res[False][1])
            grad_err = _grad_rel_err(res[True][0], res[False][0])
            del res
            print(f"remat {tag} {mode} (float32 compute): on vs off norms rel err {norm_err:.2e}, "
                  f"clipped grad sum rel err {grad_err:.2e} (tol {REMAT_TOL:.0e})")
            require(norm_err <= REMAT_TOL and grad_err <= REMAT_TOL,
                    f"remat {tag} {mode}: on vs off differ (norms {norm_err:.3e}, sums "
                    f"{grad_err:.3e})")
            rows[f"{mode} gate"] = {"norm_rel_err": norm_err, "grad_rel_err": grad_err}
    return out


def _clip_ms(fn, params, batch, n: int = 5) -> float:
    """Median host ms of ``n`` clipped calls, each ending in a sync, after
    one warm-up."""
    import torch

    fn(params, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class _TrialCounter:
    """Counts the max-batch search's trials (``trial_survives`` calls; the
    candidates its memory model rules out run none) while it is
    installed."""

    def __init__(self):
        from repro_torch.tuner import max_batch as mb

        self.mb, self.real, self.sizes = mb, mb.trial_survives, []

    def __enter__(self):
        def counting(run, b, **kw):
            self.sizes.append(b)
            return self.real(run, b, **kw)

        self.mb.trial_survives = counting
        return self

    def __exit__(self, *exc):
        self.mb.trial_survives = self.real
        return False


def _plan_step_gate(tag: str, model, params, batch, plan, label: str, n: int = 3) -> dict:
    """A clipped step under ``plan`` (mixed_ghost and bk_mixed, each reading
    its own map) and one under the time rule, against the analytic step:
    norms and clipped sums within PLAN_TOL; each timed over ``n`` calls
    (0: not timed)."""
    from repro_torch.core.clipping import ClipConfig, dp_value_and_clipped_grad, discover_meta
    from repro_torch.utils.tree import flatten_dict

    meta = discover_meta(model.loss_with_ctx, params, batch)
    require(plan.matches(meta, model.device), f"tune {tag}: the plan does not match its model")
    out = {}
    for mode in ("mixed_ghost", "bk_mixed"):
        ref_fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode))
        _, g_ref, aux_ref = ref_fn(params, batch)
        g_ref = flatten_dict(g_ref)
        variants = {"plan": ClipConfig(mode=mode, plan=plan),
                    "time rule": ClipConfig(mode=mode, decision_by="time")}
        row = {"analytic_ms": _clip_ms(ref_fn, params, batch, n) if n else None}
        for name, cfg in variants.items():
            fn = dp_value_and_clipped_grad(model.loss_with_ctx, cfg)
            _, g, aux = fn(params, batch)
            norm_err = _max_rel(aux["per_sample_norms"], aux_ref["per_sample_norms"])
            grad_err = _grad_rel_err(flatten_dict(g), g_ref)
            del g, aux
            ms = _clip_ms(fn, params, batch, n) if n else None
            timing = (f"; {ms:.2f} ms against the analytic {row['analytic_ms']:.2f}" if n
                      else "")
            print(f"tune {tag} {label} {mode}: {name} step vs analytic: norms rel err "
                  f"{norm_err:.2e}, clipped grad sum rel err {grad_err:.2e} (tol "
                  f"{PLAN_TOL:.0e}){timing}")
            require(norm_err <= PLAN_TOL and grad_err <= PLAN_TOL,
                    f"tune {tag} {label} {mode}: the {name} step differs from the analytic "
                    f"(norms {norm_err:.3e}, sums {grad_err:.3e})")
            row[name] = {"norm_rel_err": norm_err, "grad_rel_err": grad_err, "ms": ms}
        out[mode] = row
        del g_ref, aux_ref
    return out


def phase_tune(paths: dict) -> dict:
    """PrivacyEngine.tune on TUNE_PATHS (mixed_ghost, a logical batch of
    TUNE_LOGICAL, TUNE_MEASURE_* timed calls a branch, the 16 GB budget, no cache, the
    plan written to a temporary directory): per tap the five timings and
    where the measured winner differs from the analytic rule (both maps);
    the recommended mode, the certified physical batch and its
    accumulation; the kernel map (every entry the card's kernel).  Then the
    step gate (``_plan_step_gate``) in fp32 compute (the ViT's bf16 plan
    restamped with the fp32 model's fingerprint: the same taps by name) and
    reported in the path's own compute."""
    import dataclasses as dc
    import os
    import tempfile

    from repro_torch.core.clipping import discover_meta
    from repro_torch.core.decision import decide
    from repro_torch.core.engine import PrivacyEngine
    from repro_torch.tuner import shape_fingerprint
    from repro_torch.tuner.measure import MeasureConfig

    out = {}
    for tag in TUNE_PATHS:
        path = paths[tag]
        model, params, batch = _model_params_batch(path)
        engine = PrivacyEngine(loss_with_ctx=model.loss_with_ctx, batch_size=TUNE_LOGICAL,
                               sample_size=50_000, steps=1000, max_grad_norm=1.0,
                               noise_multiplier=1.0, mode="mixed_ghost", device=model.device)
        with tempfile.TemporaryDirectory() as tmp, _TrialCounter() as trials:
            t0 = time.perf_counter()
            plan = engine.tune(params, batch, arch=tag, use_cache=False,
                               plan_path=os.path.join(tmp, f"{tag}.json"),
                               hi_cap=MAX_BATCH_HI_CAP,
                               measure=MeasureConfig(repeats=TUNE_MEASURE_REPEATS,
                                                     warmup=TUNE_MEASURE_WARMUP))
            seconds = time.perf_counter() - t0
            require(os.path.exists(os.path.join(tmp, f"{tag}.json")), f"tune {tag}: no plan file")
        meta = discover_meta(model.loss_with_ctx, params, batch)
        taps = {}
        print(f"tune {tag} ({path['dtype']} compute) on {plan.device}: {seconds:.1f} s, "
              f"{len(trials.sizes)} max-batch trials; per tap ghost / instantiate / bk ghost / "
              "bk instantiate / second backward us:")
        for name, t in sorted(plan.tap_timings().items()):
            m = meta[name]
            analytic = {mode: decide(m, mode=mode) for mode in ("mixed_ghost", "bk_mixed")}
            flips = [f"{mode} measured {w} != Eq. 4.1 {analytic[mode]}"
                     for mode, w in (("mixed_ghost", t.winner), ("bk_mixed", t.bk_winner))
                     if w != analytic[mode]]
            print(f"  {name:28s} T={m.T:5d} D={m.D:5d} p={m.p:5d}: {t.ghost_us:9.1f} "
                  f"{t.instantiate_us:9.1f} {t.bk_ghost_us:9.1f} {t.bk_instantiate_us:9.1f} "
                  f"{t.second_bwd_us:9.1f} -> {t.winner}/{t.bk_winner}"
                  f"{'  (' + '; '.join(flips) + ')' if flips else ''}")
            taps[name] = {"timing": t.as_tuple(name)[1:], "winner": t.winner,
                          "bk_winner": t.bk_winner, "analytic": analytic}
        kernels = sorted({(op, impl) for _, op, impl in plan.kernels})
        flips = {mode: sum(1 for r in taps.values()
                           if r["winner" if mode == "mixed_ghost" else "bk_winner"]
                           != r["analytic"][mode]) for mode in ("mixed_ghost", "bk_mixed")}
        print(f"tune {tag}: measured vs Eq. 4.1 flips {flips}; recommended mode "
              f"{plan.recommended_mode()} (mixed_ghost {plan.mode_cost_us('mixed_ghost'):.0f} us, "
              f"bk_mixed {plan.mode_cost_us('bk_mixed'):.0f} us per step); certified physical "
              f"batch {plan.physical_batch} under {plan.budget_bytes / 2**30:.0f} GiB, logical "
              f"{plan.logical_batch} as {plan.accumulation_steps} microstep(s); measured at the "
              f"physical batch {plan.measured_at_physical}; kernel map {kernels}")
        require(plan.physical_batch and plan.physical_batch > 0, f"tune {tag}: nothing fits")
        require({impl for _, impl in kernels} == {"cuda"},
                f"tune {tag}: the kernel map sends a tap to {kernels}")
        row = {"seconds": seconds, "trials": len(trials.sizes), "trial_sizes": trials.sizes,
               "plan": json.loads(plan.to_json()), "taps": taps, "flips": flips,
               "recommended_mode": plan.recommended_mode()}
        row["gate_" + path["dtype"]] = _plan_step_gate(tag, model, params, batch, plan,
                                                       f"({path['dtype']} compute, reported)"
                                                       if path["dtype"] != "float32" else
                                                       "(float32 compute)")
        del model, params, batch
        _free()
        if path["dtype"] != "float32":
            model, params, batch = _model_params_batch(path, "float32")
            plan32 = dc.replace(plan, fingerprint=shape_fingerprint(
                discover_meta(model.loss_with_ctx, params, batch)))
            row["gate_float32"] = _plan_step_gate(tag, model, params, batch, plan32,
                                                  "(float32 compute, the bf16 plan's maps)")
            del model, params, batch
            _free()
        out[tag] = row
    return out


def phase_max_batch(paths: dict, tune: dict) -> dict:
    """The paper's Table 7 on the card: per TABLE7 model and mode, the
    largest physical batch whose clipped gradient step runs under the
    paper's 16 GB budget (less the training loop's resident state,
    ``resident_state_bytes``), by trial (``max_batch_by_trial``: the
    allocator capped by ``set_per_process_memory_fraction``).  mixed_ghost
    on the tuned paths reuses the tune phase's certificate.  Each
    certificate is checked: the certified batch runs again under the same
    cap (gated; whether the next batch fails was reported until the tp part
    came: within about a percent of the answer a trial's outcome also turns
    on the allocator's state), and at the certified batch the kernels' step matches
    force_impl("torch")'s (norms NORM_TOL, sums KERNEL_GRAD_TOL; uncapped)
    so no kernel's index range breaks below it; the launch counters show
    the kernel side launched kernels only and the plain side none (the
    reused plan's kernel map included).  Ratios against vmap and
    non_private."""
    import torch

    from repro_torch.core.clipping import ClipConfig, dp_value_and_clipped_grad
    from repro_torch.kernels import dispatch, launches
    from repro_torch.tuner import ClipPlan
    from repro_torch.tuner import max_batch as mb
    from repro_torch.utils.tree import flatten_dict

    out = {}
    for tag, modes in TABLE7.items():
        path = paths[tag]
        model, params, batch = _model_params_batch(path)
        reserved = mb.resident_state_bytes(params)
        cap = mb.DEFAULT_BUDGET_BYTES - reserved
        rows = out[tag] = {}
        for mode in modes:
            reuse = mode == "mixed_ghost" and tag in tune
            plan = ClipPlan.from_json(json.dumps(tune[tag]["plan"])) if reuse else None
            fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode, plan=plan))
            runner = mb._default_runner(fn, params, batch)
            if reuse:
                got, n, seconds = plan.physical_batch, tune[tag]["trials"], None
                source = "tune phase (under its plan)"
            else:
                with _TrialCounter() as trials:
                    t0 = time.perf_counter()
                    got = mb.max_batch_by_trial(fn, params, batch,
                                                budget_bytes=mb.DEFAULT_BUDGET_BYTES,
                                                hi_cap=MAX_BATCH_HI_CAP, reserved_bytes=reserved)
                    seconds = time.perf_counter() - t0
                n, source = len(trials.sizes), "trials"
            require(got > 0, f"max_batch {tag} {mode}: nothing fits")
            with mb._memory_fraction(model.device, cap):
                holds = mb.trial_survives(runner, got, attempts=2)
            require(holds, f"max_batch {tag} {mode}: the certified batch {got} no longer runs "
                    "under the cap")
            check = None
            if mode in ("mixed_ghost", "bk_mixed"):
                big = mb.batch_at(batch, got)
                c0 = launches.snapshot()
                _, g_k, aux_k = fn(params, big)
                c1 = launches.snapshot()
                g_k = flatten_dict(g_k)
                with dispatch.force_impl("torch"):
                    _, g_p, aux_p = fn(params, big)
                c2 = launches.snapshot()
                check = {"norm_rel_err": _max_rel(aux_k["per_sample_norms"],
                                                  aux_p["per_sample_norms"]),
                         "grad_rel_err": _grad_rel_err(g_k, flatten_dict(g_p)),
                         "kernel_run": _launch_delta(c0, c1), "plain_run": _launch_delta(c1, c2)}
                del big, g_k, aux_k, g_p, aux_p
                # each side ran what it claims: a plan's kernel map must not
                # send the plain side back to the kernels
                require(check["kernel_run"]["torch"] == 0 and check["kernel_run"]["cuda"] > 0
                        and check["plain_run"]["cuda"] == 0 and check["plain_run"]["torch"] > 0,
                        f"max_batch {tag} {mode}: launches kernel side {check['kernel_run']}, "
                        f"plain side {check['plain_run']}")
                require(check["norm_rel_err"] <= NORM_TOL
                        and check["grad_rel_err"] <= KERNEL_GRAD_TOL,
                        f"max_batch {tag} {mode}: kernels vs plain at batch {got}: {check}")
            del fn, runner
            _free()
            sec = "" if seconds is None else f" in {seconds:.1f} s"
            print(f"max_batch {tag} {mode}: {got} ({source}: {n} trials{sec}); runs again under "
                  f"the cap {holds}; kernels vs plain at it {check}")
            rows[mode] = {"max_batch": got, "trials": n, "seconds": seconds, "source": source,
                          "holds": holds, "kernel_check": check}
        for base in ("vmap", "non_private"):
            if base in rows:
                ratios = {m: r["max_batch"] / rows[base]["max_batch"] for m, r in rows.items()
                          if m != base and isinstance(r, dict) and "max_batch" in r}
                rows[f"ratio_to_{base}"] = ratios
                print(f"max_batch {tag}: ratio to {base} " + ", ".join(
                    f"{m} {v:.2f}" for m, v in ratios.items()))
        del model, params, batch
        _free()
        torch.cuda.reset_peak_memory_stats()
    return out


# ------------------------------------------------------- attention kernel --
# (B, Sq, Skv, H, K, hd, causal, window, q_offset) and dtypes: Sq and Skv
# off the 64- and 128-row and the 32-, 64- and 128-key tiles, one query row
# at the end of the cache, a window smaller than Sq and one that cuts a
# key tile, non-causal, MHA (K = H), 1, 4 and 8 query heads per KV head,
# B = 3, every head dim, fp32 (at the longest prompt's shape too, timed:
# the fp32 SIMT instance, holding the long rows at full precision)
FLASH_RAGGED = [
    ((1, 2048, 2048, 32, 4, 128, True, None, 0), ("float32",)),
    ((1, 131, 131, 32, 4, 128, True, None, 0), ("bfloat16", "float32")),
    ((2, 100, 77, 8, 2, 64, True, None, 0), ("bfloat16", "float32")),
    ((1, 1, 2049, 32, 4, 128, True, None, 2048), ("bfloat16", "float32")),
    ((1, 300, 300, 8, 2, 128, True, 100, 0), ("bfloat16", "float32")),
    ((2, 70, 45, 4, 4, 64, False, None, 0), ("bfloat16", "float32")),
    ((1, 257, 257, 16, 16, 128, True, None, 0), ("bfloat16",)),
    ((3, 150, 150, 8, 1, 32, True, 40, 0), ("bfloat16", "float32")),
    ((1, 33, 80, 2, 2, 16, True, None, 47), ("bfloat16", "float32")),
    # the wgmma instance's edges: g = 8, 4 and 1 (a 128-row block holds 16,
    # 32 or 128 positions of 8, 4 or 1 heads), Sq off the block (a consumer
    # warpgroup idle or partly live), a window across the 128-key tiles, hd
    # 64, q_offset into a longer cache
    ((1, 200, 200, 8, 8, 128, True, None, 0), ("bfloat16",)),
    ((2, 129, 129, 16, 4, 128, True, None, 0), ("bfloat16",)),
    ((1, 64, 64, 8, 1, 128, True, None, 0), ("bfloat16",)),
    ((1, 777, 777, 32, 4, 64, True, 300, 0), ("bfloat16", "float32")),
    ((1, 90, 400, 8, 2, 128, True, None, 310), ("bfloat16",)),
]


def _wave_flash_specs() -> list:
    """(name, spec, calls per wave) of the wave_serve phase's attention
    calls: Phi-3-vision's prefill (576 + 32 positions, 32 heads of 96,
    causal), Whisper's decoder self-attention prefill and its
    cross-attention over the 1500 frames, a prefill's 32 queries and a
    decode step's one (WAVE_NEW - 1 steps)."""
    from repro_torch.configs.registry import get_arch

    phi, wh = get_arch("phi-3-vision-4.2b"), get_arch("whisper-large-v3")
    n = WAVE_SLOTS
    p_len = phi.prefix_tokens + WAVE_PROMPT
    return [
        ("phi3v prefill", (n, p_len, p_len, phi.n_heads, phi.n_kv, phi.resolved_head_dim, True,
                           None, 0), phi.n_layers),
        ("whisper self prefill", (n, WAVE_PROMPT, WAVE_PROMPT, wh.n_heads, wh.n_kv,
                                  wh.resolved_head_dim, True, None, 0), wh.n_layers),
        ("whisper cross prefill", (n, WAVE_PROMPT, wh.encoder_seq, wh.n_heads, wh.n_kv,
                                   wh.resolved_head_dim, False, None, 0), wh.n_layers),
        ("whisper cross decode", (n, 1, wh.encoder_seq, wh.n_heads, wh.n_kv,
                                  wh.resolved_head_dim, False, None, 0),
         wh.n_layers * (WAVE_NEW - 1)),
    ]


def _live_pairs(sq: int, skv: int, causal: bool, window, q_offset: int) -> int:
    """The (query, key) pairs the masks leave, summed over the query rows."""
    import torch

    qi = q_offset + torch.arange(sq)[:, None]
    kj = torch.arange(skv)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= (qi - kj) < window
    return int(mask.sum())


def _flash_bound(spec, dtype: str) -> tuple[float, str]:
    """Least time (ms) of one attention call: max(bytes of q, k, v at their
    K heads and o / HBM rate, 4 * B * H * hd * live pairs / the peak rate
    of the operands' type)."""
    import torch

    b, sq, skv, h, kh, hd, causal, window, q_offset = spec
    size = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    flops = 4 * b * h * hd * _live_pairs(sq, skv, causal, window, q_offset)
    nbytes = size * hd * b * (2 * sq * h + 2 * skv * kh)
    t_ops = flops / PEAK_FLOPS_PER_S[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _sdpa_repeated(q, k, v, causal: bool, window):
    """The yardstick of a grouped or windowed call: PyTorch's fused attention
    with each KV head repeated over its query heads and the causal and
    window masks as one boolean mask, on (B, H, S, hd) views."""
    import torch
    import torch.nn.functional as F

    sq, skv = q.shape[1], k.shape[1]
    g = q.shape[2] // k.shape[2]
    qi = torch.arange(sq, device=q.device)[:, None]
    kj = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= (qi - kj) < window
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
    return F.scaled_dot_product_attention(q.transpose(1, 2), kt, vt, attn_mask=mask)


def _flash_case(spec, dtype: str, gen, timed: bool, repeated_kv: bool = False,
                plain_rows: int = None) -> dict:
    """``repeated_kv``: the yardstick is ``_sdpa_repeated`` (the MoE and
    hybrid serve prefills), else SDPA's own causal GQA.  ``plain_rows``: the
    plain version runs that many query rows at a time (each block over every
    key, its ``q_offset`` the block's first row), where its whole scores
    would not fit; a causal call at ``SERVE_JAMBA_ROWS // 2`` rows or more
    is timed against SDPA's ``is_causal`` with the KV heads repeated, whose
    mask is not materialised."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa

    b, sq, skv, h, kh, hd, causal, window, q_offset = spec
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    q, k, v = rnd(b, sq, h, hd), rnd(b, skv, kh, hd), rnd(b, skv, kh, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def plain():
        if plain_rows is None or sq <= plain_rows:
            return fa.flash_attention_plain(q, k, v, **kw)
        return torch.cat([fa.flash_attention_plain(q[:, i:i + plain_rows], k, v, causal=causal,
                                                   window=window, q_offset=q_offset + i)
                          for i in range(0, sq, plain_rows)], dim=1)

    got = fa.flash_attention_cuda(q, k, v, **kw)
    want = plain()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"flash_attention {spec}: non-finite output")
    diff, ref = (got.float() - want.float()).abs(), want.float().abs()
    abs_err = float(diff.max())
    max_rel = abs_err / max(float(ref.max()), 1e-30)
    # per query row (b, i, h): its largest error over its largest |plain|
    row_rel = float((diff.amax(-1) / ref.amax(-1).clamp_min(1e-30)).max())
    rel_err = row_rel if dtype == "bfloat16" else max_rel
    tol = FLASH_TOL[dtype]
    case = {"spec": list(spec), "dtypes": [dtype], "max_abs_err": abs_err, "rel_err": rel_err,
            "max_rel_err": max_rel, "row_rel_err": row_rel, "tol": tol,
            "deterministic": bool(torch.equal(got, fa.flash_attention_cuda(q, k, v, **kw)))}
    timing = ""
    if timed:
        # the yardstick: PyTorch's fused attention on the (B, H, S, hd) views
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        iters = 10
        case["ms"] = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), iters)
        case["device_ms"] = device_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), iters)
        case["plain_ms"] = cuda_ms(plain, iters)
        if plain_rows is not None and causal and window is None and not repeated_kv:
            g = h // kh
            kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
            case["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), iters)
        elif repeated_kv:
            case["library_ms"] = cuda_ms(lambda: _sdpa_repeated(q, k, v, causal, window), iters)
        else:
            case["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), iters)
        case["bound_ms"], case["bound_by"] = _flash_bound(spec, dtype)
        b, sq, skv, h, _, hd, causal, window, q_offset = spec
        flops = 4 * b * h * hd * _live_pairs(sq, skv, causal, window, q_offset)
        case["tflops"] = flops / case["ms"] / 1e9
        case["bound_share"] = case["bound_ms"] / case["ms"]
        timing = _timing(case).replace("library=", "sdpa=")
    status = "ok" if rel_err <= tol else "MISMATCH"
    print(f"  flash_attention {tuple(spec)} {dtype}: rel_err={rel_err:.2e} (tol {tol:.0e}; "
          f"of the largest entry {max_rel:.2e}, per row {row_rel:.2e}) "
          f"deterministic={case['deterministic']}{timing} {status}")
    require(rel_err <= tol, f"flash_attention {spec} {dtype}: rel err {rel_err:.3e}")
    require(case["deterministic"], f"flash_attention {spec} {dtype}: repeated calls differ")
    return case


def phase_flash_kernel() -> list:
    """The attention kernel at the serve phases' prefill shapes (one call per
    attention layer per prompt; timed): Yi-6B's eight bf16 prefills, then
    the fp32 prefills of moe_serve (Mixtral, GQA 32/8, window 4096) and of
    hybrid_serve (the jamba path's one attention layer, GQA 64/8), with
    the repeated-KV SDPA yardstick; then wave_serve's calls in bf16 and fp32
    (``_wave_flash_specs``: the fp32 ones sum into the wave's row); then at
    the ragged shapes."""
    import torch

    from repro_torch.configs.registry import get_arch

    cfg = _serve_cfg()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    print(f"kernel flash_attention: {SERVE_ARCH} prefill shapes ({cfg.n_layers} calls each)")
    for n in PROMPT_LENS:
        spec = (1, n, n, cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim, True, cfg.window, 0)
        case = _flash_case(spec, cfg.dtype, gen, timed=True)
        case["path"], case["calls_per_step"] = "serve", cfg.n_layers
        cases.append(case)
    total = {key: None if any(c[key] is None for c in cases)
             else sum(c[key] for c in cases) * cfg.n_layers
             for key in ("ms", "device_ms", "library_ms", "bound_ms")}
    dev = "not measured" if total["device_ms"] is None else f"{total['device_ms']:.3f}"
    print(f"flash_attention over the {len(PROMPT_LENS)} prefills: kernel {total['ms']:.3f} ms "
          f"(device {dev}), sdpa {total['library_ms']:.3f}, bound {total['bound_ms']:.3f}")
    for tag, name, prompts, layers in (
            ("moe_serve", "mixtral-8x7b", MOE_SERVE_PROMPTS, 2),
            ("hybrid_serve", "jamba-1.5-large-398b", HYBRID_SERVE_PROMPTS,
             JAMBA_PERIOD.count("attn"))):
        arch = get_arch(name)
        print(f"kernel flash_attention: {tag} {name} fp32 prefill shapes ({layers} calls "
              "each; yardstick: SDPA with the KV heads repeated and the masks as one mask)")
        rows = []
        for n in prompts:
            spec = (1, n, n, arch.n_heads, arch.n_kv, arch.resolved_head_dim, True,
                    arch.window, 0)
            case = _flash_case(spec, "float32", gen, timed=True, repeated_kv=True)
            case["path"], case["calls_per_step"] = tag, layers
            rows.append(case)
        total = {key: None if any(c[key] is None for c in rows)
                 else sum(c[key] for c in rows) * layers
                 for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}
        dev = "not measured" if total["device_ms"] is None else f"{total['device_ms']:.3f}"
        print(f"flash_attention over the {tag} prefills: kernel {total['ms']:.3f} ms (device "
              f"{dev}), plain {total['plain_ms']:.3f}, sdpa (repeated KV) "
              f"{total['library_ms']:.3f}, bound {total['bound_ms']:.3f}")
        cases += rows
    print("kernel flash_attention: wave_serve shapes (Whisper hd 64, Phi-3-vision hd 96; "
          "calls per fp32 wave)")
    rows = []
    for name, spec, calls in _wave_flash_specs():
        for dtype in ("bfloat16", "float32"):
            case = _flash_case(spec, dtype, gen, timed=True)
            case["case"] = name
            if dtype == "float32":  # the gated wave's calls
                case["path"], case["calls_per_step"] = "wave_serve", calls
            rows.append(case)
    for dtype in ("bfloat16", "float32"):
        mine = [c for c in rows if c["dtypes"] == [dtype]]
        calls = [c for _, _, c in _wave_flash_specs()]
        total = {key: None if any(c[key] is None for c in mine)
                 else sum(c[key] * n for c, n in zip(mine, calls))
                 for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"flash_attention over one {dtype} wave of both models: kernel "
              f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f}, sdpa "
              f"{total['library_ms']:.3f}, bound {total['bound_ms']:.3f}")
    cases += rows
    print("kernel flash_attention: ragged shapes")
    for spec, dtypes in FLASH_RAGGED:
        for dtype in dtypes:
            cases.append(_flash_case(spec, dtype, gen, timed=spec == FLASH_RAGGED[0][0]))
    return cases


# ------------------------------------------------------------------ serve --
def _batched(states: list) -> dict:
    """Lane-batch B=1 serving states: dim 0 of pos, dim 1 of cache leaves."""
    import torch

    from repro_torch.utils.tree import tree_map

    return {"pos": torch.cat([st["pos"] for st in states]),
            "cache": tree_map(lambda *xs: torch.cat(xs, dim=1), *(st["cache"] for st in states))}


def _median_ms(fn, n: int) -> float:
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _serve_cfg():
    """The serve phase's Yi-6B: full width, SERVE_LAYERS layers."""
    from repro_torch.configs.registry import get_arch

    return dataclasses.replace(get_arch(SERVE_ARCH), n_layers=SERVE_LAYERS)


def phase_serve() -> dict:
    import torch

    from repro_torch.configs.registry import build_model, get_arch
    from repro_torch.kernels import dispatch, launches
    from repro_torch.launch.serve import submit_all
    from repro_torch.serving import Engine, aggregate_metrics, sequential_decode
    from repro_torch.utils.tree import flatten_dict

    cfg = _serve_cfg()
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in flatten_dict(params).values())
    print(f"serve {SERVE_ARCH}: {n_params} parameters ({cfg.param_dtype}) drawn on the card "
          f"in {init_s:.1f} s; {cfg.dtype} compute")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = [torch.randint(1, cfg.vocab, (n,), generator=gen, device="cuda").tolist()
               for n in PROMPT_LENS]
    # warm-up outside the engine (cuBLAS handles, allocator), not counted
    logits, warm = model.prefill(params, {"tokens": torch.ones(1, 16, dtype=torch.long,
                                                               device="cuda")},
                                 model.init_state(1, 32))
    model.decode_step(params, logits[:, -1:].argmax(-1), warm)
    del warm

    engine = Engine(model, params, n_slots=SLOTS, page_size=PAGE,
                    max_len=max(PROMPT_LENS) + MAX_NEW, eos_id=None)
    submit_all(engine, prompts, max_new=MAX_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()  # the serve path's counts start here ...
    t0 = time.perf_counter()
    completions = engine.drain()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launches.snapshot()  # ... and are read here
    peak = torch.cuda.max_memory_allocated()
    m = aggregate_metrics(completions)
    tokens = [completions[i].tokens for i in range(len(prompts))]
    print(f"serve: {int(m['tokens'])} tokens in {wall_s:.2f} s, {m['tok_per_s']:.1f} tok/s | "
          f"TTFT p50 {m['ttft_p50_ms']:.1f} ms p95 {m['ttft_p95_ms']:.1f} ms | per-token p50 "
          f"{m['per_token_p50_ms']:.1f} ms p95 {m['per_token_p95_ms']:.1f} ms | peak memory "
          f"{peak / 2**20:.1f} MiB | {engine.steps} engine steps")
    print(f"serve: kernel launches {counts}")
    require(m["tokens"] == len(PROMPT_LENS) * MAX_NEW and m["requests"] == len(PROMPT_LENS),
            f"serve: {m['tokens']} tokens from {m['requests']} requests")
    require(counts["flash_attention"] == {"cuda": cfg.n_layers * len(PROMPT_LENS), "torch": 0,
                                          "fake": 0},
            f"serve: flash_attention launches {counts['flash_attention']}")
    require(all(v == {"cuda": 0, "torch": 0, "fake": 0} for k, v in counts.items()
                if k != "flash_attention"), f"serve: other kernels ran {counts}")
    out = {"metrics": m, "wall_s": wall_s, "peak_bytes": peak, "engine_steps": engine.steps,
           "n_params": n_params, "init_s": init_s,
           "launches": {k: counts[k]["cuda"] for k in KERNEL_INFO}}

    # one profiled prefill (the 2048 prompt) and one profiled 4-lane decode step
    longest = torch.tensor([prompts[0]], device="cuda")
    view = engine.view_len

    def prefill(toks):
        return model.prefill(params, {"tokens": toks}, model.init_state(1, view))

    out["prefill_median_ms"] = _median_ms(lambda: prefill(longest), 3)
    print(f"serve: prefill of {PROMPT_LENS[0]} tokens, median {out['prefill_median_ms']:.2f} ms")
    out["prefill_trace"] = _profiled(lambda: prefill(longest), out["prefill_median_ms"])
    lanes = [prefill(torch.tensor([p], device="cuda")) for p in prompts[:SLOTS]]
    batch_state = _batched([st for _, st in lanes])
    lane_toks = torch.cat([lg[:, -1:].argmax(-1) for lg, _ in lanes])  # (4, 1)
    out["decode_median_ms"] = _median_ms(
        lambda: model.decode_step(params, lane_toks, batch_state), 5)
    print(f"serve: one {SLOTS}-lane decode step, median {out['decode_median_ms']:.2f} ms")
    out["decode_trace"] = _profiled(lambda: model.decode_step(params, lane_toks, batch_state),
                                    out["decode_median_ms"])

    # compare 1: the 2048-token prefill on the kernel against the plain path,
    # gated in fp32 compute on the same parameters, reported in bf16
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"), device="cuda")
    for tag, lm in (("float32", model32), (cfg.dtype, model)):
        state = lm.init_state(1, view)
        kernel_logits, _ = lm.prefill(params, {"tokens": longest}, state)
        with dispatch.force_impl("torch"):
            plain_logits, _ = lm.prefill(params, {"tokens": longest}, state)
        out[f"prefill_rel_err_{tag}"] = err = _max_rel(kernel_logits.float(),
                                                       plain_logits.float())
        gated = tag == "float32"
        print(f"compare serve prefill kernel vs torch ({tag} compute): logits rel err "
              f"{err:.2e} " + (f"(tol {SERVE_KERNEL_LOGIT_TOL:.0e})" if gated
                               else "(reported, not gated)"))
        require(not gated or err <= SERVE_KERNEL_LOGIT_TOL,
                f"serve {tag} prefill logits differ by {err:.3e}")
    del model32, state
    # compare 3: one batched 4-lane decode step against each lane's B=1 step
    batched, _ = model.decode_step(params, lane_toks, batch_state)
    single = torch.cat([model.decode_step(params, lane_toks[i:i + 1], st)[0]
                        for i, (_, st) in enumerate(lanes)])
    out["decode_rel_err"] = _max_rel(batched.float(), single.float())
    print(f"compare serve {SLOTS}-lane decode vs B=1 decodes: logits rel err "
          f"{out['decode_rel_err']:.2e} (tol {SERVE_LOGIT_TOL:.0e})")
    require(out["decode_rel_err"] <= SERVE_LOGIT_TOL,
            f"serve batched decode logits differ by {out['decode_rel_err']:.3e}")
    del lanes, batch_state
    # compare 2: the sequential oracle, first tokens and whole streams; where
    # a stream leaves it, what differs at the first diverging token
    t0 = time.perf_counter()
    want = sequential_decode(model, params, prompts, max_new=MAX_NEW, view_len=view)
    out["sequential_s"] = time.perf_counter() - t0
    out["engine_streams"], out["sequential_streams"] = tokens, want
    first_equal = sum(g[0] == w[0] for g, w in zip(tokens, want))
    out["streams_equal"] = sum(g == w for g, w in zip(tokens, want))
    out["tokens_equal"] = sum(a == b for g, w in zip(tokens, want) for a, b in zip(g, w))
    print(f"compare serve engine vs sequential_decode ({cfg.dtype} compute, "
          f"{out['sequential_s']:.1f} s): first tokens equal {first_equal}/{len(prompts)}; "
          f"streams equal token for token {out['streams_equal']}/{len(prompts)}; "
          f"{out['tokens_equal']}/{len(prompts) * MAX_NEW} tokens equal")
    require(first_equal == len(prompts), "serve: a first token differs from sequential_decode")
    if out["streams_equal"] < len(prompts):
        out["divergence"] = _serve_divergence(model, params, prompts, tokens, want, view)
    out["batched_vs_b1"] = _batch_scan(model, params, prompts)
    del model
    # compare 4 (gated): the same drain and oracle in fp32 compute
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"), device="cuda")
    got32 = _drain_tokens(model32, params, prompts)
    want32 = sequential_decode(model32, params, prompts, max_new=MAX_NEW, view_len=view)
    out["streams_equal_float32"] = sum(g == w for g, w in zip(got32, want32))
    print(f"compare serve engine vs sequential_decode (float32 compute): streams equal token "
          f"for token {out['streams_equal_float32']}/{len(prompts)}")
    require(out["streams_equal_float32"] == len(prompts),
            "serve: an fp32 engine stream differs from sequential_decode")
    return out


def _drain_tokens(model, params, prompts, spy=None) -> list:
    """Every request's tokens from a fresh Engine as the serve phase builds
    it; ``spy(engine, tokens, state, logits, new_state)`` sees each
    decode."""
    from repro_torch.launch.serve import submit_all
    from repro_torch.serving import Engine

    engine = Engine(model, params, n_slots=SLOTS, page_size=PAGE,
                    max_len=max(PROMPT_LENS) + MAX_NEW, eos_id=None)
    if spy is not None:
        real = model.decode_step

        def decode_step(params_, tokens, state):
            logits, new = real(params_, tokens, state)
            spy(engine, tokens, state, logits, new)
            return logits, new

        model.decode_step = decode_step  # the engine's decode looks it up per call
    try:
        submit_all(engine, prompts, max_new=MAX_NEW)
        done = engine.drain()
    finally:
        if spy is not None:
            del model.decode_step
    return [done[i].tokens for i in range(len(prompts))]


def _batch_scan(model, params, prompts) -> dict:
    """Every decode of a drain, lane by lane: the batched step's logits row
    and the K/V rows it writes against a B=1 decode from the lane's own
    input state.  Counts the (lane, step) pairs where either differs, and
    the first one where the K/V rows do (request, token, first layer)."""
    from repro_torch.utils.tree import flatten_dict

    decode = type(model).decode_step  # the unwatched step
    scan = {"lane_steps": 0, "logits_differ": 0, "kv_rows_differ": 0, "first_kv": None}

    def spy(engine, tokens, state, logits, new):
        new_flat = flatten_dict(new["cache"])
        for slot in engine.scheduler.active_slots():
            lane = slot.index
            one_logits, one = decode(model, params, tokens[lane:lane + 1], _lane_state(state, lane))
            row = int(state["pos"][lane])  # the cache row this decode writes
            layers = set()  # the layers whose written K or V row differs
            for path, leaf in flatten_dict(one["cache"]).items():
                if path.endswith("/k") or path.endswith("/v"):
                    differ = (leaf[:, 0, row] != new_flat[path][:, lane, row]).flatten(1).any(1)
                    layers.update(differ.nonzero().flatten().tolist())
            scan["lane_steps"] += 1
            scan["logits_differ"] += not _equal(one_logits[0], logits[lane])
            if layers:
                scan["kv_rows_differ"] += 1
                if scan["first_kv"] is None:
                    scan["first_kv"] = {"request": slot.request.rid, "token": slot.generated,
                                        "first_layer": min(layers),
                                        **_batch_variance(model, params, tokens, state, lane)}

    _drain_tokens(model, params, prompts, spy)
    print(f"serve batched vs B=1 decode, every lane and step of a drain: "
          f"{scan['logits_differ']} of {scan['lane_steps']} logits rows differ, "
          f"{scan['kv_rows_differ']} written K/V rows differ (first {scan['first_kv']})")
    return scan


def _top2_gap(logits) -> float:
    top = logits.float().topk(2).values
    return float(top[0] - top[1])


def _lane_state(state: dict, lane) -> dict:
    """One lane (an int) or every lane (slice(None)) of a lane-batched
    serving state, copied out."""
    from repro_torch.utils.tree import tree_map

    rows = slice(lane, lane + 1) if isinstance(lane, int) else lane
    return {"pos": state["pos"][rows].clone(),
            "cache": tree_map(lambda x: x[:, rows].clone(), state["cache"])}


def _state_diff(got: dict, want: dict, prompt_len: int) -> dict:
    """Two B=1 serving states: positions and fill levels equal or not, and
    the largest |K/V| difference on the cache rows the lane attends (cache
    position >= 0), split into prompt rows and decode rows, with the first
    layer where those rows differ; rows it does not attend, apart."""
    from repro_torch.utils.tree import flatten_dict

    g_flat, w_flat = flatten_dict(got["cache"]), flatten_dict(want["cache"])
    out = {"top_pos_equal": bool(_equal(got["pos"], want["pos"])),
           "cache_pos_equal": all(_equal(g_flat[k], v) for k, v in w_flat.items()
                                  if k.endswith("pos")),
           "cache_idx_equal": all(_equal(g_flat[k], v) for k, v in w_flat.items()
                                  if k.endswith("idx")),
           "kv_prompt_rows": 0.0, "kv_decode_rows": 0.0, "kv_masked_rows": 0.0,
           "first_layer": None}
    for path, leaf in w_flat.items():
        if not (path.endswith("/k") or path.endswith("/v")):
            continue
        pos = w_flat[path[:-1] + "pos"]  # (L, 1, rows)
        diff = (leaf.float() - g_flat[path].float()).abs().amax(dim=(-2, -1))
        for key, rows in (("kv_prompt_rows", (pos >= 0) & (pos < prompt_len)),
                          ("kv_decode_rows", pos >= prompt_len), ("kv_masked_rows", pos < 0)):
            if rows.any():
                out[key] = max(out[key], float(diff[rows].max()))
        live = (diff * (pos >= 0)).amax(dim=(1, 2))  # per layer
        if live.any():
            first = int(live.nonzero()[0, 0])
            out["first_layer"] = first if out["first_layer"] is None else min(
                out["first_layer"], first)
    return out


def _batch_variance(model, params, tokens, state, lane: int) -> dict:
    """One decode as the engine ran it (every lane in one batch: ``tokens``,
    ``state``) and for ``lane`` alone from the same lane state: per layer,
    whether the attention's input (q) and output rows for the lane are
    equal, and the first layer where they differ."""
    from repro_torch.kernels import dispatch

    decode = type(model).decode_step  # the unwatched step
    real = dispatch.flash_attention

    def run(toks, st):
        calls = []

        def record(q, k, v, **kw):
            out = real(q, k, v, **kw)
            calls.append((q.clone(), out.clone()))
            return out

        dispatch.flash_attention = record
        try:
            logits = decode(model, params, toks, st)[0]
        finally:
            dispatch.flash_attention = real
        return logits, calls

    many, many_calls = run(tokens, state)
    one, one_calls = run(tokens[lane:lane + 1], _lane_state(state, lane))
    q_equal = [_equal(a[0][lane:lane + 1], b[0]) for a, b in zip(many_calls, one_calls)]
    out_equal = [_equal(a[1][lane:lane + 1], b[1]) for a, b in zip(many_calls, one_calls)]
    return {"lane": lane, "logits_equal": _equal(many[lane:lane + 1], one),
            "first_layer_attention_input_differs":
                q_equal.index(False) if False in q_equal else None,
            "first_layer_attention_output_differs":
                out_equal.index(False) if False in out_equal else None,
            "attention_differs_on_equal_inputs": [
                i for i, (qe, oe) in enumerate(zip(q_equal, out_equal)) if qe and not oe]}


def _equal(x, y) -> bool:
    import torch

    return bool(torch.equal(x, y))


def _serve_divergence(model, params, prompts, got, want, view) -> dict:
    """The first token (lowest index, then lowest request) where an engine
    stream leaves sequential_decode's, and what differs there.

    The engine is drained again with the decodes of that request watched:
    the lane's input state and logits row are kept at every step up to the
    diverging token.  sequential_decode's steps for the request are
    replayed beside them (a B=1 prefill, then B=1 decodes of its tokens),
    and the two states are compared at each step: the first step where
    they differ, and where (prompt or decode rows, which layer).  At the
    diverging token: the engine's logits against a B=1 decode from the
    replayed state and from the engine's own lane state, each row's top-2
    gap, the replayed decode against itself; and the rerun's streams
    against the first drain's, two B=1 prefills of the prompt against each
    other."""
    import torch

    j, r = min((next(t for t, (a, b) in enumerate(zip(g, w)) if a != b), i)
               for i, (g, w) in enumerate(zip(got, want)) if g != w)
    seen = {}

    def spy(engine, tokens, state, logits, new):
        for slot in engine.scheduler.slots:
            if slot.active and slot.request.rid == r and 1 <= slot.generated <= j:
                lane = slot.index
                seen[slot.generated] = (_lane_state(state, lane),
                                        logits[lane, -1].float().clone(),
                                        tokens[lane:lane + 1].clone(), lane)

    rerun = _drain_tokens(model, params, prompts, spy)
    dev = model.device
    toks = {"tokens": torch.tensor([prompts[r]], device=dev)}
    logits0, state = model.prefill(params, toks, model.init_state(1, view))
    logits1, again = model.prefill(params, toks, model.init_state(1, view))
    prefill_repeat = _equal(logits0, logits1) and _state_diff(
        again, state, len(prompts[r]))["first_layer"] is None
    del again
    first = None
    for t in range(1, j + 1):  # state: the replay's input to the decode emitting token t
        diff = _state_diff(seen[t][0], state, len(prompts[r]))
        if first is None and (diff["first_layer"] is not None or not diff["cache_pos_equal"]):
            first = {"step": t, **diff}
        if t < j:
            _, state = model.decode_step(params, torch.tensor([[want[r][t - 1]]], device=dev),
                                         state)
    lane_state, eng, tok, lane = seen[j]
    tok_in = torch.tensor([[want[r][j - 1]]], device=dev)
    seq = model.decode_step(params, tok_in, state)[0][0, -1].float()
    seq_again = model.decode_step(params, tok_in, state)[0][0, -1].float()
    own = model.decode_step(params, tok, lane_state)[0][0, -1].float()
    res = {
        "request": r, "token": j, "prompt_len": len(prompts[r]), "lane": lane,
        "engine_token": got[r][j], "sequential_token": want[r][j],
        "rerun_streams_equal_first_drain": rerun == got,
        "prefill_repeat_equal": prefill_repeat,
        "first_state_difference": first,
        "state_at_token": _state_diff(lane_state, state, len(prompts[r])),
        "engine_vs_b1_replayed_max_abs_diff": float((eng - seq).abs().max()),
        "engine_vs_b1_own_state_max_abs_diff": float((eng - own).abs().max()),
        "b1_replayed_repeat_equal": _equal(seq, seq_again),
        "engine_argmax": int(eng.argmax()), "b1_replayed_argmax": int(seq.argmax()),
        "engine_top2_gap": _top2_gap(eng), "b1_replayed_top2_gap": _top2_gap(seq),
        "logit_scale": float(seq.abs().max()),
    }
    print("serve divergence: " + json.dumps(res))
    return res


def summary_line(kernels: dict, runs: dict) -> dict:
    """Per kernel: times and bound summed over the calls at the main-path
    shapes of one training step of each path that launches it (the step of
    the mode that launches it: ghost norms mixed_ghost, the contractions
    bk_mixed), and for the attention kernel over the serve phase's eight
    prefills (one call per layer); launches summed over the paths' runs.
    The ghost_norm_sq row sums its dense and conv entries."""
    rows = []
    for kernel, (source, replaces) in KERNEL_INFO.items():
        entries = kernels[kernel] + (kernels["conv_ghost_norm_sq"]
                                     if kernel == "ghost_norm_sq" else [])
        main = [c for c in entries if "calls_per_step" in c]
        total = {key: sum(c[key] * c["calls_per_step"] for c in main)
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by_ops = sum(c["bound_ms"] * c["calls_per_step"] for c in main
                     if c["bound_by"] == "operations")
        rows.append({
            "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(out["launches"][kernel] for out in runs.values()),
            "max_abs_err": max(c["max_abs_err"] for c in main),
            "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": "operations" if by_ops >= total["bound_ms"] / 2 else "bytes",
            "library_ms": total["library_ms"],
        })
    return {"kernels": rows}


def per_path_lines(kernels: dict, runs: dict) -> dict:
    """The summary line's sums split by path (PERF.md's kernel table reads
    them): per kernel and path, ms (CUDA events), device ms (profiler; None
    where a call has none), plain, library and bound ms summed over one
    step's (or the serve phase's) main-path calls, and the path's launches
    in its run."""
    out = {}
    for kernel in KERNEL_INFO:
        entries = kernels[kernel] + (kernels["conv_ghost_norm_sq"]
                                     if kernel == "ghost_norm_sq" else [])
        by_path = {}
        for c in entries:
            if "calls_per_step" in c:
                by_path.setdefault(c.get("path", "serve"), []).append(c)
        for tag, main in by_path.items():
            row = {key: sum(c[key] * c["calls_per_step"] for c in main)
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
            dev = [c.get("device_ms") for c in main]
            row["device_ms"] = (None if any(d is None for d in dev) else
                                sum(d * c["calls_per_step"] for d, c in zip(dev, main)))
            row["launches"] = runs[tag]["launches"][kernel] if tag in runs else None
            out[f"{kernel} {tag}"] = row
            d = "not measured" if row["device_ms"] is None else f"{row['device_ms']:.4f}"
            print(f"kernel {kernel} per {tag} step: {row['ms']:.4f} ms [device {d}], plain "
                  f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, bound "
                  f"{row['bound_ms']:.4f}; {row['launches']} launches in the run")
    return out


def _model_params_batch(path: dict, dtype=None, remat: bool = True, batch: int = None):
    """A path's model (in ``dtype`` compute where given, its stacks
    rematerialised or not), its parameters from seed 0 and the batch of
    step 0 (``batch`` samples, else the path's batch)."""
    import torch

    model = path["build"](dtype, remat)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    return model, params, _path_batch(path, batch or path["batch"], 0)


def _paths() -> dict:
    """The training paths (``_path_specs``), with the kernel shapes and
    expected launches of their taps.  Each phase builds a path's model anew
    (seed 0) and drops it after, so one path's memory never counts in
    another's peak."""
    specs = _path_specs()
    for tag, path in specs.items():
        model, params, batch = _model_params_batch(path)
        path["dtype"] = _name(model.dtype)
        path["shapes"], path["expected"], path["taps_shapes"] = main_path_shapes(
            model, params, batch)
        if not any(mode.endswith("_taps") for mode in path["modes"]):
            path["taps_shapes"] = {k: [] for k in path["taps_shapes"]}
        print(f"{tag} at batch {path['batch']} ({path['dtype']} compute): "
              f"expected kernel launches per step {path['expected']}")
        del model, params, batch
    return specs


def _path_specs() -> dict:
    """The training paths: each one's model builder (on the card unless
    asked otherwise), batch, modes and optimizer."""
    import torch

    from repro_torch.configs.paper_native import BEIT_LARGE, VIT_BASE
    from repro_torch.models.cnn import VGG
    from repro_torch.models.vit import ViT

    def vit(base, n_classes):
        def build(dtype=None, remat=True):
            cfg = dataclasses.replace(base, remat=remat, **({} if dtype is None
                                                            else {"dtype": dtype}))
            return ViT(cfg, image_size=224, patch=16, n_classes=n_classes, device="cuda")
        return build

    specs = {
        # the paper's Table 6 batch; DP modes step on the privatized mean of
        # gradients clipped to norm 1, non_private (as in the JAX package) on
        # the plain sum of unclipped gradients (per-sample norms ~200 at init)
        "vgg19": dict(build=lambda dtype=None, remat=True, device="cuda": VGG(
                          "vgg19", dtype=getattr(torch, dtype or "float32"), device=device),
                      batch=128, image=32, n_classes=10, modes=MODES,
                      lr={"non_private": 0.05 / (128 * 200), "dp": 0.05}),
        # ViT-Base/16 on CIFAR-10 upscaled to 224, as the paper fine-tunes
        # its ViTs (VIT_BASE_LAYERS of its 12 layers); small learning rates
        # keep its noisy coordinates finite.  bf16 compute, each layer
        # rematerialised (the config's default); the oracle's gate runs it
        # in fp32 compute
        "vit_base": dict(build=vit(dataclasses.replace(VIT_BASE, n_layers=VIT_BASE_LAYERS), 10),
                         batch=32, image=224, n_classes=10,
                         modes=MODES, lr={"non_private": 1e-3 / 32, "dp": 1e-3}),
        # BEiT-Large/16 (full width, d_model 1024; BEIT_LAYERS of 24 layers), the
        # paper's headline model, at 1000 classes: bf16 compute, remat on;
        # the oracle at 8 samples in fp32 compute
        "beit_large": dict(build=vit(dataclasses.replace(BEIT_LARGE, n_layers=BEIT_LAYERS), 1000),
                           batch=32, image=224, n_classes=1000,
                           modes=BEIT_MODES, oracle_batch=8,
                           lr={"non_private": 1e-3 / 32, "dp": 1e-3}),
    }
    specs.update(_lm_paths())
    return specs


def _lm_paths() -> dict:
    """DP training of the decoder LMs at full width, depth cut: Yi-6B (1 of
    32 layers since the tp part came, 2 before, 8 until the recurrent paths
    came and the run's time needed the cut; d_model 4096, 32 query heads over 4 KV heads, d_ff 11008,
    vocab 64000) at batch 4 and Mixtral-8x7B (1 of 32 layers, 2 before the
    same cut; 8 experts top 2, d_ff 14336, 8 KV heads, window 4096, vocab
    32000) at batch 2, both at 4096 tokens (the registry's train_4k
    length), bf16 compute with fp32 parameters, remat on (the configs'
    default).  Yi-6B steps with adamw; Mixtral steps with plain sgd (at 2
    layers, 3.17B parameters with adamw's two fp32 moments did not fit the
    card's update: 9 x 12.7 GB).
    The recurrent LMs: Jamba-1.5-Large (d_model 8192, 64 query heads over 8
    KV heads of 128, d_ff 24576, Mamba d_inner 16384 in 256 SSM heads of 64
    with d_state 64, conv k 4, chunk 256, vocab 65536) cut to a two-layer
    period ("mamba", "attn") with MoE on every other layer (layer 0 Mamba +
    SwiGLU MLP, layer 1 attention + MoE, as Jamba's layers 2-3 are) and 2 of
    its 16 experts (top 2, each at full width): 3.44B parameters in the
    config's bf16, at batch 2 x 2048 (2 x 4096 until the tp part came: cut
    for the run's time), sgd; and xLSTM-350M at full width
    (d_model 1024, 4 heads, mLSTM d_inner 2048, vocab 50304) cut to
    XLSTM_PERIOD (2 layers: one sLSTM, then one mLSTM) at batch 4 x 1024
    (4 x 2048 until the tp part came: the sLSTM's loop runs a token at a time),
    adamw; both bf16 compute, remat on, RECURRENT_STEPS timed steps.
    The xLSTM's depth and both paths' steps are cut for the run's time: the
    sLSTM's time loop is host-bound (~20 small launches a token a layer).
    Each path's oracle runs a smaller cut in fp32 compute: Yi-6B at 2
    layers, batch 2, 512 tokens; Mixtral at 1 layer, batch 2, 256 tokens;
    Jamba and xLSTM at one period, batch 2, 256 tokens.  fp32 compute (the
    compare and oracle gates) also takes fp32 parameters: a gradient
    rounded to Jamba's bf16 leaves would move by a bf16 step wherever two
    fp32 sums straddle a rounding boundary.
    The frontend families at full width: Whisper-large-v3 (d_model 1280,
    20 heads of 64, d_ff 5120, vocab 51866, LayerNorm/GELU, q/k/v biases)
    cut to WHISPER_LAYERS of its 32 encoder and of its 32 decoder layers,
    at batch 8 x 448 text tokens (its decoder's context) over 1500 stub
    frames (B, 1500, 1280); Phi-3-vision-4.2b (d_model 3072, 32 heads of
    96, d_ff 8192, vocab 32064) cut to PHI3V_LAYERS of its 32 layers, at
    batch 4 x 2048 positions: the 576 x 1024 stub patch prefix (CLIP
    ViT-L/14's 24 x 24 patches) and 1472 text tokens; both bf16 compute,
    remat on, sgd.  Oracles in fp32: Whisper 1 + 1 layers, batch 2, 1500
    frames, 64 tokens; Phi-3-vision 1 layer, batch 2, 576 + 64 positions."""
    from repro_torch.configs.registry import build_model, get_arch
    from repro_torch.optim import adamw, sgd

    def lm(name, layers, **fixed):
        def build(dtype=None, remat=True, n_layers=layers, device="cuda"):
            over = {} if dtype is None else {"dtype": dtype, "param_dtype": dtype}
            if get_arch(name).encoder_layers:  # Whisper: the encoder cut to the same depth
                over["encoder_layers"] = n_layers
            cfg = dataclasses.replace(get_arch(name), n_layers=n_layers, remat=remat,
                                      **fixed, **over)
            return build_model(cfg, device=device)
        return build

    return {
        "yi_6b": dict(build=lm("yi-6b", 1), batch=4, seq=4096, vocab=64000, modes=LM_MODES,
                      steps=LM_STEPS, optimizer=adamw, lr={"non_private": 1e-4, "dp": 1e-4},
                      compare_batch=2, oracle=dict(layers=2, batch=2, seq=512)),
        "mixtral": dict(build=lm("mixtral-8x7b", 1), batch=2, seq=4096, vocab=32000,
                        modes=LM_MODES, steps=LM_STEPS, optimizer=sgd,
                        lr={"non_private": 1e-5, "dp": 1e-3}, compare_batch=2,
                        oracle=dict(layers=1, batch=2, seq=256)),
        "jamba": dict(build=lm("jamba-1.5-large-398b", 2, block_pattern=JAMBA_PERIOD,
                               moe_experts=JAMBA_EXPERTS),
                      batch=2, seq=2048, vocab=65536, modes=LM_MODES, steps=RECURRENT_STEPS,
                      optimizer=sgd, lr={"non_private": 1e-5, "dp": 1e-3}, compare_batch=2,
                      compare_on_host=True, oracle=dict(layers=2, batch=2, seq=256),
                      recurrent=dict(heads=256, dk=64, dv=64, shared_qk=True)),
        "xlstm": dict(build=lm("xlstm-350m", len(XLSTM_PERIOD), block_pattern=XLSTM_PERIOD),
                      batch=4, seq=1024, vocab=50304,
                      modes=LM_MODES, steps=RECURRENT_STEPS, optimizer=adamw,
                      lr={"non_private": 1e-4, "dp": 1e-4}, compare_batch=2,
                      oracle=dict(layers=len(XLSTM_PERIOD), batch=2, seq=256),
                      profile_modes=("mixed_ghost",),
                      compare_spread=False,
                      profile_host_ops=False,
                      recurrent=dict(heads=4, dk=512, dv=513, slstm_d=1024)),
        "whisper": dict(build=lm("whisper-large-v3", WHISPER_LAYERS), arch="whisper-large-v3",
                        batch=8, seq=448, vocab=51866, modes=LM_MODES, steps=LM_STEPS,
                        optimizer=sgd, lr={"non_private": 1e-5, "dp": 1e-3}, compare_batch=2,
                        oracle=dict(layers=1, batch=2, seq=64)),
        "phi3v": dict(build=lm("phi-3-vision-4.2b", PHI3V_LAYERS), arch="phi-3-vision-4.2b",
                      batch=4, seq=2048, vocab=32064, modes=LM_MODES, steps=LM_STEPS,
                      optimizer=sgd, lr={"non_private": 1e-5, "dp": 1e-3}, compare_batch=2,
                      oracle=dict(layers=1, batch=2, seq=576 + 64)),
    }


def _oracle_path(path: dict) -> dict:
    """An LM path cut to its oracle's depth, batch and length."""
    o = path["oracle"]
    return {**path, "batch": o["batch"], "seq": o["seq"],
            "build": lambda dtype=None, remat=True: path["build"](dtype, remat, o["layers"])}


def phase_moe_serve() -> dict:
    """Mixtral-8x7B at full width (2 layers, fp32 compute) through the
    port's Engine: MOE_SERVE_PROMPTS with MOE_SERVE_NEW new tokens each, 4
    slots; each prefill launches flash_attention once per layer (the counts
    zeroed just before the drain, read just after); the streams must equal
    sequential_decode's token for token (the decode routes each lane within
    its own capacity, as the JAX engine's vmapped B=1 step does, and the
    prefill dispatches globally over its one request)."""
    import torch

    from repro_torch.configs.registry import build_model, get_arch
    from repro_torch.kernels import dispatch, launches
    from repro_torch.launch.serve import submit_all
    from repro_torch.serving import Engine, aggregate_metrics, sequential_decode
    from repro_torch.utils.tree import flatten_dict

    cfg = dataclasses.replace(get_arch("mixtral-8x7b"), n_layers=2, dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(x.numel() for x in flatten_dict(params).values())
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = [torch.randint(1, cfg.vocab, (n,), generator=gen, device="cuda").tolist()
               for n in MOE_SERVE_PROMPTS]
    engine = Engine(model, params, n_slots=SLOTS, page_size=PAGE,
                    max_len=max(MOE_SERVE_PROMPTS) + MOE_SERVE_NEW, eos_id=None)
    submit_all(engine, prompts, max_new=MOE_SERVE_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()  # the MoE serve path's counts start here ...
    t0 = time.perf_counter()
    completions = engine.drain()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launches.snapshot()  # ... and are read here
    peak = torch.cuda.max_memory_allocated()
    m = aggregate_metrics(completions)
    tokens = [completions[i].tokens for i in range(len(prompts))]
    print(f"moe_serve mixtral-8x7b (2 layers, {n_params} parameters, fp32): "
          f"{int(m['tokens'])} tokens in {wall_s:.2f} s, {m['tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{m['ttft_p50_ms']:.1f} ms, per-token p50 {m['per_token_p50_ms']:.1f} ms, peak "
          f"{peak / 2**20:.1f} MiB; kernel launches {counts}")
    require(m["tokens"] == len(prompts) * MOE_SERVE_NEW, f"moe_serve: {m['tokens']} tokens")
    require(counts["flash_attention"] == {"cuda": cfg.n_layers * len(prompts), "torch": 0,
                                          "fake": 0},
            f"moe_serve: flash_attention launches {counts['flash_attention']}")
    require(all(v == {"cuda": 0, "torch": 0, "fake": 0} for k, v in counts.items()
                if k != "flash_attention"), f"moe_serve: other kernels ran {counts}")
    want = sequential_decode(model, params, prompts, max_new=MOE_SERVE_NEW,
                             view_len=engine.view_len)
    equal = sum(g == w for g, w in zip(tokens, want))
    print(f"compare moe_serve engine vs sequential_decode (float32 compute): streams equal "
          f"token for token {equal}/{len(prompts)}")
    require(equal == len(prompts), "moe_serve: an engine stream differs from sequential_decode")
    # the longest prompt's prefill logits, kernel against plain (fp32)
    longest = torch.tensor([prompts[2]], device="cuda")
    state = model.init_state(1, engine.view_len)
    kernel_logits, _ = model.prefill(params, {"tokens": longest}, state)
    with dispatch.force_impl("torch"):
        plain_logits, _ = model.prefill(params, {"tokens": longest}, state)
    err = _max_rel(kernel_logits, plain_logits)
    print(f"compare moe_serve prefill kernel vs torch (float32 compute): logits rel err "
          f"{err:.2e} (tol {SERVE_KERNEL_LOGIT_TOL:.0e})")
    require(err <= SERVE_KERNEL_LOGIT_TOL, f"moe_serve prefill logits differ by {err:.3e}")
    return {"metrics": m, "wall_s": wall_s, "peak_bytes": peak, "n_params": n_params,
            "streams_equal": equal, "prefill_rel_err": err, "engine_streams": tokens,
            "launches": {k: counts[k]["cuda"] for k in KERNEL_INFO}}


def phase_hybrid_serve() -> dict:
    """The recurrent LMs through the port's Engine in fp32 compute: the
    jamba path's model (the two-layer period, 2 experts, full width; the
    config's bf16 parameters) and the whole xLSTM-350M (24 layers), each on
    HYBRID_SERVE_PROMPTS with HYBRID_SERVE_NEW new tokens, 4 slots.  Jamba
    keeps paged KV for its attention layer (one flash_attention launch per
    prefill) and per-lane dense state for its Mamba layer; xLSTM has no KV
    leaf (an empty page pool) and launches no kernel.  The counts are zeroed
    just before each drain and read just after; the streams must equal
    sequential_decode's token for token; Jamba's longest prefill's logits,
    kernel against plain, within SERVE_KERNEL_LOGIT_TOL."""
    import torch

    from repro_torch.configs.registry import build_model, get_arch
    from repro_torch.kernels import dispatch, launches
    from repro_torch.launch.serve import submit_all
    from repro_torch.serving import Engine, aggregate_metrics, sequential_decode
    from repro_torch.serving.kv_pages import kv_paths
    from repro_torch.utils.tree import flatten_dict

    out = {"launches": dict.fromkeys(KERNEL_INFO, 0)}
    for tag, cfg in (
            ("jamba", dataclasses.replace(
                get_arch("jamba-1.5-large-398b"), n_layers=len(JAMBA_PERIOD),
                block_pattern=JAMBA_PERIOD, moe_experts=JAMBA_EXPERTS, dtype="float32")),
            ("xlstm", dataclasses.replace(get_arch("xlstm-350m"), dtype="float32"))):
        model = build_model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        n_params = sum(x.numel() for x in flatten_dict(params).values())
        gen = torch.Generator(device="cuda").manual_seed(1)
        prompts = [torch.randint(1, cfg.vocab, (n,), generator=gen, device="cuda").tolist()
                   for n in HYBRID_SERVE_PROMPTS]
        engine = Engine(model, params, n_slots=SLOTS, page_size=PAGE,
                        max_len=max(HYBRID_SERVE_PROMPTS) + HYBRID_SERVE_NEW, eos_id=None)
        paged = len(kv_paths(engine._template["cache"]))
        submit_all(engine, prompts, max_new=HYBRID_SERVE_NEW)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches.reset()  # this model's serve counts start here ...
        t0 = time.perf_counter()
        completions = engine.drain()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = launches.snapshot()  # ... and are read here
        peak = torch.cuda.max_memory_allocated()
        m = aggregate_metrics(completions)
        tokens = [completions[i].tokens for i in range(len(prompts))]
        attn = cfg.block_pattern.count("attn") * (cfg.n_layers // len(cfg.block_pattern))
        print(f"hybrid_serve {cfg.name} ({cfg.n_layers} layers, {n_params} parameters, fp32 "
              f"compute, {paged} paged KV nodes): {int(m['tokens'])} tokens in {wall_s:.2f} s, "
              f"{m['tok_per_s']:.1f} tok/s, TTFT p50 {m['ttft_p50_ms']:.1f} ms, per-token p50 "
              f"{m['per_token_p50_ms']:.1f} ms, peak {peak / 2**20:.1f} MiB; kernel launches "
              f"{counts}")
        require(m["tokens"] == len(prompts) * HYBRID_SERVE_NEW,
                f"hybrid_serve {tag}: {m['tokens']} tokens")
        require(counts["flash_attention"] == {"cuda": attn * len(prompts), "torch": 0, "fake": 0},
                f"hybrid_serve {tag}: flash_attention launches {counts['flash_attention']}")
        require(all(v == {"cuda": 0, "torch": 0, "fake": 0} for k, v in counts.items()
                    if k != "flash_attention"), f"hybrid_serve {tag}: other kernels ran {counts}")
        want = sequential_decode(model, params, prompts, max_new=HYBRID_SERVE_NEW,
                                 view_len=engine.view_len)
        equal = sum(g == w for g, w in zip(tokens, want))
        print(f"compare hybrid_serve {tag} engine vs sequential_decode (float32 compute): "
              f"streams equal token for token {equal}/{len(prompts)}")
        require(equal == len(prompts),
                f"hybrid_serve {tag}: an engine stream differs from sequential_decode")
        row = {"metrics": m, "wall_s": wall_s, "peak_bytes": peak, "n_params": n_params,
               "paged_kv_nodes": paged, "streams_equal": equal, "engine_streams": tokens}
        if attn:  # the longest prompt's prefill logits, kernel against plain
            longest = torch.tensor([max(prompts, key=len)], device="cuda")
            state = model.init_state(1, engine.view_len)
            kernel_logits, _ = model.prefill(params, {"tokens": longest}, state)
            with dispatch.force_impl("torch"):
                plain_logits, _ = model.prefill(params, {"tokens": longest}, state)
            err = _max_rel(kernel_logits, plain_logits)
            print(f"compare hybrid_serve {tag} prefill kernel vs torch (float32 compute): "
                  f"logits rel err {err:.2e} (tol {SERVE_KERNEL_LOGIT_TOL:.0e})")
            require(err <= SERVE_KERNEL_LOGIT_TOL,
                    f"hybrid_serve {tag} prefill logits differ by {err:.3e}")
            row["prefill_rel_err"] = err
        for k in KERNEL_INFO:
            out["launches"][k] += counts[k]["cuda"]
        out[tag] = row
        del model, params, engine
        _free()
    return out


def _wave_counts(model) -> list:
    """Spy on ``model``'s prefill and decode_step: each call's kernel
    launches (zeroed just before the call, read just after), in order."""
    from repro_torch.kernels import launches

    counts = []
    for method in ("prefill", "decode_step"):
        def spy(*args, _call=getattr(model, method), **kw):
            launches.reset()
            out = _call(*args, **kw)
            counts.append(launches.snapshot())
            return out
        setattr(model, method, spy)
    return counts


def phase_wave_serve() -> dict:
    """Whisper-large-v3 (32 + 32 layers) and Phi-3-vision-4.2b (32 layers) at
    full width and full depth through ``launch/serve._serve_wave``: one wave
    of WAVE_SLOTS prompts of WAVE_PROMPT tokens, WAVE_NEW greedy tokens, no
    EOS.  In fp32 compute (after an untimed warm-up wave), gated: each
    decode step's logits (and the prefill's last position) against one
    teacher-forced ``forward_logits`` of the same tokens within
    WAVE_LOGIT_TOL, the tokens equal to that forward's greedy choices, and
    the attention kernel's launches per call equal to the code's count:
    Whisper one per self- and one per cross-attention layer a prefill (64),
    one per cross-attention layer a decode step (32: its self-attention
    decodes through the plain serving form); Phi-3-vision one per layer a
    prefill (32), none a decode step.  Then in bf16 compute (the same fp32
    parameters): a timed wave, and the prefill's logits on the kernel
    against force_impl("torch"), reported against SERVE_LOGIT_TOL and
    gated through WAVE_BF16_WITNESS (both against the fp32 prefill of the
    same inputs).  tok/s, the prefill's and the decode steps' median ms,
    peak memory."""
    import types

    import torch

    from repro_torch.configs.registry import build_model, get_arch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import _serve_wave, wave_batch
    from repro_torch.utils.tree import flatten_dict

    args = types.SimpleNamespace(slots=WAVE_SLOTS, prompt_len=WAVE_PROMPT, max_new=WAVE_NEW,
                                 eos=-1)
    out = {"launches": dict.fromkeys(KERNEL_INFO, 0)}
    for name in WAVE_ARCHS:
        base = get_arch(name)
        cross = base.n_layers if base.family == "audio" else 0
        per_call = [base.n_layers + cross] + [cross] * (WAVE_NEW - 1)
        row = {}
        params = None
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, dtype=dtype)
            model = build_model(cfg, device="cuda")
            if params is None:  # fp32 parameters, shared by both computes
                params = model.init(torch.Generator(device="cuda").manual_seed(0))
                row["n_params"] = sum(x.numel() for x in flatten_dict(params).values())
            if dtype == "float32":
                _serve_wave(model, cfg, params, args)  # warm-up, untimed
            counts = _wave_counts(model)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            wave = _serve_wave(model, cfg, params, args, keep_logits=dtype == "float32")
            peak = torch.cuda.max_memory_allocated()
            flash = [c["flash_attention"]["cuda"] for c in counts]
            plain = sum(v["torch"] for c in counts for v in c.values())
            others = sum(v["cuda"] for c in counts for k, v in c.items()
                         if k != "flash_attention")
            for k in KERNEL_INFO:
                out["launches"][k] += sum(c[k]["cuda"] for c in counts)
            n, decode_s = wave["n_tokens"], wave["decode_s"]
            stats = {
                "tokens": n, "tok_per_s": n / (wave["prefill_s"] + decode_s),
                "decode_tok_per_s": (n - WAVE_SLOTS) / decode_s,
                "prefill_ms": wave["prefill_s"] * 1e3,
                "decode_step_ms_median": statistics.median(wave["step_s"]) * 1e3,
                "peak_bytes": peak, "flash_launches_per_call": flash,
            }
            print(f"wave_serve {name} ({cfg.n_layers} layers, {row['n_params']} parameters, "
                  f"{dtype} compute): {n} tokens, {stats['tok_per_s']:.1f} tok/s (decode "
                  f"{stats['decode_tok_per_s']:.1f}), prefill {stats['prefill_ms']:.1f} ms, "
                  f"decode step median {stats['decode_step_ms_median']:.2f} ms, peak "
                  f"{peak / 2**20:.1f} MiB; flash_attention launches per call {flash}")
            require(n == WAVE_SLOTS * WAVE_NEW, f"wave_serve {name}: {n} tokens")
            require(flash == per_call, f"wave_serve {name} {dtype}: flash_attention launches "
                    f"per call {flash}, expected {per_call}")
            require(plain == 0 and others == 0,
                    f"wave_serve {name}: {plain} plain calls, {others} other kernel launches")
            if dtype == "float32":  # the streams against a teacher-forced forward
                batch = wave_batch(cfg, WAVE_SLOTS, WAVE_PROMPT, "cuda")
                batch["tokens"] = torch.cat([batch["tokens"], wave["stepped"][:, :-1]], dim=1)
                with torch.no_grad():
                    want = model.forward_logits(params, batch)[:, WAVE_PROMPT - 1:]
                got = torch.cat(wave["logits"], dim=1)
                err = _max_rel(got, want)
                greedy = bool(torch.equal(want.argmax(-1), wave["stepped"]))
                print(f"compare wave_serve {name} decode vs teacher-forced forward (float32 "
                      f"compute): logits rel err {err:.2e} (tol {WAVE_LOGIT_TOL:.0e}), "
                      f"greedy tokens equal {greedy}")
                require(err <= WAVE_LOGIT_TOL, f"wave_serve {name}: logits differ by {err:.3e}")
                require(greedy, f"wave_serve {name}: a token differs from the forward's argmax")
                stats.update(logit_rel_err=err, greedy_equal=greedy)
                # the fp32 prefill of the bf16 wave's inputs: the bf16 readings' reference
                batch = wave_batch(dataclasses.replace(cfg, dtype="bfloat16"), WAVE_SLOTS,
                                   WAVE_PROMPT, "cuda")
                state = model.init_state(WAVE_SLOTS, WAVE_PROMPT + WAVE_NEW + cfg.prefix_tokens)
                with torch.no_grad():
                    fp32_logits, _ = model.prefill(params, batch, state)
                del want, got, batch, state
            else:  # the prefill's logits, kernel against plain and both against fp32
                batch = wave_batch(cfg, WAVE_SLOTS, WAVE_PROMPT, "cuda")
                state = model.init_state(WAVE_SLOTS, WAVE_PROMPT + WAVE_NEW + cfg.prefix_tokens)
                with torch.no_grad():
                    kernel_logits, _ = model.prefill(params, batch, state)
                    with dispatch.force_impl("torch"):
                        plain_logits, _ = model.prefill(params, batch, state)
                err = _max_rel(kernel_logits, plain_logits)
                kernel_err = _max_rel(kernel_logits.float(), fp32_logits)
                plain_err = _max_rel(plain_logits.float(), fp32_logits)
                print(f"compare wave_serve {name} prefill kernel vs torch (bfloat16 compute): "
                      f"logits rel err {err:.2e} (SERVE_LOGIT_TOL {SERVE_LOGIT_TOL:.0e}, "
                      f"reported); against the fp32 prefill: kernel {kernel_err:.2e}, torch "
                      f"{plain_err:.2e} (gate: kernel <= {WAVE_BF16_WITNESS:g} x torch)")
                require(kernel_err <= WAVE_BF16_WITNESS * plain_err,
                        f"wave_serve {name} bf16 prefill: the kernel's logits lie {kernel_err:.3e} "
                        f"from fp32, the plain versions' {plain_err:.3e}")
                stats.update(prefill_rel_err=err, prefill_vs_fp32=kernel_err,
                             plain_prefill_vs_fp32=plain_err)
                del state, batch, fp32_logits
            row[dtype] = stats
            del model, wave
            _free()
        out[name] = row
        del params
        _free()
    return out


def phase_tuner_cli(path: dict) -> dict:
    """``python -m repro_torch.tuner`` on Yi-6B's full configuration (32
    layers, 6.06B parameters) at the lm_train path's batch and length (the
    max-batch search skipped), its table printed; the plan's step (and the
    time rule's) against the analytic step on the lm_train model (1 layer)
    in fp32 compute on TUNER_GATE_BATCH samples (_plan_step_gate, untimed:
    the slice phase times the steps; the plan restamped to that model's
    fp32 fingerprint: its taps are the full model's, stacked 1 deep)."""
    import contextlib
    import io

    from repro_torch.core.clipping import discover_meta
    from repro_torch.tuner import cli
    from repro_torch.tuner.plan import ClipPlan, shape_fingerprint

    out_path = ROOT / "build" / "plans" / "yi-6b.json"
    argv = ["--arch", "yi-6b", "--seq", str(path["seq"]), "--batch", str(path["batch"]),
            "--skip-max-batch", "--repeats", "1", "--warmup", "1", "--plan", str(out_path)]
    print(f"tuner_cli: python -m repro_torch.tuner {' '.join(argv)}")
    table = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(table):
        rc = cli.main(argv)
    cli_s = time.perf_counter() - t0
    print(table.getvalue().rstrip())
    require(rc == 0, f"tuner_cli: exit code {rc}")
    plan = ClipPlan.load(str(out_path))
    _free()
    model, params, batch = _model_params_batch(path, "float32", batch=TUNER_GATE_BATCH)
    plan32 = dataclasses.replace(
        plan, fingerprint=shape_fingerprint(discover_meta(model.loss_with_ctx, params, batch)))
    gate = _plan_step_gate("yi_6b", model, params, batch, plan32, "float32", n=0)
    return {"argv": argv, "cli_s": cli_s, "table": table.getvalue(),
            "recommended_mode": plan.recommended_mode(), "branches": plan.branch_map(),
            "bk_branches": plan.branch_map("bk_mixed"), "gate": gate}


def _train_cli_cfg():
    """Whisper-large-v3 at full width, TRAIN_CLI_LAYERS encoder and decoder
    layers (the train CLI's ``arch`` keyword: no flag cuts depth)."""
    from repro_torch.configs.registry import get_arch

    cfg = dataclasses.replace(get_arch(TRAIN_CLI_ARCH), n_layers=TRAIN_CLI_LAYERS,
                              encoder_layers=TRAIN_CLI_LAYERS)
    require((cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab, cfg.encoder_seq)
            == (1280, 20, 5120, 51866, 1500), f"train_cli: not Whisper's full width: {cfg}")
    return cfg


def _count_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``, with the
    synchronizing CUDA operations of the calling thread (the data
    pipeline's thread, which makes each batch, is not counted) split by the
    train loop's steps: ``per_step`` counts those between one step's metrics
    copy (``launch.train.host_metrics``, itself one sync) and the next's,
    ``outside`` those before the first and after the last.  Each sync
    outside the steps is named by its innermost frame of this repository."""
    import threading
    import traceback
    import warnings

    import torch

    from repro_torch.launch import train

    main, n, marks, where = threading.get_ident(), [0], [], []
    real = train.host_metrics

    def show(message, category, filename, lineno, file=None, line=None):
        if threading.get_ident() == main and "synchroniz" in str(message):
            n[0] += 1
            frames = [f for f in traceback.extract_stack()[:-2] if "/src/repro_torch/" in f.filename]
            where.append(f"{Path(frames[-1].filename).name}:{frames[-1].lineno}" if frames
                         else "?")

    def marked(metrics):
        out = real(metrics)
        marks.append(n[0])
        return out

    train.host_metrics = marked
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            train.host_metrics = real
    require(bool(marks), "train_cli: the loop copied no metrics")
    per_step = [b - a for a, b in zip(marks, marks[1:])]
    first = marks[0] - 1  # the first step's own metrics copy counts as a step's
    outside = where[:first] + where[marks[-1]:]
    return out, {"total": n[0], "per_step": per_step, "outside": outside}


def _train_cli_run(argv: list, arch) -> dict:
    """One in-process ``launch.train.main(argv, arch=arch)``: its exit
    code, the kernel launches it made (zeroed just before, read just after)
    and its seconds."""
    from repro_torch.kernels import launches
    from repro_torch.launch import train

    print(f"train_cli: python -m repro_torch.launch.train {' '.join(argv)}")
    launches.reset()
    t0 = time.perf_counter()
    rc = train.main(argv, arch=arch)
    seconds = time.perf_counter() - t0
    counts = launches.snapshot()
    require(rc == 0, f"train_cli: exit code {rc} for {argv}")
    return {"seconds": seconds, "cuda": {k: counts[k]["cuda"] for k in KERNEL_INFO},
            "torch": {k: counts[k]["torch"] for k in KERNEL_INFO}}


def _npz_leaves(path) -> dict:
    import numpy as np

    with np.load(path) as z:
        return {k: np.array(z[k]) for k in z.files}


def _step_stats(ms: list) -> dict:
    q1, med, q3 = statistics.quantiles(ms, n=4) if len(ms) > 1 else (ms[0],) * 3
    return {"ms": ms, "median_ms": statistics.median(ms), "q1_ms": q1, "q3_ms": q3}


def _embedding_determinism(model, params, batch) -> list:
    """The cost of the deterministic embedding gradient: at each embedding
    tap of the path's step, the weighted gradient's scatter by
    ``index_put_(accumulate=True)`` (sorted, what core.ghost runs) against
    ``index_add_`` (float atomics), CUDA-event ms each, and whether each
    gives the same bits again on the same inputs (index_add_ 20 times)."""
    import torch

    from repro_torch.core.clipping import discover_meta
    from repro_torch.utils.tree import flatten_dict

    gen = torch.Generator(device="cuda").manual_seed(5)
    flat = flatten_dict(params)
    ids_of = {"embed/e": batch["tokens"].reshape(-1)}
    out = []
    for name, m in discover_meta(model.loss_with_ctx, params, batch).items():
        if m.kind != "embedding":
            continue
        v, d = flat[m.param_path].shape
        ids = ids_of.get(m.param_path)
        if ids is None:  # a learned position embedding: positions 0..T-1 per sample
            ids = torch.arange(m.T, device="cuda").repeat(m.batch_size)
        vals = torch.randn((ids.numel(), d), generator=gen, device="cuda")

        def put():
            return torch.zeros((v, d), device="cuda").index_put_((ids,), vals, accumulate=True)

        def add():
            return torch.zeros((v, d), device="cuda").index_add_(0, ids, vals)

        row = {"tap": name, "param": m.param_path, "shape": [v, d], "rows": ids.numel(),
               "repeats": ids.numel() - int(torch.unique(ids).numel()),
               "index_put_ms": cuda_ms(put, 20), "index_add_ms": cuda_ms(add, 20),
               "index_put_reproducible": bool(torch.equal(put(), put())),
               "index_add_reproducible": all(torch.equal(add(), add()) for _ in range(20))}
        print(f"train_cli: {name} ({v} x {d}, {row['rows']} rows, {row['repeats']} repeats): "
              f"index_put_ {row['index_put_ms']:.4f} ms (bit-reproducible "
              f"{row['index_put_reproducible']}), index_add_ {row['index_add_ms']:.4f} ms "
              f"(bit-reproducible {row['index_add_reproducible']})")
        require(row["index_put_reproducible"], f"train_cli: index_put_ at {name} not reproducible")
        out.append(row)
    return out


def phase_train_cli() -> dict:
    """The port's train CLI (``launch/train.py``'s ``main``, in process) on
    Whisper-large-v3 at full width, 1 encoder + 1 decoder layer, batch 4 x
    448 tokens over 1500 frames, bf16 compute, adam, checkpoints in a
    temporary directory deleted at the end:

    1. a straight TRAIN_CLI_STEPS-step bk_mixed run under the quantile
       policy against the same run crashed at step TRAIN_CLI_CRASH and
       auto-restarted: the final checkpoint bit-identical leaf by leaf (the
       generator's and the policy's state included), the summaries'
       epsilon, delta, logical batch, microbatch and accumulation equal;
    2. the launch counters: every run launched the card's kernels, the
       straight run and the mixed_ghost run as many per step as the path's
       taps predict, and no run called a plain version;
    3. a mixed_ghost run with --obs-dir and --profile-steps: the trace holds
       one step span per profiled step, and python -m repro_torch.obs
       renders the run; then mixed_ghost without and with --obs-dir
       (TRAIN_CLI_SYNC_STEPS steps each): the synchronizing CUDA operations
       of the loop's thread are as many either way;
    4. reported: step times (the loop's own beside the trace's host and
       device spans and the kernels' busy time inside them), checkpoint
       bytes, snapshot, write and restore seconds, the deterministic
       embedding gradient's cost, peak memory; the kernels at this path's
       shapes (the kernel table's train_cli cell)."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.configs.registry import build_model
    from repro_torch.data.synthetic import synthetic_arch_batch
    from repro_torch.obs import configure_run, read_jsonl
    from repro_torch.obs.timeline import execution_spans, step_kernel_ms, step_wall_times_ms

    cfg = _train_cli_cfg()
    out = {"arch": TRAIN_CLI_ARCH, "layers": TRAIN_CLI_LAYERS, "batch": TRAIN_CLI_BATCH,
           "seq": TRAIN_CLI_SEQ, "dtype": cfg.dtype}
    # the path's taps (launches per step, kernel shapes), the embedding
    # gradient's cost and the kernels at its shapes, on a model of its own
    # that is freed before the CLI runs build theirs
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = synthetic_arch_batch(cfg, batch=TRAIN_CLI_BATCH, seq=TRAIN_CLI_SEQ, device="cuda")
    shapes, expected, _ = main_path_shapes(model, params, batch)
    out["embedding_determinism"] = _embedding_determinism(model, params, batch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for kernel in ("ghost_norm_sq", "embedding_ghost_norm_sq", "book_weighted_grad",
                   "psg_contract"):
        cases[kernel] = []
        for (shape, dtypes), calls in sorted(shapes[kernel].items()):
            case = _kernel_case(kernel, shape, dtypes, gen, timed=True)
            case["path"], case["calls_per_step"] = "train_cli", calls
            cases[kernel].append(case)
    out["kernel_cases"] = cases
    del model, params, batch
    _free()

    base = ["--arch", TRAIN_CLI_ARCH, "--seq", str(TRAIN_CLI_SEQ), "--batch",
            str(TRAIN_CLI_BATCH), "--log-every", "1"]
    with tempfile.TemporaryDirectory(prefix="train_cli_") as tmp:
        tmp = Path(tmp)
        free = shutil.disk_usage(tmp).free
        print(f"train_cli: checkpoints under {tmp} ({free / 2**30:.1f} GiB free)")
        resume = base + ["--steps", str(TRAIN_CLI_STEPS), "--ckpt-every",
                         str(TRAIN_CLI_CKPT_EVERY), "--mode", "bk_mixed",
                         "--clip-policy", "quantile"]
        torch.cuda.reset_peak_memory_stats()
        runs = {"straight": _train_cli_run(resume + ["--ckpt-dir", str(tmp / "a")], cfg)}
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        final = f"step_{TRAIN_CLI_STEPS}.npz"
        straight = _npz_leaves(tmp / "a" / final)
        for p in (tmp / "a").glob("step_*.npz"):
            if p.name != final:
                p.unlink()
        runs["restarted"] = _train_cli_run(
            resume + ["--ckpt-dir", str(tmp / "b"), "--inject", f"crash@{TRAIN_CLI_CRASH}",
                      "--auto-restart", "2"], cfg)
        restarted = _npz_leaves(tmp / "b" / final)
        require(sorted(straight) == sorted(restarted), "train_cli: the checkpoints' leaves differ")
        require(any(k.startswith("policy/") for k in straight) and "rng" in straight,
                "train_cli: no policy or generator state in the checkpoint")
        diverged = [k for k in straight if straight[k].dtype != restarted[k].dtype
                    or not (straight[k] == restarted[k]).all()]
        require(not diverged, f"train_cli: restarted run diverged at {diverged[:8]}")
        sums = [json.loads((tmp / d / "summary.json").read_text()) for d in ("a", "b")]
        keys = ("epsilon", "delta", "logical_batch", "microbatch", "accumulation_steps", "step")
        require(all(sums[0][k] == sums[1][k] for k in keys),
                f"train_cli: summaries differ: {sums}")
        out["summary"] = sums[0]
        ckpt = {"bytes": (tmp / "a" / final).stat().st_size}
        events = {d: read_jsonl(tmp / d / "events.jsonl") for d in ("a", "b")}
        saved = [e for e in events["a"] + events["b"] if e["kind"] == "checkpoint_saved"]
        restored = [e for e in events["b"] if e["kind"] == "checkpoint_restored"]
        ckpt.update(snapshot_s=[e["snapshot_s"] for e in saved],
                    write_s=[e["write_s"] for e in saved],
                    restore_s=[e["restore_s"] for e in restored],
                    restored_step=[e["step"] for e in restored])
        out["checkpoint"] = ckpt
        out["bk_mixed_step_s"] = {d: [m["step_s"] for m in read_jsonl(tmp / d / "metrics.jsonl")
                                      if m["kind"] == "train_step"] for d in ("a", "b")}
        print(f"train_cli: straight and restarted (crash at {TRAIN_CLI_CRASH}, restored step "
              f"{ckpt['restored_step']}) bit-identical over {len(straight)} leaves; checkpoint "
              f"{ckpt['bytes'] / 2**30:.2f} GiB, snapshot s {ckpt['snapshot_s']}, write s "
              f"{ckpt['write_s']}, restore s {ckpt['restore_s']}; epsilon {sums[0]['epsilon']}")
        shutil.rmtree(tmp / "a")
        shutil.rmtree(tmp / "b")

        first, last = TRAIN_CLI_PROFILE
        prof_dir = tmp / "prof"
        runs["profiled"] = _train_cli_run(
            base + ["--steps", str(TRAIN_CLI_PROFILE_STEPS), "--mode", "mixed_ghost",
                    "--obs-dir", str(prof_dir), "--profile-steps", f"{first}:{last}"], cfg)
        traces = list((prof_dir / "profile").glob("*.trace.json"))
        require(len(traces) == 1 and traces[0].stat().st_size > 0,
                f"train_cli: no trace under {prof_dir / 'profile'}")
        host = execution_spans(prof_dir / "profile")
        n_prof = last - first + 1
        require([h["name"] for h in host] == [f"train_step#{i}" for i in range(first, last + 1)],
                f"train_cli: step spans {[h['name'] for h in host]}, expected {n_prof}")
        device = step_kernel_ms(prof_dir / "profile")
        loop = [m["step_s"] * 1e3 for m in read_jsonl(prof_dir / "metrics.jsonl")
                if m["kind"] == "train_step"]
        out["profile"] = {"trace_bytes": traces[0].stat().st_size,
                          "host_span_ms": step_wall_times_ms(prof_dir / "profile"),
                          "device": device, "loop_ms": loop}
        print(f"train_cli: profiled steps {first}-{last}: loop ms "
              f"{[round(x, 2) for x in loop[first:last + 1]]}, host spans ms "
              f"{[round(x, 2) for x in out['profile']['host_span_ms']]}, device spans "
              + (", ".join(f"{d['span_ms']:.2f} ms ({d['kernels']} kernels busy "
                           f"{d['kernel_ms']:.2f} ms)" for d in device) or "not measured"))
        # after the profiled run: the path's one-time set-up (a first call's
        # sync) lands in neither count
        sync = base + ["--steps", str(TRAIN_CLI_SYNC_STEPS), "--mode", "mixed_ghost"]
        runs["plain"], syncs_plain = _count_syncs(lambda: _train_cli_run(sync, cfg))
        runs["obs"], syncs_obs = _count_syncs(
            lambda: _train_cli_run(sync + ["--obs-dir", str(tmp / "obs")], cfg))
        out["syncs"] = {"plain": syncs_plain, "obs": syncs_obs}
        print(f"train_cli: synchronizing CUDA ops of the loop's thread per mixed_ghost step "
              f"after the first: {syncs_plain['per_step']} without obs, {syncs_obs['per_step']} "
              f"with --obs-dir; outside the steps {syncs_plain['outside']} / "
              f"{syncs_obs['outside']}")
        require(syncs_plain["per_step"] == syncs_obs["per_step"],
                f"train_cli: obs adds host syncs to a step: {syncs_plain} -> {syncs_obs}")

        env = dict(os.environ, PYTHONPATH=str(SRC))
        rendered = subprocess.run([sys.executable, "-m", "repro_torch.obs", str(prof_dir),
                                   "--timeline"], capture_output=True, text=True, env=env,
                                  timeout=120)
        print(rendered.stdout.rstrip())
        require(rendered.returncode == 0 and
                f"train steps recorded: {TRAIN_CLI_PROFILE_STEPS}" in rendered.stdout,
                f"train_cli: python -m repro_torch.obs failed: {rendered.stderr[-2000:]}")
        out["rendered"] = rendered.stdout
        steps_ms = {"bk_mixed": [x * 1e3 for x in out["bk_mixed_step_s"]["a"][1:]],
                    "mixed_ghost": loop[1:]}
        out["step_ms"] = {mode: _step_stats(ms) for mode, ms in steps_ms.items()}
        for mode, st in out["step_ms"].items():
            print(f"train_cli: {mode} step ms (the loop's, first step dropped) median "
                  f"{st['median_ms']:.2f} (q1 {st['q1_ms']:.2f}, q3 {st['q3_ms']:.2f})")
        configure_run(None)  # close the last run's streams before the directory goes

    # the launch counters: kernels, never the plain versions
    for name, run in runs.items():
        require(not any(run["torch"].values()),
                f"train_cli {name}: plain-version calls on the card {run['torch']}")
        require(any(run["cuda"].values()), f"train_cli {name}: no kernel launched")
    for name, mode, steps in (("straight", "bk_mixed", TRAIN_CLI_STEPS),
                              ("plain", "mixed_ghost", TRAIN_CLI_SYNC_STEPS)):
        per_step = {k: runs[name]["cuda"][k] / steps for k in KERNEL_INFO}
        require(per_step == expected[mode],
                f"train_cli {name}: launches per step {per_step}, expected {expected[mode]}")
    for kernel in KERNEL_INFO:
        wanted = expected["bk_mixed"][kernel] or expected["mixed_ghost"][kernel]
        require(not wanted or runs["straight"]["cuda"][kernel] + runs["plain"]["cuda"][kernel],
                f"train_cli: {kernel} was never launched")
    out["runs"] = runs
    out["expected"] = {m: expected[m] for m in ("mixed_ghost", "bk_mixed")}
    out["launches"] = {k: sum(r["cuda"][k] for r in runs.values()) for k in KERNEL_INFO}
    print(f"train_cli: launches per step, bk_mixed {expected['bk_mixed']}, mixed_ghost "
          f"{expected['mixed_ghost']}; per run (seconds, launches) "
          + "; ".join(f"{k} {r['seconds']:.1f} s {r['cuda']}" for k, r in runs.items()))
    return out


# the dist phase: data-parallel + FSDP DP-SGD over torch.distributed, two
# gloo ranks on the one card (NCCL refuses two ranks on one GPU), Whisper at
# the train_cli cut
DIST_RANKS = 2
DIST_MODES = ("non_private", "ghost", "fastgradclip", "mixed_ghost", "bk_mixed")
DIST_BF16_MODES = ("bk_mixed",)
DIST_TOL = 1e-5  # fp32 gates: the same sums in another order
DIST_CLI_STEPS, DIST_CLI_CKPT_EVERY, DIST_CLI_CRASH = 2, 2, 1
DIST_TIMEOUT_S = 600


def _dist_policy(name: str):
    """The train CLI's policy for ``--clip-policy name`` at its defaults."""
    from repro_torch.policies import make_policy

    return make_policy(name, clip_norm=1.0, init_clip_norm=1.0, gamma=0.01,
                       target_quantile=0.5, lr=0.2, release_sigma=1.0, groups=())


def _rel_tree(got: dict, want: dict, layout) -> float:
    """Max over leaves of |got - want| over the leaf's largest |want| (a
    leaf zero up to rounding, under 1e-6 of the tree's largest entry, as the
    attention key biases the softmax ignores, over the tree's largest);
    ``got`` holds this rank's shards, ``want`` full leaves."""
    top = max(float(v.abs().max()) for v in want.values())
    worst = 0.0
    for k, w in want.items():
        leaf = float(w.abs().max())
        scale = leaf if leaf >= 1e-6 * top else top
        mine = layout.local(k, w)
        worst = max(worst, float((got[k].float() - mine.float()).abs().max()) / scale)
    return worst


def _dist_case(cfg, mode: str, policy_name: str, poisson: bool, mesh, rank: int) -> dict:
    """One clipped call plus the noise-and-update tail (``make_noise_finalize``,
    the tail of ``make_train_step``) on the sharded state, and on each rank
    the same on one rank: norms, factors, the clipped gradient sum before
    the noise (gated on its own: the noise's scale would hide its error),
    the noised gradient and the parameters after the update (each rank's
    shards against the same slices of the one-rank tensors: the gathered
    comparison without moving a byte), with the launches, collective bytes
    and ms of the sharded call.  The update is SGD with momentum (its
    moment is sharded like Adam's): linear in the gradient, so the
    parameters inherit the gradient's tolerance.  Adam's first step divides
    each entry by its own magnitude, so where a gradient is zero up to
    rounding (the attention key biases, without noise under non_private)
    it moves by +-lr either way; the CLI runs Adam."""
    import torch

    from repro_torch.configs.registry import build_model
    from repro_torch.core.noise import add_dp_noise
    from repro_torch.data.poisson import poisson_sample_mask
    from repro_torch.data.synthetic import synthetic_arch_batch
    from repro_torch.kernels import launches
    from repro_torch.launch.steps import (
        DPTrainConfig,
        make_clipped_microstep,
        make_noise_finalize,
        make_train_state,
    )
    from repro_torch.optim import constant, sgd
    from repro_torch.parallel import collectives
    from repro_torch.parallel.fsdp import ShardLayout, sharded_fraction
    from repro_torch.parallel.reshard import use_reshard_rules
    from repro_torch.parallel.sharding import state_shardings
    from repro_torch.utils.tree import flatten_dict

    model = build_model(cfg, device="cuda")
    policy = _dist_policy(policy_name)
    opt = sgd(momentum=0.9)
    dp = DPTrainConfig(clipping_mode=mode, clip_norm=1.0, noise_multiplier=1.0,
                       logical_batch=TRAIN_CLI_BATCH, policy=policy)
    batch = synthetic_arch_batch(cfg, batch=TRAIN_CLI_BATCH, seq=TRAIN_CLI_SEQ, device="cuda")
    if poisson:
        batch["mask"] = poisson_sample_mask(torch.Generator(device="cuda").manual_seed(11),
                                            TRAIN_CLI_BATCH, 0.5)
    sched = constant(1e-3)
    std = dp.noise_multiplier * policy.sensitivity(policy.init_state(device="cuda"))

    def run(state, shardings=None, layout=None):
        pstate = state["policy"]
        loss, g, aux = make_clipped_microstep(model, dp, shardings)(state["params"], batch,
                                                                    pstate)
        noised = add_dp_noise(g, torch.Generator(device="cuda").manual_seed(5), std,
                              layout=layout)
        new = make_noise_finalize(opt, sched, dp, shardings=shardings)(
            state, g, aux["per_sample_norms"], batch.get("mask"))
        return loss, g, aux, noised, new

    out = {"mode": mode, "policy": policy_name, "dtype": cfg.dtype, "poisson": poisson}
    # the one-rank step, on every rank, outside any collective
    loss, g, aux, noised, new = run(make_train_state(model, 0, opt, policy))
    ref = {"loss": float(loss), "norms": aux["per_sample_norms"],
           "factors": aux["clip_factors"], "grads": flatten_dict(g),
           "noised": flatten_dict(noised), "params": flatten_dict(new["params"])}
    del g, noised, new
    state = make_train_state(model, 0, opt, policy)
    shardings = state_shardings(model, mesh, cfg, state)
    layout = ShardLayout(mesh, shardings["params"])
    trees = ("params", "m")
    full = {k: layout.local_bytes(state[k] if k == "params" else state["opt"][k]) for k in trees}
    state = layout.shard_state(state)
    frac = {k: sharded_fraction(layout, state[k] if k == "params" else state["opt"][k])
            for k in trees}
    sharded = [k for k, d in layout.dims.items() if d is not None]
    require(sharded and all(frac[t][k] == 1 / layout.n for t in frac for k in sharded)
            and all(frac[t][k] == 1.0 for t in frac for k in layout.dims if k not in sharded),
            f"dist: rank {rank} does not hold 1/{layout.n} of every sharded leaf")
    out["stored_fraction"] = {
        k: layout.local_bytes(state[k] if k == "params" else state["opt"][k]) / full[k]
        for k in trees}
    out["sharded_leaves"], out["leaves"] = len(sharded), len(layout.dims)
    with use_reshard_rules(mesh, cfg):
        torch.cuda.synchronize()
        torch.distributed.barrier(group=mesh.group("data"))  # every reference is done
        launches.reset()
        collectives.reset_bytes()
        t0 = time.perf_counter()
        loss, g, aux, noised, new = run(state, shardings, layout)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3
        counts = launches.snapshot()
        out["bytes"] = dict(collectives.BYTES)
        out["launches"] = {k: counts[k]["cuda"] for k in KERNEL_INFO}
        out["plain_calls"] = sum(counts[k]["torch"] for k in KERNEL_INFO)
    out["err"] = {
        "loss": abs(float(loss) - ref["loss"]) / abs(ref["loss"]),
        "norms": float((aux["per_sample_norms"] - ref["norms"]).abs().max()
                       / ref["norms"].abs().max()) if mode != "non_private" else 0.0,
        "factors": float((aux["clip_factors"] - ref["factors"]).abs().max()
                         / ref["factors"].abs().max()),
        "grads": _rel_tree(flatten_dict(g), ref["grads"], layout),
        "noised_grad": _rel_tree(flatten_dict(noised), ref["noised"], layout),
        "params": _rel_tree(flatten_dict(new["params"]), ref["params"], layout),
    }
    del model, state, g, new, noised, ref
    _free()
    return out


def _dist_nccl(cfg, rank: int) -> dict:
    """Rank 0 alone in an NCCL group: one bk_mixed step through the sharded
    path on a one-rank data axis, so its collectives run on NCCL; held
    against the step without a process group (equal up to summation order:
    NCCL's one-rank reductions copy)."""
    import torch

    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import collectives
    from repro_torch.tuner.plan import device_string

    dist = torch.distributed
    group = dist.new_group(ranks=[0], backend="nccl")
    if rank != 0:
        return {}
    mesh = Mesh(("data", "model"), (1, 1), hosts=1, device_kinds=(device_string("cuda"),),
                groups={"data": group}, coords={"data": 0, "model": 0})
    out = _dist_case(cfg, "bk_mixed", "fixed", False, mesh, rank)
    require(collectives.backend_of(group) == "nccl" and sum(out["bytes"].values()) > 0,
            f"dist nccl: no NCCL collective ran ({out['bytes']})")
    return out


def _dist_cli(rank: int, plan_path: str, tmp: Path) -> dict:
    """The train CLI in this rank's process (``train.main(argv, arch=cfg)``,
    the group the environment described already joined): a straight run and
    one crashed at DIST_CLI_CRASH and auto-restarted, both with --consensus
    on the parent's plan."""
    from repro_torch.kernels import launches
    from repro_torch.launch import train
    from repro_torch.obs import configure_run, read_jsonl

    cfg = _train_cli_cfg()
    base = ["--arch", TRAIN_CLI_ARCH, "--seq", str(TRAIN_CLI_SEQ), "--batch",
            str(TRAIN_CLI_BATCH), "--steps", str(DIST_CLI_STEPS), "--ckpt-every",
            str(DIST_CLI_CKPT_EVERY), "--mode", "bk_mixed", "--clip-policy", "quantile",
            "--poisson", "--sample-size", "8", "--consensus", "--plan", plan_path,
            "--log-every", "1"]
    out = {}
    for name, extra in (("straight", []),
                        ("restarted", ["--inject", f"crash@{DIST_CLI_CRASH}",
                                       "--auto-restart", "1"])):
        launches.reset()
        t0 = time.perf_counter()
        rc = train.main(base + ["--ckpt-dir", str(tmp / name)] + extra, arch=cfg)
        counts = launches.snapshot()
        require(rc == 0, f"dist cli {name}: exit code {rc}")
        events = read_jsonl(tmp / name / "events.jsonl")
        out[name] = {
            "seconds": time.perf_counter() - t0,
            "cuda": {k: counts[k]["cuda"] for k in KERNEL_INFO},
            "torch": {k: counts[k]["torch"] for k in KERNEL_INFO},
            "hashes": sorted({e.get("consensus_hash") for e in events
                              if e["kind"] == "plan_adopted" and e["rank"] == rank}),
            "step_s": [m["step_s"] for m in read_jsonl(tmp / name / "metrics.jsonl")
                       if m["kind"] == "train_step" and m["rank"] == rank],
        }
    configure_run(None)
    return out


# the dist phase's model-axis parts, on a (1, 2) mesh of the same two gloo
# ranks, each at full width: tp (Mixtral-8x7B, TP_LAYERS of its 32 layers,
# remat on), cnn (VGG-19 and ViT-Base/16, the paper's models) and mamba
# (Jamba-1.5-Large's first layer, a Mamba layer with its dense MLP)
TP_ARCH = "mixtral-8x7b"
TP_LAYERS = 1
TP_MESH = (1, DIST_RANKS)
TP_MODES = ("non_private", "mixed_ghost", "bk_mixed")  # fp32, gated at DIST_TOL
TP_BATCH, TP_SEQ = 2, 1024
TP_BF16_MODES = ("mixed_ghost", "bk_mixed")  # reported
TP_BF16_SEQ = 4096  # the mixtral path's length
CNN_VGG_BATCH, CNN_VIT_BATCH = 128, 8  # VGG-19 as its path; ViT-Base at 224 x 224
CNN_VIT_MODES = ("mixed_ghost",)
MAMBA_BATCH, MAMBA_SEQ = 2, 1024
MAMBA_F64_SEQ = 256  # the fp64 witness's length (its fp64 weight copies and fp32 state)
# the fp32 main path's clipped-sum limit against the one-rank step where
# fp32 rounding alone moves it past DIST_TOL (every other reading, and
# every other model, at DIST_TOL): between the sharded step's readings
# (<= 4.6e-5) and a bf16-compute control's (>= 3.0e-2), from
# ``scripts/axis_parts.py vgg19_sound mamba_sound`` (PERF.md §6).
# VGG-19's one-rank step takes conv1's weight gradient from cuDNN's
# Winograd (5.3e-5 from fp64), its half-channel convs from another
# algorithm (7.9e-7); Jamba's A_log and dt_bias gradients sum 2 x 1024
# positions of every head (the one-rank step 2.0-2.4e-5 from fp64 at 2 x 256)
AXIS_TOL = {"vgg19": {"grads": 2e-4}, "jamba-1.5-large-398b": {"grads": 2e-4}}
# the kernels' wrappers whose calls the parts record: (module attribute of
# kernels.dispatch, kernel, the training mode whose step gives its main-path
# shapes; None: the serve part's prefill)
TP_SPY = (("ghost_norm_sq", "ghost_norm_sq", "mixed_ghost"),
          ("conv_ghost_norm_sq", "conv_ghost_norm_sq", "mixed_ghost"),
          ("embedding_ghost_norm_sq", "embedding_ghost_norm_sq", "mixed_ghost"),
          ("book_weighted_grad", "book_weighted_grad", "bk_mixed"),
          ("psg_contract_grouped", "psg_contract", "bk_mixed"),
          ("flash_attention", "flash_attention", None))


def _tp_cfg(dtype: str):
    """Mixtral-8x7B at full width, TP_LAYERS layers, ``dtype`` compute (fp32
    compute takes fp32 parameters, as the LM paths' gates)."""
    from repro_torch.configs.registry import get_arch

    over = {"dtype": "float32", "param_dtype": "float32"} if dtype == "float32" else {}
    cfg = dataclasses.replace(get_arch(TP_ARCH), n_layers=TP_LAYERS, remat=True, **over)
    require((cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff, cfg.vocab, cfg.moe_experts)
            == (4096, 32, 8, 14336, 32000, 8), f"tp: not Mixtral's full width: {cfg}")
    return cfg


def _mamba_cfg(dtype: str):
    """Jamba-1.5-Large at full width cut to its first layer (JAMBA_PERIOD[0],
    a Mamba layer with its dense SwiGLU MLP), ``dtype`` compute, fp32
    parameters."""
    from repro_torch.configs.registry import get_arch

    cfg = dataclasses.replace(get_arch("jamba-1.5-large-398b"), n_layers=1,
                              block_pattern=JAMBA_PERIOD[:1], remat=True, dtype=dtype,
                              param_dtype="float32")
    require((cfg.d_model, cfg.d_ff, cfg.vocab, cfg.ssm_head_dim, cfg.ssm_d_state)
            == (8192, 24576, 65536, 64, 64) and JAMBA_PERIOD[0] == "mamba",
            f"mamba: not Jamba's full width: {cfg}")
    return cfg


def _lm_part(cfg, batch: int, seq: int) -> dict:
    """A model-axis part's model of a registry LM config."""
    def build():
        from repro_torch.configs.registry import build_model

        return build_model(cfg, device="cuda")

    def make_batch():
        from repro_torch.data.synthetic import synthetic_arch_batch

        return synthetic_arch_batch(cfg, batch=batch, seq=seq, device="cuda")

    return {"build": build, "cfg": cfg, "batch": make_batch, "vocab": cfg.vocab // TP_MESH[1],
            "seq": seq, "dtype": cfg.dtype, "abstract": True, "model": cfg.name}


def _vision_part(name: str, batch: int, dtype: str) -> dict:
    """A model-axis part's model of the paper's: VGG-19 (CIFAR-10 widths,
    GroupNorm, 32 x 32) or ViT-Base/16 (224 x 224), 10 classes, ``dtype``
    compute, fp32 parameters."""
    from repro_torch.configs.paper_native import VIT_BASE

    cfg = dataclasses.replace(VIT_BASE, dtype=dtype) if name == "vit_base" else None

    def build():
        import torch

        from repro_torch.models.cnn import VGG
        from repro_torch.models.vit import ViT

        if name == "vgg19":
            return VGG("vgg19", dtype=getattr(torch, dtype), device="cuda")
        return ViT(cfg, image_size=224, patch=16, n_classes=10, device="cuda")

    def make_batch():
        from repro_torch.data.synthetic import synthetic_vision_batch

        return synthetic_vision_batch(batch=batch, image=32 if name == "vgg19" else 224,
                                      channels=3, n_classes=10, step=0, device="cuda")

    return {"build": build, "cfg": cfg, "batch": make_batch, "vocab": (224 // 16) ** 2,
            "seq": None, "dtype": dtype, "abstract": False, "model": name, "ref": "together"}


class _KernelSpy:
    """Records the shape and dtypes of every call of the kernels' dispatch
    entries in TP_SPY (the kernel phase's shape keys; the ghost norm's conv
    entry its own; the attention's ``_flash_case`` spec, of its kernel's
    calls only: not the serving form's traced ``q_offset`` or
    ``kv_positions``) while active; the calls themselves go through
    unchanged."""

    def __init__(self, vocab: int = None):
        self.vocab = vocab  # the ids' range at the embedding norm (a rank's rows)
        self.calls: dict = {}

    def __enter__(self):
        from repro_torch.kernels import dispatch

        self.saved = {attr: getattr(dispatch, attr) for attr, _, _ in TP_SPY}
        for attr, kernel, _ in TP_SPY:
            setattr(dispatch, attr, self._wrap(kernel, self.saved[attr]))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import dispatch

        for attr, fn in self.saved.items():
            setattr(dispatch, attr, fn)

    def _wrap(self, kernel: str, fn):
        def spied(*args, **kw):
            x = args[0]
            if kernel == "flash_attention":
                q, k = x, args[1]
                q_offset = kw.get("q_offset", 0)
                if kw.get("kv_positions") is not None or not isinstance(q_offset, int):
                    return fn(*args, **kw)
                key = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                       kw.get("causal", True), kw.get("window"), q_offset)
            elif kernel == "psg_contract":
                key = ((x[0].shape[0], tuple((t.shape[1], 0) for t in x)),
                       tuple(_name(t.dtype) for t in x))
            elif kernel == "embedding_ghost_norm_sq":
                key = ((*x.shape, args[1].shape[-1], self.vocab),
                       (_name(x.dtype), _name(args[1].dtype)))
            elif kernel == "conv_ghost_norm_sq":
                info = args[2]
                key = ((*x.shape, *info.kernel, *info.strides, info.padding,
                        args[1].shape[-1]), (_name(x.dtype), _name(args[1].dtype)))
            else:
                key = (tuple(x.shape[:-1]) + (x.shape[-1], args[1].shape[-1]),
                       (_name(x.dtype), _name(args[1].dtype)))
            self.calls[(kernel, key)] = self.calls.get((kernel, key), 0) + 1
            return fn(*args, **kw)
        return spied


def _one_rank(part: dict, mode: str, keep_slice) -> dict:
    """A part's one-rank step in ``mode``: loss, norms and factors, and
    where ``keep_slice`` (this rank's slice of a full leaf) is given, its
    clipped gradient sum and its parameters after the update."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import make_train_state
    from repro_torch.utils.tree import flatten_dict

    model = part["build"]()
    opt, policy, dp, sched, batch = _axis_setup(part, mode)
    torch.cuda.reset_peak_memory_stats()
    with dispatch.force_impl("torch") if part.get("plain") else contextlib.nullcontext():
        loss, g, aux, new = _axis_run(model, opt, dp, sched, batch,
                                      make_train_state(model, 0, opt, policy))
    out = {"loss": float(loss), "norms": aux["per_sample_norms"],
           "factors": aux["clip_factors"]}
    if keep_slice is not None:
        out["grads"] = {k: keep_slice(k, v) for k, v in flatten_dict(g).items()}
        out["params"] = {k: keep_slice(k, v) for k, v in flatten_dict(new["params"]).items()}
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, g, aux, new, batch
    _free()
    return out


def _axis_setup(part: dict, mode: str) -> tuple:
    """(optimizer, policy, DPTrainConfig, schedule, batch) of a part's step:
    SGD with momentum (linear in the gradient, as the dist gate), the fixed
    policy at norm 1, noise multiplier 1."""
    from repro_torch.launch.steps import DPTrainConfig
    from repro_torch.optim import constant, sgd

    batch = part["batch"]()
    policy = _dist_policy("fixed")
    dp = DPTrainConfig(clipping_mode=mode, clip_norm=1.0, noise_multiplier=1.0,
                       logical_batch=int(batch["mask"].shape[0]), policy=policy)
    return sgd(momentum=0.9), policy, dp, constant(1e-3), batch


def _axis_run(model, opt, dp, sched, batch, state, shardings=None):
    """One clipped call plus the noise-and-update tail."""
    from repro_torch.launch.steps import make_clipped_microstep, make_noise_finalize

    loss, g, aux = make_clipped_microstep(model, dp, shardings)(state["params"], batch,
                                                                state["policy"])
    new = make_noise_finalize(opt, sched, dp, shardings=shardings)(
        state, g, aux["per_sample_norms"], None)
    return loss, g, aux, new


def _axis_errs(got: dict, want: dict, mode: str) -> tuple[dict, dict]:
    """({quantity: error}, {tree: worst leaf, "exempt": leaves}) of a
    step's readings against a reference's: loss, norms and factors relative
    to the reference's largest; the clipped sum and the parameters leaf by
    leaf, each leaf's error over its largest entry (a leaf zero up to
    rounding, under 1e-6 of the tree's largest entry, over the tree's
    largest, as _rel_tree: ``exempt`` lists them)."""
    import torch

    err = {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
           "norms": float((got["norms"].double() - want["norms"].double()).abs().max()
                          / want["norms"].abs().max()) if mode != "non_private" else 0.0,
           "factors": float((got["factors"].double() - want["factors"].double()).abs().max()
                            / want["factors"].abs().max())}
    worst = {}
    for what in ("grads", "params") if "grads" in want else ():
        g, w = got[what], want[what]
        top = max(float(v.abs().max()) for v in w.values())
        errs, exempt = {}, []
        for k, ref in w.items():  # leaf by leaf on the card (a reference may be on the host)
            a, b = g[k], ref.to(g[k].device)
            dt = torch.promote_types(a.dtype, b.dtype)
            leaf = float(b.abs().max())
            if leaf < 1e-6 * top:
                exempt.append(k)
            errs[k] = float((a.to(dt) - b.to(dt)).abs().max()) / (
                leaf if leaf >= 1e-6 * top else top)
        err[what] = max(errs.values())
        k = max(errs, key=errs.get)
        worst[what] = (k, float(w[k].abs().max()) / top, errs[k])
        worst[f"{what}_exempt"] = exempt
    return err, worst


def _axis_layout(part: dict, model, mesh) -> tuple:
    """(shardings, ShardLayout) of a part's train state on ``mesh``."""
    import torch

    from repro_torch.launch.flops import abstract_params
    from repro_torch.parallel.fsdp import ShardLayout
    from repro_torch.parallel.sharding import state_shardings

    if part["abstract"]:
        abstract = abstract_params(model)
    else:
        abstract = model.init(torch.Generator(device="cuda").manual_seed(0))
    shardings = state_shardings(model, mesh, part["cfg"],
                                {"params": abstract, "opt": {"m": abstract}, "step": 0})
    return shardings, ShardLayout(mesh, shardings["params"])


def _axis_ref(part: dict, mode: str, rank: int, n: int, keep_slice, how: str):
    """The one-rank step, keeping ``keep_slice`` of its gradient and
    parameters (None: loss, norms and factors only), ``how``: "each" rank
    one at a time (the card holds one at once), "together" (the card holds
    both), "rank0" alone, or "none"; None where this rank ran none."""
    import torch

    if how == "together":
        return _one_rank(part, mode, keep_slice)
    ref = None
    for r in range(n if how != "none" else 0):
        if r == rank and (how == "each" or rank == 0):
            ref = _one_rank(part, mode, keep_slice)
        torch.distributed.barrier(group=torch.distributed.group.WORLD)
    return ref


def _axis_sharded(part: dict, mode: str, model, mesh, shardings, layout, spy=None):
    """The sharded step of a part's ``model`` on ``mesh``: (readings: loss,
    norms, factors, this rank's clipped-sum and parameter shards; figures:
    batch, stored share, split leaves, ms, collective bytes, launches,
    plain calls, peak)."""
    import torch

    from repro_torch.kernels import dispatch, launches
    from repro_torch.launch.steps import make_train_state
    from repro_torch.parallel import collectives
    from repro_torch.parallel.reshard import use_reshard_rules
    from repro_torch.utils.tree import flatten_dict

    opt, policy, dp, sched, batch = _axis_setup(part, mode)
    out = {"batch": int(batch["mask"].shape[0])}
    state = make_train_state(model, 0, opt, policy)
    full = layout.local_bytes(state["params"])
    state = layout.shard_state(state)
    _free()
    out["stored_share"] = layout.local_bytes(state["params"]) / full
    out["model_split_leaves"] = sum(d is not None for d in layout.model_dims.values())
    out["leaves"] = len(layout.model_dims)
    with (use_reshard_rules(mesh, part["cfg"]), spy or contextlib.nullcontext(),
          dispatch.force_impl("torch") if part.get("plain") else contextlib.nullcontext()):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        torch.distributed.barrier(group=torch.distributed.group.WORLD)
        launches.reset()
        collectives.reset_bytes()
        t0 = time.perf_counter()
        loss, g, aux, new = _axis_run(model, opt, dp, sched, batch, state, shardings)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3
        counts = launches.snapshot()
        out["bytes"] = dict(collectives.BYTES)
        out["launches"] = {k: counts[k]["cuda"] for k in KERNEL_INFO}
        out["plain_calls"] = sum(counts[k]["torch"] for k in KERNEL_INFO)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    got = {"loss": float(loss), "norms": aux["per_sample_norms"],
           "factors": aux["clip_factors"], "grads": flatten_dict(g),
           "params": flatten_dict(new["params"])}
    del state, batch
    return got, out


def _axis_step(part: dict, mode: str, mesh, rank: int, n: int) -> dict:
    """One clipped call plus the noise-and-update tail of a part's model on
    the (1, n) mesh, and the same on one rank (``_axis_ref``), held against
    each other: each rank that ran the reference holds its shards against
    its slices of the reference's gradient and parameters.  A part's keys:
    ``ref`` (``_axis_ref``'s ``how``, default "each"); ``ref_on_host``
    keeps the slices on the host (the two ranks' sharded steps then have
    the card to themselves); ``plain`` runs both steps in the plain PyTorch
    versions (else the kernels: the main path); ``gated`` (default: fp32
    compute) gates the errors in the report at ``tol`` ({quantity: limit},
    DIST_TOL elsewhere).  Returns the errors, the sharded step's figures,
    the reference's peak and the kernel calls' shapes."""
    model = part["build"]()
    shardings, layout = _axis_layout(part, model, mesh)

    def keep_slice(k, v):
        v = layout.local(k, v)
        return v.cpu() if part.get("ref_on_host") else v

    plain = part.get("plain", False)
    out = {"mode": mode, "dtype": part["dtype"], "seq": part["seq"], "model": part["model"],
           "gated": part.get("gated", part["dtype"] == "float32"), "plain": plain,
           "tol": {k: part.get("tol", {}).get(k, DIST_TOL)
                   for k in ("loss", "norms", "factors", "grads", "params")}}
    ref = _axis_ref(part, mode, rank, n, keep_slice, part.get("ref", "each"))
    if ref is not None:
        out["ref_peak_gib"] = ref["peak_gib"]
    spy = _KernelSpy(part["vocab"])
    got, figures = _axis_sharded(part, mode, model, mesh, shardings, layout, spy)
    out.update(figures, kernel_calls=spy.calls)
    if ref is not None:  # this rank's shards against its slices of the one-rank tensors
        out["err"], out["worst"] = _axis_errs(got, ref, mode)
    del model, got, ref
    _free()
    return out


def _tp_part(rank: int, n: int) -> dict:
    """The dist phase's tp part on this rank: the fp32 gates, then bf16."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(TP_MESH, "cuda")
    t0 = time.perf_counter()
    steps = [_axis_step(_lm_part(_tp_cfg("float32"), TP_BATCH, TP_SEQ), m, mesh, rank, n)
             for m in TP_MODES]
    steps += [_axis_step(dict(_lm_part(_tp_cfg("bfloat16"), TP_BATCH, TP_BF16_SEQ), ref="none"),
                         m, mesh, rank, n) for m in TP_BF16_MODES]
    return {"steps": steps, "seconds": time.perf_counter() - t0}


def _cnn_part(rank: int, n: int) -> dict:
    """The dist phase's cnn part on this rank: VGG-19 in TP_MODES on the
    fp32 main path (gated at AXIS_TOL) and in fp64 compute with the plain
    versions (gated at DIST_TOL), ViT-Base/16 in CNN_VIT_MODES in fp32; the
    one-rank steps on both ranks at once (a few GiB each)."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(TP_MESH, "cuda")
    t0 = time.perf_counter()
    vgg = dict(_vision_part("vgg19", CNN_VGG_BATCH, "float32"), tol=AXIS_TOL["vgg19"])
    witness = dict(_vision_part("vgg19", CNN_VGG_BATCH, "float64"), plain=True, gated=True)
    vit = _vision_part("vit_base", CNN_VIT_BATCH, "float32")
    steps = [_axis_step(p, m, mesh, rank, n) for p in (vgg, witness) for m in TP_MODES]
    steps += [_axis_step(vit, m, mesh, rank, n) for m in CNN_VIT_MODES]
    return {"steps": steps, "seconds": time.perf_counter() - t0}


def _mamba_part(rank: int, n: int) -> dict:
    """The dist phase's mamba part on this rank: Jamba's Mamba layer in
    TP_MODES on the fp32 main path at MAMBA_BATCH x MAMBA_SEQ (gated at
    AXIS_TOL; the one-rank step on rank 0, its slices on the card: each
    takes 47-55 GiB, and rank 1's shards meet the fp64 witness) and in fp64
    compute with the plain versions at MAMBA_F64_SEQ (gated at DIST_TOL,
    every rank's shards, the slices kept on the host)."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(TP_MESH, "cuda")
    t0 = time.perf_counter()
    cfg = _mamba_cfg("float32")
    main = dict(_lm_part(cfg, MAMBA_BATCH, MAMBA_SEQ), ref="rank0", tol=AXIS_TOL[cfg.name])
    witness = dict(_lm_part(_mamba_cfg("float64"), MAMBA_BATCH, MAMBA_F64_SEQ),
                   ref_on_host=True, plain=True, gated=True)
    steps = [_axis_step(p, m, mesh, rank, n) for p in (main, witness) for m in TP_MODES]
    return {"steps": steps, "seconds": time.perf_counter() - t0}


# the serve part: sharded prefill and greedy decode on the same (1, 2) mesh
# (launch.steps.make_prefill_step / make_decode_step with the serve state's
# placements), fp32 compute: Mixtral-8x7B (TP_LAYERS layer, its 4096-row
# window ring split by KV head) at SERVE_MIXTRAL (lanes, prompt), and
# Jamba-1.5-Large's (mamba, attn) period (JAMBA_EXPERTS experts, the
# config's bf16 parameters) at SERVE_JAMBA into a SERVE_JAMBA_ROWS-row cache
# (split by position: 16384 rows a rank; SSM state by head), each then
# SERVE_STEPS greedy decode steps fed the one-rank steps' tokens; gated
# against the one-rank steps on rank 0 at SERVE_AXIS_TOL
SERVE_MIXTRAL = ((2, 4608), (2, 1024))  # past the window (the ring), then within it
SERVE_JAMBA = ((1, 16640),)  # both ranks hold prompt rows
SERVE_JAMBA_ROWS = 32768
SERVE_STEPS = 16
SERVE_AXIS_TOL = DIST_TOL  # logits (of the largest |logit|), the gathered state (of a leaf's)
SERVE_PLAIN_ROWS = 2048  # the plain attention's query rows at a time (its scores (H, rows, S))


def _serve_models() -> list:
    """(name, config, [(lanes, prompt, max_len)]) of the serve part."""
    from repro_torch.configs.registry import get_arch

    jamba = dataclasses.replace(get_arch("jamba-1.5-large-398b"), n_layers=len(JAMBA_PERIOD),
                                block_pattern=JAMBA_PERIOD, moe_experts=JAMBA_EXPERTS,
                                dtype="float32")
    require((jamba.d_model, jamba.n_heads, jamba.n_kv, jamba.vocab) == (8192, 64, 8, 65536),
            f"serve: not Jamba's full width: {jamba}")
    return [("mixtral-8x7b", _tp_cfg("float32"),
             [(b, s, s + SERVE_STEPS) for b, s in SERVE_MIXTRAL]),
            ("jamba-1.5-large-398b", jamba,
             [(b, s, SERVE_JAMBA_ROWS) for b, s in SERVE_JAMBA])]


def _serve_run(model, params, batch: dict, state: dict, steps: int, tokens=None,
               shardings=None) -> dict:
    """A prefill then ``steps`` greedy decode steps through the serving
    steps; ``tokens`` (each step's input, B x 1) feeds the decode steps
    (None: its own greedy tokens).  Every step's logits, its greedy tokens,
    the final state, host ms (after a sync) and the bytes the collectives
    moved in the prefill and in each decode step."""
    import torch

    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.parallel import collectives

    prefill = make_prefill_step(model, shardings)
    decode = make_decode_step(model, shardings)
    out = {"logits": [], "greedy": [], "decode_ms": [], "decode_bytes": []}
    torch.cuda.synchronize()
    collectives.reset_bytes()
    t0 = time.perf_counter()
    logits, state = prefill(params, batch, state)
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["prefill_bytes"] = sum(collectives.BYTES.values())
    nxt = logits[:, -1:].argmax(dim=-1)
    out["logits"].append(logits.float().cpu())
    out["greedy"].append(nxt.cpu())
    for i in range(steps):
        given = nxt if tokens is None else tokens[i].to(nxt.device)
        collectives.reset_bytes()
        t0 = time.perf_counter()
        nxt, logits, state = decode(params, given, state)
        torch.cuda.synchronize()
        out["decode_ms"].append((time.perf_counter() - t0) * 1e3)
        out["decode_bytes"].append(sum(collectives.BYTES.values()))
        out["logits"].append(logits.float().cpu())
        out["greedy"].append(nxt.cpu())
    out["state"] = state
    return out


def _serve_part(rank: int, n: int) -> dict:
    """The dist phase's serve part on this rank: for each of _serve_models'
    runs, the one-rank prefill and decode steps on rank 0 (the full
    parameters and state), then every rank's sharded steps (its slices of
    the parameters, its serve state built at its local shapes) fed the
    one-rank greedy tokens, with the kernel launches counted from just
    before the prefill to just after the last decode step; rank 0 holds
    the logits and the gathered state against the one-rank run's."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import build_model
    from repro_torch.kernels import launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import local_serve_state, serve_state_specs
    from repro_torch.parallel.fsdp import ShardLayout
    from repro_torch.parallel.reshard import use_reshard_rules
    from repro_torch.parallel.sharding import local_serve_shardings, param_shardings
    from repro_torch.utils.tree import flatten_dict

    mesh = make_mesh(TP_MESH, "cuda")
    t_part = time.perf_counter()
    runs = []
    for name, cfg, shapes in _serve_models():
        model = build_model(cfg, device="cuda")
        full = model.init(torch.Generator(device="cuda").manual_seed(0))
        local = ShardLayout(mesh, param_shardings(model, mesh, cfg, full)).shard(full)
        if rank != 0:  # only rank 0 runs the one-rank steps
            full = None
            _free()
        for lanes, prompt, max_len in shapes:
            gen = torch.Generator(device="cuda").manual_seed(prompt)
            batch = {"tokens": torch.randint(1, cfg.vocab, (lanes, prompt), generator=gen,
                                             device="cuda")}
            run = {"model": name, "lanes": lanes, "prompt": prompt, "rows": max_len,
                   "steps": SERVE_STEPS}
            ref = None
            if rank == 0:
                torch.cuda.reset_peak_memory_stats()
                ref = _serve_run(model, full, batch, model.init_state(lanes, max_len),
                                 SERVE_STEPS)
                run["ref_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            # every rank decodes the one-rank greedy tokens
            fed = [ref["greedy"][:SERVE_STEPS] if rank == 0 else None]
            torch.distributed.broadcast_object_list(fed, src=0)
            shape = ShapeConfig("serve", max_len, lanes, "decode")
            placements = local_serve_shardings(
                mesh, cfg, serve_state_specs(model, cfg, shape, lanes), lanes)
            state = local_serve_state(model, cfg, shape, lanes, placements, mesh)
            run["state_share"] = (
                sum(x.numel() * x.element_size() for x in flatten_dict(state).values())
                / sum(x.numel() * x.element_size()
                      for x in flatten_dict(serve_state_specs(model, cfg, shape,
                                                              lanes)).values()))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            torch.distributed.barrier(group=torch.distributed.group.WORLD)
            with use_reshard_rules(mesh, cfg), _KernelSpy() as spy:
                launches.reset()  # the main path's counts start here ...
                got = _serve_run(model, local, batch, state, SERVE_STEPS, tokens=fed[0],
                                 shardings=placements)
                counts = launches.snapshot()  # ... and are read here
                run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                whole = ShardLayout(mesh, placements).gather(got.pop("state"))
            run.update(launches={k: counts[k]["cuda"] for k in KERNEL_INFO},
                       plain_calls=sum(counts[k]["torch"] for k in KERNEL_INFO),
                       attention_calls={key: calls for (k, key), calls in spy.calls.items()
                                        if k == "flash_attention"},
                       prefill_ms=got["prefill_ms"],
                       decode_ms=statistics.median(got["decode_ms"]),
                       prefill_bytes=got["prefill_bytes"],
                       decode_bytes=statistics.median(got["decode_bytes"]),
                       # numpy: the rank's tensors do not outlive its process
                       logits=[x.numpy() for x in got["logits"]],
                       greedy=[x.numpy() for x in got["greedy"]])
            if ref is not None:
                run["err"] = _serve_errs(got, ref, whole)
            runs.append(run)
            del ref, got, whole, state
            _free()
        del model, full, local
        _free()
    return {"runs": runs, "seconds": time.perf_counter() - t_part}


def _serve_errs(got: dict, ref: dict, whole: dict) -> dict:
    """The sharded run against the one-rank run: every step's logits over
    the one-rank logits' largest entry, the greedy tokens (equal wherever
    the one-rank top-2 gap exceeds the logits' error), and the gathered
    state leaf by leaf (floats over each leaf's largest entry, positions
    and fill levels exact)."""
    import torch

    from repro_torch.utils.tree import flatten_dict

    logits = [float((a - b).abs().max() / b.abs().max())
              for a, b in zip(got["logits"], ref["logits"])]
    differ, near = 0, 0
    for a, b, la, lb in zip(got["greedy"], ref["greedy"], got["logits"], ref["logits"]):
        err = float((la - lb).abs().max())
        for lane in range(b.shape[0]):
            if _top2_gap(lb[lane, -1]) > err:
                differ += int(not torch.equal(a[lane], b[lane]))
            else:
                near += 1
    state, worst = 0.0, None
    want = flatten_dict(ref["state"])
    for k, v in flatten_dict(whole).items():
        w = want[k].to(v.device)
        if v.dtype.is_floating_point:
            e = float((v.double() - w.double()).abs().max() / w.abs().max().clamp_min(1e-30))
        else:
            e = 0.0 if torch.equal(v, w) else float("inf")
        if e >= state:
            state, worst = e, k
    return {"prefill_logits": logits[0], "decode_logits": max(logits[1:]),
            "tokens_differ": differ, "near_ties": near, "state": state, "state_worst": worst}


def _serve_report(results: dict, name: str = "serve") -> dict:
    """The serve part's gates and figures from both ranks' results, then the
    attention kernel against its plain version (and SDPA with the KV heads
    repeated) at the prefill shapes rank 0 gave it."""
    import numpy as np
    import torch

    r0 = results[0][name]
    bad = []
    for i, run in enumerate(r0["runs"]):
        mine = [res[name]["runs"][i] for res in sorted(results.values(),
                                                       key=lambda r: r["rank"])]
        for other in mine[1:]:  # every rank holds every lane's logits and tokens
            require(all(np.array_equal(a, b) for a, b in zip(other["logits"], run["logits"]))
                    and all(np.array_equal(a, b)
                            for a, b in zip(other["greedy"], run["greedy"])),
                    f"serve {run['model']} b{run['lanes']} x {run['prompt']}: ranks differ")
        attn = JAMBA_PERIOD.count("attn") if run["model"].startswith("jamba") else TP_LAYERS
        for res in mine:
            require(res["launches"]["flash_attention"] == attn and res["plain_calls"] == 0
                    and sum(res["launches"].values()) == attn,
                    f"serve {run['model']} rank: launches {res['launches']}, plain calls "
                    f"{res['plain_calls']} (want {attn} flash_attention a prefill)")
        err = run["err"]
        bad += [(run["model"], run["prompt"], k, err[k]) for k in
                ("prefill_logits", "decode_logits", "state") if not err[k] <= SERVE_AXIS_TOL]
        if err["tokens_differ"]:
            bad.append((run["model"], run["prompt"], "tokens_differ", err["tokens_differ"]))
        print(f"dist serve: {run['model']} b{run['lanes']} x {run['prompt']} into {run['rows']} "
              f"rows, {run['steps']} decode steps, fp32, kernels: vs one rank prefill logits "
              f"{err['prefill_logits']:.3g}, decode logits {err['decode_logits']:.3g}, state "
              f"{err['state']:.3g} ({err['state_worst']}), greedy tokens differ "
              f"{err['tokens_differ']} ({err['near_ties']} near ties) (gated at "
              f"{SERVE_AXIS_TOL:.0e}); per rank prefill "
              + ", ".join(f"{r['prefill_ms']:.1f}" for r in mine) + " ms, decode step "
              + ", ".join(f"{r['decode_ms']:.2f}" for r in mine) + " ms (not a speed figure: "
              "the ranks share the card over host-staged gloo); bytes a rank per prefill "
              + ", ".join(f"{r['prefill_bytes'] / 2**20:.1f}" for r in mine)
              + " MiB, per decode step "
              + ", ".join(f"{r['decode_bytes'] / 2**20:.3f}" for r in mine) + " MiB; peak "
              + ", ".join(f"{r['peak_gib']:.2f}" for r in mine) + f" GiB a rank (one rank "
              f"{run['ref_peak_gib']:.2f}); state share {run['state_share']:.4f}; launches "
              + "; ".join(f"rank {j} {r['launches']}" for j, r in enumerate(mine)))
    require(not bad, f"dist serve: off the one-rank steps: {bad}")
    out = {"mesh": TP_MESH, "part": name, "seconds": r0["seconds"], "kernel_cases": {}}
    out["launches_by_model"] = {
        model: {k: sum(res[name]["runs"][i]["launches"][k] for res in results.values()
                       for i, run in enumerate(r0["runs"]) if run["model"] == model)
                for k in KERNEL_INFO}
        for model in dict.fromkeys(run["model"] for run in r0["runs"])}
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    print("dist serve: flash_attention at rank 0's prefill shapes, fp32 (yardstick: SDPA with "
          "the KV heads repeated; the masks as one mask, or is_causal at "
          f">= {SERVE_JAMBA_ROWS // 2} rows; the plain version {SERVE_PLAIN_ROWS} query rows "
          "at a time)")
    for run in r0["runs"]:
        for spec, calls in sorted(run["attention_calls"].items(), key=str):
            big = spec[1] >= SERVE_JAMBA_ROWS // 2
            case = _flash_case(spec, "float32", gen, timed=True, repeated_kv=not big,
                               plain_rows=SERVE_PLAIN_ROWS)
            case["path"], case["calls_per_step"] = f"{name}:{run['model']}", calls
            cases.append(case)
            _free()
    out["kernel_cases"]["flash_attention"] = cases
    out["runs"] = [{k: v for k, v in run.items()
                    if k not in ("logits", "greedy", "attention_calls")} for run in r0["runs"]]
    for res in results.values():  # tensors and tuple keys: not for the JSON record
        for run in res[name]["runs"]:
            for k in ("logits", "greedy", "attention_calls"):
                run.pop(k, None)
    return out


AXIS_PARTS = {"tp": _tp_part, "cnn": _cnn_part, "mamba": _mamba_part, "serve": _serve_part}


def _rank_main(rank: int, n: int, port: int, queue, body, args: tuple) -> None:
    """One of ``spawn_ranks``'s processes: join the gloo group as
    ``torch.distributed.run`` would have it join (the CLI's
    ``init_distributed``), TF32 off, then ``body(rank, n, *args)``, whose
    result (or traceback) goes to ``queue``."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    sys.path.insert(0, str(SRC))
    try:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.launch import train

        backend = train.init_distributed()
        require(backend == "gloo", f"dist: {n} ranks on one card chose {backend}")
        _settle()
        queue.put((rank, "ok", body(rank, n, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        import torch

        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def spawn_ranks(body, *args, n: int = DIST_RANKS) -> dict:
    """``body(rank, n, *args)`` in ``n`` spawned processes joined in one
    gloo group on the card (``_rank_main``): {rank: result}; any rank's
    traceback fails the phase.  Every process is joined, or killed after a
    minute, before this returns."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, queue, body, args))
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in procs:
            rank, status, value = queue.get(timeout=DIST_TIMEOUT_S)
            (results.__setitem__(rank, value) if status == "ok"
             else errors.append(f"rank {rank}:\n{value}"))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    require(not errors, "dist: " + "\n".join(errors))
    return results


def _dist_rank(rank: int, n: int, plan_path: str, tmp: str) -> dict:
    """One rank of the dist phase: the sharded steps, the NCCL rank, the
    CLI, then the model-axis parts."""
    from repro_torch.launch.mesh import make_host_mesh

    res = {"rank": rank}
    mesh = make_host_mesh("cuda")
    cfg32 = dataclasses.replace(_train_cli_cfg(), dtype="float32")
    cfg16 = _train_cli_cfg()
    cases = [(cfg32, m, "fixed", False) for m in DIST_MODES]
    cases += [(cfg32, "bk_mixed", "quantile", True)]
    cases += [(cfg16, m, "fixed", False) for m in DIST_BF16_MODES]
    res["steps"] = [_dist_case(*c, mesh, rank) for c in cases]
    res["nccl"] = _dist_nccl(cfg32, rank)
    res["cli"] = _dist_cli(rank, plan_path, Path(tmp))
    for name, part in AXIS_PARTS.items():
        _settle()
        res[name] = part(rank, n)
    res["gc_seconds"] = GC_SECONDS["seconds"]
    return res


def _dist_plan(path: Path) -> str:
    """The plan both ranks adopt: measured here on one process at the
    per-rank batch (no batch certificate; the agreement's hash is what the
    gate reads)."""
    import torch

    from repro_torch.configs.registry import build_model
    from repro_torch.core.clipping import discover_meta
    from repro_torch.data.synthetic import synthetic_arch_batch
    from repro_torch.tuner.measure import MeasureConfig, build_plan

    cfg = _train_cli_cfg()
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    probe = synthetic_arch_batch(cfg, batch=TRAIN_CLI_BATCH // DIST_RANKS, seq=TRAIN_CLI_SEQ,
                                 device="cuda")
    metas = discover_meta(model.loss_with_ctx, params, probe)
    plan = build_plan(metas, measure=MeasureConfig(repeats=1, warmup=1, max_rows=1024),
                      arch=cfg.name, device="cuda")
    plan.save(str(path))
    del model, params, probe
    _free()
    return plan.consensus_hash()


def phase_dist() -> dict:
    """Data-parallel + FSDP DP-SGD (``launch.steps`` with ``shardings``,
    ``parallel/``) on Whisper-large-v3 at full width, 1 + 1 layers, global
    batch 4 x 448 over 1500 frames, by DIST_RANKS gloo ranks sharing the
    card (spawned processes; the CLI's backend rule picks gloo):

    1. one sharded step in each of DIST_MODES and one bk_mixed step under
       the quantile policy with a Poisson mask, fp32 compute, TF32 off,
       held against the one-rank step on the same inputs and generator
       state: loss, per-sample norms and clip factors, the clipped gradient
       sum before the noise and the noised gradient (every rank's shards
       against the one-rank tensors' slices) and the parameters after an
       SGD-with-momentum update, at DIST_TOL; each
       rank holds 1/n of every sharded leaf, params and momentum; the
       kernels launched (no plain call) and the bytes the step gathers,
       reduce-scatters and all-reduces; bf16 compute in DIST_BF16_MODES
       reported against the bf16 one-rank step, ungated;
    2. rank 0 alone in an NCCL group: a bk_mixed step whose collectives run
       on NCCL, against the one-rank step;
    3. the train CLI on both ranks (bf16, remat, bk_mixed, quantile,
       Poisson, --consensus on a plan measured here): both ranks adopt the
       plan's hash, a run crashed at DIST_CLI_CRASH and auto-restarted lands
       bit-identical to the straight run, and the checkpoint holds the
       one-rank state's leaf names and shapes;
    4. the tp part: the model axis on a TP_MESH (1, 2) mesh of the same
       ranks (``launch.mesh.make_mesh``), Mixtral-8x7B at full width (4
       experts a rank, half the q/k/v/o columns, half the vocabulary of the
       embedding and the head), TP_LAYERS layer, remat on: a step in each of
       TP_MODES in fp32 at b TP_BATCH x TP_SEQ held against the one-rank
       step (run one rank at a time) at DIST_TOL (loss, norms, factors, the
       clipped sum before the noise and the parameters after an SGD +
       momentum update, each rank's shards against its slices), the launches
       (no plain call), the bytes all-reduced, each rank's peak and stored
       share, then TP_BF16_MODES in bf16 at TP_BF16_SEQ reported; the four
       clipping kernels against their plain versions at the local shapes
       the fp32 steps gave them (``_KernelSpy``);
    5. the cnn part, the same way on the same mesh: VGG-19 (CIFAR-10 widths,
       GroupNorm, 32 x 32) at b CNN_VGG_BATCH in TP_MODES and ViT-Base/16
       (224 x 224) at b CNN_VIT_BATCH in CNN_VIT_MODES: every conv split on
       its output channels and gathered, the classifier's 10 classes split,
       ViT-Base's blocks tensor-parallel and its ``pos_embed`` whole;
    6. the mamba part: Jamba-1.5-Large at full width cut to its first layer
       (a Mamba layer, 128 of its 256 heads a rank, with its dense MLP), b
       MAMBA_BATCH x MAMBA_SEQ, in TP_MODES, the references' slices kept on
       the host;
    7. the serve part: sharded prefill and greedy decode (``launch.steps
       .make_prefill_step`` / ``make_decode_step`` with the serve state's
       placements, ``parallel.sharding.local_serve_shardings``) on the same
       mesh, fp32 compute, each rank holding its slices of the parameters
       and a serve state built at its local shapes: Mixtral-8x7B (TP_LAYERS
       layer, 4 of 8 experts, 16 of 32 q heads and 4 of 8 KV heads a rank;
       its 4096-row window ring split by KV head) at b2 x 4608 (the ring
       prefill) and b2 x 1024, and Jamba-1.5-Large's (mamba, attn) period
       (JAMBA_EXPERTS experts, the config's bf16 parameters; 128 of 256
       Mamba heads a rank) at b1 x 16640 into a 32768-row cache split by
       position (16384 rows a rank, both holding prompt rows), each then
       SERVE_STEPS decode steps fed the one-rank greedy tokens: every step's
       logits and the gathered state against the one-rank steps (on rank 0)
       at SERVE_AXIS_TOL, the greedy tokens equal wherever the one-rank top-2
       gap exceeds the logits' error; one flash_attention launch a prefill on
       each rank and no plain call; the bytes a prefill and a decode step
       move a rank, peaks, ms; then the attention kernel against its plain
       version and SDPA at rank 0's prefill shapes.
    Every training part's fp32 main path (the kernels) is gated against the
    one-rank step, at DIST_TOL where fp32 rounding stays under it (the tp
    part, ViT-Base, Jamba's loss, norms and factors) and at AXIS_TOL where
    it does not: VGG-19's sharded and one-rank forwards round apart at
    ~1e-7, which flips a few ReLU signs and max-pool picks of its last
    blocks and moves those samples' gradients by ~1e-3; Jamba's A_log and
    dt_bias gradients sum 2 x 1024 positions of every head.  Each limit
    lies between sound fp32 runs' readings and a bf16-compute control's
    (``scripts/axis_parts.py vgg19_sound mamba_sound``).  A second witness
    holds both models at DIST_TOL in fp64 compute, the plain PyTorch
    versions on both sides (the kernels take fp32 and bf16; Jamba at b
    MAMBA_BATCH x MAMBA_F64_SEQ).  Each training part requires the
    four clipping kernels launched on its fp32 main path.  Timings of
    ranks that share a card are not a speed figure."""
    import shutil
    import tempfile

    from repro_torch.configs.base import torch_dtype
    from repro_torch.configs.registry import build_model
    from repro_torch.launch.steps import make_train_state
    from repro_torch.optim import adam
    from repro_torch.checkpoint.checkpointer import snapshot_state
    from repro_torch.utils.tree import flatten_dict

    out = {"ranks": DIST_RANKS, "arch": TRAIN_CLI_ARCH, "layers": TRAIN_CLI_LAYERS,
           "batch": TRAIN_CLI_BATCH, "seq": TRAIN_CLI_SEQ}
    with tempfile.TemporaryDirectory(prefix="dist_") as tmp:
        tmp = Path(tmp)
        plan_hash = _dist_plan(tmp / "plan.json")
        cfg = _train_cli_cfg()
        model = build_model(cfg, device="cuda")
        state = make_train_state(model, 0, adam(state_dtype=torch_dtype(cfg.opt_state_dtype)),
                                 _dist_policy("quantile"))
        one_rank = {k: tuple(getattr(v, "shape", ()))
                    for k, v in flatten_dict(snapshot_state(state)).items()}
        del state
        del model
        _free()
        t0 = time.perf_counter()
        results = spawn_ranks(_dist_rank, str(tmp / "plan.json"), str(tmp))
        out["seconds"] = time.perf_counter() - t0
        final = f"step_{DIST_CLI_STEPS}.npz"
        straight = _npz_leaves(tmp / "straight" / final)
        restarted = _npz_leaves(tmp / "restarted" / final)
        diverged = [k for k in straight if not (straight[k] == restarted[k]).all()]
        require(sorted(straight) == sorted(restarted) and not diverged,
                f"dist cli: restarted run diverged at {diverged[:8]}")
        shapes = {k: tuple(v.shape) for k, v in straight.items()}
        require(shapes == one_rank, "dist cli: checkpoint leaves differ from the one-rank "
                f"state's: {sorted(set(shapes.items()) ^ set(one_rank.items()))[:8]}")
        out["checkpoint_leaves"] = len(shapes)
        shutil.rmtree(tmp / "straight")
        shutil.rmtree(tmp / "restarted")
    r0 = results[0]
    for res in results.values():
        for name, run in res["cli"].items():
            require(run["hashes"] == [plan_hash], f"dist cli {name} rank {res['rank']}: "
                    f"adopted {run['hashes']}, the plan is {plan_hash}")
            require(not any(run["torch"].values()) and any(run["cuda"].values()),
                    f"dist cli {name} rank {res['rank']}: launches {run}")
        for st in res["steps"]:
            require(st["plain_calls"] == 0, f"dist rank {res['rank']}: plain calls in {st}")
    for i, st in enumerate(r0["steps"]):  # every rank's shards: the gathered comparison
        st["err"] = {k: max(res["steps"][i]["err"][k] for res in results.values())
                     for k in st["err"]}
    bad = []
    for st in r0["steps"] + [r0["nccl"]]:
        gated = st["dtype"] == "float32"
        line = ", ".join(f"{k} {v:.3g}" for k, v in st["err"].items())
        print(f"dist: {st['mode']} {st['policy']}{' poisson' if st['poisson'] else ''} "
              f"{st['dtype']}{' nccl' if st is r0['nccl'] else ''}: vs one rank {line} "
              f"({'gated' if gated else 'reported'}); rank 0 {st['ms']:.1f} ms (ranks share "
              f"the card), gathers {st['bytes']['all_gather'] / 2**20:.1f} MiB, "
              f"reduce-scatters {st['bytes']['reduce_scatter'] / 2**20:.1f} MiB, all-reduces "
              f"{st['bytes']['all_reduce'] / 2**20:.1f} MiB; launches {st['launches']}")
        if gated:
            bad += [(st["mode"], st["policy"], k, v) for k, v in st["err"].items()
                    if not v <= DIST_TOL]
    require(not bad, f"dist: off the one-rank step at {DIST_TOL}: {bad}")
    main = {k: sum(res["steps"][i]["launches"][k] for res in results.values()
                   for i in range(len(DIST_MODES) + 1)) for k in KERNEL_INFO}
    require(all(main[k] for k in ("ghost_norm_sq", "embedding_ghost_norm_sq",
                                  "book_weighted_grad", "psg_contract")),
            f"dist: a clipping kernel never launched on the sharded path: {main}")
    st = r0["steps"][0]
    print(f"dist: each rank stores {st['sharded_leaves']} of {st['leaves']} leaves sharded: "
          f"params {st['stored_fraction']['params']:.4f}, momentum "
          f"{st['stored_fraction']['m']:.4f} of one rank's bytes; launches on the fp32 main "
          f"path per rank "
          + "; ".join(f"rank {r} " + str({k: sum(s['launches'][k] for s in
                                                 res['steps'][:len(DIST_MODES) + 1])
                                          for k in KERNEL_INFO})
                      for r, res in sorted(results.items())))
    for name in ("straight", "restarted"):
        run = r0["cli"][name]
        print(f"dist cli {name}: both ranks adopted {plan_hash}; rank 0 {run['seconds']:.1f} s, "
              f"step s {[round(x, 3) for x in run['step_s']]}")
    print(f"dist cli: straight and restarted (crash at step {DIST_CLI_CRASH}) bit-identical over "
          f"{out['checkpoint_leaves']} leaves, the one-rank state's names and shapes; phase "
          f"processes {out['seconds']:.1f} s")
    for name in AXIS_PARTS:
        out[name] = (_serve_report if name == "serve" else _axis_report)(results, name)
    out["results"] = results
    out["plan_hash"] = plan_hash
    out["launches"] = main
    return out


def _axis_report(results: dict, name: str) -> dict:
    """A model-axis part's gates and figures from both ranks' results, then
    the four clipping kernels against their plain versions at the shapes
    rank 0 recorded on the main path (``kernel_cases``, PERF.md's "per
    rank" counts)."""
    import torch

    out = {"mesh": TP_MESH, "part": name}
    r0 = results[0][name]
    bad = []
    for i, st in enumerate(r0["steps"]):
        gated = st["gated"]
        for res in results.values():
            mine = res[name]["steps"][i]
            require(mine["plain_calls"] == 0 or mine["plain"],
                    f"{name} rank {res['rank']}: plain calls in {mine}")
            require(mine["launches"] == dict.fromkeys(KERNEL_INFO, 0) or not mine["plain"],
                    f"{name} rank {res['rank']}: kernels launched on a plain step: {mine}")
            if gated:
                bad += [(st["model"], st["mode"], st["dtype"], res["rank"], k, v)
                        for k, v in mine.get("err", {}).items() if not v <= st["tol"][k]]
        held = [res[name]["steps"][i]["err"] for res in results.values()
                if "err" in res[name]["steps"][i]]  # the ranks that ran the reference
        require(held or not gated, f"{name}: {st['model']} {st['mode']} gated, no reference")
        errs = {k: max(e[k] for e in held) for k in held[0]} if held else {}
        st["err_all_ranks"] = errs
        line = ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) or "not run"
        peaks = [res[name]["steps"][i]["peak_gib"]
                 for res in sorted(results.values(), key=lambda r: r["rank"])]
        ref_peaks = [res[name]["steps"][i].get("ref_peak_gib") for res in results.values()]
        shape = f"b{st['batch']}" + (f" x {st['seq']}" if st["seq"] else "")
        how = "plain versions" if st["plain"] else "kernels"
        limits = ", ".join(f"{k} {v:.0e}" for k, v in st["tol"].items())
        gate = f"gated at {limits}" if gated else "reported"
        print(f"dist {name}: {st['model']} {st['mode']} {st['dtype']} {shape}, {how}: vs one "
              f"rank {line} ({gate}); rank 0 {st['ms']:.1f} "
              f"ms (not a speed figure: the ranks share the card over host-staged gloo); "
              f"all-reduces {st['bytes']['all_reduce'] / 2**20:.1f} MiB, gathers "
              f"{st['bytes']['all_gather'] / 2**20:.1f} MiB a rank; peak per rank "
              f"{', '.join(f'{p:.2f}' for p in peaks)} GiB, one-rank reference "
              f"{max((p for p in ref_peaks if p is not None), default=0.0):.2f} GiB; stored share "
              f"{st['stored_share']:.4f} ({st['model_split_leaves']} of {st['leaves']} leaves "
              f"split on model); launches {st['launches']}; worst leaves (path, leaf max / "
              f"tree max, error) "
              + "; ".join(f"rank {res['rank']} {res[name]['steps'][i].get('worst')}"
                          for res in results.values()))
    require(not bad, f"dist {name}: off the one-rank step: {bad}")
    main = [i for i, st in enumerate(r0["steps"]) if not st["plain"] and st["dtype"] == "float32"]
    out["launches"] = {k: sum(res[name]["steps"][i]["launches"][k]
                              for res in results.values() for i in main) for k in KERNEL_INFO}
    out["launches_by_model"] = {
        model: {k: sum(res[name]["steps"][i]["launches"][k] for res in results.values()
                       for i in main if r0["steps"][i]["model"] == model) for k in KERNEL_INFO}
        for model in dict.fromkeys(r0["steps"][i]["model"] for i in main)}
    require(all(out["launches"][k] for k in ("ghost_norm_sq", "embedding_ghost_norm_sq",
                                             "book_weighted_grad", "psg_contract")),
            f"dist {name}: a clipping kernel never launched on the model axis: "
            f"{out['launches']}")
    print(f"dist {name}: launches on the fp32 main path per rank "
          + "; ".join(f"rank {r} " + str({k: sum(res[name]["steps"][i]["launches"][k]
                                                 for i in main) for k in KERNEL_INFO})
                      for r, res in sorted(results.items())))
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {k: [] for k in KERNEL_INFO}
    cases["conv_ghost_norm_sq"] = []
    print(f"dist {name}: the clipping kernels at rank 0's main-path shapes, against their "
          "plain versions:")
    for model in out["launches_by_model"]:
        by_mode = {r0["steps"][i]["mode"]: r0["steps"][i] for i in main
                   if r0["steps"][i]["model"] == model}
        for _, kernel, mode in TP_SPY:
            if mode not in by_mode:
                continue
            for (k, (shape, dtypes)), calls in sorted(by_mode[mode]["kernel_calls"].items(),
                                                      key=str):
                if k != kernel:
                    continue
                case = _kernel_case(kernel, shape, dtypes, gen, timed=True)
                case["path"], case["calls_per_step"] = f"{name}:{model}", calls
                cases[kernel].append(case)
                _free()
    out["kernel_cases"] = cases
    out["seconds"] = r0["seconds"]
    out["steps"] = r0["steps"]
    for res in results.values():  # tuple keys: not for the JSON record
        for st in res[name]["steps"]:
            st.pop("kernel_calls", None)
    return out


# ------------------------------------------------------------- dryrun --
# The single-card cells the slice phase runs live, (path, mode), that the
# dry run predicts; and the dist phase's tp part's fp32 steps (TP_MODES; its
# bf16 steps are left out for the phase's time)
DRYRUN_CELLS = (("vgg19", "mixed_ghost"), ("vgg19", "bk_mixed"), ("yi_6b", "bk_mixed"),
                ("mixtral", "bk_mixed"))
DRYRUN_TIMEOUT_S = 300


def _dryrun_task(task: tuple) -> dict:
    """One prediction of the dryrun phase, ("cell", path tag, mode) or
    ("tp", None, mode), in a process of the child's pool: the kernels'
    launches, the state's, arguments' and peak bytes, the bytes accessed
    and the collectives' bytes by op, and the seconds it took."""
    import torch

    from repro_torch.configs.registry import build_model
    from repro_torch.data.synthetic import synthetic_arch_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import constant, sgd

    torch.set_num_threads(1)  # fake tensors compute nothing
    kind, tag, mode = task
    t0 = time.perf_counter()
    if kind == "cell":
        path = _path_specs()[tag]
        res = dryrun.evaluate_train(
            lambda: path["build"](device="cpu"), None, Mesh(("data", "model"), (1, 1)),
            lambda: _path_batch(path, path["batch"], 0, device="cpu"),
            path.get("optimizer", lambda: sgd(momentum=0.9))(), mode=mode)
        head = {"tag": tag, "mode": mode}
    else:
        cfg = _tp_cfg("float32")
        res = dryrun.evaluate_train(
            lambda: build_model(cfg, device="cpu"), cfg, Mesh(("data", "model"), TP_MESH),
            lambda: synthetic_arch_batch(cfg, batch=TP_BATCH, seq=TP_SEQ, device="cpu"),
            sgd(momentum=0.9), mode=mode, schedule=constant(1e-3), policy=_dist_policy("fixed"))
        head = {"mode": mode, "dtype": cfg.dtype, "seq": TP_SEQ}
    by_op = dict.fromkeys(("all_gather", "reduce_scatter", "all_reduce"), 0)
    for op, n, _ in res["records"]:
        by_op[op] += n
    return {**head, "launches": {k: res["launches"][k] for k in KERNEL_INFO},
            "state_bytes": res["state_bytes"], "argument_bytes": res["argument_bytes"],
            "peak_bytes": res["peak_bytes"], "bytes_accessed": res["bytes_accessed"],
            "bytes": by_op, "collectives": len(res["records"]),
            "seconds": time.perf_counter() - t0}


def _dryrun_child() -> dict:
    """The dryrun phase's evaluations (``launch.dryrun``), run in a process
    of their own so that no process group outlives them: this torch's
    version, its fake process group and the trackers, then each cell's
    prediction for the card over fake tensors (the kernels' abstract
    evaluation at the H100's constants), the cells in a pool of processes
    (each ``_dryrun_task``; the CPU only)."""
    import concurrent.futures
    import multiprocessing

    import torch
    import torch.distributed._tools.mem_tracker as mem_tracker
    from torch.testing._internal.distributed import fake_pg

    env = {"torch": torch.__version__, "fake_pg": f"{fake_pg.__name__}.FakeStore "
           f"{'present' if hasattr(fake_pg, 'FakeStore') else 'missing'}",
           "tracker": "repro_torch.launch.analysis.MemoryTracker (a TorchDispatchMode); "
           f"torch's MemTracker {'present' if hasattr(mem_tracker, 'MemTracker') else 'missing'}"}
    tasks = [("cell", tag, mode) for tag, mode in DRYRUN_CELLS]
    tasks += [("tp", None, mode) for mode in TP_MODES]
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(tasks), mp_context=multiprocessing.get_context("spawn")) as pool:
        done = list(pool.map(_dryrun_task, tasks))
    return {"env": env, "cells": done[:len(DRYRUN_CELLS)], "tp": done[len(DRYRUN_CELLS):]}


def phase_dryrun(slices: dict) -> dict:
    """The dry run's predictions for the card (``_dryrun_child``, in a
    subprocess) held against what the card ran: per single-card cell the
    kernels' launches per step and the state's bytes against the slice
    phase's live step (gated, exactly), the tracked peak against
    ``max_memory_allocated`` (reported, with the ratio); the tp part's
    predictions are gated after the dist phase (``dryrun_tp_gate``).  Also
    the target card's constants of the kernels' abstract evaluation
    (``kernels.checks.TARGET_*``) against this card's readings."""
    import torch

    from repro_torch.kernels import checks
    from repro_torch.kernels.ghost_norm.ghost_norm import embedding_slots, embedding_sort_capacity

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    require(sms == checks.TARGET_SM_COUNT, f"dryrun: {sms} SMs, the target has "
            f"{checks.TARGET_SM_COUNT}")
    for dt, per_sm in checks.TARGET_EMBED_BLOCKS_PER_SM.items():
        require(embedding_slots(0, dt) == sms * per_sm,
                f"dryrun: embedding slots {embedding_slots(0, dt)} for {dt}, target {per_sm}/SM")
    require(embedding_sort_capacity(0) == checks.TARGET_EMBED_SORT_CAPACITY,
            f"dryrun: sort capacity {embedding_sort_capacity(0)}, target "
            f"{checks.TARGET_EMBED_SORT_CAPACITY}")
    t0 = time.perf_counter()
    # a session of its own: on a timeout the child and its pool go together
    proc = subprocess.Popen(
        [sys.executable, "-c", "import json, sys; sys.path[:0] = sys.argv[1:3]; "
         "import chip_smoke; print(json.dumps(chip_smoke._dryrun_child()))", str(ROOT),
         str(SRC)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure(f"dryrun: no result within {DRYRUN_TIMEOUT_S} s") from None
    require(proc.returncode == 0, f"dryrun: the evaluation failed:\n{stderr[-4000:]}")
    pred = json.loads(stdout.strip().splitlines()[-1])
    print(f"dryrun: {sys.executable} torch {pred['env']['torch']}; fake process group "
          f"{pred['env']['fake_pg']}; tracker {pred['env']['tracker']}; {sms} SMs, embedding "
          f"slots and sort capacity as the target's; evaluated in "
          f"{time.perf_counter() - t0:.1f} s")
    for cell in pred["cells"]:
        live = slices[cell["tag"]][cell["mode"]]
        got = {k: float(v) for k, v in cell["launches"].items()}
        ratio = cell["peak_bytes"] / live["peak_bytes"]
        print(f"dryrun {cell['tag']} {cell['mode']}: launches predicted {cell['launches']}, "
              f"live {live['launches_per_step']}; state {cell['state_bytes']} B predicted, "
              f"{live['state_bytes']} B live; peak {cell['peak_bytes'] / 2**20:.1f} MiB "
              f"predicted, {live['peak_bytes'] / 2**20:.1f} MiB max_memory_allocated (ratio "
              f"{ratio:.3f}, reported); {cell['bytes_accessed']:.3e} bytes accessed op by op; "
              f"evaluated in {cell['seconds']:.1f} s")
        require(got == live["launches_per_step"],
                f"dryrun {cell['tag']} {cell['mode']}: launches {got} predicted, "
                f"{live['launches_per_step']} live")
        require(cell["state_bytes"] == live["state_bytes"],
                f"dryrun {cell['tag']} {cell['mode']}: state {cell['state_bytes']} B predicted, "
                f"{live['state_bytes']} B live")
        cell["live_peak_bytes"], cell["peak_ratio"] = live["peak_bytes"], ratio
    return pred


def dryrun_tp_gate(pred: dict, dist: dict) -> dict:
    """The dry run's tp-part steps against the dist phase's first ones (its
    fp32 steps, in TP_MODES' order): each step's
    bytes a rank gathers, reduce-scatters and all-reduces and its kernel
    launches, predicted for rank 0, against rank 0's ``collectives.BYTES``
    and launch counts (gated, exactly); the peak reported."""
    steps = dist["tp"]["steps"]
    for p, st in zip(pred["tp"], steps):
        key = (st["mode"], st["dtype"], st["seq"])
        require((p["mode"], p["dtype"], p["seq"]) == key, f"dryrun tp: {p} against {key}")
        print(f"dryrun tp {st['mode']} {st['dtype']} b{st['batch']} x {st['seq']}: bytes a rank "
              f"predicted {p['bytes']}, live rank 0 {st['bytes']}; launches predicted "
              f"{p['launches']}, live {st['launches']}; peak {p['peak_bytes'] / 2**30:.2f} GiB "
              f"predicted, {st['peak_gib']:.2f} GiB live (ratio "
              f"{p['peak_bytes'] / 2**30 / st['peak_gib']:.3f}, reported); "
              f"{p['collectives']} collectives, evaluated in {p['seconds']:.1f} s")
        require(p["bytes"] == st["bytes"], f"dryrun tp {key}: bytes {p['bytes']} predicted, "
                f"{st['bytes']} live")
        require(p["launches"] == st["launches"], f"dryrun tp {key}: launches {p['launches']} "
                f"predicted, {st['launches']} live")
        p["live_peak_gib"] = st["peak_gib"]
    return pred


def run() -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for cuDNN and matmuls: fp32 comparisons in full fp32")
    seconds, gc_seconds = {}, {}

    def phase(name, fn, *args, **kw):
        _settle()
        t0, gc0 = time.perf_counter(), GC_SECONDS["seconds"]
        res = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        gc_seconds[name] = GC_SECONDS["seconds"] - gc0
        _free()
        print(f"phase {name}: {seconds[name]:.1f} s ({gc_seconds[name]:.1f} s of it in the "
              "host's cyclic collector)")
        return res

    card = phase("card", phase_card)
    build = phase("build", phase_build)
    paths = phase("paths", _paths)
    kernels = phase("kernels", phase_kernels, paths)
    kernels["flash_attention"] = phase("flash_kernel", phase_flash_kernel)
    slices = {tag: phase(f"slice {tag}", phase_slice, tag, path, path.get("steps", STEPS))
              for tag, path in paths.items()}
    compare = {}
    for tag, path in paths.items():
        if "seq" in path:  # the LMs: gated in fp32 compute, bf16 reported
            compare[tag] = phase(f"compare {tag}", phase_compare, tag, path, "float32",
                                 batch_size=path["compare_batch"])
            compare[f"{tag}_bfloat16"] = phase(f"compare {tag} bf16", phase_compare, tag, path,
                                               gated=False, batch_size=path["compare_batch"])
        else:
            compare[tag] = phase(f"compare {tag}", phase_compare, tag, path)
    oracle = {
        "vgg19": phase("oracle vgg19", phase_oracle, "vgg19", paths["vgg19"], native_ref=True),
        "vit_base": phase("oracle vit_base", phase_oracle, "vit_base", paths["vit_base"],
                          "float32"),
        "vit_base_bfloat16": phase("oracle vit_base bf16", phase_oracle, "vit_base",
                                   paths["vit_base"], gated=False),
        "beit_large": phase("oracle beit_large", phase_oracle, "beit_large",
                            paths["beit_large"], "float32", policies=False),
        "beit_large_bfloat16": phase("oracle beit_large bf16", phase_oracle, "beit_large",
                                     paths["beit_large"], gated=False),
        "yi_6b": phase("oracle yi_6b", phase_oracle, "yi_6b", _oracle_path(paths["yi_6b"]),
                       "float32"),
        "mixtral": phase("oracle mixtral", phase_oracle, "mixtral",
                         _oracle_path(paths["mixtral"]), "float32"),
        "jamba": phase("oracle jamba", phase_oracle, "jamba", _oracle_path(paths["jamba"]),
                       "float32"),
        "xlstm": phase("oracle xlstm", phase_oracle, "xlstm", _oracle_path(paths["xlstm"]),
                       "float32"),
        "whisper": phase("oracle whisper", phase_oracle, "whisper",
                         _oracle_path(paths["whisper"]), "float32"),
        "phi3v": phase("oracle phi3v", phase_oracle, "phi3v", _oracle_path(paths["phi3v"]),
                       "float32"),
    }
    accum = phase("accum", phase_accum, paths["vgg19"])
    remat = phase("remat", phase_remat, paths, slices)
    tune = phase("tune", phase_tune, paths)
    max_batch = phase("max_batch", phase_max_batch, paths, tune)
    serve = phase("serve", phase_serve)
    moe_serve = phase("moe_serve", phase_moe_serve)
    hybrid_serve = phase("hybrid_serve", phase_hybrid_serve)
    wave_serve = phase("wave_serve", phase_wave_serve)
    tuner_cli = phase("tuner_cli", phase_tuner_cli, paths["yi_6b"])
    train_cli = phase("train_cli", phase_train_cli)
    dryrun = phase("dryrun", phase_dryrun, slices)
    dist = phase("dist", phase_dist)
    phase("dryrun tp", dryrun_tp_gate, dryrun, dist)
    for source in (train_cli, *(dist[name] for name in AXIS_PARTS)):
        for kernel, cases in source.pop("kernel_cases").items():
            kernels[kernel].extend(cases)
    runs = {**slices, "serve": serve, "moe_serve": moe_serve, "hybrid_serve": hybrid_serve,
            "wave_serve": wave_serve, "train_cli": train_cli,
            "dist": {"launches": dist["launches"]},
            **{f"{name}:{model}": {"launches": launched}
               for name in AXIS_PARTS
               for model, launched in dist[name]["launches_by_model"].items()}}
    summary = summary_line(kernels, runs)
    per_path = per_path_lines(kernels, runs)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; total {sum(seconds.values()):.1f}")
    print(card["nvidia_smi"])  # again at the end, beside the summary
    print(f"host cyclic collector: {GC_SECONDS['seconds']:.1f} s in "
          f"{GC_SECONDS['collections']} collections here (phases "
          + ", ".join(f"{k} {v:.1f}" for k, v in gc_seconds.items() if v >= 0.5)
          + "); dist ranks " + ", ".join(f"{res['gc_seconds']:.1f}"
                                         for _, res in sorted(dist["results"].items())) + " s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "card": card, "build": build, "steps": STEPS, "seconds": seconds,
        "gc_seconds": gc_seconds,
        "paths": {tag: {"batch": path["batch"], "image": path.get("image"),
                        "seq": path.get("seq"), "dtype": path["dtype"],
                        "expected": path["expected"], "modes": path["modes"]}
                  for tag, path in paths.items()},
        "kernels": kernels, "slice": slices, "compare": compare, "oracle": oracle,
        "accum": accum, "remat": remat, "tune": tune, "max_batch": max_batch, "serve": serve,
        "moe_serve": moe_serve, "hybrid_serve": hybrid_serve, "wave_serve": wave_serve,
        "tuner_cli": tuner_cli, "train_cli": train_cli, "dryrun": dryrun, "dist": dist,
        "summary": summary, "per_path": per_path,
    }, indent=1, default=str))
    return {"summary": summary, "card": card}


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run it from the "
              "repository checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        result = run()
    except Exception:  # report any failed phase and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps(result["summary"]))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": result["card"]["name"], "count": result["card"]["count"],
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
