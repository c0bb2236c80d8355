"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``llm_qat_torch/csrc`` (into
``build/llm_qat_torch/``; the megakernel sources, the slowest, compile on
through phases 2 and 2b), then:

1. prints the card's name and power limit and each source's build time;
2. runs each kernel's wrapper at the TinyLlama-1.1B shapes of the serving
   path (K1/K2 also at LLaMA-7B's projections, at decode and prefill rows;
   K4 also at the zero-shot scorer's buckets and caps, S = 32 to 200),
   holds it against its plain PyTorch version on the same inputs and
   times kernel, plain version and, where one exists, the single PyTorch
   call that computes the same function (``library_ms``; the port never
   calls it). The paged decode attention is also held against the contiguous
   decode attention on the same K/V gathered into a contiguous cache, and
   runs at the LLaMA-7B attention shape too (32 MHA heads of 128), as do the
   contiguous decode attention and the flash forward (full and ragged
   lengths: SDPA's yardstick then runs under a boolean mask of the
   lengths); the stacked kernels are held
   against their plain versions and against the unstacked kernels on the
   layer's slice;
3. for TinyLlama-1.1B at full width and depth with random weights, at
   W8A8KV8 and at W4A8KV4 (nibble-packed KV cache): one decode step of the
   whole-model decode kernel against its plain version (22 layers and a
   2-layer cut; see ``megakernel_phase``); then ``InferenceEngine`` serves
   8 requests, prompts of 16..1000 tokens, SERVE_NEW greedy new tokens each,
   twice: on the scan path (``use_megakernel=False``) and on the default
   configuration, whose decode steps are one launch of that kernel. Every
   launch count is set to 0 just before each run and read just after, and
   the two runs' greedy tokens are held against each other (see
   ``compare_tokens``). Then ``PagedInferenceEngine`` serves the same 8
   requests from a page pool (pages of 128, 16 a sequence), once with a
   roomy pool (256 pages) and once with a tight one (``TIGHT_PAGES``), which
   must preempt (see ``serve_paged``). Then the same weights, for one short
   prompt, through the GPU paths with their kernels, the GPU path with the
   plain versions and the port's CPU path, contiguous and paged, and the
   paged path against the scan path on a prompt of more than one page (see
   ``cpu_check`` for the limits). Then LLaMA-7B at full width and depth
   (32 layers of 32 MHA heads of 128, random weights made on the card from
   a seed): the decode megakernel against its plain version at W8A8KV8 and
   W4A8KV4, and ``InferenceEngine`` with default flags (every decode step
   one launch of the megakernel, no decode-attention launch) against the
   scan path on the same 8 requests (see ``llama7b_phase``). Then
   LLaMA-3-8B's published widths ((4, 128) heads, vocabulary 128256) cut to
   4 layers: the megakernel against its plain version, and the default,
   scan and paged engines on 8 requests of 16 greedy tokens, held by their
   launch counts and against the scan path (see ``llama3_phase``); then
   OpenLLaMA-3B (``openllama3b_phase``) and, past 8 query heads a kv head,
   Mistral-Large-2's and Llama-3.1-405B's widths cut to 2 layers through the
   default, scan and paged engines (``wide_groups_phase``), and Falcon3-7B
   at full width and depth, head dim 256, on the three paths
   (``falcon3_phase``);
4. holds the four training kernels against their plain versions at the train
   steps' shapes (flash backward dQ and dK/dV and the flash forward at
   B = 16, G = 8, S = 2048, D = 64 and at LLaMA-7B's B = 32, G = 1, S = 2048,
   D = 128, full and ragged lengths, dQ and dK/dV also against their own
   second launches, bit for bit; RMSNorm+quant at [8192, 2048], [4096, 4096]
   and [4096, 5120] and SiLU*up+quant at [8192, 5632] and [4096, 11008],
   equal to their second launches bit for bit, SiLU*up+quant also to its
   plain version), then takes KD-QAT train
   steps of TinyLlama-1.1B W4A8KV4 at full width and depth through
   ``training.trainer.Trainer`` (bf16 params, 4 x 2048 tokens,
   ``kl_chunk=256``, remat on; see ``train_run``), the same at LLaMA-7B's
   widths on a 4-layer cut at 2 x 2048 tokens, steps on a 4-layer
   TinyLlama cut with and without ``fused_silu_quant``, and one step on a
   2-layer cut of each width: the card path with its kernels against the
   card path with the plain versions swapped in, and at TinyLlama's width
   also against the port's CPU path (``train_check``). Each train run prints
   the memory allocated at its entry (after ``gc.collect``) beside its peak;
4i. trains OpenLLaMA-3B at its published widths and full depth (head dim 100
   through the padded builds of K4, K10 and K11): the three kernels at its
   attention shape against their plain versions, 2 + 3 steps through
   ``Trainer``, a 2-layer cut against the plain versions (see
   ``openllama3b_train_phase``);
4b. runs the reference's pipeline through the port's entry points at
   TinyLlama-1.1B's full width and depth: the teacher as an HF checkpoint
   written and read back, synthesis on the card, ``cli.train.run`` (3 steps
   of 2048 tokens, the HF export, eval) and a resume on a 2-layer cut, bit
   for bit (see ``pipeline_phase``);
4c. scores that pipeline's exported student at the same size through the
   port's entry points: ``cli.eval.main`` on eight seeded task files and a
   perplexity file, and with a ``--max_len`` cap of 100 (K4 and K12 launch
   counts checked per forward; the scorer against the plain versions and, on
   a 2-layer cut, the CPU path), beam search at W8A8KV8 and W4A8KV4 on the
   scan path (88 K1/K2 and 22 K3 launches a step; against the plain
   versions; one beam against the engine's greedy tokens) and ``classify``
   on a right-padded batch (see ``eval_phase``);
4d. trains over a mesh of two ranks on the one card (``parallel.launch``
   over gloo, CUDA tensors staged through host memory; NCCL refuses two
   ranks on one card) at TinyLlama-1.1B's full width and depth: FSDP
   (fsdp = 2) and ring context parallelism (cp = 2, the ring's transport in
   bf16 and int8) through ``Trainer(mesh=, parallel=)``, K4/K10/K11's causal
   and non-causal launches counted per step against the ring's schedule and
   every non-causal launch of one step held against its plain version; a
   2-layer f32 cut of each mode against the single-device step; K4/K10/K11
   non-causal at the ring's shape against their plain versions and SDPA;
   one step of the train CLI with NCCL at world 1 (see
   ``multi_device_phase``; the FSDP and CP runs on a 2-layer cut of the
   full width). The two ranks' step times share one card and are no scaling
   figure;
4e. serves tensor-parallel over two ranks on the one card (gloo, as 4d) at
   TinyLlama-1.1B's full width, 6 of its 22 layers (``TP_LAYERS``):
   ``InferenceEngine(mesh=)`` and
   ``PagedInferenceEngine(mesh=)`` at W8A8KV8 and W4A8KV4, every decode
   step's and prefill call's K1/K2, K3/K8 and K4 launches counted (no K9),
   the drift from one device teacher-forced at full depth and the prefill's
   quantizer codes, the tokens against one rank's, a held step (every
   K1/K2/K3/K8/K4 launch against its plain version), 2-layer cuts against
   one device and the CPU path, beam search over TP and the multi-host
   driver as 2 hosts x tp 1 (see ``tp_serving_phase``);
4f. trains tensor- and pipeline-parallel over two ranks (see
   ``tp_pp_train_phase``);
4g. runs ``examples/tiny_pipeline_torch.py`` as a user does (head dim 16,
   two query heads a kv head, f32), launches counted stage by stage, and
   ``examples/accuracy_experiment_torch.py`` at its model's shape (head dim
   32, bf16) for a handful of steps (see ``tiny_pipeline_phase``,
   ``accuracy_phase``); phase 2b holds every kernel instantiation of the
   repo's other head shapes and K tails, and K3/K7/K8 and K9 at every G of
   1..8 query heads a kv head at head dims 64 and 128, against its plain
   version (see ``shapes_phase``);
5. prints what the compiler gave the tensor-core flash kernels, the
   decode megakernel and every K1/K2, K3/K7/K8 and K12/K13 variant
   (registers, shared memory, spills, blocks an SM holds; it fails on a
   spill), the whole run's time, a
   ``{"kernels": [...]}`` line and, last, the ``{"ok": true, "device": ...}``
   line.

Exits non-zero, and prints no result, when there is no GPU or any phase
fails. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
INT8_OPS = 1979e12              # dense int8 tensor-core peak
PROMPT_LENS = (16, 120, 250, 400, 550, 700, 850, 1000)
NEW_TOKENS = 64                     # the decode attention phases' lengths: prompt + NEW_TOKENS / 2
# greedy tokens a request in the TinyLlama-1.1B and LLaMA-7B serving runs (the
# tight pool still preempts: its 120-token prompt crosses into a second page
# at its ninth token)
SERVE_NEW = 32
ATTN_ULPS, ATTN_FLOOR = 2.0, 1e-2   # K3/K4 against their plain versions
CUT_LAYERS, CUT_DRIFT = 2, 1e-3     # GPU vs CPU at the first layers
CUT_FLIP_DRIFT = 0.05               # the cut's logits that see a one-level code flip (hold_flip)
FULL_DRIFT_OVER = 1.5               # full depth: x the plain GPU path's drift
K9_LENS = (48, 0, 282, 432, 512, 732, 882, 1032)   # slot 1 empty, 4 on a block edge
K9_INACTIVE = 2                     # this slot sits the step out
NEAR_TIE_OVER = 4.0                 # see compare_tokens
MEGA_FULL_DRIFT = 0.5               # megakernel vs scan path, full depth (sanity)
MEGA_CUT_DRIFT = 0.15               # megakernel vs scan path, 2-layer cut
PAGE, SEQ_PAGES, ROOMY_PAGES = 128, 16, 256   # paged serving: page size, pages a sequence, pool
TIGHT_PAGES = 33                    # 32 usable pages: the buckets need 40 (see serve_paged)
PAGED_VS_K3_ULPS, PAGED_VS_K3_FLOOR = 4.0, 2e-2   # K8 against K3 on the gathered cache
PAGED_PROMPT = 1000                 # the longest served prompt: 8 pages, so K8 rescales 7 times
LONG_LENS = (8192, 7200, 6100, 5000, 3900, 2800, 1700, 600)   # K3 at S = 8192
STACK_LAYER = 3                     # the layer K5-K7 read in place
F32_FLOPS = 67e12               # fp32 peak outside the tensor cores
TRAIN_BATCH, TRAIN_SEQ, KL_CHUNK = 4, 2048, 256     # the train step's batch
TRAIN_WARM, TRAIN_STEPS = 2, 3                       # warm-up and timed steps
TRAIN_LENS = (2048,) * 10 + (1234, 777, 1, 0, 2048, 1500)   # flash backward phase, B = 16
LLAMA7B_LENS = tuple(1024 - 33 * i for i in range(31)) + (0,)   # K4 at LLaMA-7B heads, B = 32
# flash train phase at LLaMA-7B heads (B = 32 kv heads, G = 1, D = 128)
LLAMA7B_TRAIN_LENS = (2048,) * 16 + tuple(2048 - 97 * i for i in range(1, 15)) + (1, 0)
LLAMA7B_TRAIN_LAYERS, LLAMA7B_TRAIN_BATCH = 4, 2    # the LLaMA-7B-width train run
LLAMA7B_SERVE = ("W8A8KV8",)        # modes served at LLaMA-7B width and depth (K9 phase: both)
LLAMA7B_DRIFT_PROMPT = 40           # teacher-forced megakernel-vs-scan prompt at LLaMA-7B
SILU_LAYERS, SILU_STEPS, SILU_LOSS_REL = 4, 2, 0.05  # the fused_silu_quant run (see train_phases)
TRAIN_CUT_LOSS_REL, TRAIN_CUT_GRAD_REL = 2e-2, 0.25   # train_check: kernels against plain versions
PROFILE_WATCH = ("rmsnorm_quant", "silu_mul_quant")    # K12, K13: their time in each train profile
PIPE_SEED, PIPE_VOCAB, PIPE_LEN = 5, 8, 256   # pipeline: weights' seed, start ids, doc tokens
PIPE_STEPS, PIPE_RESUME_LAYERS, PIPE_RESUME_STEPS = 3, 2, 2   # pipeline train and resume
EVAL_SEED, EVAL_DOCS, EVAL_CHECK_DOCS = 11, 16, 4   # eval: seed; docs a task in the CLI run, in the check
EVAL_CAP, EVAL_CAP_TASKS = 100, ("boolq", "hellaswag")   # the capped run: --max_len (no multiple of 64)
EVAL_PPL_BLOCKS, EVAL_PPL_BLOCK = 8, 1024            # the perplexity file
EVAL_CUT_LAYERS = 2                                  # eval, beam and classify checks: the cut
EVAL_FULL_LOGP, EVAL_CUT_LOGP = 0.25, 0.1           # scorer, kernels vs plain (and CPU): log-prob a token
EVAL_CPU_ROWS, EVAL_CPU_LEN = 16, 128                # scorer: the CPU path's rows and cap (2-layer cut)
SCORER_S = (32, 64, 100, 200)                        # K4 at the scorer's buckets and caps
K12_REPLAY_SEED = 1000                               # K12 at [4096, 5120]: the seeded search's rows
BEAM_NUM, BEAM_NEW, BEAM_PROMPTS = 4, 16, (40, 300)  # beam search: beams, new tokens, prompt lengths
BEAM_SCORE_REL, BEAM_CUT_REL = 0.03, 1e-3           # beam: kernels vs plain, normalized score
CLS_ROWS, CLS_LABELS = 8, 4                          # classify: right-padded rows, labels
CLS_FULL_REL, CLS_CUT_REL = 0.15, 3e-2               # classify: pooled logits, kernels vs plain
SPIN_CYCLES = 2_000_000            # Timer: ~1 ms of device clock between flush and timed call
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def bound(nbytes: float, ops: float, peak: float):
    """(least ms the card could take, "bytes" or "operations")."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    a = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def agreement(got: torch.Tensor, want: torch.Tensor, ulps: float, floor: float) -> dict:
    """Element-wise: |got - want| <= ulps bf16 steps of |want| + floor *
    median|want| (the floor covers outputs near 0, where a bf16 step is
    tiny but the fp32 sums in another order still differ by their own
    rounding). ``worst`` is the largest error over its limit (1 = at it)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    med = float(w.abs().median())
    lim = ulps * bf16_ulp(w) + floor * med
    return dict(ok=bool(torch.isfinite(g).all()) and bool((err <= lim).all()),
                max_abs_err=float(err.max()), worst=float((err / lim).max()),
                median_abs_want=med, rel_l2=float((g - w).norm() / w.norm()))


class Timer:
    """Median of per-run CUDA-event times after warm-up; the 50 MB L2 is
    flushed before each run (the serving step finds weights and cache
    cold), then the device spins for about a millisecond, so that the
    host's enqueue of the timed call is never on the clock (a call of a few
    microseconds read 3-10x long when the host lagged the flush)."""

    def __init__(self, reps: int = 25, warmup: int = 3):
        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 0) -> float:
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(reps or self.reps):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def gemm_phase(timer, gen, QM, c, c7):
    """K1 (W8) and K2 (W4) at the four projections of one layer of
    TinyLlama-1.1B (``c``) and of LLaMA-7B (``c7``): decode rows (8 slots,
    padded to 32) for both, and for W4, which takes K2 at every row count,
    prefill rows: one 1000-token prompt's bucket (1024 rows, both models) and
    the engine's largest group (4 x 1024 = 4096 rows, TinyLlama). Kernel and
    plain version are the exact int32 sum through the same f32 epilogue:
    held bit for bit (``torch.equal``), and a second launch (split-K
    partials meet in a cluster's shared memory) gives the same bits. ``library_ms`` of K1
    is ``torch._int_mm`` on a K-contiguous copy of the weight (the layout
    that library kernel wants; made outside the timing) with the epilogue,
    and ``library_rowmajor_ms`` the same call on the row-major ``[K, N]``
    weight as K1 reads it. K2 has no library call of its function; at
    prefill rows ``int8_library_unpacked_ms`` times ``torch._int_mm`` on the
    unpacked K-contiguous int8 weight (not the same function, but the
    tensor-core rate within reach) and ``library_rowmajor_ms`` the same on
    the row-major unpacked weight, the call W8 prefill makes from 128 rows
    on."""
    one = torch.zeros(1, device="cuda")
    floor_ms = timer(lambda: one.add_(1))
    log(f"  timer floor: one launch of a 1-element kernel {floor_ms:.4f} ms between the events")
    rows = {"int8_matmul": {"TinyLlama-1.1B": [32], "LLaMA-7B": [32]},
            "int4_matmul": {"TinyLlama-1.1B": [32, 1024, 4096], "LLaMA-7B": [32, 1024]}}
    out = {}
    for name, fn, plain in (("int8_matmul", QM.int8_matmul, QM._int8_matmul_plain),
                            ("int4_matmul", QM.int4_matmul, QM._int4_matmul_plain)):
        shapes = []
        for model, cm in (("TinyLlama-1.1B", c), ("LLaMA-7B", c7)):
            H, I, hd = cm.hidden_size, cm.intermediate_size, cm.head_dim
            qkv_n = (cm.num_attention_heads + 2 * cm.kv_heads) * hd
            projs = {"qkv": (H, qkv_n), "o": (H, H), "gateup": (H, 2 * I), "down": (I, H)}
            for M in rows[name][model]:
                for proj, (K, N) in projs.items():
                    shapes.append(gemm_shape(timer, gen, QM, name, fn, plain, model, proj, M,
                                             K, N))
                torch.cuda.empty_cache()
        out[name] = shapes
    out["timer_floor_ms"] = floor_ms
    return out


def gemm_shape(timer, gen, QM, name, fn, plain, model, proj, M, K, N, out_dtype=torch.bfloat16):
    """One K1/K2 shape of ``gemm_phase``: held, timed, its bound. ``out_dtype``:
    bf16, or f32 as a row-parallel chunk under tensor parallelism writes it."""
    x = torch.randn(M, K, device="cuda", generator=gen)
    w = torch.randn(K, N, device="cuda", generator=gen) * 0.02
    xq, sx = QM.quantize_per_token(x)
    if name == "int8_matmul":
        wq, sw = QM.quantize_per_channel(w)
        wbytes, wi = K * N, wq
    else:
        wq, sw = QM.quantize_weights_w4(w)
        wbytes, wi = K * N // 2, QM.unpack_int4(wq)
    del x, w
    od = dict(out_dtype=out_dtype)
    got = fn(xq, wq, sx, sw, **od)
    again = fn(xq, wq, sx, sw, **od)
    want = plain(xq, wq, sx, sw, **od)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(again, got)):
        raise AssertionError(f"{name} {model} {proj} M={M}: not bit-equal to its plain "
                             "version, or a second launch differs")
    ms = timer(lambda: fn(xq, wq, sx, sw, **od))
    plain_ms = timer(lambda: plain(xq, wq, sx, sw, **od))
    wt = wi.t().contiguous().t()   # K-contiguous [K, N]
    lib_ms = lib_row_ms = unpacked_ms = None

    def epi(acc):
        return (acc.float() * (1.0 / ((sx + 1e-6) * (sw + 1e-6)))).to(out_dtype)

    if name == "int8_matmul":
        lib_ms = timer(lambda: epi(torch._int_mm(xq, wt)))
        lib_row_ms = timer(lambda: epi(torch._int_mm(xq, wq)))
    elif M >= QM.XLA_INT8_MIN_ROWS:   # and on the row-major weight, as W8 prefill calls it
        unpacked_ms = timer(lambda: epi(torch._int_mm(xq, wt)))
        lib_row_ms = timer(lambda: epi(torch._int_mm(xq, wi)))
    plan = QM.gemm_plan(M, N, K, name == "int4_matmul",
                        torch.cuda.get_device_properties(0).multi_processor_count)
    out_bytes = M * N * torch.finfo(out_dtype).bits // 8
    b_ms, b_by = bound(M * K + wbytes + 4 * (M + N) + out_bytes, 2.0 * M * K * N, INT8_OPS)
    log(f"  {name} {model} {proj:6s} M={M:4d} K={K} N={N} {str(out_dtype)[6:]} ({plan['variant']}, "
        f"{plan['splits']} split): {ms:.4f} ms (plain {plain_ms:.4f}, library {lib_ms} "
        f"K-contiguous / {lib_row_ms} row-major, int8 library on the unpacked K-contiguous "
        f"weight {unpacked_ms}, bound {b_ms:.4f} {b_by}) bit-equal, twice")
    return dict(model=model, proj=proj, M=M, K=K, N=N, out_dtype=str(out_dtype)[6:],
                variant=plan["variant"],
                splits=plan["splits"], ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_rowmajor_ms=lib_row_ms, int8_library_unpacked_ms=unpacked_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0)


def decode_attention_phase(timer, gen, DA, kvh, G, hd, packed, S=2048, lens_l=None,
                           plain_reps=0):
    """K3 at the decode shape: b=8 slots, S=2048, TinyLlama-1.1B's heads
    (kvh=4, G=8, hd=64) or LLaMA-7B's (kvh=32, G=1, hd=128), slot
    lengths those of the served prompts after half the new tokens (or
    ``lens_l``, with a longer ``S``); the folded pair in the cache's range
    (-8..7 at KV4), as the main path quantizes it. Kernel and plain version
    walk the JAX picker's bk-column blocks (1024 at TinyLlama's heads, 256 at
    LLaMA-7B's: the lengths 48..1032 cross it), round to bf16 at the same
    points against the same running maximum, and take their sums in
    float64: held element-wise to ATTN_ULPS bf16 steps plus ATTN_FLOOR of
    the median output (``agreement``); the same bits on a second launch.
    ``plain_reps``: the plain version's timed runs (the Timer's default
    unless given; a block of 8 columns makes it slow, see PAD_DECODE)."""
    b = 8
    hdc = hd // 2 if packed else hd
    if packed:
        kq = torch.randint(0, 256, (b, kvh, hdc, S), device="cuda", generator=gen).to(torch.uint8)
        vq = torch.randint(0, 256, (b, kvh, hdc, S), device="cuda", generator=gen).to(torch.uint8)
    else:
        kq = torch.randint(-127, 128, (b, kvh, hdc, S), device="cuda", generator=gen).to(torch.int8)
        vq = torch.randint(-127, 128, (b, kvh, hdc, S), device="cuda", generator=gen).to(torch.int8)
    ks = torch.rand(b, S, device="cuda", generator=gen) * 0.02 + 0.005
    vs = torch.rand(b, S, device="cuda", generator=gen) * 0.02 + 0.005
    q = torch.randn(b, kvh * G, hd, device="cuda", generator=gen).to(torch.bfloat16)
    lens_l = list(lens_l or [n + NEW_TOKENS // 2 for n in PROMPT_LENS])
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    kc, ksn = DA._rope_tables(S, hd, 10000.0, "cuda")
    lo, hi = (-8, 8) if packed else (-127, 128)
    kn = torch.randint(lo, hi, (b, kvh, hd), device="cuda", generator=gen).to(torch.int8)
    vn = torch.randint(lo, hi, (b, kvh, hd), device="cuda", generator=gen).to(torch.int8)
    ki = torch.rand(b, 1, device="cuda", generator=gen) * 0.02 + 0.005
    vi = torch.rand(b, 1, device="cuda", generator=gen) * 0.02 + 0.005
    act = torch.ones(b, dtype=torch.int32, device="cuda")
    fold = (kn, ki, vn, vi, act, kc[:, :b].T.contiguous(), ksn[:, :b].T.contiguous())
    args = (q, kq, ks, vq, vs, lens, kc, ksn, fold)
    kw = dict(rope=True, packed=packed)
    got = DA.quantized_decode_attention(*args, **kw)
    again = DA.quantized_decode_attention(*args, **kw)
    want = DA._decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    agr = agreement(got, want, ATTN_ULPS, ATTN_FLOOR)
    if not (agr["ok"] and torch.equal(got, again)):
        raise AssertionError(f"decode attention kvh={kvh} G={G} hd={hd} packed={packed} S={S}: "
                             f"{agr}, same bits twice: {torch.equal(got, again)}")
    bk, ch = DA._kernel_chunk(S, kvh, hd, 1024)
    items, grid = attn_grid(DA, G, hd, kvh, lens_l, ch, S // ch)
    ms = timer(lambda: DA.quantized_decode_attention(*args, **kw))
    plain_ms = timer(lambda: DA._decode_attention_plain(*args, **kw), reps=plain_reps)
    tot = sum(lens_l)
    nbytes = (2 * kvh * hdc * tot + 2 * 4 * tot          # K/V ints, scales
              + 2 * 4 * (hd // 2) * max(lens_l)          # RoPE tables
              + 2 * 2 * b * kvh * G * hd                 # q, out (bf16)
              + 2 * b * kvh * hd + 8 * b)                # folded pair
    ops = 2 * 2 * kvh * G * hd * (tot + b)               # q.k and p.v
    b_ms, b_by = bound(nbytes, ops, BF16_FLOPS)
    log(f"  decode_attention kvh={kvh} G={G} hd={hd} packed={packed} b={b} S={S} lens={lens_l}: "
        f"{ms:.4f} ms "
        f"(plain {plain_ms:.4f}, bound {b_ms:.5f} {b_by}) bk {bk}, {items} items of {ch} "
        f"columns on {grid} resident blocks; max_abs_err "
        f"{agr['max_abs_err']:.3g}, worst {agr['worst']:.3g} of its limit, "
        f"rel L2 {agr['rel_l2']:.3g}")
    return dict(kvh=kvh, G=G, hd=hd, packed=packed, b=b, S=S, lengths=lens_l, bk=bk,
                items=items, grid=grid, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by, **agr)


def attn_grid(DA, G, hd, kvh, lens_l, ch, n_chunks):
    """(items, blocks) of a decode attention launch (csrc/decode_attn.cuh):
    the live chunks of ``ch`` columns times the kv heads, and the resident
    blocks of the cooperative launch, at most one an item the cache could
    give."""
    from llm_qat_torch.ops import _build

    items = sum(-(-min(n, n_chunks * ch) // ch) for n in lens_l) * kvh
    per_sm = _build.attributes(DA._stem(hd), "decode_attention_attributes", 1, G,
                               hd)["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return items, min(sms * per_sm, max(len(lens_l) * kvh * n_chunks, 1))


def ragged_sdpa_inputs(k, v, lens_l, G):
    """K and V ``[B, S, D]`` expanded to the G query heads, and the boolean
    mask ``[B, 1, S, S]`` under which ``scaled_dot_product_attention``
    computes what a flash kernel computes at the lengths ``lens_l``: query row
    i of sequence b sees key j when j <= i and j < max(length, 1)
    (``live_pairs``). SDPA takes no lengths; its memory-efficient backend
    takes the mask, and K/V of every query head."""
    B, S, D = k.shape
    j = torch.arange(S, device="cuda")
    lens = torch.tensor([max(n, 1) for n in lens_l], device="cuda")
    mask = (j[None, :] <= j[:, None])[None, None] & (j < lens[:, None, None, None])
    kx, vx = (t[:, None].expand(B, G, S, D).contiguous() for t in (k, v))
    return kx, vx, mask


def flash_phase(timer, gen, FA, B, G, S, D, lens_l=None, dtype=torch.bfloat16):
    """K4 at a prefill shape: B = prompts x kv heads, G query heads a kv
    head, causal, bf16 (or ``dtype``), full lengths unless ``lens_l``.
    Kernel and plain version walk the TPU kernel's key blocks
    (``_fit_block(1024, S)``: one block up to 1024, two of 768 at S = 1536,
    fifteen of 120 at S = 1800), take p against the same running maxima,
    from the same tensor-core q.k, and round it to bf16 alike; they differ
    in their fp32 summation orders: held element-wise as K3 is, and the LSE
    to 1e-3 (f32: ``f32_agreement``, the LSE to 1e-5). SDPA is the
    yardstick: causal at full lengths, under the lengths' boolean mask
    otherwise (``ragged_sdpa_inputs``)."""
    q = torch.randn(B, G, S, D, device="cuda", generator=gen).to(dtype)
    k = torch.randn(B, S, D, device="cuda", generator=gen).to(dtype)
    v = torch.randn(B, S, D, device="cuda", generator=gen).to(dtype)
    full = lens_l is None
    lens_l = [S] * B if full else list(lens_l)
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    o, lse = FA._flash_fwd(q, k, v, lens)
    o2, lse2 = FA._flash_fwd_plain(q, k, v, lens)
    torch.cuda.synchronize()
    bf = dtype == torch.bfloat16
    agr = agreement(o, o2, ATTN_ULPS, ATTN_FLOOR) if bf else f32_agreement(o, o2)
    lse_err = float((lse - lse2).abs().max())
    if not (agr["ok"] and lse_err <= (1e-3 if bf else 1e-5)):
        raise AssertionError(f"flash B={B} G={G} S={S} D={D} {dtype} lens={lens_l}: {agr}, "
                             f"lse {lse_err}")
    ms = timer(lambda: FA._flash_fwd(q, k, v, lens))
    plain_ms = timer(lambda: FA._flash_fwd_plain(q, k, v, lens))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if full:
        qh, kh, vh = q.reshape(1, B * G, S, D), k[None], v[None]
        lib_ms = timer(lambda: sdpa(qh, kh, vh, is_causal=True, enable_gqa=True))
    else:
        kx, vx, mask = ragged_sdpa_inputs(k, v, lens_l, G)
        lib_ms = timer(lambda: sdpa(q, kx, vx, attn_mask=mask))
        del kx, vx, mask
    nbytes = (2 if bf else 4) * (2 * B * G * S * D + 2 * B * S * D) + 4 * B * G * S
    ops = 2 * 2 * G * D * live_pairs(lens_l, S)
    b_ms, b_by = bound(nbytes, ops, BF16_FLOPS if bf else F32_FLOPS)
    log(f"  flash_fwd B={B} G={G} S={S} D={D} {str(dtype)[6:]} "
        f"{'full' if full else 'ragged'} lengths: {ms:.4f} ms "
        f"(plain {plain_ms:.4f}, sdpa {lib_ms}, bound {b_ms:.5f} {b_by}) max_abs_err "
        f"{agr['max_abs_err']:.3g}, worst {agr['worst']:.3g} of its limit, rel L2 {agr['rel_l2']:.3g}, "
        f"lse {lse_err:.3g}")
    return dict(B=B, G=G, S=S, D=D, dtype=str(dtype)[6:], lengths="full" if full else lens_l,
                blocks=-(-S // 64) * G * B,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                lse_err=lse_err, **agr)


def paged_attention_phase(timer, gen, DA, kvh, G, hd, packed):
    """K8 at the paged decode shape: b = 8 slots, a pool of 256 pages of 128,
    16 pages a sequence, lengths K9_LENS (an empty slot, one on a page edge),
    slot K9_INACTIVE inactive, fold on, bf16; block tables shuffled and
    non-contiguous, their unused entries pointing outside the pool. Held
    element-wise against the plain version under the K3/K4 limit (both walk
    the pages in order and round p*vs against the running maximum; the same
    bits on a second launch), and, as a second witness that shares no
    indirection with it, against the contiguous decode attention K3 on the
    same K/V gathered into a contiguous cache: that one walks the JAX
    picker's blocks (1024 columns at TinyLlama's heads, 256 at LLaMA-7B's)
    where K8 walks pages of 128, so the two differ by where p*vs is rounded,
    held to PAGED_VS_K3_ULPS bf16 steps + PAGED_VS_K3_FLOOR of the median."""
    b, n_pages, max_pages = len(K9_LENS), ROOMY_PAGES, SEQ_PAGES
    hdc = hd // 2 if packed else hd
    lo, hi, qdt = (0, 256, torch.uint8) if packed else (-127, 128, torch.int8)

    def ints():
        return torch.randint(lo, hi, (n_pages, kvh, hdc, PAGE), device="cuda",
                             generator=gen).to(qdt)

    def scales():
        return torch.rand(n_pages, PAGE, device="cuda", generator=gen) * 0.02 + 0.005

    kq, ks, vq, vs = ints(), scales(), ints(), scales()
    ids = torch.randperm(n_pages - 1, device="cuda", generator=gen).cpu()
    bt = torch.full((b, max_pages), 10 ** 6, dtype=torch.int32)
    safe = torch.zeros((b, max_pages), dtype=torch.int64)
    at = 0
    for i, n in enumerate(K9_LENS):
        live = -(-n // PAGE)
        bt[i, :live] = ids[at:at + live].to(torch.int32)
        safe[i, :live] = ids[at:at + live]
        at += live + 1                                  # leave holes: non-contiguous
    bt, safe = bt.cuda(), safe.cuda()
    q = torch.randn(b, kvh * G, hd, device="cuda", generator=gen).to(torch.bfloat16)
    lens = torch.tensor(K9_LENS, dtype=torch.int32, device="cuda")
    kc, ksn = DA._rope_tables(max_pages * PAGE, hd, 10000.0, "cuda")
    flo, fhi = (-8, 8) if packed else (-127, 128)
    kn = torch.randint(flo, fhi, (b, kvh, hd), device="cuda", generator=gen).to(torch.int8)
    vn = torch.randint(flo, fhi, (b, kvh, hd), device="cuda", generator=gen).to(torch.int8)
    ki = torch.rand(b, 1, device="cuda", generator=gen) * 0.02 + 0.005
    vi = torch.rand(b, 1, device="cuda", generator=gen) * 0.02 + 0.005
    act = torch.tensor([int(i != K9_INACTIVE) for i in range(b)], dtype=torch.int32,
                       device="cuda")
    pos = lens.long()
    fold = (kn, ki, vn, vi, act, kc[:, pos].T.contiguous(), ksn[:, pos].T.contiguous())
    args = (q, kq, ks, vq, vs, lens, bt, kc, ksn, fold)
    kw = dict(rope=True, packed=packed)
    got = DA.quantized_paged_attention(*args, **kw)
    again = DA.quantized_paged_attention(*args, **kw)
    want = DA._paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    agr = agreement(got, want, ATTN_ULPS, ATTN_FLOOR)
    if not (agr["ok"] and torch.equal(got, again)):
        raise AssertionError(f"paged attention G={G} hd={hd} packed={packed}: {agr}, same bits "
                             f"twice: {torch.equal(got, again)}")
    items, grid = attn_grid(DA, G, hd, kvh, K9_LENS, PAGE, max_pages)
    # the same K/V as a contiguous cache [b, kvh, hd(/2), max_pages * P]
    ck = kq[safe].permute(0, 2, 3, 1, 4).reshape(b, kvh, hdc, -1).contiguous()
    cv = vq[safe].permute(0, 2, 3, 1, 4).reshape(b, kvh, hdc, -1).contiguous()
    cks, cvs = ks[safe].reshape(b, -1).contiguous(), vs[safe].reshape(b, -1).contiguous()
    flat = DA.quantized_decode_attention(q, ck, cks, cv, cvs, lens, kc, ksn, fold, **kw)
    torch.cuda.synchronize()
    k3 = agreement(got, flat, PAGED_VS_K3_ULPS, PAGED_VS_K3_FLOOR)
    if not k3["ok"]:
        raise AssertionError(f"paged attention against the contiguous one on the gathered "
                             f"cache, G={G} hd={hd} packed={packed}: {k3}")
    ms = timer(lambda: DA.quantized_paged_attention(*args, **kw))
    plain_ms = timer(lambda: DA._paged_attention_plain(*args, **kw))
    live_cols = sum(-(-n // PAGE) * PAGE for n in K9_LENS)      # whole live pages
    tot = sum(K9_LENS)
    nbytes = (2 * kvh * hdc * tot + 2 * 4 * tot           # live K/V columns, scales
              + 2 * 4 * (hd // 2) * max(K9_LENS)          # RoPE table columns
              + 4 * sum(-(-n // PAGE) for n in K9_LENS) + 4 * b   # live table entries, lengths
              + 2 * 2 * b * kvh * G * hd                  # q, out (bf16)
              + 2 * b * kvh * hd + 8 * b + 4 * b + 2 * 4 * b * (hd // 2))   # folded pair
    ops = 2 * 2 * kvh * G * hd * (tot + b)                # q.k and p.v
    b_ms, b_by = bound(nbytes, ops, BF16_FLOPS)
    log(f"  paged_attention kvh={kvh} G={G} hd={hd} packed={packed} b={b} pool {n_pages} x "
        f"{PAGE} lens={list(K9_LENS)}: {ms:.4f} ms (plain {plain_ms:.4f}, bound {b_ms:.5f} "
        f"{b_by}) {items} items on {grid} resident blocks; max_abs_err {agr['max_abs_err']:.3g}, "
        f"worst {agr['worst']:.3g} of its limit; against K3 on "
        f"the gathered cache: max_abs_err {k3['max_abs_err']:.3g}, worst {k3['worst']:.3g} of "
        f"its limit ({PAGED_VS_K3_ULPS} bf16 steps + {PAGED_VS_K3_FLOOR} x median)")
    return dict(kvh=kvh, G=G, hd=hd, packed=packed, b=b, n_pages=n_pages, page=PAGE,
                max_pages=max_pages, lengths=list(K9_LENS), live_columns=live_cols,
                items=items, grid=grid, ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                against_contiguous=k3, **agr)


def stacked_gemm_phase(timer, gen, QM, qparams, w4):
    """K5 (W8) or K6 (W4) at layer STACK_LAYER of the served model's stacked
    weights, the four projections at decode rows (M = 32), read in place:
    bit-equal to the plain version and to the unstacked kernel (K1/K2) on
    that layer's slice."""
    name = "int4_matmul_stacked" if w4 else "int8_matmul_stacked"
    fn = getattr(QM, name)
    flat = QM.int4_matmul if w4 else QM.int8_matmul
    plain = QM._int4_matmul_plain if w4 else QM._int8_matmul_plain
    M, l = 32, STACK_LAYER
    shapes = []
    before = fn.launches
    for proj in ("qkv", "o", "gateup", "down"):
        w_all, sw_all = qparams["layers"][proj]["q"], qparams["layers"][proj]["s"]
        K, N = (2 if w4 else 1) * w_all.shape[1], w_all.shape[2]
        xq, sx = QM.quantize_per_token(torch.randn(M, K, device="cuda", generator=gen))
        got = fn(xq, w_all, sx, sw_all, layer=l)
        want = plain(xq, w_all[l], sx, sw_all[l])
        same = flat(xq, w_all[l], sx, sw_all[l])
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, same)):
            raise AssertionError(f"{name} {proj}: not bit-equal to its plain version and "
                                 "to the unstacked kernel")
        ms = timer(lambda: fn(xq, w_all, sx, sw_all, layer=l))
        plain_ms = timer(lambda: plain(xq, w_all[l], sx, sw_all[l]))
        lib_ms = lib_row_ms = None
        if not w4:   # as gemm_phase: K-contiguous copy, and the weight as K5 reads it
            def epi(acc):
                return (acc.float() * (1.0 / ((sx + 1e-6) * (sw_all[l] + 1e-6)))
                        ).to(torch.bfloat16)

            wt = w_all[l].t().contiguous().t()
            lib_ms = timer(lambda: epi(torch._int_mm(xq, wt)))
            lib_row_ms = timer(lambda: epi(torch._int_mm(xq, w_all[l])))
        b_ms, b_by = bound(M * K + w_all[l].numel() + 4 * (M + N) + 2 * M * N,
                           2.0 * M * K * N, INT8_OPS)
        shapes.append(dict(proj=proj, M=M, K=K, N=N, layer=l, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, library_rowmajor_ms=lib_row_ms, bound_ms=b_ms,
                           bound_by=b_by, max_abs_err=0.0))
        log(f"  {name} {proj:6s} layer {l} of {w_all.shape[0]} M={M} K={K} N={N}: {ms:.4f} ms "
            f"(plain {plain_ms:.4f}, library {lib_ms} K-contiguous / {lib_row_ms} row-major, "
            f"bound {b_ms:.4f} {b_by}) bit-equal to plain and unstacked")
    return dict(shapes=shapes, launches=fn.launches - before)


def stacked_attention_phase(timer, gen, DA, c, plain_reps=0):
    """K7 at the K3 phase's shape on layer STACK_LAYER - 1 of a 3-layer
    stacked int8 cache: b = 8, S = 2048, the lengths of the K3 phase with
    slot 1 empty, slot K9_INACTIVE's pair excluded; the pair arrives as bf16
    fake-quantized values. Held against its plain version as K3 is."""
    L, l = 3, STACK_LAYER - 1
    cache = random_cache(c.replace(num_hidden_layers=L, kv_bits=8, kv_cache_pack=False),
                         8, 2048, gen)
    b, kvh, G, hd = 8, c.kv_heads, c.num_attention_heads // c.kv_heads, c.head_dim
    q = torch.randn(b, kvh * G, hd, device="cuda", generator=gen).to(torch.bfloat16)
    lens_l = [n + NEW_TOKENS // 2 for n in PROMPT_LENS]
    lens_l[1] = 0
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    inc = torch.tensor([int(i != K9_INACTIVE) for i in range(b)], dtype=torch.int32,
                       device="cuda")
    kn = (torch.randn(b, kvh, hd, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
    vn = (torch.randn(b, kvh, hd, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
    kc, ksn = DA._rope_tables(2048, hd, c.rope_theta, "cuda")
    args = (q, cache["k_q"], cache["k_s"], cache["v_q"], cache["v_s"], lens, inc, kn, vn,
            kc, ksn)
    before = DA.quantized_decode_attention_stacked.launches
    got = DA.quantized_decode_attention_stacked(*args, layer=l)
    want = DA._decode_attention_stacked_plain(*args, layer=l)
    torch.cuda.synchronize()
    agr = agreement(got, want, ATTN_ULPS, ATTN_FLOOR)
    if not agr["ok"]:
        raise AssertionError(f"stacked decode attention: {agr}")
    ms = timer(lambda: DA.quantized_decode_attention_stacked(*args, layer=l))
    plain_ms = timer(lambda: DA._decode_attention_stacked_plain(*args, layer=l), reps=plain_reps)
    tot = sum(lens_l)
    nbytes = (2 * kvh * hd * tot + 2 * 4 * tot + 2 * 4 * (hd // 2) * max(lens_l)
              + 2 * 2 * b * kvh * G * hd + 2 * 2 * b * kvh * hd + 8 * b)
    b_ms, b_by = bound(nbytes, 2 * 2 * kvh * G * hd * (tot + b), BF16_FLOPS)
    log(f"  decode_attention_stacked layer {l} of {L} b={b} S=2048 lens={lens_l}: {ms:.4f} ms "
        f"(plain {plain_ms:.4f}, bound {b_ms:.5f} {b_by}) max_abs_err {agr['max_abs_err']:.3g}, "
        f"worst {agr['worst']:.3g} of its limit")
    return dict(layer=l, layers=L, b=b, S=2048, lengths=lens_l, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                launches=DA.quantized_decode_attention_stacked.launches - before, **agr)


def cut_layers(qparams, n):
    """The first ``n`` layers of stacked serving params (views)."""
    return dict(qparams, layers={k: ({kk: vv[:n] for kk, vv in v.items()}
                                     if isinstance(v, dict) else v[:n])
                                 for k, v in qparams["layers"].items()})


def random_cache(cfg, b, S, gen):
    """A serving cache of random integers and inverse scales (the K3 phase's
    distribution) for every layer of ``cfg``."""
    from llm_qat_torch.inference import model as M

    packed = M.cache_is_packed(cfg)
    shape = (cfg.num_hidden_layers, b, cfg.kv_heads,
             cfg.head_dim // 2 if packed else cfg.head_dim, S)

    def ints():
        if packed:
            return torch.randint(0, 256, shape, device="cuda", generator=gen).to(torch.uint8)
        return torch.randint(-127, 128, shape, device="cuda", generator=gen).to(torch.int8)

    def scales():
        return torch.rand(shape[0], b, S, device="cuda", generator=gen) * 0.02 + 0.005

    return {"k_q": ints(), "k_s": scales(), "v_q": ints(), "v_s": scales()}


def megakernel_step_check(cfg, qparams, lens, active, gen, dtype=torch.bfloat16, S=2048):
    """One decode step through the kernel and through its plain version from
    the same random cache: committed K/V integers equal, inverse scales at
    rtol 1e-6, final hidden and logits element-wise within ATTN_ULPS bf16
    steps + ATTN_FLOOR of the median (``agreement``; both versions take
    every rounded sum in float64, so they are expected to be equal)."""
    from llm_qat_torch.inference import megakernel as MK

    b = len(lens)
    cache = random_cache(cfg, b, S, gen)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    act = torch.tensor(active, device="cuda")
    ids = torch.randint(0, cfg.vocab_size, (b, 1), device="cuda", generator=gen)
    out = []
    for fn in (MK.decode_layers, MK.decode_layers_plain):
        c = {k: v.clone() for k, v in cache.items()}
        lg, c, y = MK._step(qparams, cfg, ids, lens_t, act, c, dtype, fn)
        torch.cuda.synchronize()
        out.append((lg, c, y))
    (lg, c, y), (lg2, c2, y2) = out
    ints = all(torch.equal(c[k], c2[k]) for k in ("k_q", "v_q", "lengths"))
    scales = all(torch.allclose(c[k], c2[k], rtol=1e-6, atol=0) for k in ("k_s", "v_s"))
    hid, lgt = (agreement(a, w, ATTN_ULPS, ATTN_FLOOR) for a, w in ((y, y2), (lg, lg2)))
    res = dict(layers=cfg.num_hidden_layers, ints_equal=ints, scales_close=scales,
               hidden=hid, logits=lgt, bit_equal=torch.equal(y, y2) and torch.equal(lg, lg2),
               max_abs_err=max(hid["max_abs_err"], lgt["max_abs_err"]))
    res["ok"] = ints and scales and hid["ok"] and lgt["ok"]
    return res, (cache, lens_t, act, ids)


def megakernel_phase(timer, label, cfg, qparams, gen, lens=K9_LENS):
    """K9 at the full width and depth of ``cfg`` (TinyLlama-1.1B, 22 layers;
    LLaMA-7B, 32): b = 8, max_len 2048, lengths K9_LENS (an empty active
    slot, one on a block edge, one inactive; or ``lens``, b = len(lens),
    slot K9_INACTIVE inactive where there is one), at full depth and at a
    CUT_LAYERS cut, kernel against plain version, and the kernel against its
    own second launch (the same bits); then the kernel's and the plain
    version's time at full depth, the time between the kernel's grid
    barriers by stage, and the cost of its barriers alone."""
    from llm_qat_torch.inference import megakernel as MK

    b, S, L = len(lens), 2048, cfg.num_hidden_layers
    if not MK.supported(cfg, b, S):
        raise AssertionError(f"{label}: megakernel.supported() is false for b={b}, S={S}")
    active = [i != K9_INACTIVE for i in range(b)]
    cut = None                         # a model of CUT_LAYERS layers is its own cut
    if L > CUT_LAYERS:
        cut, _ = megakernel_step_check(cfg.replace(num_hidden_layers=CUT_LAYERS),
                                       cut_layers(qparams, CUT_LAYERS), lens, active, gen)
    full, (cache, lens_t, act, ids) = megakernel_step_check(cfg, qparams, lens, active, gen)
    cut = cut or full
    for r in ((cut, full) if cut is not full else (full,)):
        log(f"  decode_megakernel {label} {r['layers']} layers: K/V integers equal "
            f"{r['ints_equal']}, scales within 1e-6 {r['scales_close']}, hidden max_abs_err "
            f"{r['hidden']['max_abs_err']:.3g}, logits max_abs_err {r['logits']['max_abs_err']:.3g} "
            f"(worst {r['logits']['worst']:.3g} of its limit), bit-equal {r['bit_equal']}")
        if not r["ok"]:
            raise AssertionError(f"decode_megakernel {label}: {r}")

    args = k9_args(cfg, qparams, cache, lens_t, act, ids, S)
    bk = args[10]
    card = MK.card_weights(qparams)
    once, twice = (MK.decode_layers(*args, card=card) for _ in range(2))
    same_twice = all(torch.equal(a, w) for a, w in zip(once, twice))
    ms = timer(lambda: MK.decode_layers(*args, card=card))
    plain_ms = timer(lambda: MK.decode_layers_plain(*args), reps=5)
    ns = len(MK.STAGES)                # barriers a layer (and one before the first)
    stamps = torch.zeros(MK.n_stamps(L), dtype=torch.int64, device="cuda")
    arrive = torch.zeros((MK.n_stamps(L) - 1, MK.grid_size()), dtype=torch.int64, device="cuda")
    MK.decode_layers(*args, stamps=stamps, card=card, arrive=arrive)
    torch.cuda.synchronize()
    gaps = (stamps[2:] - stamps[1:-1]).reshape(L, ns).double().sum(0) / 1e6     # ms by stage
    stages = {"resid0": float(stamps[1] - stamps[0]) / 1e6}
    stages.update({f"{i}:{n}": float(g) for i, (n, g) in enumerate(zip(MK.STAGES, gaps))})
    # each block's work in a stage: from the barrier before it (block 0's clock
    # leaving it) to the block's arrival at the next one
    work = (arrive[1:] - stamps[1:-1, None]).double().reshape(L, ns, -1) / 1e6
    busy = {f"{i}:{n}": dict(median=float(work[:, i].median(dim=1).values.sum()),
                             max=float(work[:, i].max(dim=1).values.sum()))
            for i, n in enumerate(MK.STAGES)}

    def barriers(n):
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        MK.grid_barriers(n)
        e.record()
        torch.cuda.synchronize()
        return a.elapsed_time(e)

    barriers(10)
    barrier_us = (barriers(2000) - barriers(0)) / 2000 * 1e3

    b_ms, b_by, nbytes = megakernel_bound(cfg, qparams, lens, cache["k_q"].shape[3])
    grid = torch.cuda.get_device_properties(0).multi_processor_count   # a block per SM
    log(f"  decode_megakernel {label} b={b} S={S} BK={bk} lens={list(lens)} grid "
        f"{grid} blocks: {ms:.4f} ms (plain {plain_ms:.3f}, bound {b_ms:.4f} {b_by}, "
        f"{nbytes / 1e9:.4f} GB); {ns * L + 1} barriers x {barrier_us:.3f} us = "
        f"{(ns * L + 1) * barrier_us / 1e3:.4f} ms; ms between barriers by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; the same bits twice {same_twice}; blocks busy by stage (median / slowest): "
        + ", ".join(f"{k} {v['median']:.3f} / {v['max']:.3f}" for k, v in busy.items()))
    if not same_twice:
        raise AssertionError(f"decode_megakernel {label}: two launches differ")
    return dict(mode=label, b=b, S=S, BK=bk, lengths=list(lens), grid=grid, ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, barrier_us=barrier_us, barriers=ns * L + 1, stage_ms=stages,
                stage_busy_ms=busy,
                max_abs_err=max(cut["max_abs_err"], full["max_abs_err"]),
                bit_equal=cut["bit_equal"] and full["bit_equal"], same_bits_twice=same_twice,
                layers=L, cut=cut, full=full)


def megakernel_bound(cfg, qparams, lens, hdc):
    """(least ms, "bytes" or "operations", bytes) of one K9 step: every
    stacked weight, scale and gain, the live cache columns (``hdc`` bytes of
    head dim a column) with their scales, the RoPE tables up to the longest
    slot, x, y and the new columns, each moved once; operations: the int8
    products and the attention's q.k and p.V."""
    lay = qparams["layers"]
    L, b, hd = cfg.num_hidden_layers, len(lens), cfg.head_dim
    wbytes = sum(lay[k]["q"].numel() * lay[k]["q"].element_size() + 4 * lay[k]["s"].numel()
                 for k in ("qkv", "o", "gateup", "down"))
    kv_dim, tot = cfg.kv_heads * hd, sum(lens)
    nbytes = (wbytes + 2 * 2 * L * cfg.hidden_size
              + L * (2 * cfg.kv_heads * hdc * tot + 2 * 4 * tot)
              + 2 * 4 * (hd // 2) * max(lens) + 2 * 2 * b * cfg.hidden_size
              + L * b * (2 * kv_dim + 8))
    mac = cfg.hidden_size * (cfg.hidden_size + 2 * kv_dim + cfg.hidden_size
                             + 2 * cfg.intermediate_size) + cfg.intermediate_size * cfg.hidden_size
    int_ops = 2.0 * b * mac * L
    attn_ops = 2.0 * 2 * cfg.num_attention_heads * hd * (tot + b) * L
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int_ops / INT8_OPS + attn_ops / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes


def llama7b_phase(timer, gen, cfg7, prompts):
    """LLaMA-7B at full width and depth (32 layers, random weights from a
    seed, made on the card and freed once quantized), (G, hd) = (1, 128):
    the K9 phase at W8A8KV8 and W4A8KV4; for the modes in LLAMA7B_SERVE,
    ``InferenceEngine`` with default flags (decode through K9) and on the
    scan path (``use_megakernel=False``, the witness) serving the 8 prompts,
    and one prompt teacher-forced through both paths: greedy tokens and
    logit drift (held to MEGA_FULL_DRIFT; the paths differ by design), which
    also sets the near-tie limit of ``compare_tokens`` for the served
    tokens."""
    from llm_qat_torch.inference import quantized as Q
    from llm_qat_torch.models import params as P

    out = dict(kernel=[], runs=[], flips={}, teacher_forced={})
    modes = {"W8A8KV8": dict(w_bits=8, a_bits=8, kv_bits=8),
             "W4A8KV4": dict(w_bits=4, a_bits=8, kv_bits=4, kv_cache_pack=True)}
    for label, mode in modes.items():
        cfg = cfg7.replace(**mode)
        params = P.init_params(cfg, seed=0, dtype=torch.bfloat16)
        qp = Q.quantize_params(params, cfg)
        del params
        torch.cuda.empty_cache()
        out["kernel"].append(megakernel_phase(timer, f"{label} LLaMA-7B", cfg, qp, gen))
        if label in LLAMA7B_SERVE:
            name = f"{label} LLaMA-7B"
            dflt = serve(f"{name} megakernel", cfg, qp, prompts)
            scan = serve(f"{name} scan", cfg.replace(use_megakernel=False), qp, prompts)
            toks = []
            prompt = prompts[-1][:LLAMA7B_DRIFT_PROMPT]
            mega = _greedy_logits(cfg, qp, prompt, "cuda", toks)
            wit = _greedy_logits(cfg.replace(use_megakernel=False), qp, prompt, "cuda", toks)
            same, drift, diff = _compare(mega, wit)
            log(f"  {name}: megakernel against scan path teacher-forced on a "
                f"{len(prompt)}-token prompt: tokens equal {same}, drift {drift:.4g} "
                f"(limit {MEGA_FULL_DRIFT}), largest logit difference {diff:.4g}")
            if drift > MEGA_FULL_DRIFT:
                raise AssertionError(f"{name}: megakernel drifts {drift} from the scan path")
            out["teacher_forced"][label] = dict(tokens_equal=same, drift=drift, max_abs=diff)
            out["flips"][label] = compare_tokens(name, scan, dflt, diff)
            out["runs"] += [dflt[0], scan[0]]
        del qp
        torch.cuda.empty_cache()
    return out


# Meta-Llama-3-8B's published config.json widths (32 query heads and 8 kv
# heads of 128, the vocabulary of 128256, rope_theta 500000), its 32 layers
# cut to LLAMA3_LAYERS; random weights from LLAMA3_SEED
LLAMA3_8B = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                 num_attention_heads=32, num_key_value_heads=8, rope_theta=500000.0,
                 rms_norm_eps=1e-5, max_position_embeddings=8192, tie_word_embeddings=False)
LLAMA3_LAYERS, LLAMA3_NEW, LLAMA3_SEED = 4, 16, 18   # depth cut, greedy tokens a request, seed
# the default and paged paths against the scan path at these widths: the
# teacher-forced relative L2 logit drift (sound runs 0.0765-0.0826), and a
# served request's scan-path lead at its first difference in units of that
# logit row's standard deviation (sound runs at most 0.267; about 2.5 of the
# 128256 random-weight logits lie within 0.35 of the row's top, so a path
# whose choice is not a near tie of the scan path's lands far outside it)
LLAMA3_DRIFT, LLAMA3_LEAD_STD = 0.15, 0.5


def llama3_phase(timer, gen, base):
    """LLaMA-3-8B at its published widths (``LLAMA3_8B``), (G, hd) = (4, 128),
    cut to LLAMA3_LAYERS layers, at W8A8KV8 and W4A8KV4 (packed cache): the
    K9 phase (kernel against its plain version at the cut's depth and at
    CUT_LAYERS, timed); then ``InferenceEngine`` with default flags (every
    decode step one K9 launch, held by its launch count), on the scan path
    (``use_megakernel=False``, K3 every layer: the witness) and
    ``PagedInferenceEngine`` (K8 every layer) serving 8 requests of
    PROMPT_LENS tokens, LLAMA3_NEW greedy tokens each. Default and paged
    against scan: the longest prompt (1000 tokens, 8 pages) teacher-forced
    through the three paths is held to LLAMA3_DRIFT, and each served
    request's first difference to a near tie, a lead of at most
    LLAMA3_LEAD_STD of the scan path's logit row's standard deviation
    (``compare_tokens``); every failure is reported before the phase fails.
    Weights, prompts and tokens from a generator of its own."""
    from llm_qat_torch.inference import megakernel as MK
    from llm_qat_torch.inference import quantized as Q
    from llm_qat_torch.models import params as P

    cfg0 = base.replace(num_hidden_layers=LLAMA3_LAYERS, **LLAMA3_8B)
    rng = np.random.default_rng(LLAMA3_SEED)
    prompts = [list(map(int, rng.integers(1, cfg0.vocab_size, n))) for n in PROMPT_LENS]
    out = dict(kernel=[], runs=[], flips={}, teacher_forced={}, peak_gib={},
               launches=dict.fromkeys(counters(), 0))
    modes = {"W8A8KV8": dict(w_bits=8, a_bits=8, kv_bits=8),
             "W4A8KV4": dict(w_bits=4, a_bits=8, kv_bits=4, kv_cache_pack=True)}
    L = cfg0.num_hidden_layers
    for label, mode in modes.items():
        cfg = cfg0.replace(**mode)
        name = f"{label} LLaMA-3-8B"
        if not MK.card_takes(cfg, 8, 2048, torch.bfloat16):
            raise AssertionError(f"{name}: K9 does not take it")
        params = P.init_params(cfg, seed=LLAMA3_SEED, dtype=torch.bfloat16)
        qp = Q.quantize_params(params, cfg)
        del params
        torch.cuda.empty_cache()
        out["kernel"].append(megakernel_phase(timer, name, cfg, qp, gen))
        torch.cuda.reset_peak_memory_stats()
        dflt = serve(f"{name} megakernel", cfg, qp, prompts, new_tokens=LLAMA3_NEW,
                     profile=label == "W8A8KV8")
        out["peak_gib"][label] = torch.cuda.max_memory_allocated() / 2 ** 30
        scan = serve(f"{name} scan", cfg.replace(use_megakernel=False), qp, prompts,
                     new_tokens=LLAMA3_NEW, profile=False)
        paged = serve_paged(f"{name} paged", cfg, qp, prompts, ROOMY_PAGES, profile=False,
                            new_tokens=LLAMA3_NEW)
        gemm_k = "int8_matmul" if label.startswith("W8") else "int4_matmul"
        for m in (dflt[0], scan[0], paged[0]):
            dl, pl = m["decode_launches"], m["prefill_launches"]
            if m is dflt[0]:
                ok = (dl["decode_megakernel"] == m["decode_steps"] and dl["decode_attention"] == 0
                      and dl["int8_matmul"] == dl["int4_matmul"] == 0)
            elif m is scan[0]:
                ok = (dl["decode_attention"] == L * m["decode_steps"] and dl[gemm_k] > 0
                      and m["launches"]["decode_megakernel"] == 0)
            else:
                ok = (dl["paged_attention"] == L * m["decode_steps"] and dl[gemm_k] > 0
                      and m["launches"]["decode_megakernel"] == 0
                      and m["launches"]["decode_attention"] == 0)
            if not (ok and pl[gemm_k] > 0 and pl["flash_fwd"] > 0):
                raise AssertionError(f"{m['mode']}: launches off the path: prefill {pl}, "
                                     f"decode {dl}")
            for k in out["launches"]:
                out["launches"][k] += m["launches"][k]
        out["runs"] += [dflt[0], scan[0], paged[0]]
        # teacher-forced on the longest prompt: it spans several pages and KV
        # blocks, where the paged path's per-page roundings part from the
        # scan path's (within one page the two agree to the bit)
        toks, prompt = [], prompts[-1]
        n9 = MK.decode_layers.launches
        mega = _greedy_logits(cfg, qp, prompt, "cuda", toks)
        if MK.decode_layers.launches - n9 != 4:
            raise AssertionError(f"{name}: the teacher-forced default run missed K9")
        wit = _greedy_logits(cfg.replace(use_megakernel=False), qp, prompt, "cuda", toks)
        pgd = _greedy_logits_paged(cfg, qp, prompt, "cuda", toks)
        tf, bad = {}, []
        for other, seq in (("megakernel", mega), ("paged", pgd)):
            same, drift, diff = _compare(seq, wit)
            log(f"  {name}: {other} against scan path teacher-forced on a {len(prompt)}-token "
                f"prompt: tokens equal {same}, drift {drift:.4g} (limit {LLAMA3_DRIFT}), "
                f"largest logit difference {diff:.4g}")
            if drift > LLAMA3_DRIFT:
                bad.append(f"{other} drifts {drift:.4g} from the scan path")
            tf[other] = dict(tokens_equal=same, drift=drift, max_abs=diff)
            try:
                out["flips"][f"{label} {other}"] = compare_tokens(
                    name, scan, dflt if other == "megakernel" else paged, None, other=other,
                    lead_std=LLAMA3_LEAD_STD)
            except AssertionError as e:
                bad.append(str(e))
        if bad:
            raise AssertionError(f"{name}: " + "; ".join(bad))
        out["teacher_forced"][label] = tf
        log(f"  {name}: decode ms/step default {dflt[0]['decode_ms_per_step']:.3f}, scan "
            f"{scan[0]['decode_ms_per_step']:.3f}, paged {paged[0]['decode_ms_per_step']:.3f}; "
            f"peak {out['peak_gib'][label]:.2f} GiB in the default run")
        del qp, dflt, scan, paged
        torch.cuda.empty_cache()
    return out


# OpenLLaMA-3B's published config.json (openlm-research/open_llama_3b): 32
# MHA heads of 100, H 3200 and I 8640 (off the products' 256 K grid), 26
# layers, vocabulary 32000, rms_norm_eps 1e-6; full depth, random weights from
# OPENLLAMA_SEED
OPENLLAMA_3B = dict(vocab_size=32000, hidden_size=3200, intermediate_size=8640,
                    num_hidden_layers=26, num_attention_heads=32, num_key_value_heads=32,
                    rms_norm_eps=1e-6, rope_theta=10000.0, max_position_embeddings=2048,
                    tie_word_embeddings=False)
OPENLLAMA_NEW, OPENLLAMA_SEED = 16, 23   # greedy tokens a request, the phase's seed


def cut_against_cpu(label, cfg, params, prompt):
    """The CUT_LAYERS cut of ``cfg`` (``params``: its bf16 weights on the
    card) greedy through the scan and the paged path on the card, then
    teacher-forced with their tokens on the CPU path (plain versions), every
    activation quantizer's codes recorded on both: each held by the flip rule
    (``hold_flip``: CUT_DRIFT before the first parting quantizer, one level,
    CUT_FLIP_DRIFT from it). The default path (K9) against the scan path on
    the card, teacher-forced with the scan path's tokens: within
    MEGA_CUT_DRIFT, and where a step's greedy token parts (the paths differ
    by design: SiLU in fp32, attention rounded block by block) the scan
    path's lead of its token at most LLAMA3_LEAD_STD of that logit row's
    standard deviation: a near tie."""
    from llm_qat_torch.inference import quantized as Q

    scan = cfg.replace(use_megakernel=False)
    gpu_q, cpu_q = Q.quantize_params(params, scan), Q.quantize_params(params, scan, device="cpu")
    out = {}
    for path, run in (("scan", _greedy_logits), ("paged", _greedy_logits_paged)):
        toks, cg, cc = [], [], []
        with record_codes(cg):
            card = run(scan, gpu_q, prompt, "cuda", toks)
        with record_codes(cc):
            cpu = run(scan, cpu_q, prompt, "cpu", toks)
        parting = first_code_parting(cc, cg, CUT_LAYERS)
        steps = _compare_steps(card, cpu)
        log(f"  {label} {CUT_LAYERS}-layer cut, {len(prompt)} tokens, {path} path against the "
            f"CPU path: greedy tokens equal {steps[0]}, relative L2 drift "
            f"[{', '.join(f'{d:.3g}' for d in steps[1])}], codes {parting_text(parting)}")
        hold_flip(f"{label} {CUT_LAYERS}-layer cut, {path} against the CPU path", steps, parting)
        out[path] = dict(steps=steps, codes=parting)
        if path == "scan":
            mega = _greedy_logits(cfg, gpu_q, prompt, "cuda", toks)
            same, drift, diff = _compare(mega, card)
            leads = [float((r[r.argmax()] - r[m.argmax()]) / r.std())
                     for r, m, eq in zip(card, mega, same) if not eq]
            log(f"  {label} {CUT_LAYERS}-layer cut: default path (K9) against the scan path: "
                f"tokens equal {same} (scan path's lead where they part, in row std: "
                f"{', '.join(f'{x:.3g}' for x in leads) or 'none'}; limit {LLAMA3_LEAD_STD}), "
                f"drift {drift:.4g} (limit {MEGA_CUT_DRIFT})")
            if not (drift <= MEGA_CUT_DRIFT and all(x <= LLAMA3_LEAD_STD for x in leads)):
                raise AssertionError(f"{label} cut: K9 against the scan path: drift {drift}, "
                                     f"leads {leads} row std")
            out["megakernel_vs_scan"] = dict(tokens_equal=same, drift=drift, max_abs=diff,
                                             leads_std=leads)
    return out


def openllama3b_phase(timer, gen, base):
    """OpenLLaMA-3B at its published widths and full depth (``OPENLLAMA_3B``),
    (G, hd) = (1, 100): head dim 100 through the padded builds of K4, K3/K8
    and K9, and the products' K tails (H, I off the 256 grid), at W8A8KV8 and
    W4A8KV4 (packed cache), by ``full_depth_phase``. 26 random-weight layers
    that re-quantize every projection's input amplify the paths' by-design
    differences past the 4-layer drift limit: 0.209-0.221 in this phase's
    first run, leads to 0.59 row std (PERF.md §6)."""
    return full_depth_phase(timer, gen, base.replace(**OPENLLAMA_3B), "OpenLLaMA-3B",
                            OPENLLAMA_SEED, "megakernel_dpad", OPENLLAMA_NEW)


SERVE_MODES = {"W8A8KV8": dict(w_bits=8, a_bits=8, kv_bits=8),
               "W4A8KV4": dict(w_bits=4, a_bits=8, kv_bits=4, kv_cache_pack=True)}


def full_depth_phase(timer, gen, cfg0, model, seed, stem, new_tokens):
    """A model at its published widths and full depth (``cfg0``) on every
    serving path, at W8A8KV8 and W4A8KV4 (packed cache), K9 through the build
    of ``stem``. The K9 phase (kernel against its plain version at full depth
    and at CUT_LAYERS, bit-equal, timed); then ``InferenceEngine`` with
    default flags (every decode step one K9 launch), on the scan path
    (``use_megakernel=False``, K3 every layer) and ``PagedInferenceEngine``
    (K8 every layer) serving 8 requests of PROMPT_LENS tokens,
    ``new_tokens`` greedy tokens each, prefill through K4 and K1/K2, every
    launch count held. Default and paged against scan: at LLaMA-3-8B's depth
    (a LLAMA3_LAYERS cut) by that phase's gates, the 1000-token prompt
    teacher-forced through the three paths within LLAMA3_DRIFT and, where a
    step's greedy token parts, the scan path's lead of its token at most
    LLAMA3_LEAD_STD of the logit row's standard deviation;
    at full depth by the rule the repo holds its other full-depth models to
    (TinyLlama-1.1B, LLaMA-7B): the same prompt within MEGA_FULL_DRIFT, and
    each served request's first difference a near tie of the scan path
    (``compare_tokens`` with the teacher-forced run's largest logit
    difference). Last, a CUT_LAYERS cut against the CPU path
    (``cut_against_cpu``). Weights, prompts and tokens from ``seed``."""
    from llm_qat_torch.inference import megakernel as MK
    from llm_qat_torch.inference import quantized as Q
    from llm_qat_torch.models import params as P

    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(1, cfg0.vocab_size, n))) for n in PROMPT_LENS]
    out = dict(kernel=[], runs=[], flips={}, teacher_forced={}, peak_gib={},
               launches=dict.fromkeys(counters(), 0))
    L, G = cfg0.num_hidden_layers, cfg0.num_attention_heads // cfg0.kv_heads
    for label, mode in SERVE_MODES.items():
        t_mode = time.perf_counter()
        gc.collect()                   # reference cycles of earlier runs hold device memory
        torch.cuda.empty_cache()
        cfg = cfg0.replace(**mode)
        name = f"{label} {model}"
        if not (MK.card_takes(cfg, 8, 2048, torch.bfloat16)
                and MK._stem(cfg.head_dim, G) == stem):
            raise AssertionError(f"{name}: K9's build {stem} does not take it")
        params = P.init_params(cfg, seed=seed, dtype=torch.bfloat16)
        qp = Q.quantize_params(params, cfg)
        del params
        torch.cuda.empty_cache()
        out["kernel"].append(megakernel_phase(timer, name, cfg, qp, gen))
        torch.cuda.reset_peak_memory_stats()
        dflt = serve(f"{name} megakernel", cfg, qp, prompts, new_tokens=new_tokens,
                     profile=False)
        out["peak_gib"][label] = torch.cuda.max_memory_allocated() / 2 ** 30
        scan = serve(f"{name} scan", cfg.replace(use_megakernel=False), qp, prompts,
                     new_tokens=new_tokens, profile=False)
        paged = serve_paged(f"{name} paged", cfg, qp, prompts, ROOMY_PAGES, profile=False,
                            new_tokens=new_tokens)
        gemm_k = "int8_matmul" if label.startswith("W8") else "int4_matmul"
        for m in (dflt[0], scan[0], paged[0]):
            dl, pl = m["decode_launches"], m["prefill_launches"]
            if m is dflt[0]:
                ok = (dl["decode_megakernel"] == m["decode_steps"] and dl["decode_attention"] == 0
                      and dl["int8_matmul"] == dl["int4_matmul"] == 0)
            elif m is scan[0]:
                ok = (dl["decode_attention"] == L * m["decode_steps"] and dl[gemm_k] > 0
                      and m["launches"]["decode_megakernel"] == 0)
            else:
                ok = (dl["paged_attention"] == L * m["decode_steps"] and dl[gemm_k] > 0
                      and m["launches"]["decode_megakernel"] == 0
                      and m["launches"]["decode_attention"] == 0)
            if not (ok and pl[gemm_k] > 0 and pl["flash_fwd"] > 0):
                raise AssertionError(f"{m['mode']}: launches off the path: prefill {pl}, "
                                     f"decode {dl}")
            for k in out["launches"]:
                out["launches"][k] += m["launches"][k]
        out["runs"] += [dflt[0], scan[0], paged[0]]
        prompt, tf, bad = prompts[-1], {}, []
        for depth, limit in ((LLAMA3_LAYERS, LLAMA3_DRIFT), (L, MEGA_FULL_DRIFT)):
            c, q = cfg.replace(num_hidden_layers=depth), qp if depth == L else cut_layers(qp, depth)
            toks, n9 = [], MK.decode_layers.launches
            mega = _greedy_logits(c, q, prompt, "cuda", toks)
            if MK.decode_layers.launches - n9 != 4:
                raise AssertionError(f"{name}: the teacher-forced default run missed K9")
            wit = _greedy_logits(c.replace(use_megakernel=False), q, prompt, "cuda", toks)
            pgd = _greedy_logits_paged(c, q, prompt, "cuda", toks)
            for other, seq in (("megakernel", mega), ("paged", pgd)):
                same, drift, diff = _compare(seq, wit)
                leads = [float((r[r.argmax()] - r[m.argmax()]) / r.std())
                         for r, m, eq in zip(wit, seq, same) if not eq]
                log(f"  {name} at {depth} layers: {other} against scan path teacher-forced on "
                    f"a {len(prompt)}-token prompt: tokens equal {same}, drift {drift:.4g} "
                    f"(limit {limit}), largest logit difference {diff:.4g}; the scan path's "
                    f"lead where they part, in row std: "
                    f"{', '.join(f'{x:.3g}' for x in leads) or 'none'}"
                    + (f" (limit {LLAMA3_LEAD_STD})" if depth != L else ""))
                if drift > limit:
                    bad.append(f"{other} drifts {drift:.4g} from the scan path at {depth} layers")
                if depth != L and any(x > LLAMA3_LEAD_STD for x in leads):
                    bad.append(f"{other} parts from the scan path at {depth} layers with leads "
                               f"{leads} row std")
                tf[f"{other} {depth} layers"] = dict(tokens_equal=same, drift=drift, max_abs=diff,
                                                     leads_std=leads)
                if depth != L:
                    continue
                try:
                    out["flips"][f"{label} {other}"] = compare_tokens(
                        name, scan, dflt if other == "megakernel" else paged, diff, other=other)
                except AssertionError as e:
                    bad.append(str(e))
        if bad:
            raise AssertionError(f"{name}: " + "; ".join(bad))
        out["teacher_forced"][label] = tf
        log(f"  {name}: decode ms/step default {dflt[0]['decode_ms_per_step']:.3f}, scan "
            f"{scan[0]['decode_ms_per_step']:.3f}, paged {paged[0]['decode_ms_per_step']:.3f}; "
            f"peak {out['peak_gib'][label]:.2f} GiB in the default run; the mode took "
            f"{time.perf_counter() - t_mode:.1f} s")
        del qp, dflt, scan, paged
        torch.cuda.empty_cache()
    cut = cfg0.replace(num_hidden_layers=CUT_LAYERS, **SERVE_MODES["W8A8KV8"])
    params = P.init_params(cut, seed=seed, dtype=torch.bfloat16)
    out["cut_vs_cpu"] = cut_against_cpu(f"W8A8KV8 {model}", cut, params, prompts[0])
    del params
    torch.cuda.empty_cache()
    return out


# Falcon3-7B-Base's published config.json (tiiuae/Falcon3-7B-Base, a
# LlamaForCausalLM): 12 query heads over 4 kv heads of 256 (G = 3; head_dim
# 256 = hidden / heads, as LlamaConfig derives it), H 3072, I 23040, 28
# layers, vocabulary 131072, rope_theta 1000042, rms_norm_eps 1e-6, untied
# embeddings; full depth, random weights from FALCON3_SEED
FALCON3_7B = dict(vocab_size=131072, hidden_size=3072, intermediate_size=23040,
                  num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=4,
                  rms_norm_eps=1e-6, rope_theta=1000042.0, max_position_embeddings=32768,
                  tie_word_embeddings=False)
FALCON3_NEW, FALCON3_SEED = 16, 28   # greedy tokens a request, the phase's seed


def falcon3_phase(timer, gen, base):
    """Falcon3-7B-Base at its published widths and full depth (``FALCON3_7B``),
    (G, hd) = (3, 256): head dim 256 through K4's ``flash_fwd_d256``, K3/K8's
    ``decode_attention_d256.cu`` and K9's ``megakernel_d256.cu`` on every
    serving path, at W8A8KV8 and W4A8KV4 (packed cache), by
    ``full_depth_phase``."""
    return full_depth_phase(timer, gen, base.replace(**FALCON3_7B), "Falcon3-7B", FALCON3_SEED,
                            "megakernel_d256", FALCON3_NEW)


# Mistral-Large-2's published config.json (mistralai/Mistral-Large-Instruct-2407):
# 96 query heads over 8 kv heads of 128 (G = 12), H 12288, I 28672, vocabulary
# 32768, rope_theta 1e6, rms_norm_eps 1e-5, 88 layers. Llama-3.1-405B's
# (meta-llama/Llama-3.1-405B): 128 query heads over 8 kv heads of 128 (G = 16),
# H 16384, I 53248, vocabulary 128256, rope_theta 5e5, rms_norm_eps 1e-5, 126
# layers; its rope_scaling block is left out (LlamaConfig.from_hf_dict does not
# read it). Both cut to WIDE_LAYERS layers (reduced: 88 or 126 layers do not
# fit 80 GB, even at W4 with the K-contiguous copy K9 reads); random weights
# from WIDE_SEED
MISTRAL_LARGE_2 = dict(vocab_size=32768, hidden_size=12288, intermediate_size=28672,
                       num_attention_heads=96, num_key_value_heads=8, rope_theta=1e6,
                       rms_norm_eps=1e-5, max_position_embeddings=131072,
                       tie_word_embeddings=False)
LLAMA31_405B = dict(vocab_size=128256, hidden_size=16384, intermediate_size=53248,
                    num_attention_heads=128, num_key_value_heads=8, rope_theta=5e5,
                    rms_norm_eps=1e-5, max_position_embeddings=131072, tie_word_embeddings=False)
WIDE_LAYERS, WIDE_SEED = 2, 26
WIDE_FULL_LAYERS = {"Mistral-Large-2": 88, "Llama-3.1-405B": 126}
# (model, published widths, mode, slots of the default run, paged run too):
# the default path at a b JAX's supported() sends to its megakernel (b = 8 at
# Mistral-Large-2 W4; b = 1 at its W8 and at Llama-3.1-405B W4, where JAX's
# TPU scratch budget sends b = 8 to its scan path; the card's K9 has no such
# budget); the scan and paged runs at b = 8
WIDE_RUNS = (("Mistral-Large-2", MISTRAL_LARGE_2, "W4A8KV4", 8, True),
             ("Mistral-Large-2", MISTRAL_LARGE_2, "W8A8KV8", 1, False),
             ("Llama-3.1-405B", LLAMA31_405B, "W4A8KV4", 1, True))


def wide_groups_phase(timer, gen, base):
    """More than 8 query heads a kv head on every serving path: Mistral-Large-2
    (G = 12) and Llama-3.1-405B (G = 16) at their published widths
    (``MISTRAL_LARGE_2``, ``LLAMA31_405B``), cut to WIDE_LAYERS layers, each
    run of ``WIDE_RUNS``: the K9 phase at the run's default b (kernel against
    its plain version at the cut's depth, held bit-equal, timed beside its
    byte bound; b = 1 at the longest of K9_LENS); then ``InferenceEngine``
    with default flags at that b (every decode step one K9 launch through its
    9..16 build), on the scan path at b = 8 (K3 every layer) and, where the
    run says, ``PagedInferenceEngine`` at b = 8 (K8 every layer), 8 requests
    of PROMPT_LENS tokens, LLAMA3_NEW greedy tokens each (the default run at
    a b where JAX's ``supported()`` takes the config too). Held by LLaMA-3-8B's
    gates (``llama3_phase``): the 1000-token prompt teacher-forced through
    the default and paged paths against the scan path
    within LLAMA3_DRIFT, and each served request's first difference a near
    tie (LLAMA3_LEAD_STD). Prints the launches a step and each model's peak
    memory. Weights, prompts and tokens from a generator of its own."""
    from llm_qat_torch.inference import megakernel as MK
    from llm_qat_torch.inference import quantized as Q
    from llm_qat_torch.models import params as P

    out = dict(kernel=[], runs=[], flips={}, teacher_forced={}, peak_gib={},
               launches=dict.fromkeys(counters(), 0), reduced={})
    L = WIDE_LAYERS
    for model, widths, label, b_dflt, with_paged in WIDE_RUNS:
        t_run = time.perf_counter()
        # the earlier phases leave reference cycles that hold device memory
        # (train_run clears them the same way)
        before_gc = torch.cuda.memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  allocated at the run's entry {before_gc / 2 ** 30:.2f} GiB, after gc "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
        torch.cuda.reset_peak_memory_stats()
        cfg = base.replace(num_hidden_layers=L, **widths, **SERVE_MODES[label])
        name = f"{label} {model}"
        G = cfg.num_attention_heads // cfg.kv_heads
        out["reduced"][model] = f"layers: {L} of {WIDE_FULL_LAYERS[model]}"
        if not (MK.card_takes(cfg, b_dflt, 2048, torch.bfloat16)
                and MK._stem(cfg.head_dim, G).endswith("_g16")):
            raise AssertionError(f"{name}: K9's 9..16 build does not take b = {b_dflt}")
        rng = np.random.default_rng(WIDE_SEED)
        prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n))) for n in PROMPT_LENS]
        params = P.init_params(cfg, seed=WIDE_SEED, dtype=torch.bfloat16)
        qp = Q.quantize_params(params, cfg)
        del params
        torch.cuda.empty_cache()
        lens = K9_LENS if b_dflt == len(K9_LENS) else K9_LENS[-b_dflt:]
        out["kernel"].append(dict(megakernel_phase(timer, name, cfg, qp, gen, lens=lens),
                                  model=model, G=G))
        if not out["kernel"][-1]["bit_equal"]:
            raise AssertionError(f"{name}: K9 is not bit-equal to its plain version")
        dflt = serve(f"{name} megakernel b={b_dflt}", cfg, qp, prompts, new_tokens=LLAMA3_NEW,
                     profile=False, max_batch=b_dflt)
        scan = serve(f"{name} scan", cfg.replace(use_megakernel=False), qp, prompts,
                     new_tokens=LLAMA3_NEW, profile=False)
        paged = (serve_paged(f"{name} paged", cfg, qp, prompts, ROOMY_PAGES, profile=False,
                             new_tokens=LLAMA3_NEW) if with_paged else None)
        gemm_k = "int8_matmul" if label.startswith("W8") else "int4_matmul"
        for m in (dflt[0], scan[0]) + ((paged[0],) if paged else ()):
            dl, pl = m["decode_launches"], m["prefill_launches"]
            if m is dflt[0]:
                ok = (dl["decode_megakernel"] == m["decode_steps"] and dl["decode_attention"] == 0
                      and dl["int8_matmul"] == dl["int4_matmul"] == 0)
            elif m is scan[0]:
                ok = (dl["decode_attention"] == L * m["decode_steps"] and dl[gemm_k] > 0
                      and m["launches"]["decode_megakernel"] == 0)
            else:
                ok = (dl["paged_attention"] == L * m["decode_steps"] and dl[gemm_k] > 0
                      and m["launches"]["decode_megakernel"] == 0
                      and m["launches"]["decode_attention"] == 0)
            if not (ok and pl[gemm_k] > 0 and pl["flash_fwd"] > 0):
                raise AssertionError(f"{m['mode']}: launches off the path: prefill {pl}, "
                                     f"decode {dl}")
            for k in out["launches"]:
                out["launches"][k] += m["launches"][k]
            m.update(model=model, G=G)
            log(f"  {m['mode']}: launches a decode step "
                + ", ".join(f"{k} {v / m['decode_steps']:g}" for k, v in dl.items() if v))
        out["runs"] += [dflt[0], scan[0]] + ([paged[0]] if paged else [])
        # teacher-forced on the longest prompt (b = 1: the default path is K9)
        toks, prompt, tf, bad = [], prompts[-1], {}, []
        n9 = MK.decode_layers.launches
        seqs = {"megakernel": _greedy_logits(cfg, qp, prompt, "cuda", toks)}
        if MK.decode_layers.launches - n9 != 4:
            raise AssertionError(f"{name}: the teacher-forced default run missed K9")
        wit = _greedy_logits(cfg.replace(use_megakernel=False), qp, prompt, "cuda", toks)
        if paged:
            seqs["paged"] = _greedy_logits_paged(cfg, qp, prompt, "cuda", toks)
        for other, seq in seqs.items():
            same, drift, diff = _compare(seq, wit)
            log(f"  {name}: {other} against scan path teacher-forced on a {len(prompt)}-token "
                f"prompt: tokens equal {same}, drift {drift:.4g} (limit {LLAMA3_DRIFT}), "
                f"largest logit difference {diff:.4g}")
            if drift > LLAMA3_DRIFT:
                bad.append(f"{other} drifts {drift:.4g} from the scan path")
            tf[other] = dict(tokens_equal=same, drift=drift, max_abs=diff)
            try:
                out["flips"][f"{name} {other}"] = compare_tokens(
                    name, scan, dflt if other == "megakernel" else paged, None, other=other,
                    lead_std=LLAMA3_LEAD_STD)
            except AssertionError as e:
                bad.append(str(e))
        if bad:
            raise AssertionError(f"{name}: " + "; ".join(bad))
        out["teacher_forced"][name] = tf
        out["peak_gib"][name] = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  {name} ({L} of its layers, G = {G}): decode ms/step default (b={b_dflt}) "
            f"{dflt[0]['decode_ms_per_step']:.3f}, scan {scan[0]['decode_ms_per_step']:.3f}"
            + (f", paged {paged[0]['decode_ms_per_step']:.3f}" if paged else "")
            + f"; K9 {out['kernel'][-1]['ms']:.4f} ms a step (bound "
            f"{out['kernel'][-1]['bound_ms']:.4f} {out['kernel'][-1]['bound_by']}); peak "
            f"{out['peak_gib'][name]:.2f} GiB; the run took {time.perf_counter() - t_run:.1f} s")
        del qp, dflt, scan, paged
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------


def counters():
    from llm_qat_torch.inference import megakernel as MK
    from llm_qat_torch.ops import decode_attention as DA
    from llm_qat_torch.ops import flash_attention as FA
    from llm_qat_torch.ops import quant_matmul as QM
    return {"int8_matmul": QM.int8_matmul, "int4_matmul": QM.int4_matmul,
            "decode_attention": DA.quantized_decode_attention,
            "flash_fwd": FA._flash_fwd, "decode_megakernel": MK.decode_layers,
            "paged_attention": DA.quantized_paged_attention,
            "int8_matmul_stacked": QM.int8_matmul_stacked,
            "int4_matmul_stacked": QM.int4_matmul_stacked,
            "decode_attention_stacked": DA.quantized_decode_attention_stacked,
            **train_counters()}


def train_counters():
    from llm_qat_torch.ops import flash_attention as FA
    from llm_qat_torch.ops import fused_quant as FQ
    return {"flash_bwd_dq": FA._flash_bwd_dq, "flash_bwd_dkv": FA._flash_bwd_dkv,
            "rmsnorm_quant": FQ.rmsnorm_quant, "silu_mul_quant": FQ.silu_mul_quant,
            "silu_mul_amax": FQ.silu_mul_amax, "silu_mul_quant_amax": FQ.silu_mul_quant_amax}


def read_counters():
    return {k: fn.launches for k, fn in counters().items()}


def serve(label, cfg, qparams, prompts, new_tokens=SERVE_NEW, profile=True, max_batch=8):
    """Serve 8 requests through the engine at ``cfg``'s width and depth
    (TinyLlama-1.1B's full ones unless a phase says otherwise) on ``cfg``'s
    decode path, ``new_tokens`` greedy tokens each, ``max_batch`` slots;
    returns the run's metrics, with the launches of prefill and of decode
    apart, each request's tokens and every decode step's logits.
    ``profile``: one 8-step chunk under the profiler after the run."""
    from llm_qat_torch.inference import engine as E

    t_call = time.perf_counter()
    # warm-up: one short request (cuBLAS handles, first launches)
    warm = E.InferenceEngine(qparams, cfg, max_batch=max_batch, max_len=2048)
    warm.submit(prompts[0], max_new_tokens=8)
    warm.run()
    del warm

    eng = E.InferenceEngine(qparams, cfg, max_batch=max_batch, max_len=2048)
    pre = {"s": 0.0, "tokens": sum(map(len, prompts)), "rows": 0,
           "launches": dict.fromkeys(counters(), 0)}
    real_prefill = eng._prefill

    def timed_prefill(qp, ids):
        before = read_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_prefill(qp, ids)
        torch.cuda.synchronize()
        pre["s"] += time.perf_counter() - t
        pre["rows"] += ids.shape[0] * ids.shape[1]
        for k, n in read_counters().items():
            pre["launches"][k] += n - before[k]
        return out

    eng._prefill = timed_prefill
    tops = []
    real_fwd = eng._fwd

    def recorded_fwd(*a, **k):
        logits, cache = real_fwd(*a, **k)
        tops.append(logits[:, 0])
        return logits, cache

    eng._fwd = recorded_fwd
    uids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()

    if len(done) != len(prompts) or any(len(r.output) != new_tokens for r in done):
        raise AssertionError(f"{label}: {len(done)} finished, outputs "
                             f"{[len(r.output) for r in done]}")
    if not torch.isfinite(eng._logits).all():
        raise AssertionError(f"{label}: non-finite logits")
    if any(not (0 <= t < cfg.vocab_size) for r in done for t in r.output):
        raise AssertionError(f"{label}: token out of range")
    steps = len(tops)
    decode_s = wall - pre["s"]
    by_uid = {r.uid: r.output for r in done}
    m = dict(
        mode=label, requests=len(done), prompt_tokens=pre["tokens"],
        prefill_rows=pre["rows"], prefill_s=pre["s"],
        prefill_tok_per_s=pre["tokens"] / pre["s"],
        decode_steps=steps, decode_s=decode_s,
        decode_ms_per_step=1e3 * decode_s / steps,
        generated_tok_per_s=len(done) * new_tokens / wall, wall_s=wall,
        launches=launches, prefill_launches=pre["launches"],
        decode_launches={k: launches[k] - pre["launches"][k] for k in launches},
    )
    if profile:
        m["profile"] = profile_decode_chunk(eng, prompts)
    log(f"  {label}: prefill {m['prefill_tok_per_s']:.0f} tok/s "
        f"({pre['tokens']} prompt tokens in {m['prefill_s']:.3f} s), decode "
        f"{m['decode_ms_per_step']:.3f} ms/step over {steps} steps of {max_batch} slots, "
        f"{m['generated_tok_per_s']:.1f} generated tok/s; launches in prefill "
        f"{m['prefill_launches']}, in decode {m['decode_launches']}; the call took "
        f"{time.perf_counter() - t_call:.1f} s")
    return m, [by_uid[u] for u in uids], tops


def serve_paged(label, cfg, qparams, prompts, n_pages, profile, new_tokens=SERVE_NEW):
    """Serve the 8 requests through ``PagedInferenceEngine`` at full
    TinyLlama width and depth: pages of PAGE tokens, SEQ_PAGES a sequence, a
    pool of ``n_pages`` (one of them scratch). At admission the prompts'
    buckets (16, 128, 256, 512, 4 x 1024) take 1+1+2+4+8+8+8+8 = 40 pages:
    ROOMY_PAGES holds them all; TIGHT_PAGES = 33 (32 usable) leaves the
    eighth request waiting and is dry at the first page a decoding slot
    crosses into, so the engine must preempt. Preemptions are counted here,
    by wrapping ``_preempt_victim``, with the tokens each one throws away
    (the victim's prompt and output so far, prefilled again on
    re-admission). Returns the run's metrics and each request's tokens."""
    from llm_qat_torch.inference import paged as PG
    from llm_qat_torch.inference import paged_engine as PE

    pcfg = PG.PagedConfig(page_size=PAGE, n_pages=n_pages, max_pages_per_seq=SEQ_PAGES)

    def engine():
        return PE.PagedInferenceEngine(qparams, cfg, pcfg=pcfg, max_batch=8, steps_per_sync=8)

    t_call = time.perf_counter()
    warm = engine()
    warm.submit(prompts[0], max_new_tokens=8)
    warm.run()
    del warm

    eng = engine()
    pre = {"s": 0.0, "calls": 0, "rows": 0, "launches": dict.fromkeys(counters(), 0)}
    real_prefill, real_fwd, real_preempt = eng._prefill, eng._fwd, eng._preempt_victim

    def timed_prefill(qp, ids, *a):
        before = read_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_prefill(qp, ids, *a)
        torch.cuda.synchronize()
        pre["s"] += time.perf_counter() - t
        pre["calls"] += 1
        pre["rows"] += ids.shape[0] * ids.shape[1]
        for k, n in read_counters().items():
            pre["launches"][k] += n - before[k]
        return out

    steps = [0]

    def counted_fwd(*a):
        steps[0] += 1
        return real_fwd(*a)

    preempted = {"n": 0, "tokens": 0}

    def counted_preempt(skip):
        hit = real_preempt(skip)
        if hit:                                    # the victim now heads the queue
            preempted["n"] += 1
            preempted["tokens"] += len(eng.queue[0].prompt)
        return hit

    eng._prefill, eng._fwd, eng._preempt_victim = timed_prefill, counted_fwd, counted_preempt
    uids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()

    # a preempted request comes back with its output folded into its prompt:
    # its tokens are the prompt's tail plus what it generated afterwards
    by_uid = {r.uid: r for r in done}
    toks = []
    for u, p in zip(uids, prompts):
        r = by_uid.get(u)
        toks.append(None if r is None else r.prompt[len(p):] + r.output)
    if len(done) != len(prompts) or any(t is None or len(t) != new_tokens for t in toks):
        raise AssertionError(f"{label}: {len(done)} finished, outputs "
                             f"{[None if t is None else len(t) for t in toks]}")
    if not torch.isfinite(eng._logits).all():
        raise AssertionError(f"{label}: non-finite logits")
    if any(not (0 <= t < cfg.vocab_size) for ts in toks for t in ts):
        raise AssertionError(f"{label}: token out of range")
    if eng.alloc.available != n_pages - 1:
        raise AssertionError(f"{label}: {eng.alloc.available} of {n_pages - 1} pages back "
                             "in the pool after the run")
    decode_s = wall - pre["s"]
    prompt_tokens = sum(map(len, prompts)) + preempted["tokens"]
    m = dict(
        mode=label, requests=len(done), n_pages=n_pages, page_size=PAGE,
        prompt_tokens=sum(map(len, prompts)), prefilled_tokens=prompt_tokens,
        prefill_calls=pre["calls"], prefill_rows=pre["rows"], prefill_s=pre["s"],
        prefill_tok_per_s=prompt_tokens / pre["s"],
        decode_steps=steps[0], decode_s=decode_s,
        decode_ms_per_step=1e3 * decode_s / steps[0],
        generated_tok_per_s=len(done) * new_tokens / wall, wall_s=wall,
        preemptions=preempted["n"], recomputed_tokens=preempted["tokens"],
        launches=launches, prefill_launches=pre["launches"],
        decode_launches={k: launches[k] - pre["launches"][k] for k in launches},
    )
    if profile:
        m["profile"] = profile_decode_chunk(eng, prompts)
        if eng.alloc.available != n_pages - 1:
            raise AssertionError(f"{label}: pages missing after the profiled run")
    log(f"  {label}: pool {n_pages} x {PAGE}, prefill {m['prefill_tok_per_s']:.0f} tok/s "
        f"({prompt_tokens} tokens in {m['prefill_calls']} calls, {m['prefill_s']:.3f} s), "
        f"decode {m['decode_ms_per_step']:.3f} ms/step over {m['decode_steps']} steps, "
        f"{m['generated_tok_per_s']:.1f} generated tok/s, {preempted['n']} preemptions, "
        f"{preempted['tokens']} recomputed tokens; launches in prefill "
        f"{m['prefill_launches']}, in decode {m['decode_launches']}; the call took "
        f"{time.perf_counter() - t_call:.1f} s")
    return m, toks


def compare_tokens(label, scan, mega, path_diff, other="megakernel", lead_std=None):
    """The megakernel run's (or, with ``other="paged"``, the roomy paged
    run's) greedy tokens against the scan run's, request by request. The two decode paths differ by design (SiLU in fp32 against
    the model type, attention rounded block by block against per slot), and
    22 layers that re-quantize every projection's input amplify that, so a
    greedy choice may flip where logits nearly tie, and after a flip the
    two requests are different texts. ``path_diff`` is the largest absolute
    logit difference between the two paths that ``cpu_check`` measured at
    full depth on its own prompt (teacher-forced). If the paths' logits
    differ by at most e on the same tokens, the choice can flip only where
    the scan path's logit of its own token leads its logit of the
    megakernel's token by at most 2 e. Rule: token 0 (from the prefill,
    which both runs share) is equal; at a request's first difference that
    lead is at most NEAR_TIE_OVER x ``path_diff`` (2 e, and a factor 2 for
    another prompt and a longer context than e was measured on). With
    ``lead_std`` the limit is instead that many of the scan path's logit
    row's standard deviation at the step."""
    (_, s_tok, s_logits), m_tok = scan, mega[1]
    flips = []
    for r, (a, b) in enumerate(zip(s_tok, m_tok)):
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            continue
        if t == 0:
            raise AssertionError(f"{label}: request {r} differs at the prefill's token")
        row = s_logits[t - 1][r]               # the step that produced token t
        flips.append(dict(request=r, step=t, scan_token=a[t], other_token=b[t],
                          scan_lead=float(row[a[t]] - row[b[t]]), row_std=float(row.std())))
    for f in flips:
        f["limit"] = NEAR_TIE_OVER * path_diff if lead_std is None else lead_std * f["row_std"]
    limit = f"{NEAR_TIE_OVER * path_diff:.4g}" if lead_std is None else f"{lead_std} std"
    log(f"  {label}: {other} run against scan run, {len(s_tok) - len(flips)} of "
        f"{len(s_tok)} requests equal over {len(s_tok[0])} tokens; first differences "
        f"(scan path's lead there, limit {limit}): "
        + ("; ".join(f"request {f['request']} step {f['step']} lead {f['scan_lead']:.4g} "
                     f"({f['scan_lead'] / f['row_std']:.3g} std)" for f in flips) or "none"))
    bad = [f for f in flips if f["scan_lead"] > f["limit"]]
    if bad:
        raise AssertionError(f"{label}: tokens part where the scan path is not near a tie: {bad}")
    return flips


def profile_decode_chunk(eng, prompts):
    """One chunk of decode steps (8 slots) under torch.profiler, after the
    measured run: device time by kernel and the device's busy share of the
    chunk's wall time. Only the kernels' own events are summed: an operator's
    event repeats the device time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.submit(p, max_new_tokens=2 * eng.steps_per_sync)
    eng.step()                        # admission, prefill, first chunk
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    eng.run()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ev)
    top = sorted(ev, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    out = dict(steps=eng.steps_per_sync, wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
               device_busy_share=busy / wall_us,
               top=[(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in top])
    log(f"  profile of one {eng.steps_per_sync}-step chunk: wall {out['wall_ms']:.2f} ms, "
        f"device busy {out['device_busy_ms']:.2f} ms ({100 * out['device_busy_share']:.1f}%)")
    for name, ms, n in out["top"]:
        log(f"    {ms:9.3f} ms  x{n:5d}  {name}")
    return out


@contextlib.contextmanager
def plain_on_gpu():
    """Within the block, the kernel wrappers are their plain versions,
    so the GPU path runs with no hand-written kernel: the witness that
    separates the kernels' share of a GPU/CPU difference from the rest of
    the GPU path's (cuBLAS bf16 products, CUDA reductions)."""
    from llm_qat_torch.inference import megakernel as MK
    from llm_qat_torch.ops import decode_attention as DA
    from llm_qat_torch.ops import flash_attention as FA
    from llm_qat_torch.ops import quant_matmul as QM

    swaps = [(MK, "decode_layers", MK.decode_layers_plain),
             (QM, "int8_matmul", QM._int8_matmul_plain),
             (QM, "int4_matmul", QM._int4_matmul_plain),
             (DA, "quantized_decode_attention", DA._decode_attention_plain),
             (DA, "quantized_paged_attention", DA._paged_attention_plain),
             (FA, "_flash_fwd", FA._flash_fwd_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def k8_against_k3(found):
    """Within the block every launch of the paged attention kernel is also
    held against the contiguous kernel K3 on the same K/V, gathered from the
    pool through the block tables into a contiguous cache: the two kernels on
    the model's own data, layer by layer and step by step, with nothing in
    between to amplify a difference. ``found`` collects each comparison."""
    from llm_qat_torch.ops import decode_attention as DA

    real = DA.quantized_paged_attention

    def both(q, k_q, k_s, v_q, v_s, lens, bt, kc=None, ksn=None, fold=None, **kw):
        out = real(q, k_q, k_s, v_q, v_s, lens, bt, kc, ksn, fold, **kw)
        b, idx = bt.shape[0], bt.long()
        ck = k_q[idx].permute(0, 2, 3, 1, 4).reshape(b, k_q.shape[1], k_q.shape[2], -1)
        cv = v_q[idx].permute(0, 2, 3, 1, 4).reshape(b, v_q.shape[1], v_q.shape[2], -1)
        flat = DA.quantized_decode_attention(
            q, ck.contiguous(), k_s[idx].reshape(b, -1), cv.contiguous(),
            v_s[idx].reshape(b, -1), lens, kc, ksn, fold, **kw)
        found.append(agreement(out, flat, PAGED_VS_K3_ULPS, PAGED_VS_K3_FLOOR))
        return out

    both.launches = real.launches      # the wrapper counts on its module's name
    DA.quantized_paged_attention = both
    try:
        yield
    finally:
        real.launches = both.launches
        DA.quantized_paged_attention = real


def _bucketed(prompt):
    """``[1, bucket]`` ids of ``prompt``, zero-padded to the engines' pow2
    bucket (16 at least)."""
    bucket = 16
    while bucket < len(prompt):
        bucket *= 2
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :len(prompt)] = prompt
    return ids


def _greedy_logits(cfg, qp, prompt, dev, toks, max_len=64, dtype=torch.bfloat16, mesh=None):
    """Prefill + 4 decode steps; the first run (``toks`` empty) picks the
    greedy tokens and later runs are teacher-forced with them. Returns the
    5 last-position logit vectors on the host. ``mesh``: tensor-parallel over
    its 'tp' group, ``qp`` this rank's shard. The cache holds ``max_len``
    rows, or twice the prompt's bucket where that is more."""
    from llm_qat_torch.inference import model as M
    from llm_qat_torch.parallel import mesh as pmesh

    group = None if mesh is None else pmesh.axis_group(mesh, "tp")
    kvh = cfg.kv_heads // (1 if mesh is None else pmesh.axis_size(mesh, "tp"))

    n, ids = len(prompt), _bucketed(prompt)
    lg, rows = M.prefill_slot(qp, cfg, ids, dtype=dtype, device=dev, tp_group=group)
    cache = M.init_serving_cache(cfg, 1, max(max_len, 2 * ids.shape[1]), device=dev,
                                 kv_heads=kvh)
    M.insert_slot(cache, rows, 0)
    cache["lengths"] = torch.full((1,), len(prompt), dtype=torch.int32, device=dev)
    seq = [lg[0, n - 1].float().cpu()]
    for i in range(4):
        if len(toks) == i:
            toks.append(int(seq[-1].argmax()))
        lg, cache = M.serving_forward(qp, cfg, [[toks[i]]], cache["lengths"], [True],
                                      cache, dtype=dtype, device=dev, tp_group=group)
        seq.append(lg[0, -1].float().cpu())
    return seq


def _greedy_logits_paged(cfg, qp, prompt, dev, toks, dtype=torch.bfloat16, mesh=None):
    """``_greedy_logits`` through the paged forward: the prompt's bucket
    prefilled from empty into shuffled pages of a small pool, then 4 decode
    steps."""
    from llm_qat_torch.inference import paged as PG
    from llm_qat_torch.parallel import mesh as pmesh

    group = None if mesh is None else pmesh.axis_group(mesh, "tp")
    kvh = cfg.kv_heads // (1 if mesh is None else pmesh.axis_size(mesh, "tp"))

    n = len(prompt)
    pages = -(-(n + 4) // PAGE)
    pcfg = PG.PagedConfig(page_size=PAGE, n_pages=pages + 3, max_pages_per_seq=pages + 1)
    cache = PG.init_paged_cache(cfg, pcfg, device=dev, kv_heads=kvh)
    tables = [list(range(pages, 0, -1)) + [0]]          # pages + 1 entries, reversed ids
    ids = _bucketed(prompt)
    lg, cache = PG.paged_forward(qp, cfg, pcfg, ids, [0], [True], tables, cache,
                                 dtype=dtype, from_empty=True, device=dev, tp_group=group)
    seq = [lg[0, n - 1].float().cpu()]
    for i in range(4):
        if len(toks) == i:
            toks.append(int(seq[-1].argmax()))
        lg, cache = PG.paged_forward(qp, cfg, pcfg, [[toks[i]]], [n + i], [True], tables,
                                     cache, dtype=dtype, device=dev, tp_group=group)
        seq.append(lg[0, -1].float().cpu())
    return seq


def _compare_steps(a_seq, b_seq):
    """(greedy tokens equal, relative L2 logit drift) per logit vector."""
    return ([int(a.argmax()) == int(b.argmax()) for a, b in zip(a_seq, b_seq)],
            [float((a - b).norm() / b.norm()) for a, b in zip(a_seq, b_seq)])


def _compare(a_seq, b_seq):
    """(greedy tokens equal per step, largest relative L2 logit drift,
    largest absolute logit difference)."""
    same = [int(a.argmax()) == int(b.argmax()) for a, b in zip(a_seq, b_seq)]
    drift = max(float((a - b).norm() / b.norm()) for a, b in zip(a_seq, b_seq))
    return same, drift, max(float((a - b).abs().max()) for a, b in zip(a_seq, b_seq))


@contextlib.contextmanager
def record_codes(found):
    """Within the block every serving projection's activation quantizer
    (``quant_matmul.quantize_rows``) appends its int8 codes, the real rows,
    to ``found`` in call order: per forward and layer qkv, o, gate-up, down.
    The codes are what a rounding flip changes first."""
    from llm_qat_torch.ops import quant_matmul as QM

    real = QM.quantize_rows

    def rec(x, bits, amax=None):
        xq, sx, M = real(x, bits, amax)
        found.append(xq[:M].clone())
        return xq, sx, M

    QM.quantize_rows = rec
    try:
        yield found
    finally:
        QM.quantize_rows = real


def first_code_parting(ref, got, layers, rank=0, n=1):
    """The first quantizer call whose codes part between ``ref`` and ``got``
    (``record_codes`` of the same forwards; under TP ``got`` is rank
    ``rank`` of ``n``, whose row-parallel inputs hold its K-shard of
    ``ref``'s). None when every code agrees; else the call (its forward,
    layer and projection), how many elements part, the largest level
    difference, the tensor's elements, and whether it is a shard."""
    if len(ref) != len(got):
        raise AssertionError(f"{len(ref)} quantizer calls against {len(got)}")
    for i, (a, b) in enumerate(zip(ref, got)):
        a, shard = a.to(b.device), a.shape != b.shape
        if shard:
            k = b.shape[-1]
            if a.shape[:-1] != b.shape[:-1] or a.shape[-1] != n * k:
                raise AssertionError(f"quantizer call {i}: {tuple(a.shape)} against "
                                     f"{tuple(b.shape)}")
            a = a[..., rank * k:(rank + 1) * k]
        d = (a.int() - b.int()).abs()
        parting = int((d > 0).sum())
        if parting:
            return dict(call=i, forward=i // (4 * layers), layer=i // 4 % layers,
                        proj=("qkv", "o", "gateup", "down")[i % 4], parting=parting,
                        levels=int(d.max()), elements=b.numel() * (n if shard else 1),
                        shard=shard)
    return None


def parting_text(p):
    return "none" if p is None else (
        f"forward {p['forward']}, {p['proj']} input of layer {p['layer']}: {p['parting']} of "
        f"{p['elements']} codes, {p['levels']} level(s) apart")


def join_partings(per_rank):
    """The first parting over the ranks' ``first_code_parting``: at a
    row-parallel input each rank saw its own shard, so their counts add."""
    found = [p for p in per_rank if p is not None]
    if not found:
        return None
    first = min(p["call"] for p in found)
    at = [p for p in found if p["call"] == first]
    if not at[0]["shard"]:
        return at[0]
    return dict(at[0], parting=sum(p["parting"] for p in at),
                levels=max(p["levels"] for p in at))


def gpu_vs_cpu(cfg, qparams, prompt, long_prompt):
    """The same weights through four paths: the GPU scan path with its
    kernels, the default path (decode steps in the whole-model kernel), the
    GPU scan path with the plain versions (``plain_on_gpu``) and the CPU
    scan path (plain versions), the last three teacher-forced with the
    first's greedy tokens; then the paged path the same three ways (kernels,
    plain versions, CPU), and the paged path against the scan path on
    ``long_prompt``."""
    def tree_cpu(t):
        return {k: tree_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()

    scan = cfg.replace(use_megakernel=False)
    toks = []
    kern = _greedy_logits(scan, qparams, prompt, "cuda", toks)
    mega = _greedy_logits(cfg, qparams, prompt, "cuda", toks)
    with plain_on_gpu():
        plain = _greedy_logits(scan, qparams, prompt, "cuda", toks)
    cpu = _greedy_logits(scan, tree_cpu(qparams), prompt, "cpu", toks)
    # the paged path: with its kernels, with the plain versions, on the CPU
    pkern = _greedy_logits_paged(scan, qparams, prompt, "cuda", toks)
    with plain_on_gpu():
        pplain = _greedy_logits_paged(scan, qparams, prompt, "cuda", toks)
    pcpu = _greedy_logits_paged(scan, tree_cpu(qparams), prompt, "cpu", toks)
    # paged against scan on a prompt of several pages (its own greedy tokens)
    ltoks = []
    lscan = _greedy_logits(scan, qparams, long_prompt, "cuda", ltoks, max_len=2048)
    k8 = []
    with k8_against_k3(k8):
        lpaged = _greedy_logits_paged(scan, qparams, long_prompt, "cuda", ltoks)
    # and in float32, where K8 and K3 round nothing and differ only in the
    # order of their fp32 sums
    ftoks = []
    fscan = _greedy_logits(scan, qparams, long_prompt, "cuda", ftoks, max_len=2048,
                           dtype=torch.float32)
    fpaged = _greedy_logits_paged(scan, qparams, long_prompt, "cuda", ftoks,
                                  dtype=torch.float32)
    finite = all(bool(torch.isfinite(x).all()) for x in kern + mega + pkern + lpaged + fpaged)
    return dict(kernels_vs_cpu=_compare(kern, cpu), plain_vs_cpu=_compare(plain, cpu),
                kernels_vs_plain=_compare(kern, plain), megakernel_vs_scan=_compare(mega, kern),
                paged_vs_cpu=_compare(pkern, pcpu), paged_plain_vs_cpu=_compare(pplain, pcpu),
                paged_vs_plain=_compare(pkern, pplain), paged_vs_scan=_compare(lpaged, lscan),
                paged_vs_scan_f32=_compare(fpaged, fscan), finite=finite,
                k8_vs_k3=dict(launches=len(k8), ok=all(a["ok"] for a in k8),
                              worst=max(a["worst"] for a in k8),
                              max_abs_err=max(a["max_abs_err"] for a in k8)))


def cpu_check(label, cfg, qparams, rng):
    """The GPU path against the CPU path (plain versions) on the same
    weights for one short prompt, prefill + 4 greedy steps, at the first
    CUT_LAYERS layers and at full depth.

    Cut: greedy tokens equal and logit drift (relative L2) <= CUT_DRIFT;
    this run reads ~4e-7 there, a K3 that skipped the TPU kernel's bf16
    roundings read 4.4-5.5%. Full depth: 22 layers of random weights
    re-quantize every projection's input to int8, so one last-bit
    difference that moves a rounding grows layer over layer, with no kernel
    involved: the GPU path with the plain versions (``plain_on_gpu``)
    measures that drift. The kernels' path must give that path's greedy
    tokens and stay within FULL_DRIFT_OVER x its drift from the CPU, plus
    CUT_DRIFT. The default path (decode steps in the whole-model kernel)
    against the scan path: the two differ by design (SiLU in fp32, block-wise
    attention roundings): every SiLU output may differ by a bf16 step, the
    int8 quant that follows turns part of those into whole quantization
    steps, and the cut reads ~5% at W8, so it is held to MEGA_CUT_DRIFT with
    equal tokens; at full depth the difference is a property of the two
    algorithms, not of the CUDA kernel (held bit for bit against its plain
    version in ``megakernel_phase``): it is reported, held under
    MEGA_FULL_DRIFT (unrelated logits would read 1.4) and its largest
    absolute value sets ``compare_tokens``' limit.

    The paged path is held the same way against its own CPU run and its own
    plain-versions witness. Paged against scan, both on the GPU, on a prompt
    of PAGED_PROMPT tokens (8 pages), where the two run the same code but for
    K8 against K3. The proof that the paged path computes the scan path's
    function is taken where nothing amplifies a difference: every K8 launch
    of that run is held against K3 on the same K/V gathered into a
    contiguous cache (``k8_against_k3``), under the kernel phase's limit. The
    logits are reported and held loosely. In bf16 K8 rounds p*vs against the
    running maximum of its pages where K3 walks the JAX picker's 1024-column
    blocks, a bf16 step in some attention outputs, and the int8 quant after it amplifies that as it does
    for the megakernel path (4-5% at the cut): held to MEGA_CUT_DRIFT at the
    cut and MEGA_FULL_DRIFT at full depth, tokens reported (they part at
    near-ties), and the largest absolute difference at full depth sets the
    limit of ``compare_tokens`` for the paged run. In float32 neither kernel
    rounds and the paths read 2e-7..5e-7 apart at the cut, unless one of
    the ~10^5 int8 activations of the four steps rounds the other way, which
    the next layer grows to percents (one run in two read 2.9%): same limits."""
    prompt = rng.integers(1, cfg.vocab_size, 16)
    # from a generator of its own: ``rng``'s draws stay those of the prompts
    long_prompt = np.random.default_rng(PAGED_PROMPT).integers(1, cfg.vocab_size,
                                                               PAGED_PROMPT)
    full = gpu_vs_cpu(cfg, qparams, prompt, long_prompt)
    cut = cfg.replace(num_hidden_layers=CUT_LAYERS)
    part = gpu_vs_cpu(cut, cut_layers(qparams, CUT_LAYERS), prompt, long_prompt)
    for depth, r in ((cfg.num_hidden_layers, full), (CUT_LAYERS, part)):
        log(f"  {label} {depth} layers, greedy tokens equal per step and largest logit "
            "drift (largest absolute difference): "
            + "; ".join(f"{k} {r[k][0]} {r[k][1]:.4g} ({r[k][2]:.3g})"
                                  for k in ("kernels_vs_cpu", "plain_vs_cpu",
                                            "kernels_vs_plain", "megakernel_vs_scan",
                                            "paged_vs_cpu", "paged_plain_vs_cpu",
                                            "paged_vs_plain", "paged_vs_scan",
                                            "paged_vs_scan_f32")))
    limit_full = FULL_DRIFT_OVER * full["plain_vs_cpu"][1] + CUT_DRIFT
    limit_paged = FULL_DRIFT_OVER * full["paged_plain_vs_cpu"][1] + CUT_DRIFT
    log(f"  {label} limits: {CUT_LAYERS} layers {CUT_DRIFT}; full depth "
        f"{FULL_DRIFT_OVER} x plain GPU path's + {CUT_DRIFT} = {limit_full:.4g} "
        f"(paged: {limit_paged:.4g}); paged vs scan: {MEGA_CUT_DRIFT} at {CUT_LAYERS} layers, "
        f"{MEGA_FULL_DRIFT} at full depth; K8 against K3 inside that run: "
        + "; ".join(f"{r['k8_vs_k3']['launches']} launches, worst {r['k8_vs_k3']['worst']:.3g} "
                    f"of its limit, max_abs_err {r['k8_vs_k3']['max_abs_err']:.3g}"
                    for r in (part, full)))
    ok = (full["finite"] and part["finite"]
          and all(part["kernels_vs_cpu"][0]) and part["kernels_vs_cpu"][1] <= CUT_DRIFT
          and all(full["kernels_vs_plain"][0])
          and full["kernels_vs_cpu"][1] <= limit_full
          and all(part["megakernel_vs_scan"][0])
          and part["megakernel_vs_scan"][1] <= MEGA_CUT_DRIFT
          and full["megakernel_vs_scan"][1] <= MEGA_FULL_DRIFT
          and all(part["paged_vs_cpu"][0]) and part["paged_vs_cpu"][1] <= CUT_DRIFT
          and all(full["paged_vs_plain"][0])
          and full["paged_vs_cpu"][1] <= limit_paged
          and part["paged_vs_scan"][1] <= MEGA_CUT_DRIFT
          and full["paged_vs_scan"][1] <= MEGA_FULL_DRIFT
          and part["paged_vs_scan_f32"][1] <= MEGA_CUT_DRIFT
          and full["paged_vs_scan_f32"][1] <= MEGA_FULL_DRIFT
          and part["k8_vs_k3"]["ok"] and full["k8_vs_k3"]["ok"]
          and part["k8_vs_k3"]["launches"] == 4 * CUT_LAYERS
          and full["k8_vs_k3"]["launches"] == 4 * cfg.num_hidden_layers)
    if not ok:
        raise AssertionError(f"{label}: GPU and CPU paths disagree")
    return dict(mode=label, full_depth=full, cut_layers=CUT_LAYERS, cut=part,
                full_depth_limit=limit_full, full_depth_limit_paged=limit_paged)


# ---------------------------------------------------------------------------
# training: kernel phases
# ---------------------------------------------------------------------------


def live_pairs(lens, S, causal=True):
    """(query row, key column) pairs a flash kernel must visit for one query
    head of each sequence: columns < max(length, 1), and <= row when causal."""
    tot = 0
    for n in lens:
        n = max(n, 1)
        tot += (n * (n + 1) // 2 + (S - n) * n) if causal else S * n
    return tot


def flash_train_phase(timer, gen, FA, G, D, ragged):
    """K4, K10 and K11 at a train step's attention shape: B = len(ragged)
    sequences of one kv head (batch x kv heads), G query heads a kv head,
    S = TRAIN_SEQ, head dim D, causal, bf16, twice: at full lengths (what the
    train step runs, and what SDPA, the yardstick, computes) and at the
    ``ragged`` lengths (full, ragged, 1 and 0). Each against its plain
    version under the K3/K4 limit (``agreement``): kernel and plain version
    take q.k and dO.v as the same bf16 products with fp32 sums, compute p
    from the same log-sum-exp and round ds and p to bf16 alike; they differ
    in their fp32 summation orders. K10 and K11 are also launched twice on
    the same inputs and must give the same bits (no atomics), and K11 exact
    zeros past each length. The backward pair takes the forward KERNEL's O
    and log-sum-exp. ``library_ms`` of the backward pair is the backward of
    one ``scaled_dot_product_attention`` call (dQ, dK and dV together; the
    port never calls it): causal at full lengths, under the lengths' boolean
    mask at the ragged ones (``ragged_sdpa_inputs``), where
    ``library_fwd_bwd_ms`` is its forward and backward together."""
    B, S = len(ragged), TRAIN_SEQ
    q, do = (torch.randn(B, G, S, D, device="cuda", generator=gen).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kh, vh = k[:, None], v[:, None]
    lib_fwd = timer(lambda: sdpa(q, kh, vh, is_causal=True, enable_gqa=True))
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, kh, vh))
    out = sdpa(ql, kl, vl, is_causal=True, enable_gqa=True)
    lib_bwd = timer(lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True))
    del out, ql, kl, vl

    rows = {}
    for label, lens_l in (("full", (S,) * B), ("ragged", ragged)):
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        o, lse = FA._flash_fwd(q, k, v, lens)
        o2, lse2 = FA._flash_fwd_plain(q, k, v, lens)
        torch.cuda.synchronize()
        fwd = agreement(o, o2, ATTN_ULPS, ATTN_FLOOR)
        lse_err = float((lse - lse2).abs().max())
        del o2, lse2
        if not (fwd["ok"] and lse_err <= 1e-3):
            raise AssertionError(f"flash forward S={S} {label} lengths: {fwd}, lse {lse_err}")
        delta = FA._delta(o, do)
        args = (q, k, v, lens, lse, delta, do)
        dq = FA._flash_bwd_dq(*args)
        dk, dv = FA._flash_bwd_dkv(*args)
        dq_again = FA._flash_bwd_dq(*args)
        dk_again, dv_again = FA._flash_bwd_dkv(*args)
        dq2 = FA._flash_bwd_dq_plain(*args)
        dk2, dv2 = FA._flash_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        agr = {n: agreement(a, w, ATTN_ULPS, ATTN_FLOOR)
               for n, a, w in (("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2))}
        zeros = all(not t[b, max(n, 1):].any() for t in (dk, dv) for b, n in enumerate(lens_l))
        same_dq = torch.equal(dq, dq_again)
        same = torch.equal(dk, dk_again) and torch.equal(dv, dv_again)
        if not (all(a["ok"] for a in agr.values()) and zeros and same and same_dq):
            raise AssertionError(f"flash backward G={G} D={D}, {label} lengths: {agr}, zeros past "
                                 f"the lengths {zeros}, the same bits twice: K10 {same_dq}, "
                                 f"K11 {same}")
        del dq, dk, dv, dq_again, dk_again, dv_again, dq2, dk2, dv2

        ms = {"fwd": timer(lambda: FA._flash_fwd(q, k, v, lens)),
              "dq": timer(lambda: FA._flash_bwd_dq(*args)),
              "dkv": timer(lambda: FA._flash_bwd_dkv(*args))}
        plain = {"fwd": timer(lambda: FA._flash_fwd_plain(q, k, v, lens), reps=3),
                 "dq": timer(lambda: FA._flash_bwd_dq_plain(*args), reps=3),
                 "dkv": timer(lambda: FA._flash_bwd_dkv_plain(*args), reps=3)}
        pairs = G * live_pairs(lens_l, S)
        qb, kvb, rowb = 2 * B * G * S * D, 2 * B * S * D, 4 * B * G * S
        bounds = {"fwd": bound(2 * qb + 2 * kvb + rowb, 2 * 2 * pairs * D, BF16_FLOPS),
                  "dq": bound(3 * qb + 2 * kvb + 2 * rowb, 3 * 2 * pairs * D, BF16_FLOPS),
                  "dkv": bound(2 * qb + 4 * kvb + 2 * rowb, 4 * 2 * pairs * D, BF16_FLOPS)}
        if label == "full":
            lib = {"fwd": lib_fwd, "dq": lib_bwd, "dkv": lib_bwd}
        else:
            kx, vx, mask = ragged_sdpa_inputs(k, v, lens_l, G)
            lib = {"fwd": timer(lambda: sdpa(q, kx, vx, attn_mask=mask))}
            ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, kx, vx))
            out = sdpa(ql, kl, vl, attn_mask=mask)
            lib["dq"] = lib["dkv"] = timer(
                lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True))
            lib["fwd_bwd"] = timer(
                lambda: torch.autograd.grad(sdpa(ql, kl, vl, attn_mask=mask), (ql, kl, vl), do))
            del out, ql, kl, vl, kx, vx, mask
        log(f"  flash at the train shape B={B} G={G} S={S} D={D}, {label} lengths {list(lens_l)}: "
            f"forward {ms['fwd']:.4f} ms (plain {plain['fwd']:.2f}, sdpa {lib.get('fwd')}, bound "
            f"{bounds['fwd'][0]:.4f} {bounds['fwd'][1]}) max_abs_err {fwd['max_abs_err']:.3g}, "
            f"worst {fwd['worst']:.3g} of its limit, lse {lse_err:.3g}; dQ {ms['dq']:.4f} ms (plain "
            f"{plain['dq']:.2f}, bound {bounds['dq'][0]:.4f} {bounds['dq'][1]}) max_abs_err "
            f"{agr['dq']['max_abs_err']:.3g}, worst {agr['dq']['worst']:.3g}, the same bits twice; "
            f"dK/dV {ms['dkv']:.4f} "
            f"ms (plain {plain['dkv']:.2f}, bound {bounds['dkv'][0]:.4f} {bounds['dkv'][1]}) "
            f"max_abs_err dk {agr['dk']['max_abs_err']:.3g} dv {agr['dv']['max_abs_err']:.3g}, worst "
            f"{max(agr['dk']['worst'], agr['dv']['worst']):.3g}, the same bits twice; sdpa backward "
            f"(dQ, dK, dV together) {lib['dq']:.4f} ms"
            + (f", forward and backward {lib['fwd_bwd']:.4f} ms" if "fwd_bwd" in lib else ""))
        shape = dict(B=B, G=G, S=S, D=D, lengths="full" if label == "full" else list(lens_l),
                     live_pairs=pairs)

        def row(key, **extra):
            return dict(shape, ms=ms[key], plain_ms=plain[key], library_ms=lib.get(key),
                        bound_ms=bounds[key][0], bound_by=bounds[key][1], **extra)

        lib_is = "sdpa backward, dQ+dK+dV together" + (
            "" if label == "full" else " under the lengths' boolean mask, K/V expanded to the G "
            "query heads")
        if "fwd_bwd" in lib:
            shape["library_fwd_bwd_ms"] = lib["fwd_bwd"]
        rows[label] = dict(
            fwd=row("fwd", blocks=-(-S // 64) * G * B, lse_err=lse_err, **fwd),
            dq=row("dq", library_is=lib_is, blocks=-(-S // 64) * G * B,
                   bit_identical_twice=same_dq, **agr["dq"]),
            dkv=row("dkv", library_is=lib_is, blocks=(-(-S // 64) + 1) // 2 * B,
                    bit_identical_twice=same,
                    max_abs_err=max(agr["dk"]["max_abs_err"], agr["dv"]["max_abs_err"]),
                    dk=agr["dk"], dv=agr["dv"]))
    return rows


def quant_agreement(got, again, want):
    """K12/K13 against their plain versions, to the bit (K13 sums nothing;
    K12's plain version sums its squares in the kernel's order on the card),
    and a second launch's bits equal to the first's. ``max_abs_err`` is the
    largest integer difference (in steps)."""
    (q, s), (q2, s2), (q3, s3) = got, want, again
    d = (q.int() - q2.int()).abs()
    res = dict(scale_max_rel_err=float(((s - s2).abs() / s2).max()),
               int_diff_share=float((d != 0).float().mean()), max_abs_err=float(d.max()),
               same_bits_twice=bool(torch.equal(q, q3) and torch.equal(s, s3)))
    res["ok"] = bool(torch.equal(q, q2) and torch.equal(s, s2)) and res["same_bits_twice"]
    return res


def stream_floor_ms(timer, a, b=None):
    """Time of ``csrc/stream_floor.cu`` on a K12 / K13 row set: it moves
    the same bytes (bf16 ``a``, and ``b`` for K13's second input, read in
    16-byte pieces; a byte an element written in 8-byte pieces) and computes
    nothing, so it reads the rate such a pass attains under this Timer."""
    from llm_qat_torch.ops import _build

    f = _build.bind("stream_floor", "stream_floor", 3, 1)
    out = torch.empty(a.shape, dtype=torch.int8, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    run = lambda: _build.check(f(a.data_ptr(), None if b is None else b.data_ptr(),  # noqa: E731
                                 out.data_ptr(), a.numel() // 8, st), "stream_floor")
    run()
    return timer(run)


def fused_quant_phase(timer, gen, FQ, c):
    """K12 at the train step's rows [4 * 2048, H] with an f32 and a bf16 gain,
    at the LLaMA-7B-width run's [2 * 2048, 4096] and at LLaMA-13B's hidden
    width [2 * 2048, 5120] (1/K inexact in fp32) with a bf16 gain; K13 at
    [4 * 2048, I] and at the LLaMA-7B width's [2 * 2048, 11008]; bf16,
    8-bit activations; and K12 again at [4096, 5120] on rows from a seeded
    search of its own generator (the shape where the kernel once gave an
    integer two levels off, when the plain version summed in another order;
    ``sum_order_moves`` counts the integers that order would move). Each
    against its plain version to the bit (``quant_agreement``). Bound by bytes: input read once (2 bytes an element, two
    inputs for K13), int8 written once, a scale a row, the gain. Each row
    prints the kernel's plan (``FQ.plan``: chunks a thread, warps a row, row
    groups a block), its share of the bound and ``floor_ms``, the time of a
    pass that moves the same bytes and computes nothing (``stream_floor_ms``)."""
    M, M7, I = TRAIN_BATCH * TRAIN_SEQ, LLAMA7B_TRAIN_BATCH * TRAIN_SEQ, c.intermediate_size
    out = {"rmsnorm_quant": [], "silu_mul_quant": []}
    gen_replay = torch.Generator(device="cuda")
    gen_replay.manual_seed(K12_REPLAY_SEED)
    for M_, H, gdt, gen_ in ((M, c.hidden_size, torch.float32, gen),
                             (M, c.hidden_size, torch.bfloat16, gen),
                             (M7, 4096, torch.bfloat16, gen), (M7, 5120, torch.bfloat16, gen),
                             (M7, 5120, torch.bfloat16, gen_replay)):
        h = (torch.randn(M_, H, device="cuda", generator=gen_) * 1.3).to(torch.bfloat16)
        g = (1 + 0.1 * torch.randn(H, device="cuda", generator=gen_)).to(gdt)
        run = lambda: FQ.rmsnorm_quant(h, g, c.rms_norm_eps, 8)  # noqa: E731
        agr = quant_agreement(run(), run(), FQ._rmsnorm_quant_plain(h, g, c.rms_norm_eps, 8))
        agr["sum_order_moves"] = int((run()[0] != FQ._rmsnorm_quant_plain(
            h, g, c.rms_norm_eps, 8, kernel_order=False)[0]).sum())
        agr["replay"] = gen_ is gen_replay
        torch.cuda.synchronize()
        if not agr["ok"]:
            raise AssertionError(f"rmsnorm_quant [{M_}, {H}] gain {gdt}: {agr}")
        ms = timer(run)
        plain_ms = timer(lambda: FQ._rmsnorm_quant_plain(h, g, c.rms_norm_eps, 8))
        floor_ms = stream_floor_ms(timer, h)
        b_ms, b_by = bound(3 * M_ * H + 4 * M_ + g.element_size() * H, 8.0 * M_ * H, F32_FLOPS)
        p = FQ.plan(H, 2, 1, f32_products=gdt != torch.bfloat16)
        log(f"  rmsnorm_quant [{M_}, {H}] bf16, gain {str(gdt)[6:]}, plan {p}: {ms:.4f} ms (plain "
            f"{plain_ms:.4f}, bound {b_ms:.4f} {b_by}, {100 * b_ms / ms:.1f}% of it; streaming "
            f"floor {floor_ms:.4f}, {100 * floor_ms / ms:.1f}% of it); bit-equal to the plain "
            f"version {agr['ok']} (integers the sum(dim=1) order would move: "
            f"{agr['sum_order_moves']}{', seeded search' if agr['replay'] else ''})")
        out["rmsnorm_quant"].append(dict(M=M_, K=H, gain=str(gdt)[6:], plan=p, ms=ms,
                                         plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                                         bound_by=b_by, bound_share=b_ms / ms,
                                         floor_ms=floor_ms, **agr))
    for M_, I_ in ((M, I), (M7, 11008)):
        gate = (torch.randn(M_, I_, device="cuda", generator=gen) * 2).to(torch.bfloat16)
        up = torch.randn(M_, I_, device="cuda", generator=gen).to(torch.bfloat16)
        run = lambda: FQ.silu_mul_quant(gate, up, 8)  # noqa: E731
        agr = quant_agreement(run(), run(), FQ._silu_mul_quant_plain(gate, up, 8))
        torch.cuda.synchronize()
        if not agr["ok"]:
            raise AssertionError(f"silu_mul_quant [{M_}, {I_}]: {agr}")
        ms = timer(run)
        plain_ms = timer(lambda: FQ._silu_mul_quant_plain(gate, up, 8))
        floor_ms = stream_floor_ms(timer, gate, up)
        b_ms, b_by = bound(5 * M_ * I_ + 4 * M_, 12.0 * M_ * I_, F32_FLOPS)
        p = FQ.plan(I_, 2, 2)
        log(f"  silu_mul_quant [{M_}, {I_}] bf16, plan {p}: {ms:.4f} ms (plain {plain_ms:.4f}, "
            f"bound {b_ms:.4f} {b_by}, {100 * b_ms / ms:.1f}% of it; streaming floor "
            f"{floor_ms:.4f}, {100 * floor_ms / ms:.1f}% of it); integers differ in "
            f"{agr['int_diff_share']:.3g} of the elements, scales rel err "
            f"{agr['scale_max_rel_err']:.3g}, the same bits twice {agr['same_bits_twice']}")
        out["silu_mul_quant"].append(dict(M=M_, K=I_, plan=p, ms=ms, plain_ms=plain_ms,
                                          library_ms=None, bound_ms=b_ms, bound_by=b_by,
                                          bound_share=b_ms / ms, floor_ms=floor_ms, **agr))
    return out


# ---------------------------------------------------------------------------
# training: the train step
# ---------------------------------------------------------------------------


def profile_kernels(fn, label):
    """``fn()`` under torch.profiler: device time by kernel and the device's
    busy share of the wall time (kernel events only, as in
    ``profile_decode_chunk``), and the device time and launches of the
    kernels whose names hold each string of ``PROFILE_WATCH``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ev)
    top = sorted(ev, key=lambda e: e.self_device_time_total, reverse=True)[:14]
    watched = {w: (sum(e.self_device_time_total for e in ev if w in e.key) / 1e3,
                   sum(e.count for e in ev if w in e.key)) for w in PROFILE_WATCH}
    out = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3, device_busy_share=busy / wall_us,
               top=[(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top],
               watched=watched)
    log(f"  profile of {label}: wall {out['wall_ms']:.1f} ms, device busy "
        f"{out['device_busy_ms']:.1f} ms ({100 * out['device_busy_share']:.1f}%); "
        + ", ".join(f"{w} {ms:.3f} ms in {n} launches" for w, (ms, n) in watched.items()))
    for name, ms, n in out["top"]:
        log(f"    {ms:9.3f} ms  x{n:5d}  {name}")
    return out


def train_cfg_of(cfg, layers=None, **kw):
    """``cfg`` (TinyLlama-1.1B, LLaMA-7B or OpenLLaMA-3B) at W4A8KV4 with the library's
    default flags, optionally cut to its first ``layers`` layers."""
    c = cfg.replace(w_bits=4, a_bits=8, kv_bits=4, **kw)
    return c if layers is None else c.replace(num_hidden_layers=layers)


def train_run(label, cfg, steps, warm, profile, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """KD-QAT train steps through ``Trainer``, the recipe of the JAX package's
    benchmark: bf16 params and compute, student from seed 0, fp teacher from
    seed 1, one batch of ``batch`` x ``seq`` tokens from seed 2 (the same at
    every step), ``TrainConfig(kl_chunk=256)`` (AdamW, lr 2e-5 cosine over 1000
    steps, clip 1.0, remat on). Every launch count is set to 0 before each step
    and read after it. Per step: K4 twice a layer (teacher and student: the
    rematerialized layer reads its saved attention), K10 and K11 once a layer,
    K12 four times a layer (two norms, forward and recompute) and K13 twice a
    layer with ``fused_silu_quant`` (forward and recompute), else never; no
    serving kernel. Fails unless every loss and grad_norm is finite, the last
    loss is below the first and the teacher's tensors are bit-unchanged."""
    from llm_qat_torch.models import params as P
    from llm_qat_torch.training import trainer as T

    L = cfg.num_hidden_layers
    before_gc = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    entry = torch.cuda.memory_allocated()
    tc = T.TrainConfig(kl_chunk=KL_CHUNK)
    student = P.init_params(cfg, seed=0, dtype=torch.bfloat16)
    teacher = P.init_params(cfg.replace(w_bits=32, a_bits=32, kv_bits=32), seed=1,
                            dtype=torch.bfloat16)
    teacher_sums = [t.double().sum().item() for t in T.tree_leaves(teacher)]
    teacher_copy = T.tree_map(torch.clone, teacher)
    tr = T.Trainer(cfg, tc, student, teacher)
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), device="cuda", generator=g)
    data = {"input_ids": ids, "labels": ids}
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L, "rmsnorm_quant": 4 * L,
            "silu_mul_quant": 2 * L if cfg.fused_silu_quant else 0}
    state_bytes = torch.cuda.memory_allocated() - entry   # student, teacher, moments, batch
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times, launches = [], [], [], dict.fromkeys(counters(), 0)
    for i in range(warm + steps):
        for fn in counters().values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(data)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = read_counters()
        if any(got[k] != n for k, n in want.items()) or any(
                n for k, n in got.items() if k not in want):
            raise AssertionError(f"{label} step {i}: launches {got}, expected {want} and no other")
        if not (np.isfinite(loss) and np.isfinite(norm)):
            raise AssertionError(f"{label} step {i}: loss {loss}, grad_norm {norm}")
        losses.append(loss)
        norms.append(norm)
        if i >= warm:
            times.append(dt)
            for k, n in got.items():
                launches[k] += n
    peak = torch.cuda.max_memory_allocated()
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    same = all(torch.equal(a, b) for a, b in zip(T.tree_leaves(teacher),
                                                 T.tree_leaves(teacher_copy)))
    if not same or teacher_sums != [t.double().sum().item() for t in T.tree_leaves(teacher)]:
        raise AssertionError(f"{label}: the teacher's tensors changed")
    del teacher_copy
    step_ms = 1e3 * statistics.median(times)
    res = dict(mode=label, layers=L, hidden_size=cfg.hidden_size, head_dim=cfg.head_dim,
               batch=batch, seq=seq, kl_chunk=KL_CHUNK,
               learning_rate=tc.learning_rate, warmup=warm, steps=steps, losses=losses,
               grad_norms=norms, step_ms=step_ms, step_ms_all=[1e3 * t for t in times],
               tokens_per_s=batch * seq / (step_ms / 1e3), peak_memory_bytes=peak,
               entry_allocated_bytes=entry, entry_before_gc_bytes=before_gc,
               state_bytes=state_bytes,
               step_peak_over_entry_bytes=peak - entry,
               launches_per_step=want, launches=launches, teacher_unchanged=True)
    log(f"  {label}: {L} layers, {batch} x {seq} tokens, lr {tc.learning_rate}: losses "
        + " ".join(f"{x:.3f}" for x in losses) + "; grad norms "
        + " ".join(f"{x:.3f}" for x in norms) + f"; step {step_ms:.1f} ms "
        f"({', '.join(f'{1e3 * t:.1f}' for t in times)}), {res['tokens_per_s']:.0f} tokens/s, "
        f"peak memory {peak / 2 ** 30:.2f} GiB (allocated at entry {before_gc / 2 ** 30:.2f} GiB, "
        f"after gc {entry / 2 ** 30:.2f} GiB; student + teacher + moments + batch "
        f"{state_bytes / 2 ** 30:.2f} GiB; the steps' own peak {(peak - entry) / 2 ** 30:.2f} "
        f"GiB); launches a step {want}; teacher unchanged")
    if profile:
        res["profile"] = profile_kernels(lambda: tr.train_step(data), f"one train step ({label})")
    del tr, student, teacher
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def plain_train_on_gpu():
    """Within the block the training kernels' wrappers are their plain
    versions (the witness of ``train_check``, as ``plain_on_gpu`` is for
    serving)."""
    from llm_qat_torch.ops import flash_attention as FA
    from llm_qat_torch.ops import fused_quant as FQ

    swaps = [(FA, "_flash_fwd", FA._flash_fwd_plain),
             (FA, "_flash_bwd_dq", FA._flash_bwd_dq_plain),
             (FA, "_flash_bwd_dkv", FA._flash_bwd_dkv_plain),
             (FQ, "rmsnorm_quant", FQ._rmsnorm_quant_plain),
             (FQ, "silu_mul_quant", FQ._silu_mul_quant_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


class _KeepGrads:
    """An optimizer that keeps the gradients it is handed and updates
    nothing: ``make_train_step`` with it is one forward and backward."""

    def update(self, grads, state, params):
        self.grads = grads
        return None, state


def _step_grads(cfg, student, teacher, ids, dtype):
    """(loss, grad_norm, gradients) of one KD-QAT step, no update."""
    from llm_qat_torch.training import trainer as T

    keep = _KeepGrads()
    tcfg = cfg.replace(w_bits=32, a_bits=32, kv_bits=32)
    step = T.make_train_step(cfg, tcfg, T.TrainConfig(kl_chunk=KL_CHUNK, compute_dtype=dtype),
                             keep)
    _, m = step(T.TrainState(student, None, 0), teacher, {"input_ids": ids, "labels": ids})
    return float(m["loss"]), float(m["grad_norm"]), keep.grads


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _grad_drift(a, b):
    """(largest per-leaf relative L2 difference of two gradient trees, its
    leaf)."""
    worst = (0.0, "")
    for (name, x), (_, y) in zip(_named_leaves(a), _named_leaves(b)):
        x, y = x.double().cpu(), y.double().cpu()
        worst = max(worst, (float((x - y).norm() / y.norm().clamp_min(1e-30)), name))
    return worst


def train_check(cfg, with_cpu=True):
    """One KD-QAT step (no update) at ``cfg``'s full width on a CUT_LAYERS
    cut, batch 1: the card path with its kernels, the card path with the
    plain versions swapped in (``plain_train_on_gpu``: the witness) and, with
    ``with_cpu``, the port's CPU path, on the same bf16 weights and ids, at 128
    tokens; and the first two at 2048 tokens. Loss, grad_norm and the largest
    per-leaf relative L2 difference of the gradients.

    Kernels against plain versions (the kernels' own share): the two differ
    in fp32 summation orders inside K4, K10, K11 and K12, a bf16 step in some
    attention outputs and gradients, and every projection re-quantizes its
    input to int8, which turns some of those into whole quantization steps.
    Held to TRAIN_CUT_LOSS_REL on the loss and grad_norm and to
    TRAIN_CUT_GRAD_REL on every leaf's gradient, and to no more than
    FULL_DRIFT_OVER x the witness's own drift from the CPU path + these
    limits (the witness shows what the card's library products and reductions
    alone move)."""
    from llm_qat_torch.models import params as P
    from llm_qat_torch.training import trainer as T

    cut = train_cfg_of(cfg, CUT_LAYERS)
    student = P.init_params(cut, seed=0, dtype=torch.bfloat16)
    teacher = P.init_params(cut.replace(w_bits=32, a_bits=32, kv_bits=32), seed=1,
                            dtype=torch.bfloat16)
    out = {}
    for seq in (128, TRAIN_SEQ):
        g = torch.Generator(device="cuda")
        g.manual_seed(3)
        ids = torch.randint(0, cut.vocab_size, (1, seq), device="cuda", generator=g)
        for fn in counters().values():
            fn.launches = 0
        kern = _step_grads(cut, student, teacher, ids, torch.bfloat16)
        used = read_counters()
        with plain_train_on_gpu():
            plain = _step_grads(cut, student, teacher, ids, torch.bfloat16)
        if read_counters() != used:
            raise AssertionError("train_check: the plain run launched a kernel")
        res = dict(seq=seq, loss=kern[0], grad_norm=kern[1], launches=used,
                   loss_rel_vs_plain=abs(kern[0] - plain[0]) / abs(plain[0]),
                   norm_rel_vs_plain=abs(kern[1] - plain[1]) / abs(plain[1]),
                   grad_vs_plain=_grad_drift(kern[2], plain[2]))
        vs_cpu = with_cpu and seq == 128
        if vs_cpu:
            to_cpu = lambda t: t.detach().cpu()  # noqa: E731
            cpu = _step_grads(cut, T.tree_map(to_cpu, student), T.tree_map(to_cpu, teacher),
                              ids.cpu(), torch.bfloat16)
            for name, run in (("kernels", kern), ("plain", plain)):
                res[f"{name}_loss_rel_vs_cpu"] = abs(run[0] - cpu[0]) / abs(cpu[0])
                res[f"{name}_grad_vs_cpu"] = _grad_drift(run[2], cpu[2])
            witness_loss, witness_grad = res["plain_loss_rel_vs_cpu"], res["plain_grad_vs_cpu"][0]
        log(f"  train step on a {CUT_LAYERS}-layer cut of H={cut.hidden_size}, head dim "
            f"{cut.head_dim}, 1 x {seq} tokens: loss {kern[0]:.4f}, "
            f"grad_norm {kern[1]:.4f}; kernels against plain versions on the card: loss "
            f"{res['loss_rel_vs_plain']:.3g}, grad_norm {res['norm_rel_vs_plain']:.3g}, gradients "
            f"{res['grad_vs_plain'][0]:.3g} ({res['grad_vs_plain'][1]})"
            + (f"; against the CPU path: kernels loss {res['kernels_loss_rel_vs_cpu']:.3g}, "
               f"gradients {res['kernels_grad_vs_cpu'][0]:.3g} ({res['kernels_grad_vs_cpu'][1]}); "
               f"plain versions on the card (witness) loss {res['plain_loss_rel_vs_cpu']:.3g}, "
               f"gradients {res['plain_grad_vs_cpu'][0]:.3g} ({res['plain_grad_vs_cpu'][1]})"
               if vs_cpu else "")
            + f" (limits: loss and grad_norm {TRAIN_CUT_LOSS_REL}, gradients "
            f"{TRAIN_CUT_GRAD_REL})")
        L = CUT_LAYERS
        ok = (used["flash_fwd"] == 2 * L and used["flash_bwd_dq"] == L == used["flash_bwd_dkv"]
              and used["rmsnorm_quant"] == 4 * L
              and res["loss_rel_vs_plain"] <= TRAIN_CUT_LOSS_REL
              and res["norm_rel_vs_plain"] <= TRAIN_CUT_LOSS_REL
              and res["grad_vs_plain"][0] <= TRAIN_CUT_GRAD_REL)
        if vs_cpu:
            ok = (ok and res["kernels_loss_rel_vs_cpu"]
                  <= FULL_DRIFT_OVER * witness_loss + TRAIN_CUT_LOSS_REL
                  and res["kernels_grad_vs_cpu"][0]
                  <= FULL_DRIFT_OVER * witness_grad + TRAIN_CUT_GRAD_REL)
        if not ok:
            raise AssertionError(f"train_check: {res}")
        out[f"seq{seq}"] = res
    del student, teacher
    torch.cuda.empty_cache()
    return out


# phase [4i]: OpenLLaMA-3B's KD-QAT training. The flash train rows at its
# attention shape (TRAIN_BATCH sequences x 32 MHA heads, G = 1, head dim 100):
# full lengths and these (full, ragged, 1 and 0)
O3_TRAIN_LENS = (2048,) * 64 + tuple(2048 - 31 * i for i in range(1, 63)) + (1, 0)
O3_TRAIN_SEED = 24                       # the phase's kernel inputs


def openllama3b_train_phase(timer, base):
    """KD-QAT training of OpenLLaMA-3B (``OPENLLAMA_3B``: H 3200, I 8640, 32
    MHA heads of 100, vocabulary 32000, 26 layers) at W4A8KV4, head dim 100
    through the padded builds of K4, K10 and K11. First K4, K10 and K11 at
    its train step's attention shape (B = 128, G = 1, S = TRAIN_SEQ, D = 100,
    bf16; ``flash_train_phase``: full and O3_TRAIN_LENS lengths, each against
    its plain version, K10 and K11 against their second launches bit for bit,
    bounds from the real head dim); then ``train_run`` at full width and
    depth, TRAIN_WARM + TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens
    (every step K4 2L, K10 L, K11 L, K12 4L and nothing else; the loss finite
    and falling, the teacher unchanged; one step profiled); then
    ``train_check`` on a CUT_LAYERS cut of the same width: the kernels against
    their plain versions (no CPU path, as at LLaMA-7B's width). Kernel inputs
    from a generator of its own."""
    from llm_qat_torch.ops import flash_attention as FA

    cfg = base.replace(**OPENLLAMA_3B)
    G, D = cfg.num_attention_heads // cfg.kv_heads, cfg.head_dim
    if not FA.padded(D) or len(O3_TRAIN_LENS) != TRAIN_BATCH * cfg.kv_heads:
        raise AssertionError(f"OpenLLaMA-3B: head dim {D}, {len(O3_TRAIN_LENS)} train lengths")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(O3_TRAIN_SEED)
    flash = flash_train_phase(timer, gen, FA, G, D, O3_TRAIN_LENS)
    torch.cuda.empty_cache()
    run = train_run("OpenLLaMA-3B W4A8KV4 train", train_cfg_of(cfg), TRAIN_STEPS, TRAIN_WARM,
                    profile=True)
    check = train_check(cfg, with_cpu=False)
    return dict(flash=flash, train=run, train_check=check)


def train_phases(cfg, cfg7):
    """The train runs: TinyLlama-1.1B at full depth with the default flags
    (the main path of the training slice: K4, K10, K11, K12), then LLaMA-7B's
    widths (``cfg7``: H=4096, 32 MHA heads of 128, I=11008) cut to
    LLAMA7B_TRAIN_LAYERS layers at LLAMA7B_TRAIN_BATCH x TRAIN_SEQ tokens (K4,
    K10 and K11 at head dim 128, K12 at H=4096), then a
    SILU_LAYERS-layer cut with ``fused_silu_quant`` (K13 twice a layer a step:
    the student's forward and its recompute) beside the same cut with the
    default flags (the former profiled: K13's device time). The two cuts start
    from the same weights and differ in the MLP activation alone (sigmoid in fp32 rounded once, against the model
    type's SiLU, and the kernel's quantization against the fused matmul's):
    their first losses are held within SILU_LOSS_REL of each other."""
    full = train_run("W4A8KV4 train", train_cfg_of(cfg), TRAIN_STEPS, TRAIN_WARM, profile=True)
    l7 = train_run(f"LLaMA-7B width W4A8KV4 train, {LLAMA7B_TRAIN_LAYERS}-layer cut",
                   train_cfg_of(cfg7, LLAMA7B_TRAIN_LAYERS), TRAIN_STEPS, TRAIN_WARM,
                   profile=True, batch=LLAMA7B_TRAIN_BATCH)
    base = train_run(f"W4A8KV4 train, {SILU_LAYERS}-layer cut", train_cfg_of(cfg, SILU_LAYERS),
                     SILU_STEPS, 0, profile=False)
    silu = train_run(f"W4A8KV4 train, {SILU_LAYERS}-layer cut, fused_silu_quant",
                     train_cfg_of(cfg, SILU_LAYERS, fused_silu_quant=True), SILU_STEPS, 0,
                     profile=True)
    rel = abs(silu["losses"][0] - base["losses"][0]) / abs(base["losses"][0])
    log(f"  fused_silu_quant against the default route on the {SILU_LAYERS}-layer cut: first "
        f"losses {silu['losses'][0]:.4f} and {base['losses'][0]:.4f}, {rel:.3g} apart (limit "
        f"{SILU_LOSS_REL})")
    if rel > SILU_LOSS_REL:
        raise AssertionError(f"fused_silu_quant: first loss {rel} from the default route's")
    silu["first_loss_rel_vs_default"] = rel
    return [full, l7, base, silu]


# ---------------------------------------------------------------------------
# the reference's pipeline through the port's entry points
# ---------------------------------------------------------------------------


def id_codec():
    """(detokenize, tokenize): token ids written as decimal text and read
    back. The byte tokenizer cannot spell ids >= 256 of a 32000-token vocab,
    and the card's host has no tokenizer files."""
    return (lambda ids: " ".join(str(int(i)) for i in ids),
            lambda text: [int(t) for t in text.split()])


class _Clock:
    """Accumulates the wall time and the number of calls of functions it
    wraps (``wrap(module, name)``), waiting for the card around each call;
    ``undo()`` puts the originals back."""

    def __init__(self):
        self.s, self.calls, self._saved = {}, {}, []

    def wrap(self, mod, name, key):
        real = getattr(mod, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            self.s[key] = self.s.get(key, 0.0) + time.perf_counter() - t0
            self.calls[key] = self.calls.get(key, 0) + 1
            return out

        self._saved.append((mod, name, real))
        setattr(mod, name, timed)

    def undo(self):
        for mod, name, real in reversed(self._saved):
            setattr(mod, name, real)
        self._saved.clear()


def _same_tree(a, b) -> bool:
    from llm_qat_torch.training import trainer as T
    la, lb = T.tree_leaves(a), T.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(la, lb))


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def resume_check(cfg, layers, steps=PIPE_RESUME_STEPS):
    """Resume at full width on a ``layers``-layer cut: 2 steps, a step
    checkpoint through ``CheckpointManager``, a fresh ``Trainer`` restored
    from it and 2 more steps, against 4 straight steps on the same batches.
    Params and both Adam moments must be bit-equal."""
    from llm_qat_torch.models import params as P
    from llm_qat_torch.training import trainer as T
    from llm_qat_torch.utils.checkpoint import CheckpointManager

    c = train_cfg_of(cfg, layers)
    g = torch.Generator(device="cuda")
    g.manual_seed(PIPE_SEED + 7)
    batches = [torch.randint(0, c.vocab_size, (1, TRAIN_SEQ), device="cuda", generator=g)
               for _ in range(2 * steps)]
    teacher = P.init_params(c.replace(w_bits=32, a_bits=32, kv_bits=32), seed=PIPE_SEED,
                            dtype=torch.bfloat16)

    def trainer():
        return T.Trainer(c, T.TrainConfig(kl_chunk=KL_CHUNK, total_steps=2 * steps),
                         P.init_params(c, seed=PIPE_SEED, dtype=torch.bfloat16), teacher)

    straight = trainer()
    for ids in batches:
        straight.train_step({"input_ids": ids, "labels": ids})
    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        first = trainer()
        for ids in batches[:steps]:
            first.train_step({"input_ids": ids, "labels": ids})
        mngr = CheckpointManager(root)
        t0 = time.perf_counter()
        mngr.save(steps, first.state)
        save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(root)
        del first
        resumed = trainer()
        t0 = time.perf_counter()
        resumed.state = mngr.restore(resumed.state)
        restore_s = time.perf_counter() - t0
        for ids in batches[steps:]:
            resumed.train_step({"input_ids": ids, "labels": ids})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    a, b = straight.state, resumed.state
    same = (a.step == b.step == 2 * steps and a.opt_state["count"] == b.opt_state["count"]
            and _same_tree(a.params, b.params) and _same_tree(a.opt_state["mu"], b.opt_state["mu"])
            and _same_tree(a.opt_state["nu"], b.opt_state["nu"]))
    if not same:
        raise AssertionError(f"resume on the {layers}-layer cut: {steps} + {steps} steps are not "
                             f"bit-equal to {2 * steps} straight steps")
    log(f"  resume, {layers}-layer cut at full width: {steps} steps, save ({nbytes / 1e9:.3f} GB "
        f"in {save_s:.2f} s), restore into a fresh trainer ({restore_s:.2f} s), {steps} more: "
        f"params and moments bit-equal to {2 * steps} straight steps")
    return dict(layers=layers, steps=f"{steps} + {steps}", bit_equal=True, checkpoint_bytes=nbytes,
                save_s=save_s, restore_s=restore_s)


def pipeline_phase(cfg):
    """The reference's workflow (generate_data.py -> merge_gen_data.py ->
    train.py with an HF export) through the port's entry points at
    TinyLlama-1.1B's full width and depth, random N(0, 0.02) weights from
    PIPE_SEED:

    1. the teacher written as an HF directory in bf16
       (``convert.save_hf_checkpoint``) and read back
       (``load_hf_checkpoint``): bit-equal;
    2. ``synthesis.synthesize_shard`` on the card (PIPE_VOCAB start ids x 3
       greedy lengths, batches of PIPE_VOCAB, PIPE_LEN tokens, no EOS cut)
       through the id codec, then ``merge_shards``; no kernel launches (the
       fp teacher's cached path, as in the JAX package);
    3. ``cli.train.run`` on the merged jsonl (also the eval file): W4A8KV4,
       qat + KD, bf16, blocks of 2048, PIPE_STEPS steps, eval; every launch
       count is set to 0 before it and read after: K4, K10, K11 and K12 at
       the counts the steps and the eval forwards give, nothing else; every
       logged loss and the perplexity finite; the HF export equal bit for
       bit to the final step checkpoint's params;
    4. ``resume_check`` on a PIPE_RESUME_LAYERS-layer cut.

    Prints the time of each part, the bytes written, the memory allocated
    at entry and the full-depth TrainState's size from its dtypes."""
    from llm_qat_torch.cli import train as CLI
    from llm_qat_torch.data import synthesis as S
    from llm_qat_torch.models import convert
    from llm_qat_torch.models import params as P
    from llm_qat_torch.training import trainer as T
    from llm_qat_torch.utils import args as A
    from llm_qat_torch.utils import checkpoint as CK

    before_gc = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    entry = torch.cuda.memory_allocated()
    log(f"  allocated at the pipeline's entry {before_gc / 2 ** 30:.2f} GiB, after gc "
        f"{entry / 2 ** 30:.2f} GiB")
    detok, tok = id_codec()
    L = cfg.num_hidden_layers
    root = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    t, nbytes = {}, {}
    try:
        teacher_cfg = cfg.replace(w_bits=32, a_bits=32, kv_bits=32)
        teacher = P.init_params(teacher_cfg, seed=PIPE_SEED, dtype=torch.bfloat16)
        tdir = os.path.join(root, "teacher")
        t0 = time.perf_counter()
        nbytes["teacher"] = convert.save_hf_checkpoint(teacher, teacher_cfg, tdir,
                                                       dtype=torch.bfloat16)
        t["write_teacher_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cfg2, back = convert.load_hf_checkpoint(tdir, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t["read_teacher_s"] = time.perf_counter() - t0
        if not (_same_tree(teacher, back) and cfg2.hidden_size == cfg.hidden_size
                and cfg2.num_hidden_layers == L and cfg2.vocab_size == cfg.vocab_size
                and cfg2.kv_heads == cfg.kv_heads):
            raise AssertionError("pipeline: the teacher read back is not the teacher written")
        del teacher

        for fn in counters().values():
            fn.launches = 0
        gen_dir = os.path.join(root, "gen")
        t0 = time.perf_counter()
        shard = S.synthesize_shard(back, cfg2, 0, gen_dir, detokenize=detok,
                                   n_vocab_per_shard=PIPE_VOCAB, batch_size=PIPE_VOCAB,
                                   total_len=PIPE_LEN, eos_id=None, seed=PIPE_SEED)
        torch.cuda.synchronize()
        t["synthesize_s"] = time.perf_counter() - t0
        merged = S.merge_shards(gen_dir)
        synth_launches = read_counters()
        docs = [json.loads(line)["text"] for line in open(merged)]
        n_docs = len(docs)
        if (n_docs != 3 * PIPE_VOCAB or open(shard).read() != open(merged).read()
                or any(len(tok(d)) != PIPE_LEN for d in docs)
                or any(tok(d)[0] != i % PIPE_VOCAB for i, d in enumerate(docs))
                or any(min(tok(d)) < 0 or max(tok(d)) >= cfg.vocab_size for d in docs)
                or any(synth_launches.values())):
            raise AssertionError(f"pipeline synthesis: {n_docs} documents, launches "
                                 f"{synth_launches}")
        del back
        gc.collect()
        torch.cuda.empty_cache()

        margs = A.ModelArguments(input_model_filename=tdir, output_model_filename="student",
                                 local_dir=os.path.join(root, "local"), w_bits=4, a_bits=8,
                                 kv_bits=4)
        dargs = A.DataArguments(train_data_local_path=merged, eval_data_local_path=merged)
        targs = A.TrainingArguments(output_dir=os.path.join(root, "out"),
                                    model_max_length=TRAIN_SEQ, qat=True, use_kd=True,
                                    bf16=True, max_steps=PIPE_STEPS, do_eval=True)
        clock = _Clock()
        clock.wrap(T.Trainer, "train_step", "train_steps")
        clock.wrap(T.Trainer, "evaluate", "eval")
        clock.wrap(CK.CheckpointManager, "_write", "checkpoint_writes")
        clock.wrap(convert, "save_hf_checkpoint", "export")
        for fn in counters().values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            res = CLI.run(margs, dargs, targs, tokenize=tok)
        finally:
            clock.undo()
        t["train_run_s"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got = read_counters()
        n_eval = (n_docs * PIPE_LEN) // min(TRAIN_SEQ, 1024)
        want = {"flash_fwd": PIPE_STEPS * 2 * L + n_eval * L, "flash_bwd_dq": PIPE_STEPS * L,
                "flash_bwd_dkv": PIPE_STEPS * L,
                "rmsnorm_quant": PIPE_STEPS * 4 * L + n_eval * 2 * L}
        losses = [json.loads(line)["loss"]
                  for line in open(os.path.join(root, "out", "logs", "metrics.jsonl"))]
        if (res["train_steps"] != PIPE_STEPS or len(losses) != PIPE_STEPS
                or not all(np.isfinite(losses)) or not np.isfinite(res["perplexity"])
                or clock.calls.get("eval") != 1):
            raise AssertionError(f"pipeline train: {res}, losses {losses}")
        if any(got[k] != want.get(k, 0) for k in got):
            raise AssertionError(f"pipeline train: launches {got}, expected {want} and no other")
        ckpt = os.path.join(root, "out", "checkpoints", str(PIPE_STEPS), "state.pt")
        final = torch.load(ckpt, map_location="cpu", weights_only=True)["params"]
        _, exported = convert.load_hf_checkpoint(res["model_path"], dtype=torch.bfloat16,
                                                 device="cpu")
        if not _same_tree(final, exported):
            raise AssertionError("pipeline: the HF export is not the trainer's final params")
        nbytes["export"] = _dir_bytes(res["model_path"])
        nbytes["checkpoint"] = os.path.getsize(ckpt)
        # the exported student outlives the phase: eval_phase scores it
        student_dir = tempfile.mkdtemp(prefix="chip_smoke_student_")
        shutil.move(res["model_path"], os.path.join(student_dir, "model"))
        t.update({k: v for k, v in clock.s.items()})
        del final, exported
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    resume = resume_check(cfg, PIPE_RESUME_LAYERS)
    per_layer = (cfg.hidden_size * (cfg.num_attention_heads + 2 * cfg.kv_heads) * cfg.head_dim
                 + cfg.num_attention_heads * cfg.head_dim * cfg.hidden_size
                 + 3 * cfg.hidden_size * cfg.intermediate_size + 2 * cfg.hidden_size)
    n_params = (L * per_layer + cfg.vocab_size * cfg.hidden_size * (1 if cfg.tie_word_embeddings
                                                                    else 2) + cfg.hidden_size)
    state_gb = 3 * 2 * n_params / 1e9       # bf16 params, bf16 first and second moments
    out = dict(layers=L, hidden_size=cfg.hidden_size, vocab=cfg.vocab_size,
               documents=n_docs, doc_tokens=PIPE_LEN, train_steps=PIPE_STEPS, block=TRAIN_SEQ,
               eval_forwards=n_eval, losses=losses, perplexity=res["perplexity"],
               eval_loss=res["eval_loss"], jsonl_reader=res["jsonl_reader"],
               step_time_s=res.get("step_time_s"), times_s=t, bytes=nbytes,
               launches=got, launches_expected=want, synthesis_launches=synth_launches,
               entry_allocated_bytes=entry, entry_before_gc_bytes=before_gc,
               peak_memory_bytes=peak,
               trainstate_bytes_reckoned=state_gb * 1e9, params=n_params, resume=resume,
               student_dir=student_dir)
    log(f"  pipeline at TinyLlama-1.1B, {L} layers: teacher written {nbytes['teacher'] / 1e9:.3f} "
        f"GB bf16 in {t['write_teacher_s']:.2f} s, read back bit-equal in "
        f"{t['read_teacher_s']:.2f} s; {n_docs} documents of {PIPE_LEN} tokens synthesized in "
        f"{t['synthesize_s']:.2f} s (no kernel launch); cli.train.run {t['train_run_s']:.2f} s: "
        f"{PIPE_STEPS} steps {t['train_steps']:.2f} s, losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f", checkpoint writes {t['checkpoint_writes']:.2f} s ({clock.calls['checkpoint_writes']}"
        f" x {nbytes['checkpoint'] / 1e9:.3f} GB), export {t['export']:.2f} s "
        f"({nbytes['export'] / 1e9:.3f} GB f32), eval {t['eval']:.2f} s over {n_eval} forwards, "
        f"perplexity {res['perplexity']:.1f}; launches {got}; peak memory {peak / 2 ** 30:.2f} "
        f"GiB; full-depth TrainState from its dtypes {state_gb:.2f} GB ({n_params} params); "
        f"{res['jsonl_reader']} jsonl reader")
    return out


# ---------------------------------------------------------------------------
# evaluation: zero-shot and perplexity through the eval CLI, beam search,
# the classification head
# ---------------------------------------------------------------------------


def scorer_lens(S, rows=16, kvh=4):
    """Per-(row, kv head) lengths of one zero-shot scorer batch at bucket
    ``S``: ``rows`` right-padded rows, one full and the rest shorter down to
    1, and a padded tail of three empty rows, each repeated for TinyLlama's
    ``kvh`` kv heads (``tests/test_torch_cuda_kernels.py`` holds K4 there too)."""
    lens = [max(1, S - (S // 13 + 1) * i) for i in range(rows - 3)] + [0, 0, 0]
    return [n for n in lens for _ in range(kvh)]


def flash_gate(s: int) -> bool:
    """``llama.backbone``'s flash gate: the forward of ``s`` columns takes K4."""
    return s >= 16 and s % min(128, s) == 0


@contextlib.contextmanager
def plain_everywhere():
    """``plain_on_gpu`` and ``plain_train_on_gpu`` together: the serving and
    the training forward with no hand-written kernel."""
    with plain_on_gpu(), plain_train_on_gpu():
        yield


def write_eval_files(root):
    """One jsonl a task (``zero_shot.random_docs``, EVAL_DOCS each, from
    EVAL_SEED) and a perplexity file of at least EVAL_PPL_BLOCKS blocks of
    EVAL_PPL_BLOCK byte-tokenizer tokens; returns (task dir, perplexity
    file)."""
    from llm_qat_torch.eval import zero_shot as Z

    tdir = os.path.join(root, "tasks")
    os.makedirs(tdir)
    for task in Z.TASK_ADAPTERS:
        with open(os.path.join(tdir, f"{task}.jsonl"), "w") as f:
            for d in Z.random_docs(task, EVAL_DOCS, seed=EVAL_SEED):
                f.write(json.dumps(d) + "\n")
    rng = np.random.default_rng(EVAL_SEED)
    n_docs = 16
    per_doc = -(-EVAL_PPL_BLOCKS * EVAL_PPL_BLOCK // n_docs)          # tokens, BOS included
    ppl = os.path.join(root, "ppl.jsonl")
    with open(ppl, "w") as f:
        for _ in range(n_docs):
            text = "".join(chr(c) for c in rng.choice(list(range(97, 123)) + [32], per_doc - 1))
            f.write(json.dumps({"text": text}) + "\n")
    return tdir, ppl


def eval_cli_run(label, argv, L):
    """``cli.eval.main(argv)`` on the card with every launch count set to 0
    before and read after; times each task and the perplexity, records every
    forward's shape. K4 must have launched L times for each forward whose
    columns pass the flash gate, K12 2L times for each forward (the two norms
    of a layer), and nothing else."""
    from llm_qat_torch.cli import eval as CLI
    from llm_qat_torch.eval import zero_shot as Z
    from llm_qat_torch.models import llama

    shapes, tasks = [], {}
    real_fwd, real_task, real_ppl = llama.forward, Z.evaluate_task, CLI.evaluate_perplexity

    def fwd(params, config, ids, **kw):
        shapes.append(tuple(ids.shape))
        return real_fwd(params, config, ids, **kw)

    def task(params, config, name, docs, tokenize, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_task(params, config, name, docs, tokenize, **kw)
        torch.cuda.synchronize()
        rows = sum(len(Z.TASK_ADAPTERS[name](d, tokenize).choices) for d in docs)
        tasks[name] = dict(s=time.perf_counter() - t0, rows=rows)
        return out

    ppl_s = {}

    def ppl(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_ppl(*a, **kw)
        torch.cuda.synchronize()
        ppl_s["s"] = time.perf_counter() - t0
        return out

    llama.forward, Z.evaluate_task, CLI.evaluate_perplexity = fwd, task, ppl
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        res = CLI.main(argv)
    finally:
        llama.forward, Z.evaluate_task, CLI.evaluate_perplexity = real_fwd, real_task, real_ppl
    wall = time.perf_counter() - t0
    got = read_counters()
    n_flash = sum(flash_gate(s) for _, s in shapes)
    want = {"flash_fwd": L * n_flash, "rmsnorm_quant": 2 * L * len(shapes)}
    if any(got[k] != want.get(k, 0) for k in got) or not got["flash_fwd"]:
        raise AssertionError(f"{label}: launches {got}, expected {want} and no other")
    for name, m in tasks.items():
        r = res[name]
        if r["n"] != EVAL_DOCS or not (0.0 <= r["acc"] <= 1.0 and 0.0 <= r["acc_norm"] <= 1.0):
            raise AssertionError(f"{label} {name}: {r}")
        m.update(acc=r["acc"], acc_norm=r["acc_norm"], rows_per_s=m["rows"] / m["s"])
    out = dict(wall_s=wall, results=res, tasks=tasks, launches=got, launches_expected=want,
               forwards=len(shapes), flash_forwards=n_flash,
               buckets=sorted({s for _, s in shapes}))
    if "perplexity" in res:
        p = res["perplexity"]
        if not (np.isfinite(p["eval_loss"]) and np.isfinite(p["perplexity"])):
            raise AssertionError(f"{label}: perplexity {p}")
        out.update(perplexity=p, perplexity_s=ppl_s["s"])
    log(f"  {label}: {wall:.2f} s, {len(shapes)} forwards ({n_flash} through K4, buckets "
        f"{out['buckets']}); launches {got}"
        + (f"; perplexity {p['perplexity']:.2f} over {EVAL_PPL_BLOCKS} x {EVAL_PPL_BLOCK} "
           f"tokens in {ppl_s['s']:.2f} s" if "perplexity" in res else ""))
    for name, m in tasks.items():
        log(f"    {name:13s} {m['s']:.3f} s, {m['rows']} rows, {m['rows_per_s']:.1f} rows/s, "
            f"acc {m['acc']:.4f} acc_norm {m['acc_norm']:.4f}")
    return out


def score_drift(got, want, n_tok, limit):
    """Summed log-probs ``[examples, choices]`` of two paths: (the largest
    difference a target token, the examples whose argmax parts, ok): ok when
    that difference is within ``limit`` and every parted example's two best
    scores (``want``) lie within ``limit`` times its tokens of each other."""
    fin = np.isfinite(want)
    if not (np.isfinite(got) == fin).all():
        return float("inf"), [], False
    drift = float((np.abs(got[fin] - want[fin]) / np.maximum(n_tok[fin], 1)).max())
    parted = [int(e) for e in np.nonzero(got.argmax(-1) != want.argmax(-1))[0]]
    ties = all(np.diff(np.sort(want[e][fin[e]])[-2:])[0] <= limit * n_tok[e].max()
               for e in parted)
    return drift, parted, drift <= limit and ties


def eval_scores(params, cfg, examples, max_len, plain=False, batch_rows=16):
    from llm_qat_torch.eval import zero_shot as Z
    with plain_everywhere() if plain else contextlib.nullcontext():
        return Z.score_examples(params, cfg, examples, max_len=max_len, batch_rows=batch_rows,
                                return_scores=True)["scores"]


def eval_scorer_check(cfg, params, tokenize):
    """The scorer's summed log-probs with the kernels against the card path
    with the plain versions swapped in: EVAL_CHECK_DOCS docs of every task,
    uncapped and at the EVAL_CAP cap, at full depth (EVAL_FULL_LOGP a target
    token) and on a EVAL_CUT_LAYERS-layer cut (EVAL_CUT_LOGP); then the cut
    against the port's CPU path on the shortest examples (EVAL_CPU_ROWS rows
    at most, capped at EVAL_CPU_LEN tokens; EVAL_CUT_LOGP). An argmax may
    part only where the two best choices lie within the limit times their
    tokens of each other.

    K4 and K12 are held launch by launch in their kernel phases; neither is
    bit-equal to its plain version (fp32 sums in another order; K12's
    integers 1 apart in up to 1%), and the fake-quant forward re-quantizes
    every projection's input, so a code one level off grows layer over
    layer. Probe runs of this check on two sets of weights read 0.0007-0.021
    a token on the cut and 0.021-0.061 at 22 layers (one argmax parted on a
    near tie); the limits are about 4-5x the largest. They are sanity
    bounds on the path as a whole: a random model's log-probs depend little
    on their context, and causal rows never see the columns past their
    length, so what guards K4 at these shapes is the flash phase, launch by
    launch, at the scorer's buckets and ragged lengths."""
    from llm_qat_torch.eval import zero_shot as Z

    exs = [Z.TASK_ADAPTERS[t](d, tokenize) for t in Z.TASK_ADAPTERS
           for d in Z.random_docs(t, EVAL_CHECK_DOCS, seed=EVAL_SEED + 1)]

    def n_tok(examples, cap):
        """Target tokens of every (example, choice) as the scorer counts them."""
        n = np.zeros((len(examples), max(len(e.choices) for e in examples)))
        for i, e in enumerate(examples):
            for c, ch in enumerate(e.choices):
                full = len(ch) if e.ctx_lens is not None else len(e.context) + len(ch)
                ctx = e.ctx_lens[c] if e.ctx_lens is not None else len(e.context)
                L = min(full, cap) if cap else full
                n[i, c] = max(0, L - min(ctx, L))
        return n

    cut_cfg = cfg.replace(num_hidden_layers=EVAL_CUT_LAYERS)
    cut = dict(params, layers={k: v[:EVAL_CUT_LAYERS] for k, v in params["layers"].items()})
    out = {}
    for cap in (None, EVAL_CAP):
        nt = n_tok(exs, cap)
        out["uncapped" if cap is None else f"cap_{cap}"] = r = dict(
            full_vs_plain=score_drift(eval_scores(params, cfg, exs, cap),
                                      eval_scores(params, cfg, exs, cap, plain=True), nt,
                                      EVAL_FULL_LOGP),
            cut_vs_plain=score_drift(eval_scores(cut, cut_cfg, exs, cap),
                                     eval_scores(cut, cut_cfg, exs, cap, plain=True), nt,
                                     EVAL_CUT_LOGP))
    short, rows = [], 0
    for e in sorted(exs, key=lambda e: max(len(e.context) + len(c) for c in e.choices)):
        if rows + len(e.choices) > EVAL_CPU_ROWS:
            break
        short.append(e)
        rows += len(e.choices)
    cut_cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
               for k, v in cut.items()}
    t0 = time.perf_counter()
    on_cpu = eval_scores(cut_cpu, cut_cfg, short, EVAL_CPU_LEN, batch_rows=EVAL_CPU_ROWS)
    cpu_s = time.perf_counter() - t0
    out["cpu"] = dict(cut_vs_cpu=score_drift(
        eval_scores(cut, cut_cfg, short, EVAL_CPU_LEN, batch_rows=EVAL_CPU_ROWS), on_cpu,
        n_tok(short, EVAL_CPU_LEN), EVAL_CUT_LOGP))
    for name, r in out.items():
        log(f"  scorer, {len(short) if name == 'cpu' else len(exs)} examples ({name}): largest "
            "log-prob difference a target token (examples whose argmax parts): "
            + "; ".join(f"{k} {d:.3g} ({len(pt)})" for k, (d, pt, _) in r.items())
            + (f" (CPU path {cpu_s:.1f} s)" if name == "cpu" else ""))
    log(f"  scorer limits: {EVAL_FULL_LOGP} at {cfg.num_hidden_layers} layers, {EVAL_CUT_LOGP} "
        f"at {EVAL_CUT_LAYERS}")
    if not all(ok for r in out.values() for _, _, ok in r.values()):
        raise AssertionError(f"eval scorer: kernels, plain versions and the CPU disagree: {out}")
    return out


def beam_search_run(label, cfg, qparams, prompt, eos_id, plain=False):
    """``beam_generate`` on the card (BEAM_NUM beams, BEAM_NEW tokens): the
    prefill's launches apart from the decode steps', and the decode steps'
    ms each. Each decode step is one ``serving_forward`` of BEAM_NUM rows:
    4 K1/K2 and one K3 a layer; the prefill K4 once a layer."""
    from llm_qat_torch.inference import beam as B
    from llm_qat_torch.inference import model as M

    fns = counters()          # the wrappers themselves: plain_on_gpu swaps the names

    def count():
        return {k: fn.launches for k, fn in fns.items()}

    pre = {}
    real = M.prefill_slot

    def prefill(*a, **kw):
        before = count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        pre["s"] = time.perf_counter() - t0
        pre["launches"] = {k: n - before[k] for k, n in count().items()}
        return out

    M.prefill_slot = prefill
    for fn in fns.values():
        fn.launches = 0
    try:
        with plain_on_gpu() if plain else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, score = B.beam_generate(qparams, cfg, prompt, num_beams=BEAM_NUM,
                                          max_new_tokens=BEAM_NEW, eos_id=eos_id)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        M.prefill_slot = real
    got = count()
    steps = BEAM_NEW - 1
    dec = {k: n - pre["launches"][k] for k, n in got.items()}
    out = dict(mode=label, prompt=len(prompt), eos_id=eos_id, tokens=[int(t) for t in toks],
               score=score, wall_s=wall, prefill_s=pre["s"], decode_steps=steps,
               ms_per_step=1e3 * (wall - pre["s"]) / steps, prefill_launches=pre["launches"],
               decode_launches=dec, launches=got)
    if not plain:
        L = cfg.num_hidden_layers
        gemm_k = "int8_matmul" if cfg.w_bits == 8 else "int4_matmul"
        want = {gemm_k: 4 * L * steps, "decode_attention": L * steps}
        if (any(dec[k] != want.get(k, 0) for k in dec) or pre["launches"]["flash_fwd"] != L
                or any(v for k, v in pre["launches"].items()
                       if k not in ("flash_fwd", gemm_k))):
            raise AssertionError(f"beam {label}: prefill launches {pre['launches']}, decode "
                                 f"{dec}, expected {want} in decode and K4 {L} in prefill")
    if not (0 < len(toks) <= BEAM_NEW and np.isfinite(score)
            and all(0 <= t < cfg.vocab_size for t in toks)):
        raise AssertionError(f"beam {label}: tokens {list(toks)}, score {score}")
    return out


def beam_hold(label, r, p, limit):
    """A beam run with the kernels (``r``) against the same search with the
    plain versions (``p``): the tokens' first difference and the normalized
    scores' relative difference, which must be within ``limit`` whether the
    tokens part or not (where they part, near-equal hypotheses swapped)."""
    first = next((i for i, (a, b) in enumerate(zip(r["tokens"], p["tokens"])) if a != b),
                 None)
    if first is None and len(r["tokens"]) != len(p["tokens"]):
        first = min(len(r["tokens"]), len(p["tokens"]))
    rel = abs(r["score"] - p["score"]) / abs(p["score"])
    log(f"  beam {label}: {r['ms_per_step']:.2f} ms a step over {r['decode_steps']} steps of "
        f"{BEAM_NUM} beams (plain versions {p['ms_per_step']:.2f}), prefill "
        f"{1e3 * r['prefill_s']:.1f} ms; {len(r['tokens'])} tokens, score {r['score']:.5f}; "
        f"against the plain versions: tokens {'equal' if first is None else f'part at {first}'}, "
        f"score {rel:.3g} apart (limit {limit}); launches in decode "
        + str({k: v for k, v in r["decode_launches"].items() if v}))
    return dict(mode=label, first_difference=first, score_rel=rel, limit=limit,
                ok=rel <= limit, plain_ms_per_step=p["ms_per_step"])


def beam_phase(cfg):
    """Beam search at TinyLlama-1.1B's full width and depth on the scan path
    (``use_megakernel=False``: every decode step through K1/K2 and K3), at
    W8A8KV8 and W4A8KV4 (packed cache), prompts of BEAM_PROMPTS tokens, with
    no EOS and with an EOS the free search meets (its best hypothesis's
    third token).

    Held against the same search with the plain versions swapped in
    (``beam_hold``): on a EVAL_CUT_LAYERS-layer cut, where the serving path's
    kernels and plain versions agree to ~1e-6 (``cpu_check``), to
    BEAM_CUT_REL; at full depth, where 22 layers of random weights grow any
    last-bit difference (K4's fp32 sums in the prefill) into percents of the
    logits and the searches part at near ties from the first step, to
    BEAM_SCORE_REL (a probe run of this phase read 5.6e-5 to 0.0117, the
    largest where the tokens parted at step 0). The cut runs come first
    (they warm the path up); the plain hold at full depth takes one search
    a mode: W8 the short prompt without EOS, W4 the long one with it.
    ``num_beams=1`` must give ``InferenceEngine``'s greedy tokens on
    the same path, bit for bit (the same kernels on the same shapes)."""
    from llm_qat_torch.inference import beam as B
    from llm_qat_torch.inference import engine as E
    from llm_qat_torch.inference import quantized as Q
    from llm_qat_torch.models import params as P

    rng = np.random.default_rng(EVAL_SEED + 2)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n))) for n in BEAM_PROMPTS]
    runs, holds, greedy = [], [], {}
    for label, mcfg in (("W8A8KV8", cfg.replace(w_bits=8, a_bits=8, kv_bits=8)),
                        ("W4A8KV4", cfg.replace(w_bits=4, a_bits=8, kv_bits=4,
                                                kv_cache_pack=True))):
        mcfg = mcfg.replace(use_megakernel=False)
        qp = Q.quantize_params(P.init_params(mcfg, seed=EVAL_SEED, dtype=torch.bfloat16), mcfg)
        torch.cuda.empty_cache()
        ccfg = mcfg.replace(num_hidden_layers=EVAL_CUT_LAYERS)
        qcut = cut_layers(qp, EVAL_CUT_LAYERS)
        eos_id = None
        for name in ("", " eos"):
            r = beam_search_run(f"{label} {EVAL_CUT_LAYERS}-layer cut prompt {len(prompts[0])}"
                                + name, ccfg, qcut, prompts[0], eos_id)
            p = beam_search_run(r["mode"] + " plain", ccfg, qcut, prompts[0], eos_id,
                                plain=True)
            holds.append(beam_hold(r["mode"], r, p, BEAM_CUT_REL))
            eos_id = r["tokens"][2]          # the second search ends where the first went
        # the full-depth hold: W8 the short prompt without EOS, W4 the long one with it
        held = (prompts[0], None) if label == "W8A8KV8" else (prompts[1], "eos")
        for prompt in prompts:
            free = beam_search_run(f"{label} prompt {len(prompt)}", mcfg, qp, prompt, None)
            eos = beam_search_run(f"{label} prompt {len(prompt)} eos", mcfg, qp, prompt,
                                  free["tokens"][2])
            runs += [free, eos]
            for r, kind in ((free, None), (eos, "eos")):
                if (prompt, kind) == held:
                    p = beam_search_run(r["mode"] + " plain", mcfg, qp, prompt, r["eos_id"],
                                        plain=True)
                    holds.append(beam_hold(r["mode"], r, p, BEAM_SCORE_REL))
                else:
                    log(f"  beam {r['mode']}: {r['ms_per_step']:.2f} ms a step, prefill "
                        f"{1e3 * r['prefill_s']:.1f} ms; {len(r['tokens'])} tokens, score "
                        f"{r['score']:.5f}")
        # one beam is greedy: the engine's tokens on the same path and cache length
        toks, _ = B.beam_generate(qp, mcfg, prompts[0], num_beams=1, max_new_tokens=BEAM_NEW)
        max_len = 64
        while max_len < len(prompts[0]) + BEAM_NEW + 1:
            max_len *= 2
        eng = E.InferenceEngine(qp, mcfg, max_batch=1, max_len=max_len)
        eng.submit(prompts[0], max_new_tokens=BEAM_NEW)
        want = eng.run()[0].output
        greedy[label] = list(toks) == list(want)
        log(f"  beam {label} num_beams=1 against the engine's greedy tokens: "
            f"{'equal' if greedy[label] else 'DIFFER'} over {BEAM_NEW} tokens")
        del qp, qcut, eng
        torch.cuda.empty_cache()
    if not all(h["ok"] for h in holds) or not all(greedy.values()):
        raise AssertionError(f"beam search: kernels against plain versions {holds}, "
                             f"num_beams=1 against greedy {greedy}")
    return dict(runs=runs, holds=holds, greedy_equal=greedy)


def classify_check(cfg):
    """``classify`` on a right-padded batch (CLS_ROWS rows of 128 tokens, pad
    id 0, lengths down to 9) at W4A8KV4, bf16, from seeded classifier
    params: the kernels (K4, K12) against the plain versions, at full depth
    (relative L2 of the pooled logits <= CLS_FULL_REL) and on a
    EVAL_CUT_LAYERS-layer cut (CLS_CUT_REL): K4 and K12 are not bit-equal to
    their plain versions, and the fake-quant forward grows a code one level
    off (``eval_scorer_check``); a probe run read 0.039 and 0.0073, the
    limits are about 3-4x those."""
    from llm_qat_torch.models import llama

    c = cfg.replace(w_bits=4, a_bits=8, kv_bits=4)
    params = llama.init_classifier_params(c, CLS_LABELS, seed=EVAL_SEED, dtype=torch.bfloat16)
    g = torch.Generator(device="cuda")
    g.manual_seed(EVAL_SEED)
    ids = torch.randint(1, c.vocab_size, (CLS_ROWS, 128), device="cuda", generator=g)
    lens = torch.tensor([128 - 17 * i for i in range(CLS_ROWS)], device="cuda")
    mask = torch.arange(128, device="cuda")[None] < lens[:, None]
    ids = torch.where(mask, ids, torch.zeros_like(ids))
    out = {}
    for depth in (c.num_hidden_layers, EVAL_CUT_LAYERS):
        cc = c.replace(num_hidden_layers=depth)
        pp = dict(params, layers={k: v[:depth] for k, v in params["layers"].items()})
        for fn in counters().values():
            fn.launches = 0
        with torch.no_grad():
            got = llama.classify(pp, cc, ids, pad_token_id=0, attention_mask=mask.int(),
                                 dtype=torch.bfloat16)
            launches = read_counters()
            with plain_everywhere():
                want = llama.classify(pp, cc, ids, pad_token_id=0, attention_mask=mask.int(),
                                      dtype=torch.bfloat16)
        rel = float((got - want).norm() / want.norm())
        lim = CLS_FULL_REL if depth == c.num_hidden_layers else CLS_CUT_REL
        ok = (bool(torch.isfinite(got).all()) and tuple(got.shape) == (CLS_ROWS, CLS_LABELS)
              and rel <= lim and launches["flash_fwd"] == depth
              and launches["rmsnorm_quant"] == 2 * depth)
        out[depth] = dict(rel_l2=rel, limit=lim, launches={k: v for k, v in launches.items() if v})
        log(f"  classify {depth} layers, {CLS_ROWS} right-padded rows: pooled logits "
            f"{tuple(got.shape)}, kernels against plain versions rel L2 {rel:.3g} (limit {lim}); "
            f"launches {out[depth]['launches']}")
        if not ok:
            raise AssertionError(f"classify at {depth} layers: {out[depth]}")
    return out


def eval_phase(cfg, model_dir=None):
    """The paper's deliverable, scoring, through the port's entry points at
    TinyLlama-1.1B's full width and depth (22 layers, H 2048, 32/4 heads):

    (a) ``cli.eval.main`` on the card at W4A8KV4 in bf16 with the byte
        tokenizer, on the HF checkpoint in ``model_dir`` (``pipeline_phase``'s
        exported student) or, without one, seeded random weights written as
        one: all eight tasks (EVAL_DOCS seeded docs each in the task's field
        layout) and a perplexity file of EVAL_PPL_BLOCKS blocks of
        EVAL_PPL_BLOCK; then EVAL_CAP_TASKS capped at EVAL_CAP tokens (no
        multiple of 64: K4's tiles straddle the edge). Launch counts checked
        per forward (``eval_cli_run``); the scorer held against the plain
        versions and the CPU path (``eval_scorer_check``);
    (b) ``beam_phase``; (c) ``classify_check``."""
    from llm_qat_torch.data.dataset import load_tokenizer
    from llm_qat_torch.eval import zero_shot as Z
    from llm_qat_torch.models import convert
    from llm_qat_torch.models import params as P

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    L = cfg.num_hidden_layers
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        t0 = time.perf_counter()
        if model_dir is None:
            model_dir = os.path.join(root, "model")
            c = cfg.replace(w_bits=4, a_bits=8, kv_bits=4)
            convert.save_hf_checkpoint(P.init_params(c, seed=EVAL_SEED, dtype=torch.bfloat16),
                                       c, model_dir, dtype=torch.bfloat16)
            source = "seeded random weights"
        else:
            source = "the pipeline's exported student"
        times = {"write_model_s": time.perf_counter() - t0}
        tdir, ppl = write_eval_files(root)
        bits = ["--w_bits", "4", "--a_bits", "8", "--kv_bits", "4"]
        common = ["--model", model_dir, "--tokenizer", "byte", *bits, "--task_dir", tdir,
                  "--bf16", "true"]
        t0 = time.perf_counter()
        full = eval_cli_run("eval CLI, 8 tasks + perplexity", common + [
            "--tasks", ",".join(Z.TASK_ADAPTERS), "--perplexity_data", ppl,
            "--block_size", str(EVAL_PPL_BLOCK), "--output_json", os.path.join(root, "out.json")],
            L)
        capped = eval_cli_run(f"eval CLI capped at {EVAL_CAP}", common + [
            "--tasks", ",".join(EVAL_CAP_TASKS), "--max_len", str(EVAL_CAP)], L)
        if EVAL_CAP not in capped["buckets"]:
            raise AssertionError(f"capped run: buckets {capped['buckets']}")
        if json.load(open(os.path.join(root, "out.json"))) != full["results"]:
            raise AssertionError("eval CLI: output_json differs from the results returned")
        c, params = convert.load_hf_checkpoint(model_dir, dtype=torch.bfloat16, w_bits=4,
                                               a_bits=8, kv_bits=4)
        times["cli_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        scorer = eval_scorer_check(c, params, load_tokenizer("byte")[1])
        times["scorer_check_s"] = time.perf_counter() - t0
        del params
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    beams = beam_phase(cfg)
    times["beam_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cls = classify_check(cfg)
    times["classify_s"] = time.perf_counter() - t0
    launches = {k: full["launches"][k] + capped["launches"][k]
                + sum(r["launches"][k] for r in beams["runs"]) for k in counters()}
    out = dict(model=source, zero_shot=full, capped=capped, scorer=scorer, beam=beams,
               classify=cls, launches=launches, times_s=times,
               phase_s=time.perf_counter() - t_phase)
    log(f"  eval phase {out['phase_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in times.items()) + f"); launches {launches}")
    return out


# ---------------------------------------------------------------------------
# multi-device training: two ranks on the one card
# ---------------------------------------------------------------------------

MD_BATCH, MD_SEQ = 4, 2048            # FSDP: the global batch, 2 x 2048 tokens a rank
MD_CP_BATCH, MD_CP_SEQ = 2, 4096      # CP: 2 x 4096 tokens, 2048 a rank
MD_WARM, MD_STEPS = 1, 2              # FSDP: warm-up and timed steps
# the FSDP and CP runs' depth: a cut of TinyLlama-1.1B at its full width (at
# full depth the steps take 13-25 s and 5-11 s each over the host's
# transport; the cut launches every kernel the full depth does)
MD_LAYERS = 2
MD_CP_WARM, MD_CP_STEPS = 1, 1        # CP, each transport
# the 2-layer f32 cuts against one device: (mode, quantized, batch, seq). The
# cp layer takes the unfused norm and quant (as the JAX package's does), so
# its quantized cut is held against one device on that route too
# (fused_norm_quant off), at the CPU tests' 32 rows: the ring's merge moves
# attention outputs by their last bits, and over hundreds of rows that flips
# 4-bit K/V and int8 activation codes (the flip class of ROADMAP.md section 3,
# which an fp model cannot meet). The fp cut holds the merge alone at 2048
# tokens.
MD_CUTS = (("fsdp", True, 2, 256), ("cp", True, 1, 32), ("cp", False, 1, 2048))
MD_CLI_SEQ = 256                      # the NCCL world-1 CLI step's blocks
MD_CUT_LR = 1e-3                      # their learning rate (the CPU tests')
MD_SEED = 13                          # the phase's weights and tokens
MD_TIMEOUT = 900                      # seconds a spawn of ranks may take
MD_TRANSPORT = ("gloo, CUDA tensors staged through host memory: two ranks share the one "
                "H100, which NCCL refuses (duplicate GPU)")


_CAUSAL_AT = {"_flash_fwd": 4, "_flash_bwd_dq": 7, "_flash_bwd_dkv": 7}   # its position


def _causal(name, a, kw) -> bool:
    return kw.get("causal", a[_CAUSAL_AT[name]] if len(a) > _CAUSAL_AT[name] else True)


def md_counts(causal_of, fn):
    """Wrap ``FA.<fn>`` so each call tallies its ``causal`` flag into
    ``causal_of[fn]``. The wrapped function counts its launches on the
    module's attribute, the wrapper, where ``read_counters`` reads them."""
    from llm_qat_torch.ops import flash_attention as FA

    real = getattr(FA, fn)

    def counted(*a, **kw):
        causal_of[fn]["causal" if _causal(fn, a, kw) else "non_causal"] += 1
        return real(*a, **kw)

    counted.launches = 0
    setattr(FA, fn, counted)
    return real


def md_hold_noncausal(holds):
    """Wrap K4, K10 and K11 so every non-causal launch is held against its
    plain version on the same inputs (``agreement``, the K3/K4 limit);
    returns an undo."""
    from llm_qat_torch.ops import flash_attention as FA

    reals = {n: getattr(FA, n) for n in ("_flash_fwd", "_flash_bwd_dq", "_flash_bwd_dkv")}
    plains = {"_flash_fwd": FA._flash_fwd_plain, "_flash_bwd_dq": FA._flash_bwd_dq_plain,
              "_flash_bwd_dkv": FA._flash_bwd_dkv_plain}

    # what is held of each: the forward's O (its log-sum-exp feeds the
    # backward), dQ, dK and dV
    parts = {"_flash_fwd": lambda o: o[:1], "_flash_bwd_dq": lambda o: (o,),
             "_flash_bwd_dkv": lambda o: o}

    def held(name):
        def fn(*a, **kw):
            out = reals[name](*a, **kw)
            if not _causal(name, a, kw):
                want = plains[name](*a, **kw)
                h = holds.setdefault(name, {"launches": 0, "agreements": []})
                h["launches"] += 1
                h["agreements"] += [agreement(g, w, ATTN_ULPS, ATTN_FLOOR)
                                    for g, w in zip(parts[name](out), parts[name](want))]
            return out
        fn.launches = 0
        return fn

    for n in reals:
        setattr(FA, n, held(n))
    return lambda: [setattr(FA, n, f) for n, f in reals.items()]


def _md_whole_bytes(tree, specs, mesh) -> int:
    """The bytes one device holds of a tree of which a rank holds its shards:
    each leaf's times the ranks of every axis its spec splits."""
    from llm_qat_torch.parallel import mesh as pmesh
    out = []
    pmesh.map_specs(lambda t, sp: out.append(t.numel() * t.element_size() * math.prod(
        pmesh.axis_size(mesh, a) for a in pmesh.split_axes(sp))), tree, specs)
    return sum(out)


def _md_bytes(tree) -> int:
    from llm_qat_torch.training import trainer as T
    return sum(t.numel() * t.element_size() for t in T.tree_leaves(tree))


def _md_cut(rank, cfg, mesh, parallel, quantized, b, s):
    """One step of the 2-layer f32 cut (W4A8KV4, or an fp student with
    ``quantized`` False) through ``Trainer(mesh=, parallel=)`` on a global
    batch of ``b`` x ``s`` tokens; rank 0 also takes the single-device step
    and holds the two at the CPU tests' limits (loss and grad_norm 1e-4
    relative, params within 2.1 lr and 1e-3 lr + 1e-6 |p| for 99.9% of each
    leaf)."""
    from llm_qat_torch.models import params as P
    from llm_qat_torch.parallel import mesh as pmesh
    from llm_qat_torch.training import trainer as T

    tcut = train_cfg_of(cfg, CUT_LAYERS).replace(w_bits=32, a_bits=32, kv_bits=32)
    cut = train_cfg_of(cfg, CUT_LAYERS, fused_norm_quant=parallel != "cp") if quantized else tcut
    g = torch.Generator(device="cuda")
    g.manual_seed(MD_SEED + 1)
    ids = torch.randint(0, cut.vocab_size, (b, s), device="cuda", generator=g)
    batch = {"input_ids": ids, "labels": ids}
    tc = T.TrainConfig(learning_rate=MD_CUT_LR, total_steps=20, compute_dtype=torch.float32,
                       kl_chunk=KL_CHUNK)

    def trainer(mesh_):
        return T.Trainer(cut, tc, P.init_params(cut, seed=MD_SEED),
                         P.init_params(tcut, seed=MD_SEED + 2),
                         teacher_cfg=tcut, mesh=mesh_, parallel=parallel if mesh_ else "fsdp")

    tr = trainer(mesh)
    m = tr.train_step(batch)
    got = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    whole = pmesh.gather_params(tr.state.params, mesh, tr.param_specs)
    del tr
    if rank != 0:
        return got
    one = trainer(None)
    m1 = one.train_step(batch)
    want = dict(loss=float(m1["loss"]), grad_norm=float(m1["grad_norm"]))
    worst_tight, worst_max = 1.0, 0.0
    for (name, a), (_, w) in zip(_named_leaves(whole), _named_leaves(one.state.params)):
        a, w = a.detach(), w.detach()
        d = (a - w).abs()
        worst_max = max(worst_max, float(d.max()) / MD_CUT_LR)
        worst_tight = min(worst_tight, float((d <= 1e-3 * MD_CUT_LR + 1e-6 * w.abs())
                                             .float().mean()))
    res = dict(parallel=parallel, quantized=quantized, batch=b, seq=s, mesh=got, one_device=want,
               loss_rel=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
               grad_norm_rel=abs(got["grad_norm"] - want["grad_norm"]) / abs(want["grad_norm"]),
               params_max_over_lr=worst_max, params_tight_share=worst_tight)
    res["ok"] = (res["loss_rel"] <= 1e-4 and res["grad_norm_rel"] <= 1e-4
                 and worst_max <= 2.1 and worst_tight >= 0.999)
    del one, whole
    return res


def _md_run(rank, label, cfg, mesh, parallel, warm, steps, batch, seq, want, tc_kw,
            hold=False):
    """KD-QAT steps of ``cfg`` (bf16, the train recipe) through
    ``Trainer(mesh=, parallel=)`` on a global batch of ``batch`` x ``seq``
    tokens. Every count is set to 0 before each step and read after it: the
    launches and K4/K10/K11's causal and non-causal calls must be ``want``.
    With ``hold``, one more step holds every non-causal launch against its
    plain version."""
    from llm_qat_torch.models import params as P
    from llm_qat_torch.training import trainer as T

    gc.collect()
    torch.cuda.empty_cache()
    entry = torch.cuda.memory_allocated()
    tc = T.TrainConfig(kl_chunk=KL_CHUNK, **tc_kw)
    tr = T.Trainer(cfg, tc, P.init_params(cfg, seed=MD_SEED, dtype=torch.bfloat16),
                   P.init_params(cfg.replace(w_bits=32, a_bits=32, kv_bits=32), seed=MD_SEED + 2,
                                 dtype=torch.bfloat16), mesh=mesh, parallel=parallel)
    st = tr.state
    held = dict(params=_md_bytes(st.params), moments=_md_bytes(st.opt_state["mu"])
                + _md_bytes(st.opt_state["nu"]), teacher=_md_bytes(tr.teacher_params))
    # one device holds every leaf whole: a split leaf's shard times the ranks
    whole_params = _md_whole_bytes(st.params, tr.param_specs, mesh)
    one_device = dict(params=whole_params, moments=2 * whole_params, teacher=whole_params)
    g = torch.Generator(device="cuda")
    g.manual_seed(MD_SEED + 3)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), device="cuda", generator=g)
    data = {"input_ids": ids, "labels": ids}
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times = [], [], []
    causal_of = {n: {"causal": 0, "non_causal": 0}
                 for n in ("_flash_fwd", "_flash_bwd_dq", "_flash_bwd_dkv")}
    reals = {n: md_counts(causal_of, n) for n in causal_of}
    from llm_qat_torch.ops import flash_attention as FA
    try:
        for i in range(warm + steps):
            for fn in counters().values():
                fn.launches = 0
            for c in causal_of.values():
                c.update(causal=0, non_causal=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(data)
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = {k: n for k, n in read_counters().items() if n}
            got.update({f"{n}_{k}": c[k] for n, c in causal_of.items() for k in c if c[k]})
            if got != want:
                raise AssertionError(f"{label} rank {rank} step {i}: launches {got}, expected "
                                     f"{want}")
            if not (np.isfinite(loss) and np.isfinite(norm)):
                raise AssertionError(f"{label} step {i}: loss {loss}, grad_norm {norm}")
            losses.append(loss)
            norms.append(norm)
            if i >= warm:
                times.append(dt)
    finally:
        for n, f in reals.items():
            setattr(FA, n, f)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    log(f"  rank {rank}, {label}: losses {[round(x, 4) for x in losses]}, step "
        f"{1e3 * statistics.median(times):.0f} ms")
    res = dict(mode=label, rank=rank, layers=cfg.num_hidden_layers, batch=batch, seq=seq,
               losses=losses, grad_norms=norms, step_s=statistics.median(times),
               step_s_all=times, launches_per_step=want, held_bytes=held,
               one_device_bytes=one_device,
               peak_memory_bytes=torch.cuda.max_memory_allocated(), entry_allocated_bytes=entry)
    if hold:
        holds = {}
        undo = md_hold_noncausal(holds)
        try:
            tr.train_step(data)
        finally:
            undo()
        torch.cuda.synchronize()
        res["noncausal_holds"] = {
            n: dict(launches=h["launches"], ok=all(a["ok"] for a in h["agreements"]),
                    max_abs_err=max(a["max_abs_err"] for a in h["agreements"]),
                    worst=max(a["worst"] for a in h["agreements"])) for n, h in holds.items()}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _md_transport(cfg, mesh):
    """Seconds (median of 3) of one all-gather, reduce-scatter and all-reduce
    over 'fsdp' of a bf16 tensor the size of one layer's shard at ``cfg``'s
    widths, the collectives an FSDP step issues per layer."""
    from llm_qat_torch.parallel import comm
    from llm_qat_torch.parallel import mesh as pmesh

    c, n = cfg, pmesh.axis_size(mesh, "fsdp")
    per_layer = c.hidden_size * (2 * c.num_attention_heads * c.head_dim
                                 + 2 * c.kv_heads * c.head_dim + 3 * c.intermediate_size)
    x = torch.ones(per_layer // n, dtype=torch.bfloat16, device="cuda")
    group = pmesh.axis_group(mesh, "fsdp")
    out = {"shard_bytes": x.numel() * 2}
    for name, fn in (("all_gather_s", lambda: comm.all_gather(x, 0, group)),
                     ("reduce_scatter_s", lambda: comm.reduce_scatter(
                         torch.ones(per_layer, dtype=torch.bfloat16, device="cuda"), 0, group)),
                     ("all_reduce_s", lambda: comm.all_reduce_(x.clone(), group))):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = statistics.median(times)
    return out


def _md_rank(rank, world, cfg):
    """Rank ``rank`` of the two: the 2-layer cuts (FSDP, then CP), FSDP at
    full depth, then CP at full depth with each transport."""
    from llm_qat_torch.parallel import mesh as pmesh
    from llm_qat_torch.parallel.ring_attention import ring_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fsdp = pmesh.make_mesh(data=1, fsdp=2, device_type="cuda")
    cp = pmesh.make_mesh(data=1, fsdp=1, cp=2, device_type="cuda")
    out = {"transport": _md_transport(cfg, fsdp),
           "cuts": [_md_cut(rank, cfg, fsdp if m == "fsdp" else cp, m, q, b, s)
                    for m, q, b, s in MD_CUTS]}
    L = MD_LAYERS
    full = train_cfg_of(cfg, MD_LAYERS)
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L, "rmsnorm_quant": 4 * L,
            "_flash_fwd_causal": 2 * L, "_flash_bwd_dq_causal": L, "_flash_bwd_dkv_causal": L}
    out["fsdp"] = _md_run(rank, "FSDP fsdp=2", full, fsdp, "fsdp", MD_WARM, MD_STEPS,
                          MD_BATCH, MD_SEQ, want, {})
    # the ring's schedule on this rank: per layer 3 ring forwards a step
    # (teacher, student, the student's recompute) and one backward, each a
    # causal launch and, on rank 1 of 2, one non-causal
    live = sum(lv for lv, causal in ring_steps(2, rank) if not causal)
    want = {"flash_fwd": 3 * L * (1 + live), "flash_bwd_dq": L * (1 + live),
            "flash_bwd_dkv": L * (1 + live), "_flash_fwd_causal": 3 * L,
            "_flash_bwd_dq_causal": L, "_flash_bwd_dkv_causal": L}
    if live:
        want.update(_flash_fwd_non_causal=3 * L * live, _flash_bwd_dq_non_causal=L * live,
                    _flash_bwd_dkv_non_causal=L * live)
    for bits in (None, 8):
        out[f"cp_transport_{bits}"] = _md_run(
            rank, f"CP cp=2, ring transport {bits}", full, cp, "cp", MD_CP_WARM, MD_CP_STEPS,
            MD_CP_BATCH, MD_CP_SEQ, want, dict(ring_transport_bits=bits), hold=bits is None)
    return out


def write_cli_root(cfg, root, seed):
    """A CUT_LAYERS-layer cut of ``cfg`` as a bf16 HF teacher checkpoint
    (``root/teacher``) and 24 documents of 2 x MD_CLI_SEQ letters
    (``root/train.jsonl``), for the train CLI's runs."""
    from llm_qat_torch.models import convert
    from llm_qat_torch.models import params as P

    cut = train_cfg_of(cfg, CUT_LAYERS).replace(w_bits=32, a_bits=32, kv_bits=32)
    convert.save_hf_checkpoint(P.init_params(cut, seed=seed, dtype=torch.bfloat16), cut,
                               os.path.join(root, "teacher"), dtype=torch.bfloat16)
    rng = np.random.default_rng(seed)
    with open(os.path.join(root, "train.jsonl"), "w") as f:
        for _ in range(24):
            f.write(json.dumps({"text": "".join(chr(97 + c) for c in
                                                rng.integers(0, 26, 2 * MD_CLI_SEQ))}) + "\n")


def _md_nccl_rank(rank, world, root):
    """One step through ``train_torch.py``'s entry (``cli.train.main``) with
    the process group NCCL at world 1: the mesh path at fsdp = 1."""
    from llm_qat_torch.cli import train as CLI

    torch.backends.cuda.matmul.allow_tf32 = False
    for fn in counters().values():
        fn.launches = 0
    res = CLI.main(["--input_model_filename", os.path.join(root, "teacher"),
                    "--tokenizer", "byte", "--train_data_local_path",
                    os.path.join(root, "train.jsonl"), "--eval_data_local_path",
                    os.path.join(root, "train.jsonl"), "--output_dir", os.path.join(root, "out"),
                    "--local_dir", root, "--model_max_length", str(MD_CLI_SEQ), "--qat", "true",
                    "--use_kd", "true", "--w_bits", "4", "--a_bits", "8", "--kv_bits", "4",
                    "--max_steps", "1", "--do_eval", "false", "--mesh_fsdp", "1"])
    import torch.distributed as dist
    res["backend"] = dist.get_backend()
    res["launches"] = {k: n for k, n in read_counters().items() if n}
    return res


def flash_ring_phase(timer, gen, FA, B=8, G=8, S=2048, D=64, causal=False,
                     label="the ring's shape"):
    """K4, K10 and K11 at full lengths at one shape, by default non-causal at
    the ring's (a live ring step of the CP phase: 2 sequences x 4 kv heads, 8
    query heads a kv head, a 2048-token chunk, head dim 64, bf16), against
    their plain versions (the K3/K4 limit) and timed beside them and beside
    SDPA of the same causality (forward; the backward of one call, dQ, dK and
    dV together, for K10 and K11)."""
    q, do = (torch.randn(B, G, S, D, device="cuda", generator=gen).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
    o, lse = FA._flash_fwd(q, k, v, lens, causal=causal)
    o2, _ = FA._flash_fwd_plain(q, k, v, lens, causal=causal)
    delta = FA._delta(o, do)
    args = (q, k, v, lens, lse, delta, do)
    dq = FA._flash_bwd_dq(*args, causal=causal)
    dk, dv = FA._flash_bwd_dkv(*args, causal=causal)
    dq2 = FA._flash_bwd_dq_plain(*args, causal=causal)
    dk2, dv2 = FA._flash_bwd_dkv_plain(*args, causal=causal)
    torch.cuda.synchronize()
    agr = {"fwd": agreement(o, o2, ATTN_ULPS, ATTN_FLOOR),
           "dq": agreement(dq, dq2, ATTN_ULPS, ATTN_FLOOR),
           "dk": agreement(dk, dk2, ATTN_ULPS, ATTN_FLOOR),
           "dv": agreement(dv, dv2, ATTN_ULPS, ATTN_FLOOR)}
    if not all(a["ok"] for a in agr.values()):
        raise AssertionError(f"flash at {label}: {agr}")
    del o2, dq2, dk2, dv2
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kh, vh = k[:, None], v[:, None]
    lib_fwd = timer(lambda: sdpa(q, kh, vh, is_causal=causal, enable_gqa=True))
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, kh, vh))
    out = sdpa(ql, kl, vl, is_causal=causal, enable_gqa=True)
    lib_bwd = timer(lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True))
    del out, ql, kl, vl
    ms = {"fwd": timer(lambda: FA._flash_fwd(q, k, v, lens, causal=causal)),
          "dq": timer(lambda: FA._flash_bwd_dq(*args, causal=causal)),
          "dkv": timer(lambda: FA._flash_bwd_dkv(*args, causal=causal))}
    plain = {"fwd": timer(lambda: FA._flash_fwd_plain(q, k, v, lens, causal=causal), reps=3),
             "dq": timer(lambda: FA._flash_bwd_dq_plain(*args, causal=causal), reps=3),
             "dkv": timer(lambda: FA._flash_bwd_dkv_plain(*args, causal=causal), reps=3)}
    pairs = G * live_pairs((S,) * B, S, causal=causal)
    qb, kvb, rowb = 2 * B * G * S * D, 2 * B * S * D, 4 * B * G * S
    bounds = {"fwd": bound(2 * qb + 2 * kvb + rowb, 2 * 2 * pairs * D, BF16_FLOPS),
              "dq": bound(3 * qb + 2 * kvb + 2 * rowb, 3 * 2 * pairs * D, BF16_FLOPS),
              "dkv": bound(2 * qb + 4 * kvb + 2 * rowb, 4 * 2 * pairs * D, BF16_FLOPS)}
    lib = {"fwd": lib_fwd, "dq": lib_bwd, "dkv": lib_bwd}
    errs = {"fwd": agr["fwd"]["max_abs_err"], "dq": agr["dq"]["max_abs_err"],
            "dkv": max(agr["dk"]["max_abs_err"], agr["dv"]["max_abs_err"])}
    kind = "causal" if causal else "non-causal"
    rows = {key: dict(B=B, G=G, S=S, D=D, causal=causal, lengths="full", live_pairs=pairs,
                      ms=ms[key], plain_ms=plain[key], library_ms=lib[key],
                      library_is=f"sdpa {kind}" + (" backward, dQ+dK+dV together"
                                                   if key != "fwd" else ""),
                      bound_ms=bounds[key][0], bound_by=bounds[key][1], max_abs_err=errs[key],
                      worst=max(a["worst"] for n, a in agr.items()
                                if n == key or (key == "dkv" and n in ("dk", "dv"))))
            for key in ms}
    for key, r in rows.items():
        log(f"  flash {key} {kind} at {label} B={B} G={G} S={S} D={D}: "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.2f}, {r['library_is']} {r['library_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} {r['bound_by']}), max_abs_err {r['max_abs_err']:.3g}, "
            f"worst {r['worst']:.3g} of its limit")
    return rows


def multi_device_phase(cfg):
    """KD-QAT training over a mesh of two ranks on the one H100, spawned by
    ``parallel.launch`` over gloo (``MD_TRANSPORT``), at TinyLlama-1.1B's full
    width on an MD_LAYERS-layer cut, the train recipe (W4A8KV4, bf16,
    ``kl_chunk=256``, remat):

    * FSDP (data = 1, fsdp = 2): MD_BATCH x MD_SEQ tokens a step (half a
      rank), MD_WARM + MD_STEPS steps; every step launches K4 2L, K10 L,
      K11 L and K12 4L times a rank, all causal; each rank's held bytes of
      params, moments and teacher beside the single-device figure;
    * CP (cp = 2): MD_CP_BATCH x MD_CP_SEQ tokens (a 2048-token chunk a rank),
      MD_CP_WARM + MD_CP_STEPS steps with the ring's transport in bf16 and
      in int8; each step's causal and non-causal K4/K10/K11 launches as the
      ring's schedule counts them; one more step holds every non-causal
      launch against its plain version;
    * a 2-layer f32 cut of each mode against the single-device step on the
      same global batch (``_md_cut``);
    * K4/K10/K11 non-causal at the ring's shape against their plain versions
      and timed (``flash_ring_phase``);
    * one step of ``train_torch.py``'s entry with NCCL at world 1
      (``_md_nccl_rank``, a 2-layer cut written as an HF checkpoint).

    Losses must be finite and fall. The ranks share the card and exchange
    through host memory: their step times are printed as such and are no
    scaling figure."""
    from llm_qat_torch.ops import flash_attention as FA
    from llm_qat_torch.parallel import launch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(MD_SEED)
    ring = flash_ring_phase(Timer(), gen, FA)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.spawn(_md_rank, 2, backend="gloo", device="cuda", args=(cfg,),
                         timeout=MD_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    tr = ranks[0]["transport"]
    log(f"  transport ({MD_TRANSPORT}), one layer's bf16 shard of {tr['shard_bytes'] / 1e6:.1f} "
        f"MB between the two ranks: all-gather {tr['all_gather_s']:.3f} s, reduce-scatter "
        f"{tr['reduce_scatter_s']:.3f} s (of the whole layer), all-reduce {tr['all_reduce_s']:.3f} s")
    cuts = ranks[0]["cuts"]
    for c in cuts:
        m = f"{c['parallel']} {'W4A8KV4' if c['quantized'] else 'fp'}"
        log(f"  {m} {CUT_LAYERS}-layer f32 cut at full width, {c['batch']} x {c['seq']} tokens, "
            f"one step against one device: loss {c['loss_rel']:.3g}, grad_norm "
            f"{c['grad_norm_rel']:.3g} relative, params at most {c['params_max_over_lr']:.3g} lr "
            f"apart, {100 * c['params_tight_share']:.3f}% within 1e-3 lr + 1e-6 |p| (limits: "
            f"1e-4, 1e-4, 2.1 lr, 99.9%)")
        if not c["ok"]:
            raise AssertionError(f"multi-device {m} cut against one device: {c}")
    for key in ("fsdp", "cp_transport_None", "cp_transport_8"):
        for r in (x[key] for x in ranks):
            h, one = r["held_bytes"], r["one_device_bytes"]
            log(f"  {r['mode']} rank {r['rank']}: {r['layers']} layers, {r['batch']} x {r['seq']} tokens "
                f"a step (global): losses " + " ".join(f"{x:.3f}" for x in r["losses"])
                + "; grad norms " + " ".join(f"{x:.3f}" for x in r["grad_norms"])
                + f"; step {1e3 * r['step_s']:.0f} ms on a card shared by two ranks ({MD_TRANSPORT};"
                f" no scaling figure); held: params {h['params'] / 1e9:.3f} GB, moments "
                f"{h['moments'] / 1e9:.3f} GB, teacher {h['teacher'] / 1e9:.3f} GB (one device: "
                f"{one['params'] / 1e9:.3f}, {one['moments'] / 1e9:.3f}, "
                f"{one['teacher'] / 1e9:.3f} GB); peak memory {r['peak_memory_bytes'] / 2 ** 30:.2f} GiB; launches a step "
                f"{r['launches_per_step']}")
        if key == "fsdp":
            h, one = ranks[0][key]["held_bytes"], ranks[0][key]["one_device_bytes"]
            # half of every split leaf, the replicated norm gains whole
            if not (one["params"] / 2 < h["params"] < 0.51 * one["params"]
                    and h["moments"] == 2 * h["params"]):
                raise AssertionError(f"FSDP rank 0 holds {h}, one device {one}")
    for r in ranks:
        for n, h in r["cp_transport_None"].get("noncausal_holds", {}).items():
            log(f"  rank {r['cp_transport_None']['rank']}: {h['launches']} non-causal {n} launches "
                f"of a CP step held against the plain version: max_abs_err "
                f"{h['max_abs_err']:.3g}, worst {h['worst']:.3g} of its limit")
            if not h["ok"]:
                raise AssertionError(f"non-causal {n} against its plain version: {h}")
    holds = ranks[1]["cp_transport_None"].get("noncausal_holds", {})
    if set(holds) != {"_flash_fwd", "_flash_bwd_dq", "_flash_bwd_dkv"}:
        raise AssertionError(f"the CP step held no non-causal K4/K10/K11 launch: {holds}")

    # NCCL at world 1 through the train CLI, on a 2-layer cut as an HF checkpoint
    root = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        write_cli_root(cfg, root, MD_SEED)
        nccl = launch.spawn(_md_nccl_rank, 1, backend="nccl", device="cuda", args=(root,),
                            timeout=MD_TIMEOUT)[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    Lc = CUT_LAYERS
    if not (nccl["train_steps"] == 1 and nccl["backend"] == "nccl"
            and nccl["launches"].get("flash_fwd") == 2 * Lc
            and nccl["launches"].get("rmsnorm_quant") == 4 * Lc):
        raise AssertionError(f"NCCL at world 1 through cli.train.main: {nccl}")
    log(f"  NCCL at world 1: cli.train.main, one step on a {Lc}-layer cut, "
        f"launches {nccl['launches']}")
    launches = {k: sum(r[key]["launches_per_step"].get(k, 0)
                       * len(r[key]["losses"]) for r in ranks
                       for key in ("fsdp", "cp_transport_None", "cp_transport_8"))
                for k in counters()}
    return dict(transport=MD_TRANSPORT, ranks=ranks, ring_shape=ring, nccl_world1=nccl,
                spawn_s=spawn_s, launches=launches)


# ---------------------------------------------------------------------------
# tensor-parallel and pipeline training: two ranks on the one card
# ---------------------------------------------------------------------------

TPP_TP, TPP_PP = 2, 2                    # the tp and pp meshes' axis
TPP_BATCH, TPP_SEQ = 4, 2048             # the global batch of both modes
TPP_MICRO = 4                            # pp's microbatches: 1 x 2048 tokens each
TPP_WARM, TPP_STEPS = 1, 1               # warm-up and timed steps a run
TPP_CUT = (2, 256)                       # the 2-layer f32 cuts' global batch
TPP_SEED = 17                            # the phase's weights, tokens and kernel inputs


def _tpp_cli(rank, root, axis):
    """One step of ``train_torch.py``'s entry (``cli.train.main``) over the
    two ranks with ``--mesh_<axis> 2`` on the CLI root's 2-layer cut;
    every count set to 0 before it and read after it."""
    from llm_qat_torch.cli import train as CLI

    for fn in counters().values():
        fn.launches = 0
    res = CLI.main(["--input_model_filename", os.path.join(root, "teacher"),
                    "--tokenizer", "byte", "--train_data_local_path",
                    os.path.join(root, "train.jsonl"), "--eval_data_local_path",
                    os.path.join(root, "train.jsonl"), "--output_dir",
                    os.path.join(root, f"out_{axis}"), "--local_dir",
                    os.path.join(root, f"local_{axis}"), "--model_max_length", str(MD_CLI_SEQ),
                    "--qat", "true", "--use_kd", "true", "--w_bits", "4", "--a_bits", "8",
                    "--kv_bits", "4", "--max_steps", "1", "--do_eval", "false",
                    "--per_device_train_batch_size", "2", "--mesh_fsdp", "1",
                    f"--mesh_{axis}", "2"])
    res["launches"] = {k: n for k, n in read_counters().items() if n}
    return res


def _tpp_rank(rank, world, cfg, root):
    """Rank ``rank`` of the two: the 2-layer f32 cuts (tp, then pp) against
    one device; KD-QAT at TinyLlama-1.1B's full width on MD_LAYERS layers
    over tp = 2 (without and with ``fused_silu_quant``) and pp = 2; one step
    of the train CLI with ``--mesh_tp 2`` and with ``--mesh_pp 2``. Each
    step's launches are held against the counts derived from the code."""
    from llm_qat_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = pmesh.make_mesh(data=1, fsdp=1, tp=TPP_TP, device_type="cuda")
    pp = pmesh.make_mesh(fsdp=1, pp=TPP_PP, device_type="cuda")
    out = {"cuts": [_md_cut(rank, cfg, tp, "fsdp", True, *TPP_CUT),
                    _md_cut(rank, cfg, pp, "pp", True, *TPP_CUT)]}
    L = MD_LAYERS
    full = train_cfg_of(cfg, L)
    # a tp rank launches what one device does, at its heads: the teacher's and
    # the student's forward (the recompute reads the saved attention), the
    # backward pair, and RMSNorm+quant twice a layer forward and recompute;
    # with fused_silu_quant the row-max entry and the given-max entry of K13
    # once a layer forward and recompute, and no one-pass K13
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L, "rmsnorm_quant": 4 * L,
            "_flash_fwd_causal": 2 * L, "_flash_bwd_dq_causal": L, "_flash_bwd_dkv_causal": L}
    out["tp"] = _md_run(rank, f"TP tp={TPP_TP}", full, tp, "fsdp", TPP_WARM, TPP_STEPS,
                        TPP_BATCH, TPP_SEQ, want, {})
    out["tp_silu"] = _md_run(rank, f"TP tp={TPP_TP} fused_silu_quant",
                             full.replace(fused_silu_quant=True), tp, "fsdp", TPP_WARM,
                             TPP_STEPS, TPP_BATCH, TPP_SEQ,
                             dict(want, silu_mul_amax=2 * L, silu_mul_quant_amax=2 * L), {})
    # a pp stage sweeps its L / P layers on each of the M + P - 1 ticks, bubbles
    # included, forward and backward; the teacher's forward is whole on each rank
    n = (TPP_MICRO + TPP_PP - 1) * (L // TPP_PP)
    want = {"flash_fwd": L + n, "flash_bwd_dq": n, "flash_bwd_dkv": n, "rmsnorm_quant": 4 * n,
            "_flash_fwd_causal": L + n, "_flash_bwd_dq_causal": n, "_flash_bwd_dkv_causal": n}
    out["pp"] = _md_run(rank, f"PP pp={TPP_PP}, {TPP_MICRO} microbatches", full, pp, "pp",
                        TPP_WARM, TPP_STEPS, TPP_BATCH, TPP_SEQ, want,
                        dict(num_microbatches=TPP_MICRO))
    out["cli"] = {axis: _tpp_cli(rank, root, axis) for axis in ("tp", "pp")}
    return out


def k13_tp_phase(timer, gen, FQ, cfg, tp=TPP_TP):
    """K13's two entries for tensor parallelism at a tp rank's shape,
    [TPP_BATCH x TPP_SEQ, I / tp] bf16: the row max (``silu_mul_amax``) and
    the quantization with a given row max (``silu_mul_quant(..., amax=)``),
    each bit-equal to its plain version; the ranks' row maxima, their MAX
    and the given-max quantization of each rank's columns bit-equal to the
    one-pass K13 on the whole row. Timed beside the plain versions; bound by
    bytes (the two inputs read once, a max a row written; and the integers
    and a scale a row)."""
    M, I = TPP_BATCH * TPP_SEQ, cfg.intermediate_size
    c = I // tp
    gate = (torch.randn(M, I, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    up = torch.randn(M, I, device="cuda", generator=gen).to(torch.bfloat16)
    parts = [(gate[:, r * c:(r + 1) * c].contiguous(), up[:, r * c:(r + 1) * c].contiguous())
             for r in range(tp)]
    amax = [FQ.silu_mul_amax(g, u) for g, u in parts]
    amax_ok = all(torch.equal(a, FQ._silu_mul_amax_plain(g, u)) for a, (g, u) in zip(amax, parts))
    row_max = torch.stack(amax).amax(dim=0)
    got = [FQ.silu_mul_quant(g, u, 8, amax=row_max) for g, u in parts]
    plain_ok = all(torch.equal(q, pq) and torch.equal(sc, ps) for (q, sc), (pq, ps) in zip(
        got, (FQ._silu_mul_quant_plain(g, u, 8, row_max) for g, u in parts)))
    one_q, one_s = FQ.silu_mul_quant(gate, up, 8)
    one_ok = (torch.equal(torch.cat([q for q, _ in got], dim=1), one_q)
              and all(torch.equal(sc, one_s) for _, sc in got))
    again = FQ.silu_mul_quant(*parts[0], 8, amax=row_max)
    twice_ok = torch.equal(again[0], got[0][0]) and torch.equal(again[1], got[0][1])
    torch.cuda.synchronize()
    g0, u0 = parts[0]
    rows = {
        "silu_mul_amax": dict(
            ms=timer(lambda: FQ.silu_mul_amax(g0, u0)),
            plain_ms=timer(lambda: FQ._silu_mul_amax_plain(g0, u0)),
            bound=bound(4 * M * c + 4 * M, 10.0 * M * c, F32_FLOPS), ok=amax_ok),
        "silu_mul_quant_amax": dict(
            ms=timer(lambda: FQ.silu_mul_quant(g0, u0, 8, amax=row_max)),
            plain_ms=timer(lambda: FQ._silu_mul_quant_plain(g0, u0, 8, row_max)),
            bound=bound(5 * M * c + 8 * M, 12.0 * M * c, F32_FLOPS),
            ok=plain_ok and one_ok and twice_ok)}
    out = {}
    for name, r in rows.items():
        (b_ms, b_by) = r.pop("bound")
        out[name] = dict(M=M, K=c, plan=FQ.plan(c, 2, 2), library_ms=None, bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=0.0 if r["ok"] else float("nan"), **r)
        log(f"  K13 {name} at a tp={tp} rank's [{M}, {c}] bf16: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, bound {b_ms:.4f} {b_by}, {100 * b_ms / r['ms']:.1f}% of it); "
            f"bit-equal to its plain version {r['ok']}")
    if not (amax_ok and plain_ok and one_ok and twice_ok):
        raise AssertionError(f"K13's tp entries: row max {amax_ok}, given max against the plain "
                             f"version {plain_ok}, against the one-pass K13 on the whole row "
                             f"{one_ok}, the same bits twice {twice_ok}")
    out["whole_row_bit_equal"] = one_ok
    return out


def tp_pp_train_phase(cfg):
    """KD-QAT training over 'tp' and over 'pp', two ranks on the one H100
    spawned by ``parallel.launch`` over gloo (``MD_TRANSPORT``), at
    TinyLlama-1.1B's full width on an MD_LAYERS-layer cut, the train recipe
    (W4A8KV4, bf16, ``kl_chunk=256``, remat), TPP_BATCH x TPP_SEQ tokens a
    step, TPP_WARM + TPP_STEPS steps a run:

    * tp = 2 (the Megatron split; 16 query and 2 kv heads, 2816 intermediate
      columns a rank), without and with ``fused_silu_quant`` (K13 through its
      row-max and given-max entries);
    * pp = 2 (GPipe, one layer a stage, TPP_MICRO microbatches of 2048
      tokens);
    * each rank's K4/K10/K11/K12/K13 launches every step held against the
      counts derived from the code (``_tpp_rank``), losses finite and
      falling, each rank's held bytes beside the one-device figure;
    * a 2-layer f32 cut of each mode against the one-device step on the same
      global batch (``_md_cut``'s limits);
    * one step of ``train_torch.py``'s entry over the two ranks with
      ``--mesh_tp 2`` and with ``--mesh_pp 2``;
    * K4/K10/K11 at a tp rank's shard shape (B = 4 x 2 kv heads, G = 8,
      S = 2048, causal) and K13's two tp entries at [8192, 2816] against their
      plain versions and timed (``flash_ring_phase``, ``k13_tp_phase``).

    Walls are the card's shared by two ranks over a host-staged transport: no
    scaling figure."""
    from llm_qat_torch.ops import flash_attention as FA
    from llm_qat_torch.ops import fused_quant as FQ
    from llm_qat_torch.parallel import launch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(TPP_SEED)
    G = cfg.num_attention_heads // cfg.kv_heads
    shard = flash_ring_phase(Timer(), gen, FA, B=TPP_BATCH * cfg.kv_heads // TPP_TP, G=G,
                             S=TPP_SEQ, D=cfg.head_dim, causal=True,
                             label=f"a tp={TPP_TP} rank's shard")
    k13 = k13_tp_phase(Timer(), gen, FQ, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_tpp_")
    try:
        write_cli_root(cfg, root, TPP_SEED)
        t0 = time.perf_counter()
        ranks = launch.spawn(_tpp_rank, 2, backend="gloo", device="cuda", args=(cfg, root),
                             timeout=MD_TIMEOUT)
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for c in ranks[0]["cuts"]:
        m = "tp=2" if c["parallel"] == "fsdp" else "pp=2"
        log(f"  {m} W4A8KV4 {CUT_LAYERS}-layer f32 cut at full width, {c['batch']} x {c['seq']} "
            f"tokens, one step against one device: loss {c['loss_rel']:.3g}, grad_norm "
            f"{c['grad_norm_rel']:.3g} relative, params at most {c['params_max_over_lr']:.3g} lr "
            f"apart, {100 * c['params_tight_share']:.3f}% within 1e-3 lr + 1e-6 |p| (limits: "
            f"1e-4, 1e-4, 2.1 lr, 99.9%)")
        if not c["ok"]:
            raise AssertionError(f"{m} cut against one device: {c}")
    for key in ("tp", "tp_silu", "pp"):
        for r in (x[key] for x in ranks):
            h, one = r["held_bytes"], r["one_device_bytes"]
            log(f"  {r['mode']} rank {r['rank']}: {r['layers']} layers, {r['batch']} x {r['seq']} "
                "tokens a step: losses " + " ".join(f"{x:.3f}" for x in r["losses"])
                + f"; step {1e3 * r['step_s']:.0f} ms on a card shared by two ranks "
                f"({MD_TRANSPORT}; no scaling figure); held: params {h['params'] / 1e9:.3f} GB, "
                f"moments {h['moments'] / 1e9:.3f} GB, teacher {h['teacher'] / 1e9:.3f} GB (one "
                f"device: {one['params'] / 1e9:.3f}, {one['moments'] / 1e9:.3f}, "
                f"{one['teacher'] / 1e9:.3f} GB); peak memory "
                f"{r['peak_memory_bytes'] / 2 ** 30:.2f} GiB; launches a step {r['launches_per_step']}")
            if h["moments"] != 2 * h["params"] or not h["params"] < one["params"]:
                raise AssertionError(f"{r['mode']} rank {r['rank']} holds {h}, one device {one}")
            if key != "pp" and not one["params"] / 2 < h["params"] < 0.51 * one["params"]:
                raise AssertionError(f"{r['mode']} rank {r['rank']} holds {h}, one device {one}")
    Lc, cli = CUT_LAYERS, {}
    n_pp = (2 + TPP_PP - 1) * (Lc // TPP_PP)    # the CLI's pp step: 2 rows, 2 microbatches
    want = {"tp": {"flash_fwd": 2 * Lc, "flash_bwd_dq": Lc, "flash_bwd_dkv": Lc,
                   "rmsnorm_quant": 4 * Lc},
            "pp": {"flash_fwd": Lc + n_pp, "flash_bwd_dq": n_pp, "flash_bwd_dkv": n_pp,
                   "rmsnorm_quant": 4 * n_pp}}
    for axis in ("tp", "pp"):
        for r in ranks:
            got = r["cli"][axis]
            if got["train_steps"] != 1 or got["launches"] != want[axis]:
                raise AssertionError(f"cli.train.main --mesh_{axis} 2: {got}, launches expected "
                                     f"{want[axis]}")
        cli[axis] = dict(train_steps=1, launches_per_rank=want[axis],
                         model_path=ranks[0]["cli"][axis].get("model_path"))
        log(f"  cli.train.main --mesh_{axis} 2 over two gloo ranks, one step on a {Lc}-layer "
            f"cut: launches a rank {want[axis]}")
    per_mode = {key: {k: sum(r[key]["launches_per_step"].get(k, 0) * len(r[key]["losses"])
                             for r in ranks) for k in counters()}
                for key in ("tp", "tp_silu", "pp")}
    launches_tp = {k: per_mode["tp"][k] + per_mode["tp_silu"][k] for k in counters()}
    launches = {k: launches_tp[k] + per_mode["pp"][k] for k in counters()}
    return dict(transport=MD_TRANSPORT, ranks=ranks, shard_shape=shard, k13=k13, cli=cli,
                spawn_s=spawn_s, launches=launches, launches_tp=launches_tp,
                launches_pp=per_mode["pp"])


# ---------------------------------------------------------------------------
# tensor-parallel serving: two ranks on the one card
# ---------------------------------------------------------------------------

TP, TP_SEED = 2, 21                      # tp ranks; the phase's weights, prompts and inputs
# the depth it serves: every layer of TinyLlama-1.1B's 22 does the same work
# over gloo through the host; the phase ran 161.8 s at all 22 and 138.0 s at
# 11 on a host that ran the other phases 1.2-1.4x slower (PERF.md); 76.4 s at
# 8 left the time phase [4i] takes, and 6 the time of the G > 8 phase [3b4]
TP_LAYERS = 6
TP_PROMPT_LENS, TP_NEW = (16, 300, 700, 1000), 8   # 4 requests x 8 greedy new tokens
TP_PAGES = 64                            # the paged engine's pool (pages of PAGE)
TP_BEAM_NEW, TP_BEAM_PROMPT = 16, 40     # beam over TP: BEAM_NUM beams, tokens, prompt
TP_FORCED = (0, 3)                       # teacher-forced at full depth: 16 and 1000 tokens
TP_FULL_DRIFT = 0.15                     # its limit: TP against one rank (see tp_serving_phase)
TP_CUT_PROMPTS = (0, 1)                  # the cut's prompts: 16 tokens, and 300 (512 rows)
TP_TIMEOUT = 900                         # seconds the spawn of the two ranks may take
TP_TRANSPORT = ("gloo, CUDA tensors staged through host memory: two ranks share the one "
                "H100, which NCCL refuses (duplicate GPU)")


def tp_modes(cfg):
    """The served modes; the default config (``use_megakernel=True``): a TP
    engine must decode on the scan path all the same."""
    return {"W8A8KV8": cfg.replace(w_bits=8, a_bits=8, kv_bits=8),
            "W4A8KV4": cfg.replace(w_bits=4, a_bits=8, kv_bits=4, kv_cache_pack=True)}


def tp_prompts(cfg):
    rng = np.random.default_rng(TP_SEED)
    return [list(map(int, rng.integers(1, cfg.vocab_size, n))) for n in TP_PROMPT_LENS]


def tp_kernel_shapes(timer, gen, cfg):
    """K1/K2 at the shard shapes a rank of tp = 2 gives them at decode (4
    slots, padded to 32 rows): column-parallel qkv (N = 1280) and gate-up
    (N = 5632) at K = 2048 in bf16, one of the four column chunks of the
    row-parallel o (K = 1024) and down (K = 2816) in f32; K3 and K8 at the
    rank's 2 kv heads (G = 8, hd = 64), int8 and packed. Held as their phases
    hold them; times beside the bounds."""
    from llm_qat_torch.ops import decode_attention as DA
    from llm_qat_torch.ops import quant_matmul as QM

    H, I, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    qkv_n = (cfg.num_attention_heads + 2 * cfg.kv_heads) * hd // TP
    projs = {"qkv": (H, qkv_n, torch.bfloat16), "gateup": (H, 2 * I // TP, torch.bfloat16),
             "o chunk": (H // TP, H // 4, torch.float32),
             "down chunk": (I // TP, H // 4, torch.float32)}
    out = {}
    for name, fn, plain in (("int8_matmul", QM.int8_matmul, QM._int8_matmul_plain),
                            ("int4_matmul", QM.int4_matmul, QM._int4_matmul_plain)):
        out[name] = [gemm_shape(timer, gen, QM, name, fn, plain, f"TinyLlama-1.1B tp={TP}", proj,
                                32, K, N, out_dtype=od) for proj, (K, N, od) in projs.items()]
    kvh = cfg.kv_heads // TP
    G = cfg.num_attention_heads // cfg.kv_heads
    out["decode_attention"] = [decode_attention_phase(timer, gen, DA, kvh, G, hd, packed)
                               for packed in (False, True)]
    out["paged_attention"] = [paged_attention_phase(timer, gen, DA, kvh, G, hd, packed)
                              for packed in (False, True)]
    return out


@contextlib.contextmanager
def tp_hold_launches(holds):
    """Within the block every launch of K1, K2, K3, K8 and K4 is also
    computed by its plain version on the same inputs: K1/K2 held bit for bit
    (``torch.equal``), K3/K8/K4 element-wise (``agreement``, the K3/K4
    limit). ``holds[name]`` collects (launches, ok, max_abs_err, worst)."""
    from llm_qat_torch.ops import decode_attention as DA
    from llm_qat_torch.ops import flash_attention as FA
    from llm_qat_torch.ops import quant_matmul as QM

    pairs = [(QM, "int8_matmul", QM._int8_matmul_plain, True),
             (QM, "int4_matmul", QM._int4_matmul_plain, True),
             (DA, "quantized_decode_attention", DA._decode_attention_plain, False),
             (DA, "quantized_paged_attention", DA._paged_attention_plain, False),
             (FA, "_flash_fwd", FA._flash_fwd_plain, False)]
    reals = [getattr(mod, name) for mod, name, _, _ in pairs]

    def held(name, real, plain, exact):
        def fn(*a, **kw):
            out = real(*a, **kw)
            want = plain(*a, **kw)
            got_o, want_o = (out[0], want[0]) if name == "_flash_fwd" else (out, want)
            torch.cuda.synchronize()
            if exact:
                a_ = dict(ok=torch.equal(got_o, want_o),
                          max_abs_err=float((got_o.float() - want_o.float()).abs().max()),
                          worst=0.0)
            else:
                a_ = agreement(got_o, want_o, ATTN_ULPS, ATTN_FLOOR)
            h = holds.setdefault(name, dict(launches=0, ok=True, max_abs_err=0.0, worst=0.0,
                                            shapes=set()))
            h["launches"] += 1
            h["ok"] = h["ok"] and a_["ok"]
            h["max_abs_err"] = max(h["max_abs_err"], a_["max_abs_err"])
            h["worst"] = max(h["worst"], a_["worst"])
            h["shapes"].add(str([tuple(t.shape) for t in a[:2] if torch.is_tensor(t)]))
            return out
        fn.launches = real.launches
        return fn

    try:
        for (mod, name, plain, exact), real in zip(pairs, reals):
            setattr(mod, name, held(name, real, plain, exact))
        yield
    finally:
        for (mod, name, _, _), real in zip(pairs, reals):
            setattr(mod, name, real)
        for h in holds.values():
            h["shapes"] = sorted(h["shapes"])


def tp_serve(label, eng, prompts, want_step=None, record=False):
    """Serve ``prompts`` x TP_NEW greedy tokens through an engine: prefill
    time and launches apart, each prefill call's launches with its rows;
    every decode step's launches (set to 0 before the step, read after it)
    must be ``want_step``; with ``record`` the logits each token was drawn
    from are kept (the prefill's, then each step's). Returns (metrics,
    tokens by request, logits)."""
    pre = {"s": 0.0, "launches": dict.fromkeys(counters(), 0), "calls": []}
    dec = dict.fromkeys(counters(), 0)
    real_prefill, real_fwd = eng._prefill, eng._fwd
    steps, tops, bad = [0], [], []

    def timed_prefill(qp, ids, *a):
        before = read_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_prefill(qp, ids, *a)
        torch.cuda.synchronize()
        pre["s"] += time.perf_counter() - t
        got = {k: n - before[k] for k, n in read_counters().items() if n - before[k]}
        for k, n in got.items():
            pre["launches"][k] += n
        pre["calls"].append((int(ids.shape[0] * ids.shape[1]), got))
        return out

    def step_fwd(*a):
        if record and not steps[0]:
            tops.append(eng._logits.float().clone())      # the prefill's: token 0's
        for fn in counters().values():
            fn.launches = 0
        out = real_fwd(*a)
        got = {k: n for k, n in read_counters().items() if n}
        if want_step is not None and got != want_step:
            bad.append(got)
        for k, n in got.items():
            dec[k] += n
        steps[0] += 1
        if record:       # a copy: the engine's next admission writes its logits in place
            tops.append(out[0][:, 0].float().clone())
        return out

    eng._prefill, eng._fwd = timed_prefill, step_fwd
    uids = [eng.submit(p, max_new_tokens=TP_NEW) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng._prefill, eng._fwd = real_prefill, real_fwd
    by_uid = {r.uid: r for r in done}
    toks = [by_uid[u].prompt[len(p):] + by_uid[u].output if u in by_uid else None
            for u, p in zip(uids, prompts)]
    if any(t is None or len(t) != TP_NEW for t in toks) or not torch.isfinite(eng._logits).all():
        raise AssertionError(f"{label}: outputs {[None if t is None else len(t) for t in toks]}")
    if bad:
        raise AssertionError(f"{label}: decode steps launched {bad[:2]}, expected {want_step}")
    decode_s = wall - pre["s"]
    m = dict(mode=label, requests=len(done), prompt_tokens=sum(map(len, prompts)),
             prefill_s=pre["s"], decode_steps=steps[0], decode_s=decode_s,
             decode_ms_per_step=1e3 * decode_s / steps[0], wall_s=wall,
             generated_tok_per_s=len(done) * TP_NEW / wall,
             prefill_launches={k: n for k, n in pre["launches"].items() if n},
             prefill_calls=pre["calls"], decode_launches={k: n for k, n in dec.items() if n},
             launches_per_step=want_step)
    log(f"  {label}: prefill {m['prefill_s']:.3f} s, decode {m['decode_ms_per_step']:.2f} ms/step "
        f"over {m['decode_steps']} steps, wall {wall:.2f} s ({time.perf_counter() - T_START:.0f} s "
        "into the run)")
    return m, toks, [t.cpu() for t in tops]


def tp_compare_tokens(label, ref, got, path_diff, codes):
    """The TP run's greedy tokens against the one-rank run's, tie-aware as
    ``compare_tokens``. The TP path sums the row-parallel partials in f32 and
    rounds once, one rank rounds its exact integer sum: an output on a bf16
    rounding boundary rounds the other way, a quantizer code that sees it
    may move one level, and 22 layers that re-quantize every projection's
    input carry that into a flip where logits nearly tie. ``path_diff`` is
    the largest absolute logit difference of the teacher-forced full-depth
    runs (``_tp_forced``, held at TP_FULL_DRIFT). ``codes``: each prompt's
    first parting quantizer codes in its prefill (``_tp_forced``). Rules:
    token 0 (the prefill's) is equal, or the request's prompt's prefill codes
    part, one level apart (checked for every prompt by the caller); the
    logits that drew token k saw tokens < k only, so wherever a request's
    tokens before k agree, the two runs' logits of token k are on the same
    context, and those differ by at most NEAR_TIE_OVER x ``path_diff`` (a
    factor 2 for a lead against a difference, 2 for another prompt and a
    longer context); at a request's first difference the one-rank run's
    lead of its token over the TP run's is within that limit too."""
    (r_toks, r_logits), (g_toks, g_logits) = ref, got
    firsts = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
              for a, b in zip(r_toks, g_toks)]
    shared = 0.0
    for k, (rl, gl) in enumerate(zip(r_logits, g_logits)):
        for r, t in enumerate(firsts):
            if t is None or k <= t:
                shared = max(shared, float((rl[r] - gl[r]).abs().max()))
    flips = []
    for r, t in enumerate(firsts):
        if t is None:
            continue
        if t == 0 and codes[r] is None:
            raise AssertionError(f"{label}: request {r} differs at the prefill's token, and its "
                                 "prompt's prefill codes do not part")
        row = r_logits[t][r]
        flips.append(dict(request=r, step=t, lead=float(row[r_toks[r][t]] - row[g_toks[r][t]])))
    limit = NEAR_TIE_OVER * path_diff
    log(f"  {label}: tp={TP} against one rank, {len(firsts) - len(flips)} of {len(firsts)} "
        f"requests equal over {TP_NEW} tokens; largest logit difference on a shared context "
        f"{shared:.4g}; first differences (one rank's lead); limit of both {limit:.4g} "
        f"({NEAR_TIE_OVER} x the teacher-forced {path_diff:.4g}): "
        + ("; ".join(f"request {f['request']} step {f['step']} lead {f['lead']:.4g}"
                     for f in flips) or "none"))
    if shared > limit or any(f["lead"] > limit for f in flips):
        raise AssertionError(f"{label}: shared-context difference {shared}, first differences "
                             f"{flips}: over {limit}")
    return dict(path_diff=path_diff, shared_diff=shared, flips=flips)


def tp_transport(eng, prompt):
    """One decode step of ``eng`` with every collective timed on the host
    clock (the device synchronized before and after each): the gloo
    transport a step issues, and how many collectives."""
    from llm_qat_torch.parallel import comm

    reals = {n: getattr(comm, n) for n in ("all_reduce_", "all_gather")}
    spent = {"s": 0.0, "n": 0}

    def timed(real):
        def fn(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            spent["s"] += time.perf_counter() - t0
            spent["n"] += 1
            return out
        return fn

    # a lone collective of each kind the step issues, the card idle: 20 each
    from llm_qat_torch.parallel import mesh as pmesh

    group = pmesh.axis_group(eng.mesh, "tp")
    lone = {}
    if group is not None:
        chunk = torch.ones(32, 512, device="cuda")
        amax = torch.ones(4, 1, device="cuda")
        for name, fn in (("sum_chunk", lambda: comm.all_reduce_(chunk, group)),
                         ("max_amax", lambda: comm.all_reduce_(
                             amax, group, op=torch.distributed.ReduceOp.MAX))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            lone[name] = (time.perf_counter() - t0) / 20
    eng.submit(prompt, max_new_tokens=1)
    eng._admit()
    try:
        for n, f in reals.items():
            setattr(comm, n, timed(f))
        spent.update(s=0.0, n=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for n, f in reals.items():
            setattr(comm, n, f)
    return dict(collectives=spent["n"], transport_s=spent["s"], step_wall_s=wall,
                lone_collective_s=lone)


def _tp_forced(scan, shard, one_q, prompts, mesh, rank):
    """Full depth, with no engine: every prompt's prefill through
    ``model.prefill_slot`` on one device, then over TP, every activation
    quantizer's codes recorded (``first_code_parting``: this rank's view);
    then the TP_FORCED prompts' prefill and 4 decode steps through the TP
    scan and paged forwards (greedy) and, on rank 0, the one-device forwards
    teacher-forced with their tokens (``_compare`` by path and prompt
    length)."""
    from llm_qat_torch.inference import model as M
    from llm_qat_torch.parallel import mesh as pmesh

    group = pmesh.axis_group(mesh, "tp")
    L = scan.num_hidden_layers
    codes = []
    for p in prompts:
        one, tp = [], []
        with record_codes(one):
            M.prefill_slot(one_q, scan, _bucketed(p), device="cuda")
        with record_codes(tp):
            M.prefill_slot(shard, scan, _bucketed(p), device="cuda", tp_group=group)
        codes.append(first_code_parting(one, tp, L, rank, TP))
        del one, tp
    compare = {}
    for i in TP_FORCED:
        p, toks, ptoks = prompts[i], [], []
        tp = _greedy_logits(scan, shard, p, "cuda", toks, mesh=mesh)
        tp_paged = _greedy_logits_paged(scan, shard, p, "cuda", ptoks, mesh=mesh)
        if rank == 0:
            compare[f"scan {len(p)}"] = _compare(tp, _greedy_logits(scan, one_q, p, "cuda", toks))
            compare[f"paged {len(p)}"] = _compare(
                tp_paged, _greedy_logits_paged(scan, one_q, p, "cuda", ptoks))
    return dict(codes=codes, compare=compare)


def _tp_greedy_cut(cut, params, prompt, mesh, rank, cpu):
    """The CUT_LAYERS-layer cut, greedy (prefill + 4 steps), through the TP
    scan and paged forwards on the card, then teacher-forced with their
    tokens the one-device forwards on the card and, with ``cpu`` (rank 0),
    the port's CPU path (one device, plain versions), every activation
    quantizer's codes recorded. Returns each comparison's greedy tokens and
    drift per logit vector (``_compare_steps``, rank 0) and the first code
    partings (``first_code_parting``, this rank's view of TP against one
    device)."""
    from llm_qat_torch.inference import quantized as Q
    from llm_qat_torch.inference import sharded as S

    scan = cut.replace(use_megakernel=False)
    shard = S.shard_qparams(S.quantize_params_tp(params, cut, TP), mesh)
    one_q = Q.quantize_params(params, scan)
    out = {"steps": {}, "codes": {}}
    for path, run in (("scan", _greedy_logits), ("paged", _greedy_logits_paged)):
        toks, c_tp, c_one, c_cpu = [], [], [], []
        with record_codes(c_tp):
            tp = run(scan, shard, prompt, "cuda", toks, mesh=mesh)
        with record_codes(c_one):
            one = run(scan, one_q, prompt, "cuda", toks)
        out["codes"][path] = dict(tp_vs_one=first_code_parting(c_one, c_tp, CUT_LAYERS, rank, TP))
        out["steps"][path] = dict(tp_vs_one=_compare_steps(tp, one))
        if cpu:
            with record_codes(c_cpu):
                on_cpu = run(scan, Q.quantize_params(params, scan, device="cpu"), prompt, "cpu",
                             toks)
            out["codes"][path]["one_vs_cpu"] = first_code_parting(c_cpu, c_one, CUT_LAYERS)
            out["steps"][path].update(one_vs_cpu=_compare_steps(one, on_cpu),
                                      tp_vs_cpu=_compare_steps(tp, on_cpu))
    return out


def hold_flip(label, steps, parting, limit=CUT_DRIFT):
    """One comparison of the cut held by the flip rule (ROADMAP.md section
    3): ``steps`` = (greedy tokens equal, relative L2 drift) per logit vector
    (the prefill's, then each decode step's); ``parting``: the first
    quantizer call whose codes part. With none, every vector within
    ``limit`` and its greedy token equal. With one, it must part by one
    level; the vectors of the forwards before it are held so, those from its
    forward on (which see the flipped code) within CUT_FLIP_DRIFT."""
    same, drift = steps
    f = len(drift) if parting is None else parting["forward"]
    ok = ((parting is None or parting["levels"] == 1) and all(same[:f])
          and all(d <= limit for d in drift[:f]) and all(d <= CUT_FLIP_DRIFT for d in drift[f:]))
    if not ok:
        raise AssertionError(f"{label}: tokens {same}, drift {drift}, codes part {parting}; "
                             f"limits {limit} before the parting, {CUT_FLIP_DRIFT} from it")


def _tp_rank(rank, world, cfg, prompts):
    """Rank ``rank`` of TP: for each mode the TP scan engine and the TP paged
    engine serve ``prompts`` (launches checked every step; the logits kept
    on rank 0), one held step of each (every K1/K2/K3/K8/K4 launch against
    its plain version), the transport of one step, then the teacher-forced
    full-depth runs and prefill codes (``_tp_forced``); the 2-layer cut
    against one device and the CPU path; beam search over TP at W8A8KV8,
    full depth and the cut; then the multi-host driver as 2 hosts x tp 1."""
    from llm_qat_torch.inference import beam as B
    from llm_qat_torch.inference import paged as PG
    from llm_qat_torch.inference import paged_engine as PE
    from llm_qat_torch.inference import quantized as Q
    from llm_qat_torch.inference import sharded as S
    from llm_qat_torch.inference.engine import InferenceEngine
    from llm_qat_torch.inference.multihost import MultiHostServingDriver
    from llm_qat_torch.models import params as P
    from llm_qat_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pmesh.make_serving_mesh(TP, device_type="cuda")
    L = cfg.num_hidden_layers
    pcfg = PG.PagedConfig(page_size=PAGE, n_pages=TP_PAGES, max_pages_per_seq=SEQ_PAGES)
    out = {"part_s": {}}
    clock = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        out["part_s"][name] = now - clock[0]
        clock[0] = now

    # the held steps: K1, K3 and K4 at W8A8KV8 scan, K2, K8 and K4 at W4A8KV4 paged
    held = {"W8A8KV8 scan", "W4A8KV4 paged"}
    for label, mcfg in tp_modes(cfg).items():
        gemm_k = "int8_matmul" if mcfg.w_bits == 8 else "int4_matmul"
        params = P.init_params(mcfg, seed=TP_SEED, dtype=torch.bfloat16)
        qp = S.quantize_params_tp(params, mcfg, TP)
        one_q = Q.quantize_params(params, mcfg)
        del params
        kw = dict(max_batch=len(prompts), mesh=mesh)
        engines = {"scan": InferenceEngine(qp, mcfg, max_len=2048, **kw),
                   "paged": PE.PagedInferenceEngine(qp, mcfg, pcfg=pcfg, **kw)}
        del qp
        gc.collect()
        torch.cuda.empty_cache()
        for kind, eng in engines.items():
            attn = "decode_attention" if kind == "scan" else "paged_attention"
            # K1/K2 a layer: qkv and gate-up once each, o and down in 4 chunks each
            want = {gemm_k: 10 * L, attn: L}
            eng.submit(prompts[0][:16], max_new_tokens=4)       # warm-up
            eng.run()
            m, toks, logits = tp_serve(f"{label} {kind} tp={TP}", eng, prompts, want,
                                       record=rank == 0)
            holds = {}
            if f"{label} {kind}" in held:
                with tp_hold_launches(holds):
                    for p in prompts:
                        eng.submit(p, max_new_tokens=1)       # the prefill and one decode step
                    eng.run()
            m["held_step"] = holds
            m["transport"] = tp_transport(eng, prompts[1])
            out[f"{label} {kind}"] = dict(metrics=m, tokens=toks, logits=logits)
            part(f"{label} {kind}")
        out[f"{label} forced"] = _tp_forced(mcfg.replace(use_megakernel=False),
                                            engines["scan"].qparams, one_q, prompts, mesh, rank)
        part(f"{label} forced")
        del engines, one_q
        gc.collect()
        torch.cuda.empty_cache()
    # the 2-layer cut against one device, and on the first prompt the CPU path
    cut = tp_modes(cfg)["W8A8KV8"].replace(num_hidden_layers=CUT_LAYERS)
    cparams = P.init_params(cut, seed=TP_SEED, dtype=torch.bfloat16)
    out["cut"] = {len(prompts[i]): _tp_greedy_cut(cut, cparams, prompts[i], mesh, rank,
                                                  cpu=rank == 0 and i == TP_CUT_PROMPTS[0])
                  for i in TP_CUT_PROMPTS}
    part("cut")
    # beam search over TP, W8A8KV8 scan path, full depth and the cut
    bprompt = prompts[1][:TP_BEAM_PROMPT]
    out["beam"] = {}
    for name, bcfg in (("full", tp_modes(cfg)["W8A8KV8"]), ("cut", cut)):
        scan = bcfg.replace(use_megakernel=False)
        params = cparams if name == "cut" else P.init_params(bcfg, seed=TP_SEED,
                                                              dtype=torch.bfloat16)
        shard = S.shard_qparams(S.quantize_params_tp(params, bcfg, TP), mesh)
        del params
        for fn in counters().values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, score = B.beam_generate(
            shard, scan, bprompt, num_beams=BEAM_NUM, max_new_tokens=TP_BEAM_NEW,
            fwd=S.make_tp_forward(scan, mesh), prefill=S.make_tp_prefill(scan, mesh))
        torch.cuda.synchronize()
        out["beam"][name] = dict(tokens=[int(t) for t in toks], score=score,
                                 wall_s=time.perf_counter() - t0,
                                 launches={k: n for k, n in read_counters().items() if n})
        del shard
        part(f"beam {name}")
    # the multi-host driver: 2 hosts x tp 1, the W8A8KV8 scan path
    w8 = tp_modes(cfg)["W8A8KV8"].replace(use_megakernel=False)
    params = P.init_params(w8, seed=TP_SEED, dtype=torch.bfloat16)
    drv = MultiHostServingDriver(params, w8, tp=1, local_size=1, max_batch=len(prompts))
    del params
    uids = [drv.submit(p, max_new_tokens=TP_NEW) for p in prompts]
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = {r.uid: [int(t) for t in r.output] for r in drv.run()}
    torch.cuda.synchronize()
    out["multihost"] = dict(host=drv.process_index, hosts=drv.process_count, uids=uids,
                            owners=[drv.owner(u) for u in uids], served=served,
                            wall_s=time.perf_counter() - t0,
                            launches={k: n for k, n in read_counters().items() if n})
    part("multihost")
    return out


def tp_serving_phase(cfg):
    """Tensor-parallel serving at ``cfg``'s width and depth (main gives it
    TinyLlama-1.1B's full width at TP_LAYERS layers; "full depth" below is
    that depth), tp = TP ranks on the one H100 spawned by ``parallel.launch`` over gloo
    (``TP_TRANSPORT``), through the entry points: ``InferenceEngine(mesh=)``
    and ``PagedInferenceEngine(mesh=)`` over ``sharded.quantize_params_tp``
    weights at W8A8KV8 and W4A8KV4 (packed cache), len(TP_PROMPT_LENS)
    requests x TP_NEW greedy tokens each:

    * every decode step launches 10L K1 (W8) or K2 (W4) a rank (qkv, gate-up,
      and o and down in four column chunks each) and L K3 (scan) or K8
      (paged), and no K9, though the config asks for the megakernel;
    * every prefill call launches, a rank, L K4 and 10L K1 (below
      XLA_INT8_MIN_ROWS padded rows; from there W8 takes the library GEMM)
      or K2;
    * teacher-forced with no engine (``_tp_forced``): the TP_FORCED prompts'
      prefill and 4 decode steps through the TP scan and paged forwards
      against one device's, drift <= TP_FULL_DRIFT; every prompt's prefill
      codes against one device's, the first parting one level apart;
    * the tokens equal the one-rank scan / paged engine's on the same weights
      (``tp_compare_tokens``, tie-aware from the teacher-forced reading), the
      same on both ranks;
    * one held step (prefill and one decode step of the 4 requests): every
      K1/K2/K3/K8/K4 launch at the shard shapes against its plain version;
    * the gloo transport of one decode step, on the host's clock;
    * a CUT_LAYERS-layer cut on 16 and 300 tokens (the latter's 512 rows
      take W8's library GEMM in f32 chunks) through the TP scan and paged
      forwards against one device, and on 16 tokens one device against the
      port's CPU path: CUT_DRIFT, by the flip rule (``hold_flip``);
    * beam search over TP (``beam_generate(fwd=, prefill=)``, BEAM_NUM beams x
      TP_BEAM_NEW tokens) against one rank's: the cut's tokens equal and its
      score within BEAM_CUT_REL, full depth's score within BEAM_SCORE_REL;
    * ``multihost.MultiHostServingDriver`` on the two ranks as 2 hosts x tp
      1: a disjoint, exhaustive partition of the requests with the one-rank
      engine's tokens.

    K1/K2 at the shard shapes, K3/K8 at the rank's kv heads are timed first
    (``tp_kernel_shapes``). Walls are the card's shared by two ranks; the
    transport is the host's."""
    from llm_qat_torch.inference import beam as B
    from llm_qat_torch.inference import paged as PG
    from llm_qat_torch.inference import paged_engine as PE
    from llm_qat_torch.inference import quantized as Q
    from llm_qat_torch.inference.engine import InferenceEngine
    from llm_qat_torch.models import params as P
    from llm_qat_torch.ops import quant_matmul as QM
    from llm_qat_torch.parallel import launch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(TP_SEED)
    shapes = tp_kernel_shapes(Timer(), gen, cfg)
    prompts = tp_prompts(cfg)
    L = cfg.num_hidden_layers
    pcfg = PG.PagedConfig(page_size=PAGE, n_pages=TP_PAGES, max_pages_per_seq=SEQ_PAGES)
    ref, ref_beam = {}, {}
    cut = tp_modes(cfg)["W8A8KV8"].replace(num_hidden_layers=CUT_LAYERS)
    for label, mcfg in tp_modes(cfg).items():
        scan = mcfg.replace(use_megakernel=False)
        gemm_k = "int8_matmul" if mcfg.w_bits == 8 else "int4_matmul"
        params = P.init_params(mcfg, seed=TP_SEED, dtype=torch.bfloat16)
        qp = Q.quantize_params(params, mcfg)
        del params
        for kind, eng in (("scan", InferenceEngine(qp, scan, max_batch=len(prompts))),
                          ("paged", PE.PagedInferenceEngine(qp, scan, pcfg=pcfg,
                                                            max_batch=len(prompts)))):
            attn = "decode_attention" if kind == "scan" else "paged_attention"
            eng.submit(prompts[0][:16], max_new_tokens=4)
            eng.run()
            m, toks, logits = tp_serve(f"{label} {kind} one rank", eng, prompts,
                                       {gemm_k: 4 * L, attn: L}, record=True)
            ref[f"{label} {kind}"] = dict(metrics=m, tokens=toks, logits=logits)
        if mcfg.w_bits == 8:
            for name, bcfg in (("full", scan), ("cut", cut.replace(use_megakernel=False))):
                bq = qp if name == "full" else Q.quantize_params(
                    P.init_params(cut, seed=TP_SEED, dtype=torch.bfloat16), bcfg)
                toks, score = B.beam_generate(bq, bcfg, prompts[1][:TP_BEAM_PROMPT],
                                              num_beams=BEAM_NUM, max_new_tokens=TP_BEAM_NEW)
                ref_beam[name] = dict(tokens=[int(t) for t in toks], score=score)
        del qp, eng
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = launch.spawn(_tp_rank, TP, backend="gloo", device="cuda", args=(cfg, prompts),
                         timeout=TP_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    log(f"  the ranks ran {spawn_s:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in ranks[0]["part_s"].items()))
    out = dict(transport=TP_TRANSPORT, spawn_s=spawn_s, shapes=shapes, runs={}, beam={},
               forced={}, rank_part_s=ranks[0]["part_s"])
    # teacher-forced at full depth: the drift, the prefill codes
    for label, mcfg in tp_modes(cfg).items():
        fr = [r[f"{label} forced"] for r in ranks]
        codes = [join_partings([f["codes"][i] for f in fr]) for i in range(len(prompts))]
        cmp = fr[0]["compare"]
        path_diff = max(v[2] for v in cmp.values())
        log(f"  {label} tp={TP} teacher-forced at full depth against one device (prefill + 4 "
            "steps; greedy tokens equal per step, relative L2 drift, largest absolute "
            f"difference; limit {TP_FULL_DRIFT}): " + "; ".join(
                f"{k} tokens {v[0]} {v[1]:.4g} ({v[2]:.4g})" for k, v in cmp.items())
            + "; first parting prefill codes by prompt length: " + "; ".join(
                f"{len(p)}: {parting_text(c)}" for p, c in zip(prompts, codes)))
        if any(v[1] > TP_FULL_DRIFT for v in cmp.values()) or any(
                c is not None and c["levels"] != 1 for c in codes):
            raise AssertionError(f"{label} tp={TP} teacher-forced: {cmp}, codes {codes}")
        out["forced"][label] = dict(compare=cmp, codes=codes, path_diff=path_diff)
    launches = dict.fromkeys(counters(), 0)
    for key, want in ref.items():
        got = [r[key] for r in ranks]
        if got[1]["tokens"] != got[0]["tokens"]:
            raise AssertionError(f"{key} tp={TP}: the ranks emit different tokens")
        forced = out["forced"][key.split()[0]]
        cmp = tp_compare_tokens(key, (want["tokens"], want["logits"]),
                                (got[0]["tokens"], got[0]["logits"]), forced["path_diff"],
                                forced["codes"])
        m, one = got[0]["metrics"], want["metrics"]
        for r in got:
            for name, h in r["metrics"]["held_step"].items():
                if not h["ok"]:
                    raise AssertionError(f"{key} tp={TP} rank held step: {name} {h}")
        need = {"int8_matmul" if key.startswith("W8") else "int4_matmul", "_flash_fwd",
                "quantized_decode_attention" if key.endswith("scan")
                else "quantized_paged_attention"}
        if m["held_step"] and not need <= set(m["held_step"]):
            raise AssertionError(f"{key} tp={TP}: the held step held {set(m['held_step'])}")
        tr = m["transport"]
        log(f"  {key} tp={TP} (rank 0; the card's walls, two ranks sharing it): prefill "
            f"{m['prefill_s']:.3f} s, decode {m['decode_ms_per_step']:.2f} ms/step over "
            f"{m['decode_steps']} steps (one rank: {one['decode_ms_per_step']:.2f}), "
            f"{m['generated_tok_per_s']:.1f} generated tok/s; launches a step "
            f"{m['launches_per_step']} (one rank {one['launches_per_step']}); transport of one "
            f"decode step on the host's clock ({TP_TRANSPORT}): {tr['collectives']} collectives "
            f"in {1e3 * tr['transport_s']:.1f} ms of a {1e3 * tr['step_wall_s']:.1f} ms step (one "
            "lone collective, the card idle: " + ", ".join(
                f"{n} {1e3 * s:.3f} ms" for n, s in tr["lone_collective_s"].items()) + "); "
            "held step: " + ("; ".join(
                f"{n} {h['launches']} launches, max_abs_err {h['max_abs_err']:.3g}, worst "
                f"{h['worst']:.3g}" for n, h in m["held_step"].items()) or "none in this run"))
        out["runs"][key] = dict(tp=[r[key]["metrics"] for r in ranks], one_rank=one,
                                tokens=cmp)
        w4 = key.startswith("W4")
        for r in got:
            for rows, n in r["metrics"]["prefill_calls"]:
                want_n = {"flash_fwd": L}
                if w4 or -(-rows // 32) * 32 < QM.XLA_INT8_MIN_ROWS:
                    want_n["int4_matmul" if w4 else "int8_matmul"] = 10 * L
                if n != want_n:
                    raise AssertionError(f"{key} tp={TP}: a prefill call of {rows} rows "
                                         f"launched {n}, expected {want_n}")
            for k, v in (*r["metrics"]["decode_launches"].items(),
                         *r["metrics"]["prefill_launches"].items()):
                launches[k] += v
    held_names = {n for r in out["runs"].values() for n in r["tp"][0]["held_step"]}
    if held_names != {"int8_matmul", "int4_matmul", "quantized_decode_attention",
                      "quantized_paged_attention", "_flash_fwd"}:
        raise AssertionError(f"tp={TP}: the held steps held {held_names}")
    # the cut: TP against one device on the card, and one device against the
    # CPU path (whose K4 and cuBLAS products round otherwise), by the flip
    # rule; TP against the CPU path is their composition, shown
    out["cut"] = {}
    for n_tok in ranks[0]["cut"]:
        res = ranks[0]["cut"][n_tok]
        for path, r in res["steps"].items():
            codes = dict(res["codes"][path], tp_vs_one=join_partings(
                [rk["cut"][n_tok]["codes"][path]["tp_vs_one"] for rk in ranks]))
            log(f"  {CUT_LAYERS}-layer cut, {n_tok} tokens, {path}: greedy tokens equal and "
                "relative L2 drift per logit vector, and the first parting codes: " + "; ".join(
                    f"{k} {v[0]} [{', '.join(f'{d:.3g}' for d in v[1])}]"
                    + (f" codes {parting_text(codes[k])}" if k in codes else "")
                    for k, v in r.items()))
            for k, parting in codes.items():
                hold_flip(f"TP {CUT_LAYERS}-layer cut, {n_tok} tokens, {path}, {k}", r[k], parting)
            out["cut"][f"{n_tok} {path}"] = dict(steps=r, codes=codes)
    steps = TP_BEAM_NEW - 1
    for name, limit in (("full", BEAM_SCORE_REL), ("cut", BEAM_CUT_REL)):
        b0, b1, want = ranks[0]["beam"][name], ranks[1]["beam"][name], ref_beam[name]
        rel = abs(b0["score"] - want["score"]) / abs(want["score"])
        Lb = cut.num_hidden_layers if name == "cut" else L
        # the prefill's 64 rows take K1 too
        want_l = {"int8_matmul": 10 * Lb * (steps + 1), "decode_attention": Lb * steps,
                  "flash_fwd": Lb}
        ok = (b0["tokens"] == b1["tokens"] and b0["score"] == b1["score"] and rel <= limit
              and (name == "full" or b0["tokens"] == want["tokens"])
              and all(b["launches"] == want_l for b in (b0, b1)))
        log(f"  beam over TP, {name} ({Lb} layers), {BEAM_NUM} beams x {TP_BEAM_NEW} tokens: "
            f"{1e3 * b0['wall_s'] / TP_BEAM_NEW:.1f} ms a token (the card's wall, shared), "
            f"tokens {'equal to' if b0['tokens'] == want['tokens'] else 'part from'} one rank's, "
            f"score {rel:.3g} apart (limit {limit}); launches {b0['launches']}")
        if not ok:
            raise AssertionError(f"beam over TP {name}: {b0}, {b1}, one rank {want}")
        out["beam"][name] = dict(rank0=b0, one_rank=want, score_rel=rel)
        if name == "full":
            for b in (b0, b1):
                for k, n in b["launches"].items():
                    launches[k] += n
    mh = [r["multihost"] for r in ranks]
    served = {}
    for r in mh:
        served.update(r["served"])
        mine = [u for u, o in zip(r["uids"], r["owners"]) if o == r["host"]]
        if sorted(r["served"]) != sorted(mine) or r["hosts"] != 2:
            raise AssertionError(f"multi-host: host {r['host']} served {sorted(r['served'])}, "
                                 f"owns {mine}")
    want_toks = ref["W8A8KV8 scan"]["tokens"]
    if sorted(served) != list(range(len(prompts))) or any(
            served[u] != want_toks[u] for u in served):
        raise AssertionError(f"multi-host: served {served}, one rank {want_toks}")
    walls = ", ".join(f"{r['wall_s']:.2f} s" for r in mh)
    log(f"  multi-host driver, 2 hosts x tp 1 (W8A8KV8 scan path): {len(served)} requests, "
        f"each on its owner, tokens equal to one rank's; walls {walls}; launches a host "
        f"{mh[0]['launches']}")
    for r in mh:
        for k, n in r["launches"].items():
            launches[k] += n
    out["multihost"] = mh
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# the kernels at every head shape and K of the repo's models, and the two
# example scripts (tiny pipeline, accuracy experiment) on the card
# ---------------------------------------------------------------------------

SHAPES_SEED = 16                     # the shapes phase's generator
# K1/K2 at K no multiple of the 128-row stage: (model and projection, K, N) at
# decode rows; the tiny models' qkv (hidden 64), the accuracy model's down
# (768), LLaMA-7B's down at tp = 8 and tp = 4
K_TAIL_PROJ = (("tiny", "qkv", 64, 128), ("accuracy", "down", 768, 256),
               ("LLaMA-7B tp=8", "down", 1376, 4096), ("LLaMA-7B tp=4", "down", 2752, 4096))
# K3/K7/K8 at the new (G, hd): (kv heads, G, hd, model)
NEW_DECODE = ((2, 2, 16, "tiny"), (4, 2, 32, "accuracy"), (8, 4, 128, "LLaMA-3-8B"),
              (8, 8, 128, "LLaMA-2-70B"))
# every G of 1..8 query heads a kv head at head dims 64 and 128, the public GQA
# checkpoints' 8 kv heads (12 MHA heads of 64 for llama-68m): (G, hd) -> model
GQA_MODELS = {(1, 64): "llama-68m", (4, 64): "Llama-3.2-1B", (8, 64): "TinyLlama-1.1B heads",
              (1, 128): "LLaMA-7B heads", (3, 128): "Llama-3.2-3B", (4, 128): "LLaMA-3-8B",
              (7, 128): "Yi-34B", (8, 128): "LLaMA-2-70B"}
GQA_SHAPES = tuple((g, hd) for hd in (64, 128) for g in range(1, 9))
# K3 (int8, packed), K8 (int8) and K7 at those not already in NEW_DECODE
GQA_DECODE = tuple((12 if (g, hd) == (1, 64) else 8, g, hd, GQA_MODELS.get((g, hd), "-"))
                   for g, hd in GQA_SHAPES if (g, hd) not in ((4, 128), (8, 128)))
K9_SHAPE_KVH, K9_SHAPE_I = 8, 2048   # K9 at the 16 (G, hd): kv heads, intermediate size (2 layers)
# past 8 query heads a kv head (the builds of G = 9..15 and 16): K3 (int8,
# packed), K8 (int8) and K7 at (kv heads, G, hd, model), 8 kv heads but for
# Llama-3.1-405B's tp = 8 shard (16 query heads over one kv head of 128); K9
# at (G, hd) on the 2-layer cut of K9_SHAPE_KVH kv heads
WIDE_MODELS = {(12, 128): "Mistral-Large-2", (16, 128): "Llama-3.1-405B"}
WIDE_DECODE = tuple((8, g, hd, WIDE_MODELS.get((g, hd), "-")) for hd in (64, 128)
                    for g in (9, 12, 16)) + ((1, 16, 128, "Llama-3.1-405B tp=8 shard"),
                                             (8, 12, 100, "-"))
WIDE_K9 = ((12, 128), (16, 128), (12, 64))
WIDE_SHAPES_SEED = 27
# head dim 100 through the padded builds: K3 (int8, packed), K8 (int8, packed)
# and K7 at (kv heads, G, hd, model), K4 at OpenLLaMA-3B's prefill of 1024
# tokens (B = its 32 MHA heads, G = 1) in bf16 and f32. At 32 kv heads of 100
# the JAX picker's KV block is 8 columns (its cap 2**20 / (32 x 100) = 327 is
# odd, and it steps down by 8 to its floor): K3 and K7 walk 256 blocks a
# slot, and their plain versions take PAD_PLAIN_REPS timed runs
PAD_DECODE = ((32, 1, 100, "OpenLLaMA-3B"), (8, 4, 100, "-"), (8, 8, 100, "-"))
PAD_FLASH = (32, 1, 1024, 100)
PAD_PLAIN_REPS = 3
# K4/K10/K11 at every padded head dim of the repo's tests, bf16 and f32, causal
# and not (the ring's backward): (B, G, S), two query heads a kv head, S off
# the 64-row tiles; and at a tp = 2 rank's shard of OpenLLaMA-3B's train step
# (16 of its MHA heads of 100, 2 sequences); from a generator of their own
PAD_DIMS = (48, 80, 96, 100)
PAD_BWD = (4, 2, 1100)
PAD_TP_SHARD = (32, 1, 2048, 100)
PAD_BWD_SEED = 25
# head dim 256 (Falcon3's) through the hd-256 builds: K3 (int8, packed), K8
# (int8, packed) and K7 at (kv heads, G, hd, model), G = 1..4 over Falcon3's
# 4 kv heads; K4 at Falcon3-7B's prefill of 8 x 1024 tokens (B = 8 x 4 kv
# heads, G = 3) in bf16 and f32
D256_MODELS = {(2, 256): "Falcon3-1B", (3, 256): "Falcon3-7B"}
D256_DECODE = tuple((4, g, 256, D256_MODELS.get((g, 256), "-")) for g in range(1, 5))
D256_FLASH = (32, 3, 1024, 256)
D256_SHAPES_SEED = 29                # their generator (the other rows keep their inputs)
# K4/K10/K11 at the new head dims: (D, dtype, B, G, S, what); B = batch x kv heads
NEW_FLASH = ((16, torch.float32, 4, 2, 32, "tiny pipeline train"),
             (16, torch.float32, 16, 2, 2048, "long"),
             (16, torch.bfloat16, 16, 2, 2048, "long"),
             (32, torch.bfloat16, 128, 2, 256, "accuracy train"),
             (32, torch.float32, 16, 2, 2048, "long"),
             (32, torch.bfloat16, 16, 2, 2048, "long"),
             (128, torch.float32, 8, 1, 2048, "LLaMA-7B heads, long"))
F32_ULPS_REL, F32_FLOOR = 1e-5, 1e-4  # f32 kernels against their plain versions
TINY_SEQ, ACC_ARGV = 32, ("--teacher_steps", "4", "--qat_steps", "4", "--corpus_mb", "0.1")
ACC_SIZES = dict(n_mc=32, synth_per_shard=8, synth_rounds=1)  # main()'s keyword arguments


def f32_agreement(got, want):
    """Element-wise |got - want| <= 1e-5 |want| + 1e-4 median|want| (the f32
    kernels' limit of ``tests/test_torch_cuda_kernels.py``)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    med = float(w.abs().median())
    lim = F32_ULPS_REL * w.abs() + F32_FLOOR * med
    return dict(ok=bool(torch.isfinite(g).all()) and bool((err <= lim).all()),
                max_abs_err=float(err.max()), worst=float((err / lim.clamp_min(1e-30)).max()),
                median_abs_want=med, rel_l2=float((g - w).norm() / w.norm().clamp_min(1e-30)))


def flash_shape(timer, gen, FA, D, dtype, B, G, S, what, causal=True):
    """K4, K10 and K11 at one new (head dim, type): causal (or not), full
    lengths but one sequence cut mid-block and one of length 1; each against
    its plain version (bf16: ``agreement``; f32: ``f32_agreement``), the same
    bits on a second launch, exact zeros of dK/dV past the lengths.
    ``library_ms``: SDPA (causal or not) with ``enable_gqa`` (forward), its
    backward (dQ, dK, dV together) for K10 and K11; at the full lengths only
    the first sequence is cut, so SDPA computes a little more. Bounds: bf16
    at the tensor-core peak, f32 at the fp32 units', the work of the real
    head dim D (a padded build's tiles are 128 wide)."""
    q, do = (torch.randn(B, G, S, D, device="cuda", generator=gen).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, S, D, device="cuda", generator=gen).to(dtype) for _ in range(2))
    lens_l = [S] * B
    lens_l[-1], lens_l[-2] = 1, S // 2 + 3
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    hold = (lambda a, b: agreement(a, b, ATTN_ULPS, ATTN_FLOOR)) if dtype == torch.bfloat16 \
        else f32_agreement
    o, lse = FA._flash_fwd(q, k, v, lens, causal)
    o_again, _ = FA._flash_fwd(q, k, v, lens, causal)
    o2, lse2 = FA._flash_fwd_plain(q, k, v, lens, causal)
    args = (q, k, v, lens, lse, FA._delta(o, do), do, causal)
    dq, (dk, dv) = FA._flash_bwd_dq(*args), FA._flash_bwd_dkv(*args)
    dq_a, (dk_a, dv_a) = FA._flash_bwd_dq(*args), FA._flash_bwd_dkv(*args)
    dq2, (dk2, dv2) = FA._flash_bwd_dq_plain(*args), FA._flash_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    rows = [i for i, n in enumerate(lens_l) if n > 1]
    agr = {"fwd": hold(o[rows], o2[rows]), "dq": hold(dq[rows], dq2[rows]),
           "dk": hold(dk[rows], dk2[rows]), "dv": hold(dv[rows], dv2[rows])}
    lse_err = float((lse - lse2).abs().max())
    same = (torch.equal(o, o_again) and torch.equal(dq, dq_a) and torch.equal(dk, dk_a)
            and torch.equal(dv, dv_a))
    zeros = all(not t[b, max(n, 1):].any() for t in (dk, dv) for b, n in enumerate(lens_l))
    lse_lim = 1e-3 if dtype == torch.bfloat16 else 1e-5
    if not (all(a["ok"] for a in agr.values()) and same and zeros and lse_err <= lse_lim):
        raise AssertionError(f"flash D={D} {dtype} B={B} G={G} S={S} causal={causal}: {agr}, lse "
                             f"{lse_err}, the same bits twice {same}, zeros past the lengths "
                             f"{zeros}")
    del o_again, o2, lse2, dq, dk, dv, dq_a, dk_a, dv_a, dq2, dk2, dv2
    ms = {"fwd": timer(lambda: FA._flash_fwd(q, k, v, lens, causal)),
          "dq": timer(lambda: FA._flash_bwd_dq(*args)),
          "dkv": timer(lambda: FA._flash_bwd_dkv(*args))}
    plain = {"fwd": timer(lambda: FA._flash_fwd_plain(q, k, v, lens, causal), reps=3),
             "dq": timer(lambda: FA._flash_bwd_dq_plain(*args), reps=3),
             "dkv": timer(lambda: FA._flash_bwd_dkv_plain(*args), reps=3)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kh, vh = k[:, None], v[:, None]
    lib_fwd = timer(lambda: sdpa(q, kh, vh, is_causal=causal, enable_gqa=True))
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, kh, vh))
    out = sdpa(ql, kl, vl, is_causal=causal, enable_gqa=True)
    lib_bwd = timer(lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True))
    del out, ql, kl, vl
    es = torch.finfo(dtype).bits // 8
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    pairs = G * live_pairs(lens_l, S, causal)
    qb, kvb, rowb = es * B * G * S * D, es * B * S * D, 4 * B * G * S
    bounds = {"fwd": bound(2 * qb + 2 * kvb + rowb, 2 * 2 * pairs * D, peak),
              "dq": bound(3 * qb + 2 * kvb + 2 * rowb, 3 * 2 * pairs * D, peak),
              "dkv": bound(2 * qb + 4 * kvb + 2 * rowb, 4 * 2 * pairs * D, peak)}
    lib = {"fwd": lib_fwd, "dq": lib_bwd, "dkv": lib_bwd}
    tag = str(dtype)[6:]
    log(f"  flash D={D} {tag} B={B} G={G} S={S} {'causal' if causal else 'non-causal'} ({what}), "
        f"lengths full but {lens_l[-2]} and 1: "
        + "; ".join(f"{k_} {ms[k_]:.4f} ms (plain {plain[k_]:.3f}, sdpa {lib[k_]:.4f}, bound "
                    f"{bounds[k_][0]:.5f} {bounds[k_][1]})" for k_ in ms)
        + f"; max_abs_err fwd {agr['fwd']['max_abs_err']:.3g} dq {agr['dq']['max_abs_err']:.3g} "
        f"dk {agr['dk']['max_abs_err']:.3g} dv {agr['dv']['max_abs_err']:.3g}, worst "
        f"{max(a['worst'] for a in agr.values()):.3g} of its limit, lse {lse_err:.3g}; the same "
        "bits twice")
    shape = dict(B=B, G=G, S=S, D=D, dtype=tag, what=what, causal=causal, lengths=lens_l,
                 live_pairs=pairs)
    return {k_: dict(shape, ms=ms[k_], plain_ms=plain[k_], library_ms=lib[k_],
                     library_is=("sdpa causal" if causal else "sdpa")
                     + ("" if k_ == "fwd" else " backward, dQ+dK+dV"),
                     bound_ms=bounds[k_][0], bound_by=bounds[k_][1],
                     bit_identical_twice=True,
                     **(agr[k_] if k_ != "dkv" else dict(
                         agr["dk"], max_abs_err=max(agr["dk"]["max_abs_err"],
                                                    agr["dv"]["max_abs_err"]),
                         worst=max(agr["dk"]["worst"], agr["dv"]["worst"]))))
            for k_ in ms}


def gemm_splits_check(gen, QM, K, N, M=32):
    """K1 and K2 at ``[M, K] x [K, N]`` forced through every split count the
    plan could take: each bit-equal to the plain version."""
    x = torch.randn(M, K, device="cuda", generator=gen)
    w = torch.randn(K, N, device="cuda", generator=gen) * 0.02
    xq, sx = QM.quantize_per_token(x)
    done = {}
    for stem, wq, sw, plain in (("int8_matmul", *QM.quantize_per_channel(w),
                                 QM._int8_matmul_plain),
                                ("w4a8_matmul", *QM.quantize_weights_w4(w),
                                 QM._int4_matmul_plain)):
        want = plain(xq, wq, sx, sw, torch.bfloat16)
        plan = QM.gemm_plan(M, N, K, stem == "w4a8_matmul")
        splits = list(range(1, min(plan["steps"], QM.MAX_SPLITS) + 1))
        for s in splits:
            got = QM._launch_gemm(stem, stem, xq, wq, sx, sw, torch.bfloat16, M, N, K,
                                  plan=dict(plan, splits=s))
            if not torch.equal(got, want):
                raise AssertionError(f"{stem} M={M} K={K} N={N} at {s} splits: not bit-equal")
        done[stem] = splits
    return done


def shapes_phase(timer, QM, DA, FA):
    """Every kernel shape the repo's models and the public GQA checkpoints
    take beyond phase 2's, against its plain version and timed: K1/K2 at K
    no multiple of the 128-row stage (``K_TAIL_PROJ``, bit-equal, at every
    split count), K3, K8 and K7 at the new (G, hd) (``NEW_DECODE``, int8 and
    packed caches; K7 int8) and at every G of 1..8 at head dims 64 and 128
    (``GQA_DECODE``: K3 int8 and packed, K8 int8, K7; bit-equal) and at
    head dim 100 through the padded builds (``PAD_DECODE``: K3 and K8 int8
    and packed, K7; bit-equal), and past 8 query heads a kv head
    (``WIDE_DECODE``: K3 int8 and packed, K8 int8, K7 through the builds of
    G = 9..15 and 16; bit-equal), and at head dim 256 (``D256_DECODE``: K3
    and K8 int8 and packed, K7; bit-equal), K4/K10/K11 at head dims 16 and 32 in f32
    and bf16 and 128 in f32 (``NEW_FLASH``), K4 at head dim 100 in bf16 and
    f32 (``PAD_FLASH``), K4 at head dim 256 in bf16 and f32 (``D256_FLASH``),
    K4/K10/K11 at head dims 48, 80, 96 and 100 in bf16
    and f32, causal and not (``PAD_BWD``), and at a tp = 2 rank's shard of
    OpenLLaMA-3B's train step (``PAD_TP_SHARD``). Then K1 at
    the TinyLlama-1.1B decode layer's qkv shape through
    ``utils.benchmarking.measure`` (a CUDA graph of the runs, its
    floor subtracted) beside the ``Timer``'s median. Last (the megakernel
    compiles through the phases before it), K9 at the 16 (G, hd) and at
    ``WIDE_K9`` on a 2-layer cut (``megakernel_shape``, bit-equal). From a
    generator of its own (the shapes past 8 heads from another)."""
    from llm_qat_torch.models.config import TINYLLAMA_1B
    from llm_qat_torch.utils import benchmarking as B

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SHAPES_SEED)
    out = {"int8_matmul": [], "int4_matmul": [], "splits": {}}
    for model, proj, K, N in K_TAIL_PROJ:
        for name, fn, plain in (("int8_matmul", QM.int8_matmul, QM._int8_matmul_plain),
                                ("int4_matmul", QM.int4_matmul, QM._int4_matmul_plain)):
            out[name].append(gemm_shape(timer, gen, QM, name, fn, plain, model, proj, 32, K, N))
        out["splits"][f"K={K} N={N}"] = gemm_splits_check(gen, QM, K, N)
    out["decode_attention"], out["paged_attention"], out["decode_attention_stacked"] = [], [], []
    for kvh, G, hd, model in NEW_DECODE:
        for packed in (False, True):
            for key, fn in (("decode_attention", decode_attention_phase),
                            ("paged_attention", paged_attention_phase)):
                r = fn(timer, gen, DA, kvh, G, hd, packed)
                r.update(model=model, bit_equal=r["max_abs_err"] == 0.0)
                out[key].append(r)
        c = TINYLLAMA_1B.replace(num_attention_heads=kvh * G, num_key_value_heads=kvh,
                                 hidden_size=kvh * G * hd)
        r = stacked_attention_phase(timer, gen, DA, c)
        r.update(kvh=kvh, G=G, hd=hd, model=model, bit_equal=r["max_abs_err"] == 0.0)
        out["decode_attention_stacked"].append(r)
    for kvh, G, hd, model in GQA_DECODE:
        for key, fn, packs in (("decode_attention", decode_attention_phase, (False, True)),
                               ("paged_attention", paged_attention_phase, (False,))):
            for packed in packs:
                r = fn(timer, gen, DA, kvh, G, hd, packed)
                r.update(model=model, bit_equal=r["max_abs_err"] == 0.0)
                out[key].append(r)
        c = TINYLLAMA_1B.replace(num_attention_heads=kvh * G, num_key_value_heads=kvh,
                                 hidden_size=kvh * G * hd)
        r = stacked_attention_phase(timer, gen, DA, c)
        r.update(kvh=kvh, G=G, hd=hd, model=model, bit_equal=r["max_abs_err"] == 0.0)
        out["decode_attention_stacked"].append(r)
    for kvh, G, hd, model in PAD_DECODE:
        for packed in (False, True):
            for key, r in (("decode_attention", decode_attention_phase(
                                timer, gen, DA, kvh, G, hd, packed, plain_reps=PAD_PLAIN_REPS)),
                           ("paged_attention", paged_attention_phase(
                                timer, gen, DA, kvh, G, hd, packed))):
                r.update(model=model, bit_equal=r["max_abs_err"] == 0.0)
                out[key].append(r)
        c = TINYLLAMA_1B.replace(num_attention_heads=kvh * G, num_key_value_heads=kvh,
                                 hidden_size=kvh * G * hd)
        r = stacked_attention_phase(timer, gen, DA, c, plain_reps=PAD_PLAIN_REPS)
        r.update(kvh=kvh, G=G, hd=hd, model=model, bit_equal=r["max_abs_err"] == 0.0)
        out["decode_attention_stacked"].append(r)
    # past 8 query heads a kv head, from a generator of their own (the later
    # shapes keep their inputs)
    gen_wide = torch.Generator(device="cuda")
    gen_wide.manual_seed(WIDE_SHAPES_SEED)
    for kvh, G, hd, model in WIDE_DECODE:
        for key, fn, packs in (("decode_attention", decode_attention_phase, (False, True)),
                               ("paged_attention", paged_attention_phase, (False,))):
            for packed in packs:
                r = fn(timer, gen_wide, DA, kvh, G, hd, packed)
                r.update(model=model, bit_equal=r["max_abs_err"] == 0.0)
                out[key].append(r)
        c = TINYLLAMA_1B.replace(num_attention_heads=kvh * G, num_key_value_heads=kvh,
                                 hidden_size=kvh * G * hd)
        r = stacked_attention_phase(timer, gen_wide, DA, c)
        r.update(kvh=kvh, G=G, hd=hd, model=model, bit_equal=r["max_abs_err"] == 0.0)
        out["decode_attention_stacked"].append(r)
    gen_d256 = torch.Generator(device="cuda")
    gen_d256.manual_seed(D256_SHAPES_SEED)
    for kvh, G, hd, model in D256_DECODE:
        for packed in (False, True):
            for key, fn in (("decode_attention", decode_attention_phase),
                            ("paged_attention", paged_attention_phase)):
                r = fn(timer, gen_d256, DA, kvh, G, hd, packed)
                r.update(model=model, bit_equal=r["max_abs_err"] == 0.0)
                out[key].append(r)
        c = TINYLLAMA_1B.replace(num_attention_heads=kvh * G, num_key_value_heads=kvh,
                                 hidden_size=kvh * G * hd)
        r = stacked_attention_phase(timer, gen_d256, DA, c)
        r.update(kvh=kvh, G=G, hd=hd, model=model, bit_equal=r["max_abs_err"] == 0.0)
        out["decode_attention_stacked"].append(r)
    held = (set(GQA_SHAPES) | {(G, hd) for _, G, hd, _ in PAD_DECODE}
            | {(G, hd) for _, G, hd, _ in WIDE_DECODE} | {(G, hd) for _, G, hd, _ in D256_DECODE})
    gqa = [r for key in ("decode_attention", "paged_attention", "decode_attention_stacked")
           for r in out[key] if (r.get("G"), r.get("hd")) in held]
    if not all(r["bit_equal"] for r in gqa):
        raise AssertionError("K3/K8/K7 not bit-equal to their plain versions at "
                             + ", ".join(f"G={r['G']} hd={r['hd']}" for r in gqa
                                         if not r["bit_equal"]))
    out["flash"] = {"fwd": [], "dq": [], "dkv": []}
    for D, dtype, Bq, G, S, what in NEW_FLASH:
        for k_, r in flash_shape(timer, gen, FA, D, dtype, Bq, G, S, what).items():
            out["flash"][k_].append(r)
        torch.cuda.empty_cache()
    Bq, G, S, D = PAD_FLASH
    for dtype in (torch.bfloat16, torch.float32):
        out["flash"]["fwd"].append(dict(flash_phase(timer, gen, FA, Bq, G, S, D, dtype=dtype),
                                        what="OpenLLaMA-3B prefill"))
    Bq, G, S, D = D256_FLASH
    for dtype in (torch.bfloat16, torch.float32):
        out["flash"]["fwd"].append(dict(flash_phase(timer, gen_d256, FA, Bq, G, S, D,
                                                    dtype=dtype), what="Falcon3-7B prefill"))
    torch.cuda.empty_cache()
    gen_pad = torch.Generator(device="cuda")
    gen_pad.manual_seed(PAD_BWD_SEED)
    Bq, G, S = PAD_BWD
    pad = [(D, dtype, Bq, G, S, "padded build", causal) for D in PAD_DIMS
           for dtype in (torch.bfloat16, torch.float32) for causal in (True, False)]
    Bq, G, S, D = PAD_TP_SHARD
    pad.append((D, torch.bfloat16, Bq, G, S, "OpenLLaMA-3B train, a tp=2 rank's shard", True))
    for D, dtype, Bq, G, S, what, causal in pad:
        for k_, r in flash_shape(timer, gen_pad, FA, D, dtype, Bq, G, S, what, causal).items():
            out["flash"][k_].append(r)
    torch.cuda.empty_cache()
    # K1 through utils.benchmarking.measure, beside the Timer
    c = TINYLLAMA_1B
    K, N = c.hidden_size, (c.num_attention_heads + 2 * c.kv_heads) * c.head_dim
    xq, sx = QM.quantize_per_token(torch.randn(32, K, device="cuda", generator=gen))
    wq, sw = QM.quantize_per_channel(torch.randn(K, N, device="cuda", generator=gen) * 0.02)
    floor_s = B.dispatch_floor(iters=200, reps=3)
    per_s = B.measure(QM.int8_matmul, [xq, wq, sx, sw], iters=200, reps=3, floor=floor_s)
    timer_ms = timer(lambda: QM.int8_matmul(xq, wq, sx, sw))
    out["measure"] = dict(kernel="int8_matmul", M=32, K=K, N=N, measure_ms=per_s * 1e3,
                          measure_floor_ms_per_iter=floor_s * 1e3 / 200, timer_ms=timer_ms,
                          iters=200, reps=3)
    log(f"  K1 TinyLlama-1.1B qkv M=32 K={K} N={N}: utils.benchmarking.measure {per_s * 1e3:.4f} "
        f"ms a run (a CUDA graph of 200 runs, its floor {floor_s * 1e3 / 200:.4f} ms a run "
        f"subtracted; warm L2) against the Timer's {timer_ms:.4f} ms (L2 flushed, one launch "
        "between events)")
    out["decode_megakernel"] = ([megakernel_shape(timer, gen, G, hd) for G, hd in GQA_SHAPES]
                                + [megakernel_shape(timer, gen_wide, G, hd) for G, hd in WIDE_K9])
    return out


def k9_args(cfg, qparams, cache, lens_t, act, ids, S):
    """``decode_layers``' arguments for one step of ``cfg`` from this cache
    (bf16, the JAX picker's KV block)."""
    from llm_qat_torch.inference import megakernel as MK
    from llm_qat_torch.models import llama

    hd = cfg.head_dim
    x = qparams["embed"][ids[:, 0]].to(torch.bfloat16)
    qcos, qsin = llama.rope_cos_sin(lens_t[:, None], hd, cfg.rope_theta)
    qcos, qsin = qcos[:, 0, :hd // 2].contiguous(), qsin[:, 0, :hd // 2].contiguous()
    kcos, ksin = MK._cache_rope_tables(S, hd, cfg.rope_theta, ids.device)
    return (x, qcos, qsin, kcos, ksin, qparams["layers"], cache, lens_t, act, cfg,
            MK.pick_bk(cfg, len(lens_t), S), torch.bfloat16)


def megakernel_shape(timer, gen, G, hd, kvh=K9_SHAPE_KVH):
    """K9 at G query heads per kv head and head dim ``hd``: a CUT_LAYERS
    cut, ``kvh`` kv heads, intermediate size K9_SHAPE_I, W8A8KV8 "pre", b = 8,
    max_len 2048, lengths K9_LENS (slot K9_INACTIVE inactive): one step
    through the kernel and its plain version (``megakernel_step_check``),
    held bit-equal; the kernel's time, the plain version's and the bound."""
    from llm_qat_torch.inference import megakernel as MK
    from llm_qat_torch.inference import quantized as Q
    from llm_qat_torch.models import params as P
    from llm_qat_torch.models.config import LLAMA_7B

    cfg = LLAMA_7B.replace(num_hidden_layers=CUT_LAYERS, hidden_size=kvh * G * hd,
                           intermediate_size=K9_SHAPE_I, num_attention_heads=kvh * G,
                           num_key_value_heads=kvh, w_bits=8, a_bits=8, kv_bits=8)
    b, S = len(K9_LENS), 2048
    if not MK.card_takes(cfg, b, S, torch.bfloat16):
        raise AssertionError(f"K9 does not take G={G} hd={hd}")
    qp = Q.quantize_params(P.init_params(cfg, seed=SHAPES_SEED, dtype=torch.bfloat16), cfg)
    active = [i != K9_INACTIVE for i in range(b)]
    res, (cache, lens_t, act, ids) = megakernel_step_check(cfg, qp, K9_LENS, active, gen)
    if not (res["ok"] and res["bit_equal"]):
        raise AssertionError(f"K9 G={G} hd={hd}: not bit-equal to its plain version: {res}")
    args = k9_args(cfg, qp, cache, lens_t, act, ids, S)
    card = MK.card_weights(qp)
    ms = timer(lambda: MK.decode_layers(*args, card=card))
    plain_ms = timer(lambda: MK.decode_layers_plain(*args), reps=3)
    b_ms, b_by, nbytes = megakernel_bound(cfg, qp, K9_LENS, cache["k_q"].shape[3])
    model = {**GQA_MODELS, **WIDE_MODELS}.get((G, hd), "-")
    log(f"  decode_megakernel G={G} hd={hd} ({model}) kvh={kvh} "
        f"{CUT_LAYERS} layers H={cfg.hidden_size} I={K9_SHAPE_I} W8A8KV8 b={b} S={S} BK={args[10]}: "
        f"{ms:.4f} ms (plain {plain_ms:.3f}, bound {b_ms:.5f} {b_by}); bit-equal: K/V integers, "
        "scales, hidden and logits")
    return dict(G=G, hd=hd, kvh=kvh, model=model, layers=CUT_LAYERS,
                H=cfg.hidden_size, I=K9_SHAPE_I, mode="W8A8KV8", b=b, S=S, BK=args[10],
                lengths=list(K9_LENS), ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, max_abs_err=res["max_abs_err"],
                bit_equal=True)


def _example(name):
    """``examples/<name>.py`` as a module (the folder is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stage_counts(per_stage):
    """A ``stage_hook`` that files each stage's launch counts under its name
    and sets every count to 0 for the next stage."""
    def hook(name):
        per_stage[name] = read_counters()
        for fn in counters().values():
            fn.launches = 0
    return hook


def tiny_pipeline_phase():
    """``examples/tiny_pipeline_torch.py`` on the card as a user runs it
    (hidden 64, 4 / 2 heads: head dim 16, G = 2, f32), each stage's launches
    counted: K4/K10/K11 at D = 16 in the KD-QAT stage, K4 in its eval and the
    zero-shot stage, K1 at K = 64, K3 at (2, 16) and K4 in serving (scan
    path: the decode megakernel is not built for these heads). Then the
    exported student's logits on the card against the CPU path (1e-4 of the
    largest logit)."""
    from llm_qat_torch.models import convert
    from llm_qat_torch.models import llama as LL

    tiny = _example("tiny_pipeline_torch")
    per_stage = {}
    work = tempfile.mkdtemp(prefix="tiny_pipeline_")
    try:
        for fn in counters().values():
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = tiny.main(work, device="cuda", stage_hook=_stage_counts(per_stage))
        wall = time.perf_counter() - t0
        path = res["train"]["model_path"]
        ids = torch.randint(0, tiny.CONFIG.vocab_size, (2, TINY_SEQ),
                            generator=torch.Generator().manual_seed(SHAPES_SEED))
        logits = {}
        for dev in ("cuda", "cpu"):
            cfg, p = convert.load_hf_checkpoint(path, dtype=torch.float32, device=dev,
                                                w_bits=4, a_bits=8, kv_bits=4)
            with torch.no_grad():
                logits[dev] = LL.forward(p, cfg, ids.to(dev), dtype=torch.float32).cpu()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    drift = float((logits["cuda"] - logits["cpu"]).abs().max() / logits["cpu"].abs().max())
    total = {k: sum(s[k] for s in per_stage.values()) for k in counters()}
    want = ("int8_matmul", "decode_attention", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    ok = (all(total[k] > 0 for k in want) and total["decode_megakernel"] == 0
          and per_stage["qat"]["flash_bwd_dq"] > 0 and per_stage["serve"]["decode_attention"] > 0
          and per_stage["serve"]["int8_matmul"] > 0 and not any(per_stage["synthesis"].values())
          and math.isfinite(res["train"]["perplexity"]) and len(res["served"]) == 2
          and drift <= 1e-4)
    log(f"  tiny pipeline: {wall:.1f} s, {res['train']['train_steps']} QAT steps, eval ppl "
        f"{res['train']['perplexity']:.2f}, zero-shot acc {res['zero_shot']['acc']:.2f}, served "
        f"{[len(s) for s in res['served']]} characters; launches by stage "
        + "; ".join(f"{s}: " + ", ".join(f"{k} {n}" for k, n in c.items() if n)
                    for s, c in per_stage.items())
        + f"; the student's logits on the card against the CPU path {drift:.3g} of the largest")
    if not ok:
        raise AssertionError(f"tiny pipeline: launches by stage {per_stage}, logits drift {drift}, "
                             f"result {res}")
    return dict(wall_s=wall, perplexity=res["train"]["perplexity"],
                zero_shot=res["zero_shot"], served=res["served"], launches_by_stage=per_stage,
                launches=total, cpu_drift=drift)


def accuracy_phase():
    """``examples/accuracy_experiment_torch.py`` at the experiment's full
    model shape (hidden 256, 8 / 4 heads: head dim 32, G = 2, bf16, 32 x 256
    tokens) for a handful of steps (``ACC_ARGV``: 4 teacher and 4 QAT steps,
    a corpus of 0.1 MB; ``ACC_SIZES``: 32 examples a task, one synthesis round
    of 8 start tokens a shard): each stage's launches counted, K4/K10/K11 at D = 32 and
    K12 at hidden 256 in the QAT stage; results finite."""
    acc = _example("accuracy_experiment_torch")
    per_stage = {}
    work = tempfile.mkdtemp(prefix="accuracy_")
    try:
        for fn in counters().values():
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = acc.main([work, *ACC_ARGV], stage_hook=_stage_counts(per_stage), **ACC_SIZES)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    total = {k: sum(s[k] for s in per_stage.values()) for k in counters()}
    qat = per_stage["qat_w4a8kv4"]
    ok = (all(qat[k] > 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rmsnorm_quant"))
          and per_stage["teacher"]["flash_bwd_dkv"] > 0
          and all(math.isfinite(res[k]["ppl"]) for k in ("fp_teacher", "ptq", "qat")))
    log(f"  accuracy experiment ({' '.join(ACC_ARGV)}, {ACC_SIZES}): {wall:.1f} s; fp ppl "
        f"{res['fp_teacher']['ppl']}, PTQ {res['ptq']['ppl']}, QAT {res['qat']['ppl']}; seconds by "
        f"stage {res['timing']}; launches by stage "
        + "; ".join(f"{s}: " + ", ".join(f"{k} {n}" for k, n in c.items() if n)
                    for s, c in per_stage.items()))
    if not ok:
        raise AssertionError(f"accuracy experiment: launches by stage {per_stage}, results {res}")
    return dict(wall_s=wall, argv=list(ACC_ARGV), sizes=ACC_SIZES, results={k: res[k] for k in (
        "fp_teacher", "ptq", "qat", "timing")}, launches_by_stage=per_stage, launches=total)


T_START = time.perf_counter()
PHASE_S = {}
_LAP = [T_START]


def lap(name):
    """Seconds since the previous lap, kept as phase ``name``'s time."""
    now = time.perf_counter()
    PHASE_S[name] = now - _LAP[0]
    _LAP[0] = now
    log(f"    phase {name}: {PHASE_S[name]:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from llm_qat_torch.models.config import LLAMA_7B, TINYLLAMA_1B
    from llm_qat_torch.ops import _build
    from llm_qat_torch.ops import decode_attention as DA
    from llm_qat_torch.ops import flash_attention as FA
    from llm_qat_torch.ops import fused_quant as FQ
    from llm_qat_torch.ops import quant_matmul as QM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}")
    # every source starts compiling now; the megakernels, the slowest, and the
    # decode attention builds phase 2 first reads in its kernel attributes
    # (head dims 16, 32 and the padded build) go on compiling at a lower
    # priority through phase 2 and are waited for at their first use
    late = ("megakernel", "megakernel_d128", "megakernel_dpad", "megakernel_g16",
            "megakernel_d128_g16", "megakernel_dpad_g16", "megakernel_d256",
            "decode_attention_d16", "decode_attention_d32", "decode_attention_dpad",
            "decode_attention_d256")
    _build.build_all(wait_for=[p.stem for p in _build.CSRC.glob("*.cu") if p.stem not in late])
    log(f"    kernels built into {_build.BUILD_DIR} in "
        + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(_build.build_seconds.items()))
        + f"; {', '.join(s + '.cu' for s in late)} still compiling")
    lap("build")

    cfg = TINYLLAMA_1B                 # the default: use_megakernel=True
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = Timer()
    log("[2] kernels against their plain versions (TinyLlama-1.1B shapes, bf16)")
    gemm = gemm_phase(timer, gen, QM, cfg, LLAMA_7B)
    G = cfg.num_attention_heads // cfg.kv_heads
    # K3 at TinyLlama-1.1B's heads and at LLaMA-7B's (32 MHA heads of 128)
    dec = [decode_attention_phase(timer, gen, DA, kvh, g, hd, packed)
           for kvh, g, hd in ((cfg.kv_heads, G, cfg.head_dim), (32, 1, 128))
           for packed in (False, True)]
    # and at S = 8192, over the cache-length limit of K3's first version (32768 / G)
    dec.append(decode_attention_phase(timer, gen, DA, cfg.kv_heads, G, cfg.head_dim, False,
                                      S=8192, lens_l=LONG_LENS))
    # S = 1536 and 1800 cross the TPU kernel's key blocks (2 x 768, 15 x 120)
    fl = [flash_phase(timer, gen, FA, cfg.kv_heads, G, S, cfg.head_dim)
          for S in (1024, 128, 1536, 1800)]
    # K4 at the zero-shot scorer's buckets (32, 64) and caps (100, 200): 16 rows, ragged;
    # from a generator of its own, so the other phases keep their inputs
    gen_scorer = torch.Generator(device="cuda")
    gen_scorer.manual_seed(EVAL_SEED)
    fls = [flash_phase(timer, gen_scorer, FA, len(scorer_lens(S)), G, S, cfg.head_dim,
                       scorer_lens(S)) for S in SCORER_S]
    # K4 at LLaMA-7B's attention shape (32 MHA heads of 128), full and ragged lengths
    fl7 = [flash_phase(timer, gen, FA, 32, 1, 1024, 128, lens) for lens in (None, LLAMA7B_LENS)]
    # K8 at TinyLlama-1.1B's attention shape and at LLaMA-7B's (32 MHA heads of 128)
    pag = [paged_attention_phase(timer, gen, DA, kvh, g, hd, packed)
           for kvh, g, hd in ((cfg.kv_heads, G, cfg.head_dim), (32, 1, 128))
           for packed in (False, True)]
    k7 = stacked_attention_phase(timer, gen, DA, cfg)
    ftr = flash_train_phase(timer, gen, FA, G, cfg.head_dim, TRAIN_LENS)
    # and at LLaMA-7B's attention (32 MHA heads of 128), one sequence of 2048
    ftr7 = flash_train_phase(timer, gen, FA, 1, 128, LLAMA7B_TRAIN_LENS)
    # what the compiler gave the tensor-core kernels, and the grids they ran
    attrs = FA.kernel_attributes()
    attrs["flash_fwd"]["blocks"] = {"B=4 G=8 S=1024": fl[0]["blocks"],
                                    "B=16 G=8 S=2048": ftr["full"]["fwd"]["blocks"]}
    attrs["flash_fwd_d128"]["blocks"] = {"B=32 G=1 S=1024": fl7[0]["blocks"],
                                         "B=32 G=1 S=2048": ftr7["full"]["fwd"]["blocks"]}
    for name, shapes in (("flash_bwd_dq", ftr), ("flash_bwd_dq_d128", ftr7)):
        attrs[name]["blocks"] = {f"B={shapes['full']['dq']['B']} G={shapes['full']['dq']['G']} "
                                 "S=2048": shapes["full"]["dq"]["blocks"]}
    for name, shapes in (("flash_bwd_dkv", ftr), ("flash_bwd_dkv_d128", ftr7)):
        attrs[name]["blocks"] = {f"B={shapes['full']['dkv']['B']} G={shapes['full']['dkv']['G']} "
                                 "S=2048": shapes["full"]["dkv"]["blocks"]}
    attrs.update({f"gemm_{k}": v for k, v in QM.kernel_attributes().items()})
    attrs.update(DA.kernel_attributes())
    attrs.update(FQ.kernel_attributes())
    if any(a["spill_bytes"] for a in attrs.values()):
        raise AssertionError(f"a tensor-core kernel, a K1/K2, a K3/K7/K8 or a K12/K13 variant "
                             f"spills registers: {attrs}")
    fq = fused_quant_phase(timer, gen, FQ, cfg)
    lap("[2] kernels")
    log("[2b] the shapes beyond phase 2's, against their plain versions: K1/K2 at K = 64, 768, "
        "1376, 2752 (every split count), K3/K8/K7 at (G, hd) = (2, 16), (2, 32), (4, 128), "
        "(8, 128) and at every G of 1..8 at head dims 64 and 128, K4/K10/K11 at head dims 16 "
        "and 32 (f32, bf16) and 128 (f32), K3/K8/K7 and K4 at head dim 100 and K4/K10/K11 at "
        "head dims 48, 80, 96, 100 (f32, bf16, causal and not) and a tp=2 rank's shard of "
        "OpenLLaMA-3B through the padded builds; K3/K8/K7 at G = 9, 12, 16 at head dims 64 and "
        "128 (8 kv heads; 1 kv head at (16, 128), Llama-3.1-405B's tp = 8 shard) and G = 12 at "
        "100; K3/K8/K7 at G = 1..4 and K4 at head dim 256 (Falcon3's); K1 through "
        "utils.benchmarking.measure; K9 at every G of 1..8 at head dims 64 and "
        "128, and at (12, 128), (16, 128), (12, 64), on a 2-layer cut")
    shp = shapes_phase(timer, QM, DA, FA)
    lap("[2b] new shapes")

    log("[3] TinyLlama-1.1B, 22 layers: the stacked GEMMs on the served weights, the "
        f"decode megakernel against its plain version, then serving 8 requests x {SERVE_NEW} new "
        "tokens: max_len 2048 on the scan path (use_megakernel=False) and on the default "
        f"path, then paged (pages of {PAGE}, {SEQ_PAGES} a sequence) from a pool of "
        f"{ROOMY_PAGES} and of {TIGHT_PAGES} pages")
    from llm_qat_torch.inference import megakernel as MK
    from llm_qat_torch.inference import quantized as Q
    from llm_qat_torch.models import params as P

    mk_attrs = {f"decode_megakernel_{k}": v for k, v in MK.kernel_attributes().items()}
    log("    " + ", ".join(f"{stem}.cu built, {_build.build_seconds.get(stem, 0.0):.1f} s"
                          for stem in MK._STEMS.values()) + " after the build started")
    if any(a["spill_bytes"] for a in mk_attrs.values()):
        raise AssertionError(f"K9 spills registers: {mk_attrs}")
    attrs.update(mk_attrs)

    rng = np.random.default_rng(0)
    modes = {
        "W8A8KV8": cfg.replace(w_bits=8, a_bits=8, kv_bits=8),
        "W4A8KV4": cfg.replace(w_bits=4, a_bits=8, kv_bits=4, kv_cache_pack=True),
    }
    # kernel phase and both serving runs of a mode first, then the CPU checks
    # (the CPU path's thread pool would share the host with the timed loops)
    mega, runs, served, flips, qps, checks = [], [], {}, {}, {}, []
    paged_runs, stacked = [], {}
    for label, mcfg in modes.items():
        prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n))) for n in PROMPT_LENS]
        params = P.init_params(mcfg, seed=0, dtype=torch.bfloat16)
        qps[label] = Q.quantize_params(params, mcfg)
        del params
        torch.cuda.empty_cache()
        stacked[label] = stacked_gemm_phase(timer, gen, QM, qps[label], mcfg.w_bits == 4)
        mega.append(megakernel_phase(timer, label, mcfg, qps[label], gen))
        scan = serve(f"{label} scan", mcfg.replace(use_megakernel=False), qps[label], prompts)
        dflt = serve(f"{label} megakernel", mcfg, qps[label], prompts)
        roomy = serve_paged(f"{label} paged roomy", mcfg, qps[label], prompts, ROOMY_PAGES,
                            profile=True)
        tight = serve_paged(f"{label} paged tight", mcfg, qps[label], prompts, TIGHT_PAGES,
                            profile=False)
        served[label] = (scan, dflt, roomy)
        runs += [scan[0], dflt[0]]
        paged_runs += [roomy[0], tight[0]]
    lap("[3] TinyLlama serving")
    log("[3b] LLaMA-7B, 32 layers, 32 MHA heads of 128: the decode megakernel against its "
        "plain version at W8A8KV8 and W4A8KV4, then serving the same 8 requests at "
        f"{', '.join(LLAMA7B_SERVE)} on the default path and on the scan path")
    l7 = llama7b_phase(timer, gen, LLAMA_7B, prompts)
    mega += l7["kernel"]
    runs += l7["runs"]
    flips.update({f"{k} LLaMA-7B": v for k, v in l7["flips"].items()})
    lap("[3b] LLaMA-7B serving")
    log(f"[3b2] LLaMA-3-8B's published widths (32 query and 8 kv heads of 128, vocabulary "
        f"128256, rope_theta 500000), its 32 layers cut to {LLAMA3_LAYERS}, random weights: the "
        f"decode megakernel against its plain version at W8A8KV8 and W4A8KV4, then 8 requests x "
        f"{LLAMA3_NEW} greedy tokens on the default path (K9), the scan path (K3) and the paged "
        f"engine (K8) ({smi})")
    l3 = llama3_phase(timer, gen, LLAMA_7B)
    mega += l3["kernel"]
    flips.update({f"{k} LLaMA-3-8B": v for k, v in l3["flips"].items()})
    lap("[3b2] LLaMA-3-8B serving")
    log(f"[3b3] OpenLLaMA-3B's published widths at full depth (26 layers, 32 MHA heads of 100, "
        f"H 3200, I 8640, vocabulary 32000), random weights: head dim 100 through the padded "
        f"builds of K4, K3/K8 and K9, the products' K off the 256 grid; K9 against its plain "
        f"version at W8A8KV8 and W4A8KV4, then 8 requests x {OPENLLAMA_NEW} greedy tokens on the "
        f"default path (K9), the scan path (K3) and the paged engine (K8); a {CUT_LAYERS}-layer "
        f"cut against the CPU path ({smi})")
    o3 = openllama3b_phase(timer, gen, LLAMA_7B)
    mega += o3["kernel"]
    flips.update({f"{k} OpenLLaMA-3B": v for k, v in o3["flips"].items()})
    lap("[3b3] OpenLLaMA-3B serving")
    log(f"[3b4] G > 8 serving: Mistral-Large-2's published widths (96 query and 8 kv heads of "
        f"128, G = 12, H 12288, I 28672, vocabulary 32768, rope_theta 1e6) and Llama-3.1-405B's "
        f"(128 and 8 heads of 128, G = 16, H 16384, I 53248, vocabulary 128256, rope_theta "
        f"5e5; rope_scaling left out), each cut to {WIDE_LAYERS} layers, random weights: K9 "
        f"against its plain version at the default path's b, then 8 requests x {LLAMA3_NEW} "
        f"greedy tokens on the default path (K9's 9..16 build; b = 8 at Mistral-Large-2 W4A8KV4, "
        f"b = 1 at its W8A8KV8 and at Llama-3.1-405B W4A8KV4, as JAX's supported() routes), the "
        f"scan path (K3) and the paged engine (K8) at b = 8 ({smi})")
    wg = wide_groups_phase(timer, gen, LLAMA_7B)
    mega += wg["kernel"]
    flips.update(wg["flips"])
    lap("[3b4] G > 8 serving")
    log(f"[3b5] Falcon3-7B-Base's published widths at full depth (28 layers, 12 query and 4 kv "
        f"heads of 256, H 3072, I 23040, vocabulary 131072, rope_theta 1000042), random weights: "
        f"head dim 256 through K4's, K3/K8's and K9's hd-256 builds; K9 against its plain "
        f"version at W8A8KV8 and W4A8KV4, then 8 requests x {FALCON3_NEW} greedy tokens on the "
        f"default path (K9), the scan path (K3) and the paged engine (K8); a {CUT_LAYERS}-layer "
        f"cut against the CPU path ({smi})")
    fc = falcon3_phase(timer, gen, LLAMA_7B)
    mega += fc["kernel"]
    flips.update({f"{k} Falcon3-7B": v for k, v in fc["flips"].items()})
    del timer
    lap("[3b5] Falcon3-7B serving")
    for label, mcfg in modes.items():
        checks.append(cpu_check(label, mcfg, qps.pop(label), rng))
        scan, dflt, roomy = served.pop(label)
        flips[label] = compare_tokens(label, scan, dflt,
                                      checks[-1]["full_depth"]["megakernel_vs_scan"][2])
        # the floor keeps the rule meaningful should the paths agree to the bit
        flips[label + " paged"] = compare_tokens(
            label, scan, roomy, max(checks[-1]["full_depth"]["paged_vs_scan"][2],
                                    checks[-1]["full_depth"]["kernels_vs_plain"][2]),
            other="paged")
    lap("[3c] GPU against CPU")

    log(f"[4] KD-QAT training, TinyLlama-1.1B W4A8KV4, bf16, {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens, kl_chunk {KL_CHUNK}: {TRAIN_WARM} + {TRAIN_STEPS} steps at full depth, "
        f"the same at LLaMA-7B widths on a {LLAMA7B_TRAIN_LAYERS}-layer cut at "
        f"{LLAMA7B_TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"{SILU_STEPS} steps on a {SILU_LAYERS}-layer cut with and without fused_silu_quant, "
        f"one step on a {CUT_LAYERS}-layer cut against the plain versions (and, for "
        "TinyLlama-1.1B, the CPU path)")
    torch.cuda.empty_cache()
    trains = train_phases(cfg, LLAMA_7B)
    tcheck = {"TinyLlama-1.1B": train_check(cfg),
              "LLaMA-7B width": train_check(LLAMA_7B, with_cpu=False)}
    lap("[4] training")
    log(f"[4i] KD-QAT training of OpenLLaMA-3B at its published widths and full depth (26 "
        f"layers, 32 MHA heads of 100, H 3200, I 8640, vocabulary 32000), W4A8KV4, bf16: K4, "
        f"K10 and K11 at its attention shape through the padded builds (B={len(O3_TRAIN_LENS)} "
        f"G=1 S={TRAIN_SEQ} D=100, full and ragged lengths) against their plain versions, "
        f"{TRAIN_WARM} + {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens through "
        f"Trainer (kl_chunk {KL_CHUNK}), a {CUT_LAYERS}-layer cut against the plain versions "
        f"({smi})")
    o3t = openllama3b_train_phase(Timer(), LLAMA_7B)
    trains.append(o3t["train"])
    tcheck["OpenLLaMA-3B width"] = o3t["train_check"]
    lap("[4i] OpenLLaMA-3B training")
    log(f"[4b] the reference's pipeline at TinyLlama-1.1B's full width and depth through the "
        f"port's entry points: HF teacher checkpoint, synthesis ({3 * PIPE_VOCAB} documents of "
        f"{PIPE_LEN} tokens), cli.train.run ({PIPE_STEPS} steps of {TRAIN_SEQ} tokens, export, "
        f"eval), resume on a {PIPE_RESUME_LAYERS}-layer cut ({smi})")
    pipe = pipeline_phase(cfg)
    student_dir = pipe.pop("student_dir")
    lap("[4b] pipeline")
    log(f"[4c] evaluation at TinyLlama-1.1B's full width and depth through the port's entry "
        f"points: cli.eval.main on the pipeline's student (8 tasks x {EVAL_DOCS} docs, "
        f"perplexity over {EVAL_PPL_BLOCKS} x {EVAL_PPL_BLOCK} tokens, a --max_len {EVAL_CAP} "
        f"run), beam search ({BEAM_NUM} beams x {BEAM_NEW} tokens, prompts {BEAM_PROMPTS}, "
        f"W8A8KV8 and W4A8KV4), classify ({smi})")
    try:
        ev = eval_phase(cfg, os.path.join(student_dir, "model"))
    finally:
        shutil.rmtree(student_dir, ignore_errors=True)
    lap("[4c] eval")
    log(f"[4d] multi-device KD-QAT training at TinyLlama-1.1B's full width, {MD_LAYERS} layers, "
        f"two ranks on the one card ({MD_TRANSPORT}): FSDP fsdp=2 ({MD_BATCH} x {MD_SEQ} tokens, "
        f"{MD_WARM} + {MD_STEPS} steps), CP cp=2 ({MD_CP_BATCH} x {MD_CP_SEQ} tokens, "
        f"{MD_CP_WARM} + {MD_CP_STEPS} steps, ring transport bf16 and int8), {CUT_LAYERS}-layer "
        f"cuts against one device, K4/K10/K11 non-causal at the ring's shape, NCCL at world 1 "
        f"through the train CLI ({smi})")
    md = multi_device_phase(cfg)
    lap("[4d] multi-device training")
    log(f"[4e] tensor-parallel serving at TinyLlama-1.1B's full width, {TP_LAYERS} of its "
        f"{cfg.num_hidden_layers} layers, tp={TP} ranks on the one card ({TP_TRANSPORT}): "
        f"InferenceEngine(mesh=) and "
        f"PagedInferenceEngine(mesh=) at W8A8KV8 and W4A8KV4, {len(TP_PROMPT_LENS)} requests x "
        f"{TP_NEW} tokens, against one rank; a held step; a {CUT_LAYERS}-layer cut against the "
        f"CPU path; beam search over TP; the multi-host driver as 2 hosts x tp 1 ({smi})")
    tp = tp_serving_phase(cfg.replace(num_hidden_layers=TP_LAYERS))
    lap("[4e] tensor-parallel serving")
    log(f"[4f] tensor-parallel and pipeline KD-QAT training at TinyLlama-1.1B's full width, "
        f"{MD_LAYERS} layers, two ranks on the one card ({MD_TRANSPORT}): tp={TPP_TP} without and "
        f"with fused_silu_quant, pp={TPP_PP} with {TPP_MICRO} microbatches ({TPP_BATCH} x "
        f"{TPP_SEQ} tokens, {TPP_WARM} + {TPP_STEPS} steps each), {CUT_LAYERS}-layer f32 cuts "
        f"against one device, the train CLI with --mesh_tp 2 and --mesh_pp 2; K4/K10/K11 at a "
        f"tp rank's shard and K13's tp entries ({smi})")
    tpp = tp_pp_train_phase(cfg)
    lap("[4f] tp/pp training")
    log(f"[4g] examples/tiny_pipeline_torch.py on the card: teacher, synthesis, KD-QAT W4A8KV4, "
        f"zero-shot, W8A8KV8 serving on a model of head dim 16, two query heads a kv head, f32 "
        f"({smi})")
    tinyp = tiny_pipeline_phase()
    lap("[4g] tiny pipeline")
    log(f"[4h] examples/accuracy_experiment_torch.py at the experiment's model shape (head dim "
        f"32, two query heads a kv head, bf16, 32 x 256 tokens) for a handful of steps ({smi})")
    accp = accuracy_phase()
    lap("[4h] accuracy experiment")

    # each path went through its kernels, and only through them
    for m in runs:
        gemm_k = "int8_matmul" if m["mode"].startswith("W8") else "int4_matmul"
        dl, pl = m["decode_launches"], m["prefill_launches"]
        if m["mode"].endswith("scan"):
            ok = (dl[gemm_k] > 0 and dl["decode_attention"] > 0 and pl["flash_fwd"] > 0
                  and m["launches"]["decode_megakernel"] == 0)
        else:
            ok = (dl["decode_megakernel"] == m["decode_steps"] and pl[gemm_k] > 0
                  and pl["flash_fwd"] > 0 and dl["int8_matmul"] == dl["int4_matmul"] == 0
                  and dl["decode_attention"] == 0)
        if not (ok and m["launches"]["paged_attention"] == 0):
            raise AssertionError(f"{m['mode']}: launches off the path: prefill {pl}, decode {dl}")
    L = cfg.num_hidden_layers
    for m in paged_runs:
        gemm_k = "int8_matmul" if m["mode"].startswith("W8") else "int4_matmul"
        dl, pl, al = m["decode_launches"], m["prefill_launches"], m["launches"]
        ok = (dl["paged_attention"] == L * m["decode_steps"] and pl["paged_attention"] == 0
              and dl[gemm_k] > 0 and pl["flash_fwd"] > 0
              and al["decode_attention"] == al["decode_megakernel"] == 0
              and al["decode_attention_stacked"] == 0)
        if not ok:
            raise AssertionError(f"{m['mode']}: launches off the path: prefill {pl}, decode {dl}")
        if m["mode"].endswith("tight") and m["preemptions"] < 1:
            raise AssertionError(f"{m['mode']}: a pool of {m['n_pages']} pages preempted nothing")

    def per_layer(shapes, M, model="TinyLlama-1.1B"):
        sel = [s for s in shapes if s["M"] == M and s.get("model", model) == model]
        tot = lambda key: sum(s[key] for s in sel)  # noqa: E731
        lib = [s["library_ms"] for s in sel]
        return dict(ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
                    library_ms=None if None in lib else sum(lib),
                    bound_by=sel[0]["bound_by"],
                    max_abs_err=max(s["max_abs_err"] for s in sel))

    launches = {k: sum(m["launches"][k] for m in runs + paged_runs + trains) + pipe["launches"][k]
                + ev["launches"][k] + md["launches"][k] + tp["launches"][k]
                + tpp["launches"][k] + tinyp["launches"][k] + accp["launches"][k]
                + l3["launches"][k] + o3["launches"][k] + wg["launches"][k] + fc["launches"][k]
                for k in counters()}
    # K5-K7 are on no serving path of either package: their counts are those
    # of their kernel phases
    launches["int8_matmul_stacked"] = stacked["W8A8KV8"]["launches"]
    launches["int4_matmul_stacked"] = stacked["W4A8KV4"]["launches"]
    launches["decode_attention_stacked"] = k7["launches"]
    k8 = pag[0]
    k9 = mega[0]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")
    ftro = o3t["flash"]
    fwd_shapes = fl + fls + [ftr["full"]["fwd"], ftr["ragged"]["fwd"]] + fl7 + [
        ftr7["full"]["fwd"], ftr7["ragged"]["fwd"], ftro["full"]["fwd"], ftro["ragged"]["fwd"]]
    train_shape = ("B=16 G=8 S=2048 D=64 causal bf16, full lengths (lengths full, ragged, 1 "
                   "and 0, LLaMA-7B heads B=32 G=1 S=2048 D=128 and OpenLLaMA-3B's B=128 G=1 "
                   "S=2048 D=100 through the padded build, full and ragged, the ring's live step "
                   "B=8 G=8 S=2048 D=64 non-causal, and the padded build at head dims 48, 80, "
                   "96, 100 causal and not and at a tp=2 rank's shard of OpenLLaMA-3B, in "
                   "shapes)")
    rows = [
        dict(name="int8_matmul", source="llm_qat_torch/csrc/int8_matmul.cu",
             replaces="llm_qat_tpu/ops/pallas/quant_matmul.py:77",
             shape="one TinyLlama-1.1B decode layer: qkv+o+gateup+down at M=32 (LLaMA-7B's "
                   "and a tp=2 rank's shard shapes in shapes); library_ms: torch._int_mm on the "
                   "K-contiguous weight (row-major: library_rowmajor_ms in shapes)",
             **per_layer(gemm["int8_matmul"], 32),
             shapes=gemm["int8_matmul"] + tp["shapes"]["int8_matmul"] + shp["int8_matmul"]),
        dict(name="int4_matmul", source="llm_qat_torch/csrc/w4a8_matmul.cu",
             replaces="llm_qat_tpu/ops/pallas/quant_matmul.py:394",
             shape="one TinyLlama-1.1B decode layer: qkv+o+gateup+down at M=32 (prefill rows "
                   "1024 and 4096, LLaMA-7B's at 32 and 1024, and a tp=2 rank's shard shapes, "
                   "in shapes)",
             **per_layer(gemm["int4_matmul"], 32),
             shapes=gemm["int4_matmul"] + tp["shapes"]["int4_matmul"] + shp["int4_matmul"]),
        dict(name="decode_attention", source="llm_qat_torch/csrc/decode_attn.cuh",
             replaces="llm_qat_tpu/ops/pallas/decode_attention.py:55",
             shape="b=8 S=2048 int8 cache, TinyLlama-1.1B heads (packed KV4, LLaMA-7B "
                   "heads kvh=32 G=1 hd=128, S=8192, a tp=2 rank's kvh=2, every G of 1..8 "
                   "at hd 64 and 128, and (1, 4, 8) at hd 100 through the padded build, "
                   "G = 9, 12, 16 at hd 64 and 128 (Mistral-Large-2's (12, 128), "
                   "Llama-3.1-405B's (16, 128) and its tp=8 shard's one kv head) and 12 at "
                   "hd 100 through the builds of 9..15 and 16, and G = 1..4 at hd 256, in "
                   "shapes; Mistral-Large-2 and Llama-3.1-405B on the scan path in "
                   "wide_groups, Falcon3-7B's (3, 256) in falcon3_7b)",
             **{k: dec[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                       "bound_by")},
             max_abs_err=max(d["max_abs_err"] for d in dec + tp["shapes"]["decode_attention"]
                             + shp["decode_attention"]),
             shapes=dec + tp["shapes"]["decode_attention"] + shp["decode_attention"]),
        dict(name="flash_fwd", source="llm_qat_torch/csrc/flash_attention.cu",
             replaces="llm_qat_tpu/ops/pallas/flash_attention.py:94",
             shape="B=4 G=8 S=1024 D=64 causal (S=128, the scorer's B=64 at S=32, 64, 100 and "
                   "200 at ragged lengths, the train shape B=16 S=2048 at full and "
                   "ragged lengths, LLaMA-7B's B=32 G=1 S=1024 and S=2048 D=128 at full and "
                   "ragged lengths, the ring's live step B=8 G=8 S=2048 D=64 non-causal, "
                   "and OpenLLaMA-3B's B=32 G=1 S=1024 D=100 in bf16 and f32 and its train "
                   "shape B=128 G=1 S=2048 D=100 through the padded build, and Falcon3-7B's "
                   "prefill B=32 G=3 S=1024 D=256 in bf16 and f32, in shapes)",
             **{k: fl[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by")},
             max_abs_err=max(f["max_abs_err"] for f in fwd_shapes + [md["ring_shape"]["fwd"],
                                                                     tpp["shard_shape"]["fwd"]]
                             + shp["flash"]["fwd"]),
             shapes=fwd_shapes + [md["ring_shape"]["fwd"], tpp["shard_shape"]["fwd"]]
             + shp["flash"]["fwd"]),
        dict(name="decode_megakernel", source="llm_qat_torch/csrc/megakernel.cuh",
             replaces="llm_qat_tpu/inference/megakernel.py:259",
             shape="one decode step, 22 layers, b=8 S=2048 W8A8KV8 (W4A8KV4 packed, "
                   "LLaMA-7B's 32 layers of (1, 128) heads, LLaMA-3-8B's widths on 4 "
                   "layers ((4, 128) heads) and OpenLLaMA-3B's 26 layers of (1, 100) heads "
                   "(the padded build) at both, Mistral-Large-2's (12, 128) heads at W4A8KV4 "
                   "b=8 and W8A8KV8 b=1 and Llama-3.1-405B's (16, 128) at W4A8KV4 b=1 on "
                   "2-layer cuts of their widths (the builds of G = 9..16), Falcon3-7B's 28 "
                   "layers of (3, 256) heads (the hd-256 build) at both, and a 2-layer cut "
                   "at every G of 1..8 at hd 64 and 128 and at (12, 128), (16, 128), (12, 64), "
                   "in shapes)",
             **{k: k9[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
             max_abs_err=max(m["max_abs_err"] for m in mega + shp["decode_megakernel"]),
             shapes=mega + shp["decode_megakernel"]),
        dict(name="paged_attention", source="llm_qat_torch/csrc/decode_attn.cuh",
             replaces="llm_qat_tpu/ops/pallas/decode_attention.py:646",
             shape=f"b=8, pool {ROOMY_PAGES} x {PAGE}, {SEQ_PAGES} pages a sequence, int8 pool, "
                   "TinyLlama-1.1B heads (packed KV4, LLaMA-7B heads, a tp=2 rank's kvh=2, "
                   "every G of 1..8 at hd 64 and 128, (1, 4, 8) at hd 100, G = 9, 12, "
                   "16 at hd 64 and 128 and 12 at hd 100, and G = 1..4 at hd 256 in shapes; "
                   "Mistral-Large-2 and Llama-3.1-405B in wide_groups, Falcon3-7B in "
                   "falcon3_7b)",
             **{k: k8[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
             max_abs_err=max(d["max_abs_err"] for d in pag + tp["shapes"]["paged_attention"]
                             + shp["paged_attention"]),
             shapes=pag + tp["shapes"]["paged_attention"] + shp["paged_attention"]),
        dict(name="int8_matmul_stacked", source="llm_qat_torch/csrc/int8_matmul.cu",
             replaces="llm_qat_tpu/ops/pallas/quant_matmul.py:237",
             shape=f"layer {STACK_LAYER} of the stacked weights: qkv+o+gateup+down at M=32",
             **per_layer(stacked["W8A8KV8"]["shapes"], 32), shapes=stacked["W8A8KV8"]["shapes"],
             launches_from="kernel phase (on no serving path)"),
        dict(name="int4_matmul_stacked", source="llm_qat_torch/csrc/w4a8_matmul.cu",
             replaces="llm_qat_tpu/ops/pallas/quant_matmul.py:486",
             shape=f"layer {STACK_LAYER} of the stacked weights: qkv+o+gateup+down at M=32",
             **per_layer(stacked["W4A8KV4"]["shapes"], 32), shapes=stacked["W4A8KV4"]["shapes"],
             launches_from="kernel phase (on no serving path)"),
        dict(name="decode_attention_stacked", source="llm_qat_torch/csrc/decode_attn.cuh",
             replaces="llm_qat_tpu/ops/pallas/decode_attention.py:403",
             shape="layer 2 of a 3-layer stacked int8 cache, b=8 S=2048",
             **{k: k7[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                   "max_abs_err")},
             shapes=[k7] + shp["decode_attention_stacked"],
             launches_from="kernel phase (on no serving path)"),
        dict(name="flash_bwd_dq", source="llm_qat_torch/csrc/flash_attention_bwd.cu",
             replaces="llm_qat_tpu/ops/pallas/flash_attention.py:236",
             shape=train_shape, **{k: ftr["full"]["dq"][k] for k in keys},
             shapes=[ftr["full"]["dq"], ftr["ragged"]["dq"], ftr7["full"]["dq"],
                     ftr7["ragged"]["dq"], ftro["full"]["dq"], ftro["ragged"]["dq"],
                     md["ring_shape"]["dq"], tpp["shard_shape"]["dq"]] + shp["flash"]["dq"]),
        dict(name="flash_bwd_dkv", source="llm_qat_torch/csrc/flash_attention_bwd.cu",
             replaces="llm_qat_tpu/ops/pallas/flash_attention.py:297",
             shape=train_shape, **{k: ftr["full"]["dkv"][k] for k in keys},
             shapes=[ftr["full"]["dkv"], ftr["ragged"]["dkv"], ftr7["full"]["dkv"],
                     ftr7["ragged"]["dkv"], ftro["full"]["dkv"], ftro["ragged"]["dkv"],
                     md["ring_shape"]["dkv"], tpp["shard_shape"]["dkv"]] + shp["flash"]["dkv"]),
        dict(name="rmsnorm_quant", source="llm_qat_torch/csrc/fused_quant.cu",
             replaces="llm_qat_tpu/ops/pallas/fused_quant.py:77",
             shape="[8192, 2048] bf16 with an f32 gain (bf16 gain, and [4096, 4096] and "
                   "[4096, 5120] with a bf16 gain, and [4096, 5120] on the seeded search's "
                   "rows, in shapes); max_abs_err in integer steps",
             **{k: fq["rmsnorm_quant"][0][k] for k in keys}, shapes=fq["rmsnorm_quant"]),
        dict(name="silu_mul_quant", source="llm_qat_torch/csrc/fused_quant.cu",
             replaces="llm_qat_tpu/ops/pallas/fused_quant.py:129",
             shape="[8192, 5632] bf16 ([4096, 11008] in shapes); max_abs_err in integer steps",
             **{k: fq["silu_mul_quant"][0][k] for k in keys}, shapes=fq["silu_mul_quant"],
             launches_from="the fused_silu_quant train run (off by default)",
             entries={name: dict(tpp["k13"][name], launches=launches[name],
                                 launches_tp_train=tpp["launches_tp"][name])
                      for name in ("silu_mul_amax", "silu_mul_quant_amax")}),
    ]
    for r in rows:
        r.update(route="cuda", launches=launches[r["name"]],
                 launches_pipeline=pipe["launches"][r["name"]],
                 launches_eval=ev["launches"][r["name"]],
                 launches_multi_device=md["launches"][r["name"]],
                 launches_tp=tp["launches"][r["name"]],
                 launches_tp_train=tpp["launches_tp"][r["name"]],
                 launches_pp=tpp["launches_pp"][r["name"]],
                 launches_tiny_pipeline=tinyp["launches"][r["name"]],
                 launches_accuracy=accp["launches"][r["name"]],
                 tpu_kernel=r["replaces"], max_err=r["max_abs_err"])
    log("[5] results")
    log(f"    chip_smoke.py ran {time.perf_counter() - T_START:.1f} s (kernel builds included); "
        "phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in PHASE_S.items()))
    log(json.dumps({"serving": runs, "paged_serving": paged_runs, "token_flips": flips,
                    "timer_floor_ms": gemm["timer_floor_ms"],
                    "llama7b_teacher_forced": l7["teacher_forced"],
                    "cpu_checks": checks, "training": trains, "train_check": tcheck,
                    "pipeline": pipe, "eval": ev, "multi_device": md, "tp_serving": tp,
                    "tp_pp_training": tpp, "shapes": shp, "tiny_pipeline": tinyp,
                    "llama3_8b": {k: l3[k] for k in ("runs", "teacher_forced", "peak_gib",
                                                     "launches")},
                    "openllama_3b": {k: o3[k] for k in ("runs", "teacher_forced", "peak_gib",
                                                        "launches", "cut_vs_cpu")},
                    "wide_groups": {k: wg[k] for k in ("runs", "teacher_forced", "peak_gib",
                                                       "launches", "reduced")},
                    "falcon3_7b": {k: fc[k] for k in ("runs", "teacher_forced", "peak_gib",
                                                      "launches", "cut_vs_cpu")},
                    "openllama_3b_training_flash": o3t["flash"],
                    "accuracy_experiment": accp,
                    "phase_s": PHASE_S, "build_seconds": _build.build_seconds, "card": smi}))
    log(json.dumps({"kernel_attributes": attrs}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
