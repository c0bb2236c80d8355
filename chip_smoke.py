"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``llm_qat_torch/csrc`` (into
``build/llm_qat_torch/``), then:

1. prints the card's name and power limit and the build time;
2. runs each kernel's wrapper at the TinyLlama-1.1B shapes of the serving
   path, holds it against its plain PyTorch version on the same inputs and
   times kernel, plain version and, where one exists, the single PyTorch
   call that computes the same function (``library_ms``; the port never
   calls it). The paged decode attention is also held against the contiguous
   decode attention on the same K/V gathered into a contiguous cache, and
   runs at the LLaMA-7B attention shape too; the stacked kernels are held
   against their plain versions and against the unstacked kernels on the
   layer's slice;
3. for TinyLlama-1.1B at full width and depth with random weights, at
   W8A8KV8 and at W4A8KV4 (nibble-packed KV cache): one decode step of the
   whole-model decode kernel against its plain version (22 layers and a
   2-layer cut; see ``megakernel_phase``); then ``InferenceEngine`` serves
   8 requests, prompts of 16..1000 tokens, 64 greedy new tokens each,
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
   ``cpu_check`` for the limits);
4. holds the four training kernels against their plain versions at the train
   step's shapes (flash backward dQ and dK/dV and the flash forward at
   B = 16, G = 8, S = 2048; RMSNorm+quant at [8192, 2048]; SiLU*up+quant at
   [8192, 5632]), then takes KD-QAT train steps of TinyLlama-1.1B W4A8KV4 at
   full width and depth through ``training.trainer.Trainer`` (bf16 params,
   4 x 2048 tokens, ``kl_chunk=256``, remat on; see ``train_run``), steps on a
   4-layer cut with and without ``fused_silu_quant``, and one step on a
   2-layer cut three ways: the card path with its kernels, with the plain
   versions swapped in, and the port's CPU path (``train_check``);
5. prints a ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, "device": ...}`` line.

Exits non-zero, and prints no result, when there is no GPU or any phase
fails. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
INT8_OPS = 1979e12              # dense int8 tensor-core peak
PROMPT_LENS = (16, 120, 250, 400, 550, 700, 850, 1000)
NEW_TOKENS = 64
ATTN_ULPS, ATTN_FLOOR = 2.0, 1e-2   # K3/K4 against their plain versions
CUT_LAYERS, CUT_DRIFT = 2, 1e-3     # GPU vs CPU at the first layers
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
STACK_LAYER = 3                     # the layer K5-K7 read in place
F32_FLOPS = 67e12               # fp32 peak outside the tensor cores
TRAIN_BATCH, TRAIN_SEQ, KL_CHUNK = 4, 2048, 256     # the train step's batch
TRAIN_WARM, TRAIN_STEPS = 2, 3                       # warm-up and timed steps
TRAIN_LENS = (2048,) * 10 + (1234, 777, 1, 0, 2048, 1500)   # flash backward phase, B = 16
SILU_LAYERS, SILU_STEPS, SILU_LOSS_REL = 4, 2, 0.05  # the fused_silu_quant run (see train_phases)
QUANT_FLIP_SHARE = 0.01     # K12/K13: integers one off where x*s is on a rounding boundary
QUANT_ROW_SHARE = 1e-3      # K12: rows whose absmax moved one bf16 step (see fused_quant_phase)
TRAIN_CUT_LOSS_REL, TRAIN_CUT_GRAD_REL = 2e-2, 0.25   # train_check: kernels against plain versions
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
    cold)."""

    def __init__(self, reps: int = 25, warmup: int = 3):
        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 0) -> float:
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(reps or self.reps):
            self.flush.zero_()
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


def gemm_phase(timer, gen, QM, c):
    """K1 (W8) and K2 (W4) at the four projections of one TinyLlama layer:
    decode (8 slots, padded to 32 rows) for both, and prefill rows (one
    1000-token prompt's bucket, 1024 rows) for W4, which takes K2 at every
    row count. Kernel and plain version are the exact int32 sum through the
    same f32 epilogue: held to 1 bf16 ulp."""
    H, I, hd = c.hidden_size, c.intermediate_size, c.head_dim
    qkv_n = (c.num_attention_heads + 2 * c.kv_heads) * hd
    projs = {"qkv": (H, qkv_n), "o": (H, H), "gateup": (H, 2 * I), "down": (I, H)}
    rows = {"int8_matmul": [32], "int4_matmul": [32, 1024]}
    out = {}
    for name, fn, plain in (("int8_matmul", QM.int8_matmul, QM._int8_matmul_plain),
                            ("int4_matmul", QM.int4_matmul, QM._int4_matmul_plain)):
        shapes = []
        for M in rows[name]:
            for proj, (K, N) in projs.items():
                x = torch.randn(M, K, device="cuda", generator=gen)
                w = torch.randn(K, N, device="cuda", generator=gen) * 0.02
                xq, sx = QM.quantize_per_token(x)
                if name == "int8_matmul":
                    wq, sw = QM.quantize_per_channel(w)
                    wbytes = K * N
                else:
                    wq, sw = QM.quantize_weights_w4(w)
                    wbytes = K * N // 2
                got = fn(xq, wq, sx, sw)
                want = plain(xq, wq, sx, sw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                ulp = want.float().abs() * 2.0 ** -7 + 1e-30
                if not bool((err <= ulp).all()):
                    raise AssertionError(f"{name} {proj} M={M}: beyond 1 bf16 ulp")
                ms = timer(lambda: fn(xq, wq, sx, sw))
                plain_ms = timer(lambda: plain(xq, wq, sx, sw))
                lib_ms = None
                if name == "int8_matmul":
                    # one library call of the same function: cuBLASLt int8 GEMM
                    # plus the epilogue as one expression
                    lib_ms = timer(lambda: (torch._int_mm(xq, wq).float()
                                            * (1.0 / ((sx + 1e-6) * (sw + 1e-6))))
                                   .to(torch.bfloat16))
                b_ms, b_by = bound(M * K + wbytes + 4 * (M + N) + 2 * M * N,
                                   2.0 * M * K * N, INT8_OPS)
                shapes.append(dict(proj=proj, M=M, K=K, N=N, ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                                   max_abs_err=float(err.max())))
                log(f"  {name} {proj:6s} M={M:4d} K={K} N={N}: {ms:.4f} ms "
                    f"(plain {plain_ms:.4f}, library {lib_ms}, bound {b_ms:.4f} {b_by}) "
                    f"max_abs_err {float(err.max()):.3g}")
        out[name] = shapes
    return out


def decode_attention_phase(timer, gen, DA, c, packed):
    """K3 at the decode shape: b=8 slots, kvh=4, G=8, hd=64, S=2048, slot
    lengths those of the served prompts after half the new tokens; the
    folded pair in the cache's range (-8..7 at KV4), as the main path
    quantizes it. Kernel and plain version round to bf16 at the same points
    against the same softmax maximum and differ only in their fp32
    summation orders: held element-wise to ATTN_ULPS bf16 steps plus
    ATTN_FLOOR of the median output (``agreement``)."""
    b, kvh, G, hd, S = 8, c.kv_heads, c.num_attention_heads // c.kv_heads, c.head_dim, 2048
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
    lens_l = [n + NEW_TOKENS // 2 for n in PROMPT_LENS]
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    kc, ksn = DA._rope_tables(S, hd, c.rope_theta, "cuda")
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
    want = DA._decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    agr = agreement(got, want, ATTN_ULPS, ATTN_FLOOR)
    if not agr["ok"]:
        raise AssertionError(f"decode attention packed={packed}: {agr}")
    ms = timer(lambda: DA.quantized_decode_attention(*args, **kw))
    plain_ms = timer(lambda: DA._decode_attention_plain(*args, **kw))
    tot = sum(lens_l)
    nbytes = (2 * kvh * hdc * tot + 2 * 4 * tot          # K/V ints, scales
              + 2 * 4 * (hd // 2) * max(lens_l)          # RoPE tables
              + 2 * 2 * b * kvh * G * hd                 # q, out (bf16)
              + 2 * b * kvh * hd + 8 * b)                # folded pair
    ops = 2 * 2 * kvh * G * hd * (tot + b)               # q.k and p.v
    b_ms, b_by = bound(nbytes, ops, BF16_FLOPS)
    log(f"  decode_attention packed={packed} b={b} S={S} lens={lens_l}: {ms:.4f} ms "
        f"(plain {plain_ms:.4f}, bound {b_ms:.5f} {b_by}) max_abs_err "
        f"{agr['max_abs_err']:.3g}, worst {agr['worst']:.3g} of its limit, "
        f"rel L2 {agr['rel_l2']:.3g}")
    return dict(packed=packed, b=b, S=S, lengths=lens_l, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by, **agr)


def flash_phase(timer, gen, FA, c, S):
    """K4 at a prefill shape: one prompt bucketed to S rows, B = kvh, G = 8,
    D = 64, causal, bf16. Kernel and plain version take p against the same
    row maximum and round it to bf16 alike; they differ in their fp32
    summation orders: held element-wise as K3 is, and the LSE to 1e-3."""
    B, G, D = c.kv_heads, c.num_attention_heads // c.kv_heads, c.head_dim
    q = torch.randn(B, G, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
    o, lse = FA._flash_fwd(q, k, v, lens)
    o2, lse2 = FA._flash_fwd_plain(q, k, v, lens)
    torch.cuda.synchronize()
    agr = agreement(o, o2, ATTN_ULPS, ATTN_FLOOR)
    lse_err = float((lse - lse2).abs().max())
    if not (agr["ok"] and lse_err <= 1e-3):
        raise AssertionError(f"flash S={S}: {agr}, lse {lse_err}")
    ms = timer(lambda: FA._flash_fwd(q, k, v, lens))
    plain_ms = timer(lambda: FA._flash_fwd_plain(q, k, v, lens))
    qh, kh, vh = q.reshape(1, B * G, S, D), k[None], v[None]
    lib_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True))
    nbytes = 2 * (2 * B * G * S * D + 2 * B * S * D) + 4 * B * G * S
    ops = 2 * 2 * B * G * D * (S * (S + 1) // 2)
    b_ms, b_by = bound(nbytes, ops, BF16_FLOPS)
    log(f"  flash_fwd B={B} G={G} S={S} D={D}: {ms:.4f} ms (plain {plain_ms:.4f}, "
        f"sdpa {lib_ms:.4f}, bound {b_ms:.5f} {b_by}) max_abs_err {agr['max_abs_err']:.3g}, "
        f"worst {agr['worst']:.3g} of its limit, rel L2 {agr['rel_l2']:.3g}, lse {lse_err:.3g}")
    return dict(B=B, G=G, S=S, D=D, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, lse_err=lse_err, **agr)


def paged_attention_phase(timer, gen, DA, kvh, G, hd, packed):
    """K8 at the paged decode shape: b = 8 slots, a pool of 256 pages of 128,
    16 pages a sequence, lengths K9_LENS (an empty slot, one on a page edge),
    slot K9_INACTIVE inactive, fold on, bf16; block tables shuffled and
    non-contiguous, their unused entries pointing outside the pool. Held
    element-wise against the plain version under the K3/K4 limit (both walk
    the pages in order and round p*vs against the running maximum), and, as
    a second witness that shares no indirection with it, against the
    contiguous decode attention on the same K/V gathered into a contiguous
    cache (the CUDA kernel K3 at the shape it is built for, its plain
    version otherwise): that one takes p against the final maximum, so the
    two differ by the rounding of p*vs, held to PAGED_VS_K3_ULPS bf16 steps
    + PAGED_VS_K3_FLOOR of the median."""
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
    want = DA._paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    agr = agreement(got, want, ATTN_ULPS, ATTN_FLOOR)
    if not agr["ok"]:
        raise AssertionError(f"paged attention G={G} hd={hd} packed={packed}: {agr}")
    # the same K/V as a contiguous cache [b, kvh, hd(/2), max_pages * P]
    ck = kq[safe].permute(0, 2, 3, 1, 4).reshape(b, kvh, hdc, -1).contiguous()
    cv = vq[safe].permute(0, 2, 3, 1, 4).reshape(b, kvh, hdc, -1).contiguous()
    cks, cvs = ks[safe].reshape(b, -1).contiguous(), vs[safe].reshape(b, -1).contiguous()
    contiguous = (DA.quantized_decode_attention if (G, hd) == (8, 64)
                  else DA._decode_attention_plain)
    flat = contiguous(q, ck, cks, cv, cvs, lens, kc, ksn, fold, **kw)
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
        f"{b_by}) max_abs_err {agr['max_abs_err']:.3g}, worst {agr['worst']:.3g} of its "
        f"limit; against {'K3' if (G, hd) == (8, 64) else 'the plain contiguous version'} on "
        f"the gathered cache: max_abs_err {k3['max_abs_err']:.3g}, worst {k3['worst']:.3g} of "
        f"its limit ({PAGED_VS_K3_ULPS} bf16 steps + {PAGED_VS_K3_FLOOR} x median)")
    return dict(kvh=kvh, G=G, hd=hd, packed=packed, b=b, n_pages=n_pages, page=PAGE,
                max_pages=max_pages, lengths=list(K9_LENS), live_columns=live_cols, ms=ms,
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
        lib_ms = None
        if not w4:
            lib_ms = timer(lambda: (torch._int_mm(xq, w_all[l]).float()
                                    * (1.0 / ((sx + 1e-6) * (sw_all[l] + 1e-6))))
                           .to(torch.bfloat16))
        b_ms, b_by = bound(M * K + w_all[l].numel() + 4 * (M + N) + 2 * M * N,
                           2.0 * M * K * N, INT8_OPS)
        shapes.append(dict(proj=proj, M=M, K=K, N=N, layer=l, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0))
        log(f"  {name} {proj:6s} layer {l} of {w_all.shape[0]} M={M} K={K} N={N}: {ms:.4f} ms "
            f"(plain {plain_ms:.4f}, library {lib_ms}, bound {b_ms:.4f} {b_by}) bit-equal to "
            "plain and unstacked")
    return dict(shapes=shapes, launches=fn.launches - before)


def stacked_attention_phase(timer, gen, DA, c):
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
    plain_ms = timer(lambda: DA._decode_attention_stacked_plain(*args, layer=l))
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


def megakernel_phase(timer, label, cfg, qparams, gen):
    """K9 at TinyLlama-1.1B full width: b = 8, max_len 2048, lengths
    K9_LENS (an empty active slot, one on a block edge, one inactive), at 22
    layers and at a CUT_LAYERS cut, kernel against plain version; then the
    kernel's and the plain version's time for the 22 layers, the time
    between the kernel's grid barriers by stage, and the cost of its
    barriers alone."""
    from llm_qat_torch.inference import megakernel as MK
    from llm_qat_torch.models import llama

    b, S, L = len(K9_LENS), 2048, cfg.num_hidden_layers
    if not MK.supported(cfg, b, S):
        raise AssertionError(f"{label}: megakernel.supported() is false for b={b}, S={S}")
    active = [i != K9_INACTIVE for i in range(b)]
    cut_cfg = cfg.replace(num_hidden_layers=CUT_LAYERS)
    cut, _ = megakernel_step_check(cut_cfg, cut_layers(qparams, CUT_LAYERS), K9_LENS,
                                   active, gen)
    full, (cache, lens_t, act, ids) = megakernel_step_check(cfg, qparams, K9_LENS, active, gen)
    for r in (cut, full):
        log(f"  decode_megakernel {label} {r['layers']} layers: K/V integers equal "
            f"{r['ints_equal']}, scales within 1e-6 {r['scales_close']}, hidden max_abs_err "
            f"{r['hidden']['max_abs_err']:.3g}, logits max_abs_err {r['logits']['max_abs_err']:.3g} "
            f"(worst {r['logits']['worst']:.3g} of its limit), bit-equal {r['bit_equal']}")
        if not r["ok"]:
            raise AssertionError(f"decode_megakernel {label}: {r}")

    hd = cfg.head_dim
    x = qparams["embed"][ids[:, 0]].to(torch.bfloat16)
    qcos, qsin = llama.rope_cos_sin(lens_t[:, None], hd, cfg.rope_theta)
    qcos, qsin = qcos[:, 0, :hd // 2].contiguous(), qsin[:, 0, :hd // 2].contiguous()
    kcos, ksin = MK._cache_rope_tables(S, hd, cfg.rope_theta, ids.device)
    bk = MK.pick_bk(cfg, b, S)
    args = (x, qcos, qsin, kcos, ksin, qparams["layers"], cache, lens_t, act, cfg, bk,
            torch.bfloat16)
    ms = timer(lambda: MK.decode_layers(*args))
    plain_ms = timer(lambda: MK.decode_layers_plain(*args), reps=5)
    ns = len(MK.STAGES)                # barriers a layer
    stamps = torch.zeros(1 + ns * L, dtype=torch.int64, device="cuda")
    MK.decode_layers(*args, stamps=stamps)
    torch.cuda.synchronize()
    gaps = (stamps[1:] - stamps[:-1]).reshape(L, ns).double().sum(0) / 1e6     # ms by stage
    stages = {f"{i}:{n}": float(g) for i, (n, g) in enumerate(zip(MK.STAGES, gaps))}

    def barriers(n):
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        MK.grid_barriers(n)
        e.record()
        torch.cuda.synchronize()
        return a.elapsed_time(e)

    barriers(10)
    barrier_us = (barriers(2000) - barriers(0)) / 2000 * 1e3

    # bound: every stacked weight, scale and gain, the live cache columns
    # with their scales, the RoPE tables up to the longest slot, x, y and
    # the new columns, each moved once; operations: the int8 products and
    # the attention's q.k and p.V
    lay = qparams["layers"]
    wbytes = sum(lay[k]["q"].numel() * lay[k]["q"].element_size() + 4 * lay[k]["s"].numel()
                 for k in ("qkv", "o", "gateup", "down"))
    kv_dim, tot = cfg.kv_heads * hd, sum(K9_LENS)
    hdc = cache["k_q"].shape[3]
    nbytes = (wbytes + 2 * 2 * L * cfg.hidden_size
              + L * (2 * cfg.kv_heads * hdc * tot + 2 * 4 * tot)
              + 2 * 4 * (hd // 2) * max(K9_LENS) + 2 * 2 * b * cfg.hidden_size
              + L * b * (2 * kv_dim + 8))
    mac = cfg.hidden_size * (cfg.hidden_size + 2 * kv_dim + cfg.hidden_size
                             + 2 * cfg.intermediate_size) + cfg.intermediate_size * cfg.hidden_size
    int_ops = 2.0 * b * mac * L
    attn_ops = 2.0 * 2 * cfg.num_attention_heads * hd * (tot + b) * L
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int_ops / INT8_OPS + attn_ops / BF16_FLOPS
    b_ms, b_by = 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    grid = torch.cuda.get_device_properties(0).multi_processor_count   # a block per SM
    log(f"  decode_megakernel {label} b={b} S={S} BK={bk} lens={list(K9_LENS)} grid "
        f"{grid} blocks: {ms:.4f} ms (plain {plain_ms:.3f}, bound {b_ms:.4f} {b_by}, "
        f"{nbytes / 1e9:.4f} GB); {ns * L} barriers x {barrier_us:.3f} us = "
        f"{ns * L * barrier_us / 1e3:.4f} ms; ms between barriers by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return dict(mode=label, b=b, S=S, BK=bk, lengths=list(K9_LENS), grid=grid, ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, barrier_us=barrier_us, barriers=ns * L, stage_ms=stages,
                max_abs_err=max(cut["max_abs_err"], full["max_abs_err"]),
                bit_equal=cut["bit_equal"] and full["bit_equal"], cut=cut, full=full)


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
            "rmsnorm_quant": FQ.rmsnorm_quant, "silu_mul_quant": FQ.silu_mul_quant}


def read_counters():
    return {k: fn.launches for k, fn in counters().items()}


def serve(label, cfg, qparams, prompts):
    """Serve 8 requests through the engine at full TinyLlama width and
    depth on ``cfg``'s decode path; returns the run's metrics, with the
    launches of prefill and of decode apart, each request's tokens and
    every decode step's logits."""
    from llm_qat_torch.inference import engine as E

    # warm-up: one short request (cuBLAS handles, first launches)
    warm = E.InferenceEngine(qparams, cfg, max_batch=8, max_len=2048)
    warm.submit(prompts[0], max_new_tokens=8)
    warm.run()
    del warm

    eng = E.InferenceEngine(qparams, cfg, max_batch=8, max_len=2048)
    pre = {"s": 0.0, "tokens": sum(PROMPT_LENS), "rows": 0,
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
    uids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()

    if len(done) != len(prompts) or any(len(r.output) != NEW_TOKENS for r in done):
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
        generated_tok_per_s=len(done) * NEW_TOKENS / wall, wall_s=wall,
        launches=launches, prefill_launches=pre["launches"],
        decode_launches={k: launches[k] - pre["launches"][k] for k in launches},
    )
    m["profile"] = profile_decode_chunk(eng, prompts)
    log(f"  {label}: prefill {m['prefill_tok_per_s']:.0f} tok/s "
        f"({pre['tokens']} prompt tokens in {pre['s']:.3f} s), decode "
        f"{m['decode_ms_per_step']:.3f} ms/step over {steps} steps of 8 slots, "
        f"{m['generated_tok_per_s']:.1f} generated tok/s; launches in prefill "
        f"{m['prefill_launches']}, in decode {m['decode_launches']}")
    return m, [by_uid[u] for u in uids], tops


def serve_paged(label, cfg, qparams, prompts, n_pages, profile):
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
    uids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
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
    if len(done) != len(prompts) or any(t is None or len(t) != NEW_TOKENS for t in toks):
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
    prompt_tokens = sum(PROMPT_LENS) + preempted["tokens"]
    m = dict(
        mode=label, requests=len(done), n_pages=n_pages, page_size=PAGE,
        prompt_tokens=sum(PROMPT_LENS), prefilled_tokens=prompt_tokens,
        prefill_calls=pre["calls"], prefill_rows=pre["rows"], prefill_s=pre["s"],
        prefill_tok_per_s=prompt_tokens / pre["s"],
        decode_steps=steps[0], decode_s=decode_s,
        decode_ms_per_step=1e3 * decode_s / steps[0],
        generated_tok_per_s=len(done) * NEW_TOKENS / wall, wall_s=wall,
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
        f"{m['prefill_launches']}, in decode {m['decode_launches']}")
    return m, toks


def compare_tokens(label, scan, mega, path_diff, other="megakernel"):
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
    another prompt and a longer context than e was measured on)."""
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
    limit = NEAR_TIE_OVER * path_diff
    log(f"  {label}: {other} run against scan run, {len(s_tok) - len(flips)} of "
        f"{len(s_tok)} requests equal over {NEW_TOKENS} tokens; first differences "
        f"(scan path's lead there, limit {limit:.4g}): "
        + ("; ".join(f"request {f['request']} step {f['step']} lead {f['scan_lead']:.4g} "
                     f"({f['scan_lead'] / f['row_std']:.3g} std)" for f in flips) or "none"))
    bad = [f for f in flips if f["scan_lead"] > limit]
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


def _greedy_logits(cfg, qp, prompt, dev, toks, max_len=64, dtype=torch.bfloat16):
    """Prefill + 4 decode steps; the first run (``toks`` empty) picks the
    greedy tokens and later runs are teacher-forced with them. Returns the
    5 last-position logit vectors on the host."""
    from llm_qat_torch.inference import model as M

    n = len(prompt)
    bucket = 16
    while bucket < n:
        bucket *= 2
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :n] = prompt
    lg, rows = M.prefill_slot(qp, cfg, ids, dtype=dtype, device=dev)
    cache = M.init_serving_cache(cfg, 1, max_len, device=dev)
    M.insert_slot(cache, rows, 0)
    cache["lengths"] = torch.full((1,), len(prompt), dtype=torch.int32, device=dev)
    seq = [lg[0, n - 1].float().cpu()]
    for i in range(4):
        if len(toks) == i:
            toks.append(int(seq[-1].argmax()))
        lg, cache = M.serving_forward(qp, cfg, [[toks[i]]], cache["lengths"], [True],
                                      cache, dtype=dtype, device=dev)
        seq.append(lg[0, -1].float().cpu())
    return seq


def _greedy_logits_paged(cfg, qp, prompt, dev, toks, dtype=torch.bfloat16):
    """``_greedy_logits`` through the paged forward: the prompt's bucket
    prefilled from empty into shuffled pages of a small pool, then 4 decode
    steps."""
    from llm_qat_torch.inference import paged as PG

    n = len(prompt)
    bucket = 16
    while bucket < n:
        bucket *= 2
    pages = -(-(n + 4) // PAGE)
    pcfg = PG.PagedConfig(page_size=PAGE, n_pages=pages + 3, max_pages_per_seq=pages + 1)
    cache = PG.init_paged_cache(cfg, pcfg, device=dev)
    tables = [list(range(pages, 0, -1)) + [0]]          # pages + 1 entries, reversed ids
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :n] = prompt
    lg, cache = PG.paged_forward(qp, cfg, pcfg, ids, [0], [True], tables, cache,
                                 dtype=dtype, from_empty=True, device=dev)
    seq = [lg[0, n - 1].float().cpu()]
    for i in range(4):
        if len(toks) == i:
            toks.append(int(seq[-1].argmax()))
        lg, cache = PG.paged_forward(qp, cfg, pcfg, [[toks[i]]], [n + i], [True], tables,
                                     cache, dtype=dtype, device=dev)
        seq.append(lg[0, -1].float().cpu())
    return seq


def _compare(a_seq, b_seq):
    """(greedy tokens equal per step, largest relative L2 logit drift,
    largest absolute logit difference)."""
    same = [int(a.argmax()) == int(b.argmax()) for a, b in zip(a_seq, b_seq)]
    drift = max(float((a - b).norm() / b.norm()) for a, b in zip(a_seq, b_seq))
    return same, drift, max(float((a - b).abs().max()) for a, b in zip(a_seq, b_seq))


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
    running maximum where K3 takes the final one, a bf16 step in some
    attention outputs, and the int8 quant after it amplifies that as it does
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


def flash_train_phase(timer, gen, FA):
    """K4, K10 and K11 at the train step's attention shape: batch 4 x 4 kv
    heads = 16, G = 8, S = 2048, D = 64, causal, bf16, lengths TRAIN_LENS
    (full, ragged, 1 and 0). Each against its plain version under the K3/K4
    limit (``agreement``): kernel and plain version compute p from the same
    log-sum-exp and round ds and p to bf16 alike; they differ in their fp32
    summation orders. The backward pair takes the forward KERNEL's O and
    log-sum-exp. ``library_ms`` of the backward pair is the backward of one
    ``scaled_dot_product_attention`` call (dQ, dK and dV together, full
    lengths; the port never calls it)."""
    B, G, S, D = len(TRAIN_LENS), 8, TRAIN_SEQ, 64
    q, do = (torch.randn(B, G, S, D, device="cuda", generator=gen).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    lens = torch.tensor(TRAIN_LENS, dtype=torch.int32, device="cuda")
    o, lse = FA._flash_fwd(q, k, v, lens)
    o2, lse2 = FA._flash_fwd_plain(q, k, v, lens)
    torch.cuda.synchronize()
    fwd = agreement(o, o2, ATTN_ULPS, ATTN_FLOOR)
    lse_err = float((lse - lse2).abs().max())
    del o2, lse2
    if not (fwd["ok"] and lse_err <= 1e-3):
        raise AssertionError(f"flash forward S={S}: {fwd}, lse {lse_err}")
    delta = FA._delta(o, do)
    args = (q, k, v, lens, lse, delta, do)
    dq = FA._flash_bwd_dq(*args)
    dk, dv = FA._flash_bwd_dkv(*args)
    dq2 = FA._flash_bwd_dq_plain(*args)
    dk2, dv2 = FA._flash_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    agr = {n: agreement(a, w, ATTN_ULPS, ATTN_FLOOR)
           for n, a, w in (("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2))}
    zeros = all(not t[b, max(n, 1):].any() for t in (dk, dv) for b, n in enumerate(TRAIN_LENS))
    if not (all(a["ok"] for a in agr.values()) and zeros):
        raise AssertionError(f"flash backward: {agr}, zeros past the lengths {zeros}")
    del dq, dk, dv, dq2, dk2, dv2

    ms = {"fwd": timer(lambda: FA._flash_fwd(q, k, v, lens)),
          "dq": timer(lambda: FA._flash_bwd_dq(*args)),
          "dkv": timer(lambda: FA._flash_bwd_dkv(*args))}
    plain = {"fwd": timer(lambda: FA._flash_fwd_plain(q, k, v, lens), reps=3),
             "dq": timer(lambda: FA._flash_bwd_dq_plain(*args), reps=3),
             "dkv": timer(lambda: FA._flash_bwd_dkv_plain(*args), reps=3)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kh, vh = k[:, None], v[:, None]
    lib_fwd = timer(lambda: sdpa(q, kh, vh, is_causal=True, enable_gqa=True))
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, kh, vh))
    out = sdpa(ql, kl, vl, is_causal=True, enable_gqa=True)
    lib_bwd = timer(lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True))
    del out

    pairs = G * live_pairs(TRAIN_LENS, S)
    qb, kvb, rowb = 2 * B * G * S * D, 2 * B * S * D, 4 * B * G * S
    bounds = {"fwd": bound(2 * qb + 2 * kvb + rowb, 2 * 2 * pairs * D, BF16_FLOPS),
              "dq": bound(3 * qb + 2 * kvb + 2 * rowb, 3 * 2 * pairs * D, BF16_FLOPS),
              "dkv": bound(2 * qb + 4 * kvb + 2 * rowb, 4 * 2 * pairs * D, BF16_FLOPS)}
    log(f"  flash at the train shape B={B} G={G} S={S} D={D} lens={list(TRAIN_LENS)}: forward "
        f"{ms['fwd']:.3f} ms (plain {plain['fwd']:.2f}, sdpa {lib_fwd:.4f}, bound "
        f"{bounds['fwd'][0]:.4f} {bounds['fwd'][1]}) max_abs_err {fwd['max_abs_err']:.3g}, worst "
        f"{fwd['worst']:.3g} of its limit, lse {lse_err:.3g}; dQ {ms['dq']:.3f} ms (plain "
        f"{plain['dq']:.2f}, bound {bounds['dq'][0]:.4f} {bounds['dq'][1]}) max_abs_err "
        f"{agr['dq']['max_abs_err']:.3g}, worst {agr['dq']['worst']:.3g}; dK/dV {ms['dkv']:.3f} ms "
        f"(plain {plain['dkv']:.2f}, bound {bounds['dkv'][0]:.4f} {bounds['dkv'][1]}) max_abs_err "
        f"dk {agr['dk']['max_abs_err']:.3g} dv {agr['dv']['max_abs_err']:.3g}, worst "
        f"{max(agr['dk']['worst'], agr['dv']['worst']):.3g}; sdpa backward (dQ, dK, dV together, "
        f"full lengths) {lib_bwd:.4f} ms")
    shape = dict(B=B, G=G, S=S, D=D, lengths=list(TRAIN_LENS), live_pairs=pairs)

    def row(key, lib, **extra):
        return dict(shape, ms=ms[key], plain_ms=plain[key], library_ms=lib,
                    bound_ms=bounds[key][0], bound_by=bounds[key][1], **extra)

    return dict(fwd=row("fwd", lib_fwd, lse_err=lse_err, **fwd),
                dq=row("dq", lib_bwd, library_is="sdpa backward, dQ+dK+dV together", **agr["dq"]),
                dkv=row("dkv", lib_bwd, library_is="sdpa backward, dQ+dK+dV together",
                        max_abs_err=max(agr["dk"]["max_abs_err"], agr["dv"]["max_abs_err"]),
                        dk=agr["dk"], dv=agr["dv"]))


def quant_agreement(q, s, q2, s2):
    """K12/K13 against their plain versions. Scales within rtol 1e-6, except
    in rows whose absmax element moved by one bf16 step (its fp32 value sat on
    a bf16 rounding boundary and the two fp32 sums of squares differ in the
    last bit): at most QUANT_ROW_SHARE of the rows, their scales within 2**-7.
    In all other rows the integers are equal or one apart, and at most
    QUANT_FLIP_SHARE of them differ."""
    rel = ((s - s2).abs() / s2)[:, 0]
    moved = rel > 1e-6
    d = (q.int() - q2.int()).abs()[~moved]
    res = dict(scale_rel_err=float(rel[~moved].max()) if (~moved).any() else 0.0,
               moved_rows=float(moved.float().mean()),
               moved_rows_rel=float(rel.max()),
               int_max_diff=int(d.max()), int_diff_share=float((d != 0).float().mean()))
    res["max_abs_err"] = float(res["int_max_diff"])
    res["ok"] = (res["moved_rows"] <= QUANT_ROW_SHARE and res["moved_rows_rel"] <= 2.0 ** -7
                 and res["int_max_diff"] <= 1 and res["int_diff_share"] <= QUANT_FLIP_SHARE)
    return res


def fused_quant_phase(timer, gen, FQ, c):
    """K12 at the train step's rows [4 * 2048, H] with an f32 and a bf16 gain,
    K13 at [4 * 2048, I], bf16, 8-bit activations. Bound by bytes: input read
    once (2 bytes an element, two inputs for K13), int8 written once, a scale
    a row, the gain."""
    M, H, I = TRAIN_BATCH * TRAIN_SEQ, c.hidden_size, c.intermediate_size
    out = {"rmsnorm_quant": [], "silu_mul_quant": []}
    h = (torch.randn(M, H, device="cuda", generator=gen) * 1.3).to(torch.bfloat16)
    for gdt in (torch.float32, torch.bfloat16):
        g = (1 + 0.1 * torch.randn(H, device="cuda", generator=gen)).to(gdt)
        agr = quant_agreement(*FQ.rmsnorm_quant(h, g, c.rms_norm_eps, 8),
                              *FQ._rmsnorm_quant_plain(h, g, c.rms_norm_eps, 8))
        torch.cuda.synchronize()
        if not agr["ok"]:
            raise AssertionError(f"rmsnorm_quant gain {gdt}: {agr}")
        ms = timer(lambda: FQ.rmsnorm_quant(h, g, c.rms_norm_eps, 8))
        plain_ms = timer(lambda: FQ._rmsnorm_quant_plain(h, g, c.rms_norm_eps, 8))
        b_ms, b_by = bound(3 * M * H + 4 * M + g.element_size() * H, 8.0 * M * H, F32_FLOPS)
        log(f"  rmsnorm_quant [{M}, {H}] bf16, gain {str(gdt)[6:]}: {ms:.4f} ms (plain "
            f"{plain_ms:.4f}, bound {b_ms:.4f} {b_by}) scales rel err {agr['scale_rel_err']:.3g}, "
            f"rows with a moved absmax {agr['moved_rows']:.3g}, integers differ by at most "
            f"{agr['int_max_diff']} in {agr['int_diff_share']:.3g} of the elements")
        out["rmsnorm_quant"].append(dict(M=M, K=H, gain=str(gdt)[6:], ms=ms, plain_ms=plain_ms,
                                         library_ms=None, bound_ms=b_ms, bound_by=b_by, **agr))
    gate = (torch.randn(M, I, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    up = torch.randn(M, I, device="cuda", generator=gen).to(torch.bfloat16)
    agr = quant_agreement(*FQ.silu_mul_quant(gate, up, 8), *FQ._silu_mul_quant_plain(gate, up, 8))
    torch.cuda.synchronize()
    if not agr["ok"]:
        raise AssertionError(f"silu_mul_quant: {agr}")
    ms = timer(lambda: FQ.silu_mul_quant(gate, up, 8))
    plain_ms = timer(lambda: FQ._silu_mul_quant_plain(gate, up, 8))
    b_ms, b_by = bound(5 * M * I + 4 * M, 12.0 * M * I, F32_FLOPS)
    log(f"  silu_mul_quant [{M}, {I}] bf16: {ms:.4f} ms (plain {plain_ms:.4f}, bound {b_ms:.4f} "
        f"{b_by}) scales rel err {agr['scale_rel_err']:.3g}, integers differ by at most "
        f"{agr['int_max_diff']} in {agr['int_diff_share']:.3g} of the elements")
    out["silu_mul_quant"].append(dict(M=M, K=I, ms=ms, plain_ms=plain_ms, library_ms=None,
                                      bound_ms=b_ms, bound_by=b_by, **agr))
    return out


# ---------------------------------------------------------------------------
# training: the train step
# ---------------------------------------------------------------------------


def profile_kernels(fn, label):
    """``fn()`` under torch.profiler: device time by kernel and the device's
    busy share of the wall time (kernel events only, as in
    ``profile_decode_chunk``)."""
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
    out = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3, device_busy_share=busy / wall_us,
               top=[(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top])
    log(f"  profile of {label}: wall {out['wall_ms']:.1f} ms, device busy "
        f"{out['device_busy_ms']:.1f} ms ({100 * out['device_busy_share']:.1f}%)")
    for name, ms, n in out["top"]:
        log(f"    {ms:9.3f} ms  x{n:5d}  {name}")
    return out


def train_cfg_of(cfg, layers=None, **kw):
    """TinyLlama-1.1B W4A8KV4 with the library's default flags, optionally cut
    to its first ``layers`` layers."""
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
    res = dict(mode=label, layers=L, batch=batch, seq=seq, kl_chunk=KL_CHUNK,
               learning_rate=tc.learning_rate, warmup=warm, steps=steps, losses=losses,
               grad_norms=norms, step_ms=step_ms, step_ms_all=[1e3 * t for t in times],
               tokens_per_s=batch * seq / (step_ms / 1e3), peak_memory_bytes=peak,
               launches_per_step=want, launches=launches, teacher_unchanged=True)
    log(f"  {label}: {L} layers, {batch} x {seq} tokens, lr {tc.learning_rate}: losses "
        + " ".join(f"{x:.3f}" for x in losses) + "; grad norms "
        + " ".join(f"{x:.3f}" for x in norms) + f"; step {step_ms:.1f} ms "
        f"({', '.join(f'{1e3 * t:.1f}' for t in times)}), {res['tokens_per_s']:.0f} tokens/s, "
        f"peak memory {peak / 2 ** 30:.2f} GiB; launches a step {want}; teacher unchanged")
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


def train_check(cfg):
    """One KD-QAT step (no update) at full width on a CUT_LAYERS cut, batch 1:
    the card path with its kernels, the card path with the plain versions
    swapped in (``plain_train_on_gpu``: the witness) and the port's CPU path,
    on the same bf16 weights and ids, at 128 tokens; and the first two at
    2048 tokens. Loss, grad_norm and the largest per-leaf relative L2
    difference of the gradients.

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
        if seq == 128:
            to_cpu = lambda t: t.detach().cpu()  # noqa: E731
            cpu = _step_grads(cut, T.tree_map(to_cpu, student), T.tree_map(to_cpu, teacher),
                              ids.cpu(), torch.bfloat16)
            for name, run in (("kernels", kern), ("plain", plain)):
                res[f"{name}_loss_rel_vs_cpu"] = abs(run[0] - cpu[0]) / abs(cpu[0])
                res[f"{name}_grad_vs_cpu"] = _grad_drift(run[2], cpu[2])
            witness_loss, witness_grad = res["plain_loss_rel_vs_cpu"], res["plain_grad_vs_cpu"][0]
        log(f"  train step on a {CUT_LAYERS}-layer cut, 1 x {seq} tokens: loss {kern[0]:.4f}, "
            f"grad_norm {kern[1]:.4f}; kernels against plain versions on the card: loss "
            f"{res['loss_rel_vs_plain']:.3g}, grad_norm {res['norm_rel_vs_plain']:.3g}, gradients "
            f"{res['grad_vs_plain'][0]:.3g} ({res['grad_vs_plain'][1]})"
            + (f"; against the CPU path: kernels loss {res['kernels_loss_rel_vs_cpu']:.3g}, "
               f"gradients {res['kernels_grad_vs_cpu'][0]:.3g} ({res['kernels_grad_vs_cpu'][1]}); "
               f"plain versions on the card (witness) loss {res['plain_loss_rel_vs_cpu']:.3g}, "
               f"gradients {res['plain_grad_vs_cpu'][0]:.3g} ({res['plain_grad_vs_cpu'][1]})"
               if seq == 128 else "")
            + f" (limits: loss and grad_norm {TRAIN_CUT_LOSS_REL}, gradients "
            f"{TRAIN_CUT_GRAD_REL})")
        L = CUT_LAYERS
        ok = (used["flash_fwd"] == 2 * L and used["flash_bwd_dq"] == L == used["flash_bwd_dkv"]
              and used["rmsnorm_quant"] == 4 * L
              and res["loss_rel_vs_plain"] <= TRAIN_CUT_LOSS_REL
              and res["norm_rel_vs_plain"] <= TRAIN_CUT_LOSS_REL
              and res["grad_vs_plain"][0] <= TRAIN_CUT_GRAD_REL)
        if seq == 128:
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


def train_phases(cfg):
    """The train runs: TinyLlama-1.1B at full depth with the default flags
    (the main path of the training slice: K4, K10, K11, K12), then a
    SILU_LAYERS-layer cut with ``fused_silu_quant`` (K13 twice a layer a step:
    the student's forward and its recompute) beside the same cut with the
    default flags. The two cuts start from the same weights and differ in the
    MLP activation alone (sigmoid in fp32 rounded once, against the model
    type's SiLU, and the kernel's quantization against the fused matmul's):
    their first losses are held within SILU_LOSS_REL of each other."""
    full = train_run("W4A8KV4 train", train_cfg_of(cfg), TRAIN_STEPS, TRAIN_WARM, profile=True)
    base = train_run(f"W4A8KV4 train, {SILU_LAYERS}-layer cut", train_cfg_of(cfg, SILU_LAYERS),
                     SILU_STEPS, 0, profile=False)
    silu = train_run(f"W4A8KV4 train, {SILU_LAYERS}-layer cut, fused_silu_quant",
                     train_cfg_of(cfg, SILU_LAYERS, fused_silu_quant=True), SILU_STEPS, 0,
                     profile=False)
    rel = abs(silu["losses"][0] - base["losses"][0]) / abs(base["losses"][0])
    log(f"  fused_silu_quant against the default route on the {SILU_LAYERS}-layer cut: first "
        f"losses {silu['losses'][0]:.4f} and {base['losses'][0]:.4f}, {rel:.3g} apart (limit "
        f"{SILU_LOSS_REL})")
    if rel > SILU_LOSS_REL:
        raise AssertionError(f"fused_silu_quant: first loss {rel} from the default route's")
    silu["first_loss_rel_vs_default"] = rel
    return [full, base, silu]


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from llm_qat_torch.models.config import TINYLLAMA_1B
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
    _build.build_all()
    log(f"    kernels built in {_build.build_seconds:.1f} s into {_build.BUILD_DIR}")

    cfg = TINYLLAMA_1B                 # the default: use_megakernel=True
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = Timer()
    log("[2] kernels against their plain versions (TinyLlama-1.1B shapes, bf16)")
    gemm = gemm_phase(timer, gen, QM, cfg)
    dec = [decode_attention_phase(timer, gen, DA, cfg, packed) for packed in (False, True)]
    fl = [flash_phase(timer, gen, FA, cfg, S) for S in (1024, 128)]
    G = cfg.num_attention_heads // cfg.kv_heads
    # K8 at TinyLlama-1.1B's attention shape and at LLaMA-7B's (32 MHA heads of 128)
    pag = [paged_attention_phase(timer, gen, DA, kvh, g, hd, packed)
           for kvh, g, hd in ((cfg.kv_heads, G, cfg.head_dim), (32, 1, 128))
           for packed in (False, True)]
    k7 = stacked_attention_phase(timer, gen, DA, cfg)
    ftr = flash_train_phase(timer, gen, FA)
    fq = fused_quant_phase(timer, gen, FQ, cfg)

    log("[3] TinyLlama-1.1B, 22 layers: the stacked GEMMs on the served weights, the "
        "decode megakernel against its plain version, then serving 8 requests x 64 new "
        "tokens: max_len 2048 on the scan path (use_megakernel=False) and on the default "
        f"path, then paged (pages of {PAGE}, {SEQ_PAGES} a sequence) from a pool of "
        f"{ROOMY_PAGES} and of {TIGHT_PAGES} pages")
    from llm_qat_torch.inference import quantized as Q
    from llm_qat_torch.models import params as P

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
    del timer
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

    log(f"[4] KD-QAT training, TinyLlama-1.1B W4A8KV4, bf16, {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens, kl_chunk {KL_CHUNK}: {TRAIN_WARM} + {TRAIN_STEPS} steps at full depth, "
        f"{SILU_STEPS} steps on a {SILU_LAYERS}-layer cut with and without fused_silu_quant, "
        f"one step on a {CUT_LAYERS}-layer cut against the plain versions and the CPU path")
    torch.cuda.empty_cache()
    trains = train_phases(cfg)
    tcheck = train_check(cfg)

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

    def per_layer(shapes, M):
        sel = [s for s in shapes if s["M"] == M]
        tot = lambda key: sum(s[key] for s in sel)  # noqa: E731
        lib = [s["library_ms"] for s in sel]
        return dict(ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
                    library_ms=None if None in lib else sum(lib),
                    bound_by=sel[0]["bound_by"],
                    max_abs_err=max(s["max_abs_err"] for s in sel))

    launches = {k: sum(m["launches"][k] for m in runs + paged_runs + trains) for k in counters()}
    # K5-K7 are on no serving path of either package: their counts are those
    # of their kernel phases
    launches["int8_matmul_stacked"] = stacked["W8A8KV8"]["launches"]
    launches["int4_matmul_stacked"] = stacked["W4A8KV4"]["launches"]
    launches["decode_attention_stacked"] = k7["launches"]
    k8 = pag[0]
    k9 = mega[0]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")
    rows = [
        dict(name="int8_matmul", source="llm_qat_torch/csrc/int8_matmul.cu",
             replaces="llm_qat_tpu/ops/pallas/quant_matmul.py:77",
             shape="one decode layer: qkv+o+gateup+down at M=32",
             **per_layer(gemm["int8_matmul"], 32), shapes=gemm["int8_matmul"]),
        dict(name="int4_matmul", source="llm_qat_torch/csrc/w4a8_matmul.cu",
             replaces="llm_qat_tpu/ops/pallas/quant_matmul.py:394",
             shape="one decode layer: qkv+o+gateup+down at M=32",
             **per_layer(gemm["int4_matmul"], 32), shapes=gemm["int4_matmul"]),
        dict(name="decode_attention", source="llm_qat_torch/csrc/decode_attention.cu",
             replaces="llm_qat_tpu/ops/pallas/decode_attention.py:55",
             shape="b=8 S=2048 int8 cache (packed KV4 in shapes)",
             **{k: dec[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                       "bound_by")},
             max_abs_err=max(d["max_abs_err"] for d in dec), shapes=dec),
        dict(name="flash_fwd", source="llm_qat_torch/csrc/flash_attention.cu",
             replaces="llm_qat_tpu/ops/pallas/flash_attention.py:94",
             shape="B=4 G=8 S=1024 D=64 causal (S=128 and the train shape B=16 S=2048 in shapes)",
             **{k: fl[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by")},
             max_abs_err=max(f["max_abs_err"] for f in fl + [ftr["fwd"]]),
             shapes=fl + [ftr["fwd"]]),
        dict(name="decode_megakernel", source="llm_qat_torch/csrc/megakernel.cu",
             replaces="llm_qat_tpu/inference/megakernel.py:259",
             shape="one decode step, 22 layers, b=8 S=2048 W8A8KV8 (W4A8KV4 packed in shapes)",
             **{k: k9[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
             max_abs_err=max(m["max_abs_err"] for m in mega), shapes=mega),
        dict(name="paged_attention", source="llm_qat_torch/csrc/paged_attention.cu",
             replaces="llm_qat_tpu/ops/pallas/decode_attention.py:646",
             shape=f"b=8, pool {ROOMY_PAGES} x {PAGE}, {SEQ_PAGES} pages a sequence, int8 pool, "
                   "TinyLlama-1.1B heads (packed KV4 and LLaMA-7B heads in shapes)",
             **{k: k8[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
             max_abs_err=max(d["max_abs_err"] for d in pag), shapes=pag),
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
        dict(name="decode_attention_stacked", source="llm_qat_torch/csrc/decode_attention.cu",
             replaces="llm_qat_tpu/ops/pallas/decode_attention.py:403",
             shape="layer 2 of a 3-layer stacked int8 cache, b=8 S=2048",
             **{k: k7[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                   "max_abs_err")},
             shapes=[k7], launches_from="kernel phase (on no serving path)"),
        dict(name="flash_bwd_dq", source="llm_qat_torch/csrc/flash_attention_bwd.cu",
             replaces="llm_qat_tpu/ops/pallas/flash_attention.py:236",
             shape="B=16 G=8 S=2048 D=64 causal bf16, lengths full, ragged, 1 and 0",
             **{k: ftr["dq"][k] for k in keys}, shapes=[ftr["dq"]]),
        dict(name="flash_bwd_dkv", source="llm_qat_torch/csrc/flash_attention_bwd.cu",
             replaces="llm_qat_tpu/ops/pallas/flash_attention.py:297",
             shape="B=16 G=8 S=2048 D=64 causal bf16, lengths full, ragged, 1 and 0",
             **{k: ftr["dkv"][k] for k in keys}, shapes=[ftr["dkv"]]),
        dict(name="rmsnorm_quant", source="llm_qat_torch/csrc/fused_quant.cu",
             replaces="llm_qat_tpu/ops/pallas/fused_quant.py:77",
             shape="[8192, 2048] bf16 with an f32 gain (bf16 gain in shapes); max_abs_err in "
                   "integer steps",
             **{k: fq["rmsnorm_quant"][0][k] for k in keys}, shapes=fq["rmsnorm_quant"]),
        dict(name="silu_mul_quant", source="llm_qat_torch/csrc/fused_quant.cu",
             replaces="llm_qat_tpu/ops/pallas/fused_quant.py:129",
             shape="[8192, 5632] bf16; max_abs_err in integer steps",
             **{k: fq["silu_mul_quant"][0][k] for k in keys}, shapes=fq["silu_mul_quant"],
             launches_from="the fused_silu_quant train run (off by default)"),
    ]
    for r in rows:
        r.update(route="cuda", launches=launches[r["name"]],
                 tpu_kernel=r["replaces"], max_err=r["max_abs_err"])
    log("[5] results")
    log(json.dumps({"serving": runs, "paged_serving": paged_runs, "token_flips": flips,
                    "cpu_checks": checks, "training": trains, "train_check": tcheck,
                    "card": smi}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
