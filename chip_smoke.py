"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``llm_qat_torch/csrc`` (into
``build/llm_qat_torch/``), then:

1. prints the card's name and power limit and the build time;
2. runs each kernel's wrapper at the TinyLlama-1.1B shapes of the serving
   path, holds it against its plain PyTorch version on the same inputs and
   times kernel, plain version and, where one exists, the single PyTorch
   call that computes the same function (``library_ms``; the port never
   calls it);
3. for TinyLlama-1.1B at full width and depth with random weights, at
   W8A8KV8 and at W4A8KV4 (nibble-packed KV cache): one decode step of the
   whole-model decode kernel against its plain version (22 layers and a
   2-layer cut; see ``megakernel_phase``); then ``InferenceEngine`` serves
   8 requests, prompts of 16..1000 tokens, 64 greedy new tokens each,
   twice: on the scan path (``use_megakernel=False``) and on the default
   configuration, whose decode steps are one launch of that kernel. Every
   launch count is set to 0 just before each run and read just after, and
   the two runs' greedy tokens are held against each other (see
   ``compare_tokens``). Then the same weights, for one short prompt, through
   the GPU paths with their kernels, the GPU path with the plain versions
   and the port's CPU path (see ``cpu_check`` for the limits);
4. prints a ``{"kernels": [...]}`` line and, last, the
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
            "flash_fwd": FA._flash_fwd, "decode_megakernel": MK.decode_layers}


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


def compare_tokens(label, scan, mega, path_diff):
    """The megakernel run's greedy tokens against the scan run's, request
    by request. The two decode paths differ by design (SiLU in fp32 against
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
    (_, s_tok, s_logits), (_, m_tok, _) = scan, mega
    flips = []
    for r, (a, b) in enumerate(zip(s_tok, m_tok)):
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            continue
        if t == 0:
            raise AssertionError(f"{label}: request {r} differs at the prefill's token")
        row = s_logits[t - 1][r]               # the step that produced token t
        flips.append(dict(request=r, step=t, scan_token=a[t], megakernel_token=b[t],
                          scan_lead=float(row[a[t]] - row[b[t]]), row_std=float(row.std())))
    limit = NEAR_TIE_OVER * path_diff
    log(f"  {label}: megakernel run against scan run, {len(s_tok) - len(flips)} of "
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
    """Within the block, the five kernel wrappers are their plain versions,
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
             (FA, "_flash_fwd", FA._flash_fwd_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def _greedy_logits(cfg, qp, prompt, dev, toks):
    """Prefill + 4 decode steps; the first run (``toks`` empty) picks the
    greedy tokens and later runs are teacher-forced with them. Returns the
    5 last-position logit vectors on the host."""
    from llm_qat_torch.inference import model as M

    lg, rows = M.prefill_slot(qp, cfg, prompt[None], device=dev)
    cache = M.init_serving_cache(cfg, 1, 64, device=dev)
    M.insert_slot(cache, rows, 0)
    cache["lengths"] = torch.full((1,), len(prompt), dtype=torch.int32, device=dev)
    seq = [lg[0, -1].float().cpu()]
    for i in range(4):
        if len(toks) == i:
            toks.append(int(seq[-1].argmax()))
        lg, cache = M.serving_forward(qp, cfg, [[toks[i]]], cache["lengths"], [True],
                                      cache, device=dev)
        seq.append(lg[0, -1].float().cpu())
    return seq


def _compare(a_seq, b_seq):
    """(greedy tokens equal per step, largest relative L2 logit drift,
    largest absolute logit difference)."""
    same = [int(a.argmax()) == int(b.argmax()) for a, b in zip(a_seq, b_seq)]
    drift = max(float((a - b).norm() / b.norm()) for a, b in zip(a_seq, b_seq))
    return same, drift, max(float((a - b).abs().max()) for a, b in zip(a_seq, b_seq))


def gpu_vs_cpu(cfg, qparams, prompt):
    """The same weights through four paths: the GPU scan path with its
    kernels, the default path (decode steps in the whole-model kernel), the
    GPU scan path with the plain versions (``plain_on_gpu``) and the CPU
    scan path (plain versions), the last three teacher-forced with the
    first's greedy tokens."""
    def tree_cpu(t):
        return {k: tree_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()

    scan = cfg.replace(use_megakernel=False)
    toks = []
    kern = _greedy_logits(scan, qparams, prompt, "cuda", toks)
    mega = _greedy_logits(cfg, qparams, prompt, "cuda", toks)
    with plain_on_gpu():
        plain = _greedy_logits(scan, qparams, prompt, "cuda", toks)
    cpu = _greedy_logits(scan, tree_cpu(qparams), prompt, "cpu", toks)
    finite = all(bool(torch.isfinite(x).all()) for x in kern + mega)
    return dict(kernels_vs_cpu=_compare(kern, cpu), plain_vs_cpu=_compare(plain, cpu),
                kernels_vs_plain=_compare(kern, plain), megakernel_vs_scan=_compare(mega, kern),
                finite=finite)


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
    absolute value sets ``compare_tokens``' limit."""
    prompt = rng.integers(1, cfg.vocab_size, 16)
    full = gpu_vs_cpu(cfg, qparams, prompt)
    cut = cfg.replace(num_hidden_layers=CUT_LAYERS)
    part = gpu_vs_cpu(cut, cut_layers(qparams, CUT_LAYERS), prompt)
    for depth, r in ((cfg.num_hidden_layers, full), (CUT_LAYERS, part)):
        log(f"  {label} {depth} layers, greedy tokens equal per step and largest logit "
            "drift (largest absolute difference): "
            + "; ".join(f"{k} {r[k][0]} {r[k][1]:.4g} ({r[k][2]:.3g})"
                                  for k in ("kernels_vs_cpu", "plain_vs_cpu",
                                            "kernels_vs_plain", "megakernel_vs_scan")))
    limit_full = FULL_DRIFT_OVER * full["plain_vs_cpu"][1] + CUT_DRIFT
    log(f"  {label} limits: {CUT_LAYERS} layers {CUT_DRIFT}; full depth "
        f"{FULL_DRIFT_OVER} x plain GPU path's + {CUT_DRIFT} = {limit_full:.4g}")
    ok = (full["finite"] and part["finite"]
          and all(part["kernels_vs_cpu"][0]) and part["kernels_vs_cpu"][1] <= CUT_DRIFT
          and all(full["kernels_vs_plain"][0])
          and full["kernels_vs_cpu"][1] <= limit_full
          and all(part["megakernel_vs_scan"][0])
          and part["megakernel_vs_scan"][1] <= MEGA_CUT_DRIFT
          and full["megakernel_vs_scan"][1] <= MEGA_FULL_DRIFT)
    if not ok:
        raise AssertionError(f"{label}: GPU and CPU paths disagree")
    return dict(mode=label, full_depth=full, cut_layers=CUT_LAYERS, cut=part,
                full_depth_limit=limit_full)


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

    log("[3] TinyLlama-1.1B, 22 layers: the decode megakernel against its plain version, "
        "then serving 8 requests x 64 new tokens, max_len 2048, on the scan path "
        "(use_megakernel=False) and on the default path")
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
    for label, mcfg in modes.items():
        prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n))) for n in PROMPT_LENS]
        params = P.init_params(mcfg, seed=0, dtype=torch.bfloat16)
        qps[label] = Q.quantize_params(params, mcfg)
        del params
        torch.cuda.empty_cache()
        mega.append(megakernel_phase(timer, label, mcfg, qps[label], gen))
        scan = serve(f"{label} scan", mcfg.replace(use_megakernel=False), qps[label], prompts)
        dflt = serve(f"{label} megakernel", mcfg, qps[label], prompts)
        served[label] = (scan, dflt)
        runs += [scan[0], dflt[0]]
    del timer
    for label, mcfg in modes.items():
        checks.append(cpu_check(label, mcfg, qps.pop(label), rng))
        flips[label] = compare_tokens(label, *served.pop(label),
                                      checks[-1]["full_depth"]["megakernel_vs_scan"][2])

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
        if not ok:
            raise AssertionError(f"{m['mode']}: launches off the path: prefill {pl}, decode {dl}")

    def per_layer(shapes, M):
        sel = [s for s in shapes if s["M"] == M]
        tot = lambda key: sum(s[key] for s in sel)  # noqa: E731
        lib = [s["library_ms"] for s in sel]
        return dict(ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
                    library_ms=None if None in lib else sum(lib),
                    bound_by=sel[0]["bound_by"],
                    max_abs_err=max(s["max_abs_err"] for s in sel))

    launches = {k: sum(m["launches"][k] for m in runs) for k in counters()}
    k9 = mega[0]
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
             shape="B=4 G=8 S=1024 D=64 causal (S=128 in shapes)",
             **{k: fl[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by")},
             max_abs_err=max(f["max_abs_err"] for f in fl), shapes=fl),
        dict(name="decode_megakernel", source="llm_qat_torch/csrc/megakernel.cu",
             replaces="llm_qat_tpu/inference/megakernel.py:259",
             shape="one decode step, 22 layers, b=8 S=2048 W8A8KV8 (W4A8KV4 packed in shapes)",
             **{k: k9[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
             max_abs_err=max(m["max_abs_err"] for m in mega), shapes=mega),
    ]
    for r in rows:
        r.update(route="cuda", launches=launches[r["name"]],
                 tpu_kernel=r["replaces"], max_err=r["max_abs_err"])
    log("[4] results")
    log(json.dumps({"serving": runs, "token_flips": flips, "cpu_checks": checks,
                    "card": smi}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
