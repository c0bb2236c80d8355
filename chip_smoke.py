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
3. serves TinyLlama-1.1B at full width and depth with random weights, at
   W8A8KV8 and at W4A8KV4 (nibble-packed KV cache), through
   ``InferenceEngine``: 8 requests, prompts of 16..1000 tokens, 64 greedy
   new tokens each, with every launch count set to 0 just before each run
   and read just after; then the same weights, for one short prompt,
   through the GPU path with its kernels, the GPU path with the plain
   versions and the port's CPU path (see ``cpu_check`` for the limits);
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

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.reps):
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


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------


def counters():
    from llm_qat_torch.ops import decode_attention as DA
    from llm_qat_torch.ops import flash_attention as FA
    from llm_qat_torch.ops import quant_matmul as QM
    return {"int8_matmul": QM.int8_matmul, "int4_matmul": QM.int4_matmul,
            "decode_attention": DA.quantized_decode_attention,
            "flash_fwd": FA._flash_fwd}


def serve(label, cfg, rng):
    """Serve 8 requests through the engine at full TinyLlama width and
    depth; returns (metrics, qparams)."""
    from llm_qat_torch.inference import engine as E
    from llm_qat_torch.inference import quantized as Q
    from llm_qat_torch.models import params as P

    params = P.init_params(cfg, seed=0, dtype=torch.bfloat16)
    qparams = Q.quantize_params(params, cfg)
    del params
    torch.cuda.empty_cache()
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n))) for n in PROMPT_LENS]

    # warm-up: one short request (cuBLAS handles, first launches)
    warm = E.InferenceEngine(qparams, cfg, max_batch=8, max_len=2048)
    warm.submit(prompts[0], max_new_tokens=8)
    warm.run()
    del warm

    eng = E.InferenceEngine(qparams, cfg, max_batch=8, max_len=2048)
    pre = {"s": 0.0, "tokens": 0, "rows": 0}
    real_prefill = eng._prefill

    def timed_prefill(qp, ids):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_prefill(qp, ids)
        torch.cuda.synchronize()
        pre["s"] += time.perf_counter() - t
        pre["rows"] += ids.shape[0] * ids.shape[1]
        return out

    eng._prefill = timed_prefill
    steps = {"n": 0}
    real_fwd = eng._fwd

    def counted_fwd(*a, **k):
        steps["n"] += 1
        return real_fwd(*a, **k)

    eng._fwd = counted_fwd
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    pre["tokens"] = sum(PROMPT_LENS)
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}

    if len(done) != len(prompts) or any(len(r.output) != NEW_TOKENS for r in done):
        raise AssertionError(f"{label}: {len(done)} finished, outputs "
                             f"{[len(r.output) for r in done]}")
    if not torch.isfinite(eng._logits).all():
        raise AssertionError(f"{label}: non-finite logits")
    if any(not (0 <= t < cfg.vocab_size) for r in done for t in r.output):
        raise AssertionError(f"{label}: token out of range")
    decode_s = wall - pre["s"]
    m = dict(
        mode=label, requests=len(done), prompt_tokens=pre["tokens"],
        prefill_rows=pre["rows"], prefill_s=pre["s"],
        prefill_tok_per_s=pre["tokens"] / pre["s"],
        decode_steps=steps["n"], decode_s=decode_s,
        decode_ms_per_step=1e3 * decode_s / steps["n"],
        generated_tok_per_s=len(done) * NEW_TOKENS / wall, wall_s=wall,
        launches=launches,
    )
    m["profile"] = profile_decode_chunk(eng, prompts)
    log(f"  {label}: prefill {m['prefill_tok_per_s']:.0f} tok/s "
        f"({pre['tokens']} prompt tokens in {pre['s']:.3f} s), decode "
        f"{m['decode_ms_per_step']:.3f} ms/step over {m['decode_steps']} steps of 8 slots, "
        f"{m['generated_tok_per_s']:.1f} generated tok/s; launches {launches}")
    return m, qparams


def profile_decode_chunk(eng, prompts):
    """One chunk of decode steps (8 slots) under torch.profiler, after the
    measured run: device time by kernel and the device's busy share of the
    chunk's wall time."""
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
    ev = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
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
    """Within the block, the four kernel wrappers are their plain versions,
    so the GPU path runs with no hand-written kernel: the witness that
    separates the kernels' share of a GPU/CPU difference from the rest of
    the GPU path's (cuBLAS bf16 products, CUDA reductions)."""
    from llm_qat_torch.ops import decode_attention as DA
    from llm_qat_torch.ops import flash_attention as FA
    from llm_qat_torch.ops import quant_matmul as QM

    swaps = [(QM, "int8_matmul", QM._int8_matmul_plain),
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
    """(greedy tokens equal per step, largest relative L2 logit drift)."""
    same = [int(a.argmax()) == int(b.argmax()) for a, b in zip(a_seq, b_seq)]
    drift = max(float((a - b).norm() / b.norm()) for a, b in zip(a_seq, b_seq))
    return same, drift


def gpu_vs_cpu(cfg, qparams, prompt):
    """The same weights through three paths: the GPU with its kernels, the
    GPU with the plain versions (``plain_on_gpu``) and the CPU (plain
    versions), the last two teacher-forced with the first's greedy tokens."""
    def tree_cpu(t):
        return {k: tree_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()

    toks = []
    kern = _greedy_logits(cfg, qparams, prompt, "cuda", toks)
    with plain_on_gpu():
        plain = _greedy_logits(cfg, qparams, prompt, "cuda", toks)
    cpu = _greedy_logits(cfg, tree_cpu(qparams), prompt, "cpu", toks)
    finite = all(bool(torch.isfinite(x).all()) for x in kern)
    return dict(kernels_vs_cpu=_compare(kern, cpu), plain_vs_cpu=_compare(plain, cpu),
                kernels_vs_plain=_compare(kern, plain), finite=finite)


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
    CUT_DRIFT."""
    prompt = rng.integers(1, cfg.vocab_size, 16)
    full = gpu_vs_cpu(cfg, qparams, prompt)
    cut = cfg.replace(num_hidden_layers=CUT_LAYERS)
    cut_q = dict(qparams, layers={k: ({kk: vv[:CUT_LAYERS] for kk, vv in v.items()}
                                      if isinstance(v, dict) else v[:CUT_LAYERS])
                                  for k, v in qparams["layers"].items()})
    part = gpu_vs_cpu(cut, cut_q, prompt)
    for depth, r in ((cfg.num_hidden_layers, full), (CUT_LAYERS, part)):
        log(f"  {label} {depth} layers, greedy tokens equal per step and largest logit "
            "drift: " + "; ".join(f"{k} {r[k][0]} {r[k][1]:.4g}"
                                  for k in ("kernels_vs_cpu", "plain_vs_cpu",
                                            "kernels_vs_plain")))
    limit_full = FULL_DRIFT_OVER * full["plain_vs_cpu"][1] + CUT_DRIFT
    log(f"  {label} limits: {CUT_LAYERS} layers {CUT_DRIFT}; full depth "
        f"{FULL_DRIFT_OVER} x plain GPU path's + {CUT_DRIFT} = {limit_full:.4g}")
    ok = (full["finite"] and part["finite"]
          and all(part["kernels_vs_cpu"][0]) and part["kernels_vs_cpu"][1] <= CUT_DRIFT
          and all(full["kernels_vs_plain"][0])
          and full["kernels_vs_cpu"][1] <= limit_full)
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

    cfg = TINYLLAMA_1B.replace(use_megakernel=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = Timer()
    log("[2] kernels against their plain versions (TinyLlama-1.1B shapes, bf16)")
    gemm = gemm_phase(timer, gen, QM, cfg)
    dec = [decode_attention_phase(timer, gen, DA, cfg, packed) for packed in (False, True)]
    fl = [flash_phase(timer, gen, FA, cfg, S) for S in (1024, 128)]
    del timer

    log("[3] TinyLlama-1.1B serving, 8 requests x 64 new tokens, max_len 2048")
    rng = np.random.default_rng(0)
    modes = {
        "W8A8KV8": cfg.replace(w_bits=8, a_bits=8, kv_bits=8),
        "W4A8KV4": cfg.replace(w_bits=4, a_bits=8, kv_bits=4, kv_cache_pack=True),
    }
    # both serving runs first, then the CPU checks (the CPU path's thread
    # pool would share the host with the timed engine loop)
    runs, qps, checks = [], {}, []
    for label, mcfg in modes.items():
        m, qps[label] = serve(label, mcfg, rng)
        runs.append(m)
    for label, mcfg in modes.items():
        checks.append(cpu_check(label, mcfg, qps.pop(label), rng))
    need = {"W8A8KV8": ("int8_matmul", "decode_attention", "flash_fwd"),
            "W4A8KV4": ("int4_matmul", "decode_attention", "flash_fwd")}
    for m in runs:
        idle = [k for k in need[m["mode"]] if m["launches"][k] == 0]
        if idle:
            raise AssertionError(f"{m['mode']}: kernels {idle} never launched")

    def per_layer(shapes, M):
        sel = [s for s in shapes if s["M"] == M]
        tot = lambda key: sum(s[key] for s in sel)  # noqa: E731
        lib = [s["library_ms"] for s in sel]
        return dict(ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
                    library_ms=None if None in lib else sum(lib),
                    bound_by=sel[0]["bound_by"],
                    max_abs_err=max(s["max_abs_err"] for s in sel))

    launches = {k: sum(m["launches"][k] for m in runs) for k in counters()}
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
    ]
    for r in rows:
        r.update(route="cuda", launches=launches[r["name"]],
                 tpu_kernel=r["replaces"], max_err=r["max_abs_err"])
    log("[4] results")
    log(json.dumps({"serving": runs, "cpu_checks": checks, "card": smi}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
