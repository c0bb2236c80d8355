"""Decode kernel times of checkouts of the port, in turns, on one NVIDIA GPU.

    python3 decode_ab.py [--k3-only] OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Times, with each checkout's own kernels and ``chip_smoke.Timer`` (median of
25 CUDA-event runs, the L2 flushed before each): K3 (int8 and packed cache)
and K8 (int8 pool) through ``chip_smoke.decode_attention_phase`` /
``paged_attention_phase`` at the heads of ``SHAPES`` (kv heads, query heads
a kv head G, head dim): TinyLlama-1.1B's (4, 8, 64), the LLaMA-7B family's
(32, 1, 128), Meta-Llama-3-8B's (8, 4, 128), Llama-2-70B's (8, 8, 128), the
tiny pipeline's (2, 2, 16), the accuracy experiment's (4, 2, 32),
Mistral-Large-2's (8, 12, 128), Llama-3.1-405B's (8, 16, 128) and its tp = 8
shard's (1, 16, 128), Falcon3-7B's (4, 3, 256) and Falcon3-1B's (4, 2, 256)
(a checkout whose kernels refuse a shape prints "refused" for it); and,
without ``--k3-only``, the flash forward K4 (``chip_smoke.flash_phase``,
bf16, causal, full lengths) and the flash backward pair K10 (dQ) and K11
(dK/dV, ``flash_attention._flash_bwd_dq`` / ``_flash_bwd_dkv`` on the
forward kernel's O and log-sum-exp, the same Timer) at the train shapes of
``FLASH`` (B, G, S, D): TinyLlama-1.1B's (16, 8, 2048, 64) and LLaMA-7B's
(32, 1, 2048, 128), K4 alone at ``FLASH_FWD``: Falcon3-7B's prefill (32, 3,
1024, 256), and
the decode megakernel K9 (``megakernel.decode_layers``, one step) at
TinyLlama-1.1B's and LLaMA-7B's full width and depth and Falcon3-7B's width
cut to 4 layers (``FALCON3_7B``), W8A8KV8 and W4A8KV4 (packed cache), b = 8,
max_len 2048, lengths ``chip_smoke.K9_LENS``, random weights and cache from
seed 0.

Before the timed runs every checkout builds its sources into its own
``build/``, every ``nvcc`` of every checkout started together
(``--k3-only``: the decode attention sources alone), and the seconds each
took are printed. Then the checkouts run in turns, this one first, then the
others, then the others in reverse and this one last (A B C C B A), each run
in a process of its own. Prints one line a run and kernel. Imports nothing
of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((4, 8, 64), (32, 1, 128), (8, 4, 128), (8, 8, 128), (2, 2, 16), (4, 2, 32),
          (8, 12, 128), (8, 16, 128), (1, 16, 128), (4, 3, 256), (4, 2, 256))
FLASH = ((16, 8, 2048, 64), (32, 1, 2048, 128))
FLASH_FWD = ((32, 3, 1024, 256),)
# Falcon3-7B-Base's published widths (chip_smoke.FALCON3_7B), cut to 4 layers
FALCON3_7B = dict(vocab_size=131072, hidden_size=3072, intermediate_size=23040,
                  num_hidden_layers=4, num_attention_heads=12, num_key_value_heads=4,
                  rms_norm_eps=1e-6, rope_theta=1000042.0, tie_word_embeddings=False)

# one checkout's build: every source, or (an argument "k3") the decode
# attention sources (one a head dim, or one for all; K8's own before they
# were merged), each nvcc started at once
BUILD = r"""
import json, subprocess, sys, tempfile, time
sys.path.insert(0, ".")
from llm_qat_torch.ops import _build as B
if sys.argv[1:] != ["k3"]:
    B.build_all()
    print("BUILD " + json.dumps(B.build_seconds), flush=True)
    sys.exit(0)
B.BUILD_DIR.mkdir(parents=True, exist_ok=True)
procs, secs = {}, {}
for src in sorted(B.CSRC.glob("decode_attention*.cu")) + sorted(B.CSRC.glob("paged_attention.cu")):
    if not B._target(src).exists():
        log = tempfile.TemporaryFile(mode="w+")
        cmd = [B._nvcc(), *B.NVCC_FLAGS, "-o", str(B._target(src)), str(src)]
        procs[src.stem] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log,
                           time.perf_counter())
while procs:
    for stem, (p, log, t0) in list(procs.items()):
        if p.poll() is None:
            continue
        secs[stem] = time.perf_counter() - t0
        del procs[stem]
        if p.returncode:
            log.seek(0)
            sys.exit(f"nvcc failed on {stem}.cu:\n{log.read()}")
    time.sleep(0.05)
print("BUILD " + json.dumps(secs), flush=True)
"""

RUN = r"""
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as S
from llm_qat_torch.inference import megakernel as MK
from llm_qat_torch.inference import quantized as Q
from llm_qat_torch.models import llama
from llm_qat_torch.models import params as P
from llm_qat_torch.models.config import LLAMA_7B, TINYLLAMA_1B
from llm_qat_torch.ops import decode_attention as DA
from llm_qat_torch.ops import flash_attention as FA
k3_only, shapes, flash, flash_fwd, falcon3 = (json.loads(a) for a in sys.argv[1:6])
timer = S.Timer()
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
out = []
for kvh, G, hd in shapes:
    try:
        DA._check_kernel_shape("decode", torch.zeros(1, dtype=torch.bfloat16), G, hd, 8)
    except NotImplementedError:
        out += [dict(run=f"{k} G={G} hd={hd} {p}", ms=None)
                for k, p in (("K3", "int8"), ("K3", "packed"), ("K8", "int8"))]
        continue
    for packed in (False, True):
        r = S.decode_attention_phase(timer, gen, DA, kvh, G, hd, packed)
        out.append(dict(run=f"K3 G={G} hd={hd} {'packed' if packed else 'int8'}", ms=r["ms"]))
    r = S.paged_attention_phase(timer, gen, DA, kvh, G, hd, False)
    out.append(dict(run=f"K8 G={G} hd={hd} int8", ms=r["ms"]))
for B, G, n, D in () if k3_only else flash:
    r = S.flash_phase(timer, gen, FA, B, G, n, D)
    out.append(dict(run=f"K4 B={B} G={G} S={n} D={D}", ms=r["ms"]))
    q, do = (torch.randn(B, G, n, D, device="cuda", generator=gen).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(B, n, D, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
    o, lse = FA._flash_fwd(q, k, v, lens)
    bwd = (q, k, v, lens, lse, FA._delta(o, do), do)
    out.append(dict(run=f"K10 B={B} G={G} S={n} D={D}", ms=timer(lambda: FA._flash_bwd_dq(*bwd))))
    out.append(dict(run=f"K11 B={B} G={G} S={n} D={D}",
                    ms=timer(lambda: FA._flash_bwd_dkv(*bwd))))
    del q, do, k, v, o, lse, bwd
    torch.cuda.empty_cache()
for B, G, n, D in () if k3_only else flash_fwd:
    try:
        FA._check_built("flash_attention.cu", D, (torch.zeros(1, dtype=torch.bfloat16),) * 3)
    except NotImplementedError:
        out.append(dict(run=f"K4 B={B} G={G} S={n} D={D}", ms=None))
        continue
    r = S.flash_phase(timer, gen, FA, B, G, n, D)
    out.append(dict(run=f"K4 B={B} G={G} S={n} D={D}", ms=r["ms"]))
modes = (("W8A8KV8", dict(w_bits=8, a_bits=8, kv_bits=8)),
         ("W4A8KV4", dict(w_bits=4, a_bits=8, kv_bits=4, kv_cache_pack=True)))
for name, base in () if k3_only else (("TinyLlama-1.1B", TINYLLAMA_1B), ("LLaMA-7B", LLAMA_7B),
                                      ("Falcon3-7B 4 layers", LLAMA_7B.replace(**falcon3))):
    for label, mode in modes:
        cfg = base.replace(**mode)
        if not MK.card_takes(cfg, len(S.K9_LENS), 2048, torch.bfloat16):
            out.append(dict(run=f"K9 {name} {label}", ms=None))
            continue
        qp = Q.quantize_params(P.init_params(cfg, seed=0, dtype=torch.bfloat16), cfg)
        torch.cuda.empty_cache()
        b, n, hd = len(S.K9_LENS), 2048, cfg.head_dim
        cache = S.random_cache(cfg, b, n, gen)
        lens = torch.tensor(S.K9_LENS, dtype=torch.int32, device="cuda")
        act = torch.tensor([i != S.K9_INACTIVE for i in range(b)], device="cuda")
        ids = torch.randint(0, cfg.vocab_size, (b, 1), device="cuda", generator=gen)
        x = qp["embed"][ids[:, 0]].to(torch.bfloat16)
        qcos, qsin = llama.rope_cos_sin(lens[:, None], hd, cfg.rope_theta)
        qcos, qsin = qcos[:, 0, :hd // 2].contiguous(), qsin[:, 0, :hd // 2].contiguous()
        kcos, ksin = MK._cache_rope_tables(n, hd, cfg.rope_theta, "cuda")
        args = (x, qcos, qsin, kcos, ksin, qp["layers"], cache, lens, act, cfg,
                MK.pick_bk(cfg, b, n), torch.bfloat16)
        card = MK.card_weights(qp)
        ms = timer(lambda: MK.decode_layers(*args, card=card))
        out.append(dict(run=f"K9 {name} {label}", ms=ms))
        del qp, cache, card, args, x
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
"""


def _result(proc, tree: str, tag: str):
    out, err = proc.communicate() if isinstance(proc, subprocess.Popen) else (proc.stdout, proc.stderr)
    lines = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{out[-2000:]}\n{err[-4000:]}")
    return json.loads(lines[-1][len(tag) + 1:])


def main() -> int:
    args = sys.argv[1:]
    k3_only = "--k3-only" in args
    others = [os.path.abspath(a) for a in args if a != "--k3-only"]
    if not others:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    trees = [REPO, *others]
    name = {t: "this" if t == REPO else f"other{i}" for i, t in enumerate(trees)}
    builds = [subprocess.Popen([sys.executable, "-c", BUILD, *(["k3"] if k3_only else [])],
                               cwd=t, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for t in trees]
    for t, p in zip(trees, builds):
        secs = _result(p, t, "BUILD")
        print(f"{name[t]:7s} {t}: build (s a source, every checkout's started together): "
              + (", ".join(f"{k} {v:.1f}" for k, v in sorted(secs.items())) or "built already"),
              flush=True)
    for t in trees + trees[::-1]:
        proc = subprocess.run([sys.executable, "-c", RUN, json.dumps(k3_only),
                               json.dumps(SHAPES), json.dumps(FLASH), json.dumps(FLASH_FWD),
                               json.dumps(FALCON3_7B)], cwd=t,
                              capture_output=True, text=True)
        for r in _result(proc, t, "RESULT"):
            print(f"{name[t]:7s} {r['run']:34s} "
                  + ("refused" if r["ms"] is None else f"{r['ms']:.4f} ms"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
