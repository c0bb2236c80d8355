"""Where a K3 / K8 launch spends its time, stage by stage, on one NVIDIA GPU.

    python3 decode_attn_timeline.py

Builds ``llm_qat_torch/csrc/decode_attention.cu`` and ``paged_attention.cu``
with ``-DDECODE_ATTN_TRACE`` (into ``build/llm_qat_torch/``), then launches
K3 and K8 at ``chip_smoke.py``'s phase shapes (b = 8 slots, int8 cache,
bf16; TinyLlama-1.1B's heads and LLaMA-7B's; K3 also at S = 8192), the L2
flushed before the launch as ``chip_smoke.py`` times them. Thread 0 of every
block stamps the global timer at entry, after the item table, at the end
of the scores stage, after the first grid barrier, at the end of the
softmax.V stage, after the second barrier and at its end, and notes its
count of scores items (``csrc/decode_attn.cuh``, ``trace``). Prints per
launch: the CUDA-event time, the items a block, then for each stage the
median and the largest block's time in it and when the last block left it,
in microseconds from the first block's entry. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
STAGES = ("table", "scores", "barrier 1", "softmax.V", "barrier 2", "finish")


def traced_libraries(_build) -> dict:
    """Build both sources with DECODE_ATTN_TRACE and load them under their stems."""
    out = {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in ("decode_attention", "paged_attention"):
        so = _build.BUILD_DIR / f"{stem}-trace.so"
        procs[stem] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-DDECODE_ATTN_TRACE", "-o", str(so),
             str(_build.CSRC / f"{stem}.cu")]))
    for stem, (so, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed on {stem}.cu")
        out[stem] = ctypes.CDLL(str(so))
        getattr(out[stem], f"{stem}_read_trace").argtypes = [ctypes.c_void_p]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_attn_timeline: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as C
    from llm_qat_torch.ops import _build
    from llm_qat_torch.ops import decode_attention as DA

    libs = traced_libraries(_build)
    _build._libs.update(libs)
    _build._fns.clear()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stamps = np.zeros((8, 4096), dtype=np.uint64)
    served = [n + C.NEW_TOKENS // 2 for n in C.PROMPT_LENS]
    cases = [("K3", 4, 8, 64, 2048, served), ("K3", 32, 1, 128, 2048, served),
             ("K3", 4, 8, 64, 8192, list(C.LONG_LENS)),
             ("K8", 4, 8, 64, None, list(C.K9_LENS)), ("K8", 32, 1, 128, None, list(C.K9_LENS))]
    for name, kvh, G, hd, S, lens_l in cases:
        b = len(lens_l)
        q = torch.randn(b, kvh * G, hd, device="cuda", generator=gen).to(torch.bfloat16)
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        if name == "K3":
            kq = torch.randint(-127, 128, (b, kvh, hd, S), device="cuda", generator=gen).to(torch.int8)
            ks = torch.rand(b, S, device="cuda", generator=gen) * 0.02 + 0.005
            kc, ksn = DA._rope_tables(S, hd, 10000.0, "cuda")
            stem = "decode_attention"
            call = lambda: DA.quantized_decode_attention(q, kq, ks, kq, ks, lens, kc, ksn)  # noqa: E731
        else:
            pages, mp = C.ROOMY_PAGES, C.SEQ_PAGES
            kq = torch.randint(-127, 128, (pages, kvh, hd, C.PAGE), device="cuda",
                               generator=gen).to(torch.int8)
            ks = torch.rand(pages, C.PAGE, device="cuda", generator=gen) * 0.02 + 0.005
            bt = torch.randperm(pages, device="cuda", generator=gen)[:b * mp].reshape(b, mp)
            bt = bt.to(torch.int32)
            kc, ksn = DA._rope_tables(mp * C.PAGE, hd, 10000.0, "cuda")
            stem = "paged_attention"
            call = lambda: DA.quantized_paged_attention(q, kq, ks, kq, ks, lens, bt, kc, ksn)  # noqa: E731
        for _ in range(3):
            call()
        flush.zero_()
        torch.cuda._sleep(2_000_000)   # the host enqueues the call meanwhile
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        e.record()
        torch.cuda.synchronize()
        stamps[:] = 0
        if getattr(libs[stem], f"{stem}_read_trace")(stamps.ctypes.data):
            raise RuntimeError("read_trace failed")
        n = int((stamps[0] > 0).sum())
        t = stamps[:7, :n].astype(np.int64)
        t = (t - t[0].min()) / 1e3
        items = stamps[7, :n]
        parts = "; ".join(f"{st} {np.median(t[k + 1] - t[k]):.2f} / {(t[k + 1] - t[k]).max():.2f}"
                          f" (left by {t[k + 1].max():.2f})" for k, st in enumerate(STAGES))
        print(f"{name} kvh={kvh} G={G} hd={hd} {'S=' + str(S) if S else 'pages of 128'} "
              f"lens={lens_l}: event {a.elapsed_time(e) * 1e3:.1f} us, {n} blocks, scores items "
              f"a block {items.min()}..{items.max()}; us a block, median / largest: {parts}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
