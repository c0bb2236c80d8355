"""Where a K1/K2 launch spends its time, block by block, on one NVIDIA GPU.

    python3 gemm_timeline.py

Builds ``llm_qat_torch/csrc/int8_matmul.cu`` and ``w4a8_matmul.cu`` with
``-DGEMM_TRACE`` (into ``build/llm_qat_torch/``), then launches each at the
TinyLlama-1.1B projections at decode rows (32) and at a prefill bucket
(1024 rows), the L2 flushed before the launch as ``chip_smoke.py`` times
them. Thread 0 of every block stamps the global timer at entry, when its
first stage of weights has landed, after its main loop and at its end
(``csrc/gemm_int8.cuh``, ``TRACE``). Prints per launch: the CUDA-event time,
then the median and the largest of each block's wait for its first stage,
its main loop and its epilogue (for split tiles: the cluster's sum), and
when the last block ended, in microseconds from the first block's entry.
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ROWS = (32, 1024)
PROJ = {"qkv": (2048, 2560), "o": (2048, 2048), "gateup": (2048, 11264), "down": (5632, 2048)}


def traced_libraries(_build) -> dict:
    """Build both sources with GEMM_TRACE and load them under their stems."""
    out = {}
    for stem in ("int8_matmul", "w4a8_matmul"):
        so = _build.BUILD_DIR / f"{stem}-trace.so"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DGEMM_TRACE", "-o", str(so),
                        str(_build.CSRC / f"{stem}.cu")], check=True)
        out[stem] = ctypes.CDLL(str(so))
        out[stem].gemm_read_trace.argtypes = [ctypes.c_void_p]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("gemm_timeline: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from llm_qat_torch.ops import _build
    from llm_qat_torch.ops import quant_matmul as QM

    libs = traced_libraries(_build)
    _build._libs.update(libs)
    _build._fns.clear()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stamps = np.zeros((4, 65536), dtype=np.uint64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for M in ROWS:
        for proj, (K, N) in PROJ.items():
            xq, sx = QM.quantize_per_token(torch.randn(M, K, device="cuda", generator=gen))
            w = torch.randn(K, N, device="cuda", generator=gen) * 0.02
            for tag, fn, stem, (wq, sw) in (
                    ("W8", QM.int8_matmul, "int8_matmul", QM.quantize_per_channel(w)),
                    ("W4", QM.int4_matmul, "w4a8_matmul", QM.quantize_weights_w4(w))):
                for _ in range(3):
                    fn(xq, wq, sx, sw)
                flush.zero_()
                torch.cuda._sleep(2_000_000)   # the host enqueues the call meanwhile
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn(xq, wq, sx, sw)
                b.record()
                torch.cuda.synchronize()
                if libs[stem].gemm_read_trace(stamps.ctypes.data):
                    raise RuntimeError("gemm_read_trace failed")
                plan = QM.gemm_plan(M, N, K, tag == "W4", sms)
                n = plan["tiles"] * plan["splits"]
                t = stamps[:, :n].astype(np.int64)
                t = (t - t[0].min()) / 1e3
                first, loop = t[1] - t[0], t[2] - t[1]
                done = t[3] >= t[2]          # stamps of this launch
                epi = (t[3] - t[2])[done]
                print(f"{tag} {proj:6s} M={M:4d} K={K} N={N} {plan['variant']} "
                      f"{n} blocks ({plan['splits']} split): event {a.elapsed_time(b) * 1e3:.1f}"
                      f" us; first stage {np.median(first):.2f} / {first.max():.2f}, loop "
                      f"{np.median(loop):.2f} / {loop.max():.2f}, epilogue "
                      f"{np.median(epi):.2f} / {epi.max():.2f} us (median / largest); "
                      f"last block ended at {t[3][done].max():.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
