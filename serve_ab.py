"""Serving numbers of two checkouts of the port, in turns, on one NVIDIA GPU.

    python3 serve_ab.py OTHER_CHECKOUT

Runs ``chip_smoke.serve`` (each checkout's own: its kernels, its engine) on
TinyLlama-1.1B at full width and depth with random weights from seed 0, at
W4A8KV4 and W8A8KV8, on the scan path (``use_megakernel=False``) and the
default path, and ``chip_smoke.serve_paged`` with the roomy pool, for the
same 8 prompts of ``chip_smoke.PROMPT_LENS``: first this checkout, then
OTHER_CHECKOUT, then OTHER_CHECKOUT, then this one (each in a process of its
own, building its kernels into its own ``build/``). Prints one line a run:
prefill seconds (device-synchronised around the engine's prefill calls),
decode ms a step, and the device busy time of one profiled 8-step decode
chunk with the part of it in the decode attention kernels K3 and K8 (the
kernels whose names hold ``attn_kernel``); then, a mode, the device time of
the 8 prompts' prefill alone (one new token each, under the profiler) and
the part of it in the int8 / W4A8 GEMM kernels. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))

RUN = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as S
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from llm_qat_torch.inference import engine as E
from llm_qat_torch.inference import quantized as Q
from llm_qat_torch.models import params as P
from llm_qat_torch.models.config import TINYLLAMA_1B as cfg
rng = np.random.default_rng(0)
modes = {"W4A8KV4": cfg.replace(w_bits=4, a_bits=8, kv_bits=4, kv_cache_pack=True),
         "W8A8KV8": cfg.replace(w_bits=8, a_bits=8, kv_bits=8)}
out = []
for label, mcfg in modes.items():
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n))) for n in S.PROMPT_LENS]
    qp = Q.quantize_params(P.init_params(mcfg, seed=0, dtype=torch.bfloat16), mcfg)
    for path, c in (("scan", mcfg.replace(use_megakernel=False)), ("default", mcfg)):
        m = S.serve(f"{label} {path}", c, qp, prompts)[0]
        out.append(dict(run=f"{label} {path}", prefill_s=m["prefill_s"],
                        decode_ms_per_step=m["decode_ms_per_step"],
                        chunk_busy_ms=m["profile"]["device_busy_ms"],
                        chunk_wall_ms=m["profile"]["wall_ms"],
                        attn_ms=sum(ms for name, ms, n in m["profile"]["top"]
                                    if "attn_kernel" in name)))
    m = S.serve_paged(f"{label} paged", mcfg, qp, prompts, S.ROOMY_PAGES, profile=True)[0]
    out.append(dict(run=f"{label} paged", prefill_s=m["prefill_s"],
                    decode_ms_per_step=m["decode_ms_per_step"],
                    chunk_busy_ms=m["profile"]["device_busy_ms"],
                    chunk_wall_ms=m["profile"]["wall_ms"],
                    attn_ms=sum(ms for name, ms, n in m["profile"]["top"]
                                if "attn_kernel" in name)))
    # prefill alone (one new token a request) under the profiler: device time
    eng = E.InferenceEngine(qp, mcfg.replace(use_megakernel=False), max_batch=8, max_len=2048)
    for rep in range(2):   # the first run warms up
        for p in prompts:
            eng.submit(p, max_new_tokens=1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.run()
            torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    gemm = [e for e in ev if "gemm_int8" in e.key]
    out.append(dict(run=f"{label} prefill",
                    device_ms=sum(e.self_device_time_total for e in ev) / 1e3,
                    gemm_ms=sum(e.self_device_time_total for e in gemm) / 1e3))
    del qp, eng
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
"""


def run(tree: str) -> list:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    for tree in (REPO, other, other, REPO):
        for r in run(tree):
            who = "this " if tree == REPO else "other"
            if "device_ms" in r:
                print(f"{who} {r['run']:16s} device {r['device_ms']:.2f} ms, of it the int8 "
                      f"GEMM kernels {r['gemm_ms']:.2f} ms", flush=True)
                continue
            print(f"{who} {r['run']:16s} prefill {r['prefill_s']:.4f} s, decode "
                  f"{r['decode_ms_per_step']:.3f} ms/step, decode chunk busy "
                  f"{r['chunk_busy_ms']:.2f} of {r['chunk_wall_ms']:.2f} ms, of it the decode "
                  f"attention kernel {r['attn_ms']:.2f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
