"""Why the bf16 flash kernels at head dims 64 and 128 name only their thread
count in ``__launch_bounds__``, while those at 16 and 32 also name a minimum
of one block an SM, measured on one NVIDIA GPU.

    python3 flash_launch_bounds.py

Copies ``llm_qat_torch/`` twice into ``build/flash_launch_bounds/``, keeping
only the flash sources: ``shipped`` as it is, and ``min1`` with the minimum
named on every bf16 kernel (``__launch_bounds__(TC_THREADS, 1)``: one kernel
of each kind would then serve every head dim). Builds both, then, in the
order shipped, min1, min1, shipped, each in a process of its own: what the
compiler gave each bf16 kernel (``kernel_attributes()``), and K4, K10 and
K11 timed (median of 40 CUDA-event runs after warm-up) at the shapes of
``chip_smoke.py``'s phases 2 and 2b, with a digest of their outputs.

Prints one JSON line. Imports nothing of JAX. Exits 1 without a GPU.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "flash_launch_bounds")
FLASH = ("flash_attention.cu", "flash_attention_bwd.cu")
TRAIN_LENS = (2048,) * 10 + (1234, 777, 1, 0, 2048, 1500)
LLAMA7B_TRAIN_LENS = (2048,) * 16 + tuple(2048 - 97 * i for i in range(1, 15)) + (1, 0)
# (D, B, G, S, lengths): B = batch x kv heads
SHAPES = ((64, 4, 8, 1024, None), (64, 16, 8, 2048, TRAIN_LENS),
          (128, 32, 1, 1024, None), (128, 32, 1, 2048, LLAMA7B_TRAIN_LENS),
          (16, 16, 2, 2048, None), (32, 16, 2, 2048, None), (32, 128, 2, 256, None))


def make_tree(name: str) -> str:
    root = os.path.join(WORK, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "llm_qat_torch"), os.path.join(root, "llm_qat_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(root, "llm_qat_torch", "csrc")
    for f in os.listdir(csrc):
        if f.endswith(".cu") and f not in FLASH:
            os.remove(os.path.join(csrc, f))
    if name == "min1":
        for f in FLASH:
            path = os.path.join(csrc, f)
            src = open(path).read()
            if "__launch_bounds__(TC_THREADS) flash_" not in src:
                raise RuntimeError(f"{f}: no bf16 kernel without a minimum")
            open(path, "w").write(src.replace("__launch_bounds__(TC_THREADS) flash_",
                                              "__launch_bounds__(TC_THREADS, 1) flash_"))
    return root


def median_ms(fn, reps: int = 40) -> float:
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in ev)[reps // 2]


def measure(tree: str) -> dict:
    """One variant, in this process: attributes, times and output digests."""
    sys.path.insert(0, tree)
    from llm_qat_torch.ops import _build
    from llm_qat_torch.ops import flash_attention as FA

    _build.build_all()
    attrs = {k: v for k, v in FA.kernel_attributes().items() if not k.endswith("_f32")}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    for D, B, G, S, lens in SHAPES:
        q, do = (torch.randn(B, G, S, D, device="cuda", generator=gen).bfloat16() for _ in "qd")
        k, v = (torch.randn(B, S, D, device="cuda", generator=gen).bfloat16() for _ in "kv")
        L = torch.tensor(lens or (S,) * B, dtype=torch.int32, device="cuda")
        o, lse = FA._flash_fwd(q, k, v, L)
        args = (q, k, v, L, lse, FA._delta(o, do), do)
        h = hashlib.sha256()
        for x in (o, lse, FA._flash_bwd_dq(*args), *FA._flash_bwd_dkv(*args)):
            h.update(x.float().cpu().numpy().tobytes())
        cases.append(dict(D=D, B=B, G=G, S=S, ragged=lens is not None, digest=h.hexdigest()[:16],
                          fwd_ms=median_ms(lambda: FA._flash_fwd(q, k, v, L)),
                          dq_ms=median_ms(lambda: FA._flash_bwd_dq(*args)),
                          dkv_ms=median_ms(lambda: FA._flash_bwd_dkv(*args))))
    return dict(attrs=attrs, cases=cases)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--tree":
        print(json.dumps(measure(sys.argv[2])))
        return 0
    if not torch.cuda.is_available():
        print("flash_launch_bounds: no CUDA device", file=sys.stderr)
        return 1
    trees = {name: make_tree(name) for name in ("shipped", "min1")}
    runs = {"shipped": [], "min1": []}
    for name in ("shipped", "min1", "min1", "shipped"):
        out = subprocess.run([sys.executable, __file__, "--tree", trees[name]], check=True,
                             capture_output=True, text=True).stdout
        runs[name].append(json.loads(out.strip().splitlines()[-1]))
    first = runs["shipped"][0]
    kernels = {k: {name: {key: runs[name][0]["attrs"][k][key]
                          for key in ("registers", "blocks_per_sm", "spill_bytes")}
                   for name in runs} for k in first["attrs"]}
    shapes = []
    for i, c in enumerate(first["cases"]):
        row = {key: c[key] for key in ("D", "B", "G", "S", "ragged")}
        digests = {r["cases"][i]["digest"] for rs in runs.values() for r in rs}
        row["same_outputs"] = len(digests) == 1
        for name, rs in runs.items():
            for key in ("fwd_ms", "dq_ms", "dkv_ms"):
                row[f"{name}_{key}"] = [r["cases"][i][key] for r in rs]
        shapes.append(row)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(card=card, kernels=kernels, shapes=shapes)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
