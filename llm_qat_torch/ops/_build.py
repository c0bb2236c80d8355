"""Build and load the port's CUDA kernels.

Each ``llm_qat_torch/csrc/*.cu`` source is compiled by ``nvcc`` on its own into
a shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/llm_qat_torch/<stem>-<hash>.so <stem>.cu

The libraries go to ``build/llm_qat_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of their source, so a changed source builds
anew and an unchanged one is reused. All sources build at first use, one
``nvcc`` process each, started together. Nothing here runs at import: the
package imports without CUDA or ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "llm_qat_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}
build_seconds = 0.0   # time the last build_all() spent compiling


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [shutil.which("nvcc")]
    if CUDA_HOME:
        cand.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("llm_qat_torch: nvcc not found (set CUDA_HOME or PATH)")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):  # shared headers
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel; return
    ``{stem: library path}``. Raises with the compiler's output on failure."""
    global build_seconds
    srcs = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for src in srcs:
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {stem}.cu ---\n{log}")
            continue
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {src.stem: _target(src) for src in srcs}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (builds all sources
    on first use)."""
    if stem not in _libs:
        paths = build_all()
        if stem not in paths:
            raise RuntimeError(f"no CUDA source csrc/{stem}.cu")
        _libs[stem] = ctypes.CDLL(str(paths[stem]))
    return _libs[stem]


def bind(stem: str, fn: str, n_ptr: int, n_int: int, n_float: int = 0):
    """Declare ``fn(ptr * n_ptr, int * n_int, float * n_float, stream)``
    returning an ``int`` (the ``cudaError_t`` after the launch); the bound
    function is cached."""
    key = f"{stem}:{fn}"
    if key in _fns:
        return _fns[key]
    f = getattr(library(stem), fn)
    f.argtypes = (
        [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
        + [ctypes.c_float] * n_float + [ctypes.c_void_p]
    )
    f.restype = ctypes.c_int
    _fns[key] = f
    return f


def query(stem: str, fn: str, n_out: int, *ints: int) -> list:
    """Call ``fn(int *out, int...)`` of ``csrc/<stem>.cu``, a host-side query
    that launches nothing, and return its ``n_out`` results."""
    f = getattr(library(stem), fn)
    f.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * len(ints)
    f.restype = ctypes.c_int
    out = (ctypes.c_int * n_out)()
    check(f(ctypes.addressof(out), *ints), fn)
    return list(out)


# what csrc/tc_bf16.cuh attributes() reports, in its order
ATTRIBUTE_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes", "spill_bytes",
                  "threads", "blocks_per_sm")


def attributes(stem: str, fn: str, *ints: int) -> dict:
    """A kernel's registers a thread, shared bytes (static, dynamic), local
    (spill) bytes a thread, threads a block and blocks an SM can hold, from
    the host-side query ``fn(int *out, int...)`` of ``csrc/<stem>.cu``."""
    return dict(zip(ATTRIBUTE_KEYS, query(stem, fn, len(ATTRIBUTE_KEYS), *ints)))


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
