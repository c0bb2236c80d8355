"""Build and load the port's CUDA kernels.

Each ``llm_qat_torch/csrc/*.cu`` source is compiled by ``nvcc`` on its own into
a shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/llm_qat_torch/<stem>-<hash>.so <stem>.cu

The libraries go to ``build/llm_qat_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of their source, so a changed source builds
anew and an unchanged one is reused. All sources build at first use, one
``nvcc`` process each, started together; ``start_build`` starts them and
returns, so a caller can work while the slow ones compile, and ``library``
then waits only for the source it loads. Nothing here runs at import: the
package imports without CUDA or ``nvcc``.
"""

from __future__ import annotations

import atexit
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
_pending: Dict[str, tuple] = {}   # stem -> (nvcc process, temporary output, its log, start)
build_seconds: Dict[str, float] = {}   # stem -> seconds from its nvcc's start until a wait saw it end


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


def start_build(background=()) -> None:
    """Start one ``nvcc`` for each source whose library is missing (and is not
    compiling already), and return at once. Each writes its messages to a
    file beside its output, so none blocks on a full pipe. The stems in
    ``background`` compile at a lower scheduling priority (10), so that the
    others take the cores first."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if out.exists() or src.stem in _pending:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(tmp.with_suffix(".log"), "w+")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        if src.stem in background:
            try:        # from here, the compiler stages nvcc starts inherit it
                os.setpriority(os.PRIO_PROCESS, proc.pid, 10)
            except OSError:     # the compiler has exited already
                pass
        _pending[src.stem] = (proc, tmp, log, time.perf_counter())


def wait_build(stem: str) -> Path:
    """Wait for ``csrc/<stem>.cu``'s ``nvcc`` if one is running; return the
    library's path. Raises with the compiler's output on failure."""
    out = _target(CSRC / f"{stem}.cu")
    if stem in _pending:
        proc, tmp, log, t0 = _pending.pop(stem)
        proc.wait()
        build_seconds[stem] = time.perf_counter() - t0
        log.seek(0)
        text = log.read()
        log.close()
        os.unlink(log.name)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n--- {stem}.cu ---\n{text}")
        os.replace(tmp, out)
    return out


def build_all(wait_for=None) -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel, and wait
    for those named in ``wait_for`` (default: all), each as it finishes (the
    others compile at a lower priority); return ``{stem: library path}``.
    Raises with the compiler's output on failure."""
    start_build(background=() if wait_for is None
                else {src.stem for src in CSRC.glob("*.cu")} - set(wait_for))
    names = set(_pending) if wait_for is None else set(wait_for) & set(_pending)
    failed = []
    while names:
        done = [stem for stem in sorted(names) if _pending[stem][0].poll() is not None]
        if not done:
            time.sleep(0.05)
        for stem in done:
            names.discard(stem)
            try:
                wait_build(stem)
            except RuntimeError as e:
                failed.append(str(e))
    if failed:
        raise RuntimeError("\n".join(failed))
    return {src.stem: _target(src) for src in sorted(CSRC.glob("*.cu"))}


@atexit.register
def _stop_pending() -> None:
    """Stop the compilers nothing waited for (a run that failed early)."""
    for proc, tmp, log, _ in _pending.values():
        proc.kill()
        proc.wait()
        log.close()
        for f in (tmp, Path(log.name)):
            f.unlink(missing_ok=True)
    _pending.clear()


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``: waits for it alone
    if ``start_build`` started it, builds all missing sources if it is
    missing, and waits for nothing if it is built."""
    if stem not in _libs:
        if not (CSRC / f"{stem}.cu").exists():
            raise RuntimeError(f"no CUDA source csrc/{stem}.cu")
        path = _target(CSRC / f"{stem}.cu")
        if stem in _pending:
            wait_build(stem)
        elif not path.exists():
            build_all()
        _libs[stem] = ctypes.CDLL(str(path))
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


# The head dims the padded builds take beside their own power-of-two ones:
# K4's flash_fwd_dpad (csrc/flash_attention.cu), K3/K7/K8's
# decode_attention_dpad.cu (decode_attn.cuh DECODE_ATTN_PAD) and K9's
# megakernel_dpad.cu (megakernel.cuh MEGAKERNEL_PAD): rows of hd values in
# global memory, 8-byte aligned, in shared buffers sized for 128.
PADDED_RULE = "hd % 4 == 0 with 32 < hd <= 128"


def in_padded_rule(hd: int) -> bool:
    """Whether head dim ``hd`` is of ``PADDED_RULE``."""
    return hd % 4 == 0 and 32 < hd <= 128


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
