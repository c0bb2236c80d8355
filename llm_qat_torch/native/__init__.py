"""Native (C++) host-side data helpers, built at first use.

``get_fastdata()`` returns the compiled ``_fastdata`` extension (jsonl reader
+ line counter; the JAX package's ``native/_fastdata.cpp``, copied) or None
when g++ or Python's headers are missing; callers keep a pure-Python reader.
The library is built by g++ into ``build/llm_qat_torch/`` at the repository
root (listed in ``.gitignore``), named by a hash of its source and the
interpreter, never into the package. ``data.dataset.last_reader`` says which
reader a read took.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "_fastdata.cpp"
BUILD_DIR = _SRC.parent.parent.parent / "build" / "llm_qat_torch"

_cached = False
_module = None


def _target() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + sys.version.encode()).hexdigest()[:16]
    return BUILD_DIR / f"_fastdata-{h}{sysconfig.get_config_var('EXT_SUFFIX') or '.so'}"


def build(force: bool = False) -> Optional[str]:
    """Compile the extension with g++ if needed; returns the library's path,
    or None when it cannot be built."""
    out = _target()
    if out.exists() and not force:
        return str(out)
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", f"-I{include}", str(_SRC),
           "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)
    return str(out)


def get_fastdata():
    """Import (building if necessary) the native module, or None."""
    global _cached, _module
    if _cached:
        return _module
    _cached = True
    path = build()
    if path is None:
        return None
    try:
        import importlib.util

        spec = importlib.util.spec_from_file_location("_fastdata", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _module = mod
    except ImportError:
        _module = None
    return _module

