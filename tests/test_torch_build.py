"""The kernel build (``llm_qat_torch/ops/_build.py``) on the CPU, with a
stand-in for ``nvcc``: every source compiles in a process of its own, all
started together; ``build_all(wait_for=...)`` returns while the others go on
compiling; ``library`` then waits only for its own source; a failure carries
the compiler's output; a compiler nothing waited for is stopped at exit."""

import os
import stat
import sys
import time

import pytest

from llm_qat_torch.ops import _build

FAKE_NVCC = f"""#!{sys.executable}
import sys, time
args = sys.argv[1:]
out, src = args[args.index("-o") + 1], args[-1]
text = open(src).read()
if "broken" in text:
    print("error: " + src + " does not compile")
    sys.exit(2)
time.sleep(float(text.split()[0]))
open(out, "w").write(text)
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_pending", {})
    monkeypatch.setattr(_build, "build_seconds", {})
    monkeypatch.setattr(_build, "_libs", {})
    return csrc, build


def test_build_all_compiles_every_source_together_and_reuses_them(tree):
    csrc, build = tree
    for name, secs in (("a", 1.0), ("b", 1.0), ("c", 1.0)):
        (csrc / f"{name}.cu").write_text(f"{secs} {name}")
    t0 = time.perf_counter()
    paths = _build.build_all()
    wall = time.perf_counter() - t0
    assert sorted(paths) == ["a", "b", "c"] and wall < 2.5   # in parallel, not 3 s
    assert all(p.read_text().endswith(n) for n, p in paths.items())
    assert set(_build.build_seconds) == {"a", "b", "c"} and not _build._pending
    assert not [p for p in build.iterdir() if p.suffix in (".tmp", ".log")]
    _build.build_seconds.clear()
    assert _build.build_all() == paths and not _build.build_seconds   # nothing rebuilt


def test_wait_for_leaves_the_slow_source_compiling_until_its_first_use(tree, monkeypatch):
    csrc, _ = tree
    (csrc / "fast.cu").write_text("0.05 fast")
    (csrc / "slow.cu").write_text("2.0 slow")
    loaded = []
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loaded.append(path) or path)
    t0 = time.perf_counter()
    _build.build_all(wait_for=["fast"])
    assert time.perf_counter() - t0 < 1.5
    assert list(_build._pending) == ["slow"] and set(_build.build_seconds) == {"fast"}
    assert _build.library("fast") and not loaded[0].endswith("slow")
    assert list(_build._pending) == ["slow"]  # loading a built source waits for no other
    _build.library("slow")                    # waits for its own compiler only
    assert not _build._pending and _build.build_seconds["slow"] >= 2.0
    assert open(loaded[-1]).read() == "2.0 slow"


def test_a_failed_source_raises_with_the_compilers_output(tree):
    csrc, build = tree
    (csrc / "good.cu").write_text("0.01 good")
    (csrc / "bad.cu").write_text("broken")
    with pytest.raises(RuntimeError, match=r"--- bad\.cu ---\nerror: .*bad\.cu does not compile"):
        _build.build_all()
    assert _build._target(csrc / "good.cu").exists()
    assert not _build._target(csrc / "bad.cu").exists()
    with pytest.raises(RuntimeError, match="no CUDA source csrc/missing.cu"):
        _build.library("missing")


def test_a_compiler_nothing_waited_for_is_stopped(tree):
    csrc, build = tree
    (csrc / "slow.cu").write_text("30 slow")
    _build.start_build()
    proc, tmp, log, _ = _build._pending["slow"]
    _build._stop_pending()
    assert proc.poll() is not None and not _build._pending
    assert not os.path.exists(tmp) and not os.path.exists(log.name)
    assert not _build._target(csrc / "slow.cu").exists()
