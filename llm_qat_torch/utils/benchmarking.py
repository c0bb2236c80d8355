"""Device-time measurement of one operation, the counterpart of the JAX
package's ``utils/benchmarking.py``: the same three functions, arguments
and contract (``measure`` gives per-iteration device seconds with the
harness's floor subtracted, clamped at 0).

The JAX design dispatches ``iters`` runs of the op as ONE program (a
``lax.scan``), so that the per-dispatch cost is paid once, and subtracts
the same harness around a trivial body. On the card the counterpart of the
one program is a CUDA graph: ``iters`` runs of ``fn(*args)`` are captured
once and replayed as one launch, timed between two CUDA events. The floor
is the same harness around a one-element operation. The JAX version
threads the scan's carry into the op's first input, because XLA would
otherwise hoist a loop-invariant body out of the scan; eager PyTorch
hoists nothing and a graph replays every captured launch as recorded, so
the carry perturbation is not needed here.

On the CPU (arguments on the CPU, or ``device="cpu"``) the runs are timed
with the host clock (``clock``, ``time.perf_counter``). The device is the
arguments'; a CUDA tensor on a machine without a card fails, it does not
fall back to the CPU.

``fn`` must be capturable on the card: no host synchronisation (``.item()``,
``.cpu()``) and no allocation whose size depends on data. The port's kernel
wrappers count their launches in Python: a capture adds ``iters`` to the
count of each kernel ``fn`` launches, replays add nothing.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

clock = time.perf_counter   # the host clock of the CPU path (a test may replace it)


def _device_of(args: Sequence) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _graph_time(fn: Callable, args: Sequence, iters: int, reps: int) -> float:
    """Seconds for one replay of a CUDA graph of ``iters`` runs of
    ``fn(*args)``, averaged over ``reps`` replays after a warm one."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the capture (first-call work)
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end) / 1e3
    del graph
    return total / reps


def _host_time(fn: Callable, args: Sequence, iters: int, reps: int) -> float:
    """Seconds for ``iters`` runs of ``fn(*args)`` on the host clock,
    averaged over ``reps`` after a warm run."""
    fn(*args)
    t0 = clock()
    for _ in range(reps):
        for _ in range(iters):
            fn(*args)
    return (clock() - t0) / reps


def scan_time(
    fn: Callable[..., torch.Tensor],
    args: Sequence[torch.Tensor],
    *,
    iters: int = 500,
    reps: int = 3,
) -> float:
    """Total seconds for one dispatch of ``iters`` runs of ``fn(*args)`` (a
    CUDA graph replay on the card), averaged over ``reps``."""
    if _device_of(args).type == "cuda":
        return _graph_time(fn, args, iters, reps)
    return _host_time(fn, args, iters, reps)


def dispatch_floor(iters: int = 500, reps: int = 3, device="cuda") -> float:
    """Per-dispatch seconds of the harness itself around a one-element
    operation on ``device``."""
    x = torch.ones(1, device=device)
    return scan_time(lambda t: t * 2.0, [x], iters=iters, reps=reps)


def measure(
    fn: Callable[..., torch.Tensor],
    args: Sequence[torch.Tensor],
    *,
    iters: int = 500,
    reps: int = 3,
    floor: float | None = None,
) -> float:
    """Per-iteration device seconds of ``fn(*args)``, floor-subtracted and
    clamped at 0."""
    if floor is None:
        floor = dispatch_floor(iters=iters, reps=reps, device=_device_of(args))
    total = scan_time(fn, args, iters=iters, reps=reps)
    return max(total - floor, 0.0) / iters
