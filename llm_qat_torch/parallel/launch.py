"""Ranks on one host: ``spawn(fn, world)`` runs ``fn(rank, world, *args)`` in
``world`` fresh processes joined into one ``torch.distributed`` process group
and returns what each returned, by rank (the port's counterpart of the JAX
package's fake-device mesh, which its tests get from
``--xla_force_host_platform_device_count``).

* The ranks meet through a ``FileStore`` in a temporary directory, not a TCP
  port, so launches that run side by side never collide; gloo's own
  connections use the loopback interface unless ``GLOO_SOCKET_IFNAME`` says
  otherwise.
* The backend is the caller's: nothing switches to another when it fails.
  ``device="cuda"`` puts rank r on card ``r % device_count`` (two ranks share
  a card on a one-card host; NCCL refuses that, gloo does not).
* Every rank runs under ``timeout`` seconds (its collectives too): a rank
  that fails ends the others at once, and ranks still running at the
  deadline are killed, so a deadlock fails instead of hanging.

``fn`` and its arguments must be picklable (a module-level function): each
rank is a new interpreter that imports ``fn``'s module.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch


def _rank_main(fn, rank, world, backend, device, args, workdir, timeout, threads):
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(threads)
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(workdir, "store"), world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def spawn(fn: Callable, world: int, backend: str = "gloo", device: str = "cpu",
          args: Sequence[Any] = (), timeout: float = 300.0, threads: int = 1) -> List[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    computed by its own process in a process group of ``world`` ranks over
    ``backend``. ``threads``: the ranks' intra-op threads. Raises
    ``RuntimeError`` with the failing ranks' tracebacks, or ``TimeoutError``
    when ranks outlive ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="llm_qat_torch_ranks_") as workdir:
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, backend, device, tuple(args),
                                                      workdir, timeout, threads))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            live = list(procs)
            while live and time.monotonic() < deadline:
                multiprocessing.connection.wait([p.sentinel for p in live],
                                                max(0.0, deadline - time.monotonic()))
                live = [p for p in procs if p.exitcode is None]
                if any(p.exitcode not in (None, 0) for p in procs):
                    break                       # one rank failed: the others may wait forever
        finally:
            stuck = [r for r, p in enumerate(procs) if p.exitcode is None]
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join()
        errors = []
        for r in range(world):
            path = os.path.join(workdir, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"--- rank {r} ---\n{f.read()}")
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0 and r not in stuck]
        if errors or failed:
            raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}, world={world}, {backend}): "
                               f"ranks {failed or stuck} failed\n" + "\n".join(errors))
        if stuck:
            raise TimeoutError(f"spawn({getattr(fn, '__name__', fn)}, world={world}, {backend}): "
                               f"ranks {stuck} still running after {timeout} s")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world)]
