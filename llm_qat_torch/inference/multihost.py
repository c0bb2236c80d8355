"""Multi-host serving driver: data over hosts x tensor parallelism within a
host (the JAX package's ``inference/multihost.py``).

Each host runs its own continuous-batching engine (``inference/engine.py``)
over a tp-split model on its own ranks, and requests are partitioned across
hosts: no collective crosses hosts on the decode path. In the port every
rank is one process on one device; a host is the ranks that share a node
(``LOCAL_WORLD_SIZE``, which torchrun sets, or ``local_size=``), and the
ranks of the world are laid out host by host, as torchrun numbers them.

* Every rank builds the same request -> host partition (uid round-robin),
  so no coordinator is needed: a ``submit`` on any rank enqueues only the
  requests its host owns. Every rank of a host calls ``submit`` and ``run``
  alike: the tp group's ranks run one engine together.
* Each host's engine runs over its tp group (the ``('host', 'tp')`` mesh of
  ``parallel.mesh.make_serving_mesh``); ``tp=1`` serves one rank a host with
  ``quantized.quantize_params``.
* ``run()`` drains the local engine, checks that every rank saw the same
  request stream (one all-gather of a CRC32 digest over the world, at drain,
  never on the decode path) and returns the requests with their global uids.
"""

from __future__ import annotations

import os
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from llm_qat_torch.inference.engine import InferenceEngine, Request
from llm_qat_torch.models.config import LlamaConfig
from llm_qat_torch.parallel import comm
from llm_qat_torch.parallel import mesh as pmesh


class MultiHostServingDriver:
    """One per rank, over an initialized default process group. ``params``
    are the latent-fp weights, the same on every rank; each host quantizes
    them into the tp-interleaved layout and its ranks keep their shards.
    ``tp`` defaults to the ranks of a host."""

    def __init__(
        self,
        params: Dict[str, Any],
        config: LlamaConfig,
        *,
        tp: Optional[int] = None,
        max_batch: int = 8,
        max_len: int = 2048,
        steps_per_sync: int = 8,
        dtype=torch.bfloat16,
        local_size: Optional[int] = None,
        device=None,
    ):
        if not dist.is_initialized():
            raise RuntimeError("MultiHostServingDriver needs torch.distributed initialized")
        world, rank = dist.get_world_size(), dist.get_rank()
        if local_size is None:
            local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if world % local_size:
            raise ValueError(f"{local_size} ranks a host do not divide the world of {world}")
        tp = local_size if tp is None else tp
        if tp > local_size:
            raise ValueError(
                f"tp={tp} exceeds {local_size} local devices: tensor "
                "parallelism stays within a host (no DCN on the hot path)"
            )
        if local_size % tp:
            raise ValueError(f"tp={tp} does not divide the {local_size} ranks of a host")
        # one engine a tp group: with the default tp a group is a host
        self.process_index = rank // tp
        self.process_count = world // tp
        if tp == 1:
            from llm_qat_torch.inference import quantized as Q

            qparams, mesh = Q.quantize_params(params, config, device=device), None
        else:
            from llm_qat_torch.inference import sharded as S

            mesh = pmesh.make_serving_mesh(tp)
            qparams = S.quantize_params_tp(params, config, tp, device=device)
        self.engine = InferenceEngine(
            qparams, config, max_batch=max_batch, max_len=max_len,
            steps_per_sync=steps_per_sync, dtype=dtype, mesh=mesh, device=device,
        )
        del qparams
        self._next_uid = 0
        self._stream_digest = 0
        self._local_to_global: Dict[int, int] = {}

    def owner(self, uid: int) -> int:
        """The host that serves ``uid``: every rank computes the same answer
        with no coordination."""
        return uid % self.process_count

    def submit(self, prompt: Sequence[int], **kw) -> int:
        """Assigns the next global uid and enqueues the request iff this
        host owns it. Every rank must call ``submit`` with the same request
        stream (the loopback form of a broadcast frontend); each folds
        (uid, prompt) into a CRC32 digest, owned or not, so ``run`` can
        check that all saw the same stream. Returns the global uid."""
        uid = self._next_uid
        self._next_uid += 1
        payload = np.asarray([uid, len(prompt), *prompt], np.int64).tobytes()
        self._stream_digest = zlib.crc32(payload, self._stream_digest)
        if self.owner(uid) == self.process_index:
            self._local_to_global[self.engine.submit(prompt, **kw)] = uid
        return uid

    def check_stream_consistency(self) -> None:
        """All-gather every rank's (digest, count) and raise if any rank saw
        another (uid, prompt) stream: a divergent stream would serve a prompt
        on the wrong host, twice or never, with no error."""
        if dist.get_world_size() == 1:
            return
        mine = torch.tensor([self._stream_digest, self._next_uid], dtype=torch.int64,
                            device=self.engine.device)
        every = comm.all_gather(mine[None], 0, None).cpu()
        if not bool((every == mine.cpu()[None]).all()):
            raise RuntimeError(
                "multi-host request streams diverged: per-host "
                f"(digest, count) = {every.tolist()} — every process must "
                "call submit() with an identical request stream"
            )

    def run(self) -> List[Request]:
        """Drain this host's engine; rewrites uids to the global ids after
        checking that every rank saw the same stream."""
        finished = self.engine.run()
        self.check_stream_consistency()
        for r in finished:
            r.uid = self._local_to_global.get(r.uid, r.uid)
        return finished
