"""Continuous-batching engine over the paged quantized KV cache.

Port of the JAX package's ``inference/paged_engine.py``, on one device or,
with ``mesh=``, tensor-parallel as the slot engine is. It
extends the slot engine (``inference/engine.py``) with pooled memory: KV
lives in the shared page pool (``inference/paged.py``), slots allocate pages
lazily as they grow, and when the pool runs dry the engine **preempts** the
request with the most remaining work: its pages are released and it is
re-queued with its generated prefix folded into the prompt (recomputed on
re-admission). The throughput path is the same chunked device-side sampling
loop; sampling uses the engine's ``torch.Generator`` (its numbers are not
JAX's). Under a mesh the allocator and the block tables stay on the host,
the same on every rank; each rank's pool holds its kv heads.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from llm_qat_torch.device import resolve_device
from llm_qat_torch.inference import paged as PG
from llm_qat_torch.inference.engine import Request, _bucket, _sample_tokens
from llm_qat_torch.models.config import LlamaConfig


def _paged_decode_chunk(fwd, qparams, logits0, temps, active, seq_lens,
                        block_tables, cache: Dict[str, torch.Tensor], gen,
                        n_steps: int, top_k: int, sample: bool):
    """Sample and decode ``n_steps`` tokens with no host sync: a Python loop
    where the JAX package scans. ``fwd`` is the engine's paged forward.
    Returns (tokens [b, n_steps] on the device, last logits, pool, lengths)."""
    logits, lens, toks = logits0, seq_lens, []
    for _ in range(n_steps):
        tok = _sample_tokens(logits, temps, top_k, gen, sample)
        new_logits, cache = fwd(qparams, tok[:, None], lens, active, block_tables, cache)
        lens = torch.where(active, lens + 1, lens)
        logits = new_logits[:, 0]
        toks.append(tok)
    return torch.stack(toks, dim=1), logits, cache, lens


class PagedInferenceEngine:
    def __init__(
        self,
        qparams,
        config: LlamaConfig,
        *,
        pcfg: Optional[PG.PagedConfig] = None,
        max_batch: int = 8,
        steps_per_sync: int = 8,
        top_k: int = 50,
        dtype=torch.bfloat16,
        seed: int = 0,
        mesh=None,
        device=None,
    ):
        """Engine on ``device`` (``cuda`` unless ``device="cpu"``) over
        ``qparams`` from ``quantized.quantize_params``, or, with ``mesh`` (a
        ``DeviceMesh`` with a ``tp`` axis), over the whole
        ``sharded.quantize_params_tp`` tree, of which it keeps this rank's
        shard (see ``engine.InferenceEngine``)."""
        self.device = resolve_device(device)
        self.config = config
        self.pcfg = pcfg or PG.PagedConfig()
        self.max_batch = max_batch
        self.steps_per_sync = steps_per_sync
        self.top_k = top_k
        self.dtype = dtype
        self.mesh = mesh
        dev, pc = self.device, self.pcfg
        if mesh is None:
            self.qparams = qparams
            self.cache = PG.init_paged_cache(config, pc, device=dev)
            self._fwd = lambda qp, ids, lens, active, tables, cache: PG.paged_forward(
                qp, config, pc, ids, lens, active, tables, cache, dtype=dtype, device=dev)
            self._prefill = lambda qp, ids, lens, active, tables, cache: PG.paged_forward(
                qp, config, pc, ids, lens, active, tables, cache, dtype=dtype,
                from_empty=True, device=dev)
        else:
            from llm_qat_torch.inference import sharded as S

            S.check_mesh(mesh)
            self.qparams = S.shard_qparams(qparams, mesh)
            self.cache = S.init_paged_cache_tp(config, pc, mesh, device=dev)
            self._fwd = S.make_tp_paged_forward(config, pc, mesh, dtype=dtype, device=dev)
            self._prefill = S.make_tp_paged_forward(config, pc, mesh, dtype=dtype,
                                                    from_empty=True, device=dev)
        self.alloc = PG.PageAllocator(self.pcfg)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.lengths = np.zeros((max_batch,), np.int32)
        self.queue: deque[Request] = deque()
        self._uid = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # held logits for the next sample, one row per slot
        self._logits = torch.zeros((max_batch, config.vocab_size),
                                   dtype=torch.float32, device=self.device)
        self._tables = np.zeros((max_batch, self.pcfg.max_pages_per_seq), np.int32)

    # ------------------------------------------------------------------ API

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 128,
               temperature: float = 0.0, top_k: Optional[int] = None,
               eos_id: Optional[int] = None) -> int:
        # reject instead of truncating at admission; preemption re-queues
        # prompt + output, whose total stays within this same bound
        if len(prompt) + max_new_tokens > self.pcfg.max_seq_len - 1:
            raise ValueError(
                f"request does not fit: len(prompt)={len(prompt)} + "
                f"max_new_tokens={max_new_tokens} > max_seq_len-1="
                f"{self.pcfg.max_seq_len - 1}"
            )
        self._uid += 1
        self.queue.append(Request(
            uid=self._uid, prompt=list(prompt),
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k if top_k is not None else self.top_k, eos_id=eos_id,
        ))
        return self._uid

    def run(self) -> List[Request]:
        finished: List[Request] = []
        while self.queue or any(s is not None for s in self.slots):
            finished.extend(self.step())
        return finished

    # ----------------------------------------------------------- internals

    def _pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.pcfg.page_size)

    def _free_slot_pages(self, b: int) -> None:
        self.alloc.release(self.slot_pages[b])
        self.slot_pages[b] = []
        self._tables[b] = 0
        self.lengths[b] = 0

    def _ensure_capacity(self, b: int, tokens: int) -> bool:
        """Grow slot b's page list to cover ``tokens`` in all; False if the
        pool is dry. Raises if one sequence outgrows the block table."""
        total_pages = self._pages_needed(tokens)
        if total_pages > self.pcfg.max_pages_per_seq:
            raise MemoryError(
                f"sequence needs {total_pages} pages > max_pages_per_seq "
                f"{self.pcfg.max_pages_per_seq}"
            )
        need = total_pages - len(self.slot_pages[b])
        if need <= 0:
            return True
        if need > self.alloc.available:
            return False
        pages = self.alloc.alloc(need)
        start = len(self.slot_pages[b])
        self.slot_pages[b].extend(pages)
        self._tables[b, start:start + len(pages)] = pages
        return True

    def _preempt_victim(self, skip: int) -> bool:
        """Release the active slot with the most remaining budget (other
        than ``skip``); its progress is folded into a re-queued prompt."""
        candidates = [
            b for b, s in enumerate(self.slots) if s is not None and b != skip
        ]
        if not candidates:
            return False
        b = max(
            candidates,
            key=lambda i: self.slots[i].max_new_tokens - len(self.slots[i].output),
        )
        req = self.slots[b]
        req.prompt = req.prompt + req.output
        req.max_new_tokens -= len(req.output)
        req.output = []
        self.queue.appendleft(req)
        self.slots[b] = None
        self._free_slot_pages(b)
        return True

    def _admit(self) -> None:
        for b, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            req = self.queue[0]
            prompt = req.prompt[: self.pcfg.max_seq_len - req.max_new_tokens - 1]
            bucket = min(_bucket(len(prompt)), self.pcfg.max_seq_len - 1)
            prompt = prompt[:bucket]
            if not self._ensure_capacity(b, bucket):
                if not any(s is not None for s in self.slots):
                    raise MemoryError(
                        "paged KV pool too small for a single request "
                        f"(need {self._pages_needed(bucket)} pages, pool has "
                        f"{self.alloc.available})"
                    )
                break  # pool dry; decode what's running, retry later
            self.queue.popleft()

            # batch-1 prefill of just this slot: paged writes scatter
            # straight into the shared pool, so no splice is needed
            ids = np.zeros((1, bucket), np.int64)
            ids[0, : len(prompt)] = prompt
            logits, self.cache = self._prefill(
                self.qparams, ids, np.zeros((1,), np.int32), np.ones((1,), bool),
                self._tables[b:b + 1], self.cache,
            )
            self.lengths[b] = len(prompt)
            self._logits[b] = logits[0, len(prompt) - 1]
            self.slots[b] = req

    def step(self) -> List[Request]:
        self._admit()
        active_ids = [b for b, s in enumerate(self.slots) if s is not None]
        if not active_ids:
            return []

        budget = min(
            self.slots[b].max_new_tokens - len(self.slots[b].output)
            for b in active_ids
        )
        n_steps = max(1, min(self.steps_per_sync, budget))

        # every active slot needs page capacity for +n_steps tokens;
        # preempt longest-remaining requests if the pool is dry
        ready: List[int] = []
        for b in list(active_ids):
            while not self._ensure_capacity(b, int(self.lengths[b]) + n_steps):
                if not self._preempt_victim(skip=b):
                    raise MemoryError(
                        "paged KV pool too small for a single request"
                    )
            if self.slots[b] is not None:
                ready.append(b)
        active_ids = [b for b in ready if self.slots[b] is not None]

        active = np.zeros((self.max_batch,), bool)
        active[active_ids] = True
        temps = np.zeros((self.max_batch,), np.float32)
        for b in active_ids:
            temps[b] = self.slots[b].temperature

        dev = self.device
        toks, self._logits, self.cache, lens = _paged_decode_chunk(
            self._fwd, self.qparams, self._logits,
            torch.as_tensor(temps, device=dev), torch.as_tensor(active, device=dev),
            torch.as_tensor(self.lengths, device=dev),
            torch.as_tensor(self._tables, device=dev), self.cache, self._gen,
            n_steps, self.top_k, sample=bool((temps > 0).any()),
        )
        toks_np = toks.cpu().numpy()            # the chunk's one host sync
        self.lengths = lens.cpu().numpy().astype(np.int32)

        finished: List[Request] = []
        for b in active_ids:
            req = self.slots[b]
            seq = [int(t) for t in toks_np[b]]
            if req.eos_id is not None and req.eos_id in seq:
                req.output.extend(seq[: seq.index(req.eos_id) + 1])
                req.done = True
            else:
                req.output.extend(seq)
                if len(req.output) >= req.max_new_tokens:
                    req.output = req.output[: req.max_new_tokens]
                    req.done = True
            if int(self.lengths[b]) >= self.pcfg.max_seq_len - 1:
                req.done = True
            if req.done:
                finished.append(req)
                self.slots[b] = None
                self._free_slot_pages(b)
        return finished
