"""Continuous-batching inference engine over the true-int serving model.

Port of the JAX package's ``inference/engine.py`` (single device):

* a fixed ``[max_batch]`` slot array shares one decode step;
* sampling stays on the device and ``steps_per_sync`` tokens are sampled
  and decoded before the host reads them (one host sync per chunk);
* admissions prefill with the prompt padded to a power-of-two bucket; the
  prompts that share a bucket prefill together, and each row is spliced into
  its slot; EOS/max-token retirements free slots between chunks.

Sampling is greedy where a request's temperature is 0, else top-k
temperature sampling with ``torch.multinomial`` on the engine's
``torch.Generator`` (seeded from ``seed``; its numbers are not JAX's).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from llm_qat_torch.device import resolve_device
from llm_qat_torch.inference import model as M
from llm_qat_torch.models.config import LlamaConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 128
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 50
    eos_id: Optional[int] = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _sample_tokens(logits, temps, top_k, gen, sample: bool = True):
    """Per-row sampling: greedy where temp <= 0, else top-k temperature.
    ``sample=False`` (no row samples) skips the draw."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not sample:
        return greedy
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    lg = logits / safe_t[:, None]
    if top_k and top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -float("inf")), lg)
    probs = torch.softmax(lg, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


def _decode_chunk(fwd, qparams, logits0, temps, active, cache, gen,
                  n_steps: int, top_k: int, sample: bool):
    """Sample and decode ``n_steps`` tokens with no host sync: a Python loop
    where the JAX package scans. Returns (tokens [b, n_steps] on the device,
    last logits, cache)."""
    logits, toks = logits0, []
    for _ in range(n_steps):
        tok = _sample_tokens(logits, temps, top_k, gen, sample)
        new_logits, cache = fwd(qparams, tok[:, None], cache["lengths"], active, cache)
        logits = new_logits[:, 0]
        toks.append(tok)
    return torch.stack(toks, dim=1), logits, cache


class InferenceEngine:
    def __init__(
        self,
        qparams,
        config: LlamaConfig,
        *,
        max_batch: int = 8,
        max_len: int = 2048,
        steps_per_sync: int = 8,
        top_k: int = 50,
        dtype=torch.bfloat16,
        seed: int = 0,
        device=None,
    ):
        """Single-device engine on ``device`` (``cuda`` unless
        ``device="cpu"``) over ``qparams`` from
        ``quantized.quantize_params`` (tensor-parallel serving is not
        ported yet)."""
        self.device = resolve_device(device)
        self.config = config
        self.max_batch = max_batch
        self.max_len = max_len
        self.steps_per_sync = steps_per_sync
        self.top_k = top_k
        self.dtype = dtype
        self.qparams = qparams
        if self.device.type == "cuda" and config.use_megakernel:
            from llm_qat_torch.inference import megakernel

            if megakernel.card_takes(config, max_batch, max_len, dtype):
                # the decode kernel's K-contiguous weights, made once, up front
                megakernel.card_weights(qparams)
        self.cache = M.init_serving_cache(config, max_batch, max_len, device=self.device)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: deque[Request] = deque()
        self._uid = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # held logits for the next sample, one row per slot
        self._logits = torch.zeros((max_batch, config.vocab_size),
                                   dtype=torch.float32, device=self.device)

    def _fwd(self, qparams, ids, lens, active, cache):
        return M.serving_forward(qparams, self.config, ids, lens, active, cache,
                                 dtype=self.dtype, device=self.device)

    def _prefill(self, qparams, ids):
        return M.prefill_slot(qparams, self.config, ids, dtype=self.dtype,
                              device=self.device)

    # ------------------------------------------------------------------ API

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        eos_id: Optional[int] = None,
    ) -> int:
        # the last cache row is scratch for inactive slots, so prompt +
        # generation must fit max_len - 1; reject rather than truncate
        if len(prompt) + max_new_tokens > self.max_len - 1:
            raise ValueError(
                f"request does not fit: len(prompt)={len(prompt)} + "
                f"max_new_tokens={max_new_tokens} > max_len-1="
                f"{self.max_len - 1}; shorten the prompt or raise max_len"
            )
        self._uid += 1
        self.queue.append(Request(
            uid=self._uid, prompt=list(prompt), max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_k=top_k if top_k is not None else self.top_k, eos_id=eos_id,
        ))
        return self._uid

    def run(self) -> List[Request]:
        """Drain queue and slots to completion; returns finished requests."""
        finished: List[Request] = []
        while self.queue or any(s is not None for s in self.slots):
            finished.extend(self.step())
        return finished

    # ----------------------------------------------------------- internals

    def _admit(self) -> None:
        """Fill free slots from the queue; admissions sharing a pow2 bucket
        prefill in one call (padded to a pow2 batch <= max_batch)."""
        free = [b for b, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return
        groups: Dict[int, list] = {}
        for slot in free:
            if not self.queue:
                break
            req = self.queue.popleft()
            bucket = min(_bucket(len(req.prompt)), self.max_len - 1)
            groups.setdefault(bucket, []).append((slot, req))

        lengths = self.cache["lengths"].cpu().numpy().copy()
        for bucket, items in groups.items():
            nb = min(_bucket(len(items), lo=1), self.max_batch)
            ids = np.zeros((nb, bucket), np.int64)
            for i, (_, req) in enumerate(items):
                ids[i, : len(req.prompt)] = req.prompt
            logits, rows = self._prefill(self.qparams, ids)
            for i, (slot, req) in enumerate(items):
                M.insert_slot(
                    self.cache,
                    {k: rows[k][:, i:i + 1] for k in ("k_q", "k_s", "v_q", "v_s")},
                    slot,
                )
                # the slot length is the real prompt (padding rows stay invalid)
                lengths[slot] = len(req.prompt)
                self._logits[slot] = logits[i, len(req.prompt) - 1]
                self.slots[slot] = req
        self.cache = dict(self.cache, lengths=torch.as_tensor(lengths, device=self.device))

    def step(self) -> List[Request]:
        """One engine iteration: admit, decode a chunk on device, retire."""
        self._admit()
        active_ids = [b for b, s in enumerate(self.slots) if s is not None]
        if not active_ids:
            return []
        budget = min(
            self.slots[b].max_new_tokens - len(self.slots[b].output)
            for b in active_ids
        )
        n_steps = max(1, min(self.steps_per_sync, budget))

        active = np.zeros((self.max_batch,), bool)
        active[active_ids] = True
        temps = np.zeros((self.max_batch,), np.float32)
        for b in active_ids:
            temps[b] = self.slots[b].temperature
        toks, self._logits, self.cache = _decode_chunk(
            self._fwd, self.qparams, self._logits,
            torch.as_tensor(temps, device=self.device),
            torch.as_tensor(active, device=self.device),
            self.cache, self._gen, n_steps, self.top_k,
            sample=bool((temps > 0).any()),
        )
        toks_np = toks.cpu().numpy()            # the chunk's one host sync
        lengths = self.cache["lengths"].cpu().numpy()

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
            if req.done or int(lengths[b]) >= self.max_len - 1:
                req.done = True
                finished.append(req)
                self.slots[b] = None
        return finished
