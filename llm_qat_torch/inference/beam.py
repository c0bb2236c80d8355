"""Batched beam search over the quantized serving cache (the JAX package's
``inference/beam.py``).

Reference parity: the reference model carries HF ``generate`` beam-search
plumbing — ``prepare_inputs_for_generation`` builds the one-token step
inputs and ``_reorder_cache`` gathers past KV rows by ``beam_idx``
(modeling_llama_quant.py:909-954). All ``num_beams`` hypotheses decode as
one batch against the int8 (or nibble-packed int4) serving cache
(inference/model.py); the cache-row reorder is a batch-axis gather on the
device each step. The step loop is a Python loop (JAX: ``lax.scan``).

Conventions, the JAX package's:
  * candidate pool of ``2*num_beams`` per step so EOS absorptions never
    starve the live set (HF's rule);
  * a candidate ending in EOS moves to a fixed-size finished pool (kept as
    top-``num_beams`` by normalized score); the live set takes the best
    ``num_beams`` non-EOS candidates;
  * normalized score = sum of generated-token logprobs divided by
    ``gen_len ** length_penalty`` (gen_len counts generated tokens,
    EOS included);
  * no early-stopping heuristic: the loop always runs ``max_new_tokens``
    steps and the final answer is the best of (finished pool, live beams)
    by normalized score — equivalent to HF ``early_stopping=False`` run to
    the length budget.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values and
``torch.topk`` promises no order, so every top-k here is a stable
descending sort (``_top_k``). The JAX scan also runs the forward after the
last step, whose logits nothing reads; the loop here does not.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from llm_qat_torch.device import check_on, resolve_device
from llm_qat_torch.inference import model as M
from llm_qat_torch.models.config import LlamaConfig

NEG_INF = -1e30


def reorder_cache(cache: Dict[str, torch.Tensor],
                  beam_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Gather cache rows by beam index (the ``_reorder_cache`` analog,
    modeling_llama_quant.py:944-954). KV tensors are ``[L, b, ...]`` so the
    batch gather is on axis 1; ``lengths`` is ``[b]``. Every tensor returned
    is new (``index_select`` copies), so the serving step's in-place writes
    never reach the input cache, and two beams with one parent share no
    storage."""
    idx = beam_idx.to(device=cache["lengths"].device, dtype=torch.long)
    out = {k: cache[k].index_select(1, idx) for k in ("k_q", "k_s", "v_q", "v_s")}
    out["lengths"] = cache["lengths"].index_select(0, idx)
    return out


def _norm(scores: torch.Tensor, gen_len: torch.Tensor, length_penalty: float) -> torch.Tensor:
    return scores / gen_len.float().clamp(min=1.0) ** length_penalty


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` on a 1-D tensor: the k largest, ties in index
    order."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _beam_loop(fwd, qparams, logits0, cache, num_beams: int, max_new_tokens: int,
               eos_id: Optional[int], length_penalty: float):
    """The JAX package's ``_beam_scan`` body, step by step: returns the
    (tokens ``[B, T]``, normalized scores ``[B]``, lengths ``[B]``) of the
    ``num_beams`` best hypotheses, best first."""
    B, T, V = num_beams, max_new_tokens, logits0.shape[-1]
    dev = logits0.device
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    logits = logits0.expand(B, V)
    # only beam 0 is live at step 0 (all rows hold the same prompt)
    beam_scores = torch.where(torch.arange(B, device=dev) == 0,
                              torch.zeros((), device=dev), torch.full((), NEG_INF, device=dev))
    tokens = torch.zeros((B, T), dtype=torch.int32, device=dev)
    fin_scores = torch.full((B,), NEG_INF, device=dev)
    fin_tokens = torch.zeros((B, T), dtype=torch.int32, device=dev)
    fin_lens = torch.zeros((B,), dtype=torch.int32, device=dev)
    for step in range(T):
        logp = torch.log_softmax(logits.float(), dim=-1)
        cand = beam_scores[:, None] + logp                     # [B, V]
        scores2, idx2 = _top_k(cand.reshape(-1), 2 * B)
        beam_idx = idx2 // V
        tok_idx = (idx2 % V).to(torch.int32)
        gen_len = step + 1

        # candidate token rows (EOS included when it is the chosen token)
        cand_tokens = tokens.index_select(0, beam_idx)
        cand_tokens[:, step] = tok_idx

        if eos_id is not None:
            is_eos = tok_idx == eos_id
            # merge EOS candidates into the finished pool, keep top B
            lens2 = torch.full((2 * B,), gen_len, dtype=torch.int32, device=dev)
            pool_scores = torch.cat([
                fin_scores,
                torch.where(is_eos, _norm(scores2, lens2, length_penalty),
                            torch.full_like(scores2, NEG_INF))])
            pool_tokens = torch.cat([fin_tokens, cand_tokens])
            pool_lens = torch.cat([fin_lens, lens2])
            fin_scores, top_i = _top_k(pool_scores, B)
            fin_tokens = pool_tokens.index_select(0, top_i)
            fin_lens = pool_lens.index_select(0, top_i)
            cont = torch.where(is_eos, torch.full_like(scores2, NEG_INF), scores2)
        else:
            cont = scores2

        # live set: best B non-EOS candidates
        beam_scores, live_pos = _top_k(cont, B)
        live_beam = beam_idx.index_select(0, live_pos)
        live_tok = tok_idx.index_select(0, live_pos)
        tokens = cand_tokens.index_select(0, live_pos)
        if step + 1 < T:
            cache = reorder_cache(cache, live_beam)
            new_logits, cache = fwd(qparams, live_tok[:, None], cache["lengths"], active, cache)
            logits = new_logits[:, 0]

    # final answer: best of finished pool vs live beams (normalized)
    live_norm = _norm(beam_scores, torch.full((B,), T, device=dev), length_penalty)
    all_scores = torch.cat([fin_scores, live_norm])
    all_tokens = torch.cat([fin_tokens, tokens])
    all_lens = torch.cat([fin_lens, torch.full((B,), T, dtype=torch.int32, device=dev)])
    order = torch.argsort(-all_scores, stable=True)[:B]
    return all_tokens[order], all_scores[order], all_lens[order]


def beam_generate(
    qparams: Dict[str, Any],
    config: LlamaConfig,
    prompt,
    *,
    num_beams: int = 4,
    max_new_tokens: int = 32,
    eos_id: Optional[int] = None,
    length_penalty: float = 1.0,
    dtype=torch.bfloat16,
    fwd=None,
    prefill=None,
    device=None,
) -> Tuple[np.ndarray, float]:
    """Beam-decode one prompt on ``device`` (``cuda`` unless ``device="cpu"``;
    the params must lie there); returns (tokens, normalized score) of the
    best hypothesis (tokens truncated at EOS when hit).

    ``fwd(qparams, ids [B, 1], lens [B], active [B], cache) -> (logits
    [B, 1, V], cache)`` defaults to the single-device ``serving_forward`` and
    ``prefill(qparams, ids [1, s]) -> (logits, rows)`` to ``prefill_slot``.
    The tensor-parallel pair (``sharded.make_tp_forward``,
    ``sharded.make_tp_prefill``, over this rank's ``shard_qparams``) runs the
    same search on every rank of the group: the beams' cache holds the heads
    the prefill's rows hold.
    """
    dev = resolve_device(device)
    check_on(dev, embed=qparams["embed"])
    prompt = list(prompt)
    plen = len(prompt)
    if fwd is None:
        def fwd(qp, ids, lens, active, cache):
            return M.serving_forward(qp, config, ids, lens, active, cache, dtype=dtype,
                                     device=dev)

    # prefill once (batch-1) with the prompt padded to a pow2 bucket
    # (engine convention), then broadcast rows to all beams
    bucket = 16
    while bucket < plen:
        bucket *= 2
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :plen] = prompt
    if prefill is None:
        def prefill(qp, ids):
            return M.prefill_slot(qp, config, ids, dtype=dtype, device=dev)
    logits, rows = prefill(qparams, ids)
    max_len = 64
    while max_len < max(bucket, plen + max_new_tokens + 1):
        max_len *= 2
    cache = M.init_serving_cache(config, num_beams, max_len, device=dev,
                                 kv_heads=rows["k_q"].shape[2])
    for k in ("k_q", "k_s", "v_q", "v_s"):
        cache[k][:, :, ..., :bucket] = rows[k]        # rows' batch of 1 broadcasts
    cache["lengths"] = torch.full((num_beams,), plen, dtype=torch.int32, device=dev)

    toks, scores, lens = _beam_loop(fwd, qparams, logits[0, plen - 1], cache, num_beams,
                                    max_new_tokens, eos_id, length_penalty)
    best = toks[0].cpu().numpy()[: int(lens[0])]
    return best, float(scores[0])
