"""Zero-shot multiple-choice evaluation harness (the JAX package's
``eval/zero_shot.py``).

The reference publishes zero-shot accuracy on 8 common-sense tasks (boolq,
piqa, siqa, hellaswag, winogrande, arc_easy, arc_challenge, obqa;
README.md:45-54) but contains no harness — the numbers came from an external
lm-eval run (SURVEY.md §3.5). This module scores answer choices by their
loglikelihood under the (fake-)quantized model, with raw and
length-normalized accuracy (lm-eval's ``acc`` / ``acc_norm``).

Batching as in the JAX package: rows sorted by length, each batch of
``batch_rows`` right-padded to a power-of-two bucket from 32 (capped by
``max_len``), the padded tail of a short last batch left as rows of zeros.
The forward is ``llama.forward`` under the right-padded attention mask, so on
the card it takes the flash kernel with per-row lengths where the bucket
passes the flash gate. Per-row continuation log-probs are gathered with a
mask from the fp32 ``log_softmax`` on the device; only the per-row sums come
to the host. The task adapters are pure string code, copied.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from llm_qat_torch.models import llama
from llm_qat_torch.models.config import LlamaConfig


@dataclasses.dataclass
class MCExample:
    """One multiple-choice item.

    Two layouts:
    - shared context (``ctx_lens is None``): ``context`` holds the context
      token ids shared by all choices and each entry of ``choices`` is a
      continuation; the scored row is ``context + choice``.
    - per-choice context (``ctx_lens`` set — winogrande's lm-eval "partial
      evaluation" scheme, where the option lives in the *context*): each
      entry of ``choices`` is already the FULL row (context + continuation)
      and ``ctx_lens[i]`` is how many leading tokens are context; only the
      remaining suffix tokens are scored.
    """

    context: Sequence[int]
    choices: Sequence[Sequence[int]]
    gold: int
    ctx_lens: Optional[Sequence[int]] = None


def row_logprobs(params, config: LlamaConfig, ids: torch.Tensor, attn_mask: torch.Tensor,
                 tgt_mask: torch.Tensor, compute_dtype=torch.bfloat16):
    """Rows ``[b, s]``, padding mask ``[b, s]`` and target mask ``[b, s]`` ->
    per-row sum and count of the target tokens' log-probs (fp32 ``[b]``)."""
    with torch.no_grad():
        logits = llama.forward(params, config, ids, attention_mask=attn_mask,
                               dtype=compute_dtype)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        row = torch.gather(logp, -1, ids[:, 1:, None])[..., 0]
        m = tgt_mask[:, 1:].float()
        return (row * m).sum(dim=-1), m.sum(dim=-1)


def _pow2_bucket(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def score_examples(
    params,
    config: LlamaConfig,
    examples: Sequence[MCExample],
    *,
    batch_rows: int = 16,
    max_len: Optional[int] = None,
    compute_dtype=torch.bfloat16,
    return_scores: bool = False,
) -> Dict[str, float]:
    """Score every (context, choice) row, pick argmax per example, on the
    device the params lie on.

    Returns ``acc`` (raw loglikelihood argmax) and ``acc_norm``
    (per-token-length normalized, lm-eval convention); with
    ``return_scores`` also the per-example summed-logprob matrix (lm-eval's
    per-doc loglikelihoods).
    """
    rows: List[np.ndarray] = []
    row_meta: List[tuple] = []  # (example_idx, choice_idx, ctx_len)
    for ei, ex in enumerate(examples):
        for ci, cont in enumerate(ex.choices):
            if ex.ctx_lens is not None:
                ids = list(cont)  # cont is already the full row
                ctx_len = ex.ctx_lens[ci]
            else:
                ids = list(ex.context) + list(cont)
                ctx_len = len(ex.context)
            rows.append(np.asarray(ids, np.int64))
            row_meta.append((ei, ci, ctx_len))

    scores = np.full((len(examples), max(len(e.choices) for e in examples)), -np.inf)
    norm_scores = np.full_like(scores, -np.inf)
    dev = params["embed"].device

    # bucket rows by pow2 length so short rows don't pay the longest row's
    # compute
    order = sorted(range(len(rows)), key=lambda i: len(rows[i]))
    for start in range(0, len(order), batch_rows):
        idxs = order[start : start + batch_rows]
        longest = max(len(rows[i]) for i in idxs)
        blen = min(_pow2_bucket(longest), max_len) if max_len else _pow2_bucket(longest)
        ids = np.zeros((batch_rows, blen), np.int64)
        attn = np.zeros((batch_rows, blen), np.int32)
        tmask = np.zeros((batch_rows, blen), np.int32)
        for i, ri in enumerate(idxs):
            r = rows[ri]
            ctx_len = row_meta[ri][2]
            L = min(len(r), blen)
            ids[i, :L] = r[:L]
            attn[i, :L] = 1
            tmask[i, min(ctx_len, L) : L] = 1
        s, cnt = row_logprobs(params, config, torch.from_numpy(ids).to(dev),
                              torch.from_numpy(attn).to(dev), torch.from_numpy(tmask).to(dev),
                              compute_dtype)
        s, cnt = s.cpu().numpy(), cnt.cpu().numpy()
        for i, ri in enumerate(idxs):
            ei, ci, _ = row_meta[ri]
            scores[ei, ci] = s[i]
            norm_scores[ei, ci] = s[i] / max(cnt[i], 1)

    golds = np.asarray([e.gold for e in examples])
    acc = float(np.mean(np.argmax(scores, axis=-1) == golds))
    acc_norm = float(np.mean(np.argmax(norm_scores, axis=-1) == golds))
    out = {"acc": acc, "acc_norm": acc_norm, "n": len(examples)}
    if return_scores:
        out["scores"] = scores  # [n_examples, max_choices] summed logprobs
    return out


# ---------------------------------------------------------------------------
# Task adapters: raw task jsonl -> MCExample
# ---------------------------------------------------------------------------

Tokenize = Callable[[str], Sequence[int]]


def _mc(tokenize: Tokenize, ctx: str, choices: Sequence[str], gold: int) -> MCExample:
    # lm-eval convention: continuation carries the leading space; the
    # context is tokenized alone, the continuation tokens are the suffix of
    # tokenizing ctx+choice (robust to tokenizers merging at the boundary).
    ctx_ids = list(tokenize(ctx))
    conts = []
    for ch in choices:
        full = list(tokenize(ctx + ch))
        conts.append(full[len(ctx_ids):] if full[: len(ctx_ids)] == ctx_ids else tokenize(ch))
    return MCExample(ctx_ids, conts, gold)


def adapt_boolq(doc: dict, tokenize: Tokenize) -> MCExample:
    ctx = f"{doc['passage']}\nQuestion: {doc['question']}?\nAnswer:"
    return _mc(tokenize, ctx, [" no", " yes"], int(doc["answer"]))


def adapt_piqa(doc: dict, tokenize: Tokenize) -> MCExample:
    ctx = f"Question: {doc['goal']}\nAnswer:"
    return _mc(tokenize, ctx, [" " + doc["sol1"], " " + doc["sol2"]], int(doc["label"]))


def _hellaswag_preprocess(text: str) -> str:
    """lm-eval's hellaswag text cleanup (detokenizer artifacts in the
    source data): strip, '[title]' -> '. ', drop other bracketed tags,
    collapse double spaces."""
    text = text.strip()
    text = text.replace(" [title]", ". ")
    text = re.sub(r"\[.*?\]", "", text)
    text = text.replace("  ", " ")
    return text


def adapt_hellaswag(doc: dict, tokenize: Tokenize) -> MCExample:
    # lm-eval convention: context = "<activity_label>: <ctx_a> <Ctx_b...>"
    # (ctx_b capitalized), both context and endings run through the
    # preprocessor. Falls back to raw ``ctx`` when the split fields are
    # absent from the doc.
    if "ctx_a" in doc or "activity_label" in doc:
        ctx_b = doc.get("ctx_b", "")
        ctx = doc.get("ctx_a", doc.get("ctx", ""))
        if ctx_b:
            ctx = ctx + " " + ctx_b.capitalize()
        label = doc.get("activity_label", "")
        if label:
            ctx = label + ": " + ctx
    else:
        ctx = doc["ctx"]
    ctx = _hellaswag_preprocess(ctx)
    endings = [_hellaswag_preprocess(e) for e in doc["endings"]]
    return _mc(tokenize, ctx, [" " + e for e in endings], int(doc["label"]))


_ARC_NUM_TO_LETTER = {"1": "A", "2": "B", "3": "C", "4": "D", "5": "E"}


def adapt_arc(doc: dict, tokenize: Tokenize) -> MCExample:
    ctx = f"Question: {doc['question']}\nAnswer:"
    # lm-eval normalizes numeric answer keys ("1".."5") to letters
    key = _ARC_NUM_TO_LETTER.get(str(doc["answerKey"]), doc["answerKey"])
    labels = [_ARC_NUM_TO_LETTER.get(str(l), l) for l in doc["choices"]["label"]]
    texts = doc["choices"]["text"]
    gold = labels.index(key)
    return _mc(tokenize, ctx, [" " + t for t in texts], gold)


def adapt_winogrande(doc: dict, tokenize: Tokenize) -> MCExample:
    # lm-eval "partial evaluation" (the convention behind the published
    # table): context = sentence up to the blank with the option
    # substituted, continuation = everything after the blank. The option
    # lives in the CONTEXT, so the scored suffix tokens are identical
    # across choices and only the conditioning differs.
    idx = doc["sentence"].index("_")
    prefix = doc["sentence"][:idx]
    suffix = doc["sentence"][idx + 1 :]
    options = [doc["option1"], doc["option2"]]
    gold = int(doc["answer"]) - 1
    rows, ctx_lens = [], []
    for opt in options:
        ctx_ids = list(tokenize(prefix + opt))
        full = list(tokenize(prefix + opt + suffix))
        # tokenizer may merge at the option/suffix boundary; lm-eval slices
        # continuation tokens out of the whole-sentence tokenization, so
        # align by longest common prefix rather than retokenizing the
        # suffix standalone (which could differ across choices)
        lcp = 0
        for a, b in zip(full, ctx_ids):
            if a != b:
                break
            lcp += 1
        rows.append(full)
        ctx_lens.append(lcp)
    return MCExample([], rows, gold, ctx_lens=ctx_lens)


def adapt_siqa(doc: dict, tokenize: Tokenize) -> MCExample:
    # lm-eval social_iqa: "Question: <context> <question>\nAnswer:"
    ctx = f"Question: {doc['context']} {doc['question']}\nAnswer:"
    choices = [" " + doc["answerA"], " " + doc["answerB"], " " + doc["answerC"]]
    return _mc(tokenize, ctx, choices, int(doc["label"]) - 1)


def adapt_obqa(doc: dict, tokenize: Tokenize) -> MCExample:
    ctx = doc["question_stem"]
    labels = doc["choices"]["label"]
    texts = doc["choices"]["text"]
    gold = labels.index(doc["answerKey"])
    return _mc(tokenize, ctx, [" " + t for t in texts], gold)


TASK_ADAPTERS = {
    "boolq": adapt_boolq,
    "piqa": adapt_piqa,
    "siqa": adapt_siqa,
    "hellaswag": adapt_hellaswag,
    "winogrande": adapt_winogrande,
    "arc_easy": adapt_arc,
    "arc_challenge": adapt_arc,
    "obqa": adapt_obqa,
}


def evaluate_task(
    params,
    config: LlamaConfig,
    task: str,
    docs: Sequence[dict],
    tokenize: Tokenize,
    **kw,
) -> Dict[str, float]:
    adapter = TASK_ADAPTERS[task]
    examples = [adapter(d, tokenize) for d in docs]
    return score_examples(params, config, examples, **kw)


# ---------------------------------------------------------------------------
# Seeded task documents, for runs without the real task files
# ---------------------------------------------------------------------------

_WORDS = ("the a man woman dog cat river stone light water paper table window garden "
          "green quickly slowly open close carry build under over before after small "
          "large red old new bright heavy empty warm cold door road bread salt").split()


def random_docs(task: str, n: int, seed: int = 0, max_words: int = 40) -> List[dict]:
    """``n`` documents of ``task`` in its adapter's field layout, made of
    random words from ``seed`` (contexts of 3 to ``max_words`` words), for
    smoke runs and tests where the task's jsonl is absent. hellaswag docs
    carry the bracketed tags its preprocessor strips, arc docs numeric and
    letter keys, winogrande a blank in every sentence."""
    if task not in TASK_ADAPTERS:
        raise KeyError(f"unknown task {task!r}; tasks: {sorted(TASK_ADAPTERS)}")
    rng = np.random.default_rng([seed, sorted(TASK_ADAPTERS).index(task)])

    def text(lo=3, hi=max_words):
        return " ".join(rng.choice(_WORDS, int(rng.integers(lo, max(lo, hi) + 1))))

    def short():
        return text(1, 6)

    docs = []
    for _ in range(n):
        if task == "boolq":
            d = {"passage": text(), "question": short(), "answer": bool(rng.integers(2))}
        elif task == "piqa":
            d = {"goal": text(), "sol1": short(), "sol2": short(), "label": int(rng.integers(2))}
        elif task == "siqa":
            d = {"context": text(), "question": short(), "answerA": short(),
                 "answerB": short(), "answerC": short(), "label": str(rng.integers(1, 4))}
        elif task == "hellaswag":
            tag = ("[title] ", "[step] ", "")[int(rng.integers(3))]
            d = {"activity_label": short(), "ctx_a": text() + ".", "ctx_b": short(),
                 "endings": [tag + short() + "  " + short() for _ in range(4)],
                 "label": str(rng.integers(4))}
        elif task == "winogrande":
            d = {"sentence": text(2) + " _ " + text(1, 12), "option1": short(),
                 "option2": short(), "answer": str(rng.integers(1, 3))}
        elif task in ("arc_easy", "arc_challenge"):
            k = int(rng.integers(3, 6))
            labels = [str(i + 1) for i in range(k)] if rng.integers(2) else list("ABCDE"[:k])
            d = {"question": text(), "choices": {"label": labels,
                                                 "text": [short() for _ in range(k)]},
                 "answerKey": labels[int(rng.integers(k))]}
        else:  # obqa
            d = {"question_stem": text(), "choices": {"label": list("ABCD"),
                                                      "text": [short() for _ in range(4)]},
                 "answerKey": "ABCD"[int(rng.integers(4))]}
        docs.append(d)
    return docs
