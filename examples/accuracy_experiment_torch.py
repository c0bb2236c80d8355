#!/usr/bin/env python
"""Controlled KD-QAT accuracy experiment at feasible (tiny) scale, through
the PyTorch port (``llm_qat_torch``): ``accuracy_experiment.py``'s stages,
flags, cached artifacts and ``results.json`` shape, on the card by default
or on the CPU with ``--device cpu``.

    fp teacher        : trained on real text, full precision
    PTQ  W4A8KV4      : teacher weights evaluated under fake-quant, no training
    QAT  W4A8KV4      : KD-distilled from the teacher on synthesized data only

Metrics: held-out byte-level perplexity, and two two-choice continuation
tasks scored by the zero-shot harness (``eval/zero_shot.py``): ``mc_far``
(real 32-byte continuation against a span of another held-out document) and
``mc_margin`` (a one-word swap, the candidates the fp teacher gets right by
the smallest margin).

The corpus is the prose of the installed packages' documentation and
docstrings, so it depends on the host: results name it. On the card the
experiment's model (hidden 256, 8 query and 4 kv heads: head dim 32, two
query heads a kv head, bf16) trains and evaluates through the flash kernels
at head dim 32 and the RMSNorm+quant kernel at hidden 256. With no card and
no ``--device cpu`` it stops: it does not fall back to the CPU.

Every stage caches its artifact in the workdir, so a killed run resumes
when it is started again on the same workdir. Without one, each run takes a
fresh directory under the temporary directory (``TMPDIR``) and reuses
nothing.
``results.json`` adds ``timing`` (seconds by stage, train steps a second)
and the device's name to the JAX script's keys; ``accuracy_table.py`` reads
it unchanged.

Usage:
    python examples/accuracy_experiment_torch.py [workdir] [--seed N] [--small]
        [--device cpu] [--sweep] [--teacher_steps N] [--qat_steps N]
"""

import argparse
import ast
import glob
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llm_qat_torch.data import synthesis as S
from llm_qat_torch.data.dataset import ByteTokenizer, BlockDataset, pack_blocks, read_jsonl_texts
from llm_qat_torch.device import resolve_device
from llm_qat_torch.eval import zero_shot as Z
from llm_qat_torch.eval.perplexity import evaluate_perplexity
from llm_qat_torch.models import convert
from llm_qat_torch.models import params as P
from llm_qat_torch.models.config import LlamaConfig
from llm_qat_torch.training import trainer as T

TOK = ByteTokenizer()


# --------------------------------------------------------------------- corpus


def _prose_score(line: str) -> float:
    """Fraction of characters that look like English prose."""
    if not line:
        return 0.0
    good = sum(c.isalpha() or c in " .,;:'\"-()" for c in line)
    return good / len(line)


def build_corpus(workdir: str, min_doc: int = 400, max_mb: float = 8.0):
    """Harvest real English prose from installed package docs (rst/md/txt
    under site-packages, then the docstrings of its python sources) into
    train/holdout jsonl, stopping past ``max_mb`` MB. Deterministic file
    order + split."""
    train_p = os.path.join(workdir, "corpus.train.jsonl")
    hold_p = os.path.join(workdir, "corpus.holdout.jsonl")
    if os.path.exists(train_p) and os.path.exists(hold_p):
        return train_p, hold_p
    site = os.path.dirname(os.path.dirname(np.__file__))
    files = []
    for pat in ("**/*.rst", "**/*.md", "**/*.txt"):
        files.extend(glob.glob(os.path.join(site, pat), recursive=True))
    files.sort()

    def doc_sources():
        for f in files:
            try:
                yield open(f, encoding="utf-8", errors="ignore").read()
            except OSError:
                continue
        # docstrings from installed python sources: the biggest pool of
        # real English prose available offline
        py_files = sorted(glob.glob(os.path.join(site, "**/*.py"), recursive=True))
        for f in py_files:
            try:
                tree = ast.parse(open(f, encoding="utf-8", errors="ignore").read())
            except (OSError, SyntaxError, ValueError):
                continue
            parts = []
            for node in ast.walk(tree):
                if isinstance(
                    node,
                    (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef),
                ):
                    d = ast.get_docstring(node)
                    if d and len(d) > 120:
                        parts.append(d)
            if parts:
                yield "\n\n".join(parts)

    docs, total = [], 0
    for raw in doc_sources():
        if total > max_mb * 1e6:
            break
        # keep prose-looking paragraphs, drop tables/code/license boilerplate
        paras = [re.sub(r"\s+", " ", p).strip() for p in raw.split("\n\n")]
        text = " ".join(p for p in paras if len(p) > 60 and _prose_score(p) > 0.8)
        if len(text) >= min_doc and all(ord(c) < 128 for c in text[:1000]):
            docs.append(text[:20000])
            total += min(len(text), 20000)
    rng = np.random.default_rng(0)
    rng.shuffle(docs)
    n_hold = max(20, len(docs) // 20)
    with open(hold_p, "w") as f:
        for d in docs[:n_hold]:
            f.write(json.dumps({"text": d}) + "\n")
    with open(train_p, "w") as f:
        for d in docs[n_hold:]:
            f.write(json.dumps({"text": d}) + "\n")
    print(f"[corpus] {len(docs)} docs, {total/1e6:.1f} MB "
          f"({n_hold} held out)", flush=True)
    return train_p, hold_p


# --------------------------------------------------------------------- stages


def _run_steps(tr, ds, batch, steps, label, what, log_every):
    """``steps`` train steps over ``ds``'s shuffled batches (a new order each
    pass); returns the trained params."""
    step = 0
    t0 = time.time()
    while step < steps:
        for b in ds.batches(batch, shuffle=True, seed=step):
            m = tr.train_step(b)
            step += 1
            if log_every and step % log_every == 0:
                print(f"[{label}] step {step}/{steps} "
                      f"{what} {float(m['loss']):.4f} "
                      f"({(time.time()-t0)/step:.3f}s/step)", flush=True)
            if step >= steps:
                break
    return tr.state.params


def train_lm(params, cfg, tcfg, ds, batch, steps, label, log_every=100):
    tr = T.Trainer(cfg, tcfg, params, device=params["embed"].device)
    return _run_steps(tr, ds, batch, steps, label, "loss", log_every)


def kd_train(student, s_cfg, teacher, t_cfg, tcfg, ds, batch, steps,
             label, log_every=100):
    tr = T.Trainer(s_cfg, tcfg, student, teacher, teacher_cfg=t_cfg,
                   device=student["embed"].device)
    return _run_steps(tr, ds, batch, steps, label, "kd_loss", log_every)


def _two_choice(ctx, gold, distract, rng):
    ctx_ids = TOK.encode(ctx)
    choices = [
        TOK.encode(ctx + gold)[len(ctx_ids):],
        TOK.encode(ctx + distract)[len(ctx_ids):],
    ]
    order = int(rng.integers(0, 2))
    if order:
        choices = choices[::-1]
    return Z.MCExample(ctx_ids, choices, gold=order ^ 0)


def make_mc_examples(holdout_texts, n, ctx_len=64, cont_len=32, seed=0):
    """Far two-choice continuation task: gold = the doc's real next bytes,
    distractor = a span from a *different* held-out doc."""
    rng = np.random.default_rng(seed)
    exs = []
    docs = [t for t in holdout_texts if len(t) > ctx_len + cont_len + 1]
    for i in range(n):
        di = int(rng.integers(0, len(docs)))
        doc = docs[di]
        start = int(rng.integers(0, len(doc) - ctx_len - cont_len))
        ctx = doc[start : start + ctx_len]
        gold = doc[start + ctx_len : start + ctx_len + cont_len]
        dj = int(rng.integers(0, len(docs) - 1))
        dj = dj + 1 if dj >= di else dj
        other = docs[dj]
        ds_ = int(rng.integers(0, len(other) - cont_len))
        distract = other[ds_ : ds_ + cont_len]
        exs.append(_two_choice(ctx, gold, distract, rng))
    return exs


def make_word_swap_candidates(holdout_texts, n, ctx_len=64, cont_len=32,
                              seed=0):
    """Candidate pool for the quantization-sensitive task: distractor = the
    gold continuation with ONE interior word replaced by a same-length real
    word from the held-out corpus. Same length keeps raw loglikelihoods
    comparable; a single plausible word keeps the gold/distractor margin
    small enough that logit noise can flip it."""
    rng = np.random.default_rng(seed)
    docs = [t for t in holdout_texts if len(t) > ctx_len + cont_len + 1]
    by_len = {}
    for t in docs[:400]:
        for w in re.findall(r"[A-Za-z]{3,10}", t):
            by_len.setdefault(len(w), []).append(w)
    by_len = {L: list(dict.fromkeys(ws)) for L, ws in by_len.items()}

    exs = []
    while len(exs) < n:
        di = int(rng.integers(0, len(docs)))
        doc = docs[di]
        start = int(rng.integers(0, len(doc) - ctx_len - cont_len))
        ctx = doc[start : start + ctx_len]
        gold = doc[start + ctx_len : start + ctx_len + cont_len]
        # words fully inside the continuation, not touching its edges
        words = [
            m for m in re.finditer(r"[A-Za-z]{3,10}", gold)
            if m.start() > 0 and m.end() < len(gold)
        ]
        if not words:
            continue
        m = words[int(rng.integers(0, len(words)))]
        pool = by_len.get(len(m.group()), ())
        if len(pool) < 2:
            continue
        repl = pool[int(rng.integers(0, len(pool)))]
        if repl.lower() == m.group().lower():
            continue
        distract = gold[: m.start()] + repl + gold[m.end():]
        exs.append(_two_choice(ctx, gold, distract, rng))
    return exs


def filter_by_teacher_margin(teacher, cfg, candidates, n, dtype):
    """Adversarial filtering (HellaSwag-style, against the fp teacher only,
    so the subset is fixed and identical for every system): keep the ``n``
    candidates the teacher gets RIGHT by the smallest loglikelihood margin.
    On these near-boundary items quantization logit noise flips decisions,
    so accuracy retention separates fp / PTQ / QAT."""
    sc = Z.score_examples(
        teacher, cfg, candidates, batch_rows=16, compute_dtype=dtype,
        return_scores=True,
    )["scores"]
    golds = np.asarray([e.gold for e in candidates])
    margin = sc[np.arange(len(candidates)), golds] - sc[
        np.arange(len(candidates)), 1 - golds
    ]
    correct = np.nonzero(margin > 0)[0]
    keep = correct[np.argsort(margin[correct])[:n]]
    print(f"[filter] {len(candidates)} candidates, teacher correct on "
          f"{len(correct)}, kept {len(keep)} smallest-margin "
          f"(max kept margin {margin[keep].max():.2f} nats)", flush=True)
    return [candidates[i] for i in keep]


def evaluate_model(params, cfg, hold_blocks, mc_tasks, batch, dtype):
    ds = BlockDataset(hold_blocks)
    ppl = evaluate_perplexity(
        params, cfg, ds.batches(batch), compute_dtype=dtype
    )
    out = {
        "ppl": round(ppl["perplexity"], 4),
        "eval_loss": round(ppl["eval_loss"], 5),
    }
    for name, exs in mc_tasks.items():
        mc = Z.score_examples(
            params, cfg, exs, batch_rows=16, compute_dtype=dtype
        )
        out[f"{name}_acc"] = round(mc["acc"], 4)
        out[f"{name}_n"] = mc["n"]
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir", nargs="?", default=None,
                    help="artifacts and results.json; resumes what it finds there "
                    "(default: a fresh temporary directory)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true", help="CPU smoke scale")
    ap.add_argument("--teacher_steps", type=int, default=None)
    ap.add_argument("--qat_steps", type=int, default=None)
    ap.add_argument("--w_bits", type=int, default=4)
    ap.add_argument("--a_bits", type=int, default=8)
    ap.add_argument("--kv_bits", type=int, default=4)
    ap.add_argument(
        "--sweep", action="store_true",
        help="run the reference table's axes: W8A8KV8, W4A8KV8, W4A8KV4, W4A6KV16, "
        "W2A8KV8, W1A8KV8, teacher/corpus/synthesis shared across configs",
    )
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--corpus_mb", type=float, default=8.0,
                    help="stop harvesting the corpus past this many MB")
    return ap.parse_args(argv)


def model_config(small: bool) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=TOK.vocab_size,
        hidden_size=64 if small else 256,
        intermediate_size=128 if small else 768,
        num_hidden_layers=2 if small else 4,
        num_attention_heads=4 if small else 8,
        num_key_value_heads=2 if small else 4,
        max_position_embeddings=256,
    )


def main(argv=None, stage_hook=None, n_mc=None, synth_per_shard=None, synth_rounds=None):
    """Run the experiment as the flags say; returns the results dict.
    ``stage_hook(name)`` is called after each stage (corpus, teacher,
    synthesis, eval_fp, then ptq_<bits> and qat_<bits> of each config).
    ``n_mc`` (examples a task), ``synth_per_shard`` (start tokens a synthesis
    shard) and ``synth_rounds`` override the scale's sizes (64 / 32 / 1
    small, 1024 / 128 / 3 full), for a short run at the full model's shape."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.workdir is None:
        args.workdir = tempfile.mkdtemp(prefix="llm_qat_accuracy_torch_")
    os.makedirs(args.workdir, exist_ok=True)
    print(f"[workdir] {args.workdir}", flush=True)
    hook = stage_hook or (lambda name: None)
    timing = {}
    lap = [time.perf_counter()]

    def stage(name):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        timing[f"{name}_s"] = round(now - lap[0], 3)
        lap[0] = now
        hook(name)

    small = args.small
    cfg = model_config(small)
    seq = 128 if small else 256
    batch = 8 if small else 32
    teacher_steps = args.teacher_steps or (30 if small else 3000)
    qat_steps = args.qat_steps or (20 if small else 4000)
    dtype = torch.float32 if small else torch.bfloat16

    bit_configs = (
        [(8, 8, 8), (4, 8, 8), (4, 8, 4), (4, 6, 16), (2, 8, 8), (1, 8, 8)]
        if args.sweep
        else [(args.w_bits, args.a_bits, args.kv_bits)]
    )
    results = {
        "config": {
            "bit_configs": [f"W{w}A{a}KV{kv}" for w, a, kv in bit_configs],
            "seed": args.seed, "seq": seq, "batch": batch,
            "teacher_steps": teacher_steps, "qat_steps": qat_steps,
            "model": {
                "hidden": cfg.hidden_size, "layers": cfg.num_hidden_layers,
                "heads": cfg.num_attention_heads, "kv_heads": cfg.num_key_value_heads,
                "vocab": cfg.vocab_size,
            },
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "framework": f"torch {torch.__version__}",
        }
    }

    # 1. corpus -------------------------------------------------------------
    train_p, hold_p = build_corpus(args.workdir, max_mb=args.corpus_mb)
    train_texts = read_jsonl_texts(train_p)
    hold_texts = read_jsonl_texts(hold_p)
    train_ds = BlockDataset(pack_blocks(train_texts, TOK.encode, seq))
    hold_blocks = pack_blocks(hold_texts, TOK.encode, seq)
    if small:
        train_ds = BlockDataset(train_ds.blocks[:64])
        hold_blocks = hold_blocks[:16]
    print(f"[corpus] train blocks {len(train_ds)}, holdout {len(hold_blocks)}",
          flush=True)
    stage("corpus")

    # 2. fp teacher ----------------------------------------------------------
    teacher_dir = os.path.join(args.workdir, "teacher")
    if os.path.exists(os.path.join(teacher_dir, "config.json")):
        _, teacher = convert.load_hf_checkpoint(teacher_dir, dtype=torch.float32, device=dev)
        print("[teacher] loaded cached checkpoint", flush=True)
    else:
        tcfg = T.TrainConfig(
            learning_rate=1e-3, total_steps=teacher_steps,
            warmup_steps=min(100, teacher_steps // 10),
            use_kd=False, remat=False, compute_dtype=dtype,
        )
        teacher = P.init_params(cfg, seed=args.seed, device=dev, dtype=torch.float32)
        t0 = time.perf_counter()
        teacher = train_lm(teacher, cfg, tcfg, train_ds, batch, teacher_steps, "teacher")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        timing["teacher_steps_per_s"] = round(teacher_steps / (time.perf_counter() - t0), 3)
        convert.save_hf_checkpoint(teacher, cfg, teacher_dir)
    stage("teacher")

    # 3. data-free synthesis (reference pipeline: generate_data.py) ----------
    # Shards cover start-token ranges; the byte vocab caps shards*per_shard at
    # 256, so extra volume comes from additional sampling rounds with
    # distinct seeds (greedy prefixes repeat, sampled continuations differ).
    gen_root = os.path.join(args.workdir, "gen_data")
    n_shards = 1 if small else 2
    per_shard = synth_per_shard or (32 if small else 128)
    n_rounds = synth_rounds or (1 if small else 3)
    syn_texts = []
    for rnd in range(n_rounds):
        gen_dir = gen_root if rnd == 0 else f"{gen_root}_r{rnd}"
        for shard in range(n_shards):
            S.synthesize_shard(
                teacher, cfg, shard, gen_dir,
                detokenize=TOK.decode,
                n_vocab_per_shard=per_shard,
                batch_size=16 if small else 64,
                total_len=64 if small else 256,
                top_k=50, seed=args.seed + rnd, dtype=dtype,
                log_every=200,
            )
        merged = S.merge_shards(gen_dir)
        syn_texts.extend(read_jsonl_texts(merged))
    syn_ds = BlockDataset(pack_blocks(syn_texts, TOK.encode, seq))
    print(f"[synthesis] {len(syn_texts)} docs -> {len(syn_ds)} blocks", flush=True)
    stage("synthesis")

    # 4. the tasks and the fp teacher's scores --------------------------------
    n_mc = n_mc or (64 if small else 1024)
    cand = make_word_swap_candidates(
        hold_texts, 4 * n_mc if small else 8 * n_mc, seed=args.seed + 1
    )
    mc_tasks = {
        "mc_far": make_mc_examples(hold_texts, n_mc, seed=args.seed),
        "mc_margin": filter_by_teacher_margin(teacher, cfg, cand, n_mc, dtype),
    }
    results["fp_teacher"] = evaluate_model(
        teacher, cfg, hold_blocks, mc_tasks, batch, dtype
    )
    print("[eval] fp teacher:", results["fp_teacher"], flush=True)
    stage("eval_fp")

    out = os.path.join(args.workdir, "results.json")
    # merge any configs a previous (killed) sweep already finished
    if os.path.exists(out):
        try:
            with open(out) as f:
                results.setdefault("configs", {}).update(
                    json.load(f).get("configs", {})
                )
        except (json.JSONDecodeError, OSError):
            pass
    results.setdefault("configs", {})

    # 5. per bit-config: PTQ baseline, then KD-QAT student (pure-KL KD on
    # synthesized data); teacher/corpus/synthesis shared across the sweep,
    # results written incrementally
    for w_bits, a_bits, kv_bits in bit_configs:
        bits = f"W{w_bits}A{a_bits}KV{kv_bits}"
        qcfg = cfg.replace(w_bits=w_bits, a_bits=a_bits, kv_bits=kv_bits)
        entry = results["configs"].get(bits, {})
        if "ptq" not in entry:
            entry["ptq"] = evaluate_model(
                teacher, qcfg, hold_blocks, mc_tasks, batch, dtype
            )
        print(f"[eval] PTQ {bits}:", entry["ptq"], flush=True)
        stage(f"ptq_{bits.lower()}")

        student_dir = os.path.join(args.workdir, f"student_{bits.lower()}")
        if os.path.exists(os.path.join(student_dir, "config.json")):
            _, student = convert.load_hf_checkpoint(
                student_dir, dtype=torch.float32, device=dev
            )
            print(f"[qat {bits}] loaded cached student", flush=True)
        else:
            ktcfg = T.TrainConfig(
                learning_rate=1e-4, total_steps=qat_steps, warmup_steps=0,
                use_kd=True, kd_loss_scale=1.0, remat=False,
                compute_dtype=dtype,
            )
            t0 = time.perf_counter()
            student = kd_train(
                teacher, qcfg, teacher, cfg, ktcfg, syn_ds, batch, qat_steps,
                f"qat {bits}",
            )
            if dev.type == "cuda":
                torch.cuda.synchronize()
            timing[f"qat_{bits.lower()}_steps_per_s"] = round(
                qat_steps / (time.perf_counter() - t0), 3)
            convert.save_hf_checkpoint(student, qcfg, student_dir)
        if "qat" not in entry:
            entry["qat"] = evaluate_model(
                student, qcfg, hold_blocks, mc_tasks, batch, dtype
            )
        print(f"[eval] QAT {bits}:", entry["qat"], flush=True)
        results["configs"][bits] = entry
        stage(f"qat_{bits.lower()}")

        # incremental write: a killed sweep keeps finished configs
        results["timing"] = timing
        with open(out, "w") as f:
            json.dump(results, f, indent=2)

    # back-compat single-config keys (the JAX script's artifact shape)
    first = f"W{bit_configs[0][0]}A{bit_configs[0][1]}KV{bit_configs[0][2]}"
    results["ptq"] = results["configs"][first]["ptq"]
    results["qat"] = results["configs"][first]["qat"]
    results["timing"] = timing
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results), flush=True)

    for bits, entry in results["configs"].items():
        ok = (
            entry["qat"]["ppl"] < entry["ptq"]["ppl"]
            and entry["qat"]["mc_margin_acc"] >= entry["ptq"]["mc_margin_acc"]
        )
        print(f"[done] {bits}: QAT beats PTQ: {ok}", flush=True)
    print(f"[done] results -> {out}", flush=True)
    return results


if __name__ == "__main__":
    main()
