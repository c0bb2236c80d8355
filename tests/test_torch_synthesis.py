"""Port parity: the cached decode path (llm_qat_torch.models.llama
init_cache / forward_with_cache) and data-free synthesis
(llm_qat_torch.data.synthesis, cli.generate_data) against the JAX package,
on the CPU from the same numpy weights.

forward_with_cache: logits at 1e-4 (rtol and atol) over a 6-token prefill
and 4 decode steps, for the fp model and a W4A8KV4 one (b*s <= 12 rows a
call), and the cache contents at 1e-5. generate_batch: the token stream
equal to JAX's, sampled positions included, with the Gumbel noise drawn in
the test by ``jax.random.gumbel`` from the keys JAX's ``generate_batch``
splits (``jax.random.categorical`` is ``argmax(logits + gumbel)``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.data import synthesis as JS
from llm_qat_tpu.models import convert as JC
from llm_qat_tpu.models import llama as JL
from llm_qat_tpu.models.config import LlamaConfig as JConfig
from llm_qat_torch.cli import generate_data as TG
from llm_qat_torch.data import synthesis as TS
from llm_qat_torch.models import llama as TL
from llm_qat_torch.models import params as TP

from tests.test_torch_serving import np_params, tcfg

TINY = JConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
WIDE_Q = TINY.replace(hidden_size=128, intermediate_size=256, w_bits=4, a_bits=8, kv_bits=4)
CONFIGS = {"fp": TINY, "w4a8kv4": WIDE_Q}
TOL = dict(rtol=1e-4, atol=1e-4)


def _tree(fn, node):
    return {k: _tree(fn, v) for k, v in node.items()} if isinstance(node, dict) else fn(node)


def _both(cfg, seed=0):
    p = np_params(cfg, seed)
    return _tree(jnp.asarray, p), TP.from_numpy(p, "cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_with_cache_matches_jax(name):
    cfg = CONFIGS[name]
    jp, tp = _both(cfg)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jc = JL.init_cache(cfg, 2, 16)
    tc = TL.init_cache(tcfg(cfg), 2, 16, device="cpu")
    assert tc["k"].shape == jc["k"].shape and tc["index"] == 0
    chunks = [(0, 6)] + [(t, t + 1) for t in range(6, 10)]
    for a, b in chunks:
        jl, jc = JL.forward_with_cache(jp, cfg, jnp.asarray(ids[:, a:b]), jc)
        tl, tc = TL.forward_with_cache(tp, tcfg(cfg), torch.from_numpy(ids[:, a:b]), tc)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"{a}:{b}")
        assert tc["index"] == int(jc["index"]) == b
        for kv in ("k", "v"):
            np.testing.assert_allclose(tc[kv].numpy(), np.asarray(jc[kv]), rtol=1e-5, atol=1e-5)


def test_cached_decode_matches_full_forward():
    """Prefill + token-by-token decode reproduce the full-sequence forward
    (``tests/test_model.py::test_cached_decode_matches_full_forward``'s
    limits, 2e-4)."""
    cfg = tcfg(WIDE_Q.replace(use_flash_attention=False))
    _, tp = _both(WIDE_Q, seed=3)
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 10)))
    full = TL.forward(tp, cfg, ids)
    cache = TL.init_cache(cfg, batch=2, max_len=16, device="cpu")
    logits_p, cache = TL.forward_with_cache(tp, cfg, ids[:, :6], cache)
    np.testing.assert_allclose(full[:, :6].numpy(), logits_p.numpy(), rtol=2e-4, atol=2e-4)
    for t in range(6, 10):
        step, cache = TL.forward_with_cache(tp, cfg, ids[:, t:t + 1], cache)
        np.testing.assert_allclose(full[:, t].numpy(), step[:, 0].numpy(), rtol=2e-4, atol=2e-4)


def test_cache_write_past_the_end_clamps_as_jax_does():
    """A start past ``max_len - s`` writes the last ``s`` rows, as
    ``dynamic_update_slice`` clamps it."""
    jp, tp = _both(TINY, seed=4)
    ids = np.random.default_rng(2).integers(0, 256, (1, 3)).astype(np.int32)
    jc = dict(JL.init_cache(TINY, 1, 4), index=jnp.asarray(3, jnp.int32))
    tc = dict(TL.init_cache(tcfg(TINY), 1, 4, device="cpu"), index=3)
    jl, jc = JL.forward_with_cache(jp, TINY, jnp.asarray(ids), jc)
    tl, tc = TL.forward_with_cache(tp, tcfg(TINY), torch.from_numpy(ids), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=1e-5, atol=1e-5)


def _jax_noise(key, steps, B, V):
    """The Gumbel noise JAX's ``generate_batch`` draws: one ``split`` a step,
    ``categorical`` on the second key."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, (B, V), jnp.float32)))
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize("greedy_len,top_k", [(3, 50), (4, 8), (1, 0)])
def test_generate_batch_stream_equals_jax(greedy_len, top_k):
    jp, tp = _both(TINY, seed=5)
    starts = np.asarray([5, 9, 200], np.int32)
    total, key = 12, jax.random.PRNGKey(11)
    want = np.asarray(JS.generate_batch(jp, TINY, jnp.asarray(starts), key,
                                        greedy_len=greedy_len, total_len=total, top_k=top_k,
                                        dtype=jnp.float32))
    noise = _jax_noise(key, total - 1, 3, TINY.vocab_size)
    got = TS.generate_batch(tp, tcfg(TINY), torch.from_numpy(starts), greedy_len=greedy_len,
                            total_len=total, top_k=top_k, dtype=torch.float32, noise=noise)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the sampled positions are samples: the noise moves them off greedy
    greedy = TS.generate_batch(tp, tcfg(TINY), torch.from_numpy(starts), greedy_len=total,
                               total_len=total, dtype=torch.float32,
                               noise=torch.zeros_like(noise))
    assert not np.array_equal(greedy.numpy()[:, greedy_len:], want[:, greedy_len:])
    np.testing.assert_array_equal(greedy.numpy()[:, :greedy_len], want[:, :greedy_len])


def test_generate_batch_from_a_generator_is_deterministic():
    _, tp = _both(TINY, seed=5)
    starts = torch.tensor([3, 4])
    runs = [TS.generate_batch(tp, tcfg(TINY), starts, torch.Generator().manual_seed(s),
                              total_len=10, dtype=torch.float32) for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert torch.equal(runs[0][:, :3], runs[2][:, :3])        # greedy prefix


def test_eos_truncation():
    row = np.asarray([5, 1, 2, 9, 2, 4])
    for eos in (2, 99, None):
        np.testing.assert_array_equal(TS._truncate_at_eos(row, eos),
                                      JS._truncate_at_eos(row, eos))
    np.testing.assert_array_equal(TS._truncate_at_eos(row, 2), [5, 1])


def detok(ids):
    return " ".join(str(i) for i in ids)


def test_synthesize_shard_resume_and_merge(tmp_path):
    """The work list, file name and resume of ``tests/test_synthesis.py``;
    each document's greedy prefix (start token + j greedy tokens) equals
    the JAX package's shard. A file truncated at a batch's start resumes to
    the same lines; one truncated inside a batch regains the missing lines,
    their greedy prefixes the same (later batches start elsewhere in the
    work list, so their noise differs)."""
    jp, tp = _both(TINY, seed=0)
    kw = dict(detokenize=detok, n_vocab_per_shard=6, batch_size=4, total_len=8, eos_id=None)
    path = TS.synthesize_shard(tp, tcfg(TINY), 1, str(tmp_path / "gen"), dtype=torch.float32,
                               **kw)
    assert os.path.basename(path) == "gen.chunk.01.jsonl"
    lines = open(path).read().splitlines()
    assert len(lines) == 18                        # 3 greedy lengths x 6 start ids
    jpath = JS.synthesize_shard(jp, TINY, 1, str(tmp_path / "jgen"), dtype=jnp.float32, **kw)
    jlines = open(jpath).read().splitlines()
    for i, (a, b) in enumerate(zip(lines, jlines)):
        j = (3, 4, 5)[i // 6]
        ta, tb = json.loads(a)["text"].split(), json.loads(b)["text"].split()
        assert ta[0] == str(6 + i % 6) and ta[:j] == tb[:j], i
    with open(path, "w") as f:
        f.write("\n".join(lines[:6]) + "\n")
    TS.synthesize_shard(tp, tcfg(TINY), 1, str(tmp_path / "gen"), dtype=torch.float32, **kw)
    assert open(path).read().splitlines() == lines
    with open(path, "w") as f:
        f.write("\n".join(lines[:7]) + "\n")
    TS.synthesize_shard(tp, tcfg(TINY), 1, str(tmp_path / "gen"), dtype=torch.float32, **kw)
    lines2 = open(path).read().splitlines()
    assert len(lines2) == 18 and lines2[:7] == lines[:7]
    assert json.loads(lines2[7])["text"].split()[:4] == json.loads(lines[7])["text"].split()[:4]

    d = tmp_path / "merge"
    d.mkdir()
    for i, n in [(0, 2), (1, 3)]:
        with open(d / f"gen.chunk.{i:02d}.jsonl", "w") as f:
            for k in range(n):
                f.write(json.dumps({"text": f"{i}-{k}"}) + "\n")
    out = TS.merge_shards(str(d))
    assert [json.loads(line)["text"] for line in open(out)] == ["0-0", "0-1", "1-0", "1-1", "1-2"]
    assert open(out).read() == open(JS.merge_shards(str(d), "jax.jsonl")).read()


def test_generate_data_cli(tmp_path, capsys):
    """``generate_data_torch.py <shard> --teacher DIR --tokenizer byte
    --device cpu``, then ``--merge``: the byte tokenizer's text, one line per
    work item."""
    p = np_params(TINY, seed=8)
    JC.save_hf_checkpoint(_tree(jnp.asarray, p), TINY, str(tmp_path / "teacher"))
    out = str(tmp_path / "gen")
    path = TG.main(["0", "--teacher", str(tmp_path / "teacher"), "--tokenizer", "byte",
                    "--out_dir", out, "--n_vocab_per_shard", "2", "--batch_size", "2",
                    "--max_length", "6", "--device", "cpu"])
    assert os.path.basename(path) == "gen.chunk.00.jsonl"
    assert len(open(path).read().splitlines()) == 6
    merged = TG.main(["--merge", "--out_dir", out])
    assert open(merged).read() == open(path).read()
