"""Port parity: llm_qat_torch.data.dataset and llm_qat_torch.native against
the JAX package's data pipeline: the jsonl readers (native and Python),
packing, the train/val split and the batch stream, bit for bit for the same
seed (shuffle, epochs, shards, the dropped tail). Mirrors
``tests/test_native.py`` for the port's reader.
"""

import json

import numpy as np
import pytest

from llm_qat_tpu import native as JN
from llm_qat_tpu.data import dataset as JD
from llm_qat_torch import native as TN
from llm_qat_torch.data import dataset as TD

DOCS = [
    "plain ascii",
    'quotes " and \\ backslash',
    "newline\nand\ttab",
    "unicode: café 中文",
    "emoji beyond BMP: \U0001f600",
    "control \b\f chars",
    "",
    "trailing space ",
]

fd = TN.get_fastdata()
needs_native = pytest.mark.skipif(fd is None, reason="no C++ toolchain")


def _write(path, docs, extra=()):
    with open(path, "w") as f:
        for d in docs:
            f.write(json.dumps({"text": d}) + "\n")
        for line in extra:
            f.write(line)
    return str(path)


@needs_native
def test_native_reader_matches_python_json(tmp_path):
    p = _write(tmp_path / "d.jsonl", DOCS,
               ["\n", json.dumps({"other": 1, "text": "after other key"}) + "\n"])
    assert fd.read_jsonl_texts(p) == DOCS + ["after other key"]
    assert fd.read_jsonl_texts(p, 3) == DOCS[:3]
    assert fd.count_lines(p) == len(DOCS) + 2
    # built outside the package, under the repository's build/
    assert TN.BUILD_DIR.parts[-2:] == ("build", "llm_qat_torch")
    assert str(TN._target()).startswith(str(TN.BUILD_DIR))


@needs_native
def test_native_reader_escapes_and_errors(tmp_path):
    p = _write(tmp_path / "d.jsonl", ["café \U0001f600"])
    assert "\\u" in open(p).read()
    assert fd.read_jsonl_texts(p) == ["café \U0001f600"]
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"nope": 1}) + "\n")
    with pytest.raises(ValueError):
        fd.read_jsonl_texts(str(bad))


@pytest.mark.parametrize("max_lines", [None, 4])
def test_read_jsonl_texts_matches_jax_with_either_reader(tmp_path, monkeypatch, max_lines):
    p = _write(tmp_path / "d.jsonl", DOCS, ["\n", json.dumps({"text": "z"}) + "\n"])
    want = JD.read_jsonl_texts(p, max_lines)
    assert TD.read_jsonl_texts(p, max_lines) == want
    assert TD.last_reader == ("native" if fd is not None else "python")
    # without the native module: the Python reader, the same texts
    monkeypatch.setattr(TN, "get_fastdata", lambda: None)
    assert TD.read_jsonl_texts(p, max_lines) == want
    assert TD.last_reader == "python"


def test_pack_blocks_and_split_match_jax():
    texts = [f"doc {i} " * (i + 1) for i in range(30)]
    tok = lambda t: [ord(c) % 97 for c in t]  # noqa: E731
    for bs in (1, 7, 64, 10_000):
        a, b = TD.pack_blocks(texts, tok, bs), JD.pack_blocks(texts, tok, bs)
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert TD.pack_blocks([], tok, 8).shape == (0, 8)
    for n in (0, 5, 100):
        assert TD.split_train_val(texts, n) == JD.split_train_val(texts, n)
    assert TD.DEFAULT_VAL_LINES == JD.DEFAULT_VAL_LINES


@pytest.mark.parametrize("shuffle,seed,epochs,drop_last", [
    (True, 0, 1, True), (True, 3, 3, True), (False, 0, 2, True), (True, 1, 2, False)])
@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_batch_stream_is_jaxs(shuffle, seed, epochs, drop_last, shard):
    blocks = np.random.default_rng(9).integers(0, 1000, (23, 5)).astype(np.int32)
    tds, jds = TD.BlockDataset(blocks).shard(*shard), JD.BlockDataset(blocks).shard(*shard)
    assert len(tds) == len(jds)
    kw = dict(shuffle=shuffle, seed=seed, epochs=epochs, drop_last=drop_last)
    got, want = list(tds.batches(3, **kw)), list(jds.batches(3, **kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert np.array_equal(a["input_ids"], b["input_ids"])
        assert np.array_equal(a["labels"], b["labels"])
    assert np.array_equal(tds[2]["input_ids"], jds[2]["input_ids"])


def test_train_val_datasets_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    docs = ["".join(chr(97 + c) for c in rng.integers(0, 26, 50)) for _ in range(20)]
    p = _write(tmp_path / "t.jsonl", docs)
    tok = TD.load_tokenizer("byte")[1]
    for kw in (dict(val_lines=5), dict(eval_path=p), dict(eval_path=p, eval_block_size=8)):
        ta, tb = TD.get_train_val_datasets(p, tok, 32, **kw)
        ja, jb = JD.get_train_val_datasets(p, tok, 32, **kw)
        assert np.array_equal(ta.blocks, ja.blocks) and np.array_equal(tb.blocks, jb.blocks)
    ds = TD.BlockDataset.from_jsonl(p, tok, 16, max_lines=3)
    assert np.array_equal(ds.blocks, JD.BlockDataset.from_jsonl(p, tok, 16, max_lines=3).blocks)


def test_byte_tokenizer_is_jaxs_and_other_paths_need_transformers(monkeypatch):
    tt, te = TD.load_tokenizer("byte")
    jt, je = JD.load_tokenizer("byte")
    for text in ("", "abc", "café \U0001f600"):
        assert te(text) == je(text)
        assert tt.decode(te(text)) == jt.decode(je(text)) == text
        assert tt(text).input_ids == te(text)
    assert (tt.vocab_size, tt.bos_token_id, tt.eos_token_id) == (259, 1, 2)
    # any other path imports transformers only when asked
    import sys
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        TD.load_tokenizer("some/tokenizer/dir")


def test_jax_reader_untouched():
    """The JAX package's native module is its own (built into its package);
    the port builds its copy elsewhere."""
    assert JN._SO != str(TN._target())
