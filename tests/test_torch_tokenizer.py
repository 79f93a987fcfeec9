"""The port's byte-level BPE tokenizer (``sparkdl_tpu_torch.models.
ByteBPETokenizer``) held against the JAX package's: the twins of the seven
tests of ``tests/test_tokenizer.py``. Each trains both tokenizers on the
same corpus and holds the port's merges and ids bitwise to the
reference's, beside the reference test's own checks; the end-to-end twin
drives ``registerTextGenerationUDF`` in both packages with the same
weights (carried across by ``load_flax_params``) and compares the
generated ids and strings for equality."""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json
import random

import jax
import numpy as np
import pytest

from sparkdl_tpu.models.tokenizer import ByteBPETokenizer as JTok
from sparkdl_tpu_torch.models import ByteBPETokenizer

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the lazy dog sleeps while the quick fox runs",
    "a quick brown dog and a lazy fox",
    "the the the quick quick lazy lazy fox dog",
]


def _both(vocab_size):
    tok = ByteBPETokenizer.train(CORPUS, vocab_size=vocab_size)
    ref = JTok.train(CORPUS, vocab_size=vocab_size)
    assert tok.merges == ref.merges
    return tok, ref


def test_untrained_round_trip_any_text():
    tok, ref = ByteBPETokenizer(), JTok()
    for text in ["hello world", "", "  spaces  and\nnewlines\t",
                 "unicode: héllo wörld — ≠ 🦊", "a"]:
        assert tok.encode(text) == ref.encode(text)
        assert tok.decode(tok.encode(text)) == text
    assert tok.vocab_size == ref.vocab_size == 259
    assert tok.encode("ab") == [97, 98]


def test_training_learns_merges_and_compresses():
    tok, ref = _both(320)
    assert 259 < tok.vocab_size == ref.vocab_size <= 320
    text = "the quick lazy fox"
    ids = tok.encode(text)
    assert ids == ref.encode(text)
    assert len(ids) < len(text.encode())
    assert tok.decode(ids) == text
    assert tok.decode(tok.encode("zebra ≠ fox!")) == "zebra ≠ fox!"


def test_specials_and_flags():
    tok, ref = _both(280)
    ids = tok.encode("the fox", add_bos=True, add_eos=True)
    assert ids == ref.encode("the fox", add_bos=True, add_eos=True)
    assert ids[0] == ByteBPETokenizer.BOS == JTok.BOS
    assert ids[-1] == ByteBPETokenizer.EOS == JTok.EOS
    assert ByteBPETokenizer.PAD == JTok.PAD
    assert tok.decode(ids) == "the fox"
    assert tok.decode([ByteBPETokenizer.PAD] * 3) == ""


def test_save_load_reproduces_encoding(tmp_path):
    """A file either package saves loads in the other with the same
    merges and encodings (one format tag)."""
    tok, ref = _both(300)
    p, pj = str(tmp_path / "bpe.json"), str(tmp_path / "bpe_ref.json")
    tok.save(p)
    ref.save(pj)
    with open(p) as f, open(pj) as g:
        assert json.load(f) == json.load(g)
    for loaded in (ByteBPETokenizer.load(p), ByteBPETokenizer.load(pj),
                   JTok.load(p)):
        assert loaded.vocab_size == tok.vocab_size
        for text in CORPUS + ["held-out the lazy zebra"]:
            assert loaded.encode(text) == tok.encode(text)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"merges": []}, f)
    with pytest.raises(ValueError, match="format"):
        ByteBPETokenizer.load(bad)


def test_deterministic_training():
    a = ByteBPETokenizer.train(CORPUS, vocab_size=300)
    b = ByteBPETokenizer.train(CORPUS, vocab_size=300)
    assert a.merges == b.merges == JTok.train(CORPUS, vocab_size=300).merges


def test_fuzz_round_trip_random_unicode():
    tok, ref = _both(320)
    rnd = random.Random(0)
    pool = ([chr(c) for c in range(32, 127)]
            + list("äöüßéè日本語中文한국어🦊🎉∑≠  ")
            + list("\t\n\r ") * 5)
    for _ in range(300):
        s = "".join(rnd.choice(pool) for _ in range(rnd.randint(0, 60)))
        ids = tok.encode(s)
        assert ids == ref.encode(s)
        assert tok.decode(ids) == s


def test_text_generation_udf_end_to_end_with_in_repo_tokenizer():
    """Config-5 string serving with no external asset, in both packages:
    the tokenizer trained in process, the tiny Llama's weights drawn by
    the reference and carried into the port's model; the completions'
    strings, and so the generated ids, are equal."""
    import sparkdl_tpu as jsdl
    import sparkdl_tpu_torch as sdl
    from sparkdl_tpu.models.llama import LlamaConfig as JCfg
    from sparkdl_tpu.models.llama import LlamaModel as JModel
    from sparkdl_tpu.udf import registerTextGenerationUDF as jreg
    from sparkdl_tpu.udf import unregisterUDF as junreg
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.udf import (registerTextGenerationUDF,
                                       unregisterUDF)

    tok = ByteBPETokenizer.train(CORPUS, vocab_size=300)
    cfg = JCfg.tiny()
    assert cfg.vocab_size >= tok.vocab_size
    jmodel = JModel(cfg)
    v = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), np.zeros((1, 4), np.int32)))
    prompts = ["the quick fox", "a lazy dog", "the the the"]
    ids = {}

    def spy(decode, key):
        def f(toks):
            ids.setdefault(key, []).append([int(t) for t in toks])
            return decode(toks)
        return f

    jreg("txt", jmodel, v, encode=tok.encode, decode=spy(tok.decode, "ref"),
         max_new_tokens=4, batchRows=2, eos_id=JTok.EOS)
    try:
        want = jsdl.applyUDF(jsdl.DataFrame.fromPydict({"prompt": prompts}),
                             "txt", "prompt", "completion").collect()
    finally:
        junreg("txt")
    model = L.LlamaModel(L.LlamaConfig.tiny(), device="cpu")
    registerTextGenerationUDF(
        "txt", model, v, encode=tok.encode, decode=spy(tok.decode, "port"),
        max_new_tokens=4, batchRows=2, eos_id=ByteBPETokenizer.EOS)
    try:
        got = sdl.applyUDF(sdl.DataFrame.fromPydict({"prompt": prompts}),
                           "txt", "prompt", "completion").collect()
    finally:
        unregisterUDF("txt")
    assert len(got) == 3
    assert [r["prompt"] for r in got] == prompts
    assert all(isinstance(r["completion"], str) for r in got)
    assert [r["completion"] for r in got] == [r["completion"] for r in want]
    assert ids["port"] == ids["ref"] and len(ids["port"]) == 3
