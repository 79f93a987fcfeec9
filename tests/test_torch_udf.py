"""The port's token-column UDFs (``sparkdl_tpu_torch.udf``) and the
serving-weights cast (``models.pretrained.cast_float_leaves``) against the
JAX package's, on the CPU.

Twins of the UDF tests of ``tests/test_transformer_models.py``. The Llama
and BERT weights come from the JAX models' flax trees
(``load_flax_params``); the same DataFrame contents go through the JAX
package's UDF (on its own DataFrame) and the port's (on the port's copy).
Greedy generation is held token for token, and classification class for
class, to the reference UDF's output; sampled generation only to its own
seed (the port draws from a ``torch.Generator``, not a JAX key).
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sparkdl_tpu as jsdl
import sparkdl_tpu_torch as sdl
from sparkdl_tpu.models import bert as JB
from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.udf import registry as jreg
from sparkdl_tpu_torch.models import bert as B
from sparkdl_tpu_torch.models import llama as L
from sparkdl_tpu_torch.models.pretrained import cast_float_leaves
from sparkdl_tpu_torch.udf import registry as reg


def _np_tree(tree):
    return {k: _np_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def llama():
    """(JAX model, its flax tree, the port's model with those weights)."""
    jmodel = JL.LlamaModel(JL.LlamaConfig.tiny())
    v = _np_tree(jmodel.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 4), jnp.int32)))
    port = L.load_flax_params(L.LlamaModel(L.LlamaConfig.tiny(),
                                           device="cpu"), v)
    return jmodel, v, port


def _jax_udf_rows(register, df_dict, col, parts=1, **kw):
    """The JAX package's UDF output column over the same contents."""
    register("ref", **kw)
    try:
        jdf = jsdl.DataFrame.fromPydict(df_dict, numPartitions=parts)
        return [r["out"] for r in jreg.applyUDF(jdf, "ref", col,
                                                "out").collect()]
    finally:
        jreg.unregisterUDF("ref")


def _apply(name, df, col, out="c"):
    try:
        return sdl.applyUDF(df, name, col, out)
    finally:
        sdl.unregisterUDF(name)


def _spy_generate(monkeypatch):
    shapes = []
    real = L.generate

    def spy(model, ids, *a, **kw):
        shapes.append(tuple(ids.shape))
        return real(model, ids, *a, **kw)

    monkeypatch.setattr(L, "generate", spy)
    return shapes, real


def test_generation_udf_left_pads_one_shape(llama, monkeypatch):
    """A mixed-length column runs as ONE left-padded generate() call of
    one shape, with no fill; a second column with another length mix and
    the same max runs at the same shape; tokens equal the reference
    UDF's."""
    jmodel, v, model = llama
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 512, n).tolist() for n in (5, 8, 5, 3)]
    prompts2 = [rng.randint(0, 512, n).tolist() for n in (8, 1, 2, 7)]
    shapes, _ = _spy_generate(monkeypatch)
    outs = []
    for ps in (prompts, prompts2):
        sdl.registerGenerationUDF("gen", model, max_new_tokens=4)
        df = sdl.DataFrame.fromPydict({"prompt": ps})
        outs.append([r["c"] for r in _apply("gen", df, "prompt")
                     .collect()])
        want = _jax_udf_rows(
            lambda name, **kw: jreg.registerGenerationUDF(
                name, jmodel, v, **kw), {"prompt": ps}, "prompt",
            max_new_tokens=4)
        assert outs[-1] == want
    assert shapes == [(4, 8), (4, 8)]
    for ps, out in zip((prompts, prompts2), outs):
        for p, c in zip(ps, out):
            assert len(c) == len(p) + 4 and c[:len(p)] == p


def test_generation_udf_streams_without_full_materialization(llama,
                                                             monkeypatch):
    """The UDF walks the column by iterBatches: every generate() call
    sees at most batchRows rows, toPandas never runs on the input, the
    partition count is kept, and each row equals its solo generation and
    the reference UDF's row."""
    from sparkdl_tpu_torch.core.frame import DataFrame as DF

    jmodel, v, model = llama
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 512, n).tolist()
               for n in (5, 2, 7, 3, 4, 6, 1, 2, 5, 3)]
    df = sdl.DataFrame.fromPydict({"p": prompts}, numPartitions=4)
    shapes, real_generate = _spy_generate(monkeypatch)
    monkeypatch.setattr(
        DF, "toPandas",
        lambda self: (_ for _ in ()).throw(
            AssertionError("generation UDF materialized the column")))
    sdl.registerGenerationUDF("sg", model, max_new_tokens=3, batchRows=4)
    out = _apply("sg", df, "p")
    rows = out.collect()
    assert len(shapes) == 3 and all(s[0] <= 4 for s in shapes)
    assert len(rows) == 10 and out.numPartitions == df.numPartitions
    want = _jax_udf_rows(
        lambda name, **kw: jreg.registerGenerationUDF(name, jmodel, v,
                                                      **kw),
        {"p": prompts}, "p", parts=4, max_new_tokens=3, batchRows=4)
    for p, r, w in zip(prompts, rows, want):
        solo = real_generate(model, np.asarray([p]), 3)
        assert list(r["c"]) == solo[0].tolist() == w


def test_generation_udf_single_shape_with_filled_tail(llama, monkeypatch):
    """18 rows, batchRows 8: chunks of 8, 8 and 2 (+6 duplicate rows), all
    at one (8, max_len) shape; the fill rows are dropped."""
    _, _, model = llama
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, 512, n).tolist()
               for n in ([3, 5, 2, 4, 6, 3, 2, 5] * 2 + [4, 3])]
    shapes, _ = _spy_generate(monkeypatch)
    sdl.registerGenerationUDF("sig", model, max_new_tokens=2, batchRows=8)
    rows = _apply("sig", sdl.DataFrame.fromPydict({"p": prompts}), "p") \
        .collect()
    assert len(rows) == 18
    assert shapes == [(8, 6)] * 3
    assert [r["c"][:len(p)] for r, p in zip(rows, prompts)] == prompts


@pytest.fixture(scope="module")
def bert():
    jmodel = JB.BertForSequenceClassification(JB.BertConfig.tiny(),
                                              num_classes=3)
    v = _np_tree(jmodel.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 8), jnp.int32)))
    return jmodel, v


def test_sequence_classification_udf(bert):
    """Ragged token-id columns stream right-padded through the classifier;
    predictions equal the reference UDF's and per-row solo
    classification; empty and null rows raise naming the global row."""
    jmodel, v = bert
    model = B.BertForSequenceClassification(B.BertConfig.tiny(),
                                            num_classes=3, device="cpu")
    rng = np.random.RandomState(0)
    rows = [rng.randint(0, 1000, n).tolist() for n in (8, 3, 12, 5, 7)]
    df = sdl.DataFrame.fromPydict({"tokens": rows}, numPartitions=2)
    # variables= loads the flax tree into the model, as from_model does
    sdl.registerSequenceClassificationUDF("cls", model, v, batchRows=3)
    out = _apply("cls", df, "tokens", "label")
    got = [r["label"] for r in out.collect()]
    assert out.numPartitions == df.numPartitions
    want = _jax_udf_rows(
        lambda name, **kw: jreg.registerSequenceClassificationUDF(
            name, jmodel, v, **kw), {"tokens": rows}, "tokens", parts=2,
        batchRows=3)
    assert got == want
    for toks, lab in zip(rows, got):
        with torch.no_grad():
            logits = model(torch.tensor([toks]), torch.ones((1, len(toks)),
                                                            dtype=torch.int32))
        assert int(logits.argmax(-1)[0]) == lab
    # classify_rows is the device step: numpy in, numpy out, fill dropped
    np.testing.assert_array_equal(
        reg.classify_rows(model, rows, 12, n_fill=2), np.asarray(got))

    bad = sdl.DataFrame.fromPydict({"tokens": [[1, 2], []]})
    nul = sdl.DataFrame.fromPydict({"tokens": [[1], [2], [3], None]},
                                   numPartitions=2)
    sdl.registerSequenceClassificationUDF("cls2", model, batchRows=2)
    try:
        with pytest.raises(ValueError, match="row 1 is an empty"):
            sdl.applyUDF(bad, "cls2", "tokens", "label")
        with pytest.raises(ValueError, match="row 3 is null"):
            sdl.applyUDF(nul, "cls2", "tokens", "label")
    finally:
        sdl.unregisterUDF("cls2")


def test_text_generation_udf_string_columns(llama):
    """String prompts → encode → the streamed token UDF → decode, the
    prompt stripped and the helper columns dropped; equal to the reference
    UDF's text."""
    jmodel, v, model = llama
    encode = lambda s: [ord(c) - ord("a") + 1 for c in s]  # noqa: E731
    decode = lambda ids: "".join(chr(i - 1 + ord("a"))  # noqa: E731
                                 for i in ids)
    texts = ["hello", "ab", "generate"]
    df = sdl.DataFrame.fromPydict({"text": texts}, numPartitions=2)
    sdl.registerTextGenerationUDF("complete", model, encode=encode,
                                  decode=decode, max_new_tokens=4,
                                  batchRows=2)
    out = _apply("complete", df, "text", "rest").toPandas()
    assert list(out.columns) == ["text", "rest"]
    for t, rest in zip(texts, out["rest"]):
        solo = L.generate(model, np.asarray([encode(t)]), 4)[0]
        assert rest == decode([int(x) for x in solo[len(encode(t)):]])
    want = _jax_udf_rows(
        lambda name, **kw: jreg.registerTextGenerationUDF(
            name, jmodel, v, encode, decode, **kw), {"text": texts},
        "text", parts=2, max_new_tokens=4, batchRows=2)
    assert list(out["rest"]) == want

    with pytest.raises(TypeError, match="encode and decode"):
        sdl.registerTextGenerationUDF("bad", model, encode="not-callable",
                                      decode=decode)
    # an empty prompt's error names the caller's column
    sdl.registerTextGenerationUDF("t2", model, encode=encode, decode=decode,
                                  max_new_tokens=2)
    with pytest.raises(ValueError, match="'text' row 1"):
        _apply("t2", sdl.DataFrame.fromPydict({"text": ["ok", ""]}),
               "text", "out")


def _first_token(model, prompt, n=5):
    return int(L.generate(model, np.asarray([prompt]), n)[0, len(prompt)])


def test_generation_eos_stops_rows(llama):
    """Greedy's first token used as eos: the row is done at once, every
    later token is eos, and the UDF trims the tail to one eos."""
    jmodel, v, model = llama
    ids = np.asarray([[1, 2, 3]])
    eos = _first_token(model, [1, 2, 3])
    out = L.generate(model, ids, 5, eos_id=eos)
    assert (out[0, 3:] == eos).all()
    sdl.registerGenerationUDF("eos_g", model, max_new_tokens=5, eos_id=eos)
    res = _apply("eos_g", sdl.DataFrame.fromPydict({"p": [[1, 2, 3]]}),
                 "p").toPandas()
    assert list(res["c"][0]) == [1, 2, 3, eos]
    want = _jax_udf_rows(
        lambda name, **kw: jreg.registerGenerationUDF(name, jmodel, v,
                                                      **kw),
        {"p": [[1, 2, 3]]}, "p", max_new_tokens=5, eos_id=eos)
    assert [list(res["c"][0])] == want


def test_generation_udf_eos_across_chunks(llama):
    """5 identical rows, batchRows 2 → 3 chunks: every row comes back
    trimmed identically, whichever chunk carried it."""
    jmodel, v, model = llama
    prompt = [1, 2, 3]
    eos = _first_token(model, prompt)
    sdl.registerGenerationUDF("ec", model, max_new_tokens=5, eos_id=eos,
                              batchRows=2)
    df = sdl.DataFrame.fromPydict({"p": [prompt] * 5}, numPartitions=3)
    rows = _apply("ec", df, "p").collect()
    assert [list(r["c"]) for r in rows] == [prompt + [eos]] * 5
    want = _jax_udf_rows(
        lambda name, **kw: jreg.registerGenerationUDF(name, jmodel, v,
                                                      **kw),
        {"p": [prompt] * 5}, "p", parts=3, max_new_tokens=5, eos_id=eos,
        batchRows=2)
    assert want == [prompt + [eos]] * 5


def test_generation_eos_with_sampling(llama):
    """Sampling with top-k / top-p and eos: the same generator seed gives
    the same tokens and steps; done rows repeat eos to the end; a sampled
    UDF repeats itself per seed."""
    _, _, model = llama
    ids = np.asarray([[1, 2, 3], [4, 5, 6]])

    def run():
        return L.generate(model, ids, 12, temperature=0.9, top_k=20,
                          top_p=0.95, eos_id=5, return_steps=True,
                          generator=torch.Generator().manual_seed(7))

    (out1, s1), (out2, s2) = run(), run()
    assert torch.equal(out1, out2) and s1 == s2 and out1.shape == (2, 15)
    for r in range(2):
        tail = out1[r, 3:]
        if (tail == 5).any():
            first = int(torch.argmax((tail == 5).int()))
            assert (tail[first:] == 5).all()
    df = sdl.DataFrame.fromPydict({"p": [[1, 2, 3], [4, 5, 6, 7]] * 3})
    outs = []
    for _ in range(2):
        sdl.registerGenerationUDF("samp", model, max_new_tokens=6,
                                  temperature=0.9, top_k=20, seed=3,
                                  batchRows=4)
        outs.append([r["c"] for r in _apply("samp", df, "p").collect()])
    assert outs[0] == outs[1]


def test_cast_float_leaves_mechanics():
    """Matrix float weights go to the serving dtype; 1-D float weights and
    integer buffers pass through; the cast is idempotent; the caller's
    model keeps its f32 weights."""
    model = B.BertForSequenceClassification(B.BertConfig.tiny(),
                                            device="cpu")
    model.register_buffer("ids", torch.arange(3, dtype=torch.int32))
    cast = cast_float_leaves(model, "bfloat16")
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 cast.named_parameters()):
        assert p.dtype == torch.float32
        assert q.dtype == (torch.bfloat16 if p.dim() >= 2
                           else torch.float32), name
        torch.testing.assert_close(q.float(), p.to(q.dtype).float())
    assert cast.ids.dtype == torch.int32 and torch.equal(cast.ids,
                                                         model.ids)
    again = cast_float_leaves(cast, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(cast.parameters(),
                                                 again.parameters()))
    with torch.no_grad():  # computes in the model's dtype from bf16 weights
        logits = cast(torch.tensor([[1, 2, 3]]))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_generation_udf_serving_params_dtype(llama):
    """``params_dtype="bfloat16"`` serves from a bf16-stored copy: the
    bf16 model's logits stay close to the f32-stored ones (only the f32
    lm_head sees rounded weights), generation runs with prompts kept as
    prefixes, and the caller's model keeps its weights."""
    _, v, _ = llama
    model = L.load_flax_params(
        L.LlamaModel(L.LlamaConfig.tiny(), dtype=torch.bfloat16,
                     device="cpu"), v)
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 512, (2, 8)))
    with torch.no_grad():
        f32 = model(ids)
        bf16 = cast_float_leaves(model, "bfloat16")(ids)
    scale = max(f32.abs().max().item(), 1.0)
    assert (bf16 - f32).abs().max().item() < 0.05 * scale
    assert model.lm_head.weight.dtype == torch.float32
    prompts = [ids[0, :5].tolist(), ids[1].tolist()]
    sdl.registerGenerationUDF("gen_bf16", model, max_new_tokens=4,
                              params_dtype="bfloat16")
    out = _apply("gen_bf16", sdl.DataFrame.fromPydict({"prompt": prompts}),
                 "prompt").collect()
    for r, p in zip(out, prompts):
        assert r["c"][:len(p)] == p and len(r["c"]) == len(p) + 4
        assert all(0 <= t < 512 for t in r["c"])
    assert model.lm_head.weight.dtype == torch.float32


def test_registration_checks_and_registry(llama):
    _, _, model = llama
    with pytest.raises(ValueError, match="top_p"):
        sdl.registerGenerationUDF("bad", model, top_p=0.0)
    with pytest.raises(ValueError, match="top_k"):
        sdl.registerGenerationUDF("bad", model, top_k=-1)
    with pytest.raises(TypeError, match="eos_id"):
        sdl.registerGenerationUDF("bad", model, eos_id="</s>")
    assert "bad" not in sdl.listUDFs()
    # the numeric and image UDFs register; a Keras model or model file
    # needs Keras on its torch backend, and this process runs keras on jax
    # (tests/conftest.py), so the port refuses it before importing keras
    # (tests/test_torch_keras.py registers one in a KERAS_BACKEND=torch
    # process); a zoo model without device= needs the card
    reg.registerUDF("u1", len, device="cpu")
    reg.registerImageUDF("u2", len, (8, 8), device="cpu")
    assert {"u1", "u2"} <= set(sdl.listUDFs())
    for keras_model_or_file in ("model.keras", object()):
        with pytest.raises(RuntimeError, match="KERAS_BACKEND=torch"):
            reg.registerKerasImageUDF("u3", keras_model_or_file)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reg.registerKerasImageUDF("u3", "ResNet50")
    assert "u3" not in sdl.listUDFs()
    sdl.unregisterUDF("u1")
    sdl.unregisterUDF("u2")
    sdl.registerGenerationUDF("g1", model, max_new_tokens=1)
    assert "g1" in sdl.listUDFs()
    sdl.unregisterUDF("g1")
    sdl.unregisterUDF("g1")  # a second unregister is a no-op
    assert "g1" not in sdl.listUDFs()
    with pytest.raises(ValueError, match="not registered"):
        sdl.applyUDF(sdl.DataFrame.fromPydict({"p": [[1]]}), "g1", "p",
                     "c")
