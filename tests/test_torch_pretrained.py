"""The port's foreign-checkpoint importers and native weight readers
(``sparkdl_tpu_torch.models.pretrained``, ``models.registry``'s
``load_flax_msgpack`` / ``load_safetensors`` / ``state_dict_to_flax``)
against the JAX package's, on the CPU.

Three kinds of test:
- twins of ``tests/test_pretrained.py`` (the three that need HF
  ``transformers`` skip where it is missing, as the reference's do; the
  Keras-model twins are in ``test_torch_pretrained_keras.py``), each
  asserting the reference's claims on the port;
- equality with the reference's importers on inputs made from a numpy
  seed: the port's tree equals the reference's leaf by leaf, bitwise (same
  key paths, shapes, dtypes and values), and both raise their
  ``CheckpointMismatch`` (or ``ValueError``) with the same message on the
  same broken input;
- end to end: the imported trees loaded into the port's models give the
  JAX models' logits within the repo's stated tolerances (Llama logits
  1e-4, ``test_torch_llama``; BERT 1e-5, ``test_torch_bert``; image
  features the f32 rule of ``test_torch_image_models``), and
  ``DeepImageFeaturizer(weightsPath=...)`` reads ``.msgpack`` and
  ``.safetensors`` files as the reference's does.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flax.serialization
import jax.numpy as jnp
from sparkdl_tpu.models import bert as JB
from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.models import pretrained as JP
from sparkdl_tpu.models import registry as JR
from sparkdl_tpu_torch.models import bert as B
from sparkdl_tpu_torch.models import llama as L
from sparkdl_tpu_torch.models import pretrained as P
from sparkdl_tpu_torch.models import registry as R

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 1e-4        # test_torch_llama
BERT_TOL = 1e-5         # test_torch_bert
PKGS = [("ref", JP), ("port", P)]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def assert_trees_bitwise(got, want):
    """Same key paths; each leaf the same shape, dtype and bits."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for path, wv in w.items():
        gv, wv = np.asarray(g[path]), np.asarray(wv)
        assert gv.shape == wv.shape and gv.dtype == wv.dtype, path
        assert np.array_equal(gv, wv), path


def raises_alike(fn, *args, exc_of=lambda pkg: pkg.CheckpointMismatch,
                 **kw):
    """Both packages raise their own error class with one message."""
    msgs = []
    for _, pkg in PKGS:
        with pytest.raises(exc_of(pkg)) as ei:
            fn(pkg)(*args, **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1], msgs
    return msgs[0]


def hf_llama_state(cfg, seed=0, prefix="model.", lm_head=True,
                   ones_norms=False):
    """A seeded HF-named Llama state dict (numpy f32)."""
    rng = np.random.RandomState(seed)
    hs, hd = cfg.hidden_size, cfg.head_dim

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    def norm():
        return np.ones(hs, np.float32) if ones_norms else \
            rng.uniform(0.5, 1.5, hs).astype(np.float32)

    s = {prefix + "embed_tokens.weight": r(cfg.vocab_size, hs),
         prefix + "norm.weight": norm()}
    for i in range(cfg.num_layers):
        p = f"{prefix}layers.{i}."
        s[p + "self_attn.q_proj.weight"] = r(cfg.num_heads * hd, hs)
        s[p + "self_attn.k_proj.weight"] = r(cfg.num_kv_heads * hd, hs)
        s[p + "self_attn.v_proj.weight"] = r(cfg.num_kv_heads * hd, hs)
        s[p + "self_attn.o_proj.weight"] = r(hs, cfg.num_heads * hd)
        s[p + "mlp.gate_proj.weight"] = r(cfg.intermediate_size, hs)
        s[p + "mlp.up_proj.weight"] = r(cfg.intermediate_size, hs)
        s[p + "mlp.down_proj.weight"] = r(hs, cfg.intermediate_size)
        s[p + "input_layernorm.weight"] = norm()
        s[p + "post_attention_layernorm.weight"] = norm()
        s[p + "self_attn.rotary_emb.inv_freq"] = r(hd // 2)
    if lm_head:
        s["lm_head.weight"] = r(cfg.vocab_size, hs)
    return s


def hf_bert_state(cfg, seed=0, num_classes=None, prefix="bert."):
    """A seeded HF-named BERT state dict (numpy f32), with the keys HF
    files carry that the importer ignores (``position_ids``, ``cls.*``)."""
    rng = np.random.RandomState(seed)
    hs, it = cfg.hidden_size, cfg.intermediate_size

    def r(*shape):
        return (0.05 * rng.randn(*shape)).astype(np.float32)

    def dense(name, i, o):
        s[name + ".weight"] = r(o, i)
        s[name + ".bias"] = r(o)

    def ln(name):
        s[name + ".weight"] = (1 + r(hs)).astype(np.float32)
        s[name + ".bias"] = r(hs)

    s = {}
    s[prefix + "embeddings.word_embeddings.weight"] = r(cfg.vocab_size, hs)
    s[prefix + "embeddings.position_embeddings.weight"] = r(
        cfg.max_position_embeddings, hs)
    s[prefix + "embeddings.token_type_embeddings.weight"] = r(
        cfg.type_vocab_size, hs)
    s[prefix + "embeddings.position_ids"] = np.arange(
        cfg.max_position_embeddings)[None]
    ln(prefix + "embeddings.LayerNorm")
    for i in range(cfg.num_layers):
        p = f"{prefix}encoder.layer.{i}."
        for m in ("query", "key", "value"):
            dense(p + "attention.self." + m, hs, hs)
        dense(p + "attention.output.dense", hs, hs)
        ln(p + "attention.output.LayerNorm")
        dense(p + "intermediate.dense", hs, it)
        dense(p + "output.dense", it, hs)
        ln(p + "output.LayerNorm")
    dense(prefix + "pooler.dense", hs, hs)
    s["cls.predictions.bias"] = r(cfg.vocab_size)
    if num_classes:
        dense("classifier", hs, num_classes)
    return s


def _torch_state_to_safetensors(model, path):
    from safetensors.torch import save_file
    state = {k: v.contiguous() for k, v in model.state_dict().items()}
    save_file(state, str(path))


def _port_llama(cfg, variables, **kw):
    return L.load_flax_params(L.LlamaModel(cfg, device="cpu", **kw),
                              variables)


# ---------------------------------------------------------------------------
# twins of tests/test_pretrained.py
# ---------------------------------------------------------------------------

def test_import_hf_llama_forward_equivalence(tmp_path):
    tr = pytest.importorskip("transformers")
    cfg = L.LlamaConfig.tiny()
    hf_cfg = tr.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads,
        intermediate_size=cfg.intermediate_size,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
        max_position_embeddings=64, attention_bias=False,
        mlp_bias=False, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = tr.LlamaForCausalLM(hf_cfg).eval()
    f = tmp_path / "llama_hf.safetensors"
    _torch_state_to_safetensors(hf, f)

    variables = P.import_hf_llama(str(f), cfg)
    assert_trees_bitwise(variables,
                         JP.import_hf_llama(str(f), JL.LlamaConfig.tiny()))

    ids = np.array([[3, 14, 15, 92, 6], [2, 7, 1, 8, 2]], np.int64)
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits.numpy()
        got = _port_llama(cfg, variables, attn_fn=None)(
            torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("pkg_name,pkg", PKGS)
def test_import_hf_llama_tied_embeddings_and_errors(pkg_name, pkg):
    cfg = (JL if pkg_name == "ref" else L).LlamaConfig.tiny()

    def full_state():
        return hf_llama_state(cfg, seed=0, lm_head=False, ones_norms=True)

    # tied embeddings: no lm_head.weight → embedding transpose
    v = pkg.import_hf_llama(full_state(), cfg)
    np.testing.assert_array_equal(
        v["params"]["lm_head"]["kernel"],
        full_state()["model.embed_tokens.weight"].T)

    state = full_state()
    del state["model.layers.0.self_attn.q_proj.weight"]
    with pytest.raises(pkg.CheckpointMismatch, match="missing"):
        pkg.import_hf_llama(state, cfg)

    state = full_state()
    state["model.layers.0.self_attn.q_proj.weight"] = np.zeros(
        (7, 7), np.float32)
    with pytest.raises(pkg.CheckpointMismatch, match="shape"):
        pkg.import_hf_llama(state, cfg)

    state = full_state()
    state["model.layers.9.self_attn.q_proj.weight"] = np.zeros(
        (1,), np.float32)
    with pytest.raises(pkg.CheckpointMismatch, match="unconsumed"):
        pkg.import_hf_llama(state, cfg)


def test_imported_llama_works_with_lora_template():
    """Base HF weights + a LoRA-enabled port model: the merge keeps the
    model's adapters (lora_b zero) and overlays everything else, so the
    LoRA forward equals the base forward."""
    cfg, base_cfg = L.LlamaConfig.tiny(lora_rank=2), L.LlamaConfig.tiny()
    state = hf_llama_state(base_cfg, seed=1, prefix="", ones_norms=True)
    imported = P.import_hf_llama(state, base_cfg)
    lora_model = L.LlamaModel(cfg, device="cpu", attn_fn=None)
    template = {"params": L.flax_params(lora_model)}
    merged = P.merge_into_template(imported, template)
    q = merged["params"]["layer_0"]["attn"]["q_proj"]
    assert "lora_a" in q and "lora_b" in q
    assert np.array_equal(q["lora_b"]["kernel"], 0 * q["lora_b"]["kernel"])
    # the reference's merge of the same trees is the same tree
    assert_trees_bitwise(merged, JP.merge_into_template(imported, template))
    L.load_flax_params(lora_model, merged)
    ids = torch.tensor([[1, 2, 3, 4]])
    with torch.no_grad():
        base = _port_llama(base_cfg, imported, attn_fn=None)(ids)
        lora = lora_model(ids)
    np.testing.assert_allclose(lora.numpy(), base.numpy(), rtol=1e-5,
                               atol=1e-5)
    # a template leaf of another shape is refused alike
    bad = {"params": {"final_norm": {"scale": np.zeros(3, np.float32)}}}
    raises_alike(lambda pkg: pkg.merge_into_template, imported, bad)


def _hf_bert_cfg(tr, cfg, **kw):
    return tr.BertConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings,
        type_vocab_size=cfg.type_vocab_size,
        layer_norm_eps=cfg.layer_norm_eps, **kw)


def test_import_hf_bert_forward_equivalence(tmp_path):
    tr = pytest.importorskip("transformers")
    cfg = B.BertConfig.tiny()
    torch.manual_seed(0)
    hf = tr.BertForSequenceClassification(
        _hf_bert_cfg(tr, cfg, num_labels=3, hidden_act="gelu")).eval()
    f = tmp_path / "bert_hf.safetensors"
    _torch_state_to_safetensors(hf, f)

    variables = P.import_hf_bert(str(f), cfg, num_classes=3)
    assert_trees_bitwise(variables, JP.import_hf_bert(
        str(f), JB.BertConfig.tiny(), num_classes=3))

    ids = np.array([[2, 45, 99, 31, 0, 0], [7, 1, 22, 90, 41, 3]])
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]])
    with torch.no_grad():
        want = hf(torch.tensor(ids),
                  attention_mask=torch.tensor(mask)).logits.numpy()
        model = B.load_flax_params(B.BertForSequenceClassification(
            cfg, num_classes=3, attn_fn=None, device="cpu"), variables)
        got = model(torch.tensor(ids), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_import_hf_bert_encoder_only_and_missing_classifier():
    tr = pytest.importorskip("transformers")
    cfg = B.BertConfig.tiny()
    torch.manual_seed(1)
    hf = tr.BertModel(_hf_bert_cfg(tr, cfg)).eval()
    state = {k: v.numpy() for k, v in hf.state_dict().items()}

    variables = P.import_hf_bert(state, cfg)  # bare-encoder keys
    ids = np.array([[5, 9, 17, 2]])
    with torch.no_grad():
        out = hf(torch.tensor(ids))
        enc = B.load_flax_params(B.BertEncoder(cfg, attn_fn=None,
                                               device="cpu"), variables)
        seq, pooled = enc(torch.tensor(ids))
    np.testing.assert_allclose(seq.numpy(), out.last_hidden_state.numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(),
                               rtol=2e-4, atol=2e-4)

    v2 = P.import_hf_bert(state, cfg, num_classes=4)
    assert v2["params"]["classifier"]["kernel"].shape == (cfg.hidden_size, 4)
    np.testing.assert_array_equal(v2["params"]["classifier"]["kernel"], 0.0)


def _legacy_vgg_h5(path):
    import h5py
    rng = np.random.RandomState(0)
    tensors = {
        "block1_conv1": [rng.randn(3, 3, 3, 8).astype(np.float32),
                         rng.randn(8).astype(np.float32)],
        "fc1": [rng.randn(32, 16).astype(np.float32),
                rng.randn(16).astype(np.float32)],
        "predictions": [rng.randn(16, 4).astype(np.float32),
                        rng.randn(4).astype(np.float32)],
    }
    with h5py.File(path, "w") as h:
        h.attrs["layer_names"] = np.array(
            [k.encode() for k in tensors] + [b"flatten"])
        h.create_group("flatten").attrs["weight_names"] = np.array([])
        for name, (kernel, bias) in tensors.items():
            g = h.create_group(name)
            g.attrs["weight_names"] = np.array(
                [f"{name}/kernel:0".encode(), f"{name}/bias:0".encode()])
            g.create_dataset(f"{name}/kernel:0", data=kernel)
            g.create_dataset(f"{name}/bias:0", data=bias)
    return tensors


@pytest.mark.parametrize("pkg_name,pkg", PKGS)
def test_read_keras_h5_legacy_format_and_vgg_mapping(tmp_path, pkg_name,
                                                     pkg):
    """Hand-built legacy-topological .h5 (the published keras-applications
    layout, ':0'-suffixed weight names included) → name-mapped VGG import,
    through each package."""
    f = str(tmp_path / "legacy_vgg.h5")
    tensors = _legacy_vgg_h5(f)
    layers = pkg.read_keras_h5(f)
    assert set(layers) == set(tensors)
    np.testing.assert_array_equal(layers["fc1"][1], tensors["fc1"][1])

    template = {"params": {
        "block1_conv1": {"kernel": np.zeros((3, 3, 3, 8), np.float32),
                         "bias": np.zeros(8, np.float32)},
        "fc1": {"kernel": np.zeros((32, 16), np.float32),
                "bias": np.zeros(16, np.float32)},
        "head": {"kernel": np.zeros((16, 4), np.float32),
                 "bias": np.zeros(4, np.float32)},
    }}
    out = pkg.import_keras_vgg(f, template)
    np.testing.assert_array_equal(out["params"]["head"]["kernel"],
                                  tensors["predictions"][0])
    template["params"]["fc1"]["kernel"] = np.zeros((9, 9), np.float32)
    with pytest.raises(pkg.CheckpointMismatch):
        pkg.import_keras_vgg(f, template)


# ---------------------------------------------------------------------------
# equality with the reference's importers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix", ["model.", ""])
@pytest.mark.parametrize("tied", [False, True])
def test_hf_llama_tree_equals_reference(tied, prefix):
    cfg, jcfg = L.LlamaConfig.tiny(), JL.LlamaConfig.tiny()
    state = hf_llama_state(cfg, seed=3, prefix=prefix, lm_head=not tied)
    got = P.import_hf_llama(dict(state), cfg)
    assert_trees_bitwise(got, JP.import_hf_llama(dict(state), jcfg))
    # torch tensors in the dict give the same tree
    assert_trees_bitwise(P.import_hf_llama(
        {k: torch.from_numpy(v) for k, v in state.items()}, cfg), got)


def test_hf_llama_rope_permutation_is_the_reference_one():
    for hd in (8, 32, 128):
        np.testing.assert_array_equal(P._rope_permutation(hd),
                                      JP._rope_permutation(hd))
    w = np.random.RandomState(0).randn(4 * 16, 5).astype(np.float32)
    np.testing.assert_array_equal(P._permute_rope_rows(w, 4),
                                  JP._permute_rope_rows(w, 4))


@pytest.mark.parametrize("broken", ["missing", "shape", "unconsumed",
                                    "wrong_width"])
def test_hf_llama_broken_inputs_raise_alike(broken):
    cfg = L.LlamaConfig.tiny()
    state = hf_llama_state(cfg, seed=4)
    if broken == "missing":
        del state["model.layers.1.mlp.up_proj.weight"]
    elif broken == "shape":
        state["model.norm.weight"] = np.ones(3, np.float32)
    elif broken == "unconsumed":
        state["model.layers.2.mlp.up_proj.weight"] = np.ones(1, np.float32)
    else:  # a config of another width
        cfg = L.LlamaConfig(**dict(vars(cfg), hidden_size=64))
    jcfg = JL.LlamaConfig(**vars(cfg))
    msgs = []
    for (_, pkg), c in zip(PKGS, (jcfg, cfg)):
        with pytest.raises(pkg.CheckpointMismatch) as ei:
            pkg.import_hf_llama(dict(state), c)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("case", ["encoder", "classifier", "other_head",
                                  "no_prefix_encoder", "legacy_ln_names"])
def test_hf_bert_tree_equals_reference(case):
    cfg, jcfg = B.BertConfig.tiny(), JB.BertConfig.tiny()
    kw = {}
    if case == "encoder":
        state = hf_bert_state(cfg, seed=5)
    elif case == "no_prefix_encoder":
        state = hf_bert_state(cfg, seed=5, prefix="")
    elif case == "classifier":
        state, kw = hf_bert_state(cfg, seed=6, num_classes=3), \
            {"num_classes": 3}
    elif case == "other_head":  # a 3-class head asked for 2: zero head
        state, kw = hf_bert_state(cfg, seed=6, num_classes=3), \
            {"num_classes": 2}
    else:  # old TF-converted files: LayerNorm gamma/beta
        state = {k.replace("LayerNorm.weight", "LayerNorm.gamma")
                 .replace("LayerNorm.bias", "LayerNorm.beta"): v
                 for k, v in hf_bert_state(cfg, seed=7).items()}
    got = P.import_hf_bert(dict(state), cfg, **kw)
    assert_trees_bitwise(got, JP.import_hf_bert(dict(state), jcfg, **kw))


@pytest.mark.parametrize("broken", ["missing", "shape", "unconsumed"])
def test_hf_bert_broken_inputs_raise_alike(broken):
    cfg, jcfg = B.BertConfig.tiny(), JB.BertConfig.tiny()
    state = hf_bert_state(cfg, seed=8)
    if broken == "missing":
        del state["bert.encoder.layer.1.output.dense.bias"]
    elif broken == "shape":
        state["bert.pooler.dense.weight"] = np.ones((3, 3), np.float32)
    else:
        state["bert.encoder.layer.7.output.dense.bias"] = np.ones(
            1, np.float32)
    msgs = []
    for (_, pkg), c in zip(PKGS, (jcfg, cfg)):
        with pytest.raises(pkg.CheckpointMismatch) as ei:
            pkg.import_hf_bert(dict(state), c)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_bf16_safetensors_widens_exactly(tmp_path):
    """A bf16 HF file (published Llama-3 files hold bf16): the port reads
    the path with safetensors.torch and widens to f32, exactly; the tree
    equals the reference's import of the same values (the reference
    reads bf16 only as arrays it is handed, numpy having no bf16)."""
    from safetensors.torch import save_file
    cfg = L.LlamaConfig.tiny()
    state = hf_llama_state(cfg, seed=9)
    bf16 = {k: torch.from_numpy(v).to(torch.bfloat16)
            for k, v in state.items()}
    f = tmp_path / "bf16.safetensors"
    save_file(bf16, str(f))
    widened = {k: v.float().numpy() for k, v in bf16.items()}
    got = P.import_hf_llama(str(f), cfg)
    assert all(leaf.dtype == np.float32 for _, leaf in _leaves(got))
    assert_trees_bitwise(got, JP.import_hf_llama(widened,
                                                 JL.LlamaConfig.tiny()))
    # torch bf16 tensors handed over in a dict give the same tree
    assert_trees_bitwise(P.import_hf_llama(bf16, cfg), got)
    # every leaf is exactly the bf16 value, widened
    emb = got["params"]["embed_tokens"]["embedding"]
    assert np.array_equal(torch.from_numpy(emb).to(torch.bfloat16).float()
                          .numpy(), emb)


def _image_template(name, **kw):
    return R.state_dict_to_flax(R.get_model(name).init_params(**kw))


def _seeded_like(template, seed):
    rng = np.random.default_rng(seed)
    return {k: _seeded_like(v, seed + i) if isinstance(v, dict) else
            rng.standard_normal(np.shape(v)).astype(np.float32)
            for i, (k, v) in enumerate(sorted(template.items()))}


@pytest.mark.parametrize("chunked", [False, True])
def test_flax_msgpack_equals_reference(tmp_path, monkeypatch, chunked):
    """A file written by the reference's ``registry.save_weights``
    (``flax.serialization.to_bytes``) reads through the port's msgpack-only
    reader into the tree the reference's ``load_weights`` gives; with
    ``MAX_CHUNK_SIZE`` patched small, every array over it is written
    chunked, and the chunked branch runs."""
    template = _image_template("ResNet18", num_classes=10)
    variables = _seeded_like(template, 10)
    variables["params"]["stem_conv"]["step"] = np.float32(3.5)  # ext 3
    tmpl = dict(template, params=dict(template["params"],
                                      stem_conv=dict(
                                          template["params"]["stem_conv"],
                                          step=np.float32(0))))
    if chunked:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
    f = str(tmp_path / "w.msgpack")
    JR.save_weights(variables, f)
    raw = open(f, "rb").read()
    assert (b"__msgpack_chunked_array__" in raw) == chunked
    got = R.load_flax_msgpack(tmpl, f)
    want = JR.load_weights(tmpl, f)
    assert_trees_bitwise(got, want)
    assert_trees_bitwise(got, variables)
    # a template key the file lacks: both refuse it, with flax's message
    tmpl["params"]["extra"] = {"kernel": np.zeros(2, np.float32)}
    msgs = []
    for fn in (JR.load_weights, R.load_flax_msgpack):
        with pytest.raises(ValueError) as ei:
            fn(tmpl, f)
        msgs.append(str(ei.value))
    assert "extra" in msgs[1] and msgs[0].split(" at path")[0] == \
        msgs[1].split(" at path")[0]


def test_flax_msgpack_bf16_leaf_widens(tmp_path):
    import ml_dtypes
    tmpl = {"params": {"a": {"kernel": np.zeros((3, 4), np.float32)}}}
    vals = np.random.default_rng(0).standard_normal((3, 4)).astype(
        ml_dtypes.bfloat16)
    f = str(tmp_path / "bf.msgpack")
    JR.save_weights({"params": {"a": {"kernel": vals}}}, f)
    got = R.load_flax_msgpack(tmpl, f)["params"]["a"]["kernel"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, vals.astype(np.float32))


def test_flax_path_safetensors_equals_reference(tmp_path):
    template = _image_template("ResNet18", num_classes=10)
    variables = _seeded_like(template, 11)
    f = str(tmp_path / "w.safetensors")
    JR.save_safetensors(variables, f)
    got = R.load_safetensors(template, f)
    want = JR.load_safetensors(template, f)
    assert_trees_bitwise(got, {k: v for k, v in
                               _np_tree(want).items()})
    assert_trees_bitwise(got, variables)
    # strict: a missing key and a shape that differs raise alike
    for mutate in ("missing", "shape"):
        tmpl = json.loads(json.dumps(_shapes(template)))
        if mutate == "missing":
            tmpl["params"]["nowhere"] = {"kernel": [2]}
        else:
            tmpl["params"]["head"]["kernel"] = tmpl["params"]["head"][
                "kernel"][::-1]
        tmpl = _zeros(tmpl)
        msgs = []
        for fn in (JR.load_safetensors, R.load_safetensors):
            with pytest.raises(ValueError) as ei:
                fn(tmpl, f)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1], msgs


def test_save_safetensors_round_trips_with_the_reference(tmp_path):
    """The port's ``save_safetensors`` writes the reference's file: a
    seeded flax tree and a port model (through ``state_dict_to_flax``)
    saved by the port read back bitwise through the reference's
    ``load_safetensors``, and the reference's file reads back bitwise
    through the port's; a file that lacks a key raises "missing" in both
    loaders (tests/test_models.py's weight round trip, on a narrow
    ResNet)."""
    from sparkdl_tpu_torch.models import resnet, save_safetensors
    model = resnet.ResNet(stage_sizes=[1, 1, 1, 1], block=resnet.BasicBlock,
                          width=8, num_classes=10)
    template = R.state_dict_to_flax(model.state_dict())
    variables = _seeded_like(template, 12)
    f_port = str(tmp_path / "port.safetensors")
    save_safetensors(variables, f_port)
    assert_trees_bitwise(_np_tree(JR.load_safetensors(template, f_port)),
                         variables)
    f_ref = str(tmp_path / "ref.safetensors")
    JR.save_safetensors(variables, f_ref)
    assert_trees_bitwise(R.load_safetensors(template, f_port), variables)
    assert_trees_bitwise(R.load_safetensors(template, f_ref), variables)
    R.load_flax_variables(model, variables)
    f_model = str(tmp_path / "model.safetensors")
    save_safetensors(model, f_model)
    assert_trees_bitwise(_np_tree(JR.load_safetensors(template, f_model)),
                         variables)
    bad = str(tmp_path / "bad.safetensors")
    save_safetensors({"params": {"w": np.ones(2, np.float32)}}, bad)
    for load in (JR.load_safetensors, R.load_safetensors):
        with pytest.raises(ValueError, match="missing"):
            load(template, bad)


def _np_tree(t):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in t.items()}


def _shapes(t):
    return {k: _shapes(v) if isinstance(v, dict) else list(np.shape(v))
            for k, v in t.items()}


def _zeros(t):
    return {k: _zeros(v) if isinstance(v, dict) else
            np.zeros(tuple(v), np.float32) for k, v in t.items()}


@pytest.mark.parametrize("name,kw", [("ResNet18", {}), ("Xception", {}),
                                     ("InceptionV3", {}),
                                     ("VGG16", {"input_size": (32, 32)})])
def test_state_dict_to_flax_inverts_the_bridge(name, kw):
    """The port's template (its module's weights in flax layout) has the
    reference's variables' key paths and shapes, and
    ``flax_to_state_dict`` maps it back to the module's state dict."""
    import jax
    sd = R.get_model(name).init_params(**kw)
    tree = R.state_dict_to_flax(sd)
    back = R.flax_to_state_dict(tree)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    size = kw.get("input_size", R.get_model(name).input_size)
    jm = JR.get_model(name).build()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + tuple(size) + (3,)),
        train=False))
    want = {"/".join(str(getattr(p, "key", p)) for p in path): s.shape
            for path, s in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {"/".join(p): np.shape(v) for p, v in _leaves(tree)}
    assert got == want


def test_load_pretrained_dispatch_equals_reference(tmp_path):
    """``load_pretrained``: llama/bert names go to the HF importers, a
    ``.safetensors`` or ``.msgpack`` file of an image model to the native
    readers, with the registry model's own template by default; an .h5
    of a family with no Keras layout is refused alike."""
    from safetensors.numpy import save_file
    cfg, jcfg = L.LlamaConfig.tiny(), JL.LlamaConfig.tiny()
    f = str(tmp_path / "llama.safetensors")
    save_file(hf_llama_state(cfg, seed=12), f)
    assert_trees_bitwise(P.load_pretrained("llama", f, cfg=cfg),
                         JP.load_pretrained("llama", f, cfg=jcfg))
    fb = str(tmp_path / "bert.safetensors")
    save_file(hf_bert_state(B.BertConfig.tiny(), seed=13, num_classes=2),
              fb)
    assert_trees_bitwise(
        P.load_pretrained("bert", fb, cfg=B.BertConfig.tiny(),
                          num_classes=2),
        JP.load_pretrained("bert", fb, cfg=JB.BertConfig.tiny(),
                           num_classes=2))
    template = _image_template("ResNet18")
    variables = _seeded_like(template, 14)
    fm, fs = str(tmp_path / "r18.msgpack"), str(tmp_path / "r18.safetensors")
    JR.save_weights(variables, fm)
    JR.save_safetensors(variables, fs)
    for path in (fm, fs):
        assert_trees_bitwise(P.load_pretrained("ResNet18", path), variables)
    open(tmp_path / "r18.h5", "wb").close()
    raises_alike(lambda pkg: pkg.load_pretrained, "ResNet18",
                 str(tmp_path / "r18.h5"), template=template)


@pytest.mark.parametrize("pkg_name,pkg", PKGS)
def test_unrecognized_keras_layout_and_missing_layers(tmp_path, pkg_name,
                                                      pkg):
    import h5py
    f = str(tmp_path / "odd.h5")
    with h5py.File(f, "w") as h:
        h.create_group("something_else")
    with pytest.raises(pkg.CheckpointMismatch, match="unrecognized"):
        pkg.read_keras_h5(f)
    f2 = str(tmp_path / "legacy.h5")
    _legacy_vgg_h5(f2)
    with pytest.raises(pkg.CheckpointMismatch, match="no layer"):
        pkg.import_keras_resnet(f2, {"params": {}}, name="ResNet50")
    with pytest.raises(pkg.CheckpointMismatch, match="No Keras"):
        pkg.import_keras_resnet(f2, {"params": {}}, name="ResNet18")


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tied", [False, True])
def test_imported_llama_logits_match_jax(tied):
    cfg, jcfg = L.LlamaConfig.tiny(), JL.LlamaConfig.tiny()
    state = hf_llama_state(cfg, seed=15, lm_head=not tied)
    for k, v in state.items():  # keep the random logits O(1)
        if v.ndim == 2:
            state[k] = v / np.sqrt(v.shape[1])
    variables = P.import_hf_llama(state, cfg)
    ids = np.random.default_rng(0).integers(0, 512, (2, 19))
    want = np.asarray(JL.LlamaModel(jcfg, attn_fn=None).apply(
        JP.import_hf_llama(state, jcfg), jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = _port_llama(cfg, variables, attn_fn=None)(
            torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_imported_bert_logits_match_jax():
    cfg, jcfg = B.BertConfig.tiny(), JB.BertConfig.tiny()
    state = hf_bert_state(cfg, seed=16, num_classes=3)
    variables = P.import_hf_bert(state, cfg, num_classes=3)
    ids = np.random.default_rng(1).integers(0, 1000, (3, 12))
    mask = np.ones_like(ids)
    mask[0, 8:] = 0
    want = np.asarray(JB.BertForSequenceClassification(
        jcfg, num_classes=3, attn_fn=None).apply(
        JP.import_hf_bert(state, jcfg, num_classes=3),
        jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)))
    with torch.no_grad():
        model = B.load_flax_params(B.BertForSequenceClassification(
            cfg, num_classes=3, attn_fn=None, device="cpu"), variables)
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=BERT_TOL, atol=BERT_TOL)


def _image_df(pkg_mod, n=3, size=40, seed=2):
    import pyarrow as pa
    io = pkg_mod.image.imageIO
    rng = np.random.default_rng(seed)
    structs = [io.imageArrayToStruct(rng.integers(0, 256, (size, size, 3),
                                                  np.uint8))
               for _ in range(n)]
    return pkg_mod.DataFrame.fromArrow(
        pa.table({"image": pa.array(structs, type=io.imageSchema)}))


def _features(pkg_mod, path, model="ResNet18", **kw):
    feat = pkg_mod.DeepImageFeaturizer(inputCol="image",
                                       outputCol="features",
                                       modelName=model, batchSize=4,
                                       weightsPath=path, **kw)
    rows = feat.transform(_image_df(pkg_mod)).collect()
    return np.stack([np.asarray(r.features, np.float32) for r in rows])


def assert_f32_close(got, ref):
    """The f32 feature rule of ``test_torch_image_models``."""
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("fmt", ["msgpack", "safetensors"])
def test_featurizer_reads_native_weight_files_as_the_reference(tmp_path,
                                                               fmt):
    import sparkdl_tpu as sdl
    import sparkdl_tpu_torch as tdl
    template = _image_template("ResNet18")
    variables = _seeded_like(template, 17)
    for leaf in ("var",):  # BatchNorm variances stay positive
        for path, v in list(_leaves(variables)):
            if path[-1] == leaf:
                node = variables
                for k in path[:-1]:
                    node = node[k]
                node[leaf] = np.abs(v) + 0.5
    f = str(tmp_path / f"r18.{fmt}")
    (JR.save_weights if fmt == "msgpack" else JR.save_safetensors)(
        variables, f)
    got = _features(tdl, f, device="cpu")
    want = _features(sdl, f)
    assert got.shape == want.shape == (3, 512)
    assert_f32_close(got, want)


def test_new_modules_import_no_jax(tmp_path):
    """The modules and scripts of the offline readers and the importers
    import with ``jax``, ``flax`` and ``sparkdl_tpu`` blocked."""
    code = f"""
import importlib, importlib.util, sys
for m in ("jax", "jaxlib", "flax", "sparkdl_tpu"):
    sys.modules[m] = None
sys.path.insert(0, {_REPO!r})
for m in ("sparkdl_tpu_torch", "sparkdl_tpu_torch.runner.analysis",
          "sparkdl_tpu_torch.runner.traceview",
          "sparkdl_tpu_torch.models.pretrained",
          "sparkdl_tpu_torch.models.registry",
          "sparkdl_tpu_torch.transformers.named_image"):
    importlib.import_module(m)
for s in ("torch_request_report", "torch_bottleneck_report",
          "torch_trace_export"):
    spec = importlib.util.spec_from_file_location(
        s, {_REPO!r} + "/scripts/" + s + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import torch
assert not torch.cuda.is_initialized()
print("ok")
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd=str(tmp_path))
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr[-2000:]


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_hf_writers_invert_the_importers():
    """``chip_smoke.py``'s phase r writes HF files of seeded port models;
    its writers are the exact inverses of both packages' importers, and
    (where ``transformers`` is installed) their names and shapes are HF's
    own."""
    cs = _chip_smoke()
    cfg = L.LlamaConfig.tiny()
    model = L.LlamaModel(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    state = cs.hf_llama_state(torch, model, torch.float32)
    want = {"params": L.flax_params(model)}
    assert_trees_bitwise(P.import_hf_llama(state, cfg), want)
    assert_trees_bitwise(JP.import_hf_llama(
        {k: v.numpy() for k, v in state.items()}, JL.LlamaConfig.tiny()),
        want)
    bf16 = cs.hf_llama_state(torch, model, torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in bf16.values())
    assert_trees_bitwise(P.import_hf_llama(bf16, cfg), P.import_hf_llama(
        {k: v.float() for k, v in bf16.items()}, cfg))
    bcfg = B.BertConfig.tiny()
    bert = B.BertForSequenceClassification(
        bcfg, num_classes=2, device="cpu",
        generator=torch.Generator().manual_seed(6))
    bstate = cs.hf_bert_state(torch, bert)
    assert_trees_bitwise(P.import_hf_bert(bstate, bcfg, num_classes=2),
                         {"params": B.flax_params(bert)})
    try:
        import transformers as tr
    except ImportError:
        return
    hf = tr.LlamaForCausalLM(tr.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads,
        intermediate_size=cfg.intermediate_size, rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_norm_eps, tie_word_embeddings=False))
    hf.load_state_dict(state, strict=True)
    ids = torch.tensor([[3, 14, 15, 92, 6]])
    model.attn_fn = None
    with torch.no_grad():
        np.testing.assert_allclose(hf.eval()(ids).logits.numpy(),
                                   model(ids).numpy(), rtol=2e-4,
                                   atol=2e-4)
    hb = tr.BertForSequenceClassification(
        _hf_bert_cfg(tr, bcfg, num_labels=2, hidden_act="gelu"))
    missing, unexpected = hb.load_state_dict(bstate, strict=False)
    assert not unexpected and all("position_ids" in k for k in missing)


def test_chip_smoke_keras_writer_inverts_the_importer(tmp_path):
    """Phase r's keras-applications ``.h5`` writer: both packages' Keras
    importers read back the port ResNet50's own tree, bitwise."""
    from sparkdl_tpu_torch.models import resnet
    cs = _chip_smoke()
    src = resnet.ResNet50(num_classes=1000, seed=3)
    f = str(tmp_path / "r50.h5")
    cs.keras_resnet50_h5(src, f)
    want = R.state_dict_to_flax(src.state_dict())
    assert_trees_bitwise(P.load_pretrained("ResNet50", f), want)
    assert_trees_bitwise(JP.load_pretrained("ResNet50", f, template=want),
                         want)
