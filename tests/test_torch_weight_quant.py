"""int8 projection weights in the port (``models.llama.quantize_params``,
the int8 base of ``LoRADense``, ``GenerationEngine.from_model(...,
weight_dtype="int8")``) held against the JAX package's ``QuantDense`` /
``quantize_params`` on the CPU.

What is held, from the same f32 weights (``LlamaConfig.tiny()``, drawn by
the reference and carried across by ``load_flax_params``):

- the codes and scales equal the reference's bitwise (both compute in f32,
  ``round`` half to even);
- the int8 model's logits equal the reference int8 model's within 2e-5
  (f32 products in another order), and track the f32 model within the
  reference test's absmax error (atol 0.15, rtol 0.1). No test asserts
  that the greedy argmax survives quantization: on the tiny model it flips
  on one row of two in the reference itself;
- a quantized model given float weights runs the float path, bitwise the
  f32 model's;
- the engine's int8 streams (``weight_dtype="int8"`` and
  ``SPARKDL_SERVE_WEIGHT_DTYPE``), paged and unpaged, equal the port's
  int8 ``generate()`` token for token;
- the reference's guards (an unknown weight or KV mode raises).
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as JL
from sparkdl_tpu_torch import GenerationEngine
from sparkdl_tpu_torch.models import llama as L

ROOT = Path(__file__).resolve().parent.parent
INT8_ATOL = 2e-5


@pytest.fixture(scope="module")
def ref():
    cfg = JL.LlamaConfig.tiny()
    model = JL.LlamaModel(cfg)
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), np.zeros((1, 4), np.int32)))
    return cfg, model, variables


def _port(variables, quant=False):
    m = L.LlamaModel(L.LlamaConfig.tiny(), device="cpu")
    L.load_flax_params(m, variables)
    return L.quantize_params(m, "int8") if quant else m


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _ids(cfg):
    return np.random.RandomState(3).randint(0, cfg.vocab_size,
                                            (2, 6)).astype(np.int32)


def test_quantize_params_targets_and_shapes(ref):
    """The twin of ``TestWeightQuant.test_quantize_params_targets_and_
    shapes``: the seven projections of every layer hold int8 codes and an
    ``[out]`` scale; embed, norms and lm_head stay float; the port's tree
    has the reference's leaves, dtypes and shapes."""
    _, _, variables = ref
    model = _port(variables, quant=True)
    assert model.weight_quant == "int8"
    seen = set()
    for name, mod in model.named_modules():
        if isinstance(mod, L.LoRADense):
            proj = name.rsplit(".", 1)[-1]
            seen.add(proj)
            assert proj in L.WEIGHT_QUANT_TARGETS
            assert mod.base.weight.dtype == torch.int8
            assert mod.base.weight_scale.shape == (mod.base.weight.shape[0],)
            assert mod.base.weight_scale.dtype == torch.float32
    assert seen == set(L.WEIGHT_QUANT_TARGETS) == set(JL.WEIGHT_QUANT_TARGETS)
    for t in (model.embed_tokens.weight, model.lm_head.weight,
              model.final_norm.scale):
        assert t.dtype == torch.float32
    want = dict(_flat(JL.quantize_params(variables["params"], "int8")))
    got = dict(_flat(L.flax_params(model)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype and got[path].shape == w.shape, path


def test_codes_and_scales_equal_the_reference_bitwise(ref):
    """From the same f32 weights, plus a projection with an all-zero
    output channel (scale 1) and one whose quotients land on .5 (half to
    even): codes and scales bitwise the reference's."""
    _, _, variables = ref
    params = jax.tree_util.tree_map(np.array, variables["params"])
    k = params["layer_0"]["attn"]["q_proj"]["base"]["kernel"]
    k[:, 3] = 0.0                                 # an all-zero channel
    k[:, 5] = np.array([127.0, 0.5, 1.5, -2.5] * (k.shape[0] // 4),
                       np.float32)                # s = 1: ties at .5
    model = L.LlamaModel(L.LlamaConfig.tiny(), device="cpu")
    L.quantize_params(L.load_flax_params(model, params), "int8")
    want = dict(_flat(JL.quantize_params(params, "int8")))
    got = dict(_flat(L.flax_params(model)))
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg="/".join(path))
    q = got[("layer_0", "attn", "q_proj", "base", "kernel")]
    s = got[("layer_0", "attn", "q_proj", "base", "kernel_scale")]
    assert s[3] == 1.0 and not q[:, 3].any()
    assert q[:4, 5].tolist() == [127, 0, 2, -2]


def test_int8_forward_close_to_f32_and_float_params_exact(ref):
    """The twin of ``TestWeightQuant.test_int8_forward_close_to_f32_and_
    float_params_exact``, held as port int8 against reference int8: the
    logits within INT8_ATOL of the reference's int8 logits and within the
    reference's absmax error of the f32 model; the quantized model fed the
    unconverted float tree runs the float path, bitwise the f32 model.
    The argmax is not asserted (see the module doc)."""
    cfg, model, variables = ref
    ids = _ids(cfg)
    jq = np.asarray(model.clone(weight_quant="int8").apply(
        {"params": JL.quantize_params(variables["params"], "int8")}, ids))
    port_f32 = _port(variables)
    f32 = port_f32(torch.from_numpy(ids).long()).detach().numpy()
    qmodel = _port(variables, quant=True)
    got = qmodel(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_allclose(got, jq, atol=INT8_ATOL, rtol=0)
    assert np.allclose(got, f32, atol=0.15, rtol=0.1)
    assert np.abs(got - f32).max() > 0  # the int8 path ran
    L.load_flax_params(qmodel, variables)          # float tree back in
    assert qmodel.weight_quant is None
    assert qmodel.layers[0].mlp.up_proj.base.weight.dtype == torch.float32
    exact = qmodel(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_array_equal(exact, f32)


def test_quantized_tree_loads_and_round_trips(ref):
    """``load_flax_params`` of the reference's quantized tree gives int8
    bases whose logits equal the port's own quantization's bitwise;
    ``flax_params`` writes the same tree back."""
    cfg, _, variables = ref
    qtree = JL.quantize_params(variables["params"], "int8")
    loaded = L.load_flax_params(
        L.LlamaModel(L.LlamaConfig.tiny(), device="cpu"), qtree)
    assert loaded.weight_quant == "int8"
    ids = torch.from_numpy(_ids(cfg)).long()
    np.testing.assert_array_equal(
        loaded(ids).detach().numpy(),
        _port(variables, quant=True)(ids).detach().numpy())
    back = dict(_flat(L.flax_params(loaded)))
    for path, w in _flat(qtree):
        np.testing.assert_array_equal(back[path], w)


def test_bf16_int8_forward_order_matches_the_reference(ref):
    """bf16 compute: the product in bf16, the scale in f32, cast back —
    the reference's order. Logits within 2^-5 of the largest reference
    logit: bf16 rounding through two layers in another order (read on
    the CPU: 0.079 of 3.6 with int8 weights, 0.026 between the two
    packages' float bf16 models)."""
    cfg, model, variables = ref
    ids = _ids(cfg)
    jq = np.asarray(JL.LlamaModel(cfg, dtype=jnp.bfloat16,
                                  weight_quant="int8").apply(
        {"params": JL.quantize_params(variables["params"], "int8")}, ids))
    m = L.LlamaModel(L.LlamaConfig.tiny(), dtype=torch.bfloat16,
                     device="cpu")
    L.quantize_params(L.load_flax_params(m, variables), "int8")
    got = m(torch.from_numpy(ids).long()).detach().float().numpy()
    assert np.abs(got - jq).max() <= 2 ** -5 * np.abs(jq).max()


def test_quant_guards():
    """The reference's guards: an unknown weight mode raises its
    ``ValueError`` (model and engine), an unknown KV mode lists what is
    available, a quantized KV pool without paging raises."""
    model = L.LlamaModel(L.LlamaConfig.tiny(), device="cpu")
    with pytest.raises(ValueError, match="unsupported weight quant dtype"):
        L.quantize_params(model, "int4")
    with pytest.raises(ValueError, match="int8 only"):
        GenerationEngine.from_model(model, device="cpu", num_slots=1,
                                    max_len=32, weight_dtype="fp8")
    assert model.weight_quant is None  # nothing was converted
    with pytest.raises(ValueError, match="available"):
        L.kv_quant_spec("int4")
    from sparkdl_tpu_torch.serving.backend import PagedLlamaSlotBackend
    with pytest.raises(ValueError, match="int4"):
        PagedLlamaSlotBackend(model, 1, 32, kv_dtype="int4")
    with pytest.raises(ValueError, match="paged"):
        GenerationEngine.from_model(model, device="cpu", num_slots=1,
                                    max_len=32, kv_dtype="int8")


@pytest.mark.parametrize("how", ["kwarg_paged", "env_paged",
                                 "kwarg_unpaged"])
def test_engine_int8_streams_equal_int8_generate(ref, how, monkeypatch):
    """The int8 engine (paged with chunked prefill, or unpaged) serves the
    same greedy streams as the port's int8 ``generate()``, prompt by
    prompt; the engine quantized the model it was given."""
    _, _, variables = ref
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 512, n).tolist() for n in (5, 17, 9, 30)]
    want = []
    base = _port(variables, quant=True)
    for p in prompts:
        ids, pads = L.left_pad_prompts([p])
        want.append(L.generate(base, ids, 6, pad_lens=pads)[0].tolist()
                    [len(p):])
    model = _port(variables)
    kw = dict(num_slots=3, max_len=64, device="cpu")
    if "paged" in how and "unpaged" not in how:
        kw.update(block_size=8, prefill_chunk=8)
    if how.startswith("env"):
        monkeypatch.setenv("SPARKDL_SERVE_WEIGHT_DTYPE", "int8")
    else:
        kw["weight_dtype"] = "int8"
    eng = GenerationEngine.from_model(model, **kw)
    assert eng.backend.weight_dtype == "int8" == model.weight_quant
    hs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_until_idle()
    assert [h.result(1) for h in hs] == want


def test_projection_bytes_count_codes_and_scales(ref):
    """``projection_bytes``: 4 bytes a weight in f32, 1 a code plus 4 an
    output channel once quantized."""
    _, _, variables = ref
    model = _port(variables)
    n_w = sum(m.base.weight.numel() for _, m in L._projections(model))
    n_out = sum(m.base.weight.shape[0] for _, m in L._projections(model))
    assert L.projection_bytes(model) == 4 * n_w
    L.quantize_params(model, "int8")
    assert L.projection_bytes(model) == n_w + 4 * n_out


def test_port_transformers_import_without_pyarrow():
    """A fresh interpreter with pyarrow and pandas blocked imports
    ``sparkdl_tpu_torch`` and its ``transformers`` (the feature stages
    load pyarrow when they run, not at import)."""
    code = (
        "import sys\n"
        "class B:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('pyarrow', 'pandas', 'jax'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, B())\n"
        "import sparkdl_tpu_torch as s\n"
        "import sparkdl_tpu_torch.transformers as t\n"
        "from sparkdl_tpu_torch.core import tuning\n"
        "assert t.VectorAssembler and t.StringIndexer and tuning\n"
        "assert s.ByteBPETokenizer and s.MulticlassClassificationEvaluator\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('pyarrow', 'pandas', 'jax')]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
