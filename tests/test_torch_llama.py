"""The port's Llama (``sparkdl_tpu_torch.models.llama``) against the JAX
package's, on the CPU, at ``LlamaConfig.tiny()``.

The JAX model is initialised from a seed, its parameters are carried
into the port as numpy arrays (``load_flax_params``), and the same token
ids go through both. The JAX flash arm runs its Pallas kernels in
interpret mode; the port's flash arm runs the kernels' plain PyTorch
versions (CPU tensors). Logits are held at atol/rtol 1e-4 in f32 (two
layers of f32 matmuls in different summation orders); greedy tokens and
decode step counts are held exactly.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash
from sparkdl_tpu_torch.models import llama as L
from sparkdl_tpu_torch.ops import flash_attention as fa
from sparkdl_tpu_torch.ops import flash_decode as fd
from sparkdl_tpu_torch.utils import platform

ROOT = Path(__file__).resolve().parent.parent
PROMPTS = [[5, 6, 7], [9, 3, 2, 8, 1, 4, 4, 7, 2, 9, 11],
           [17, 2, 30, 41, 7, 6]]
MAX_NEW = 6
LOGIT_TOL = 1e-4


def _np_tree(tree):
    return {k: _np_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_params(cfg, seed=0):
    """Seeded JAX init, with the zero-initialised LoRA B perturbed so the
    adapter path carries signal."""
    ids = jnp.zeros((1, 4), jnp.int32)
    params = _np_tree(JL.LlamaModel(cfg, attn_fn=None).init(
        jax.random.PRNGKey(seed), ids)["params"])
    rng = np.random.default_rng(seed)
    for path, leaf in _flat(params):
        if "lora_b" in path:
            node = params
            for k in path[:-1]:
                node = node[k]
            node[path[-1]] = (0.02 * rng.standard_normal(leaf.shape)).astype(
                leaf.dtype)
    return params


def _port(cfg, params, attn_fn):
    return L.load_flax_params(
        L.LlamaModel(cfg, attn_fn=attn_fn, device="cpu"), params)


@pytest.fixture(scope="module")
def tiny():
    cfg = L.LlamaConfig.tiny()
    jcfg = JL.LlamaConfig.tiny()
    params = _jax_params(jcfg)
    ids, pads = JL.left_pad_prompts(PROMPTS)
    return dict(
        cfg=cfg, params=params, ids=ids, pads=pads,
        jax={"flash": JL.LlamaModel(jcfg, attn_fn=jax_flash),
             "dense": JL.LlamaModel(jcfg, attn_fn=None)},
        port={"flash": _port(cfg, params, fa.flash_attention),
              "dense": _port(cfg, params, None)},
        jax_out={})


def _jax_generate(tiny, arm, ids, pads, **kw):
    """JAX generate(), memoised per (arm, inputs, kwargs) for the module."""
    key = (arm, ids.tobytes(), ids.shape, pads.tobytes(),
           tuple(sorted(kw.items())))
    if key not in tiny["jax_out"]:
        out = JL.generate(tiny["jax"][arm], {"params": tiny["params"]}, ids,
                          MAX_NEW, pad_lens=pads, return_steps=True, **kw)
        tiny["jax_out"][key] = (np.asarray(out[0]), int(out[1]))
    return tiny["jax_out"][key]


@pytest.mark.parametrize("rank", [0, 4])
def test_load_flax_params_round_trip_is_bit_exact(rank):
    cfg = L.LlamaConfig.tiny(lora_rank=rank)
    params = _jax_params(JL.LlamaConfig.tiny(lora_rank=rank), seed=rank)
    model = L.load_flax_params(L.LlamaModel(cfg, device="cpu"),
                               {"params": params})
    back = L.flax_params(model)
    want, got = dict(_flat(params)), dict(_flat(back))
    assert set(got) == set(want)
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype and got[path].shape == arr.shape
        np.testing.assert_array_equal(got[path], arr, err_msg=str(path))
    # Dense [in, out] became Linear.weight [out, in]
    q = model.layers[0].attn.q_proj.base.weight
    np.testing.assert_array_equal(
        q.detach().numpy(), params["layer_0"]["attn"]["q_proj"]["base"][
            "kernel"].T)


def test_load_flax_params_rejects_missing_and_unexpected():
    cfg = L.LlamaConfig.tiny()
    params = _jax_params(JL.LlamaConfig.tiny())
    model = L.LlamaModel(cfg, device="cpu")
    extra = dict(params, stray={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        L.load_flax_params(model, extra)
    missing = {k: v for k, v in params.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        L.load_flax_params(model, missing)
    lora = _jax_params(JL.LlamaConfig.tiny(lora_rank=4))
    with pytest.raises(ValueError, match="unexpected"):
        L.load_flax_params(model, lora)


@pytest.mark.parametrize("rank", [0, 4])
@pytest.mark.parametrize("arm", ["flash", "dense"])
def test_training_forward_logits_match_jax(rank, arm):
    """The no-cache forward (causal self-attention) through the port's
    flash arm and its dense arm, against the JAX dense forward."""
    params = _jax_params(JL.LlamaConfig.tiny(lora_rank=rank), seed=rank + 1)
    ids = np.random.default_rng(rank).integers(0, 512, (2, 23)).astype(
        np.int32)
    want = np.asarray(JL.LlamaModel(JL.LlamaConfig.tiny(lora_rank=rank),
                                    attn_fn=None).apply(
        {"params": params}, jnp.asarray(ids)))
    model = _port(L.LlamaConfig.tiny(lora_rank=rank), params,
                  fa.flash_attention if arm == "flash" else None)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 23, 512)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("arm", ["flash", "dense"])
def test_left_padded_prefill_logits_match_jax_flash(tiny, arm):
    ids, pads = tiny["ids"], tiny["pads"]
    jm = tiny["jax"]["flash"]
    max_len = ids.shape[1] + MAX_NEW
    want, _ = JL._prefill(jm, tiny["params"], jnp.asarray(ids),
                          JL.init_cache(jm, ids.shape[0], max_len),
                          jnp.asarray(pads))
    model = tiny["port"][arm]
    cache = L.init_cache(model, ids.shape[0], max_len)
    got = L._prefill(model, torch.from_numpy(ids).long(), cache,
                     torch.from_numpy(pads))
    assert cache.idx == ids.shape[1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


@pytest.mark.parametrize("eos", [False, True])
@pytest.mark.parametrize("arm", ["flash", "dense"])
def test_generate_greedy_tokens_match_jax(tiny, arm, eos):
    """Mixed-length left-padded prompts; with eos_id, one row stops early
    and the step count must match too."""
    ids, pads = tiny["ids"], tiny["pads"]
    kw = {}
    if eos:
        free, _ = _jax_generate(tiny, arm, ids, pads)
        kw["eos_id"] = int(free[0, ids.shape[1] + 1])
    want, want_steps = _jax_generate(tiny, arm, ids, pads, **kw)
    got, steps = L.generate(tiny["port"][arm], ids, MAX_NEW, pad_lens=pads,
                            return_steps=True, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert steps == want_steps


def test_generate_eos_early_exit_matches_jax(tiny):
    """One row whose eos arrives as its third token: both loops stop
    after two steps (the step that sampled eos is the last) and fill the
    rest with eos."""
    ids, pads = JL.left_pad_prompts(PROMPTS[:1])
    free, _ = _jax_generate(tiny, "flash", ids, pads)
    eos = int(free[0, ids.shape[1] + 2])
    want, want_steps = _jax_generate(tiny, "flash", ids, pads, eos_id=eos)
    got, steps = L.generate(tiny["port"]["flash"], ids, MAX_NEW,
                            pad_lens=pads, eos_id=eos, return_steps=True)
    assert (want_steps, steps) == (2, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_flash_and_dense_arms_agree_with_each_other(tiny):
    ids, pads = tiny["ids"], tiny["pads"]
    outs = [L.generate(tiny["port"][arm], ids, MAX_NEW, pad_lens=pads)
            for arm in ("flash", "dense")]
    assert torch.equal(*outs)


def test_generate_routes_through_both_kernels(tiny, monkeypatch):
    """The flash arm sends the prefill through flash_attention once a
    layer and every decode step through flash_decode once a layer (on the
    CPU, through the kernels' plain versions: the same count the launch
    counters show on the card)."""
    calls = {"prefill": 0, "decode": 0}
    real_fwd, real_dec = fa.flash_attention_fwd, fd.flash_decode_plain

    def fwd(*a, **kw):
        calls["prefill"] += 1
        return real_fwd(*a, **kw)

    def dec(*a, **kw):
        calls["decode"] += 1
        return real_dec(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fd, "flash_decode_plain", dec)
    ids, pads = tiny["ids"], tiny["pads"]
    _, steps = L.generate(tiny["port"]["flash"], ids, MAX_NEW, pad_lens=pads,
                          return_steps=True)
    layers = tiny["cfg"].num_layers
    assert calls == {"prefill": layers, "decode": layers * steps}
    calls.update(prefill=0, decode=0)
    L.generate(tiny["port"]["dense"], ids, MAX_NEW, pad_lens=pads)
    assert calls == {"prefill": 0, "decode": 0}
    monkeypatch.setenv("SPARKDL_FLASH_DECODE", "0")
    L.generate(tiny["port"]["flash"], ids, MAX_NEW, pad_lens=pads)
    assert calls == {"prefill": layers, "decode": 0}


def test_kernel_limits_never_reroute_to_dense(tiny, monkeypatch):
    """The kernels' limits (``support_reason``) are checked inside the
    wrappers, which raise on a CUDA tensor; the model and the "auto"
    attention never consult them to pick dense attention instead. Here
    both reasons reject everything, and the adaptive arm still goes
    through both wrappers (their plain versions, on the CPU)."""
    calls = {"prefill": 0, "decode": 0}
    real_fwd, real_dec = fa.flash_attention_fwd, fd.flash_decode_plain

    def fwd(*a, **kw):
        calls["prefill"] += 1
        return real_fwd(*a, **kw)

    def dec(*a, **kw):
        calls["decode"] += 1
        return real_dec(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fd, "flash_decode_plain", dec)
    monkeypatch.setattr(fa, "support_reason", lambda *a: "rejected")
    monkeypatch.setattr(fd, "support_reason", lambda *a: "rejected")
    monkeypatch.delenv("SPARKDL_FLASH_DECODE", raising=False)
    monkeypatch.delenv("SPARKDL_FLASH_MIN_SEQ", raising=False)
    model = tiny["port"]["flash"]
    monkeypatch.setattr(model, "attn_fn", fa.adaptive_attention)
    got, steps = L.generate(model, tiny["ids"], MAX_NEW,
                            pad_lens=tiny["pads"], return_steps=True)
    layers = tiny["cfg"].num_layers
    assert calls == {"prefill": layers, "decode": layers * steps}
    want = L.generate(tiny["port"]["dense"], tiny["ids"], MAX_NEW,
                      pad_lens=tiny["pads"])
    assert torch.equal(got, want)


def test_top_k_1_equals_greedy(tiny):
    ids, pads = tiny["ids"], tiny["pads"]
    model = tiny["port"]["flash"]
    greedy = L.generate(model, ids, MAX_NEW, pad_lens=pads)
    g = torch.Generator().manual_seed(3)
    sampled = L.generate(model, ids, MAX_NEW, temperature=0.9, top_k=1,
                         generator=g, pad_lens=pads)
    assert torch.equal(greedy, sampled)


def test_sampling_stays_in_its_support():
    """Sampling is held by support: top-k draws only the k best tokens,
    top-p only the smallest prefix reaching p, and a seeded generator
    repeats its draws."""
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 50)).astype(np.float32))
    top3 = logits.topk(3, dim=-1).indices
    g = torch.Generator().manual_seed(0)
    for _ in range(8):
        tok = L._sample(logits, g, 1.0, top_k=3)
        assert (top3 == tok[:, None]).any(-1).all()
    peaked = logits.clone()
    peaked[:, 7] = 50.0
    assert torch.all(L._sample(peaked, g, 1.0, top_p=0.5) == 7)
    a = L._sample(logits, torch.Generator().manual_seed(5), 0.7)
    b = L._sample(logits, torch.Generator().manual_seed(5), 0.7)
    assert torch.equal(a, b)
    assert torch.equal(L._sample(logits, g, 0.0), logits.argmax(-1))


def test_generate_validates_arguments(tiny):
    model, ids = tiny["port"]["dense"], tiny["ids"]
    with pytest.raises(ValueError, match="top_p"):
        L.generate(model, ids, 2, temperature=0.5, top_p=0.0)
    with pytest.raises(ValueError, match="top_k"):
        L.generate(model, ids, 2, top_k=-1)
    with pytest.raises(TypeError, match="eos_id"):
        L.generate(model, ids, 2, eos_id=True)
    with pytest.raises(ValueError, match="pad_to"):
        L.generate(model, ids, 5, pad_to=ids.shape[1] + 2)
    out = L.generate(model, ids, 2, pad_to=ids.shape[1] + 9)
    assert out.shape == (ids.shape[0], ids.shape[1] + 2)
    with pytest.raises(ValueError, match="pad_lens"):
        model(torch.from_numpy(ids).long(),
              pad_lens=torch.from_numpy(tiny["pads"]))
    cache = L.init_cache(model, ids.shape[0], ids.shape[1])
    cache.idx = ids.shape[1]
    with pytest.raises(ValueError, match="overflow"):
        model(torch.from_numpy(ids).long()[:, :1], cache=cache)
    cache = L.init_cache(model, ids.shape[0], ids.shape[1] + 4)
    cache.idx = 1
    with pytest.raises(ValueError, match="slot 0"):
        model(torch.from_numpy(ids).long()[:, :3], cache=cache,
              first_chunk=True)


def test_left_pad_prompts_matches_jax():
    ids, pads = L.left_pad_prompts(PROMPTS, pad_id=9, pad_to=14)
    jids, jpads = JL.left_pad_prompts(PROMPTS, pad_id=9, pad_to=14)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(pads.numpy(), jpads)
    with pytest.raises(ValueError, match="pad_to"):
        L.left_pad_prompts(PROMPTS, pad_to=3)
    with pytest.raises(ValueError, match="at least one"):
        L.left_pad_prompts([[1], []])


def test_entry_points_raise_without_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        platform.resolve_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        L.LlamaModel(L.LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        L.LlamaModel(L.LlamaConfig.tiny(), device="cuda")
    assert platform.resolve_device("cpu") == torch.device("cpu")
    assert not platform.is_cuda_backend() and not platform.is_hopper()
    assert L.LlamaModel(L.LlamaConfig.tiny(), device="cpu").device.type == \
        "cpu"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax") or top == "sparkdl_tpu"


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted(f for f in (ROOT / "sparkdl_tpu_torch").rglob("*.py")
                   if "_build" not in f.parts)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 8
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"sparkdl_tpu_torch/models/bert.py",
            "sparkdl_tpu_torch/models/pretrained.py",
            "sparkdl_tpu_torch/core/frame.py",
            "sparkdl_tpu_torch/udf/registry.py",
            "sparkdl_tpu_torch/runner/data.py",
            "sparkdl_tpu_torch/runner/failures.py",
            "sparkdl_tpu_torch/runner/launcher.py",
            "sparkdl_tpu_torch/runner/api.py",
            "sparkdl_tpu_torch/core/params.py",
            "sparkdl_tpu_torch/core/pipeline.py",
            "sparkdl_tpu_torch/core/ingest.py",
            "sparkdl_tpu_torch/native.py",
            "sparkdl_tpu_torch/image/imageIO.py",
            "sparkdl_tpu_torch/models/image_layers.py",
            "sparkdl_tpu_torch/models/resnet.py",
            "sparkdl_tpu_torch/models/inception.py",
            "sparkdl_tpu_torch/models/vgg.py",
            "sparkdl_tpu_torch/models/xception.py",
            "sparkdl_tpu_torch/models/registry.py",
            "sparkdl_tpu_torch/transformers/payloads.py",
            "sparkdl_tpu_torch/transformers/streaming.py",
            "sparkdl_tpu_torch/transformers/xla_image.py",
            "sparkdl_tpu_torch/transformers/named_image.py",
            "sparkdl_tpu_torch/estimators/logistic_regression.py"} <= names
    bad = [(str(f.relative_to(ROOT)), n) for f in files for n in _imports(f)
           if _forbidden(n)]
    assert bad == []
    # the guard matches sparkdl_tpu exactly, not the port's own prefix
    assert _forbidden("sparkdl_tpu") and _forbidden("sparkdl_tpu.ops")
    assert not _forbidden("sparkdl_tpu_torch.ops")


def test_importing_the_port_loads_no_jax():
    """In a fresh interpreter, importing every module of the port (and
    building nothing), then serving requests through a CPU engine (paged,
    speculative, int8 pool), leaves jax, flax and the JAX package
    unloaded."""
    mods = sorted(
        ".".join(f.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for f in (ROOT / "sparkdl_tpu_torch").rglob("*.py")
        if "_build" not in f.parts)
    assert {"sparkdl_tpu_torch.serving.backend",
            "sparkdl_tpu_torch.models.bert", "sparkdl_tpu_torch.core.frame",
            "sparkdl_tpu_torch.udf.registry",
            "sparkdl_tpu_torch.runner.failures",
            "sparkdl_tpu_torch.runner.launcher",
            "sparkdl_tpu_torch.runner.api",
            "sparkdl_tpu_torch.core.pipeline",
            "sparkdl_tpu_torch.image.imageIO",
            "sparkdl_tpu_torch.models.registry",
            "sparkdl_tpu_torch.transformers.named_image",
            "sparkdl_tpu_torch.estimators.logistic_regression"} <= set(mods)
    code = (f"import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"from sparkdl_tpu_torch import GenerationEngine\n"
            f"from sparkdl_tpu_torch.models import llama as L\n"
            f"from sparkdl_tpu_torch.ops import flash_attention as fa\n"
            f"m = L.LlamaModel(L.LlamaConfig.tiny(), "
            f"attn_fn=fa.flash_attention, device='cpu')\n"
            f"for kw in ({{}}, dict(block_size=8, spec_k=2, "
            f"kv_dtype='int8')):\n"
            f"    e = GenerationEngine.from_model(m, num_slots=2, "
            f"max_len=64, device='cpu', **kw)\n"
            f"    h = e.submit([5, 6, 7, 5, 6], max_new_tokens=4)\n"
            f"    e.run_until_idle()\n"
            f"    assert len(h.result(1)) == 4\n"
            f"from sparkdl_tpu_torch.models import bert as B\n"
            f"from sparkdl_tpu_torch.udf import classify_rows\n"
            f"c = B.BertForSequenceClassification(B.BertConfig.tiny(), "
            f"attn_fn=fa.flash_attention, device='cpu')\n"
            f"assert len(classify_rows(c, [[1, 2], [3]], 2)) == 2\n"
            f"import numpy as np, sparkdl_tpu_torch as tdl\n"
            f"from sparkdl_tpu_torch.image import imageIO\n"
            f"import pyarrow as pa\n"
            f"df = tdl.DataFrame.fromArrow(pa.table({{'image': pa.array("
            f"[imageIO.imageArrayToStruct(np.full((8, 8, 3), i, np.uint8)) "
            f"for i in range(3)], type=imageIO.imageSchema)}}))\n"
            f"f = tdl.DeepImageFeaturizer(inputCol='image', "
            f"outputCol='f', modelName='ResNet18', batchSize=2, "
            f"device='cpu')\n"
            f"assert len(f.transform(df).collect()) == 3\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"('jax', 'jaxlib', 'flax', 'sparkdl_tpu')]\n"
            f"print(len({mods!r}), bad)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split(None, 1)[1].strip() == "[]", res.stdout


def test_port_imports_without_pyarrow():
    """With pyarrow and pandas blocked, the package, BERT, the runner, the
    kernels' wrappers, the UDF registry, the image featurizer and the
    logistic regression import, and a BERT fit, ``classify_rows``, a CPU
    featurizer runner over uint8 BGR batches and ``_fit_arrays`` run on
    the CPU: the card path needs no DataFrame.
    ``sparkdl_tpu_torch.DataFrame`` is what raises."""
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import numpy as np\n"
        "import sparkdl_tpu_torch\n"
        "from sparkdl_tpu_torch.models import bert as B\n"
        "from sparkdl_tpu_torch import runner, ops, udf\n"
        "from sparkdl_tpu_torch.ops import flash_attention as fa\n"
        "from sparkdl_tpu_torch.runner.train_state import adam\n"
        "m = B.BertForSequenceClassification(B.BertConfig.tiny(), "
        "attn_fn=fa.flash_attention, device='cpu')\n"
        "batch = {'input_ids': np.ones((2, 8), np.int64), "
        "'attention_mask': np.ones((2, 8), np.int32), "
        "'label': np.array([0, 1])}\n"
        "runner.XlaRunner(np=1, device='cpu').run(lambda ctx: ctx.fit("
        "loss_fn=B.bert_finetune_loss(m), model=m, tx=adam(1e-3), "
        "data=[batch] * 2, num_steps=2, with_rng=True))\n"
        "assert len(udf.classify_rows(m, [[1, 2, 3], [4]], 3)) == 2\n"
        "from sparkdl_tpu_torch.transformers import named_image\n"
        "from sparkdl_tpu_torch.estimators import logistic_regression\n"
        "f = named_image.DeepImageFeaturizer(modelName='ResNet18', "
        "batchSize=4, device='cpu')\n"
        "wire = np.random.RandomState(0).randint(0, 256, (6, 40, 40, 3))"
        ".astype(np.uint8)\n"
        "feats = np.concatenate(list(f._get_runner().run([wire[:4], "
        "wire[4:]])))\n"
        "assert feats.shape == (6, 512)\n"
        "lr = logistic_regression.LogisticRegression(maxIter=5, "
        "device='cpu')\n"
        "pred, _ = lr._fit_arrays(feats, np.arange(6) % 2)"
        ".predict_arrays(feats)\n"
        "assert pred.shape == (6,)\n"
        "try:\n"
        "    sparkdl_tpu_torch.DataFrame\n"
        "except ImportError:\n"
        "    print('lazy')\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in "
        "('pyarrow', 'pandas') and sys.modules[n] is not None))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["lazy", "[]"], res.stdout
