"""The port's image model zoo (``sparkdl_tpu_torch.models.registry``)
against the JAX package's (``sparkdl_tpu.models.registry``), on the CPU.

The flax variables of each model are made from a numpy seed at the shapes
flax's own ``init`` gives (``jax.eval_shape``; drawing them through flax
init costs tens of seconds a model on this CPU): kernels ``lecun``-scaled
normals, biases and every BatchNorm statistic and affine term random, so
the bridge (``load_flax_variables``) is exercised on every leaf. The same
variables go into both models and the same seeded uint8 images go through
both preprocess functions and forwards.

Tolerances:
- f32 features and logits: |Δ| ≤ 1e-5·max(1, max|ref|) + 1e-4·|ref|.
  The absolute term scales with the output's magnitude because f32
  rounding of a sum scales with its terms: random-init ResNets reach
  |features| of several hundred, where the measured |Δ| is ~3e-4
  (about 1e-6 of the largest feature); on outputs ≤ 1 it is the
  1e-5 + 1e-4·|ref| rule itself.
- bf16 features: |Δ| ≤ 2^-5·max|ref| (two bf16 forwards that round at
  different points; measured ≤ 2^-7 here).
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sparkdl_tpu.models import registry as JR
from sparkdl_tpu_torch.models import registry as R
from sparkdl_tpu_torch.models import image_layers as IL

BF16_RULE = 2.0 ** -5


@functools.lru_cache(maxsize=None)
def flax_shapes(name: str, size: int):
    """The shapes of the flax model's variables initialised at ``size``
    (traced, never computed; cached — the trace is the costly part)."""
    model = JR.get_model(name).build()
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))


def flax_variables(name: str, size: int, seed: int = 0):
    """Random flax variables of model ``name`` initialised at ``size``
    (numpy, seeded): every leaf drawn, so a misplaced leaf shows."""
    shapes = flax_shapes(name, size)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        shape = s.shape
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)
                    ).astype(np.float32)
        if leaf == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.6, 1.4, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def images(n: int, size: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


def jax_forward(name, variables, x_u8, features_only, dtype=jnp.float32):
    m = JR.get_model(name)
    fn = jax.jit(m.apply_fn(dtype=dtype, features_only=features_only))
    return np.asarray(fn(variables, jnp.asarray(x_u8)))


def jax_features_and_logits(name, variables, x_u8):
    """Both outputs of the flax model from one jitted program (XLA shares
    the trunk: one compile instead of two)."""
    m = JR.get_model(name)
    f = m.apply_fn(features_only=True)
    g = m.apply_fn(features_only=False)
    both = jax.jit(lambda v, x: (f(v, x), g(v, x)))
    return tuple(np.asarray(a) for a in both(variables, jnp.asarray(x_u8)))


def port_model(name, variables, size, dtype=torch.float32):
    kw = {"input_size": (size, size)} if name.startswith("VGG") else {}
    m = R.get_model(name).build(dtype=dtype, **kw)
    return R.load_flax_variables(m, variables)


def port_forward(name, model, x_u8, features_only):
    fn = R.get_model(name).apply_fn(model, features_only=features_only)
    return fn(torch.from_numpy(x_u8)).numpy()


def assert_f32_close(got, ref):
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol)


# Smallest inputs each architecture allows at this budget: ResNets and VGG
# at 32-64 px (VGG's fc1 follows the size it is initialised at).
# The deeper variants (ResNet101/152, VGG19) and the 299-px family
# (InceptionV3, Xception) are held the same way in
# tests/test_torch_image_models_deep.py and _299.py: the flax traces and
# compiles are the cost, and each file stays well inside the suite's
# per-file budget.
MODEL_CASES = [("ResNet18", 32), ("ResNet34", 32), ("ResNet50", 64),
               ("VGG16", 64)]


def check_features_and_logits(name, size):
    variables = flax_variables(name, size)
    x = images(2, size)
    model = port_model(name, variables, size)
    refs = jax_features_and_logits(name, variables, x)
    for features_only, ref in zip((True, False), refs):
        got = port_forward(name, model, x, features_only)
        assert got.shape == ref.shape and got.dtype == np.float32
        assert_f32_close(got, ref)


def check_param_counts(name, size):
    shapes = flax_shapes(name, size)
    want = sum(int(np.prod(p.shape))
               for p in jax.tree_util.tree_leaves(shapes["params"]))
    want_stats = sum(int(np.prod(p.shape))
                     for p in jax.tree_util.tree_leaves(
                         shapes.get("batch_stats", {})))
    kw = {"input_size": (size, size)} if name.startswith("VGG") else {}
    m = R.get_model(name).build(**kw)
    assert sum(p.numel() for p in m.parameters()) == want
    assert sum(b.numel() for b in m.buffers()) == want_stats


@pytest.mark.parametrize("name,size", MODEL_CASES,
                         ids=[f"{n}-{s}" for n, s in MODEL_CASES])
def test_features_and_logits_match_flax(name, size):
    check_features_and_logits(name, size)


def test_registry_contents_match_reference_surface():
    assert list(R.SUPPORTED_MODELS) == list(JR.SUPPORTED_MODELS)
    for name, jm in JR.SUPPORTED_MODELS.items():
        m = R.get_model(name)
        assert (m.input_size, m.feature_dim, m.num_classes) == \
            (jm.input_size, jm.feature_dim, jm.num_classes), name
        assert m.preprocess.__name__ == jm.preprocess.__name__
    with pytest.raises(ValueError, match="Unknown model"):
        R.get_model("NopeNet")


@pytest.mark.parametrize("fn", ["preprocess_tf", "preprocess_caffe",
                                "preprocess_torch"])
def test_preprocess_matches_reference_on_the_uint8_wire(fn):
    """The uint8 wire upcasts before the arithmetic (caffe's mean
    subtraction must not wrap) and matches the JAX preprocess at f32."""
    u8 = np.random.RandomState(0).randint(0, 256, (2, 8, 8, 3)).astype(
        np.uint8)
    ref = np.asarray(getattr(JR, fn)(jnp.asarray(u8)))
    got = getattr(R, fn)(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)
    f32 = getattr(R, fn)(torch.from_numpy(u8.astype(np.float32)))
    np.testing.assert_array_equal(got.numpy(), f32.numpy())


@pytest.mark.parametrize("name,size", MODEL_CASES,
                         ids=[n for n, _ in MODEL_CASES])
def test_param_counts_equal_flax(name, size):
    """Parameters (and BatchNorm statistics) count what flax's do; only
    VGG's fc1 depends on the input size."""
    check_param_counts(name, size)


def test_shapes_and_feature_dims_at_full_size():
    m = R.get_model("ResNet50")
    model = m.build()
    x = torch.zeros(2, 224, 224, 3)
    with torch.no_grad():
        assert model(x, features_only=True).shape == (2, 2048)
        assert model(x).shape == (2, 1000)
    assert model.feature_dim == m.feature_dim


def test_bf16_compute_fp32_params_and_close_to_f32():
    variables = flax_variables("ResNet18", 32)
    x = images(2, 32)
    m32 = port_model("ResNet18", variables, 32)
    m16 = port_model("ResNet18", variables, 32, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    ref = port_forward("ResNet18", m32, x, True)
    got = port_forward("ResNet18", m16, x, True)
    assert got.dtype == np.float32  # features cast back at the boundary
    assert np.abs(got - ref).max() <= BF16_RULE * np.abs(ref).max()
    jref = jax_forward("ResNet18", variables, x, True, dtype=jnp.bfloat16)
    assert np.abs(got - jref).max() <= BF16_RULE * np.abs(jref).max()


def test_seeded_init_is_deterministic_and_flax_scaled():
    m = R.get_model("ResNet18")
    a, b = m.init_params(seed=3), m.init_params(seed=3)
    c = m.init_params(seed=4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stem_conv.weight"], c["stem_conv.weight"])
    w = a["stage4_block1.conv2.weight"]  # fan_in 3·3·512
    assert abs(float(w.std()) - np.sqrt(1 / (9 * 512))) < 2e-3
    assert float(w.abs().max()) <= 2 * np.sqrt(1 / (9 * 512)) / 0.8796 + 1e-6
    assert torch.equal(a["stem_bn.running_var"], torch.ones(64))
    assert torch.equal(a["head.bias"], torch.zeros(1000))


def test_same_padding_is_flax_asymmetric():
    assert IL.same_pads(56, 3, 2) == (0, 1)   # even input, stride 2
    assert IL.same_pads(34, 3, 2) == (0, 1)   # Xception at 74x74
    assert IL.same_pads(74, 3, 2) == (0, 1)   # Xception at 299x299
    assert IL.same_pads(147, 3, 2) == (1, 1)  # odd input
    assert IL.same_pads(35, 7, 1) == (3, 3)
    assert IL.same_pads(56, 1, 2) == (0, 0)


def test_vgg_flatten_order_is_nhwc():
    """fc1 reads the (h, w, c) flatten the flax model produces: permuting
    fc1's rows into the logical-NCHW order instead must break parity
    (the bridge's test catches the wrong choice)."""
    variables = flax_variables("VGG16", 64)
    x = images(2, 64)
    ref = jax_forward("VGG16", variables, x, True)
    model = port_model("VGG16", variables, 64)
    assert_f32_close(port_forward("VGG16", model, x, True), ref)
    k = variables["params"]["fc1"]["kernel"]  # (2·2·512, 4096), rows (h,w,c)
    wrong = jax.tree_util.tree_map(lambda a: a, variables)
    wrong["params"]["fc1"]["kernel"] = np.ascontiguousarray(
        k.reshape(2, 2, 512, -1).transpose(2, 0, 1, 3).reshape(k.shape))
    bad = port_forward("VGG16", port_model("VGG16", wrong, 64), x, True)
    assert np.abs(bad - ref).max() > 1e-2 * np.abs(ref).max()


def test_bridge_reports_leftovers_and_shape_mismatches():
    variables = flax_variables("ResNet18", 32)
    model = R.get_model("ResNet18").build()
    extra = dict(variables["params"])
    extra["bogus"] = {"kernel": np.zeros((1, 1, 3, 4), np.float32)}
    with pytest.raises(ValueError, match="unexpected.*bogus.weight"):
        R.load_flax_variables(model, {"params": extra,
                                      "batch_stats": variables["batch_stats"]})
    missing = dict(variables["params"])
    del missing["head"]
    with pytest.raises(ValueError, match="missing.*head.bias"):
        R.load_flax_variables(model, {"params": missing,
                                      "batch_stats": variables["batch_stats"]})
    wrong = dict(variables["params"])
    wrong["head"] = {"kernel": np.zeros((512, 10), np.float32),
                     "bias": np.zeros((10,), np.float32)}
    with pytest.raises(ValueError, match="head.weight: flax"):
        R.load_flax_variables(model, {"params": wrong,
                                      "batch_stats": variables["batch_stats"]})
    with pytest.raises(ValueError, match="unknown flax leaf"):
        R.load_flax_variables(model, {"params": {"x": {"gamma": np.ones(2)}}})


def test_weight_roundtrip_torch_save(tmp_path):
    m = R.get_model("ResNet18")
    model = m.build(seed=42)
    p = str(tmp_path / "w.pt")
    R.save_weights(model, p)
    other = R.load_weights(m.build(seed=1), p)
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(RuntimeError):
        R.load_weights(R.get_model("ResNet34").build(), p)


def test_decode_predictions():
    logits = np.array([[0.0, 3.0, 1.0]])
    out = R.decodePredictions(logits, top=2)
    assert out == JR.decodePredictions(logits, top=2)
    assert out[0][0]["class"] == 1 and out[0][1]["class"] == 2
    assert out[0][0]["label"] == "class_1"


@pytest.mark.slow
def test_inception_v3_full_size_matches_flax():
    variables = flax_variables("InceptionV3", 299)
    x = images(1, 299)
    ref = jax_forward("InceptionV3", variables, x, True)
    got = port_forward("InceptionV3", port_model("InceptionV3", variables,
                                                 299), x, True)
    assert got.shape == (1, 2048)
    assert_f32_close(got, ref)
