"""Twins of ``tests/test_parallel.py`` (ring attention, Ulysses, the
sharding rules, FSDP) and of ``tests/test_tp_serving.py::TestSpecLayout``
on the port (``sparkdl_tpu_torch.parallel``, ``core.runtime.make_mesh``),
on the CPU.

One gang of 8 gloo ranks runs every case that needs a mesh
(``tests/torch_parallel_worker.py``, mode ``parallel``, started once for
the module by ``runner.launcher.launch``): the same seeded numpy inputs
go through the JAX functions on the conftest's 8 CPU devices here and
through the port's gang there, and each rank writes what it computed.
The rule-only twins run here, with the mesh given as its axis extents.

Tolerances:
- f32 outputs, port against the JAX function and against dense
  attention: rtol 2e-4, atol 2e-5 (the reference's); Ulysses with dense
  local attention is a permutation around the same dense attention, held
  to the same limits.
- The ring's gradient against JAX's ``jax.grad`` of its ``ring_attention``:
  atol 2e-5; against dense attention's gradient: rtol 2e-3, atol 2e-4
  (the reference's own limits).
- bf16 ring against f32 dense: rtol 0.1, atol 0.05 (the reference's);
  against the JAX bf16 ring: 2^-7 of the value plus 1e-5 (each package
  rounds the same f32 result once to bf16; one bf16 step apart at most).
- The 3-D compositions and the flash-local Ulysses: atol 2e-5; their
  gradients as the ring's above.
- Every rank holds the global output: all ranks equal bitwise.
- Placement: each rank's local shard of the carried-across tiny Llama
  equals the JAX shard of the same device index (transposed where the
  port's weight is), bitwise.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from sparkdl_tpu.core import runtime as jax_runtime
from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.parallel import (dense_attention as jax_dense,
                                  ring_attention as jax_ring,
                                  shard_params as jax_shard_params,
                                  ulysses_attention as jax_ulysses)
from sparkdl_tpu.parallel import (describe as jax_describe,
                                  lora_rules as jax_lora_rules,
                                  transformer_tp_rules as jax_tp_rules)
from sparkdl_tpu_torch.core.runtime import make_mesh
from sparkdl_tpu_torch.models import llama as L
from sparkdl_tpu_torch.parallel import (P, describe, divisible_rules,
                                        fsdp_rules, lora_rules, make_rules,
                                        serving_tp_layout,
                                        transformer_tp_rules)
from sparkdl_tpu_torch.runner import launcher

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_parallel_worker.py")
F32 = dict(rtol=2e-4, atol=2e-5)


def _qkv(seed=0, B=2, H=8, S=64, D=16, dtype=np.float32):
    rng = np.random.RandomState(seed)
    mk = lambda: jnp.asarray(rng.randn(B, H, S, D).astype(dtype) * 0.3)
    return mk(), mk(), mk()


def _qkv3(seed):
    rng = np.random.RandomState(seed)
    return [jnp.asarray(rng.randn(4, 4, 32, 16).astype(np.float32) * 0.3)
            for _ in range(3)]


def _tiny_lora_flax():
    cfg = JL.LlamaConfig.tiny(lora_rank=4)
    model = JL.LlamaModel(cfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4),
                                                            jnp.int32))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


@pytest.fixture(scope="module")
def jmesh():
    return jax_runtime.make_mesh({"sp": 8})


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Every rank's outputs of the ``parallel`` worker (8 gloo ranks)."""
    d = tmp_path_factory.mktemp("parallel_gang")
    flax = _tiny_lora_flax()
    torch.save(flax, d / "llama_tiny.pt")
    env = {"OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT) + ":" + str(ROOT / "tests")}
    launcher.launch(str(WORKER), np=8, args=["parallel", str(d), str(d)],
                    env=env, timeout_s=240.0, capture=True)
    outs = [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(8)]
    return {"outs": outs, "flax": flax}


def _out(gang, key):
    return gang["outs"][0][key].numpy()


def _replicated(gang, key):
    """The global output every rank holds: all ranks bitwise equal."""
    first = gang["outs"][0][key]
    for r, o in enumerate(gang["outs"][1:], 1):
        assert torch.equal(o[key], first), (key, r)
    return first.numpy()


class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_dense(self, gang, jmesh, causal):
        q, k, v = _qkv()
        got = _replicated(gang, f"ring_{causal}")
        np.testing.assert_allclose(
            got, np.asarray(jax_dense(q, k, v, causal=causal)), **F32)
        np.testing.assert_allclose(
            got, np.asarray(jax_ring(q, k, v, jmesh, axis="sp",
                                     causal=causal)), **F32)

    def test_inside_jit_with_grad(self, gang, jmesh):
        """The ring's autograd Function against JAX differentiating
        through ppermute, and against dense attention's gradient."""
        q, k, v = _qkv(seed=1, S=32)
        g = _replicated(gang, "ring_grad")
        assert g.shape == (3,) + q.shape and np.isfinite(g).all()
        g_ring = jax.jit(jax.grad(lambda a, b, c: jax_ring(
            a, b, c, jmesh, causal=True).sum(), argnums=(0, 1, 2)))(q, k, v)
        g_dense = jax.grad(lambda a, b, c: jax_dense(
            a, b, c, causal=True).sum(), argnums=(0, 1, 2))(q, k, v)
        for i in range(3):
            np.testing.assert_allclose(g[i], np.asarray(g_ring[i]),
                                       rtol=0, atol=2e-5)
            np.testing.assert_allclose(g[i], np.asarray(g_dense[i]),
                                       rtol=2e-3, atol=2e-4)

    def test_bf16(self, gang, jmesh):
        q, k, v = _qkv(seed=2)
        qb, kb, vb = (x.astype(jnp.bfloat16) for x in (q, k, v))
        assert gang["outs"][0]["ring_bf16_dtype"] == "torch.bfloat16"
        got = _replicated(gang, "ring_bf16")
        exp = jax_dense(qb.astype(jnp.float32), kb.astype(jnp.float32),
                        vb.astype(jnp.float32), causal=True)
        np.testing.assert_allclose(got, np.asarray(exp), rtol=0.1,
                                   atol=0.05)
        ref = np.asarray(jax_ring(qb, kb, vb, jmesh, causal=True),
                         np.float32)
        assert (np.abs(got - ref) <= 1e-5 + 2.0 ** -7 * np.abs(ref)).all()

    def test_dtensor_inputs_keep_their_layout(self, gang):
        """A DTensor sharded on S over ``sp`` runs on its local block and
        comes back a DTensor of the same placement; its gradient lands on
        the DTensor leaves."""
        o = gang["outs"][0]
        assert o["dtensor_placements"] == "(Shard(dim=2),)"
        assert o["dtensor_local_shape"] == "(2, 8, 4, 16)"
        np.testing.assert_array_equal(_out(gang, "dtensor_ring"),
                                      _out(gang, "ring_grad_out"))
        np.testing.assert_allclose(_out(gang, "dtensor_ring_grad"),
                                   _out(gang, "ring_grad"), rtol=0,
                                   atol=1e-6)


class TestUlysses:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_dense(self, gang, jmesh, causal):
        q, k, v = _qkv(seed=3)
        got = _replicated(gang, f"ulysses_{causal}")
        np.testing.assert_allclose(
            got, np.asarray(jax_dense(q, k, v, causal=causal)), **F32)
        np.testing.assert_allclose(
            got, np.asarray(jax_ulysses(q, k, v, jmesh, axis="sp",
                                        causal=causal)), **F32)

    def test_head_divisibility_check(self, gang, jmesh):
        q, k, v = _qkv(H=6)
        with pytest.raises(ValueError) as ref:
            jax_ulysses(q, k, v, jmesh)
        assert gang["outs"][0]["ulysses_h6"] == str(ref.value)

    def test_gradient_through_both_exchanges(self, gang):
        """Each all-to-all's gradient is the other all-to-all: Ulysses's
        gradient equals dense attention's (JAX)."""
        q, k, v = _qkv(seed=1, S=32)
        g = _replicated(gang, "ulysses_grad")
        g_dense = jax.grad(lambda a, b, c: jax_dense(
            a, b, c, causal=True).sum(), argnums=(0, 1, 2))(q, k, v)
        for i in range(3):
            np.testing.assert_allclose(g[i], np.asarray(g_dense[i]),
                                       rtol=2e-3, atol=2e-4)


def test_ulysses_flash_local_attention(gang):
    """Ulysses with the flash kernel as its local attention (on CPU
    tensors its plain version, under the kernel's autograd Function)
    matches single-device dense attention and the JAX Ulysses with the
    Pallas kernel in interpret mode; ``"auto"`` resolves to dense here."""
    from sparkdl_tpu.ops import flash_attention
    jm = jax_runtime.make_mesh({"sp": 4}, devices_=jax.devices()[:4])
    rng = np.random.RandomState(5)
    q, k, v = [jnp.asarray(rng.randn(2, 4, 64, 16).astype(np.float32) * 0.3)
               for _ in range(3)]
    ref = np.asarray(jax_dense(q, k, v, causal=True))
    got = _replicated(gang, "ulysses_flash")
    np.testing.assert_allclose(got, ref, atol=2e-5)
    jax_flash = jax_ulysses(q, k, v, jm, axis="sp", causal=True,
                            local_attn=functools.partial(
                                flash_attention, block_q=16, block_k=16))
    np.testing.assert_allclose(got, np.asarray(jax_flash), atol=2e-5)
    np.testing.assert_allclose(_replicated(gang, "ulysses_auto"), ref,
                               atol=2e-5)


@pytest.mark.parametrize("name, fn, seed", [
    ("ring3", jax_ring, 9), ("ulysses3", jax_ulysses, 11)])
def test_composes_with_dp_tp_axes(gang, name, fn, seed):
    """Twins of ``test_ring_attention_composes_with_dp_tp_axes`` and
    ``test_ulysses_composes_with_dp_tp_axes``: on the data×model×sp mesh
    B and H ride their axes; global inputs and DTensors laid out
    ``(Shard(0), Shard(1), Shard(2))`` give the single-device answer, and
    the gradient through the three axes JAX's."""
    mesh = jax_runtime.make_mesh({"data": 2, "model": 2, "sp": 2})
    q, k, v = _qkv3(seed)
    ref = np.asarray(jax_dense(q, k, v, causal=True))
    composed = np.asarray(jax.jit(lambda a, b, c: fn(
        a, b, c, mesh, axis="sp", causal=True, batch_axis="data",
        head_axis="model"))(q, k, v))
    for key in (name, name + "_dtensor"):
        got = _replicated(gang, key)
        np.testing.assert_allclose(got, ref, atol=2e-5)
        np.testing.assert_allclose(got, composed, atol=2e-5)
    assert gang["outs"][0][name + "_placements"] == \
        "(Shard(dim=0), Shard(dim=1), Shard(dim=2))"
    # the gradient through every axis's scatter and gather: JAX's through
    # the composed function, and dense attention's
    g = _replicated(gang, name + "_grad")
    g_jax = jax.jit(jax.grad(lambda a, b, c: fn(
        a, b, c, mesh, axis="sp", causal=True, batch_axis="data",
        head_axis="model").sum(), argnums=(0, 1, 2)))(q, k, v)
    g_dense = jax.grad(lambda a, b, c: jax_dense(a, b, c, causal=True)
                       .sum(), argnums=(0, 1, 2))(q, k, v)
    for i in range(3):
        np.testing.assert_allclose(g[i], np.asarray(g_jax[i]), rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(g[i], np.asarray(g_dense[i]),
                                   rtol=2e-3, atol=2e-4)
    if name == "ulysses3":
        with pytest.raises(ValueError, match="not divisible") as e:
            jax_ulysses(q[:, :2], k[:, :2], v[:, :2], mesh, axis="sp",
                        batch_axis="data", head_axis="model")
        assert gang["outs"][0]["ulysses3_h2"] == str(e.value)


class TestMakeMesh:
    def test_refuses_without_a_process_group(self):
        with pytest.raises(ValueError, match="launcher.launch"):
            make_mesh({"sp": 1})

    def test_refusals_and_free_axis_in_a_gang(self, gang):
        o = gang["outs"][0]
        assert "need 4 devices, have 8" in o["make_mesh_product"]
        assert "launcher.launch" in o["make_mesh_product"]
        assert o["make_mesh_two_free"] == "At most one mesh axis may be -1"
        assert o["make_mesh_free"] == "(2, 4)"


class TestShardingRules:
    def _params(self):
        return {
            "layer0": {
                "q_proj": {"kernel": np.zeros((64, 64)),
                           "bias": np.zeros((64,))},
                "o_proj": {"kernel": np.zeros((64, 64))},
                "up_proj": {"kernel": np.zeros((64, 256))},
                "down_proj": {"kernel": np.zeros((256, 64))},
                "norm": {"scale": np.zeros((64,))},
            },
            "embed_tokens": {"embedding": np.zeros((1000, 64))},
        }

    def test_tp_rules_specs(self):
        desc = describe(self._params(), transformer_tp_rules())
        assert desc == jax_describe(self._params(), jax_tp_rules())
        assert desc["layer0/q_proj/kernel"] == str(JP(None, "model"))
        assert desc["layer0/o_proj/kernel"] == str(JP("model", None))
        assert desc["layer0/up_proj/kernel"] == str(JP(None, "model"))
        assert desc["layer0/down_proj/kernel"] == str(JP("model", None))
        assert desc["embed_tokens/embedding"] == str(JP(None, "model"))
        assert desc["layer0/norm/scale"] == str(JP())
        assert desc["layer0/q_proj/bias"] == str(JP())

    def test_tp_rules_on_port_weights_are_transposed(self):
        """The port's ``[out, in]`` Linear weights under dotted names get
        the transposed specs; ``[vocab, hidden]`` embeddings the same."""
        params = {"layer0.q_proj.weight": np.zeros((64, 64)),
                  "layer0.o_proj.weight": np.zeros((64, 64)),
                  "layer0.up_proj.weight": np.zeros((256, 64)),
                  "layer0.down_proj.weight": np.zeros((64, 256)),
                  "layer0.q_proj.weight_scale": np.zeros((64,)),
                  "embed_tokens.weight": np.zeros((1000, 64)),
                  "lm_head.weight": np.zeros((1000, 64))}
        desc = describe(params, transformer_tp_rules())
        assert desc == {
            "layer0/q_proj/weight": str(P("model", None)),
            "layer0/o_proj/weight": str(P(None, "model")),
            "layer0/up_proj/weight": str(P("model", None)),
            "layer0/down_proj/weight": str(P(None, "model")),
            "layer0/q_proj/weight_scale": str(P("model")),
            "embed_tokens/weight": str(P(None, "model")),
            "lm_head/weight": str(P("model", None))}

    def test_shard_params_places_shards(self, gang):
        # output dim split over model (2) → the kernel's shards (64, 32);
        # sharding_pytree names the placements shard_params used
        for r, o in enumerate(gang["outs"]):
            assert o["tree_q_kernel_local"] == "(64, 32)", r
            assert o["tree_norm_local"] == "(64,)", r
            assert o["tree_q_kernel_placements"] == [
                "(Replicate(), Shard(dim=1))"] * 2, r

    def test_lora_rules_inherit(self):
        params = {
            "layer0": {"q_proj": {
                "kernel": np.zeros((64, 64)),
                "lora_a": {"kernel": np.zeros((64, 8))},
                "lora_b": {"kernel": np.zeros((8, 64))},
            }}}
        desc = describe(params, lora_rules(transformer_tp_rules()))
        assert desc == jax_describe(params,
                                    jax_lora_rules(jax_tp_rules()))
        assert desc["layer0/q_proj/lora_a/kernel"] == str(JP(None, None))
        assert desc["layer0/q_proj/lora_b/kernel"] == str(JP(None, "model"))

    def test_custom_rules_first_match_wins(self):
        rules = make_rules([(r"special", P("data")), (r".*", P())])
        desc = describe({"special": np.zeros((8, 2)),
                         "other": np.zeros((8,))}, rules)
        assert desc["special"] == str(JP("data"))
        assert desc["other"] == str(JP())


class TestFSDP:
    def test_specs_compose_with_tp(self):
        rules = transformer_tp_rules(data_axis="data")
        params = {
            "l0": {"q_proj": {"kernel": np.zeros((64, 64)),
                              "bias": np.zeros((64,))},
                   "o_proj": {"kernel": np.zeros((64, 64))},
                   "norm": {"scale": np.zeros((64,))}},
            "embed_tokens": {"embedding": np.zeros((512, 64))},
        }
        desc = describe(params, rules)
        assert desc == jax_describe(params, jax_tp_rules(data_axis="data"))
        assert desc["l0/q_proj/kernel"] == str(JP("data", "model"))
        assert desc["l0/o_proj/kernel"] == str(JP("model", "data"))
        assert desc["embed_tokens/embedding"] == str(JP("data", "model"))
        assert desc["l0/q_proj/bias"] == str(JP())
        assert desc["l0/norm/scale"] == str(JP())


def test_fsdp_skips_indivisible_dims_with_mesh():
    """With the mesh's extents given, the data axis lands only on a dim
    divisible by them; later free dims are tried; with none divisible the
    leaf keeps the base spec. The JAX rules on the conftest's 4×2 mesh
    describe the same."""
    jm = jax_runtime.make_mesh({"data": 4, "model": 2})
    mesh = {"data": 4, "model": 2}
    params = {
        "embed_tokens": {"embedding": np.zeros((50257, 64))},
        "odd_head": {"kernel": np.zeros((7, 64))},
        "l0": {"q_proj": {"kernel": np.zeros((64, 64))}},
    }
    desc = describe(params, transformer_tp_rules(data_axis="data",
                                                 mesh=mesh))
    assert desc == jax_describe(params, jax_tp_rules(data_axis="data",
                                                     mesh=jm))
    assert desc["embed_tokens/embedding"] == str(JP(None, "model"))
    assert desc["odd_head/kernel"] == str(JP(None, "data"))
    assert desc["l0/q_proj/kernel"] == str(JP("data", "model"))
    no_mesh = describe(params, transformer_tp_rules(data_axis="data"))
    assert no_mesh["embed_tokens/embedding"] == str(JP("data", "model"))
    bare = fsdp_rules(data_axis="data", mesh=mesh)
    assert describe({"t": {"kernel": np.zeros((50257, 7))}},
                    bare)["t/kernel"] == str(JP())


def test_fsdp_lora_and_idempotence():
    params = {"l0": {"q_proj": {
        "base": {"kernel": np.zeros((64, 64))},
        "lora_a": {"kernel": np.zeros((64, 8))},
        "lora_b": {"kernel": np.zeros((8, 64))},
    }, "custom_head": {"kernel": np.zeros((64, 32))}}}
    rules = lora_rules(transformer_tp_rules(data_axis="data"))
    desc = describe(params, rules)
    assert desc["l0/q_proj/base/kernel"] == str(JP("data", "model"))
    assert desc["l0/q_proj/lora_a/kernel"] == str(JP(None, None))
    assert desc["l0/q_proj/lora_b/kernel"] == str(JP(None, "model"))
    twice = fsdp_rules(transformer_tp_rules(data_axis="data"),
                       data_axis="data")
    assert describe(params, twice)["l0/custom_head/kernel"] == \
        str(JP("data", None))


# --- the tiny Llama carried across -----------------------------------------

def _port_model(flax):
    model = L.LlamaModel(L.LlamaConfig.tiny(lora_rank=4), device="cpu")
    return L.load_flax_params(model, flax)


def _port_rules(mesh):
    return lora_rules(transformer_tp_rules(data_axis="data", mesh=mesh))


def _jax_rules(mesh):
    return jax_lora_rules(jax_tp_rules(data_axis="data", mesh=mesh))


def _padded(spec, ndim) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def test_llama_specs_are_the_transposed_flax_specs(gang):
    """Every parameter of the port's tiny LoRA Llama gets the JAX spec of
    its flax counterpart, reversed where the port's weight is the
    transposed kernel (``models/llama.py::load_flax_params``)."""
    jrules = _jax_rules(jax_runtime.make_mesh({"data": 4, "model": 2}))
    jspecs = {tuple(k.key for k in path): _padded(jrules(path, leaf),
                                                  leaf.ndim)
              for path, leaf in jax.tree_util.tree_leaves_with_path(
                  gang["flax"])}
    model = _port_model(gang["flax"])
    names = {id(p): n for n, p in model.state_dict(keep_vars=True).items()}
    prules = _port_rules({"data": 4, "model": 2})
    pairs = L._param_map(model)
    for path, param, transposed in pairs:
        want = jspecs[path][::-1] if transposed else jspecs[path]
        got = _padded(prules((names[id(param)],), param), param.ndim)
        assert got == want, (path, jspecs[path], got)
    assert len(pairs) == len(jspecs) == len(names)
    assert any("data" in s and "model" in s for s in jspecs.values())


def test_shard_params_puts_the_jax_shard_on_each_rank(gang):
    """``shard_params`` of the carried-across model on the gang's
    ``{"data": 4, "model": 2}`` mesh: rank r's local shard equals the
    JAX ``addressable_shards`` entry of device r (transposed where the
    port's weight is), and the gathered tensor the whole parameter."""
    jm = jax_runtime.make_mesh({"data": 4, "model": 2})
    placed = jax_shard_params(gang["flax"], jm, _jax_rules(jm))
    model = _port_model(gang["flax"])
    names = {id(p): n for n, p in model.state_dict(keep_vars=True).items()}
    leaves = {tuple(k.key for k in path): leaf for path, leaf in
              jax.tree_util.tree_leaves_with_path(placed)}
    sharded = 0
    for path, param, transposed in L._param_map(model):
        name = names[id(param)]
        shards = {s.device.id: np.asarray(s.data)
                  for s in leaves[path].addressable_shards}
        for r, out in enumerate(gang["outs"]):
            want = shards[r].T if transposed else shards[r]
            np.testing.assert_array_equal(
                out["llama_local/" + name].numpy(), want, err_msg=name)
            np.testing.assert_array_equal(
                out["llama_full/" + name].numpy(),
                param.detach().numpy(), err_msg=name)
        sharded += shards[0].shape != np.asarray(leaves[path]).shape
    assert sharded >= 14  # every projection, embed and lm_head


class TestSpecLayout:
    def test_layout_fields_and_head_validation(self):
        lay = serving_tp_layout(2)
        assert lay.degree == 2 and lay.axis == "tp"
        assert tuple(lay.kv_cache) == (None, "tp", None, None)
        assert tuple(lay.replicated) == ()

        class C:
            num_kv_heads = 2
            num_heads = 4

        serving_tp_layout(2, C)
        serving_tp_layout(1, C)
        with pytest.raises(ValueError, match="num_kv_heads"):
            serving_tp_layout(4, C)
        with pytest.raises(ValueError, match="tp must be >= 1"):
            serving_tp_layout(0)

    def test_divisible_rules_drop_uneven_axes(self):
        base = make_rules([(r"odd_vocab", P(None, "tp")),
                           (r"kernel", P(None, "tp"))])
        rules = divisible_rules(base, {"tp": 2})
        assert rules(("odd_vocab",), np.zeros((4, 5))) == P(None, None)
        assert rules(("kernel",), np.zeros((4, 6))) == P(None, "tp")
        assert rules(("bias",), np.zeros((3,))) == P()


def test_unported_parts_name_the_roadmap():
    from sparkdl_tpu_torch import parallel
    for name in ("gpipe", "microbatch", "stack_stage_params",
                 "stage_sharding", "SwitchMoE", "moe_rules",
                 "moe_aux_loss"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md, Queue A 8"):
            getattr(parallel, name)()
