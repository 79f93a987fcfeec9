"""Twins of the reference's expert- and pipeline-parallel tests and of its
sharded scoring feed on the port, on the CPU:
``tests/test_parallel.py::TestSwitchMoE`` (``parallel.SwitchMoE``,
``moe_rules``, ``moe_aux_loss``), ``TestPipelineParallel``
(``parallel.gpipe``, ``microbatch``, ``stack_stage_params``,
``stage_sharding``) and ``tests/test_transformers.py::
test_xla_image_transformer_multi_device_sharded`` (``BatchRunner(mesh=)``
under ``XlaImageTransformer(numDevices=)``).

The single-process cases run here: the same seeded inputs and the flax
parameters carried across (``parallel.moe.load_flax_params``) go through
both packages. One gang of 4 gloo ranks runs every mesh case
(``tests/torch_sharded_worker.py``, mode ``expert_pipe``, started once
for the module, ``OMP_NUM_THREADS=1``): SwitchMoE on ``{"ep": 4}`` (one
expert a rank), GPipe on ``{"pp": 4}`` (the reference's test at pp 4 on
both sides: its mesh is 4 of the conftest's 8 devices), the sharded feed
on ``{"data": 4}``.

Tolerances (the reference's own): SwitchMoE per token atol 1e-5, against
the JAX module atol 1e-5 (outputs) and 1e-5 (gradients, rtol 1e-4); the
expert-parallel gang against the port's unsharded module atol 1e-6;
GPipe's forward atol 1e-6, its gradients atol 1e-4; the sharded feed
bitwise against the unsharded runner; the image transformer atol 1e-6.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import sparkdl_tpu as sdl
from sparkdl_tpu.core import runtime as jax_runtime
from sparkdl_tpu.image import imageIO as JIO
from sparkdl_tpu.parallel import (SwitchMoE as JMoE, gpipe as jax_gpipe,
                                  moe_aux_loss as jax_moe_aux_loss,
                                  stack_stage_params as jax_stack,
                                  stage_sharding as jax_stage_sharding)
from sparkdl_tpu_torch.parallel import (SwitchMoE, describe, microbatch,
                                        moe_aux_loss, moe_rules,
                                        stack_stage_params)
from sparkdl_tpu_torch.parallel import moe as M
from sparkdl_tpu_torch.runner import launcher

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_sharded_worker.py")
D = 16


def _moe_inputs(capacity_factor=4.0, seed=0):
    """The reference's ``TestSwitchMoE._build``: x (2, 16, 8), 4 experts of
    d_ff 32, flax parameters from PRNGKey(0)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 16, 8).astype(np.float32)
    moe = JMoE(num_experts=4, d_ff=32, capacity_factor=capacity_factor)
    v = moe.init(jax.random.PRNGKey(0), jnp.asarray(x))
    return moe, jax.tree_util.tree_map(np.asarray, v), x


def _port_moe(params, capacity_factor=4.0):
    return M.load_flax_params(
        SwitchMoE(8, 4, 32, capacity_factor=capacity_factor, device="cpu"),
        params)


def _stages():
    rng = np.random.RandomState(0)
    return [{"w": rng.randn(D, D).astype(np.float32) * 0.3,
             "b": rng.randn(D).astype(np.float32) * 0.1}
            for _ in range(4)]


def _jax_stage(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _pipe_x(seed, m):
    return np.random.RandomState(seed).randn(m, 2, D).astype(np.float32)


def _imgs():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (12, 12, 3), np.uint8) for _ in range(10)]


def _feed():
    rng = np.random.RandomState(4)
    return [rng.randint(0, 256, (n, 3, 4)).astype(np.uint8)
            for n in (6, 5, 3)]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Every rank's outputs of the ``expert_pipe`` worker (4 gloo ranks)."""
    d = tmp_path_factory.mktemp("expert_pipe_gang")
    _, v, x = _moe_inputs()
    torch.save({"x": x, "params": v["params"]}, d / "moe.pt")
    torch.save({"stages": _stages(), "x": _pipe_x(1, 4),
                "x_grad": _pipe_x(2, 2)}, d / "pipe.pt")
    torch.save(_feed(), d / "feed.pt")
    torch.save(_imgs(), d / "imgs.pt")
    env = {"OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT) + ":" + str(ROOT / "tests")}
    launcher.launch(str(WORKER), np=4, args=["expert_pipe", str(d), str(d)],
                    env=env, timeout_s=240.0, capture=True)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


class TestSwitchMoE:
    def test_matches_per_token_reference(self):
        """The port's module per token, as the reference's test computes
        it (its numpy loop over the carried-across weights), and against
        the JAX module."""
        moe, v, x = _moe_inputs()
        out = _port_moe(v["params"])(torch.as_tensor(x)).detach().numpy()
        params = v["params"]
        xf = x.reshape(-1, x.shape[-1])
        logits = xf @ params["router"]["kernel"] + params["router"]["bias"]
        probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        idx, g = np.argmax(probs, -1), np.max(probs, -1)
        ref = np.zeros_like(xf)
        for n in range(len(xf)):
            e = int(idx[n])
            h = np.asarray(jax.nn.gelu(jnp.asarray(
                xf[n] @ params["experts"]["wi"]["kernel"][e]
                + params["experts"]["wi"]["bias"][e])))
            ref[n] = g[n] * (h @ params["experts"]["wo"]["kernel"][e]
                             + params["experts"]["wo"]["bias"][e])
        np.testing.assert_allclose(out.reshape(ref.shape), ref, atol=1e-5)
        np.testing.assert_allclose(out, np.asarray(moe.apply(v, x)),
                                   atol=1e-5)

    def test_capacity_drops_tokens(self):
        """Capacity 1 token an expert: most tokens dropped (zero rows),
        the same rows as the reference's."""
        jmoe, v, x = _moe_inputs()
        full = _port_moe(v["params"])(torch.as_tensor(x)).detach().numpy()
        tight = _port_moe(v["params"], capacity_factor=0.125)(
            torch.as_tensor(x)).detach().numpy()
        zeros_tight = (np.abs(tight.reshape(-1, 8)).sum(-1) == 0)
        zeros_full = (np.abs(full.reshape(-1, 8)).sum(-1) == 0)
        assert zeros_tight.sum() > zeros_full.sum()
        ref = np.asarray(JMoE(num_experts=4, d_ff=32,
                              capacity_factor=0.125).apply(v, x))
        np.testing.assert_array_equal(
            zeros_tight, np.abs(ref.reshape(-1, 8)).sum(-1) == 0)
        np.testing.assert_allclose(tight, ref, atol=1e-5)

    def test_aux_loss_bounds(self):
        """The aux loss the caller's intermediates dict collects lies in
        (0, E] and equals the reference's sowed value."""
        jmoe, v, x = _moe_inputs()
        inter = {}
        _port_moe(v["params"])(torch.as_tensor(x), intermediates=inter)
        aux = float(moe_aux_loss(inter))
        assert 0.0 < aux <= 4
        assert len(inter["moe_aux_loss"]) == 1
        _, state = jmoe.apply(v, x, mutable=["intermediates"])
        np.testing.assert_allclose(
            aux, float(jax_moe_aux_loss(state["intermediates"])),
            rtol=1e-6)
        # nested dicts and the reference's "/"-joined paths are read too
        assert float(moe_aux_loss({"block": inter, "other": [1.0]})) == aux
        assert float(moe_aux_loss({})) == 0.0

    def test_rules_match_the_experts_segment_exactly(self):
        params = {"experts": {"wi": {"kernel": np.zeros((4, 8, 32))}},
                  "experts_gate": {"kernel": np.zeros((8, 4))},
                  "router": {"kernel": np.zeros((8, 4))}}
        desc = describe(params, moe_rules(ep_axis="ep"))
        assert desc == {"experts/wi/kernel": "PartitionSpec('ep', None, "
                                             "None)",
                        "experts_gate/kernel": "PartitionSpec()",
                        "router/kernel": "PartitionSpec()"}

    def test_ep_sharding_and_grads(self, gang):
        """On ``{"ep": 4}`` each rank holds one expert (its ``experts``
        leaves sharded on ``ep``, the router replicated); every rank's
        output equals the unsharded module's, and the gradients of
        (out²).sum() — the experts' gathered over ``ep``, the router's
        whole on every rank — the unsharded module's and the JAX
        module's."""
        jmoe, v, x = _moe_inputs()
        specs = gang[0]["moe_specs"]
        assert specs["experts/wi/kernel"] == "PartitionSpec('ep', None, None)"
        assert specs["router/weight"] == "PartitionSpec()"
        m = _port_moe(v["params"])
        y = m(torch.as_tensor(x))
        (y ** 2).sum().backward()
        jg = jax.grad(lambda p: (jmoe.apply({"params": p}, x) ** 2).sum())(
            v["params"])
        want_jax = {"router.weight": np.asarray(jg["router"]["kernel"]).T,
                    "router.bias": jg["router"]["bias"],
                    **{f"experts.{w}.{k}": jg["experts"][w][k]
                       for w in ("wi", "wo") for k in ("kernel", "bias")}}
        for r, o in enumerate(gang):
            assert o["moe_local_wi"] == (1, 8, 32), r
            np.testing.assert_allclose(o["moe_out"].numpy(),
                                       y.detach().numpy(), atol=1e-6)
            for name, p in m.named_parameters():
                g = o["moe_grads"][name].numpy()
                assert np.isfinite(g).all()
                np.testing.assert_allclose(g, p.grad.numpy(), atol=1e-6,
                                           err_msg=name)
                np.testing.assert_allclose(g, np.asarray(want_jax[name]),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=name)
            np.testing.assert_allclose(float(o["moe_aux"]),
                                       float(gang[0]["moe_aux"]), rtol=0)

    def test_weights_carry_across_from_flax(self):
        _, v, _ = _moe_inputs()
        m = _port_moe(v["params"])
        np.testing.assert_array_equal(m.router.weight.detach().numpy(),
                                      v["params"]["router"]["kernel"].T)
        np.testing.assert_array_equal(
            m.experts.wo.kernel.detach().numpy(),
            v["params"]["experts"]["wo"]["kernel"])
        assert tuple(m.experts.wi.kernel.shape) == (4, 8, 32)


class TestPipelineParallel:
    """GPipe at pp 4 against sequential stage application and the JAX
    ``gpipe`` on a 4-device mesh."""

    @staticmethod
    def _jax_mesh():
        return jax_runtime.make_mesh({"pp": 4}, devices_=jax.devices()[:4])

    def _sequential(self, stages, x):
        h = x.reshape(-1, D)
        for p in stages:
            h = _jax_stage(p, h)
        return h.reshape(x.shape)

    @pytest.mark.parametrize("remat", [True, False])
    def test_forward_matches_sequential(self, gang, remat):
        stages, x = _stages(), _pipe_x(1, 4)
        mesh = self._jax_mesh()
        stacked = jax_stage_sharding(mesh, jax_stack(
            [jax.tree_util.tree_map(jnp.asarray, s) for s in stages]), "pp")
        jy = np.asarray(jax.jit(jax_gpipe(_jax_stage, mesh, "pp"))(
            stacked, jnp.asarray(x)))
        ref = np.asarray(self._sequential(stages, x))
        for r, o in enumerate(gang):
            got = o[f"pipe_out_{remat}"].numpy()
            np.testing.assert_allclose(got, ref, atol=1e-6, err_msg=str(r))
            np.testing.assert_allclose(got, jy, atol=1e-6, err_msg=str(r))
        assert gang[0]["pipe_placements"] == "(Shard(dim=0),)"

    @pytest.mark.parametrize("remat", [True, False])
    def test_backward_through_schedule(self, gang, remat):
        """The stacked DTensor's gradient (Shard(0), gathered) against the
        JAX gradient through its schedule and the sequential one."""
        stages, x = _stages(), jnp.asarray(_pipe_x(2, 2))
        mesh = self._jax_mesh()
        stacked = jax_stage_sharding(mesh, jax_stack(
            [jax.tree_util.tree_map(jnp.asarray, s) for s in stages]), "pp")
        apply = jax_gpipe(_jax_stage, mesh, "pp")
        g_pp = jax.jit(jax.grad(lambda p: (apply(p, x) ** 2).sum()))(stacked)

        def loss_ref(p):
            h = x.reshape(-1, D)
            for i in range(4):
                h = _jax_stage(jax.tree_util.tree_map(lambda l: l[i], p), h)
            return (h ** 2).sum()

        g_ref = jax.grad(loss_ref)(jax_stack(
            [jax.tree_util.tree_map(jnp.asarray, s) for s in stages]))
        for o in gang:
            for k in ("w", "b"):
                got = o[f"pipe_grads_{remat}"][k].numpy()
                np.testing.assert_allclose(got, np.asarray(g_pp[k]),
                                           atol=1e-4)
                np.testing.assert_allclose(got, np.asarray(g_ref[k]),
                                           atol=1e-4)

    def test_microbatch_helper(self):
        assert microbatch(torch.zeros((8, 3)), 4).shape == (4, 2, 3)
        with pytest.raises(ValueError, match="not divisible"):
            microbatch(torch.zeros((7, 3)), 4)
        st = stack_stage_params([{"w": np.ones((2, 2)), "b": [np.zeros(2)]},
                                 {"w": np.zeros((2, 2)),
                                  "b": [np.ones(2)]}])
        assert tuple(st["w"].shape) == (2, 2, 2)
        assert tuple(st["b"][0].shape) == (2, 2)


def test_batch_runner_mesh_feeds_every_rank(gang):
    """``BatchRunner(mesh={"data": 4})``: the batch size rounds up to a
    multiple of 4, each rank runs its share and every rank yields the
    unsharded runner's outputs bitwise (``donate`` too)."""
    for r, o in enumerate(gang):
        assert o["feed_single_batch"] == 6 and o["feed_mesh_batch"] == 8
        for arm in ("feed_mesh", "feed_mesh_donate"):
            assert len(o[arm]) == len(o["feed_single"]) == 3
            for got, want in zip(o[arm], o["feed_single"]):
                for k in ("sum", "max"):
                    np.testing.assert_array_equal(got[k], want[k],
                                                  err_msg=f"{arm} {r}")
    want = [b.astype(np.float32).sum(axis=(1, 2)) for b in _feed()]
    for got, w in zip(gang[0]["feed_mesh"], want):
        np.testing.assert_array_equal(got["sum"], w)


def test_xla_image_transformer_multi_device_sharded(gang):
    """``numDevices=-1`` shards scoring over the gang's four devices: the
    same rows as the single-device path and as the reference's
    ``numDevices=-1`` over its 8 virtual devices; ``numDevices=99``
    raises naming what is there."""
    structs = [JIO.imageArrayToStruct(im, origin=f"mem://{i}")
               for i, im in enumerate(_imgs())]
    df = sdl.DataFrame.fromArrow(pa.table(
        {"image": pa.array(structs, type=JIO.imageSchema)}),
        numPartitions=2)
    fn = lambda b: jnp.mean(b, axis=(1, 2))  # noqa: E731
    ref = np.stack([r.f for r in sdl.XlaImageTransformer(
        inputCol="image", outputCol="f", fn=fn, inputSize=(8, 8),
        batchSize=4, numDevices=-1).transform(df).collect()])
    for o in gang:
        assert o["image_-1_batch"] == 4
        np.testing.assert_allclose(o["image_-1"], o["image_1"], atol=1e-6)
        np.testing.assert_allclose(o["image_-1"], ref, atol=1e-6)
        assert o["image_99"].startswith("ValueError: numDevices=99 but "
                                        "only 4")
    with pytest.raises(ValueError, match="only"):
        sdl.XlaImageTransformer(inputCol="image", outputCol="f", fn=fn,
                                inputSize=(8, 8),
                                numDevices=99).transform(df)
