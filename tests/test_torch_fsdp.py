"""Twins of the reference's sharded-training tests on the port, on the CPU:
``tests/test_parallel.py::TestFSDP::test_fsdp_tp_train_step_matches_single_device``
and ``test_train_step_batch_spec_rank_truncation`` (the FSDP×TP step,
``runner.train_state.make_train_step(mesh=)``, over a Llama placed by
``models.llama.shard_model``), and the five mesh cases of
``tests/test_checkpoint.py::TestElasticReshard`` (checkpoints resharded
across meshes, ``CheckpointManager.restore(mesh=, rules=)``).

One gang of 4 gloo ranks runs every case (``tests/torch_sharded_worker.py``,
mode ``fsdp``, started once for the module, ``OMP_NUM_THREADS=1``); each
rank writes what it computed. The tiny Llama's flax parameters and the
seeded inputs are the reference tests' and come from this process, which
also runs the reference's steps on the conftest's 8 virtual CPU devices.
World sizes 4, 2 and 1 of the checkpoint cases are ``data`` sub-meshes of
the gang (``{"rep": 4 // n, "data": n}``).

Tolerances:
- updated parameters of the FSDP×TP gang against the reference's
  single-device step: rtol 5e-4, atol 5e-5 (the reference's own); the
  LoRA model's gang against the port's one-process step and the
  reference's single-device LoRA step: the same;
- the batch_spec loss: rtol 1e-5 against the closed form and the
  reference's step (the reference's);
- checkpoints: bitwise.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparkdl_tpu.core import runtime as jax_runtime
from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.parallel import (divisible_rules as jax_divisible_rules,
                                  fsdp_rules as jax_fsdp_rules,
                                  shard_params as jax_shard_params)
from sparkdl_tpu.runner import TrainState as JTrainState
from sparkdl_tpu.runner import make_train_step as jax_make_train_step
from sparkdl_tpu_torch.models import llama as L
from sparkdl_tpu_torch.runner import launcher
from torch_sharded_worker import ckpt_tree

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_sharded_worker.py")
STEP = dict(rtol=5e-4, atol=5e-5)


def _flax(cfg):
    model = JL.LlamaModel(cfg)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, v["params"])


def _lora_flax():
    """The tiny LoRA model with its B factors drawn (zero B leaves A's
    gradient zero, which would hide a wrong A gradient)."""
    _, params = _flax(JL.LlamaConfig.tiny(lora_rank=4))
    rng = np.random.RandomState(3)

    def bump(t):
        if isinstance(t, dict):
            return {k: ({"kernel": rng.randn(*v["kernel"].shape)
                         .astype(np.float32) * 0.05}
                        if k == "lora_b" else bump(v))
                    for k, v in t.items()}
        return t

    return bump(params)


def _ids():
    return np.random.RandomState(13).randint(0, 512, size=(8, 16))


def _spec_batch():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(8, 4).astype(np.float32),
            "weight": rng.rand(8).astype(np.float32)}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Every rank's outputs of the ``fsdp`` worker (4 gloo ranks)."""
    d = tmp_path_factory.mktemp("fsdp_gang")
    _, params = _flax(JL.LlamaConfig.tiny())
    torch.save(params, d / "llama.pt")
    torch.save(_lora_flax(), d / "llama_lora.pt")
    torch.save(_ids(), d / "ids.pt")
    torch.save(_spec_batch(), d / "spec_batch.pt")
    env = {"OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT) + ":" + str(ROOT / "tests")}
    launcher.launch(str(WORKER), np=4, args=["fsdp", str(d), str(d)],
                    env=env, timeout_s=240.0, capture=True)
    outs = [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(4)]
    return {"outs": outs, "params": params,
            "lora_params": torch.load(d / "llama_lora.pt",
                                      weights_only=False)}


@pytest.fixture(scope="module")
def jax_step(gang):
    """The reference's single-device sgd(1e-2) step of the tiny Llama."""
    model, params = _flax(JL.LlamaConfig.tiny())
    loss_fn = JL.causal_lm_loss_fn()
    state = JTrainState.create(model.apply, {"params": params},
                               optax.sgd(1e-2))
    step = jax.jit(lambda s, b: s.apply_gradients(jax.grad(
        lambda p: loss_fn(p, model.apply, b)[0])(s.params)))
    new = step(state, {"input_ids": jnp.asarray(_ids())})
    return jax.tree_util.tree_map(np.asarray, new.params["params"])


@pytest.fixture(scope="module")
def jax_lora_step(gang):
    """The reference's single-device LoRA step (its ``lora_optimizer(1e-2)``:
    Adam on the adapters, the bases frozen) from the B-drawn tree."""
    model = JL.LlamaModel(JL.LlamaConfig.tiny(lora_rank=4))
    loss_fn = JL.causal_lm_loss_fn()
    state = JTrainState.create(model.apply, {"params": gang["lora_params"]},
                               JL.lora_optimizer(1e-2))
    step = jax.jit(lambda s, b: s.apply_gradients(jax.grad(
        lambda p: loss_fn(p, model.apply, b)[0])(s.params)))
    new = step(state, {"input_ids": jnp.asarray(_ids())})
    return jax.tree_util.tree_map(np.asarray, new.params["params"])


def _port_tree(gathered: dict, cfg, flax_like) -> dict:
    """The gathered port parameters as the flax tree (transposed where the
    port's weight is the kernel's transpose)."""
    model = L.load_flax_params(L.LlamaModel(cfg, device="cpu"), flax_like)
    model.load_state_dict(gathered)
    return jax.tree_util.tree_map(np.asarray, L.flax_params(model))


def _assert_tree_close(got, want, **tol):
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        np.testing.assert_allclose(leaf, flat[path], err_msg=str(path),
                                   **tol)


class TestFSDP:
    def test_fsdp_tp_train_step_matches_single_device(self, gang, jax_step):
        """The 2-D FSDP×TP step (params sharded over data AND model) gives
        the reference's single-device step's parameters; every rank
        gathers the same tree; q_proj's shard is (out/2, in/2)."""
        full = [o["full"] for o in gang["outs"]]
        for r, f in enumerate(full):
            assert f["local"]["layers.0.attn.q_proj.base.weight"] == \
                (64, 64), r
            assert f["specs"]["layers.0.attn.q_proj.base.weight"] == \
                "PartitionSpec('model', 'data')"
            assert np.isfinite(float(f["loss"]))
            for k, v in f["params"].items():
                assert torch.equal(v, full[0]["params"][k]), (k, r)
        got = _port_tree(full[0]["params"], L.LlamaConfig.tiny(),
                         gang["params"])
        _assert_tree_close(got, jax_step, **STEP)
        # one step moved every weight: not an unsharded copy of the input
        moved = jax.tree_util.tree_map(
            lambda a, b: not np.array_equal(a, b), got, gang["params"])
        assert all(jax.tree_util.tree_leaves(moved))

    def test_collectives_of_a_step(self, gang):
        """A step's collectives: the all-gathers of the data-sharded
        weights (forward, again in the backward for every product that
        needs its weight there, and the reduce-scatters of their
        gradients), the model axis's conjugate all-reduces, one gradient
        mean."""
        c = gang["outs"][0]["full"]["collectives"]
        n_sharded = 2 + 2 * 7  # embed, lm_head, 7 projections a layer
        # + embed / logits gathers over model; + the backward's gathers
        # of lm_head and the projections (the embedding's keeps none)
        assert c["all_gather"] == n_sharded + 2 + (n_sharded - 1)
        assert c["reduce_scatter"] == n_sharded
        assert c["all_reduce"] > 0 and c["send_recv"] == 0

    @pytest.mark.parametrize("case", ["full", "lora"])
    def test_a_step_keeps_no_gathered_weight_for_the_backward(self, gang,
                                                              case):
        """ZeRO-3 on the port: the step's forward keeps tensors for the
        backward, and none of them is a gathered weight or a view of one
        (each product of a sharded weight keeps the shard and gathers
        again in the backward), so between uses a rank holds only its
        shards."""
        for o in gang["outs"]:
            assert o[case]["saved"] > 0
            assert o[case]["saved_gathered"] == 0

    def test_lora_step_matches_one_process(self, gang):
        """The LoRA model (adapters replicated over the data axis, A of
        q/v_proj entering the column split through copy_in) gives the
        one-process step's parameters."""
        for o in gang["outs"]:
            lora = o["lora"]
            np.testing.assert_allclose(float(lora["loss"]),
                                       float(lora["one_process_loss"]),
                                       rtol=1e-6)
            for k, v in lora["params"].items():
                np.testing.assert_allclose(
                    v.numpy(), lora["one_process"][k].numpy(),
                    err_msg=k, **STEP)
        # the step trained the adapters and left every base weight alone
        init = L.load_flax_params(L.LlamaModel(
            L.LlamaConfig.tiny(lora_rank=4), device="cpu"),
            gang["lora_params"]).state_dict()
        got = gang["outs"][0]["lora"]["params"]
        for k, v in got.items():
            assert torch.equal(v, init[k]) == ("lora_" not in k), k

    def test_lora_step_matches_the_reference_single_device_step(
            self, gang, jax_lora_step):
        """The gang's LoRA step (``lora_rules`` placement, the port's
        ``lora_optimizer``) gives the reference's single-device step of
        ``LlamaConfig.tiny(lora_rank=4)`` with its ``lora_optimizer``,
        from the same B-drawn flax tree: adapters moved, bases kept."""
        got = _port_tree(gang["outs"][0]["lora"]["params"],
                         L.LlamaConfig.tiny(lora_rank=4), gang["lora_params"])
        _assert_tree_close(got, jax_lora_step, **STEP)

    def test_remat_and_accumulation_on_the_mesh(self, gang, jax_step):
        """``remat=True`` (the recompute gathers the weights again) and
        ``accum_steps=2`` (each rank's rows split in two) on the mesh give
        the one-process step with the same settings, and that one the
        reference's single-device step (a mean-reduced loss: one update
        either way)."""
        for o in gang["outs"]:
            ra = o["remat_accum"]
            for k, v in ra["params"].items():
                np.testing.assert_allclose(v.numpy(),
                                           ra["one_process"][k].numpy(),
                                           err_msg=k, **STEP)
        got = _port_tree(gang["outs"][0]["remat_accum"]["params"],
                         L.LlamaConfig.tiny(), gang["params"])
        _assert_tree_close(got, jax_step, **STEP)
        # each microbatch: the forward's all-gathers twice (the recompute
        # re-gathers) and the backward's gathers of lm_head and the
        # projections
        c = gang["outs"][0]["remat_accum"]["collectives"]
        assert c["all_gather"] == 2 * (2 * (2 + 2 * 7 + 2) + 1 + 2 * 7)
        assert c["reduce_scatter"] == 2 * (2 + 2 * 7)

    def test_param_rules_pin_the_layout(self, gang):
        msg = gang["outs"][0]["rules_refusal"]
        assert msg.startswith("ValueError: embed_tokens.weight is placed "
                              "PartitionSpec()")

    def test_runner_context_passes_its_mesh(self, gang, jax_step):
        """``ctx.make_train_step(param_rules=)`` runs over the context's
        ``{"data": 4}`` mesh (FSDP alone) and gives the same step."""
        o = gang["outs"][0]
        assert o["ctx_mesh"] == {"data": 4}
        got = _port_tree(o["ctx_params"], L.LlamaConfig.tiny(),
                         gang["params"])
        _assert_tree_close(got, jax_step, **STEP)


def test_runner_axes_name_the_context_mesh(gang):
    """``XlaRunner(axes={"data": 2, "model": 2})`` names its context's
    mesh (the first axis the data axis, as the reference's
    ``make_context``): the context's step runs the FSDP×TP path over it
    and is bitwise the explicit ``make_train_step(mesh=)`` step on the
    same mesh, on every rank."""
    for o in gang["outs"]:
        assert o["axes_mesh"] == [{"data": 2, "model": 2}, "data"]
        assert torch.equal(o["axes_loss"], o["full"]["loss"])
        for k, v in o["full"]["params"].items():
            assert torch.equal(o["axes_params"][k], v), k


def test_train_step_batch_spec_rank_truncation(gang):
    """One batch_spec ``P("data", "sp")`` truncated to each leaf's rank: the
    ``[B]`` weight leaf splits as ``P("data")``, the ``sp`` dim stays
    whole, so the loss is the global batch's, with accum 1 and accum 2 —
    the closed form's and the reference step's."""
    from jax.sharding import PartitionSpec as JP
    batch = _spec_batch()
    ref = (batch["x"].mean(axis=1) * batch["weight"]).mean()
    mesh = jax_runtime.make_mesh({"data": 4, "sp": 2})

    def loss_fn(params, apply_fn, b):
        per_tok = (b["x"] * params["w"]).mean(axis=1)
        return (per_tok * b["weight"]).mean(), {}

    for accum in (1, 2):
        state = JTrainState.create(None, {"w": np.float32(2.0)},
                                   optax.sgd(0.1))
        new, m = jax_make_train_step(loss_fn, mesh, data_axis="data",
                                     batch_spec=JP("data", "sp"),
                                     accum_steps=accum)(state, batch)
        for o in gang["outs"]:
            got = float(o[f"spec_loss_{accum}"])
            np.testing.assert_allclose(got, ref * 2.0, rtol=1e-5)
            np.testing.assert_allclose(got, float(m["loss"]), rtol=1e-5)
            np.testing.assert_allclose(float(o[f"spec_w_{accum}"]),
                                       float(new.params["w"]), rtol=1e-5)


# --- checkpoints across meshes ----------------------------------------------

def _jax_shard_shapes(n: int) -> dict:
    """The reference's shard shape of each leaf of the tree at ``{"data":
    n}`` (its divisible fsdp_rules)."""
    mesh = jax_runtime.make_mesh({"data": n}, devices_=jax.devices()[:n])
    placed = jax_shard_params(ckpt_tree(), mesh, jax_divisible_rules(
        jax_fsdp_rules(mesh=mesh), mesh))
    return {f"{g}.{k}": tuple(v.addressable_shards[0].data.shape)
            for g, leaves in placed.items() for k, v in leaves.items()}


def _assert_restored(o, key, n, tree=None):
    tree = ckpt_tree() if tree is None else tree
    want = {f"{g}.{k}": v for g, leaves in tree.items()
            for k, v in leaves.items()}
    for name, v in want.items():
        np.testing.assert_array_equal(o[key][name].numpy(), v,
                                      err_msg=name)
    assert o[key + "/step"] == 0  # the saved (fresh) step


class TestElasticReshard:
    @pytest.mark.parametrize("n", [2, 1])
    def test_fsdp_shrink_roundtrip_bit_identical(self, gang, n):
        """Saved at world 4, restored at 2 and at 1: every leaf equals the
        original bit for bit and each rank holds the reference's shard
        shape at the NEW mesh."""
        for o in gang["outs"]:
            _assert_restored(o, f"ckpt_shrink_{n}", n)
            assert o[f"ckpt_shrink_{n}/mesh"] == {"data": n}
            assert o[f"ckpt_shrink_{n}/local"] == _jax_shard_shapes(n)

    def test_fsdp_grow_roundtrip_bit_identical(self, gang):
        for o in gang["outs"]:
            _assert_restored(o, "ckpt_grow_4", 4)
            assert o["ckpt_grow_4/mesh"] == {"data": 4}
            assert o["ckpt_grow_4/local"] == _jax_shard_shapes(4)

    def test_serving_tp_layout_reshard_roundtrip(self, gang):
        """A tp = 4 state (the serving rules, ``[out, in]`` weights)
        restores onto tp = 2 with identical weights and tp = 2 shards."""
        for o in gang["outs"]:
            _assert_restored(o, "ckpt_tp_2", 2, tree=o["tp_tree"])
            assert o["ckpt_tp_2/mesh"] == {"tp": 2}
            assert o["ckpt_tp_2/local"]["q_proj.weight"] == (4, 8)
            assert o["ckpt_tp_2/local"]["o_proj.weight"] == (8, 4)

    def test_mismatch_without_elastic_raises_topology_error(self, gang):
        """Without SPARKDL_ELASTIC the mesh change raises at the topology
        layer, naming both meshes and the knob."""
        for o in gang["outs"]:
            msg = o["ckpt_refusal"]
            assert msg.startswith("CheckpointTopologyError")
            assert "topology mismatch" in msg
            assert "'data': 4" in msg and "'data': 2" in msg
            assert "SPARKDL_ELASTIC" in msg

    def test_same_topology_restore_unaffected(self, gang):
        for o in gang["outs"]:
            _assert_restored(o, "ckpt_same_4", 4)
            assert o["ckpt_same_4/mesh"] == {"data": 4}


def test_placed_llama_checkpoint_roundtrip(gang):
    """A placed Llama's state (sgd with momentum, after a step) saves as
    global tensors and restores onto a fresh placed model bitwise, the
    momentum buffers laid out again; the manifest names the mesh and each
    parameter's spec."""
    for o in gang["outs"]:
        assert o["llama_ckpt_equal"] and o["llama_ckpt_opt_equal"]
        assert o["llama_ckpt_step"] == 1
        # a manager without the gang's group would have every rank write
        assert "manager over the gang (group=)" in o["llama_ckpt_no_group"]
    topo = gang["outs"][0]["llama_manifest_topology"]
    assert topo["mesh_shape"] == {"data": 2, "model": 2}
    assert topo["leaf_specs"]["layers.0.attn.q_proj.base.weight"] == \
        "PartitionSpec('model', 'data')"
    assert topo["tensors"]["embed_tokens.weight"] == [[512, 128], "float32"]
    json.dumps(topo)
