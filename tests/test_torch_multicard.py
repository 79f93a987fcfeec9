"""The port's multi-rank paths as ``scripts/torch_multicard.py`` drives
them, run here as one four-rank gloo gang at tiny widths
(``--device cpu --tiny``, ``OMP_NUM_THREADS=1``), held against the JAX
package and the port's one-process steps, on the CPU.

One gang serves the module: the script runs every leg and writes its
record, which the tests read. What is held:

- ``comms``: every collective the port issues, exact against the host's
  sum or permutation on every rank;
- ``dp_resnet50``: the four-rank step of the narrow ResNet18 (width 8,
  32², 8 global rows as 4 × 2, one mutable ``sgd(0.01, momentum=0.9)``
  step) against one process's step on the 8 rows, within
  ``tests/test_torch_dp.py``'s shares (parameters 5e-4 of the largest
  change, statistics 1e-4); the ranks alike to the bit; the resumed fit
  repeats the straight one bitwise;
- ``dp_m``: BERT's dropout step against one process's step on the global
  batch within ``tests/test_torch_dp_dropout.py``'s limits (gradients
  2e-6 of the largest, the loss 1e-6 relative); the LoRA losses within
  ``chip_smoke.DP_LORA_LOSS_RTOL`` of one process's fit;
- ``tp_serve``: the f32 streams of tp 1, 2 (two groups) and 4, paged and
  unpaged, and of ``generate()`` equal the JAX package's static
  ``generate()`` on the carried flax tree (``num_kv_heads=4``, the
  reference's ``_tp4_model``) — greedy tokens, no tolerance; each rank's
  KV bytes 1/tp of tp 1's; launches = dispatches = layers × steps; the
  started tp 4 engine's streams the inline run's;
- ``fsdp_tp_train``: the f32 step on ``{"data": 2, "model": 2}`` against
  the unsharded step (the script's limits), the collectives a step the
  script's ``fsdp_collectives`` at both depths, both restores bitwise;
- ``sp``: Ulysses bitwise to the bare kernel's plain version, the ring's
  logits within ``RING_LOGIT_SHARE``, its hops sp - 1 a layer;
- ``moe``: Switch MoE on ``{"ep": 4}`` (8 experts, 2 a rank) from a
  flax tree made with numpy from a seed (``--moe-init``): each rank's
  output and the gradients of ``(y**2).sum() + aux`` (x, router, the
  gathered experts) against the one-process module (the script's check,
  bitwise or within 1e-6) and against the JAX package's ``SwitchMoE`` on
  the same tree, within ``tests/test_torch_moe_pipeline.py``'s
  tolerances (outputs atol 1e-5, gradients rtol 1e-4 atol 1e-5);
- ``gpipe``: four tiny ``LlamaLayer``s on ``{"pp": 4}``: the forward and
  each stage's gradient against the one-process sequential blocks (the
  script's check), 7 flash launches a rank a pass (M + P - 1), 7 hops
  forward and 14 forward and backward;
- ``batch_runner_mesh``: the featurizer's ``{"data": 4}`` runner bitwise
  the one-process runner at the rank's batch;
- ``fleet_groups`` and ``fleet_tp_groups``: one-rank and two-rank gloo
  gangs behind an ``EngineFleet``: every stream delivered exactly once
  (the script's audit) and equal to the clean engine's before its hop,
  group b DEAD, its gang's failure the victim's SIGKILL, every rank's
  launches = dispatches = layers × steps.

And without four cards the script exits 2 before any leg.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.parallel import SwitchMoE as JMoE
from sparkdl_tpu.parallel import moe_aux_loss as jax_moe_aux_loss

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "torch_multicard.py"
LEGS = ["comms", "dp_resnet50", "dp_m", "tp_serve", "fsdp_tp_train", "sp",
        "moe", "gpipe", "batch_runner_mesh", "fleet_groups",
        "fleet_tp_groups"]
MOE_D, MOE_F, MOE_E, MOE_CF = 16, 32, 8, 1.25  # the script's tiny moe
PARAM_SHARE, STAT_SHARE = 5e-4, 1e-4   # tests/test_torch_dp.py's
GRAD_SHARE, LOSS_RTOL = 2e-6, 1e-6     # tests/test_torch_dp_dropout.py's
TP_NEW = 8                             # the script's tiny tp_new
TP_CFG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              num_kv_heads=4, intermediate_size=256, rope_theta=10000.0)


def _run(*args, timeout=400):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(SCRIPT), *args], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT)


def _moe_tree(seed=3):
    """The flax tree of a ``SwitchMoE`` (numpy, from a seed) and x."""
    rng = np.random.RandomState(seed)

    def w(*shape):
        return (rng.randn(*shape) / np.sqrt(shape[-2])).astype(np.float32)

    def b(*shape):
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    params = {"router": {"kernel": w(MOE_D, MOE_E), "bias": b(MOE_E)},
              "experts": {"wi": {"kernel": w(MOE_E, MOE_D, MOE_F),
                                 "bias": b(MOE_E, MOE_F)},
                          "wo": {"kernel": w(MOE_E, MOE_F, MOE_D),
                                 "bias": b(MOE_E, MOE_D)}}}
    return params, rng.randn(2, 16, MOE_D).astype(np.float32)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The script's record and stdout lines, the prompts and the JAX
    package's static streams they are held to."""
    d = tmp_path_factory.mktemp("multicard")
    params, x = _moe_tree()
    torch.save({"params": params, "x": x}, d / "moe.pt")
    cfg = JL.LlamaConfig(**TP_CFG)
    model = JL.LlamaModel(cfg)
    variables = model.init(jax.random.PRNGKey(1),
                           np.zeros((1, 4), np.int32))
    rng = np.random.RandomState(5)
    head = rng.randint(0, cfg.vocab_size, 16).tolist()
    prompts = [head + rng.randint(0, cfg.vocab_size, n).tolist()
               for n in (3, 6, 11)]
    ids, lens = JL.left_pad_prompts(prompts)
    out = np.asarray(JL.generate(model, variables, np.asarray(ids), TP_NEW,
                                 pad_lens=np.asarray(lens), pad_to=64))
    refs = [out[i][int(lens[i]) + len(p):].tolist()
            for i, p in enumerate(prompts)]
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    torch.save({"cfg": TP_CFG, "params": params, "prompts": prompts},
               d / "tp.pt")
    proc = _run("--device", "cpu", "--tiny", "--tp-init", str(d / "tp.pt"),
                "--moe-init", str(d / "moe.pt"),
                "--out", str(d / "record.json"))
    assert proc.returncode == 0, proc.stderr[-6000:]
    return dict(record=json.loads((d / "record.json").read_text()),
                lines=proc.stdout.splitlines(), prompts=prompts, refs=refs)


def test_without_four_cards_it_exits_2_before_any_leg():
    proc = _run(timeout=120)
    assert proc.returncode == 2, (proc.stdout, proc.stderr[-2000:])
    assert proc.stdout == "", proc.stdout
    assert "needs 4 CUDA cards" in proc.stderr


def test_the_script_imports_neither_jax_nor_the_reference():
    code = ("import runpy, sys; runpy.run_path(sys.argv[1], "
            "run_name='not_main'); bad = sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sparkdl_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code, str(SCRIPT)],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-2000:])


def test_output_lines(gang):
    """env, a line a leg in order, the walls, then ``ok`` last."""
    lines = [json.loads(x) for x in gang["lines"]]
    assert lines[0]["leg"] == "env"
    assert [x["leg"] for x in lines[1:-2]] == LEGS
    assert set(lines[-2]["phase_walls"]) >= set(LEGS) | {"total", "gang"}
    assert lines[-1] == {"ok": True, "device": {"platform": "cpu",
                                                "kind": "cpu", "count": 4}}


def test_comms_exact_on_every_rank(gang):
    c = gang["record"]["legs"]["comms"]
    assert c["backend"] == "gloo" and c["exact_on_every_rank"]
    assert set(c["checks"]) == {
        "all_reduce_sum", "all_reduce_max", "broadcast",
        "all_gather_into_tensor", "reduce_scatter_tensor",
        "all_to_all_single", "batch_isend_irecv_ring"}
    assert all(c["checks"].values())


def test_dp_resnet_step_is_the_one_process_step(gang):
    r = gang["record"]["legs"]["dp_resnet50"]
    p = r["parity"]
    assert p["rows_global"] == 8 and p["rows_per_rank"] == 2
    assert p["param_share"] <= PARAM_SHARE, p
    assert p["stat_share"] <= STAT_SHARE, p
    assert p["ranks_bitwise"]
    ck = r["checkpoint"]
    assert ck["resumed_state_bitwise"] and ck["losses_bitwise"], ck
    assert "2" in ck["checkpoint_dir_entries"]
    assert r["world_size"] == 4 and r["one_rank_gang"]["device"] == "cpu"
    assert not any(r["launches"].values())


def test_dp_m_dropout_step_and_lora(gang):
    m = gang["record"]["legs"]["dp_m"]
    p = m["dp_bert_parity"]
    assert p["grad_share"] <= GRAD_SHARE, p
    assert p["loss_rel_err"] <= LOSS_RTOL, p
    assert p["ranks_bitwise"]
    b = m["dp_bert"]
    nl = 2  # BertConfig.tiny()
    assert b["launches"]["flash_attention"] == nl * b["steps"]
    assert b["launches"]["flash_attention_bwd"] == nl * b["steps"]
    lo = m["dp_lora"]
    assert lo["rows_per_rank"] == 1
    assert lo["loss_max_rel_err"] <= lo["loss_rtol"], lo


@pytest.mark.parametrize("family", ["paged", "unpaged"])
def test_tp_streams_are_the_reference_generate(gang, family):
    """tp 1 / 2 / 4 in f32: every stream the reference's static
    ``generate()``'s, as is the port's ``generate()``; bytes 1/tp."""
    f32 = gang["record"]["legs"]["tp_serve"]["f32"]
    assert f32["generate"] == gang["refs"]
    kernel = "paged_flash_decode" if family == "paged" else "flash_decode"
    base = f32["arms"][f"{family}_tp1"]["kv_pool_device_bytes"]
    for tp in (1, 2, 4):
        arm = f32["arms"][f"{family}_tp{tp}"]
        assert f32["streams"][f"{family}_tp{tp}"] == gang["refs"], tp
        assert arm["kv_pool_device_bytes"] * tp == base
        assert arm["launches"][kernel] == TP_CFG["num_layers"] * arm["steps"]
        assert arm["dispatch"] == (0 if tp == 1 else arm["launches"][kernel])
        assert arm["group_streams_bitwise"]


def test_tp_bf16_arms_and_the_started_front(gang):
    tp = gang["record"]["legs"]["tp_serve"]
    for key, arm in tp["bf16"]["arms"].items():
        assert arm["rule"]["positions_compared"] == 3 * TP_NEW, key
    fr = tp["tp_front"]
    assert fr["streams_equal_inline"] and fr["clients"] == 4
    assert fr["dispatch"] == fr["launches"]["paged_flash_decode"] > 0


def test_fsdp_tp_step_collectives_and_restores(gang):
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import torch_multicard as M
    finally:
        sys.path.pop(0)
    f = gang["record"]["legs"]["fsdp_tp_train"]
    p = f["parity_f32"]
    assert p["loss_rel_err"] <= M.FSDP_LOSS_RTOL, p
    assert p["update_share_beyond_one_rounding"] <= M.FSDP_UPDATE_SHARE, p
    assert p["collectives_per_step"] == M.fsdp_collectives(p["layers"])
    sharded = f["bf16"]["arms"][1]
    assert sharded["mesh"] == {"data": 2, "model": 2}
    assert sharded["collectives_per_step"] == M.fsdp_collectives(
        sharded["layers"])
    restores = f["sharded_ckpt"]["restores"]
    assert set(restores) == {"data4xmodel1", "data1xmodel4"}
    assert all(r["bit_identical"] for r in restores.values())


def test_sp_ulysses_and_ring(gang):
    sp = gang["record"]["legs"]["sp"]
    u = sp["ulysses"]
    assert u["mesh"] == {"sp": 4} and all(u["bitwise_to_bare_kernel"].values())
    assert u["launches"]["flash_attention"] == 1
    assert u["launches"]["flash_attention_bwd"] == 1
    r = sp["ring_generate"]
    assert r["ring_vs_flash_logit_share"] <= r["logit_share_limit"]
    assert r["arms"]["ring"]["collectives"]["batch_isend_irecv"] == \
        r["layers"] * 3


def test_moe_at_ep4_is_the_unsharded_and_the_reference_module(gang):
    m = gang["record"]["legs"]["moe"]
    assert m["mesh"] == {"ep": 4} and m["local_wi_shape"] == [2, MOE_D,
                                                              MOE_F]
    assert m["collectives_per_step"]["all_reduce"] == 3
    for h in m["held_to_unsharded_ranks"]:
        assert h["bitwise"] or h["max_share"] <= 1e-6, h
    params, x = _moe_tree()
    jmoe = JMoE(num_experts=MOE_E, d_ff=MOE_F, capacity_factor=MOE_CF)

    def loss(p, xx):
        y, st = jmoe.apply({"params": p}, xx, mutable=["intermediates"])
        return (y ** 2).sum() + jax_moe_aux_loss(st["intermediates"])

    y, st = jmoe.apply({"params": params}, x, mutable=["intermediates"])
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    want = {"router.weight": np.asarray(gp["router"]["kernel"]).T,
            "router.bias": gp["router"]["bias"], "x_grad": gx,
            **{f"experts.{w}.{k}": gp["experts"][w][k]
               for w in ("wi", "wo") for k in ("kernel", "bias")}}
    for r, t in enumerate(m["tensors_ranks"]):
        np.testing.assert_allclose(np.asarray(t["y"]), np.asarray(y),
                                   atol=1e-5, err_msg=str(r))
        np.testing.assert_allclose(
            t["aux"], float(jax_moe_aux_loss(st["intermediates"])),
            rtol=1e-6)
        for name, g in want.items():
            np.testing.assert_allclose(np.asarray(t[name]), np.asarray(g),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {r} {name}")


def test_gpipe_at_pp4_forward_and_backward(gang):
    g = gang["record"]["legs"]["gpipe"]
    assert g["mesh"] == {"pp": 4} and g["ticks"] == 7
    for remat in (False, True):
        arm = g["arms"][f"remat_{remat}"]
        f, b = arm["forward"], arm["fwd_bwd"]
        assert f["bitwise_to_sequential"], f
        assert f["launches"]["flash_attention"] == 7
        assert f["collectives"]["send_recv"] == 7
        h = b["grads_held_to_sequential"]
        assert h["bitwise"] or h["max_share"] <= 1e-6, h
        assert b["launches"]["flash_attention"] == (14 if remat else 7)
        assert b["launches"]["flash_attention_bwd"] == 7
        assert b["collectives"]["send_recv"] == 14


def test_batch_runner_mesh_is_the_one_process_runner(gang):
    r = gang["record"]["legs"]["batch_runner_mesh"]
    assert r["mesh"] == {"data": 4} and r["batch_per_rank"] == 1
    assert r["bitwise_to_one_card_at_rank_batch"] and r["ranks_alike"]


@pytest.mark.parametrize("leg,tp,faults", [
    ("fleet_groups", 1, ["clean", "doom", "kill"]),
    ("fleet_tp_groups", 2, ["clean", "kill"])])
def test_fleet_streams_once_and_b_dead(gang, leg, tp, faults):
    f = gang["record"]["legs"][leg]
    assert f["tp"] == tp and [lg["leg"] for lg in f["legs"]] == faults
    for lg in f["legs"]:
        assert lg["new_tokens"] == f["requests"] * f["new"], lg
        # the clean engine's stream up to the hop, and past it up to
        # the first near tie
        assert all(fl["position"] >= fl["hop_at"] for fl in lg["flips"])
        assert lg["hops"] >= (lg["leg"] != "clean"), lg
    assert f["legs"][0]["identical_streams"] == f["requests"]
    assert f["states"]["b"] == "dead"
    assert f["fleet_stats"]["replica_deaths"] == 1
    assert f["fleet_stats"]["drains"] == faults.count("doom")
    victim = f["victim_rank"]
    assert set(f["gang_failures"]) == {"b"}
    assert f"rank {victim} rc=-9" in f["gang_failures"]["b"]
    for name, grp in f["groups"].items():
        assert len(grp["ranks"]) == tp
        for r in grp["ranks"]:
            c = r["counts"]
            kernel = "paged_flash_decode" if grp["family"] == "paged" \
                else "flash_decode"
            assert c[kernel] == c["dispatch"] == 2 * c["steps"] > 0, c
