"""Twins of ``tests/test_tp_serving.py`` (tensor-parallel serving) and of
the mesh cases of ``tests/test_paged_flash_decode.py`` on the port
(``serving.backend.TensorParallel*``, ``serving.backend.tp_mesh``,
``parallel.head_sharded_kernel``), on the CPU.

Torch's form is one process a device: a tp = 2 engine is two gloo ranks.
One gang of 2 ranks runs every tp = 2 case in one launch
(``tests/torch_tp_worker.py``, mode ``tp2``, started once for the module,
``OMP_NUM_THREADS=1``); each rank writes what it computed. The tiny
Llama's flax variables are the reference tests' (``_tiny_model``,
``_tp4_model``), carried across. The reference's own outputs come from
this process: its ``GenerationEngine.from_model(tp=2)`` on the
conftest's 8 virtual CPU devices and its static ``generate()``.

Tolerances: none for streams — greedy tokens are compared for equality,
port against the reference and every rank against every other. The
head-sharded dispatch against the unsharded call: bitwise. Its paged
output against the reference's paged kernel (interpret mode): rtol 2e-4,
atol 2e-5, the limits ``tests/test_torch_paged_flash_decode.py`` holds
the two packages to. Each rank's int8 codes and scales against the
slice of the reference's ``quantize_params`` of the same tree: bitwise.

The full tp 1/2/4 matrix runs as a 4-rank gang behind ``slow``, as the
reference's does.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.ops import paged_flash_decode as jpfd
from sparkdl_tpu.serving import GenerationEngine as JEngine
from sparkdl_tpu_torch import GenerationEngine
from sparkdl_tpu_torch.models import llama as L
from sparkdl_tpu_torch.runner import launcher

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_tp_worker.py")
F32 = dict(rtol=2e-4, atol=2e-5)


def _tiny_model():
    """The reference's ``_tiny_model``: GQA 4:2, an exact split at tp 2."""
    cfg = JL.LlamaConfig.tiny()
    model = JL.LlamaModel(cfg)
    variables = model.init(jax.random.PRNGKey(0),
                           np.zeros((1, 4), np.int32))
    return cfg, model, variables


def _tp4_model():
    """The reference's ``_tp4_model``: num_kv_heads 4."""
    cfg = JL.LlamaConfig(vocab_size=512, hidden_size=128, num_layers=2,
                         num_heads=4, num_kv_heads=4,
                         intermediate_size=256, rope_theta=10000.0)
    model = JL.LlamaModel(cfg)
    variables = model.init(jax.random.PRNGKey(1),
                           np.zeros((1, 4), np.int32))
    return cfg, model, variables


def _odd_model():
    """Odd MLP and vocabulary widths: ``divisible_rules`` leaves
    ``gate/up/down`` and ``lm_head`` whole at tp 2."""
    cfg = JL.LlamaConfig(vocab_size=509, hidden_size=128, num_layers=2,
                         num_heads=4, num_kv_heads=2,
                         intermediate_size=251, rope_theta=10000.0)
    model = JL.LlamaModel(cfg)
    variables = model.init(jax.random.PRNGKey(2),
                           np.zeros((1, 4), np.int32))
    return cfg, model, variables


def _static_refs(model, variables, prompts, new, max_len=64):
    ids, lens = JL.left_pad_prompts(prompts)
    out = np.asarray(JL.generate(model, variables, np.asarray(ids), new,
                                 pad_lens=np.asarray(lens), pad_to=max_len))
    return [out[i][int(lens[i]) + len(p):].tolist()
            for i, p in enumerate(prompts)]


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_serve(eng, prompts, new):
    hs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.run_until_idle()
    return [h.result(1) for h in hs]


def _lean_prompts(vocab):
    rng = np.random.RandomState(7)
    head = rng.randint(0, vocab, 16).tolist()  # 2 blocks
    pa = head + rng.randint(0, vocab, 3).tolist()
    pb = head + rng.randint(0, vocab, 6).tolist()
    return pa, pb


def _pool_case():
    """``tests/test_paged_flash_decode.py::_pool_and_tables(13)`` and its
    q: non-contiguous live blocks, a slot parked on the trash block."""
    rng = np.random.RandomState(13)
    k = rng.randn(13, 2, 8, 16).astype(np.float32)
    v = rng.randn(13, 2, 8, 16).astype(np.float32)
    tables = np.zeros((4, 4), np.int32)
    tables[0] = [7, 3, 11, 0]
    tables[1] = [2, 9, 0, 0]
    tables[2] = [5, 1, 10, 4]
    q = np.random.RandomState(29).randn(4, 4, 1, 16).astype(np.float32)
    return dict(q=q, k=k, v=v, tables=tables,
                cur=np.asarray([17, 9, 31, 0], np.int32),
                pads=np.asarray([0, 3, 5, 0], np.int32))


def _dense_case():
    rng = np.random.RandomState(31)
    return dict(q=rng.randn(3, 4, 1, 16).astype(np.float32),
                k=rng.randn(3, 2, 40, 16).astype(np.float32),
                v=rng.randn(3, 2, 40, 16).astype(np.float32),
                cur=np.asarray([40, 17, 1], np.int32),
                pads=np.asarray([0, 5, 0], np.int32))


def _launch(d: Path, mode: str, np_: int) -> list:
    env = {"OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT) + ":" + str(ROOT / "tests")}
    launcher.launch(str(WORKER), np=np_, args=[mode, str(d), str(d)],
                    env=env, timeout_s=300.0, capture=True)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(np_)]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Every rank's outputs of the ``tp2`` worker, the reference's inputs
    and streams they are held to."""
    d = tmp_path_factory.mktemp("tp_gang")
    cfg, model, variables = _tiny_model()
    _, _, vars4 = _tp4_model()
    torch.save(_numpy(variables["params"]), d / "tiny.pt")
    torch.save(_numpy(vars4["params"]), d / "tp4.pt")
    ocfg, omodel, ovars = _odd_model()
    torch.save(_numpy(ovars["params"]), d / "odd.pt")
    rng = np.random.RandomState(37)
    oprompts = [rng.randint(0, ocfg.vocab_size, n).tolist()
                for n in (6, 10)]
    pa, pb = _lean_prompts(cfg.vocab_size)
    rng = np.random.RandomState(19)
    kprompts = [rng.randint(0, cfg.vocab_size, n).tolist()
                for n in (5, 11, 8)]
    rng = np.random.RandomState(23)
    iprompts = [rng.randint(0, cfg.vocab_size, n).tolist()
                for n in (4, 9, 13)]
    cases = {
        "lean": dict(pa=pa, pb=pb, new=10,
                     refs=_static_refs(model, variables, [pa, pb], 10)),
        "kernel": dict(prompts=kprompts, new=6,
                       refs=_static_refs(model, variables, kprompts, 6,
                                         128)),
        "int8": dict(prompts=iprompts, new=8),
        "odd": dict(prompts=oprompts, new=6,
                    cfg=dict(vocab_size=509, hidden_size=128, num_layers=2,
                             num_heads=4, num_kv_heads=2,
                             intermediate_size=251, rope_theta=10000.0),
                    refs=_static_refs(omodel, ovars, oprompts, 6)),
        "pool": _pool_case(), "dense": _dense_case()}
    torch.save(cases, d / "cases.pt")
    outs = _launch(d, "tp2", 2)
    return {"outs": outs, "cases": cases, "model": model,
            "variables": variables}


def _same(gang, key):
    """The value every rank computed: all ranks equal."""
    first = gang["outs"][0][key]
    for r, o in enumerate(gang["outs"][1:], 1):
        if torch.is_tensor(first):
            assert torch.equal(o[key], first), (key, r)
        else:
            assert o[key] == first, (key, r, o[key], first)
    return first


def _env_gang(tmp_path, np_: int, env=None) -> list:
    """What each rank of an ``np_``-rank gang sees of the placement
    variables."""
    worker = tmp_path / "env_worker.py"
    worker.write_text(
        "import json, os, sys\n"
        "rank = os.environ['SPARKDL_PROCESS_ID']\n"
        "json.dump({k: os.environ.get(k) for k in\n"
        "           ('CUDA_VISIBLE_DEVICES', 'SPARKDL_TP_DEVICE_OFFSET',\n"
        "            'XLA_FLAGS')},\n"
        "          open(sys.argv[1] + f'/rank{rank}.json', 'w'))\n")
    launcher.launch(str(worker), np=np_, args=[str(tmp_path)], env=env,
                    timeout_s=60.0, capture=True)
    return [json.load(open(tmp_path / f"rank{r}.json")) for r in range(np_)]


class TestTpPlacement:
    """Torch's placement regime: one process a device, rank r on
    ``cuda:r``, so a rank's engine group is ``r // tp`` and the launcher
    places nothing (the reference's ``tp_placement_env`` and
    ``host_device_flags`` have no counterpart; ROADMAP.md, Queue C 2)."""

    def test_host_device_flags_has_no_counterpart(self, tmp_path,
                                                  monkeypatch):
        """The reference merges --xla_force_host_platform_device_count
        into XLA_FLAGS and sets a per-rank device offset; the port's
        launcher has neither helper, and a tp gang's ranks see the
        caller's XLA_FLAGS as they were."""
        assert not hasattr(launcher, "host_device_flags")
        assert not hasattr(launcher, "tp_placement_env")
        flags = "--xla_force_host_platform_device_count=16"
        monkeypatch.delenv("XLA_FLAGS", raising=False)
        got = _env_gang(tmp_path, 2, {"SPARKDL_SERVE_TP": "2",
                                      "XLA_FLAGS": flags})
        assert [g["XLA_FLAGS"] for g in got] == [flags, flags]

    def test_groups_are_disjoint_consecutive_ranks(self, gang):
        """On the 2-rank gang tp 1 puts each rank alone and tp 2 both in
        one group (the 4-rank cut is in ``test_tp_full_matrix``)."""
        assert [o["mesh1_ranks"] for o in gang["outs"]] == [[0], [1]]
        assert _same(gang, "mesh2_ranks") == [0, 1]

    def test_caller_pinned_visibility_is_kept(self, tmp_path, monkeypatch):
        """A caller-pinned ``CUDA_VISIBLE_DEVICES`` (the reference's
        ``TPU_VISIBLE_CHIPS``) reaches every rank as it was: each rank
        takes its own index in the same list."""
        monkeypatch.delenv("SPARKDL_TP_DEVICE_OFFSET", raising=False)
        got = _env_gang(tmp_path, 2, {"SPARKDL_SERVE_TP": "2",
                                      "CUDA_VISIBLE_DEVICES": "4,5"})
        assert [g["CUDA_VISIBLE_DEVICES"] for g in got] == ["4,5", "4,5"]
        assert all(g["SPARKDL_TP_DEVICE_OFFSET"] is None for g in got)

    def test_ambient_knob_never_rewrites_an_unrelated_gang(
            self, tmp_path, monkeypatch):
        """``SPARKDL_SERVE_TP``, shell-exported or in the caller's own
        ``env=``, changes nothing the launcher gives a rank, and a gang
        it does not divide still spawns: ``tp_mesh`` refuses it on the
        ranks (``TestTpMesh``)."""
        monkeypatch.delenv("SPARKDL_TP_DEVICE_OFFSET", raising=False)
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        monkeypatch.setenv("SPARKDL_SERVE_TP", "2")  # ambient only
        got = _env_gang(tmp_path, 3)
        assert all(g["SPARKDL_TP_DEVICE_OFFSET"] is None and
                   g["CUDA_VISIBLE_DEVICES"] is None for g in got)
        monkeypatch.delenv("SPARKDL_SERVE_TP")
        got = _env_gang(tmp_path, 3, {"SPARKDL_SERVE_TP": "2"})
        assert all(g["SPARKDL_TP_DEVICE_OFFSET"] is None and
                   g["CUDA_VISIBLE_DEVICES"] is None for g in got)


class TestTpMesh:
    def test_offset_env_and_bounds(self, gang):
        """``tp_mesh(2)`` is the gang's two ranks, ``tp_mesh(1)`` each
        rank alone, and the reference's ``SPARKDL_TP_DEVICE_OFFSET`` is
        read nowhere: set to a rank no group starts at, it changes
        nothing. tp 0 and a tp that does not divide the gang raise,
        naming the knob."""
        outs = gang["outs"]
        assert _same(gang, "mesh2_ranks") == [0, 1]
        assert [o["mesh1_ranks"] for o in outs] == [[0], [1]]
        assert _same(gang, "mesh_stale_offset") == [0, 1]
        assert ">= 1" in _same(gang, "mesh_tp0")
        assert "does not divide" in _same(gang, "mesh_tp3")
        assert "SPARKDL_SERVE_TP" in _same(gang, "mesh_tp3")

    def test_outside_a_gang_tp_mesh_needs_one(self):
        from sparkdl_tpu_torch.serving.backend import tp_mesh
        with pytest.raises(ValueError, match="needs a torch.distributed"):
            tp_mesh(2)


class TestTp1ExactExistingPath:
    """tp <= 1 constructs the EXACT single-device backends."""

    def test_tp1_constructs_base_classes(self):
        from sparkdl_tpu_torch.serving.backend import (
            LlamaSlotBackend, PagedLlamaSlotBackend)
        _, _, variables = _tiny_model()
        model = L.LlamaModel(L.LlamaConfig.tiny(), device="cpu")
        eng = GenerationEngine.from_model(model, variables, num_slots=2,
                                          max_len=32, tp=1, device="cpu")
        assert type(eng.backend) is LlamaSlotBackend
        assert eng.tp_degree == 1
        assert not hasattr(eng.backend, "mesh")
        engp = GenerationEngine.from_model(model, variables, num_slots=2,
                                           max_len=32, block_size=8, tp=1,
                                           device="cpu")
        assert type(engp.backend) is PagedLlamaSlotBackend
        assert eng.kv_pool_device_bytes == sum(
            t.numel() * t.element_size() for t in eng.backend.cache.tensors())

    def test_explicit_mesh_without_tp_is_inferred_not_dropped(self, gang):
        assert _same(gang, "inferred") == [
            "TensorParallelLlamaSlotBackend", 2]

    def test_tp_mesh_disagreement_and_bad_env_raise(self, gang,
                                                    monkeypatch):
        for tp in (4, 1):
            assert "disagrees" in _same(gang, f"disagree_tp{tp}")
        model = L.LlamaModel(L.LlamaConfig.tiny(), device="cpu")
        monkeypatch.setenv("SPARKDL_SERVE_TP", "four")
        with pytest.raises(ValueError, match="not an integer"):
            GenerationEngine.from_model(model, num_slots=2, max_len=32,
                                        device="cpu")
        monkeypatch.setenv("SPARKDL_SERVE_TP", "-4")
        with pytest.raises(ValueError, match="negative"):
            GenerationEngine.from_model(model, num_slots=2, max_len=32,
                                        device="cpu")

    def test_scrub_serving_env_removes_and_returns(self, monkeypatch):
        import os

        from sparkdl_tpu_torch.serving.engine import scrub_serving_env
        monkeypatch.setenv("SPARKDL_SERVE_KV_POOL_MB", "64")
        monkeypatch.setenv("SPARKDL_TP_DEVICE_OFFSET", "4")
        monkeypatch.setenv("SPARKDL_METRICS_DIR", "/tmp/keep")
        removed = scrub_serving_env()
        assert removed == {"SPARKDL_SERVE_KV_POOL_MB": "64",
                           "SPARKDL_TP_DEVICE_OFFSET": "4"}
        assert "SPARKDL_SERVE_KV_POOL_MB" not in os.environ
        assert os.environ["SPARKDL_METRICS_DIR"] == "/tmp/keep"
        os.environ.update(removed)
        env = {"SPARKDL_SERVE_TP": "2", "OTHER": "x"}
        assert scrub_serving_env(env) == {"SPARKDL_SERVE_TP": "2"}
        assert env == {"OTHER": "x"}

    def test_tp1_signature_equality_with_plain_construction(self):
        from sparkdl_tpu_torch.core.runtime import GLOBAL_COMPILE_CACHE
        from sparkdl_tpu_torch.serving.backend import LlamaSlotBackend
        cfg, _, variables = _tiny_model()
        model = L.LlamaModel(L.LlamaConfig.tiny(), device="cpu")
        prompt = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                                  5).tolist()
        eng = GenerationEngine.from_model(
            model, variables, num_slots=2, max_len=32, prefill_chunk=8,
            prefix_cache_mb=0, tp=1, device="cpu")
        h = eng.submit(prompt, max_new_tokens=3)
        eng.run_until_idle()
        sig_d = GLOBAL_COMPILE_CACHE.signatures("serve_decode_step")
        sig_c = GLOBAL_COMPILE_CACHE.signatures("serve_prefill_chunk")
        eng2 = GenerationEngine(
            LlamaSlotBackend(model, 2, 32, prefix_cache_bytes=0),
            prefill_chunk=8)
        h2 = eng2.submit(prompt, max_new_tokens=3)
        eng2.run_until_idle()
        assert h2.result(1) == h.result(1)
        assert GLOBAL_COMPILE_CACHE.signatures("serve_decode_step") == sig_d
        assert GLOBAL_COMPILE_CACHE.signatures(
            "serve_prefill_chunk") == sig_c


class TestTpEngineOnCpu:
    def test_tp2_composition_identity_lean(self, gang):
        """One tp = 2 engine through paging, a radix graft, chunked
        prefill, speculation and a preemption-resume: every rank's
        streams equal the reference's tp = 2 engine and its static
        generate(); per-rank pool bytes exactly half the tp = 1 engine's
        and the reference's global pool; at most one new decode and one
        new verify signature, none after the preemption; the tp gauges,
        snapshot and debug_state."""
        c = gang["cases"]["lean"]
        jeng = JEngine.from_model(
            gang["model"], gang["variables"], num_slots=2, max_len=64,
            prefill_chunk=8, block_size=8, prefill_budget=16, tp=2)
        want = _jax_serve(jeng, [c["pa"], c["pb"]], c["new"])
        assert want == c["refs"]
        jbytes = sum(x.size * x.dtype.itemsize
                     for x in jax.tree_util.tree_leaves(jeng.backend.cache)
                     if getattr(x, "ndim", 0) == 4)
        assert _same(gang, "lean_type") == \
            "TensorParallelPagedLlamaSlotBackend"
        assert _same(gang, "lean_paged_tp") == [True, 2]
        verifies, state, n = _same(gang, "lean_mid")
        assert verifies >= 1 and state == "running" and 0 < n < c["new"]
        assert _same(gang, "lean_streams") == c["refs"]
        pre, spec, hits, tp, dev = _same(gang, "lean_snap")
        assert pre == 1 and spec >= 1 and hits >= 1 and tp == 2
        dev_bytes = _same(gang, "lean_bytes")
        assert dev == dev_bytes
        assert dev_bytes * 2 == _same(gang, "lean_bytes_tp1") == jbytes
        d_new, v_new, v_after = _same(gang, "lean_sig")
        assert d_new <= 1 and v_new <= 1 and v_after == 0
        assert _same(gang, "lean_gauges") == [2, dev_bytes]
        assert _same(gang, "lean_debug") == [2, dev_bytes]

    def test_tp2_sharded_decode_kernels_token_identity(self, gang):
        """The paged and the unpaged tp = 2 engines run their decode
        kernels' plain versions (CPU tensors) on each rank's heads
        through the head-sharded dispatch — once a layer a decode step —
        and stay the reference's static generate() token for token; with
        the dispatch off (``SPARKDL_FLASH_DECODE=0``,
        ``SPARKDL_SERVE_PAGED_KERNEL=0``) they dispatch nothing and emit
        the same tokens."""
        c = gang["cases"]["kernel"]
        layers = L.LlamaConfig.tiny().num_layers
        for name in ("paged", "dense"):
            assert _same(gang, f"kernel_{name}") == c["refs"], name
            calls, steps = _same(gang, f"kernel_{name}_dispatch")
            assert calls == layers * steps > 0, (name, calls, steps)
            assert _same(gang, f"kernel_{name}_off") == c["refs"], name
            calls, steps = _same(gang, f"kernel_{name}_off_dispatch")
            assert calls == 0 < steps, (name, calls, steps)

    def test_tp_int8_token_parity(self, gang):
        """int8 KV codes + scale plane + int8 weights: tp 1/2 × paged
        kernel off/forced emit the same streams, which are the reference's
        int8 engine's; per-rank bytes (codes and plane) exactly half;
        the plane holds the rank's heads; and each rank's int8 codes and
        scales are the slice of the reference's quantize_params of the
        global tree that the rules give it."""
        c = gang["cases"]["int8"]
        want = _jax_serve(JEngine.from_model(
            gang["model"], gang["variables"], num_slots=3, max_len=48,
            block_size=8, prefill_chunk=8, kv_dtype="int8",
            weight_dtype="int8"), c["prompts"], c["new"])
        assert all(len(s) == c["new"] for s in want)
        for tp, k in ((1, "0"), (1, "1"), (2, "0"), (2, "1")):
            assert _same(gang, f"int8_tp{tp}_k{k}") == want, (tp, k)
        plane = _same(gang, "int8_plane_bytes")
        codes = _same(gang, "int8_code_bytes")
        assert plane > 0
        assert _same(gang, "int8_tp2_bytes") == codes + plane
        assert _same(gang, "int8_tp2_bytes") * 2 == \
            _same(gang, "int8_tp1_bytes")
        assert _same(gang, "int8_plane_shape")[1:] == [1, 2]
        kv_dtype, scale_bytes = _same(gang, "int8_pool_stats")
        assert kv_dtype == "int8" and scale_bytes > 0
        q = _numpy(JL.quantize_params(gang["variables"]["params"]))
        port = L.LlamaModel(L.LlamaConfig.tiny(), device="cpu")
        names = {id(p): n for n, p in port.state_dict(keep_vars=True).items()}
        checked = 0
        for (path, param, transposed) in L._param_map(port):
            name = names[id(param)]
            if "base" not in name:
                continue
            leaf = q
            for key in path:
                leaf = leaf[key]
            glob = leaf.T if transposed else leaf
            scale = q
            for key in path[:-1] + ("kernel_scale",):
                scale = scale[key]
            column = path[-3] in ("q_proj", "k_proj", "v_proj",
                                  "gate_proj", "up_proj")
            for r, out in enumerate(gang["outs"]):
                local = out["int8_local/" + name].numpy()
                lscale = out["int8_local/" + name + "_scale"].numpy()
                if column:   # [out, in] rows and their scales split
                    n = glob.shape[0] // 2
                    want_c, want_s = glob[r * n:(r + 1) * n], \
                        scale[r * n:(r + 1) * n]
                else:        # row-parallel: columns split, scales whole
                    n = glob.shape[1] // 2
                    want_c, want_s = glob[:, r * n:(r + 1) * n], scale
                np.testing.assert_array_equal(local, want_c, err_msg=name)
                np.testing.assert_array_equal(lscale, want_s, err_msg=name)
            checked += 1
        assert checked == 2 * 7

    def test_odd_widths_stay_whole_and_gather_nothing(self, gang):
        """Where ``divisible_rules`` leaves an odd dim whole (MLP 251,
        vocabulary 509 at tp 2), the rank holds it whole and its product
        is neither reduced nor gathered; the heads and the embedding's
        hidden dim still split, and the streams are the reference's
        static generate()."""
        assert _same(gang, "odd_streams") == gang["cases"]["odd"]["refs"]
        assert _same(gang, "odd_widths") == [2, 1, 64, 251, 509]
        assert _same(gang, "odd_groups") == [True, True, False]

    def test_tp_gauges_zero_registration_when_plane_off(self):
        from sparkdl_tpu_torch.runner import telemetry
        from sparkdl_tpu_torch.serving import StubBackend
        assert not telemetry.enabled()
        eng = GenerationEngine(StubBackend(2, 32), prefill_chunk=8)
        h = eng.submit([1, 2, 3], max_new_tokens=2)
        eng.run_until_idle()
        assert h.result(1)
        assert eng.tp_degree == 1
        assert eng.kv_pool_device_bytes is None
        assert telemetry.registry().snapshot()["gauges"] == {}

    def test_per_device_kv_pool_mb_budget_buys_tp_times_blocks(self, gang):
        """``kv_pool_mb`` is a per-device budget: the same figure buys
        about tp times the blocks, inside the budget on each rank; the
        block counts are the reference engine's."""
        _, jmodel, jvars = _tp4_model()
        got = _same(gang, "budget")
        for tp in (1, 2):
            jeng = JEngine.from_model(jmodel, jvars, num_slots=2,
                                      max_len=32, block_size=8,
                                      kv_pool_mb=0.25, tp=tp)
            assert got[tp][0] == jeng.backend.pool_blocks, tp
            assert got[tp][1] == jeng.kv_pool_device_bytes, tp
        (b1, _), (b2, dev2) = got[1], got[2]
        assert b2 >= 2 * b1 - 1, (b1, b2)
        assert dev2 <= 0.25 * 2 ** 20

    def test_rank0_clock_ends_a_deadline_at_one_step(self, gang):
        """Rank 1's clock jumps 10 s (one iteration) after submit: read
        on its own (a tp = 1 engine on each rank) it expires the request
        one iteration before rank 0 does; the tp = 2 engine reads rank
        0's clock on both ranks and ends the request at the same step,
        with the same tokens delivered."""
        outs = gang["outs"]
        local = [o["clock_local"] for o in outs]
        assert local[0][0] == local[1][0] == "deadline"
        assert local[1][1] == local[0][1] - 1 > 0, local
        assert local[1][3] == local[0][3] - 1, local
        tp = _same(gang, "clock_tp2")
        assert tp == local[0], (tp, local)

    def test_deadline_runs_from_submit_after_an_idle_gap(self, gang):
        """After 100 s with no iteration, a request whose 35 s deadline
        covers the two iterations it needs completes on the tp = 2
        engine as on the tp = 1 one: its limit runs from the group's
        clock at its submit, not from the last iteration's."""
        for o in gang["outs"]:
            assert o["clock_idle_local"] == ["length", 2], o
        assert _same(gang, "clock_idle_tp2") == ["length", 2]

    def test_start_raises_under_tp_naming_the_roadmap(self, gang):
        assert "A 8 (d)" in _same(gang, "start_tp2")

    @pytest.mark.slow
    def test_tp_full_matrix(self, tmp_path):
        """tp ∈ {1, 2, 4} × {paged + spec, unpaged no spec} on a 4-rank
        gang: every stream the reference's static generate(), every rank
        alike, per-rank bytes 1/tp; ``tp_mesh`` cuts the gang into groups
        of consecutive ranks."""
        cfg, model, variables = _tp4_model()
        rng = np.random.RandomState(5)
        head = rng.randint(0, cfg.vocab_size, 16).tolist()
        prompts = [head + rng.randint(0, cfg.vocab_size, n).tolist()
                   for n in (3, 6, 11)]
        refs = _static_refs(model, variables, prompts, 8, 64)
        torch.save(_numpy(variables["params"]), tmp_path / "tp4.pt")
        torch.save({"matrix": dict(prompts=prompts, refs=refs, new=8)},
                   tmp_path / "cases.pt")
        outs = _launch(tmp_path, "matrix", 4)
        assert [o["groups"] for o in outs] == [
            [[0], [0, 1], [0, 1, 2, 3]], [[1], [0, 1], [0, 1, 2, 3]],
            [[2], [2, 3], [0, 1, 2, 3]], [[3], [2, 3], [0, 1, 2, 3]]]
        for paged in (True, False):
            dev = {}
            for tp in (1, 2, 4):
                key = f"matrix_{paged}_{tp}"
                for o in outs:
                    streams, dev[tp], degree = o[key]
                    assert streams == refs, key
                    assert degree == tp
            assert dev[2] * 2 == dev[1] and dev[4] * 4 == dev[1]


class TestHeadShardedKernel:
    """Twins of ``tests/test_paged_flash_decode.py``'s mesh cases."""

    def test_mesh_routes_through_shard_map_gate(self, gang):
        """Under a mesh the paged resolver keeps its one-device rules:
        auto dispatches through the head-sharded wrapper (on a CPU gang
        too), ``SPARKDL_SERVE_PAGED_KERNEL=0`` turns it off, ``=1`` beats
        ``SPARKDL_FLASH_DECODE=0``, and auto follows that lever."""
        g = _same(gang, "gating")
        assert g["paged_auto_wraps"]
        assert g["paged_auto_name"] == "head_sharded_paged_flash_decode"
        assert g["paged_off"]
        assert g["paged_force_beats_dense_lever"]
        assert g["paged_auto_follows_dense_lever"]

    def test_dense_decode_fn_for_mesh_gating(self, gang):
        g = _same(gang, "gating")
        assert g["dense_auto_wraps"]
        assert g["dense_auto_name"] == "head_sharded_flash_decode"
        assert g["dense_lever_wins"]

    def test_head_sharded_kernel_matches_unsharded(self, gang):
        """Over DTensor q / K / V sharded on the heads of the 2-rank
        mesh, both decode functions' plain versions are bitwise the
        unsharded call (an int8 pool's plain scale plane shards with its
        heads); the output comes back Shard(1); the paged output is the
        reference kernel's (interpret mode); a GQA group split across
        ranks raises."""
        c = gang["cases"]["pool"]
        assert _same(gang, "hs_paged_bitwise")
        assert _same(gang, "hs_int8_bitwise")
        assert _same(gang, "hs_dense_bitwise")
        assert "Shard(dim=1)" in _same(gang, "hs_paged_placements")
        want = jpfd.paged_flash_decode(
            *(jax.numpy.asarray(c[k]) for k in
              ("q", "k", "v", "tables", "cur", "pads")), interpret=True)
        np.testing.assert_allclose(_same(gang, "hs_paged").numpy(),
                                   np.asarray(want), **F32)
        assert _same(gang, "hs_names") == ["head_sharded_flash_decode",
                                           "flash_decode"]
        for o in gang["outs"]:   # rank 0 holds KV head 0, rank 1 none
            assert "break the global Hq:Hkv ratio 4:1" in o["hs_ratio"]
