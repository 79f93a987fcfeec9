"""The port's serving engine (``sparkdl_tpu_torch.serving``) held against
the JAX package's, end to end: the same requests and knobs through both
``GenerationEngine.from_model`` give identical greedy streams.

Both models carry the same weights (``load_flax_params``) at
``LlamaConfig.tiny()`` in f32 on the CPU. The port's model gets
``attn_fn=flash_attention``, so its kernel paths run (their plain versions
on the CPU); the JAX model gets its flash ``attn_fn``, so its kernels run
in interpret mode: ``max_len`` 128 (the JAX flash-decode needs
``L % 128 == 0``) and ``block_size`` 8 (its paged kernel needs
``bs % 8 == 0``). Knobs are set per test (``monkeypatch``); chaos plans
are installed in each package's own ``runner.chaos`` and removed after.

Covered: the unpaged default (stall-free chunks and the prefix LRU), the
unpaged blocking refill, paged with radix grafts and chunked prefill,
``spec_k=2``, a pool small enough to force a preemption-resume, a chaos
``cache_lost`` failover, and the int8 pool. Tolerance: none — tokens are
compared for equality. One ``StubBackend`` scenario runs through both
packages' engines and checks streams and ``stats`` equal, which holds the
copied device-free modules (scheduler, paging, prefix trie) to their
originals.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash
from sparkdl_tpu.runner import chaos as jchaos
from sparkdl_tpu.serving import GenerationEngine as JEngine
from sparkdl_tpu.serving import StubBackend as JStub
from sparkdl_tpu_torch import GenerationEngine
from sparkdl_tpu_torch.models import llama as L
from sparkdl_tpu_torch.ops import flash_attention as fa
from sparkdl_tpu_torch.runner import chaos
from sparkdl_tpu_torch.serving import StubBackend

MAX_LEN, NEW = 128, 6


@pytest.fixture(scope="module")
def models():
    jm = JL.LlamaModel(JL.LlamaConfig.tiny(), attn_fn=jax_flash)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    tm = L.LlamaModel(L.LlamaConfig.tiny(), attn_fn=fa.flash_attention,
                      device="cpu")
    return jm, params, tm


def _prompts(n_extra=0):
    rng = np.random.RandomState(7)
    head = rng.randint(1, 512, 16).tolist()     # two shared blocks of 8
    out = [head + rng.randint(1, 512, n).tolist() for n in (3, 7)]
    out += [rng.randint(1, 512, n).tolist() for n in (5, 21)]
    out += [head + rng.randint(1, 512, 4).tolist()] * n_extra
    return out


def _serve(engine, prompts, new=NEW):
    hs = [engine.submit(p, max_new_tokens=new) for p in prompts]
    engine.run_until_idle()
    return [h.result(1) for h in hs], engine.snapshot()


def _both(models, prompts, new=NEW, **kw):
    """Greedy streams (and snapshots) of the JAX engine and the port's."""
    jm, params, tm = models
    want, jsnap = _serve(JEngine.from_model(
        jm, {"params": params}, num_slots=3, max_len=MAX_LEN, **kw),
        prompts, new)
    got, snap = _serve(GenerationEngine.from_model(
        tm, {"params": params}, num_slots=3, max_len=MAX_LEN, device="cpu",
        **kw), prompts, new)
    return got, want, snap, jsnap


@pytest.mark.parametrize("name,kw", [
    ("unpaged_stall_free", {}),
    ("unpaged_blocking", dict(stall_free=False, min_bucket=8)),
    ("paged_radix_chunked", dict(block_size=8, prefill_chunk=8)),
    ("paged_spec_k2", dict(block_size=8, prefill_chunk=8, spec_k=2)),
    ("paged_int8", dict(block_size=8, prefill_chunk=8, kv_dtype="int8")),
])
def test_engine_streams_match_jax(models, name, kw):
    prompts = _prompts(n_extra=1 if "paged" in name else 0)
    got, want, snap, jsnap = _both(models, prompts, **kw)
    assert got == want, name
    assert snap["completed"] == len(prompts) == jsnap["completed"]
    if name == "paged_radix_chunked":
        assert snap["prefix_cache"]["hits"] >= 1   # the radix graft ran
        assert snap["prefix_cache"]["hits"] == jsnap["prefix_cache"]["hits"]
    if name == "paged_spec_k2":
        assert snap["spec_verifies"] >= 1
        assert snap["spec_tokens_accepted"] == jsnap["spec_tokens_accepted"]
    if name == "paged_int8":
        assert snap["kv_pool"]["kv_dtype"] == "int8"


def test_preemption_resume_matches_jax(models, monkeypatch):
    """A pool that holds each request alone but not two at once: decode
    growth stalls every running slot, the newest is preempted and
    resumes; streams still equal the JAX engine's."""
    monkeypatch.setenv("SPARKDL_SERVE_PREFIX_CACHE_MB", "0")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 512, 12).tolist() for _ in range(2)]
    got, want, snap, jsnap = _both(models, prompts, new=24, block_size=8,
                                   prefill_chunk=8, pool_blocks=8)
    assert snap["preemptions"] >= 1 and jsnap["preemptions"] >= 1
    assert got == want


def test_cache_lost_failover_matches_jax(models):
    """An injected cache_lost at the first decode step: the port's engine
    rebuilds its backend (fresh pool and tables) and re-admits the live
    requests exactly once; streams equal the JAX engine's under the same
    fault."""
    def plan(lib):
        return lib.FaultPlan([lib.Fault("serve_decode", "cache_lost",
                                        prob=1.0)])
    jm, params, tm = models
    prompts = _prompts()
    kw = dict(num_slots=3, max_len=MAX_LEN, block_size=8, prefill_chunk=8,
              retries=1)
    jchaos.install(plan(jchaos))
    try:
        want, jsnap = _serve(JEngine.from_model(jm, {"params": params},
                                                **kw), prompts)
    finally:
        jchaos.uninstall()
    chaos.install(plan(chaos))
    try:
        got, snap = _serve(GenerationEngine.from_model(
            tm, {"params": params}, device="cpu", **kw), prompts)
    finally:
        chaos.uninstall()
    assert got == want
    assert snap["failovers"] == jsnap["failovers"] == 1
    assert snap["failover"]["state"] == "recovered"


def test_stub_backend_scenario_matches_jax_engine():
    """The copied scheduler against the original on a device-free paged
    stub: radix grafts, chunk budgets, speculation and backpressure give
    the same streams and the same counters."""
    def run(engine_cls, stub_cls):
        be = stub_cls(3, 64, vocab_size=97, block_size=4, pool_blocks=20)
        eng = engine_cls(be, prefill_chunk=4, prefill_budget=8, spec_k=2)
        out, snap = _serve(eng, [[1, 2, 3, 4, 5, 6, 7, 8, 9],
                                 [1, 2, 3, 4, 5, 6, 7, 8, 2],
                                 [4, 4, 4, 4, 4], list(range(10, 30)),
                                 [1, 2, 3, 4, 5, 6, 7, 8, 9]], new=9)
        return out, {k: v for k, v in eng.stats.items()
                     if not k.endswith("_s")}, snap["kv_pool"]
    assert run(GenerationEngine, StubBackend) == run(JEngine, JStub)


def test_from_model_refuses_what_is_not_ported(models, monkeypatch):
    """Tensor-parallel serving outside a gang raises make_mesh's
    ValueError (a tp engine is a group of processes, one a device); int8
    projection weights and the registry-paired draft (A 2's first half)
    now build; a weight mode other than int8 raises the reference's
    ValueError."""
    _, _, tm = models
    with pytest.raises(ValueError, match="make_mesh needs a "
                                         "torch.distributed gang"):
        GenerationEngine.from_model(tm, device="cpu", tp=2)
    fresh = L.LlamaModel(L.LlamaConfig.tiny(), device="cpu")
    eng = GenerationEngine.from_model(fresh, device="cpu",
                                      weight_dtype="int8", num_slots=1,
                                      max_len=32)
    assert eng.backend.weight_dtype == "int8" == fresh.weight_quant
    assert fresh.layers[0].attn.q_proj.base.weight.dtype == torch.int8
    with pytest.raises(ValueError, match="int8 only"):
        GenerationEngine.from_model(
            L.LlamaModel(L.LlamaConfig.tiny(), device="cpu"), device="cpu",
            weight_dtype="fp8", num_slots=1, max_len=32)
    monkeypatch.setenv("SPARKDL_SERVE_TP", "2")
    with pytest.raises(ValueError, match="make_mesh needs a "
                                         "torch.distributed gang"):
        GenerationEngine.from_model(tm, device="cpu")
    monkeypatch.delenv("SPARKDL_SERVE_TP")
    with pytest.raises(ValueError, match="requires the paged"):
        GenerationEngine.from_model(tm, device="cpu", kv_dtype="int8")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            GenerationEngine.from_model(tm)
    from sparkdl_tpu_torch.serving import DraftModelProvider
    draft = DraftModelProvider.from_registry("llama_small", device="cpu")
    assert draft.model.cfg == L.LlamaConfig.tiny()
    with pytest.raises(ValueError, match="no draft pairing"):
        DraftModelProvider.from_registry("llama_tiny", device="cpu")


def test_host_error_keeps_retry_and_device_error_fails_over(models):
    """A host-side error before any launch leaves the in-place cache
    usable (the engine's per-request retry path), while a CUDA error
    becomes SlotCacheLost — serving-fatal, so the engine fails over."""
    from sparkdl_tpu_torch.ops._build import CudaError
    from sparkdl_tpu_torch.serving.backend import SlotCacheLost

    _, _, tm = models
    eng = GenerationEngine.from_model(tm, num_slots=2, max_len=MAX_LEN,
                                      block_size=8, device="cpu")
    be = eng.backend

    def host_fail(*a, **k):
        raise ValueError("bad operand")

    def device_fail(*a, **k):
        raise CudaError("paged_flash_decode: CUDA error 700 (an illegal "
                        "memory access was encountered)")

    with pytest.raises(ValueError):
        be._guarded(host_fail)
    with pytest.raises(SlotCacheLost) as info:
        be._guarded(device_fail)
    assert info.value.serving_fatal
    with pytest.raises(SlotCacheLost):
        be._guarded(lambda: (_ for _ in ()).throw(
            RuntimeError("CUDA error: device-side assert triggered")))
