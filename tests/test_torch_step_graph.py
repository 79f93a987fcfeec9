"""The compiled decode step of the port (``core.runtime.CompileCache.get``)
in its CPU mode, held against the JAX package's compiled steps.

On a CUDA device every S = 1 step of ``generate()``'s decode loop and of
both serving backends is replayed from a captured CUDA graph; on the CPU
the same step function runs eagerly through the same static buffers,
which is what these tests drive. The JAX side runs as its own tests run
it: ``_decode``, ``slot_decode_step`` and ``paged_slot_decode_step``
jitted, with the flash ``attn_fn`` so its Pallas kernels run in interpret
mode (``max_len`` 128, pool blocks of 8). Both carry the same weights
(``load_flax_params``) at ``LlamaConfig.tiny()`` in f32.

What must agree: greedy tokens and step counts exactly; logits within
atol = rtol = 1e-4, the tolerance ``tests/test_torch_llama.py`` states
(two layers of f32 matmuls summed in other orders); an int8 pool's codes
within 1 LSB and its scales within 1e-6 relative, as
``tests/test_torch_serving_primitives.py`` states. The cache's host and
device fill indices must be equal after every step.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash
from sparkdl_tpu_torch.core import runtime
from sparkdl_tpu_torch.models import llama as L
from sparkdl_tpu_torch.ops import flash_attention as fa
from sparkdl_tpu_torch.serving.backend import (LlamaSlotBackend,
                                               PagedLlamaSlotBackend)

LOGIT_TOL = 1e-4
MAX_LEN, BS, POOL = 128, 8, 24
PROMPTS = [[5, 6, 7], [9, 3, 2, 8, 1, 4, 4, 7, 2, 9, 11],
           [17, 2, 30, 41, 7, 6]]
NEW = 6


@pytest.fixture(scope="module")
def models():
    jm = JL.LlamaModel(JL.LlamaConfig.tiny(), attn_fn=jax_flash)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    tm = L.load_flax_params(L.LlamaModel(L.LlamaConfig.tiny(),
                                         attn_fn=fa.flash_attention,
                                         device="cpu"), params)
    logits = jax.jit(lambda p, c, tok, **kw: jm.apply(
        {"params": p, "cache": c}, tok[:, None], decode=True,
        mutable=["cache"], **kw)[0][:, -1])
    return jm, params, tm, logits


@pytest.fixture
def spy(monkeypatch):
    """Every ``CompileCache.get``: its name, whether its step ran in the
    CPU mode, and a copy of what it returned."""
    calls = []
    real = runtime.CompileCache.get

    def get(self, name, key, fn, inputs, counters=()):
        out = real(self, name, key, fn, inputs, counters)
        step = self._steps[(name, key)]
        calls.append((name, step.device.type, step.graph is None,
                      out.clone()))
        return out

    monkeypatch.setattr(runtime.CompileCache, "get", get)
    return calls


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, 512, n).tolist()


@pytest.mark.parametrize("eos", [False, True])
def test_decode_loop_through_the_runner_matches_jax(models, spy, eos):
    """``_decode`` with and without eos: every step through the runner's
    CPU mode, tokens and step counts equal to the JAX loop's, the host
    and device fill indices equal at the end."""
    jm, params, tm, _ = models
    # with eos, one row, so that the loop stops early
    ids, pads = JL.left_pad_prompts(PROMPTS[:1] if eos else PROMPTS)
    max_len = ids.shape[1] + NEW
    jcache = JL.init_cache(jm, ids.shape[0], max_len)
    jlast, jcache = JL._prefill(jm, params, jnp.asarray(ids), jcache,
                                jnp.asarray(pads))
    kw = {}
    if eos:
        free, _ = JL._decode(jm, params, jcache, jlast,
                             jax.random.PRNGKey(0), jnp.asarray(pads),
                             max_new_tokens=NEW, temperature=0.0)
        kw["eos_id"] = int(np.asarray(free)[0, 1])
    want, want_steps = JL._decode(jm, params, jcache, jlast,
                                  jax.random.PRNGKey(0), jnp.asarray(pads),
                                  max_new_tokens=NEW, temperature=0.0, **kw)
    cache = L.init_cache(tm, ids.shape[0], max_len)
    last = L._prefill(tm, torch.from_numpy(ids).long(), cache,
                      torch.from_numpy(pads))
    assert int(cache.idx_dev) == cache.idx == ids.shape[1]
    got, steps = L._decode(tm, cache, last, None, torch.from_numpy(pads),
                           max_new_tokens=NEW, temperature=0.0, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(want_steps)
    assert (steps < NEW) == eos
    assert [c[:3] for c in spy] == [("decode_step", "cpu", True)] * steps
    assert cache.idx == int(cache.idx_dev) == ids.shape[1] + steps


def test_decode_step_logits_and_fill_indices_match_jax(models):
    """Five S = 1 steps through one runner, fed the same tokens as the
    JAX model: logits within the stated tolerance at every step, the
    host and device fill indices equal after each."""
    jm, params, tm, jlogits = models
    ids, pads = JL.left_pad_prompts(PROMPTS)
    max_len = ids.shape[1] + 5
    jcache = JL.init_cache(jm, ids.shape[0], max_len)
    _, jcache = JL._prefill(jm, params, jnp.asarray(ids), jcache,
                            jnp.asarray(pads))
    cache = L.init_cache(tm, ids.shape[0], max_len)
    L._prefill(tm, torch.from_numpy(ids).long(), cache,
               torch.from_numpy(pads))
    graphs = runtime.CompileCache()
    tpads = torch.from_numpy(pads)
    toks = np.random.RandomState(1).randint(1, 512, (5, ids.shape[0]))
    for i, tok in enumerate(toks):
        want = jlogits(params, jcache, jnp.asarray(tok),
                       pad_lens=jnp.asarray(pads))
        _, jcache = jm.apply({"params": params, "cache": jcache},
                             jnp.asarray(tok)[:, None], decode=True,
                             pad_lens=jnp.asarray(pads), mutable=["cache"])
        jcache = jcache["cache"]
        src = torch.from_numpy(tok).long()
        got = graphs.get("decode_step", "key",
                         lambda t, p: L._decode_step(tm, cache, t, p),
                         (src, tpads))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        assert cache.idx == int(cache.idx_dev) == ids.shape[1] + i + 1
    assert len(graphs._steps) == 1
    step = graphs._steps[("decode_step", "key")]
    # the buffers are the step's own: inputs were copied in, not aliased
    assert step.static[0] is not src and torch.equal(step.static[0], src)
    graphs.drop()
    assert len(graphs._steps) == 0


def test_step_graph_checks_its_inputs():
    """A step's inputs must keep the signature it was made with: the
    same count, None where None was, the same shapes."""
    step = runtime.StepGraph(lambda a, b: a * 2, (torch.ones(3), None))
    assert torch.equal(step((torch.full((3,), 4.0), None)),
                       torch.full((3,), 8.0))
    with pytest.raises(ValueError, match="signature"):
        step((torch.ones(4), None))
    with pytest.raises(ValueError, match="signature"):
        step((torch.ones(3), torch.ones(3)))
    with pytest.raises(ValueError, match="inputs"):
        step((torch.ones(3),))


def test_a_failed_step_raises_and_leaves_no_step_behind():
    """A step that fails on its first call (where the card captures it)
    raises to the caller, with no eager stand-in, and is not kept: the
    next call makes the step anew."""
    graphs = runtime.CompileCache()
    calls = []

    def fn(x):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("capture refused")
        return x + 1

    with pytest.raises(RuntimeError, match="capture refused"):
        graphs.get("step", "k", fn, (torch.zeros(2),))
    assert graphs._steps == {}
    assert torch.equal(graphs.get("step", "k", fn, (torch.zeros(2),)),
                       torch.ones(2))
    assert len(graphs._steps) == 1 and len(calls) == 2


def _backend_logits(spy, n_before):
    assert [c[:3] for c in spy[n_before:]] == [
        ("serve_decode_step", "cpu", True)]
    return spy[-1][3]


def _jax_quant_leaves(jpool, names):
    n = len(jpool)
    return {name: [np.asarray(jpool[f"layer_{i}"]["attn"][name])
                   for i in range(n)] for name in names}


@pytest.mark.parametrize("kind", ["unpaged", "paged", "paged_int8"])
def test_backend_step_through_the_runner_matches_jax(models, spy, kind):
    """``LlamaSlotBackend.step`` / ``PagedLlamaSlotBackend.step`` (the
    runner's CPU mode) against ``slot_decode_step`` /
    ``paged_slot_decode_step``: two slots refilled at different buckets,
    one parked, four steps; tokens equal, logits within the stated
    tolerance, the int8 pool (written through ``_quant_insert_rows``)
    within 1 LSB and its scales within 1e-6 relative."""
    jm, params, tm, jlogits = models
    quant = "int8" if kind == "paged_int8" else None
    paged = kind != "unpaged"
    if paged:
        be = PagedLlamaSlotBackend(tm, 3, MAX_LEN, block_size=BS,
                                   pool_blocks=POOL, kv_dtype=quant,
                                   prefix_cache_bytes=0)
        jcache = JL.init_paged_pool(jm, be.pool_blocks, BS, kv_quant=quant)
    else:
        be = LlamaSlotBackend(tm, 3, MAX_LEN, prefix_cache_bytes=0)
        jcache = JL.init_cache(jm, 3, MAX_LEN)
    key = jax.random.PRNGKey(0)
    for slot, (seed, n, bucket) in ((1, (1, 11, 16)), (0, (2, 5, 8))):
        prompt = _prompt(seed, n)
        tok = be.prefill(slot, prompt, bucket)
        ids, pad = JL.left_pad_prompts([prompt], pad_to=bucket)
        if paged:
            jt, jcache = JL.paged_prefill_into_slot(
                jm, params, ids, pad, jcache, jnp.asarray(be.tables[slot]),
                key)
        else:
            jt, jcache = JL.prefill_into_slot(jm, params, ids, pad, jcache,
                                              jnp.int32(slot), key)
        assert int(jt[0]) == tok
    active = [0, 1]
    for _ in range(4):
        if paged:
            for s in active:
                assert be.ensure_block_for(s, int(be._cur[s]))
        ops = [jnp.asarray(a.copy()) for a in (be._tokens, be._cur,
                                               be._pads)]
        tables = {} if not paged else {"block_tables":
                                       jnp.asarray(be.tables.copy())}
        want = jlogits(params, jcache, ops[0], slot_cur=ops[1],
                       pad_lens=ops[2], **tables)
        if paged:
            jn, jcache = JL.paged_slot_decode_step(
                jm, params, jcache, tables["block_tables"], *ops, key)
        else:
            jn, jcache = JL.slot_decode_step(jm, params, jcache, *ops, key)
        n_before = len(spy)
        got = be.step(active)
        assert [got[s] for s in active] == np.asarray(jn)[active].tolist()
        np.testing.assert_allclose(
            _backend_logits(spy, n_before).numpy()[active],
            np.asarray(want)[active], atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert len(be.graphs._steps) == 1
    if quant:
        want = _jax_quant_leaves(jcache, ("k", "v", "kv_scale"))
        for got, exp in zip(be.cache.k + be.cache.v, want["k"] + want["v"]):
            diff = np.abs(got[1:].numpy().astype(np.int32)
                          - exp[1:].astype(np.int32))
            assert diff.max() <= 1
        for got, exp in zip(be.cache.kv_scale, want["kv_scale"]):
            np.testing.assert_allclose(got[1:].numpy(), exp[1:], rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize("paged", [False, True])
def test_rebuild_drops_the_runners_steps(models, paged):
    """A new cache (``rebuild()`` after a lost one) drops the captured
    steps, which point into the old cache; the next step makes its own
    under a key that names the new cache."""
    _, _, tm, _ = models
    be = (PagedLlamaSlotBackend(tm, 2, 64, block_size=BS, pool_blocks=12)
          if paged else LlamaSlotBackend(tm, 2, 64))
    be.prefill(0, [5, 6, 7], 8)
    if paged:
        be.ensure_block_for(0, 8)
    be.step([0])
    assert len(be.graphs._steps) == 1
    (old_key,) = be.graphs._steps
    be.rebuild()
    assert len(be.graphs._steps) == 0
    be.prefill(0, [5, 6, 7], 8)
    if paged:
        be.ensure_block_for(0, 8)
    be.step([0])
    (new_key,) = be.graphs._steps
    assert len(be.graphs._steps) == 1 and new_key != old_key


def test_sampled_backend_step_draws_as_the_eager_step(models):
    """Sampling runs after the step, eagerly: a sampled backend's tokens
    equal the eager ``slot_decode_step`` with a generator of the same
    seed, on the same cache contents."""
    _, _, tm, _ = models
    kw = dict(temperature=0.9, top_k=40, top_p=0.95)
    be = LlamaSlotBackend(tm, 3, 64, seed=3, prefix_cache_bytes=0, **kw)
    ref = L.init_cache(tm, 3, 64)
    gen = torch.Generator().manual_seed(3)
    for slot, p in ((0, [5, 6, 7]), (2, [9, 3, 2, 8, 1])):
        be.prefill(slot, p, 8)
        ids, pad = L.left_pad_prompts([p], pad_to=8)
        L.prefill_into_slot(tm, ids, pad, ref, slot, gen, **kw)
    for _ in range(3):
        tok, cur, pads = (torch.from_numpy(a.copy()).to(dt) for a, dt in (
            (be._tokens, torch.int64), (be._cur, torch.int32),
            (be._pads, torch.int32)))
        want = L.slot_decode_step(tm, ref, tok, cur, pads, gen, **kw)
        got = be.step([0, 2])
        assert [got[0], got[2]] == [int(want[0]), int(want[2])]


def test_support_reason_lets_gradients_through():
    """The kernels have a backward now: ``support_reason`` lets tensors
    that would reach them (meta tensors stand in for CUDA ones here)
    through whether or not they require grad, in or out of grad mode, and
    still refuses a head dim or dtype the kernels do not take. CPU
    tensors that require grad train through the plain versions."""
    def qkv(device, grad, d=64, dtype=torch.float32):
        return [torch.empty((1, 2, 8, d), device=device, dtype=dtype,
                            requires_grad=grad) for _ in range(3)]

    for grad in (False, True):
        assert fa.support_reason(*qkv("meta", grad)) is None
        assert fa.support_reason(*qkv("meta", grad, d=128,
                                      dtype=torch.bfloat16)) is None
        assert "head_dim 32" in fa.support_reason(*qkv("meta", grad, d=32))
        assert "float16" in fa.support_reason(
            *qkv("meta", grad, dtype=torch.float16))
    with torch.no_grad():
        assert fa.support_reason(*qkv("meta", True)) is None
    assert not hasattr(fa, "gradient_reason")
    q, k, v = (torch.randn((1, 2, 8, 64), requires_grad=True)
               for _ in range(3))
    assert fa.support_reason(q, k, v) is None
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (q, k, v))


def test_launch_counts_of_a_capture_stay_on_its_thread():
    """Engines step on several threads at once (a fleet's replicas). A
    thread capturing a graph counts its wrappers' launches into its own
    tally (what each replay then adds), never into the shared counts, and
    the launches other threads make meanwhile land in the shared counts
    whole: 4 threads × 2000 launches while one thread holds a tally."""
    import sys
    import threading

    from sparkdl_tpu_torch.ops import _build

    class Wrapper:
        launches = 0

    w = Wrapper()
    go = threading.Event()
    ready = threading.Barrier(5)
    held = {}

    def capturing():
        with _build.capture_tally() as tally:
            ready.wait(10)
            for _ in range(7):
                _build.count_launch(w)
            go.wait(10)
            held.update(tally)

    def launching():
        ready.wait(10)
        for _ in range(2000):
            _build.count_launch(w)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=capturing)] + [
            threading.Thread(target=launching) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads[1:]:
            t.join(30)
        go.set()
        threads[0].join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert held == {w: 7}
    assert w.launches == 4 * 2000
    _build.count_launch(w, 7)  # a replay adds what the capture counted
    assert w.launches == 8007
