"""The port's continuous-batching slot primitives held against the JAX
package's, on the same weights (``load_flax_params``) and the same
numpy-made inputs, at ``LlamaConfig.tiny()`` in f32 on the CPU.

The port's model gets ``attn_fn=flash_attention``, so its kernel paths
run (their plain versions on the CPU); the JAX model gets its flash
``attn_fn``, so its Pallas kernels run in interpret mode: a slot cache of
``max_len`` 128 (the JAX flash-decode needs ``L % 128 == 0``) and pool
blocks of 8 (its paged kernel needs ``block_size % 8 == 0``).

What must agree: sampled and proposed tokens exactly; cache and pool
contents within atol = rtol = 1e-5 (f32 on both sides, summed in other
orders); an int8 pool's codes within 1 LSB and its scales within 1e-6
relative (one LSB is the most a ≤1e-6 relative difference in a value or
a scale can move a rounded code). The trash block 0 is left out of pool
comparisons: it takes every parked and overhanging write, in no defined
order on either side, and nothing reads it live.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash
from sparkdl_tpu_torch.models import llama as L
from sparkdl_tpu_torch.ops import flash_attention as fa

ATOL = RTOL = 1e-5
MAX_LEN, BS, POOL = 128, 8, 24


@pytest.fixture(scope="module")
def models():
    jcfg = JL.LlamaConfig.tiny()
    jm = JL.LlamaModel(jcfg, attn_fn=jax_flash)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    tm = L.load_flax_params(L.LlamaModel(L.LlamaConfig.tiny(),
                                         attn_fn=fa.flash_attention,
                                         device="cpu"), params)
    return jm, params, tm


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, 512, n).tolist()


def _layers(jcache, names=("k", "v")):
    n = len(jcache)
    return {name: [np.asarray(jcache[f"layer_{i}"]["attn"][name])
                   for i in range(n)] for name in names}


def _close(got, want, skip_trash=False):
    for g, w in zip(got, want):
        g = g.float().numpy() if torch.is_tensor(g) else g
        if skip_trash:
            g, w = g[1:], w[1:]
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=ATOL,
                                   rtol=RTOL)


def test_unpaged_slot_primitives_match_jax(models):
    """Blocking refill, two prefill chunks, three decode steps at
    per-slot fill indices and a verify window: tokens equal, slot cache
    within tolerance."""
    jm, params, tm = models
    jcache = JL.init_cache(jm, 3, MAX_LEN)
    tcache = L.init_cache(tm, 3, MAX_LEN)
    key = jax.random.PRNGKey(0)
    cur, pads, toks = np.zeros(3, np.int32), np.zeros(3, np.int32), \
        np.zeros(3, np.int32)

    # slot 1: blocking refill of an 11-token prompt in a 16 bucket
    ids, pad = JL.left_pad_prompts([_prompt(1, 11)], pad_to=16)
    jt, jcache = JL.prefill_into_slot(jm, params, ids, pad, jcache,
                                      jnp.int32(1), key)
    tt = L.prefill_into_slot(tm, torch.from_numpy(np.asarray(ids)),
                             torch.from_numpy(np.asarray(pad)), tcache, 1)
    assert int(jt[0]) == int(tt[0])
    cur[1], pads[1], toks[1] = 16, int(pad[0]), int(tt[0])

    # slot 0: a 13-token prompt in two zero-aligned chunks of 8
    p0 = _prompt(2, 13)
    for off in (0, 8):
        chunk = np.zeros((1, 8), np.int32)
        part = p0[off:off + 8]
        chunk[0, :len(part)] = part
        jt, jcache = JL.prefill_chunk_into_slot(
            jm, params, jnp.asarray(chunk), jcache, jnp.int32(0),
            jnp.int32(off), jnp.int32(len(part)), key, window=16)
        tt = L.prefill_chunk_into_slot(tm, torch.from_numpy(chunk).long(),
                                       tcache, 0, off, len(part), window=16)
        assert int(jt[0]) == int(tt[0])
    cur[0], toks[0] = 13, int(tt[0])

    for _ in range(3):  # slot 2 idle, parked at 0
        args = [np.asarray(toks), np.asarray(cur), np.asarray(pads)]
        jn, jcache = JL.slot_decode_step(jm, params, jcache,
                                         *map(jnp.asarray, args), key)
        tn = L.slot_decode_step(tm, tcache, *(torch.from_numpy(a)
                                              for a in args))
        assert np.asarray(jn)[:2].tolist() == tn[:2].tolist()
        toks[:2] = tn[:2].numpy()
        cur[:2] += 1

    window = np.zeros((3, 3), np.int32)
    window[:, 0] = toks
    window[:2, 1:] = [[7, 9], [11, 3]]
    jp, jcache = JL.slot_verify_step(jm, params, jcache, jnp.asarray(window),
                                     jnp.asarray(cur), jnp.asarray(pads))
    tp = L.slot_verify_step(tm, tcache, torch.from_numpy(window).long(),
                            torch.from_numpy(cur), torch.from_numpy(pads))
    assert np.asarray(jp)[:2].tolist() == tp[:2].tolist()
    want = _layers(jcache)
    _close(tcache.k, want["k"])
    _close(tcache.v, want["v"])


def _tables():
    """Slot 0: blocks 5, 9, 2 (non-contiguous); slot 1: 7, 12, 3, 16;
    slot 2 parked on the trash block."""
    t = np.zeros((3, MAX_LEN // BS), np.int32)
    t[0, :3] = [5, 9, 2]
    t[1, :4] = [7, 12, 3, 16]
    return t


def _jax_pool_leaves(jpool, quant):
    names = ("k", "v", "kv_scale") if quant else ("k", "v")
    return _layers(jpool, names)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_paged_slot_primitives_match_jax(models, kv_quant):
    """Blocking paged refill, two chunks through a table, three decode
    steps and a verify window whose last column overhangs slot 0's table
    into the trash block: tokens equal, pool within tolerance (an int8
    pool: codes within 1 LSB, scales within 1e-6 relative)."""
    jm, params, tm = models
    jpool = JL.init_paged_pool(jm, POOL, BS, kv_quant=kv_quant)
    tpool = L.init_paged_pool(tm, POOL, BS, kv_quant=kv_quant)
    tables = _tables()
    key = jax.random.PRNGKey(0)
    cur, pads, toks = np.zeros(3, np.int32), np.zeros(3, np.int32), \
        np.zeros(3, np.int32)

    # slot 1: blocking refill, 19-token prompt in a 24 bucket (3 blocks)
    ids, pad = JL.left_pad_prompts([_prompt(3, 19)], pad_to=24)
    jt, jpool = JL.paged_prefill_into_slot(jm, params, ids, pad, jpool,
                                           jnp.asarray(tables[1]), key)
    tt = L.paged_prefill_into_slot(tm, torch.from_numpy(np.asarray(ids)),
                                   torch.from_numpy(np.asarray(pad)), tpool,
                                   torch.from_numpy(tables[1]))
    assert int(jt[0]) == int(tt[0])
    cur[1], pads[1], toks[1] = 24, int(pad[0]), int(tt[0])

    # slot 0: a 13-token prompt, zero-aligned chunks of 8 through table 0
    p0 = _prompt(4, 13)
    for off in (0, 8):
        chunk = np.zeros((1, 8), np.int32)
        part = p0[off:off + 8]
        chunk[0, :len(part)] = part
        jt, jpool = JL.paged_prefill_chunk_into_slot(
            jm, params, jnp.asarray(chunk), jpool, jnp.asarray(tables[0]),
            jnp.int32(off), jnp.int32(len(part)), key, window=16)
        tt = L.paged_prefill_chunk_into_slot(
            tm, torch.from_numpy(chunk).long(), tpool,
            torch.from_numpy(tables[0]), off, len(part), window=16)
        assert int(jt[0]) == int(tt[0])
    cur[0], toks[0] = 13, int(tt[0])

    for _ in range(3):
        args = [toks, cur, pads]
        jn, jpool = JL.paged_slot_decode_step(
            jm, params, jpool, jnp.asarray(tables),
            *map(jnp.asarray, args), key)
        tn = L.paged_slot_decode_step(tm, tpool, torch.from_numpy(tables),
                                      *(torch.from_numpy(a) for a in args))
        assert np.asarray(jn)[:2].tolist() == tn[:2].tolist()
        toks[:2] = tn[:2].numpy()
        cur[:2] += 1

    # verify: slot 0 at 16 writes 16..23 — block 3 of its table is
    # unallocated (0): those columns route to the trash block
    window = np.zeros((3, 8), np.int32)
    window[:, 0] = toks
    window[:2, 1:] = np.random.RandomState(5).randint(1, 512, (2, 7))
    jp, jpool = JL.paged_slot_verify_step(
        jm, params, jpool, jnp.asarray(tables), jnp.asarray(window),
        jnp.asarray(cur), jnp.asarray(pads))
    tp = L.paged_slot_verify_step(tm, tpool, torch.from_numpy(tables),
                                  torch.from_numpy(window).long(),
                                  torch.from_numpy(cur),
                                  torch.from_numpy(pads))
    assert np.asarray(jp)[:2].tolist() == tp[:2].tolist()

    want = _jax_pool_leaves(jpool, kv_quant)
    if kv_quant is None:
        _close(tpool.k, want["k"], skip_trash=True)
        _close(tpool.v, want["v"], skip_trash=True)
        return
    for got, exp in zip(tpool.k + tpool.v, want["k"] + want["v"]):
        diff = np.abs(got[1:].numpy().astype(np.int32)
                      - exp[1:].astype(np.int32))
        assert diff.max() <= 1
    for got, exp in zip(tpool.kv_scale, want["kv_scale"]):
        np.testing.assert_allclose(got[1:].numpy(), exp[1:], rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_quant_insert_rows_and_copy_pool_block_match_jax(name):
    """The scale discipline step by step: a block's first row resets its
    scale, a larger row grows it and requantizes the residents, a
    multi-row write (duplicate blocks) takes the true absmax, and a
    copy-on-write copies codes and scales together."""
    rng = np.random.RandomState(11)
    qdt, _ = JL.kv_quant_spec(name)
    tdt, _ = L.kv_quant_spec(name)
    jcodes = jnp.zeros((6, 2, 8, 32), qdt)
    jplane = jnp.zeros((6, 2, 2), jnp.float32)
    tcodes = torch.zeros((6, 2, 8, 32), dtype=tdt)
    tplane = torch.zeros((6, 2, 2))
    writes = [([2], [0], 1.0), ([2], [1], 6.0), ([3, 3, 3, 4], [0, 1, 2, 0],
                                                 2.0),
              ([2], [0], 0.3), ([4, 4], [1, 2], 9.0)]
    for ch in (0, 1):
        for blk, off, mag in writes:
            rows = (rng.randn(len(blk), 2, 32) * mag).astype(np.float32)
            jcodes, jplane = JL._quant_insert_rows(
                jcodes, jplane, ch, jnp.asarray(blk, jnp.int32),
                jnp.asarray(off, jnp.int32), jnp.asarray(rows))
            L._quant_insert_rows(tcodes, tplane, ch, torch.tensor(blk),
                                 torch.tensor(off), torch.from_numpy(rows))
    np.testing.assert_allclose(tplane.numpy(), np.asarray(jplane), rtol=1e-6,
                               atol=0)
    got = tcodes.float().numpy()
    want = np.asarray(jcodes).astype(np.float32)
    if name == "int8":
        assert np.abs(got - want).max() <= 1
    else:  # one e4m3 step: 2**-3 of the value
        np.testing.assert_allclose(got, want, rtol=2.0 ** -3, atol=0)
    # copy-on-write: codes and scales move together, on both sides
    tm = L.LlamaModel(L.LlamaConfig.tiny(), device="cpu")
    pool = L.init_paged_pool(tm, 6, 8, kv_quant=name)
    pool.k[0].copy_(tcodes)
    pool.kv_scale[0].copy_(tplane)
    L.copy_pool_block(pool, 2, 5)
    src_scale = np.asarray(jplane)[2]
    jpool = {"layer_0": {"attn": {"k": jcodes, "v": jnp.array(jcodes),
                                  "kv_scale": jplane}}}
    jpool = JL.copy_pool_block(jpool, jnp.int32(2), jnp.int32(5))
    assert torch.equal(pool.k[0][5], pool.k[0][2])
    assert torch.equal(pool.kv_scale[0][5], pool.kv_scale[0][2])
    np.testing.assert_array_equal(
        np.asarray(jpool["layer_0"]["attn"]["kv_scale"])[5], src_scale)
    np.testing.assert_allclose(pool.kv_scale[0][5].numpy(), src_scale,
                               rtol=1e-6, atol=0)


def test_gather_view_matches_jax(models):
    """The dense reference view through the tables, float and dequantized,
    equals the JAX package's on the same pool contents."""
    jm, _, tm = models
    rng = np.random.RandomState(2)
    tables = _tables()
    for quant in (None, "int8"):
        jpool = JL.init_paged_pool(jm, POOL, BS, kv_quant=quant)
        tpool = L.init_paged_pool(tm, POOL, BS, kv_quant=quant)
        for i in range(len(tpool.k)):
            for name, leaf in (("k", tpool.k[i]), ("v", tpool.v[i])):
                vals = rng.randint(-127, 128, leaf.shape) if quant else \
                    rng.randn(*leaf.shape)
                leaf.copy_(torch.from_numpy(vals).to(leaf.dtype))
                jpool[f"layer_{i}"]["attn"][name] = jnp.asarray(
                    vals, jpool[f"layer_{i}"]["attn"][name].dtype)
            if quant:
                s = rng.uniform(1e-3, 1e-2, tpool.kv_scale[i].shape)
                tpool.kv_scale[i].copy_(torch.from_numpy(s))
                jpool[f"layer_{i}"]["attn"]["kv_scale"] = jnp.asarray(
                    s, jnp.float32)
        jview = JL._gather_view(jpool, jnp.asarray(tables))
        tview = L._gather_view(tpool, torch.from_numpy(tables))
        want = _layers(jview)
        _close(tview.k, want["k"])
        _close(tview.v, want["v"])
