"""The port's flash decode (``sparkdl_tpu_torch.ops.flash_decode``)
against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX Pallas kernel in
interpret mode and through the port's wrapper, which takes its plain
PyTorch version for CPU tensors (the CUDA kernel is held to that plain
version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``). Tolerances as in ``test_torch_flash_attention.py``:
f32 1e-5, bf16 2e-2.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from sparkdl_tpu_torch.ops import flash_attention as fa
from sparkdl_tpu_torch.ops import flash_decode as fd

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(b, hq, h_kv, length, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, 1, d)).astype(np.float32),
            rng.standard_normal((b, h_kv, length, d)).astype(np.float32),
            rng.standard_normal((b, h_kv, length, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vector_cur", [False, True])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_matches_jax_kernel(rep, vector_cur, dtype):
    b, h_kv, length, d = 4, 2, 256, 32
    q, k, v = _inputs(b, h_kv * rep, h_kv, length, d, seed=rep * 3 + 1)
    pads = np.array([0, 3, 130, 200], np.int32)
    # vector: row 3 has nothing live (cur <= pad) and outputs 0
    cur = (np.array([256, 77, 131, 150], np.int32) if vector_cur
           else np.int32(201))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_flash_decode(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(cur),
        jnp.asarray(pads), interpret=True)
    got = fd.flash_decode(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(cur) if vector_cur else int(cur),
        torch.from_numpy(pads))
    assert got.dtype == tdt and got.shape == (b, h_kv * rep, 1, d)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])
    if vector_cur:
        assert torch.all(got[3] == 0)


def test_no_pads_and_scalar_tensor_cur():
    q, k, v = _inputs(2, 4, 2, 256, 32, seed=7)
    want = np.asarray(jax_flash_decode(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.int32(100),
        interpret=True))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    for cur in (100, torch.tensor(100), torch.tensor([100, 100])):
        np.testing.assert_allclose(fd.flash_decode(*t, cur).numpy(), want,
                                   atol=1e-5, rtol=1e-5)


def test_wrapper_checks():
    t = [torch.from_numpy(a) for a in _inputs(2, 4, 2, 16, 32, seed=0)]
    with pytest.raises(ValueError, match="scalar or"):
        fd.flash_decode(*t, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="single-token"):
        fd.flash_decode(t[0].expand(2, 4, 2, 32), t[1], t[2], 4)
    with pytest.raises(ValueError, match="multiple"):
        fd.flash_decode(t[0][:, :3], t[1], t[2], 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fd.flash_decode(*(x.to("meta") for x in t), 4)


def test_support_reason_states_kernel_limits():
    """The TPU kernel's L % 128 rule is gone: any cache length works.
    What the CUDA kernel needs is head_dim 64/128, f32/bf16 and a GQA
    ratio of 1, 2, 4 or 8; CPU tensors take the plain version."""
    def meta(hq, d, length=100, dtype=torch.float32, cache_dtype=None):
        q = torch.empty(2, hq, 1, d, dtype=dtype, device="meta")
        kc = torch.empty(2, 4, length, d, dtype=cache_dtype or dtype,
                         device="meta")
        return q, kc

    assert fd.supports(torch.zeros(1, 3, 1, 16), torch.zeros(1, 1, 5, 16))
    for length in (1, 100, 2112):
        assert fd.supports(*meta(8, 128, length))
    assert fd.supports(*meta(32, 64, dtype=torch.bfloat16))
    assert "head_dim 32" in fd.support_reason(*meta(8, 32))
    assert "GQA ratio 3" in fd.support_reason(*meta(12, 128))
    assert "float16" in fd.support_reason(*meta(8, 128, dtype=torch.float16))
    assert "cache dtype" in fd.support_reason(
        *meta(8, 128, cache_dtype=torch.bfloat16))
    assert fd.KV_BLOCK == 1


def test_decode_fn_resolver(monkeypatch):
    monkeypatch.delenv("SPARKDL_FLASH_DECODE", raising=False)
    assert fd.decode_fn_for(fa.flash_attention) is fd.flash_decode
    assert fd.decode_fn_for(fa.adaptive_attention) is fd.flash_decode
    assert fd.decode_fn_for(None) is None
    assert fd.decode_fn_for(lambda q, k, v, causal: q) is None
    for off in ("0", "off", "false"):
        monkeypatch.setenv("SPARKDL_FLASH_DECODE", off)
        assert fd.decode_fn_for(fa.flash_attention) is None
    monkeypatch.setenv("SPARKDL_FLASH_DECODE", "1")
    assert fd.decode_fn_for(fa.flash_attention) is fd.flash_decode


@pytest.mark.parametrize("raw,mode", [("0", "off"), ("off", "off"),
                                      ("False", "off"), ("1", "force"),
                                      ("on", "force"), (" force ", "force"),
                                      ("true", "force"), ("auto", "auto"),
                                      ("", "auto"), ("maybe", "auto")])
def test_tri_state_env(monkeypatch, raw, mode):
    monkeypatch.setenv("SPARKDL_TEST_KNOB", raw)
    assert fd.tri_state_env("SPARKDL_TEST_KNOB") == mode


def test_tri_state_env_unset_is_auto(monkeypatch):
    monkeypatch.delenv("SPARKDL_TEST_KNOB", raising=False)
    assert fd.tri_state_env("SPARKDL_TEST_KNOB") == "auto"


def test_cpu_tensors_never_count_a_launch():
    before = fd.flash_decode.launches
    fd.flash_decode(*(torch.from_numpy(a)
                      for a in _inputs(1, 2, 1, 8, 64, seed=3)), 5)
    assert fd.flash_decode.launches == before


# --- the split-KV kernel's arithmetic, emulated on the CPU ----------------
#
# ``fd.flash_decode_emulation`` repeats what ``csrc/flash_decode.cu`` does:
# chunks of ``fd.SPLIT_CHUNK`` positions, per-key-slot online softmax in
# log2 units over zero-filled never-read slots, empty chunks as (NEG_INF,
# 0) partials, and the merge in split order. It is held to the JAX kernel
# (interpret mode) and to the plain version. Tolerances, elementwise
# |a - b| <= atol + rtol·|b|: f32, all sides do f32 arithmetic in other
# orders: atol = rtol = 1e-5; bf16, each side rounds its f32 result once
# and the two may land one bf16 step (2**-7 of the value) apart: atol
# 1e-5, rtol 2**-7.

EMU_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2.0 ** -7)}
C = fd.SPLIT_CHUNK


def _close(got, want, dtype):
    atol, rtol = EMU_TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("edges", [
    # cur and pad on each side of a chunk edge, a chunk of pad only,
    # a row with nothing live
    ([C - 1, C, C + 1, 4 * C], [0, 0, 0, C]),
    ([3 * C, 2 * C + 1, C + 1, 2 * C - 1], [C - 1, C, C + 1, 2 * C - 1]),
    ([1, 2 * C, 4 * C, 5], [0, 2 * C - 1, 3 * C, 5]),
], ids=["cur_edges", "pad_edges", "pad_only_chunks"])
def test_split_emulation_matches_jax_kernel_and_plain(dtype, d, edges):
    cur, pads = (np.asarray(x, np.int32) for x in edges)
    b, h_kv, rep, length = 4, 2, 2, 4 * C
    q, k, v = _inputs(b, h_kv * rep, h_kv, length, d, seed=d + len(dtype))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_flash_decode(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(cur),
        jnp.asarray(pads), interpret=True), np.float32)
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    c, p = torch.from_numpy(cur), torch.from_numpy(pads)
    emu = fd.flash_decode_emulation(*t, c, p)
    assert emu.dtype == tdt
    _close(emu.float(), want, dtype)
    _close(emu.float(), fd.flash_decode_plain(*t, c, p).float(), dtype)
    for r in range(b):
        if cur[r] <= pads[r]:
            assert torch.all(emu[r] == 0)


def test_split_emulation_exclusive_cur_edge():
    """flash_decode's cur is exclusive: the template's last position is
    cur - 1. Position cur (NaN here) is never read, and cur + 1 brings
    exactly that position in, for cur on each side of a chunk edge."""
    q, k, v = _inputs(3, 4, 2, 4 * C, 64, seed=5)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    cur = torch.tensor([C - 1, C, C + 1])
    pads = torch.tensor([0, 1, C])
    clean = fd.flash_decode_emulation(*t, cur, pads)
    for r, c in enumerate(cur.tolist()):
        t[1][r, :, c] = float("nan")
        t[2][r, :, c] = float("nan")
    got = fd.flash_decode_emulation(*t, cur, pads)
    assert torch.isfinite(got).all() and torch.equal(got, clean)
    q2, k2, v2 = (torch.from_numpy(a) for a in (q, k, v))
    longer = fd.flash_decode_emulation(q2, k2, v2, cur + 1, pads)
    np.testing.assert_allclose(
        longer.numpy(), fd.flash_decode_plain(q2, k2, v2, cur + 1,
                                              pads).numpy(),
        atol=1e-5, rtol=1e-5)
    assert not torch.allclose(longer, clean, atol=1e-4)


def test_split_emulation_never_reads_dead_slots():
    """NaN in the left pad and past cur, in chunks that hold nothing live
    and in the live chunks' dead rows, never reaches the output."""
    q, k, v = _inputs(2, 8, 2, 3 * C, 128, seed=9)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    cur, pads = torch.tensor([C + 3, 3 * C]), torch.tensor([5, 2 * C + 1])
    clean = fd.flash_decode_emulation(*t, cur, pads)
    for r in range(2):
        for x in (t[1], t[2]):
            x[r, :, :pads[r]] = float("nan")
            x[r, :, cur[r]:] = float("nan")
    got = fd.flash_decode_emulation(*t, cur, pads)
    assert torch.isfinite(got).all() and torch.equal(got, clean)


@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_split_emulation_any_chunk_matches_plain(chunk):
    """The chunk a split (the alternatives measured on the card) changes
    rounding only: every chunk agrees with the plain version at GQA 4."""
    q, k, v = _inputs(4, 8, 2, 600, 128, seed=chunk)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    cur, pads = torch.tensor([600, 300, 129, 7]), torch.tensor([0, 64, 128,
                                                                 0])
    np.testing.assert_allclose(
        fd.flash_decode_emulation(*t, cur, pads, chunk=chunk).numpy(),
        fd.flash_decode_plain(*t, cur, pads).numpy(), atol=1e-5, rtol=1e-5)


def test_split_plan_comes_from_static_shapes():
    """n_splits = ceil(positions / chunk), the chunk doubling until at
    most MAX_SPLITS; rows a block up to MAX_ROWS."""
    cap = fd.MAX_ROWS
    assert fd.split_plan(2112, 2) == (min(2, cap), C, -(-2112 // C))
    assert fd.split_plan(2112, 16) == (cap, C, -(-2112 // C))
    assert fd.split_plan(1, 1) == (1, C, 1)
    rt, chunk, n = fd.split_plan(fd.MAX_SPLITS * C + 1, 4)
    assert (rt, chunk, n) == (cap, 2 * C,
                              -(-(fd.MAX_SPLITS * C + 1) // (2 * C)))
    assert n <= fd.MAX_SPLITS
    assert fd.split_plan(fd.MAX_POSITIONS, 1)[1] == fd.MAX_CHUNK
    with pytest.raises(ValueError, match="chunks above"):
        fd.split_plan(fd.MAX_POSITIONS + 1, 1)


def test_support_reason_states_the_position_limit():
    """A cache longer than the plan can split is refused by name, before
    any launch; one at the limit is taken."""
    def meta(length):
        return (torch.empty(1, 8, 1, 128, device="meta"),
                torch.empty(1, 4, length, 128, device="meta"))

    assert fd.support_reason(*meta(fd.MAX_POSITIONS)) is None
    assert "exceeds the kernel's" in fd.support_reason(
        *meta(fd.MAX_POSITIONS + 1))


@pytest.mark.parametrize("bad", [
    torch.zeros(2, dtype=torch.int64), torch.zeros(3, dtype=torch.int32),
    torch.zeros(2, dtype=torch.int32, device="meta")],
    ids=["dtype", "size", "device"])
def test_block_counter_is_checked(bad):
    """The optional block counter is two int32 elements on q's device;
    anything else raises before any work."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 8, 64, seed=1))
    with pytest.raises(ValueError, match="block_counter"):
        fd.flash_decode(q, k, v, 4, block_counter=bad)
    ok = torch.zeros(2, dtype=torch.int32)
    torch.testing.assert_close(fd.flash_decode(q, k, v, 4, block_counter=ok),
                               fd.flash_decode_plain(q, k, v, 4))
    assert ok.tolist() == [0, 0]  # the plain version launches nothing