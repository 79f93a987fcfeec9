"""The port's paged flash-decode (``sparkdl_tpu_torch.ops.paged_flash_decode``)
held against the JAX package's Pallas kernel, run in interpret mode on
the CPU as ``tests/test_paged_flash_decode.py`` runs it.

On the CPU the port's wrapper takes its plain version, so these tests pin
the plain version — the arithmetic the CUDA kernel is held to on the card
(``tests/test_torch_cuda.py``) — to the TPU kernel's semantics: the
block-table walk, ragged fills, non-contiguous pool ids, a slot parked on
the trash block, the S = k+1 verify window, and int8 / fp8 pools with
their per-(block, kv head) scales.

Tolerances (elementwise ``|port - jax| <= atol + rtol·|jax|``): f32 pools,
both sides do f32 arithmetic in different orders: atol = rtol = 1e-5.
bf16, each side rounds its f32 result to bf16 once, and the two can land
one bf16 step apart (2**-7 of the value): rtol 2**-7, atol 1e-5. Quantized
pools fold the scale in at another point (the kernel after each product,
the plain version before), which moves f32 rounding only: 1e-5.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.ops import paged_flash_decode as jpfd
from sparkdl_tpu_torch.ops import flash_attention as fa
from sparkdl_tpu_torch.ops import paged_flash_decode as pfd
from sparkdl_tpu_torch.ops.flash_decode import SPLIT_CHUNK

TOL = {"f32": (1e-5, 1e-5), "bf16": (1e-5, 2.0 ** -7),
       "int8": (1e-5, 1e-5), "fp8": (1e-5, 1e-5)}
H_KV, BS, MB, POOL, D = 2, 8, 4, 13, 16


def _layout(seed, kv):
    """The adversarial layout of tests/test_paged_flash_decode.py:26-39:
    non-contiguous live pool ids, one slot parked entirely on trash block
    0, mixed fill levels. Returns numpy pools (codes as f32 values for a
    quantized pool), scales or None, tables, cur, pads."""
    rng = np.random.RandomState(seed)
    shape = (POOL, H_KV, BS, D)
    if kv == "int8":
        pools = [np.round(rng.uniform(-127, 127, shape)).astype(np.float32)
                 for _ in range(2)]
    elif kv == "fp8":
        pools = [np.asarray(jnp.asarray(rng.uniform(-448, 448, shape),
                                        jnp.float8_e4m3fn), np.float32)
                 for _ in range(2)]
    else:
        pools = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    scales = (rng.uniform(1e-3, 2e-2, (POOL, H_KV, 2)).astype(np.float32)
              if kv in ("int8", "fp8") else None)
    tables = np.zeros((4, MB), np.int32)
    tables[0] = [7, 3, 11, 0]    # non-contiguous, trailing unallocated
    tables[1] = [2, 9, 0, 0]
    tables[2] = [5, 1, 10, 4]    # fully allocated
    tables[3] = 0                # parked on the trash block (idle slot)
    cur = np.asarray([17, 9, 31, 0], np.int32)
    pads = np.asarray([0, 3, 5, 0], np.int32)
    return pools, scales, tables, cur, pads


JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8,
       "fp8": jnp.float8_e4m3fn}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
       "fp8": torch.float8_e4m3fn}


def _both(kv, rep, s_q, seed=0):
    """The JAX kernel's output (interpret mode) and the port's, on the
    same numpy inputs."""
    pools, scales, tables, cur, pads = _layout(seed, kv)
    qdt = "bf16" if kv == "bf16" else "f32"
    q = np.random.RandomState(seed + 50).randn(
        4, H_KV * rep, s_q, D).astype(np.float32)
    jargs = [jnp.asarray(q, JDT[qdt])] + [jnp.asarray(p, JDT[kv])
                                          for p in pools]
    want = jpfd.paged_flash_decode(
        *jargs, jnp.asarray(tables), jnp.asarray(cur), jnp.asarray(pads),
        kv_scales=None if scales is None else jnp.asarray(scales),
        interpret=True)
    targs = [torch.from_numpy(q).to(TDT[qdt])] + [
        torch.from_numpy(p).to(TDT[kv]) for p in pools]
    got = pfd.paged_flash_decode(
        *targs, torch.from_numpy(tables), torch.from_numpy(cur),
        torch.from_numpy(pads),
        kv_scales=None if scales is None else torch.from_numpy(scales))
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("s_q", [1, 4])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_plain_matches_jax_kernel(kv, s_q, rep):
    want, got = _both(kv, rep, s_q, seed=rep + s_q)
    atol, rtol = TOL[kv]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    # the trash-parked slot (cur 0) attends position 0 of trash block 0:
    # V there, finite garbage, never NaN and not the zero output — the
    # same value on both sides
    np.testing.assert_array_equal(got[3, :, 0], want[3, :, 0])
    assert np.isfinite(got[3]).all() and np.any(got[3, :, 0] != 0)


def test_verify_window_queries_see_their_own_prefix():
    """Query i of a slot attends [pad, cur + i]: reversing the window's
    queries changes the answer, as in the JAX test."""
    pools, _, tables, cur, pads = _layout(9, "f32")
    q = torch.from_numpy(np.random.RandomState(77).randn(
        4, H_KV * 2, 4, D).astype(np.float32))
    args = [torch.from_numpy(p) for p in pools] + [
        torch.from_numpy(tables), torch.from_numpy(cur),
        torch.from_numpy(pads)]
    got = pfd.paged_flash_decode(q, *args)
    flipped = pfd.paged_flash_decode(q.flip(2).contiguous(), *args)
    assert not torch.allclose(flipped[2, :, -1], got[2, :, -1], atol=1e-3)


def test_never_read_positions_cannot_reach_the_output():
    """NaN in every block no live range reads and past each slot's fill
    leaves the plain version's output unchanged — what the kernel's loop
    bounds give on the card."""
    pools, _, tables, cur, pads = _layout(4, "f32")
    q = torch.from_numpy(np.random.RandomState(3).randn(
        4, H_KV * 2, 1, D).astype(np.float32))
    kp, vp = (torch.from_numpy(p) for p in pools)
    t, c, p = (torch.from_numpy(x) for x in (tables, cur, pads))
    clean = pfd.paged_flash_decode(q, kp, vp, t, c, p)
    live = {0}
    for r in range(4):
        live.update(int(b) for b in tables[r, :-(-(int(cur[r]) + 1) // BS)])
    dead = [b for b in range(POOL) if b not in live]
    kp[dead] = float("nan")
    vp[dead] = float("nan")
    kp[2, :, :3] = float("nan")  # slot 1's left pad (pad 3)
    vp[2, :, :3] = float("nan")
    got = pfd.paged_flash_decode(q, kp, vp, t, c, p)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, clean, rtol=0, atol=0)


def test_validation_errors():
    pools, scales, tables, cur, pads = _layout(0, "int8")
    codes = [torch.from_numpy(x).to(torch.int8) for x in pools]
    rest = [torch.from_numpy(x) for x in (tables, cur, pads)]
    q = torch.zeros(4, H_KV * 2, 1, D)
    with pytest.raises(ValueError, match="kv_scales"):
        pfd.paged_flash_decode(q, *codes, *rest)
    with pytest.raises(ValueError, match="multiple"):
        pfd.paged_flash_decode(torch.zeros(4, 3, 1, D), *codes, *rest,
                               kv_scales=torch.from_numpy(scales))
    with pytest.raises(ValueError, match="kv_scales must be"):
        pfd.paged_flash_decode(q, *codes, *rest,
                               kv_scales=torch.zeros(POOL, H_KV))
    with pytest.raises(ValueError, match="tables"):
        pfd.paged_flash_decode(q, *codes, rest[0][:2], *rest[1:],
                               kv_scales=torch.from_numpy(scales))


def test_cpu_calls_take_the_plain_version_and_count_nothing():
    pools, _, tables, cur, pads = _layout(1, "f32")
    before = pfd.paged_flash_decode.launches
    args = [torch.zeros(4, H_KV, 1, D)] + [
        torch.from_numpy(x) for x in (*pools, tables, cur, pads)]
    torch.testing.assert_close(pfd.paged_flash_decode(*args),
                               pfd.paged_flash_decode_plain(*args))
    assert pfd.paged_flash_decode.launches == before
    assert pfd.support_reason(args[0], args[1]) is None


def test_support_reason_states_the_position_limit():
    """A table wider than the plan can split (``MB * bs`` above
    ``MAX_POSITIONS``) is refused by name; one at the limit is taken, and
    without tables only the other limits are checked."""
    from sparkdl_tpu_torch.ops.flash_decode import MAX_POSITIONS

    q = torch.empty(2, 8, 1, 128, device="meta")
    pool = torch.empty(4, 4, 16, 128, device="meta")
    at = torch.empty(2, MAX_POSITIONS // 16, dtype=torch.int32, device="meta")
    over = torch.empty(2, MAX_POSITIONS // 16 + 1, dtype=torch.int32,
                       device="meta")
    assert pfd.support_reason(q, pool, None, at) is None
    assert pfd.support_reason(q, pool) is None
    assert "exceed the kernel's" in pfd.support_reason(q, pool, None, over)


def test_block_counter_is_checked():
    """The optional block counter is two int32 elements on q's device."""
    pools, _, tables, cur, pads = _layout(1, "f32")
    args = [torch.zeros(4, H_KV, 1, D)] + [
        torch.from_numpy(x) for x in (*pools, tables, cur, pads)]
    with pytest.raises(ValueError, match="block_counter"):
        pfd.paged_flash_decode(*args, block_counter=torch.zeros(2))
    ok = torch.zeros(2, dtype=torch.int32)
    torch.testing.assert_close(pfd.paged_flash_decode(*args,
                                                      block_counter=ok),
                               pfd.paged_flash_decode_plain(*args))
    assert ok.tolist() == [0, 0]


def test_resolver_pairs_with_flash_and_obeys_the_knob(monkeypatch):
    monkeypatch.delenv(pfd.PAGED_KERNEL_ENV, raising=False)
    monkeypatch.delenv("SPARKDL_FLASH_DECODE", raising=False)
    assert pfd.paged_decode_fn_for(fa.flash_attention) is \
        pfd.paged_flash_decode
    assert pfd.paged_decode_fn_for(fa.adaptive_attention) is \
        pfd.paged_flash_decode
    assert pfd.paged_decode_fn_for(None) is None
    monkeypatch.setenv(pfd.PAGED_KERNEL_ENV, "0")
    assert pfd.paged_decode_fn_for(fa.flash_attention) is None
    monkeypatch.setenv(pfd.PAGED_KERNEL_ENV, "1")
    assert pfd.paged_decode_fn_for(None) is pfd.paged_flash_decode
    monkeypatch.setenv(pfd.PAGED_KERNEL_ENV, "auto")
    monkeypatch.setenv("SPARKDL_FLASH_DECODE", "0")
    assert pfd.paged_decode_fn_for(fa.flash_attention) is None


# --- the split-KV kernel's arithmetic, emulated on the CPU ----------------
#
# ``pfd.paged_flash_decode_emulation`` repeats what
# ``csrc/paged_flash_decode.cu`` does: chunks of ``SPLIT_CHUNK`` positions
# read through the table, per-key-slot online softmax in log2 units over
# zero-filled never-read positions, page scales folded in after each
# product, empty chunks as (NEG_INF, 0) partials, the merge in split
# order. It is held to the JAX kernel (interpret mode) and to the plain
# version with the tolerances of ``TOL`` above, and bitwise to itself
# where only never-read positions change.

SC = SPLIT_CHUNK
SPLIT_BS, SPLIT_MB, SPLIT_D = 16, 3 * SC // 16, 64
# cur and pad on each side of chunk edges; slot 3 parked on trash block 0;
# slots 1 and 4 have chunks that hold only pad
SPLIT_CUR = [SC - 1, SC, SC + 1, 0, 2 * SC + 3, SC + 10]
SPLIT_PADS = [0, SC, SC - 1, 0, 2 * SC, SC + 1]


def _split_layout(seed, kv, s_q):
    """Pools of 16-row blocks, each slot's live blocks scattered over
    non-contiguous ids, its table padded past the fill with the ids of
    blocks no slot reads; returns numpy pools (codes as f32 values),
    scales or None, tables, cur, pads and the never-read block ids."""
    rng = np.random.RandomState(seed)
    need = [0 if c == 0 else -(-(c + s_q) // SPLIT_BS) for c in SPLIT_CUR]
    pool = 1 + sum(need) + 6
    ids = rng.permutation(np.arange(1, pool))
    dead = ids[sum(need):]
    tables = np.zeros((len(SPLIT_CUR), SPLIT_MB), np.int32)
    used = 0
    for r, n in enumerate(need):
        if n:
            tables[r, :n] = ids[used:used + n]
            tables[r, n:] = dead[r % len(dead)]
            used += n
    shape = (pool, H_KV, SPLIT_BS, SPLIT_D)
    if kv == "int8":
        pools = [np.round(rng.uniform(-127, 127, shape)).astype(np.float32)
                 for _ in range(2)]
    elif kv == "fp8":
        pools = [np.asarray(jnp.asarray(rng.uniform(-448, 448, shape),
                                        jnp.float8_e4m3fn), np.float32)
                 for _ in range(2)]
    else:
        pools = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    scales = (rng.uniform(1e-3, 2e-2, (pool, H_KV, 2)).astype(np.float32)
              if kv in ("int8", "fp8") else None)
    return (pools, scales, tables, np.asarray(SPLIT_CUR, np.int32),
            np.asarray(SPLIT_PADS, np.int32), dead)


def _split_args(kv, rep, s_q, seed):
    pools, scales, tables, cur, pads, dead = _split_layout(seed, kv, s_q)
    qdt = "bf16" if kv == "bf16" else "f32"
    q = np.random.RandomState(seed + 7).randn(
        len(SPLIT_CUR), H_KV * rep, s_q, SPLIT_D).astype(np.float32)
    return pools, scales, tables, cur, pads, dead, qdt, q


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("s_q", [1, 5])
@pytest.mark.parametrize("rep", [1, 2])
def test_split_emulation_matches_jax_kernel_and_plain(kv, s_q, rep):
    pools, scales, tables, cur, pads, _, qdt, q = _split_args(
        kv, rep, s_q, seed=rep * 10 + s_q)
    want = np.asarray(jpfd.paged_flash_decode(
        jnp.asarray(q, JDT[qdt]), *(jnp.asarray(p, JDT[kv]) for p in pools),
        jnp.asarray(tables), jnp.asarray(cur), jnp.asarray(pads),
        kv_scales=None if scales is None else jnp.asarray(scales),
        interpret=True).astype(jnp.float32))
    args = ([torch.from_numpy(q).to(TDT[qdt])]
            + [torch.from_numpy(p).to(TDT[kv]) for p in pools]
            + [torch.from_numpy(x) for x in (tables, cur, pads)])
    sc = None if scales is None else torch.from_numpy(scales)
    emu = pfd.paged_flash_decode_emulation(*args, kv_scales=sc)
    plain = pfd.paged_flash_decode_plain(*args, kv_scales=sc)
    atol, rtol = TOL[kv]
    np.testing.assert_allclose(emu.float().numpy(), want, atol=atol,
                               rtol=rtol)
    np.testing.assert_allclose(emu.float().numpy(), plain.float().numpy(),
                               atol=atol, rtol=rtol)
    # the parked slot attends position 0 of trash block 0: V there
    assert np.isfinite(emu[3].float().numpy()).all()
    assert torch.any(emu[3, :, 0] != 0)


@pytest.mark.parametrize("kv", ["f32", "int8", "fp8"])
@pytest.mark.parametrize("s_q", [1, 5])
def test_split_emulation_never_reads_dead_pages(kv, s_q):
    """NaN in every block no live range reads, in each live slot's left
    pad and past its window: the emulation's output is bitwise the same
    as with finite values there (the kernel zero-fills those positions
    instead of reading them)."""
    pools, scales, tables, cur, pads, dead, qdt, q = _split_args(
        kv, 2, s_q, seed=31 + s_q)
    tq = torch.from_numpy(q)
    kp, vp = (torch.from_numpy(p).to(TDT[kv]) for p in pools)
    rest = [torch.from_numpy(x) for x in (tables, cur, pads)]
    sc = None if scales is None else torch.from_numpy(scales)
    clean = pfd.paged_flash_decode_emulation(tq, kp, vp, *rest, kv_scales=sc)
    # int8 has no NaN: its never-read codes become -128, and the scales of
    # never-read blocks NaN, which a read would carry to the output
    junk = -128 if kv == "int8" else float("nan")
    kp, vp = kp.clone(), vp.clone()
    for x in (kp, vp):
        x[torch.from_numpy(dead).long()] = junk
        for r in range(len(SPLIT_CUR)):
            if cur[r] == 0:
                continue
            for p in list(range(pads[r])) + list(range(
                    cur[r] + s_q, -(-(cur[r] + s_q) // SPLIT_BS) * SPLIT_BS)):
                x[tables[r, p // SPLIT_BS], :, p % SPLIT_BS] = junk
    if sc is not None:
        sc = sc.clone()
        sc[torch.from_numpy(dead).long()] = float("nan")
    got = pfd.paged_flash_decode_emulation(tq, kp, vp, *rest, kv_scales=sc)
    assert torch.isfinite(got).all()
    assert torch.equal(got, clean)


def test_split_emulation_verify_window_rows_see_their_own_prefix():
    """S = 5: row i of a slot attends [pad, cur + i], across a chunk
    edge (slot 0: cur = SC - 1, so rows 1..4 reach into chunk 1); the
    emulation agrees with the plain version row by row, and each row
    differs from the one before it."""
    pools, _, tables, cur, pads, _, _, q = _split_args("f32", 2, 5, seed=3)
    args = ([torch.from_numpy(q)] + [torch.from_numpy(p) for p in pools]
            + [torch.from_numpy(x) for x in (tables, cur, pads)])
    emu = pfd.paged_flash_decode_emulation(*args)
    np.testing.assert_allclose(emu.numpy(),
                               pfd.paged_flash_decode_plain(*args).numpy(),
                               atol=1e-5, rtol=1e-5)
    one = [torch.from_numpy(q[:, :, :1].copy())] + args[1:]
    for i in range(1, 5):
        args_i = list(one)
        args_i[0] = torch.from_numpy(q[:, :, i:i + 1].copy())
        args_i[4] = args[4] + i  # query i alone is a window of 1 at cur + i
        np.testing.assert_allclose(
            emu[:, :, i:i + 1].numpy(),
            pfd.paged_flash_decode_emulation(*args_i).numpy(),
            atol=1e-5, rtol=1e-5)
    assert not torch.allclose(emu[0, :, 1], emu[0, :, 0], atol=1e-3)
