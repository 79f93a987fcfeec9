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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.ops import paged_flash_decode as jpfd
from sparkdl_tpu_torch.ops import flash_attention as fa
from sparkdl_tpu_torch.ops import paged_flash_decode as pfd

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
