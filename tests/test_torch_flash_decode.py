"""The port's flash decode (``sparkdl_tpu_torch.ops.flash_decode``)
against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX Pallas kernel in
interpret mode and through the port's wrapper, which takes its plain
PyTorch version for CPU tensors (the CUDA kernel is held to that plain
version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``). Tolerances as in ``test_torch_flash_attention.py``:
f32 1e-5, bf16 2e-2.
"""

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
