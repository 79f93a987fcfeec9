"""The port's flash attention (``sparkdl_tpu_torch.ops.flash_attention``)
against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX Pallas kernel, run in
interpret mode as the JAX package's own CPU tests run it, and through the
port's wrapper, which takes its plain PyTorch version for CPU tensors (the
CUDA kernel is held to that plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances: f32 — both sides compute in f32 in different orders,
atol/rtol 1e-5; bf16 inputs and output — one rounding of the f32 result to
bf16 can land a step apart, atol/rtol 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.ops.flash_attention import _fwd as jax_fwd
from sparkdl_tpu.parallel.ring_attention import \
    dense_attention as jax_dense_attention
from sparkdl_tpu_torch.ops import flash_attention as fa
from sparkdl_tpu_torch.parallel.ring_attention import dense_attention

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(b, h, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(3)]


def _pad_mask(s, pads):
    return np.stack([(np.arange(s) >= p).astype(np.float32) for p in pads])


def _jax(arrs, dtype):
    return [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [37, 128, 200])
def test_o_and_lse_match_jax_kernel(s, d, causal, dtype):
    """Left-padded kv_mask with one all-masked row (row 2): O there is
    exactly 0 and lse exactly NEG_INF, as in the JAX kernel."""
    q, k, v = _inputs(3, 1, s, d, seed=s * 10 + d)
    mask = _pad_mask(s, [0, s // 3, s])
    o_j, lse_j = jax_fwd(*_jax([q, k, v], dtype), jnp.asarray(mask), causal,
                         128, 128, True)
    o_t, lse_t = fa.flash_attention_fwd(*_torch([q, k, v], dtype), causal,
                                        kv_mask=torch.from_numpy(mask))
    assert o_t.dtype == getattr(torch, dtype) and lse_t.dtype == torch.float32
    o_j = np.asarray(o_j, np.float32)
    o_t = o_t.float().numpy()
    np.testing.assert_allclose(o_t, o_j, atol=TOL[dtype], rtol=TOL[dtype])
    lse_j, lse_t = np.asarray(lse_j), lse_t.numpy()
    live = lse_j > -1e29
    np.testing.assert_allclose(lse_t[live], lse_j[live], atol=TOL[dtype],
                               rtol=TOL[dtype])
    np.testing.assert_array_equal(lse_t[~live], lse_j[~live])
    assert np.all(o_t[2] == 0) and np.all(o_j[2] == 0)
    assert np.all(lse_t[2] == -1e30)


@pytest.mark.parametrize("causal", [False, True])
def test_no_mask_matches_jax_kernel(causal):
    q, k, v = _inputs(2, 3, 77, 64, seed=5)
    o_j, lse_j = jax_fwd(*_jax([q, k, v], "float32"),
                         jnp.ones((2, 77), jnp.float32), causal, 128, 128,
                         True)
    o_t, lse_t = fa.flash_attention_fwd(*_torch([q, k, v], "float32"),
                                        causal)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(fa.flash_attention(*_torch([q, k, v], "float32"),
                                          causal), o_t)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_attention_matches_jax(causal):
    """``parallel.ring_attention.dense_attention``, the masking source of
    truth: a row whose kv_mask is all zero outputs zeros."""
    q, k, v = _inputs(3, 2, 40, 32, seed=9)
    mask = _pad_mask(40, [0, 11, 40])
    want = np.asarray(jax_dense_attention(*_jax([q, k, v], "float32"),
                                          causal, jnp.asarray(mask)))
    got = dense_attention(*_torch([q, k, v], "float32"), causal,
                          torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.all(got[2] == 0)
    # where every query row has a live key, dense equals flash
    flash = fa.flash_attention(*_torch([q, k, v], "float32"), causal,
                               kv_mask=torch.from_numpy(mask)).numpy()
    rows = slice(11, None) if causal else slice(None)
    np.testing.assert_allclose(flash[:2, :, rows], got[:2, :, rows],
                               atol=1e-5, rtol=1e-5)


def test_wrapper_checks_shapes_and_devices():
    q, k, v = _torch(_inputs(1, 2, 8, 64, seed=0), "float32")
    with pytest.raises(ValueError, match="one \\[B, H, S, D\\]"):
        fa.flash_attention(q, k[:, :1], v)
    with pytest.raises(ValueError, match="kv_mask"):
        fa.flash_attention(q, k, v, kv_mask=torch.ones(1, 7))
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(*meta)


def test_support_reason_states_kernel_limits():
    """CPU tensors take the plain version (always supported); elsewhere
    the kernel's limits apply: head_dim 64/128, f32/bf16, one dtype."""
    cpu = torch.zeros(1, 1, 4, 32)
    assert fa.support_reason(cpu, cpu, cpu) is None

    def meta(d, dtype=torch.float32):
        return torch.empty(1, 1, 4, d, dtype=dtype, device="meta")

    assert fa.support_reason(meta(128), meta(128), meta(128)) is None
    assert fa.support_reason(meta(64, torch.bfloat16),
                             meta(64, torch.bfloat16),
                             meta(64, torch.bfloat16)) is None
    assert "head_dim 32" in fa.support_reason(meta(32), meta(32), meta(32))
    assert "float16" in fa.support_reason(meta(64, torch.float16),
                                          meta(64, torch.float16),
                                          meta(64, torch.float16))
    assert "differ" in fa.support_reason(meta(64), meta(64, torch.bfloat16),
                                         meta(64))


def test_attn_fn_policy_on_cpu(monkeypatch):
    """``"auto"`` is dense in-model (None) without a CUDA device and the
    adaptive kernel policy with one; explicit values pass through."""
    monkeypatch.setattr(fa, "is_cuda_backend", lambda: False)
    assert fa.resolve_attn_fn("auto") is None
    assert fa.auto_attn_fn() is None
    monkeypatch.setattr(fa, "is_cuda_backend", lambda: True)
    assert fa.resolve_attn_fn("auto") is fa.adaptive_attention
    assert fa.resolve_attn_fn(None) is None
    assert fa.resolve_attn_fn(fa.flash_attention) is fa.flash_attention


def test_adaptive_attention_min_seq(monkeypatch):
    """SPARKDL_FLASH_MIN_SEQ defaults to 0 (the kernel at every length);
    below a set threshold the dense arm runs."""
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = _torch(_inputs(1, 2, 16, 32, seed=1), "float32")
    monkeypatch.delenv("SPARKDL_FLASH_MIN_SEQ", raising=False)
    o1 = fa.adaptive_attention(q, k, v, True)
    assert calls == [1]
    monkeypatch.setenv("SPARKDL_FLASH_MIN_SEQ", "17")
    o2 = fa.adaptive_attention(q, k, v, True)
    assert calls == [1]
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-5, rtol=1e-5)


def test_cpu_tensors_never_count_a_launch():
    before = fa.flash_attention_fwd.launches
    fa.flash_attention(*_torch(_inputs(1, 1, 8, 64, seed=2), "float32"))
    assert fa.flash_attention_fwd.launches == before
