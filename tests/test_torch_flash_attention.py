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

The bf16 CUDA kernel runs on the tensor cores, which cannot run on the
CPU; ``_tc_emulation`` repeats its arithmetic in PyTorch (64-column
tiles, online softmax in log2 units, P rounded to bf16 before P·V, l
summed from the f32 p, the dead-tile skip) and is held to the JAX kernel
and to ``attention_plain`` by the tensor-core rule:
|O - O_ref| <= 1e-5 + 2**-7·|O_ref| + 2**-8·(P|V|)_ref, where
(P|V|) = sum_j p_j·|v_j| / l. 2**-7·|O| is one bf16 output step;
rounding each p_j to bf16 moves O by at most 2**-9·(P|V|), and l, summed
from the unrounded p, disagrees with the rounded P by about as much again.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import math

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


# --- the tensor-core (bf16) kernel's arithmetic, emulated on the CPU -----

TC_TILE = 64


def _tc_emulation(q, k, v, causal, kv_mask, skip=True):
    """``(O, lse)`` as ``csrc/flash_attention_tc.cu`` computes them: per
    64-row Q tile, a loop over 64-column K tiles (with ``skip``, only the
    tiles with a live column, up to the causal stop), scores in f32 scaled
    by log2(e)/sqrt(D), exp2, p rounded to bf16 for P·V while l sums the
    f32 p, O / l rounded once, lse = (m + log2 l)·ln 2."""
    b, h, s, d = q.shape
    qf, kf, vf = (t.float() for t in (q, k, v))
    scale = math.log2(math.e) / math.sqrt(d)
    live_col = (torch.ones((b, s), dtype=torch.bool) if kv_mask is None
                else kv_mask.float() > 0)
    o = torch.zeros((b, h, s, d))
    lse = torch.full((b, h, s), fa.NEG_INF)
    n_t = -(-s // TC_TILE)
    for bi in range(b):
        for qt in range(n_t):
            rows = torch.arange(qt * TC_TILE, min(s, (qt + 1) * TC_TILE))
            n_k = min(n_t, qt + 1) if causal else n_t
            tiles = [kt for kt in range(n_k)
                     if not skip or live_col[bi, kt * TC_TILE:
                                             (kt + 1) * TC_TILE].any()]
            m = torch.full((h, len(rows)), fa.NEG_INF)
            l = torch.zeros((h, len(rows)))
            acc = torch.zeros((h, len(rows), d))
            for kt in tiles:
                cols = torch.arange(kt * TC_TILE, min(s, (kt + 1) * TC_TILE))
                x = (qf[bi][:, rows] @ kf[bi][:, cols].transpose(-1, -2)
                     ) * scale
                live = live_col[bi, cols][None, :].expand(len(rows), -1)
                if causal:
                    live = live & (cols[None, :] <= rows[:, None])
                x = torch.where(live, x, fa.NEG_INF)
                m_new = torch.maximum(m, x.amax(-1))
                p = torch.exp2(x - m_new[..., None])
                p = torch.where(m_new[..., None] <= fa.NEG_INF, 0.0, p)
                alpha = torch.exp2(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + (
                    p.bfloat16().float() @ vf[bi][:, cols])
                m = m_new
            safe_l = torch.where(l > 0, l, 1.0)
            o[bi][:, rows] = acc / safe_l[..., None]
            lse[bi][:, rows] = torch.where(
                m <= fa.NEG_INF, fa.NEG_INF,
                (m + torch.log2(safe_l)) * math.log(2.0))
    return o.to(q.dtype), lse


def _assert_tc_rule(got, want, pv_abs):
    excess = ((got.float() - want.float()).abs()
              - fa.tc_bf16_tolerance(want, pv_abs)).max()
    assert excess.item() <= 0, f"exceeds the rule by {excess}"


def _tc_mask(s, b_rows):
    """[B, S] 0/1 kv_mask: row 0 has an interior hole covering one whole
    64-column tile (S >= 192), row 1 a left pad that kills the first
    64-row Q tile when causal (S > 128), row 2 is all masked."""
    m = np.ones((b_rows, s), np.float32)
    if s >= 192:
        m[0, 64:128] = 0
    m[1, :(100 if s > 128 else s // 3)] = 0
    m[2] = 0
    return m


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [37, 200, 1000])
def test_tc_emulation_matches_jax_kernel_and_plain(s, d, causal):
    """The tensor-core arithmetic against the JAX kernel (interpret mode)
    and against ``attention_plain``, bf16, within the tensor-core rule;
    lse within 1e-4 where a row has a live key, exactly NEG_INF and O
    exactly 0 where it has none."""
    q, k, v = _inputs(3, 2, s, d, seed=s + d + causal)
    mask = _tc_mask(s, 3)
    tq, tk, tv = _torch([q, k, v], "bfloat16")
    tmask = torch.from_numpy(mask)
    o_e, lse_e = _tc_emulation(tq, tk, tv, causal, tmask)
    o_j, lse_j = jax_fwd(*_jax([q, k, v], "bfloat16"), jnp.asarray(mask),
                         causal, 128, 128, True)
    o_j = torch.from_numpy(np.array(o_j, np.float32))
    lse_j = torch.from_numpy(np.array(lse_j))
    o_p, lse_p = fa.attention_plain(tq, tk, tv, causal, tmask)
    pv = fa.attention_abs_pv_plain(tq, tk, tv, causal, tmask)
    _assert_tc_rule(o_e, o_j, pv)
    _assert_tc_rule(o_e, o_p, pv)
    live = lse_p > -1e29
    assert torch.equal(live, lse_j > -1e29)
    torch.testing.assert_close(lse_e[live], lse_j[live], atol=1e-4, rtol=0)
    torch.testing.assert_close(lse_e[live], lse_p[live], atol=1e-4, rtol=0)
    assert torch.all(lse_e[~live] == fa.NEG_INF)
    assert torch.all(o_e.float()[~live] == 0)
    assert torch.all(o_e[2] == 0)  # the all-masked batch row
    if causal and s > 128:  # row 1's first Q tile has no live score
        assert torch.all(o_e[1, :, :64] == 0)
        assert torch.all(lse_e[1, :, :64] == fa.NEG_INF)


def test_tc_emulation_needs_the_pv_term():
    """The old bf16 rule (one output step, 2**-7·|O|) is too tight for
    any kernel that rounds P to bf16: the emulation breaks it at the main
    path's kind of shape, and the P·V term is what covers the gap."""
    q, k, v = _inputs(1, 4, 512, 128, seed=11)
    mask = np.ones((1, 512), np.float32)
    mask[0, :150] = 0
    tq, tk, tv = _torch([q, k, v], "bfloat16")
    tmask = torch.from_numpy(mask)
    o_e, _ = _tc_emulation(tq, tk, tv, True, tmask)
    o_p, _ = fa.attention_plain(tq, tk, tv, True, tmask)
    pv = fa.attention_abs_pv_plain(tq, tk, tv, True, tmask)
    diff = (o_e.float() - o_p.float()).abs()
    assert (diff - 2.0 ** -7 * o_p.float().abs()).max() > 1e-5
    _assert_tc_rule(o_e, o_p, pv)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [200, 1000])
def test_tc_dead_tile_skip_is_bitwise_exact(s, causal):
    """Skipping K tiles with no live column changes no bit of O or lse:
    on such a tile every p is 0 and alpha is 1 (or p is forced to 0)."""
    q, k, v = _inputs(3, 2, s, 64, seed=s + 3)
    tq, tk, tv = _torch([q, k, v], "bfloat16")
    tmask = torch.from_numpy(_tc_mask(s, 3))
    o1, lse1 = _tc_emulation(tq, tk, tv, causal, tmask, skip=True)
    o2, lse2 = _tc_emulation(tq, tk, tv, causal, tmask, skip=False)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_kernel_variant_by_dtype():
    assert fa.kernel_variant(torch.bfloat16) == "tc_mma_bf16"
    assert fa.kernel_variant(torch.float32) == "fma_f32"
    with pytest.raises(ValueError, match="no kernel"):
        fa.kernel_variant(torch.float16)


def test_tile_counter_is_checked():
    """``tile_counter`` must be one int32 element on q's device; CPU
    tensors take the plain version and leave it as it is."""
    q = torch.zeros((1, 1, 8, 64))
    with pytest.raises(ValueError, match="tile_counter"):
        fa.flash_attention_fwd(q, q, q, tile_counter=torch.zeros(1))
    with pytest.raises(ValueError, match="tile_counter"):
        fa.flash_attention_fwd(q, q, q, tile_counter=torch.zeros(
            2, dtype=torch.int32))
    walked = torch.zeros(1, dtype=torch.int32)
    fa.flash_attention_fwd(q, q, q, tile_counter=walked)
    assert walked.item() == 0


def test_tc_bf16_tolerance_states_the_rule():
    """1e-5 + 2**-7·|O_plain| + 2**-8·(P|V|)_plain, elementwise."""
    o = torch.tensor([0.0, 1.0, -2.0]).bfloat16()
    pv = torch.tensor([0.0, 4.0, 2.0])
    torch.testing.assert_close(
        fa.tc_bf16_tolerance(o, pv),
        torch.tensor([1e-5, 1e-5 + 2.0 ** -7 + 2.0 ** -6,
                      1e-5 + 2.0 ** -6 + 2.0 ** -7]), rtol=1e-6, atol=0)
