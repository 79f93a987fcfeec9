"""The port's flash-attention backward (``sparkdl_tpu_torch.ops.
flash_attention``: ``attention_bwd_plain``, ``flash_attention_bwd`` and the
``torch.autograd.Function`` behind ``flash_attention``) against the JAX
package's, on the CPU.

The same seeded numpy inputs go through ``jax.vjp`` of the JAX package's
``flash_attention`` (its Pallas forward in interpret mode, with 16-row
blocks, and its ``custom_vjp`` backward ``_flash_bwd``) and through the
port: its plain forward for O and lse, then ``attention_bwd_plain`` (the
plain version of the CUDA backward kernel, which CPU tensors take).

Tolerance: f32 — both sides compute in f32 in different orders (the JAX
backward by 16-column tiles, the port on whole matrices),
|Δ| ≤ 1e-5 + 1e-5·|ref|. A fully-masked row's dq is exactly 0 on both.
The CUDA kernel itself is held to ``attention_bwd_plain`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash
from sparkdl_tpu_torch.ops import flash_attention as fa

B, H, D = 2, 2, 64


def _inputs(s, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, s, D)).astype(np.float32)
            for _ in range(4)]


def _mask(s, masked):
    """Batch row 0 left-padded by 7, row 1 all masked; None unmasked."""
    if not masked:
        return None
    m = np.zeros((B, s), np.float32)
    m[0, 7:] = 1.0
    return m


def _jax_grads(q, k, v, do, causal, mask):
    def f(q, k, v):
        return jax_flash(q, k, v, causal,
                         kv_mask=None if mask is None else jnp.asarray(mask),
                         block_q=16, block_k=16, interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, causal, mask):
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    mt = None if mask is None else torch.from_numpy(mask)
    o, lse = fa.flash_attention_fwd(qt, kt, vt, causal, kv_mask=mt)
    return fa.attention_bwd_plain(qt, kt, vt, o, lse, dot, causal, mt)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [64, 50])
def test_plain_backward_matches_jax_grad(s, causal, masked):
    q, k, v, do = _inputs(s, seed=s + 2 * causal + masked)
    mask = _mask(s, masked)
    want = _jax_grads(q, k, v, do, causal, mask)
    got = _port_grads(q, k, v, do, causal, mask)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    if masked:  # batch row 1 sees no key: every gradient there is 0
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert torch.all(g[1] == 0), name
            assert np.all(w[1] == 0), name
        # batch row 0: causal, its first 7 queries see only padding
        dead = 7 if causal else 0
        assert torch.all(got[0][0, :, :dead] == 0)
        assert torch.all(got[0][0, :, dead + 1:].abs().sum(-1) > 0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_function_gradients_are_the_plain_backward(causal, masked):
    """Autograd through ``fa.flash_attention`` on CPU tensors runs the
    ``_FlashAttention`` Function: its gradients are exactly
    ``attention_bwd_plain``'s on the saved O and lse, and ``kv_mask``
    gets none."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(50, seed=9))
    mask = None if not masked else torch.from_numpy(_mask(50, True))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*leaves, causal, kv_mask=mask)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(o, leaves, do)
    o_ref, lse = fa.flash_attention_fwd(q, k, v, causal, kv_mask=mask)
    assert torch.equal(o.detach(), o_ref)
    want = fa.attention_bwd_plain(q, k, v, o_ref, lse, do, causal, mask)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_function_only_under_grad():
    """Without grad mode, or with no input that requires grad, the
    forward runs alone: no ``grad_fn``, the same O."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(37, seed=1))
    plain = fa.flash_attention(q, k, v, True)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        o = fa.flash_attention(qg, k, v, True)
    assert o.grad_fn is None and torch.equal(o, plain)
    o = fa.flash_attention(qg, k, v, True)
    assert o.grad_fn is not None and torch.equal(o.detach(), plain)


def test_bwd_matches_autograd_of_the_dense_forward():
    """The plain backward is the gradient of the plain forward: autograd
    through ``attention_plain`` in f64 agrees (1e-5 in f32)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(50, seed=4))
    mask = torch.from_numpy(_mask(50, True))
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    o64 = fa.attention_plain(*leaves, True, mask.double())[0]
    want = torch.autograd.grad(o64, leaves, do.double())
    o, lse = fa.flash_attention_fwd(q, k, v, True, kv_mask=mask)
    got = fa.attention_bwd_plain(q, k, v, o, lse, do, True, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_bwd_tolerance_rule():
    """``bwd_tolerance``: zero where a row sees no key (the kernel must
    write exactly 0 there), and the bf16 (tensor-core) rule wider than
    the f32 one."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(50, seed=6))
    mask = torch.from_numpy(_mask(50, True))
    o, lse = fa.flash_attention_fwd(q, k, v, True, kv_mask=mask)
    args = (q, k, v, o, lse, do, True, mask)
    grads = fa.attention_bwd_plain(*args)
    for g, a in zip(grads, fa.attention_bwd_abs_plain(*args)):
        assert torch.all(a >= g.abs() - 1e-6)  # sums of the magnitudes
        tol = fa.bwd_tolerance(g, a)
        # batch row 1 and row 0's first 7 positions see or are only pads
        assert torch.all(tol[1] == 0) and torch.all(tol[0, :, :7] == 0)
        assert torch.all(tol[0, :, 7:] > 0)
        wide = fa.bwd_tolerance(g.bfloat16(), a)
        assert torch.all(wide >= tol - 1e-9)


def test_bwd_wrapper_checks_on_cpu():
    """The wrapper's checks run before it routes: O, dO and lse must fit
    q; a device that is neither CPU nor CUDA is refused."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(37, seed=2))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    with pytest.raises(ValueError, match="do must match"):
        fa.flash_attention_bwd(q, k, v, o, lse, do[:, :, :5], True)
    with pytest.raises(ValueError, match="o must match"):
        fa.flash_attention_bwd(q, k, v, o.double(), lse, do, True)
    with pytest.raises(ValueError, match="lse must be f32"):
        fa.flash_attention_bwd(q, k, v, o, lse[..., :3], do, True)
    with pytest.raises(ValueError, match="kv_mask"):
        fa.flash_attention_bwd(q, k, v, o, lse, do, True,
                               torch.ones(2, 36))
    meta = [torch.empty((1, 2, 8, 64), device="meta") for _ in range(5)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention_bwd(*meta[:4], torch.empty((1, 2, 8),
                                                      device="meta"),
                               meta[4], True)
    assert fa.flash_attention_bwd.launches == 0  # CPU runs launch nothing


# The tensor-core variant ("tc_mma_bf16") rounds P to bf16 before dV and
# dS/scale before dK and dQ; ``fa.attention_bwd_tc_plain`` emulates those
# roundings and ``fa.bwd_tolerance`` on bf16 gradients (the variant's
# rule: a = 2**-8 of the sum of the terms' magnitudes, r = 2**-7 of
# |plain|) must hold it around ``fa.attention_bwd_plain`` while still
# catching a real fault.


def _bf16_case(s, d, seed, masked):
    """bf16 q, k, v, dO and the plain forward's O and lse; at S = 2048
    one head (the score matrices are S x S a head). The mask as
    :func:`_mask`."""
    h = 1 if s >= 1024 else H
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, h, s, d)).astype(np.float32)).bfloat16() for _ in range(4))
    mask = _mask(s, masked)
    mask = None if mask is None else torch.from_numpy(mask)
    return q, k, v, do, mask


def _tc_excess(got, want, grad_abs):
    """max(|got - want| - rule) of one gradient, ``want`` in bf16 so that
    the tensor-core rule applies: > 0 means outside."""
    assert fa.kernel_variant(want.dtype) == "tc_mma_bf16"
    tol = fa.bwd_tolerance(want, grad_abs)
    return ((got.float() - want.float()).abs() - tol).max().item()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 37, 200, 2048])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_tc_emulation_inside_its_rule(seed, d, s, causal, masked):
    q, k, v, do, mask = _bf16_case(s, d, seed + 10 * s + d, masked)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, kv_mask=mask)
    args = (q, k, v, o, lse, do, causal, mask)
    got = fa.attention_bwd_tc_plain(*args)
    want = fa.attention_bwd_plain(*args)
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want,
                             fa.attention_bwd_abs_plain(*args)):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        assert _tc_excess(g, w, a) <= 0, name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 37, 200, 2048])
@pytest.mark.parametrize("d", [64, 128])
def test_tc_rule_catches_a_dropped_tile_pair(d, s, causal):
    """The emulation with the contribution of one 64x64 (Q tile, K tile)
    pair taken out — the last diagonal pair, whose rows and columns are
    the same positions — lies outside the rule: dv always, dq and dk
    where S > 1 (at S = 1 dS is 0 up to rounding: O = V). Masked as
    :func:`_mask` where S > 1 (at S = 1 that mask leaves no live key)."""
    q, k, v, do, mask = _bf16_case(s, d, 3 * s + d, s > 1)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, kv_mask=mask)
    args = (q, k, v, o, lse, do, causal, mask)
    want = fa.attention_bwd_plain(*args)
    f32 = [t.float() for t in (q, k, v, o)]
    full = fa.attention_bwd_tc_plain(*f32, lse, do.float(), causal, mask)
    r = slice((s - 1) // 64 * 64, s)  # the last tile's positions
    pair = fa.attention_bwd_tc_plain(
        *(t[:, :, r] for t in f32), lse[:, :, r], do.float()[:, :, r],
        causal, None if mask is None else mask[:, r])
    dropped = [g.clone() for g in full]
    for g, c in zip(dropped, pair):
        g[:, :, r] -= c
    for name, g, w, a in zip(("dq", "dk", "dv"), dropped, want,
                             fa.attention_bwd_abs_plain(*args)):
        if name == "dv" or s > 1:
            assert _tc_excess(g.bfloat16(), w, a) > 0, name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 37, 200, 2048])
def test_tc_emulation_masked_rows_are_zero(s, causal):
    """A batch row whose keys are all masked gets exactly 0 in dq, dk and
    dv from the emulation, as from the plain backward; causal, row 0's
    first 7 queries see only padding, so their dq is 0 too."""
    q, k, v, do, mask = _bf16_case(s, 64, s + causal, True)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, kv_mask=mask)
    got = fa.attention_bwd_tc_plain(q, k, v, o, lse, do, causal, mask)
    for g in got:
        assert torch.all(g[1] == 0)
    if causal:
        assert torch.all(got[0][0, :, :7] == 0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_tc_emulation_matches_jax_grad_within_rule(causal, masked):
    """The JAX package's gradients (``jax.vjp`` of its flash attention,
    interpret mode) on bf16-valued inputs, against the port's emulation of
    the tensor-core backward, within the "tc_mma_bf16" rule."""
    s = 50
    q, k, v, do = (a.astype(np.float32) for a in (
        t.float().numpy() for t in _bf16_case(s, D, 7, False)[:4]))
    mask = _mask(s, masked)
    want = _jax_grads(q, k, v, do, causal, mask)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    mt = None if mask is None else torch.from_numpy(mask)
    o, lse = fa.flash_attention_fwd(qt, kt, vt, causal, kv_mask=mt)
    args = (qt, kt, vt, o, lse, dot, causal, mt)
    got = fa.attention_bwd_tc_plain(*args)
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want,
                             fa.attention_bwd_abs_plain(*args)):
        assert _tc_excess(g, torch.tensor(w).bfloat16(), a) <= 0, name
