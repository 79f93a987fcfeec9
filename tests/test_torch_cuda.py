"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports torch only (no jax), so it runs on a machine with a card and no
JAX installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, elementwise |kernel - plain| <= atol + rtol * |plain|: f32 in
and out, the kernel and the plain version both do f32 arithmetic in
different orders, so they agree to ~1e-6; atol = rtol = 1e-5. bf16 out,
each rounds its f32 value to bf16 once, and the two roundings can land
one bf16 step apart, which is at most 2**-7 of the value: rtol 2**-7,
atol 1e-5.
"""

import math

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.ops import flash_attention as fa
from sparkdl_tpu_torch.ops import flash_decode as fd

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2.0 ** -7)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 37, 64, 200, 1000])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_kernel_matches_plain(dev, dtype, d, s, causal):
    rng = np.random.default_rng(s * 7 + d)
    b, h = 3, 2
    q, k, v = (_randn(rng, (b, h, s, d), dtype, dev) for _ in range(3))
    pads = [0, s // 3, s]  # row 2 is all padding: O must be exactly 0
    mask = torch.tensor([[float(c >= p) for c in range(s)] for p in pads],
                        device=dev)
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal, kv_mask=mask)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    o_ref, lse_ref = fa.attention_plain(q.cpu(), k.cpu(), v.cpu(), causal,
                                        mask.cpu())
    assert o.dtype == dtype and lse.dtype == torch.float32
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(o.float().cpu(), o_ref.float(), atol=atol,
                               rtol=rtol)
    live = lse_ref > -1e29
    np.testing.assert_allclose(lse.cpu()[live], lse_ref[live], atol=1e-4,
                               rtol=1e-5)
    assert torch.all(lse.cpu()[~live] == lse_ref[~live])
    assert torch.all(o[2] == 0)


def test_flash_attention_no_mask_and_wrapper_checks(dev):
    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, (2, 4, 130, 64), torch.float32, dev)
               for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.attention_plain(q.cpu(), k.cpu(), v.cpu(), True)[0]
    np.testing.assert_allclose(got.cpu(), want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("vector_cur", [False, True])
def test_flash_decode_kernel_matches_plain(dev, dtype, d, rep, vector_cur):
    rng = np.random.default_rng(rep * 10 + d)
    b, h_kv, max_len = 4, 2, 300
    q = _randn(rng, (b, h_kv * rep, 1, d), dtype, dev)
    k = _randn(rng, (b, h_kv, max_len, d), dtype, dev)
    v = _randn(rng, (b, h_kv, max_len, d), dtype, dev)
    pads = torch.tensor([0, 5, 120, 290], dtype=torch.int32, device=dev)
    # row 3 has nothing live (cur <= pad) in the vector case: O = 0
    cur = (torch.tensor([300, 33, 121, 200], dtype=torch.int32, device=dev)
           if vector_cur else 297)
    before = fd.flash_decode.launches
    got = fd.flash_decode(q, k, v, cur, pads)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    want = fd.flash_decode_plain(q.cpu(), k.cpu(), v.cpu(),
                                 cur.cpu() if vector_cur else cur,
                                 pads.cpu())
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu(), want.float(), atol=atol,
                               rtol=rtol)
    if vector_cur:
        assert torch.all(got[3] == 0)


def test_flash_decode_reads_only_live_slots(dev):
    """NaN in the dead tail and in the left pad must not reach the output:
    the kernel never reads those slots."""
    rng = np.random.default_rng(3)
    b, h_kv, rep, max_len, d = 2, 2, 2, 256, 128
    q = _randn(rng, (b, h_kv * rep, 1, d), torch.float32, dev)
    k = _randn(rng, (b, h_kv, max_len, d), torch.float32, dev)
    v = _randn(rng, (b, h_kv, max_len, d), torch.float32, dev)
    pads = torch.tensor([0, 10], dtype=torch.int32, device=dev)
    clean = fd.flash_decode(q, k, v, 100, pads)
    k[:, :, 100:] = float("nan")
    v[:, :, 100:] = float("nan")
    k[1, :, :10] = float("nan")
    v[1, :, :10] = float("nan")
    got = fd.flash_decode(q, k, v, 100, pads)
    assert torch.isfinite(got).all()
    assert torch.equal(got, clean)


def test_generate_flash_matches_dense_on_card(dev):
    """Greedy generate() through both kernels equals the dense in-model
    path token for token, f32 (TF32 off), on a narrow head_dim-64 model."""
    from sparkdl_tpu_torch.models import llama as L

    cfg = L.LlamaConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=2, intermediate_size=512,
                        rope_theta=10000.0)
    g = torch.Generator(device=dev).manual_seed(0)
    model = L.LlamaModel(cfg, attn_fn=fa.flash_attention, device=dev,
                         generator=g)
    ids, pads = L.left_pad_prompts([[5, 6, 7], [9, 3, 2, 8, 1, 4, 4, 7],
                                    [11] * 70])
    fa0, fd0 = fa.flash_attention_fwd.launches, fd.flash_decode.launches
    got, steps = L.generate(model, ids, 6, pad_lens=pads, return_steps=True)
    assert fa.flash_attention_fwd.launches - fa0 == cfg.num_layers
    assert fd.flash_decode.launches - fd0 == cfg.num_layers * steps
    model.attn_fn = None
    want = L.generate(model, ids, 6, pad_lens=pads)
    assert torch.equal(got, want)
    assert math.isfinite(float(got.float().sum()))


def test_unsupported_shapes_raise_instead_of_running_dense(dev):
    """A CUDA tensor reaches the kernel or an exception: the "auto"
    attention and the model's decode step give no dense stand-in for a
    head_dim the kernels do not take (tiny's 32)."""
    from sparkdl_tpu_torch.models import llama as L

    rng = np.random.default_rng(5)
    q, k, v = (_randn(rng, (1, 2, 16, 32), torch.float32, dev)
               for _ in range(3))
    with pytest.raises(ValueError, match="head_dim 32"):
        fa.adaptive_attention(q, k, v, True)
    model = L.LlamaModel(L.LlamaConfig.tiny(), device=dev)
    assert L.resolve_attn_fn(model.attn_fn) is fa.adaptive_attention
    ids, pads = L.left_pad_prompts([[5, 6, 7], [9, 3, 2, 8]])
    with pytest.raises(ValueError, match="head_dim 32"):
        L.generate(model, ids, 2, pad_lens=pads)
    cache = L.init_cache(model, 2, 8)
    model.attn_fn = None
    L._prefill(model, ids.to(dev), cache, pads.to(dev))  # dense, as asked
    model.attn_fn = fa.adaptive_attention
    with pytest.raises(ValueError, match="head_dim 32"):
        L._decode_step(model, cache, torch.tensor([1, 2], device=dev),
                       pads.to(dev))
