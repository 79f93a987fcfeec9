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

bf16 flash attention runs on the tensor cores ("tc_mma_bf16"), which
round P to bf16 before P·V (the plain version keeps p in f32). It is held
to ``fa.tc_bf16_tolerance``, the rule above plus 2**-8·(P|V|)_plain with
(P|V|) = sum_j p_j·|v_j| / l; that function gives the reason.

The flash backward's dq, dk and dv are held to ``fa.bwd_tolerance`` by
kernel variant: a·A + r·|plain|, A each entry's sum of the magnitudes of
its terms (``fa.attention_bwd_abs_plain``). f32 runs on the CUDA cores
("fma_f32"): a = r = 1e-5. bf16 runs on the tensor cores ("tc_mma_bf16"),
which round P to bf16 before dV and dS/scale before dK and dQ: a = 2**-8,
r = 2**-7. That function gives the reasons.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import math

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.ops import flash_attention as fa
from sparkdl_tpu_torch.ops import flash_decode as fd
from sparkdl_tpu_torch.ops import paged_flash_decode as pfd

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2.0 ** -7)}
NEG_INF = -1e30
# bf16 generate() prefill logits, kernel vs dense in-model path, as a
# share of the largest logit (test_generate_bf16_through_tensor_core_kernel):
# 0.0082 on an H100 80GB HBM3 at 700 W, where the planted faults gave
# 1.33 and 1.35; the bound is about twice the first
GEN_BF16_BOUND = 2.0 ** -6


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


def _assert_tc_bf16_close(o, q, k, v, causal, mask):
    """O within ``fa.tc_bf16_tolerance`` of the plain version's,
    elementwise, with the plain side on the CPU."""
    args = (q.cpu(), k.cpu(), v.cpu(), causal,
            None if mask is None else mask.cpu())
    want = fa.attention_plain(*args)[0]
    allowed = fa.tc_bf16_tolerance(want, fa.attention_abs_pv_plain(*args))
    excess = ((o.float().cpu() - want.float()).abs() - allowed).max().item()
    assert excess <= 0, (f"|O - O_plain| exceeds the bf16 tensor-core "
                         f"rule by {excess}")


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
    walked = torch.zeros(1, dtype=torch.int32, device=dev)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, kv_mask=mask,
                                    tile_counter=walked)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    o_ref, lse_ref = fa.attention_plain(q.cpu(), k.cpu(), v.cpu(), causal,
                                        mask.cpu())
    assert o.dtype == dtype and lse.dtype == torch.float32
    # only the tensor-core kernel counts tiles: the card shows which ran
    assert walked.item() == (_tiles_walked(mask, h, causal)
                             if dtype == torch.bfloat16 else 0)
    if dtype == torch.bfloat16:
        assert fa.kernel_variant(dtype) == "tc_mma_bf16"
        _assert_tc_bf16_close(o, q, k, v, causal, mask)
    else:
        assert fa.kernel_variant(dtype) == "fma_f32"
        atol, rtol = TOL[dtype]
        np.testing.assert_allclose(o.float().cpu(), o_ref.float(), atol=atol,
                                   rtol=rtol)
    live = lse_ref > -1e29
    np.testing.assert_allclose(lse.cpu()[live], lse_ref[live], atol=1e-4,
                               rtol=1e-5)
    assert torch.all(lse.cpu()[~live] == lse_ref[~live])
    assert torch.all(o[2] == 0)


def _tiles_walked(mask, h, causal):
    """(64-row Q tile, 64-row K tile) pairs the tensor-core kernel should
    compute: per head, each K tile with a live column, up to the causal
    stop."""
    b, s = mask.shape
    n_t = -(-s // 64)
    live = [[bool((mask[r, kt * 64:(kt + 1) * 64] > 0).any())
             for kt in range(n_t)] for r in range(b)]
    return h * sum(live[r][kt] for r in range(b) for qt in range(n_t)
                   for kt in range(qt + 1 if causal else n_t))


def _mask_rows(s, rows, dev):
    """[B, S] 0/1 mask; each row is ("pad", p) or ("hole", lo, hi)."""
    m = torch.ones((len(rows), s), device=dev)
    for r, spec in enumerate(rows):
        if spec[0] == "pad":
            m[r, :spec[1]] = 0
        else:
            m[r, spec[1]:spec[2]] = 0
    return m


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", [
    # causal, S, mask rows
    ("interior_hole", True, 512, [("hole", 128, 256), ("pad", 0),
                                  ("hole", 64, 448)]),
    ("dead_q_tiles", True, 512, [("pad", 64), ("pad", 200), ("pad", 511)]),
    ("ragged_pads", True, 1000, [("pad", 0), ("pad", 130), ("pad", 999)]),
    ("not_causal_mask", False, 300, [("hole", 64, 128), ("pad", 70),
                                     ("pad", 300)]),
], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_flash_attention_bf16_dead_tiles(dev, d, case):
    """The tensor-core kernel's skips: K tiles with no live column (an
    interior hole, left pads) and Q tiles with no live score (causal, pad
    >= 64) — those rows are exactly O = 0 and lse = NEG_INF."""
    _, causal, s, rows = case
    rng = np.random.default_rng(s + d)
    q, k, v = (_randn(rng, (3, 2, s, d), torch.bfloat16, dev)
               for _ in range(3))
    mask = _mask_rows(s, rows, dev)
    walked = torch.zeros(1, dtype=torch.int32, device=dev)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, kv_mask=mask,
                                    tile_counter=walked)
    torch.cuda.synchronize()
    assert walked.item() == _tiles_walked(mask, 2, causal)
    _assert_tc_bf16_close(o, q, k, v, causal, mask)
    _, lse_ref = fa.attention_plain(q.cpu(), k.cpu(), v.cpu(), causal,
                                    mask.cpu())
    live = lse_ref > -1e29
    np.testing.assert_allclose(lse.cpu()[live], lse_ref[live], atol=1e-4,
                               rtol=1e-5)
    dead = ~live  # rows with no live key: exactly O = 0, lse = NEG_INF
    assert torch.all(lse.cpu()[dead] == NEG_INF)
    assert torch.all(o.cpu()[dead] == 0)
    if case[0] == "dead_q_tiles":  # Q tile 0 of every row is dead
        assert torch.all(o[:, :, :64] == 0)
        assert torch.all(lse[:, :, :64] == NEG_INF)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_flop_count_on_card_equals_cpu(dev, d, causal):
    """Under ``utils.flops.count_flops`` the kernels report the FLOPs their
    plain versions report on the CPU, forward and backward through
    autograd, with left and right pads: the same count, exactly."""
    from sparkdl_tpu_torch.utils.flops import count_flops

    rng = np.random.default_rng(d)
    b, h, s = 2, 4, 200
    m = np.ones((b, s), np.float32)
    m[0, 150:] = 0
    m[1, :30] = 0
    counts = []
    for device in (dev, torch.device("cpu")):
        q, k, v = (_randn(rng, (b, h, s, d), torch.bfloat16, device)
                   .requires_grad_() for _ in range(3))
        with count_flops() as c:
            o = fa.flash_attention(q, k, v, causal,
                                   kv_mask=torch.from_numpy(m).to(device))
            o.float().sum().backward()
        counts.append(c.total)
    assert counts[0] == counts[1] == fa.attention_flops(
        q, causal, torch.from_numpy(m), fa.FWD_PRODUCTS + fa.BWD_PRODUCTS)


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


def test_flash_attention_from_threads_at_several_lengths(dev):
    """Threads launching the bf16 forward at once at different lengths, as
    a threaded fleet's prefills do. Each launch's dynamic shared memory
    grows with S, and no launch may fail because another thread set the
    kernel's shared-memory cap for its own S. Each thread's last output is
    bitwise the one its launch gave alone."""
    import threading

    rng = np.random.default_rng(16)
    cases = []
    for s in (64, 200, 631, 1000, 1503, 4096):
        q, k, v = (_randn(rng, (1, 2, s, 128), torch.bfloat16, dev)
                   for _ in range(3))
        cases.append((q, k, v, fa.flash_attention_fwd(q, k, v, True)[0]))
    torch.cuda.synchronize()
    errors, outs = [], [None] * len(cases)
    start = threading.Barrier(len(cases))

    def run(i):
        q, k, v, _ = cases[i]
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                start.wait(60)
                for _ in range(1000):
                    o = fa.flash_attention_fwd(q, k, v, True)[0]
                torch.cuda.current_stream().synchronize()
                outs[i] = o
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    for (_, _, _, want), got in zip(cases, outs):
        assert torch.equal(got, want)


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


def test_generate_bf16_through_tensor_core_kernel(dev):
    """bf16 generate() runs the tensor-core flash kernel once a layer in
    prefill, with finite logits; its prefill logits are held to the dense
    in-model path's (both bf16).

    Tolerance, as a share of the largest logit: the dense bf16 path
    rounds the scores and P to bf16, the kernel rounds P only, and the
    difference goes on through the norms and bf16 projections of 2
    layers. GEN_BF16_BOUND is a small factor above the difference seen on
    an H100, and the test shows that two planted faults of the attention
    (its output zeroed, its pad mask dropped) each land above it."""
    from sparkdl_tpu_torch.models import llama as L

    cfg = L.LlamaConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=2, intermediate_size=512,
                        rope_theta=10000.0)
    model = L.LlamaModel(cfg, dtype=torch.bfloat16, attn_fn=fa.flash_attention,
                         device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    ids, pads = L.left_pad_prompts([[5, 6, 7], [9, 3, 2, 8, 1, 4, 4, 7] * 9,
                                    [11] * 130])
    ids, pads = ids.to(dev), pads.to(dev)
    assert fa.kernel_variant(torch.bfloat16) == "tc_mma_bf16"

    def prefill(attn_fn):
        model.attn_fn = attn_fn
        cache = L.init_cache(model, ids.shape[0], ids.shape[1] + 2)
        return L._prefill(model, ids, cache, pads).float()

    fa0 = fa.flash_attention_fwd.launches
    got = prefill(fa.flash_attention)
    assert fa.flash_attention_fwd.launches - fa0 == cfg.num_layers
    assert torch.isfinite(got).all()
    out, steps = L.generate(model, ids.cpu(), 4, pad_lens=pads.cpu(),
                            return_steps=True)
    assert fa.flash_attention_fwd.launches - fa0 == 2 * cfg.num_layers
    assert steps == 4 and out.shape[1] == ids.shape[1] + 4
    want = prefill(None)
    scale = want.abs().max().item()

    def rel_err(logits):
        return (logits - want).abs().max().item() / scale

    def zeroed(q, k, v, causal=False, *, kv_mask=None):
        return torch.zeros_like(q)

    def mask_dropped(q, k, v, causal=False, *, kv_mask=None):
        return fa.flash_attention(q, k, v, causal)

    err = rel_err(got)
    faults = {"zeroed": rel_err(prefill(zeroed)),
              "mask_dropped": rel_err(prefill(mask_dropped))}
    print(f"prefill logits: kernel {err}, planted faults {faults} "
          f"(max |logit - dense| / max |dense logit|)")
    assert err <= GEN_BF16_BOUND, err
    for name, e in faults.items():
        assert e > GEN_BF16_BOUND, (name, e)


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


def _paged_case(rng, dev, *, dtype, kv, b, hkv, rep, s_q, d, bs, mb, curs,
                pads):
    """A pool whose live blocks are non-contiguous ids scattered over it,
    every block no table names filled with NaN, tables padded past each
    slot's fill with NaN blocks too; slot cur 0 parks on trash block 0.
    Returns (q, k_pool, v_pool, scales, tables, cur, pad)."""
    need = [-(-(c + s_q) // bs) for c in curs]
    pool = 1 + sum(need) + 8
    ids = rng.permutation(np.arange(1, pool))
    nan_ids = ids[sum(need):]
    tables = np.zeros((b, mb), np.int32)
    nxt = 0
    for r, n in enumerate(need):
        if curs[r] == 0:
            continue  # parked on the trash block 0
        tables[r, :n] = ids[nxt:nxt + n]
        tables[r, n:] = nan_ids[r % len(nan_ids)]
        nxt += n
    q = _randn(rng, (b, hkv * rep, s_q, d), dtype, dev)
    if kv in ("int8", "fp8"):
        code = torch.int8 if kv == "int8" else torch.float8_e4m3fn
        qmax = 127.0 if kv == "int8" else 448.0
        raw = rng.uniform(-qmax, qmax, (2, pool, hkv, bs, d))
        if kv == "int8":
            raw = np.round(raw)
        k_pool = torch.from_numpy(raw[0].astype(np.float32)).to(dev, code)
        v_pool = torch.from_numpy(raw[1].astype(np.float32)).to(dev, code)
        scales = torch.from_numpy(rng.uniform(
            1e-3, 2e-2, (pool, hkv, 2)).astype(np.float32)).to(dev)
        scales[torch.from_numpy(nan_ids).to(dev)] = float("nan")
    else:
        k_pool = _randn(rng, (pool, hkv, bs, d), dtype, dev)
        v_pool = _randn(rng, (pool, hkv, bs, d), dtype, dev)
        scales = None
        nan = torch.from_numpy(nan_ids).to(dev)
        k_pool[nan] = float("nan")
        v_pool[nan] = float("nan")
    return (q, k_pool, v_pool, scales, torch.from_numpy(tables).to(dev),
            torch.tensor(curs, dtype=torch.int32, device=dev),
            torch.tensor(pads, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("kv", ["same", "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q", [1, 5])
@pytest.mark.parametrize("rep,d", [(2, 128), (4, 64), (8, 128)])
def test_paged_flash_decode_kernel_matches_plain(dev, kv, dtype, s_q, rep, d):
    """Kernel B3 against its plain version over the phase-b matrix of
    chip_smoke.py at a narrower width: ragged fills, a slot parked on the
    trash block, non-contiguous tables, NaN in every block no live range
    reads."""
    rng = np.random.default_rng(rep * 100 + s_q * 10 + d)
    curs = [500, 301, 77, 16, 15, 1, 0, 200]
    pads = [0, 3, 40, 0, 15, 0, 0, 190]
    args = _paged_case(rng, dev, dtype=dtype, kv=kv, b=8, hkv=2, rep=rep,
                       s_q=s_q, d=d, bs=16, mb=33, curs=curs, pads=pads)
    before = pfd.paged_flash_decode.launches
    got = pfd.paged_flash_decode(*args[:3], args[4], args[5], args[6],
                                 kv_scales=args[3])
    torch.cuda.synchronize()
    assert pfd.paged_flash_decode.launches == before + 1
    want = pfd.paged_flash_decode_plain(*args[:3], args[4], args[5],
                                        args[6], kv_scales=args[3])
    assert torch.isfinite(got).all()
    atol, rtol = TOL[dtype]
    if kv != "same":  # codes of 10-100 times a unit scale: f32 sums of
        atol = 1e-4   # larger terms, the same one-rounding bf16 rule
    np.testing.assert_allclose(got.float().cpu(), want.float().cpu(),
                               atol=atol, rtol=rtol)
    # the parked slot (cur 0, pad 0) returns V at position 0 of trash
    # block 0 for its first query: finite garbage, not the zero output
    assert torch.any(got[6, :, 0] != 0)


def test_paged_flash_decode_raises_instead_of_running_dense(dev):
    """A CUDA input the kernel cannot take raises: head_dim 32, a pool
    whose dtype differs from q's, too many query rows, codes without
    scales."""
    rng = np.random.default_rng(0)
    args = _paged_case(rng, dev, dtype=torch.float32, kv="same", b=2, hkv=2,
                       rep=2, s_q=1, d=64, bs=16, mb=4, curs=[20, 3],
                       pads=[0, 0])
    q, kp, vp, _, tables, cur, pad = args
    with pytest.raises(ValueError, match="head_dim 32"):
        pfd.paged_flash_decode(q[..., :32].contiguous(),
                               kp[..., :32].contiguous(),
                               vp[..., :32].contiguous(), tables, cur, pad)
    with pytest.raises(ValueError, match="differs"):
        pfd.paged_flash_decode(q, kp.bfloat16(), vp.bfloat16(), tables, cur,
                               pad)
    big = q.repeat(1, 1, 65, 1)
    with pytest.raises(ValueError, match="query rows"):
        pfd.paged_flash_decode(big, kp, vp, tables, cur, pad)
    with pytest.raises(ValueError, match="kv_scales"):
        pfd.paged_flash_decode(q, kp.to(torch.int8), vp.to(torch.int8),
                               tables, cur, pad)


def test_serving_engine_runs_the_kernels_on_card(dev):
    """The paged engine with spec_k and the unpaged blocking engine on a
    head_dim-64 model give generate()'s greedy tokens, through the
    kernels (launch counts), f32 with TF32 off."""
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.serving import GenerationEngine

    cfg = L.LlamaConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=2, intermediate_size=512,
                        rope_theta=10000.0)
    model = L.LlamaModel(cfg, attn_fn=fa.flash_attention, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    prompts = [[5, 6, 7], [9, 3, 2, 8, 1, 4, 4, 7] * 5, [11] * 70]
    ids, pads = L.left_pad_prompts(prompts)
    out = L.generate(model, ids, 8, pad_lens=pads)
    refs = [out[i, ids.shape[1]:].tolist() for i in range(len(prompts))]
    for kw in (dict(block_size=16, prefill_chunk=32, spec_k=2),
               dict(block_size=16, prefill_chunk=32, kv_dtype="int8"),
               dict(stall_free=False, min_bucket=8)):
        p0, d0 = pfd.paged_flash_decode.launches, fd.flash_decode.launches
        eng = GenerationEngine.from_model(model, num_slots=2, max_len=160,
                                          **kw)
        hs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_idle()
        got = [h.result(1) for h in hs]
        if kw.get("kv_dtype") is None:
            assert got == refs, kw
        else:
            assert all(len(g) == 8 for g in got)
        if "block_size" in kw:
            assert pfd.paged_flash_decode.launches > p0
            assert fd.flash_decode.launches == d0
        else:
            assert fd.flash_decode.launches - d0 == \
                cfg.num_layers * eng.stats["steps"]


# --- split-KV decode: chunk edges, long tables, the in-launch merge -------

SC = fd.SPLIT_CHUNK


def _tol(dtype, kv="same"):
    atol, rtol = TOL[dtype]
    return (1e-4 if kv != "same" else atol), rtol


def test_split_kv_counts_its_blocks(dev):
    """The kernel's own count of the blocks it ran and of those that found
    a live position equals the plan (``fd.split_blocks``): chunk edges, a
    chunk of pad only, a row with nothing live, the S = 5 window and a
    16384-position table. Counting changes no output bit."""
    rng = np.random.default_rng(14)
    length = 4 * SC
    q = _randn(rng, (4, 8, 1, 64), torch.bfloat16, dev)
    k = _randn(rng, (4, 2, length, 64), torch.bfloat16, dev)
    v = _randn(rng, (4, 2, length, 64), torch.bfloat16, dev)
    curs, pads = [SC, SC + 1, 3 * SC, 5], [0, SC - 1, 2 * SC, 5]
    cur = torch.tensor(curs, dtype=torch.int32, device=dev)
    pad = torch.tensor(pads, dtype=torch.int32, device=dev)
    cnt = torch.zeros(2, dtype=torch.int32, device=dev)
    got = fd.flash_decode(q, k, v, cur, pad, block_counter=cnt)
    plan = fd.split_blocks(length, 4, 2, list(zip(pads, curs)))
    assert cnt.tolist() == [plan["grid_blocks"], plan["live_blocks"]], plan
    assert torch.equal(got, fd.flash_decode(q, k, v, cur, pad))
    for s_q, mb in ((5, 3 * SC // 16), (1, 16384 // 16)):
        pcur, ppad = [SC - 1, 0, 2 * SC + 3, mb * 16 - 6], [0, 0, 2 * SC, SC]
        args = _paged_case(rng, dev, dtype=torch.bfloat16, kv="same", b=4,
                           hkv=2, rep=2, s_q=s_q, d=128, bs=16, mb=mb,
                           curs=pcur, pads=ppad)
        qp, kp, vp, _, tables, curp, padp = args
        cnt.zero_()
        got = pfd.paged_flash_decode(qp, kp, vp, tables, curp, padp,
                                     block_counter=cnt)
        spans = [(p, min(c + s_q, mb * 16)) for c, p in zip(pcur, ppad)]
        plan = fd.split_blocks(mb * 16, 2 * s_q, 2, spans)
        assert cnt.tolist() == [plan["grid_blocks"],
                                plan["live_blocks"]], (s_q, plan)
        assert torch.equal(got, pfd.paged_flash_decode(qp, kp, vp, tables,
                                                        curp, padp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_decode_split_edges(dev, dtype, d):
    """cur and pad on each side of a chunk edge, chunks of pad only, a
    row with nothing live; the kernel against the plain version and the
    CPU emulation of its arithmetic."""
    rng = np.random.default_rng(d + 1)
    b, h_kv, rep, length = 8, 2, 4, 4 * SC
    q = _randn(rng, (b, h_kv * rep, 1, d), dtype, dev)
    k = _randn(rng, (b, h_kv, length, d), dtype, dev)
    v = _randn(rng, (b, h_kv, length, d), dtype, dev)
    cur = torch.tensor([SC - 1, SC, SC + 1, 4 * SC, 2 * SC + 1, 3 * SC, 5,
                        2 * SC - 1], dtype=torch.int32, device=dev)
    pads = torch.tensor([0, SC - 1, SC, SC + 1, 2 * SC, 2 * SC - 1, 0,
                         2 * SC - 1], dtype=torch.int32, device=dev)
    got = fd.flash_decode(q, k, v, cur, pads)
    torch.cuda.synchronize()
    args = (q.cpu(), k.cpu(), v.cpu(), cur.cpu(), pads.cpu())
    atol, rtol = _tol(dtype)
    for want in (fd.flash_decode_plain(*args),
                 fd.flash_decode_emulation(*args)):
        np.testing.assert_allclose(got.float().cpu(), want.float(),
                                   atol=atol, rtol=rtol)
    assert torch.all(got[7] == 0)  # cur <= pad: nothing live


@pytest.mark.parametrize("kv", ["same", "int8"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s_q", [1, 5])
def test_paged_flash_decode_split_edges(dev, kv, d, s_q):
    """The paged kernel with fills and pads on each side of chunk edges,
    a chunk of pad only and a parked slot, bf16 queries, NaN in every
    block no live range reads."""
    rng = np.random.default_rng(d * 10 + s_q)
    curs = [SC - 1, SC, SC + 1, 0, 2 * SC + 3, SC + 10, 3 * SC - 6, 1]
    pads = [0, SC, SC - 1, 0, 2 * SC, SC + 1, SC, 0]
    args = _paged_case(rng, dev, dtype=torch.bfloat16, kv=kv, b=8, hkv=2,
                       rep=2, s_q=s_q, d=d, bs=16, mb=3 * SC // 16,
                       curs=curs, pads=pads)
    q, kp, vp, sc, tables, cur, pad = args
    got = pfd.paged_flash_decode(q, kp, vp, tables, cur, pad, kv_scales=sc)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    cpu = [x if x is None else x.cpu() for x in (q, kp, vp, tables, cur,
                                                    pad, sc)]
    atol, rtol = _tol(torch.bfloat16, kv)
    for want in (pfd.paged_flash_decode_plain(*cpu[:6], kv_scales=cpu[6]),
                 pfd.paged_flash_decode_emulation(*cpu[:6],
                                                  kv_scales=cpu[6])):
        np.testing.assert_allclose(got.float().cpu(), want.float(),
                                   atol=atol, rtol=rtol)


def test_split_kv_long_tables(dev):
    """16384 positions a row: 256 splits of both kernels, merged in the
    launch, against the plain versions."""
    rng = np.random.default_rng(11)
    n = 16384
    q = _randn(rng, (3, 8, 1, 128), torch.bfloat16, dev)
    k = _randn(rng, (3, 2, n, 128), torch.bfloat16, dev)
    v = _randn(rng, (3, 2, n, 128), torch.bfloat16, dev)
    cur = torch.tensor([n, 9001, 65], dtype=torch.int32, device=dev)
    pads = torch.tensor([0, 4000, 64], dtype=torch.int32, device=dev)
    got = fd.flash_decode(q, k, v, cur, pads)
    want = fd.flash_decode_plain(q, k, v, cur, pads)
    atol, rtol = _tol(torch.bfloat16)
    np.testing.assert_allclose(got.float().cpu(), want.float().cpu(),
                               atol=atol, rtol=rtol)
    args = _paged_case(rng, dev, dtype=torch.bfloat16, kv="same", b=4, hkv=2,
                       rep=2, s_q=1, d=128, bs=16, mb=n // 16,
                       curs=[n - 1, 12000, 63, 0], pads=[0, 5000, 0, 0])
    qp, kp, vp, _, tables, curp, padp = args
    got = pfd.paged_flash_decode(qp, kp, vp, tables, curp, padp)
    want = pfd.paged_flash_decode_plain(qp, kp, vp, tables, curp, padp)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().cpu(), want.float().cpu(),
                               atol=atol, rtol=rtol)


def test_split_kv_merge_is_deterministic(dev):
    """Three calls back to back, then two shapes interleaved: the outputs
    are bitwise equal, so the counters reset after every launch and the
    merge does not depend on the order in which the splits finish."""
    rng = np.random.default_rng(12)
    q = _randn(rng, (4, 16, 1, 128), torch.bfloat16, dev)
    k = _randn(rng, (4, 8, 2112, 128), torch.bfloat16, dev)
    v = _randn(rng, (4, 8, 2112, 128), torch.bfloat16, dev)
    cur = torch.tensor([2049, 1501, 701, 34], dtype=torch.int32, device=dev)
    args = _paged_case(rng, dev, dtype=torch.bfloat16, kv="same", b=8, hkv=8,
                       rep=2, s_q=1, d=128, bs=16, mb=132,
                       curs=[2047, 1500, 900, 513, 300, 64, 17, 0],
                       pads=[0, 0, 37, 0, 0, 0, 0, 0])
    qp, kp, vp, _, tables, curp, padp = args

    def dec():
        return fd.flash_decode(q, k, v, cur)

    def paged():
        return pfd.paged_flash_decode(qp, kp, vp, tables, curp, padp)

    first = [dec() for _ in range(3)]
    mixed = [f() for f in (paged, dec, paged, dec, paged)]
    torch.cuda.synchronize()
    for o in first[1:] + mixed[1::2]:
        assert torch.equal(o, first[0])
    for o in mixed[2::2]:
        assert torch.equal(o, mixed[0])
    np.testing.assert_allclose(
        first[0].float().cpu(), fd.flash_decode_plain(q, k, v,
                                                      cur).float().cpu(),
        atol=1e-5, rtol=2.0 ** -7)


def test_split_kv_graph_capture_and_replay(dev):
    """Each wrapper captured in a CUDA graph after a warm-up, replayed
    after cur changes in place: equal to the plain version at the new
    fill. The grid comes from static shapes and the launch syncs nothing
    with the host."""
    rng = np.random.default_rng(13)
    q = _randn(rng, (4, 16, 1, 128), torch.bfloat16, dev)
    k = _randn(rng, (4, 8, 1024, 128), torch.bfloat16, dev)
    v = _randn(rng, (4, 8, 1024, 128), torch.bfloat16, dev)
    cur = torch.tensor([1000, 500, 64, 3], dtype=torch.int32, device=dev)
    pads = torch.tensor([0, 10, 0, 0], dtype=torch.int32, device=dev)
    args = _paged_case(rng, dev, dtype=torch.bfloat16, kv="int8", b=4, hkv=8,
                       rep=2, s_q=1, d=128, bs=16, mb=64,
                       curs=[1000, 700, 65, 0], pads=[0, 0, 64, 0])
    qp, kp, vp, sc, tables, curp, padp = args
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: library, counters
        fd.flash_decode(q, k, v, cur, pads)
        pfd.paged_flash_decode(qp, kp, vp, tables, curp, padp, kv_scales=sc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fd.flash_decode(q, k, v, cur, pads)
        outp = pfd.paged_flash_decode(qp, kp, vp, tables, curp, padp,
                                      kv_scales=sc)
    atol, rtol = _tol(torch.bfloat16)
    for new, newp in (([1001, 400, 65, 0], [1001, 300, 70, 0]),
                      ([12, 1024, 128, 64], [63, 699, 64, 0])):
        cur.copy_(torch.tensor(new, dtype=torch.int32))
        curp.copy_(torch.tensor(newp, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        np.testing.assert_allclose(
            out.float().cpu(),
            fd.flash_decode_plain(q, k, v, cur, pads).float().cpu(),
            atol=atol, rtol=rtol)
        np.testing.assert_allclose(
            outp.float().cpu(),
            pfd.paged_flash_decode_plain(qp, kp, vp, tables, curp, padp,
                                         kv_scales=sc).float().cpu(),
            atol=1e-4, rtol=rtol)


# --- the flash kernel's gradient rule, and the compiled decode step -------

HD64 = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=512, rope_theta=10000.0)


# LoRA gradients, kernel arm against the dense arm, as a share of the
# largest gradient of each adapter: the f32 arms differ in summation order
# only; the bf16 arms round at other places (the kernel rounds P to bf16
# before P·V, the dense arm rounds p and takes both products in bf16).
# Measured 1.45e-6 (f32) and 0.0204 (bf16) on an NVIDIA H100 80GB HBM3 at
# 700 W; the bounds are about 7x and 3x those
LORA_GRAD_BOUND = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -4}


def _lora_grads(model, ids):
    from sparkdl_tpu_torch.models import llama as L

    model.zero_grad(set_to_none=True)
    loss, _ = L.causal_lm_loss_fn()(model, {"input_ids": ids})
    loss.backward()
    return loss.item(), {n: p.grad.float().clone()
                         for n, p in model.named_parameters()
                         if p.grad is not None}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_gradients_match_dense_arm(dev, dtype):
    """The training forward with ``attn_fn="auto"`` runs the flash kernel
    and its backward kernel: the LoRA gradients of the causal LM loss
    match the dense arm's (``attn_fn=None``), one forward and one
    backward launch a layer."""
    import dataclasses

    from sparkdl_tpu_torch.models import llama as L

    cfg = dataclasses.replace(L.LlamaConfig(**HD64), lora_rank=4)
    assert cfg.head_dim == 64
    model = L.LlamaModel(cfg, dtype=dtype, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    L.lora_optimizer(1e-3)(model)  # freezes the base weights
    with torch.no_grad():  # B carries signal (it starts at zero)
        for name, p in model.named_parameters():
            if "lora_b" in name:
                p.normal_(0.0, 0.05, generator=torch.Generator(
                    device=dev).manual_seed(len(name)))
    ids = torch.randint(1, 512, (2, 200), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    assert L.resolve_attn_fn(model.attn_fn) is fa.adaptive_attention
    f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    loss_k, g_k = _lora_grads(model, ids)
    assert fa.flash_attention_fwd.launches - f0 == cfg.num_layers
    assert fa.flash_attention_bwd.launches - b0 == cfg.num_layers
    model.attn_fn = None
    loss_d, g_d = _lora_grads(model, ids)
    assert sorted(g_k) == sorted(g_d) and len(g_k) == 4 * cfg.num_layers
    assert abs(loss_k - loss_d) <= 1e-4 * abs(loss_d) + (
        0 if dtype == torch.float32 else 1e-2)
    shares = {}
    for name, want in g_d.items():
        err = (g_k[name] - want).abs().max().item()
        assert want.abs().max().item() > 0, name
        shares[name] = err / want.abs().max().item()
    print(f"lora grad |kernel - dense| / max|dense| ({dtype}): max "
          f"{max(shares.values()):.3g}; loss {loss_k} vs {loss_d}")
    assert max(shares.values()) <= LORA_GRAD_BOUND[dtype], shares


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 37, 64, 200, 1000])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bwd_kernel_matches_plain(dev, dtype, d, s, causal):
    """(dq, dk, dv) of the backward kernel against
    ``fa.attention_bwd_plain`` on the same (q, k, v, O, lse, dO), held to
    ``fa.bwd_tolerance`` of the dtype's variant; batch row 2 is all
    padding, so its dq, dk and dv are exactly 0, and row 1 has a left
    pad."""
    rng = np.random.default_rng(s * 11 + d)
    b, h = 3, 2
    q, k, v, do = (_randn(rng, (b, h, s, d), dtype, dev) for _ in range(4))
    pads = [0, s // 3, s]
    mask = torch.tensor([[float(c >= p) for c in range(s)] for p in pads],
                        device=dev)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, kv_mask=mask)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, mask)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    args = (q, k, v, o, lse, do, causal, mask)
    want = fa.attention_bwd_plain(*args)
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want,
                             fa.attention_bwd_abs_plain(*args)):
        assert g.dtype == dtype and g.shape == q.shape
        excess = ((g.float() - w.float()).abs()
                  - fa.bwd_tolerance(w, a)).max().item()
        assert excess <= 0, (name, excess)
        assert torch.all(g[2] == 0), f"{name}: the all-masked row is not 0"
    # deterministic: no atomics, the same bits again
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, mask)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_attention_bwd_wrapper_checks(dev):
    """The backward wrapper raises on what the kernel does not take, and
    without a mask matches the plain version."""
    rng = np.random.default_rng(5)
    q, k, v, do = (_randn(rng, (2, 4, 130, 128), torch.bfloat16, dev)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    args = (q, k, v, o, lse, do, True)
    for g, w, a in zip(got, fa.attention_bwd_plain(*args),
                       fa.attention_bwd_abs_plain(*args)):
        assert ((g.float() - w.float()).abs()
                - fa.bwd_tolerance(w, a)).max() <= 0
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd(q, k, v, o, lse, do.transpose(1, 2)
                               .contiguous().transpose(1, 2), True)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, o, lse.bfloat16(), do, True)
    q32 = _randn(rng, (2, 4, 130, 32), torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bwd(q32, q32, q32, q32, lse, q32, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_launches_its_variant(dev, dtype):
    """bf16 gradients come from the tensor-core kernels ("tc_mma_bf16"),
    f32 ones from the CUDA-core kernels ("fma_f32"): the wrapper counts
    each launch under the variant it handed the C entry. The bf16 kernel
    also lies within its rule around ``fa.attention_bwd_tc_plain``, the
    emulation of its roundings."""
    rng = np.random.default_rng(8)
    q, k, v, do = (_randn(rng, (2, 4, 300, 128), dtype, dev)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    before = dict(fa.flash_attention_bwd.variant_launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    after = fa.flash_attention_bwd.variant_launches
    variant = fa.kernel_variant(dtype)
    assert variant == ("tc_mma_bf16" if dtype == torch.bfloat16
                       else "fma_f32")
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == variant) for n in after}
    if dtype == torch.bfloat16:
        args = (q, k, v, o, lse, do, True)
        for g, w, a in zip(got, fa.attention_bwd_tc_plain(*args),
                           fa.attention_bwd_abs_plain(*args)):
            assert ((g.float() - w.float()).abs()
                    - fa.bwd_tolerance(w, a)).max() <= 0


def test_fit_on_card(dev):
    """``XlaRunner(np=1).run(ctx.fit(...))`` trains the LoRA adapters of
    a bf16 model through both flash kernels for 4 steps: finite, falling
    losses, one forward and one backward launch a layer a step, base
    weights unchanged, adapters moved."""
    import dataclasses

    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.runner import XlaRunner

    cfg = dataclasses.replace(L.LlamaConfig(**HD64), lora_rank=4)
    model = L.LlamaModel(cfg, dtype=torch.bfloat16, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ids = np.random.default_rng(2).integers(1, 512, (4, 256))
    f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    res = XlaRunner(np=1).run(lambda ctx: ctx.fit(
        loss_fn=L.causal_lm_loss_fn(), model=model,
        tx=L.lora_optimizer(5e-3), data=[{"input_ids": ids}] * 4,
        num_steps=4, log_every=1))
    losses = [h["loss"] for h in res["history"]]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0], losses
    assert fa.flash_attention_fwd.launches - f0 == 4 * cfg.num_layers
    assert fa.flash_attention_bwd.launches - b0 == 4 * cfg.num_layers
    mask = L.lora_mask(model)
    for name, p in model.named_parameters():
        if mask[name]:
            assert not torch.equal(p, before[name]), name
        else:
            assert torch.equal(p, before[name]), name


def _eager_decode(L, model, ids, pads, new, eos_id=None):
    """generate()'s loop with every step eager (``_decode_step`` called
    directly, no runner): greedy tokens and the step count."""
    cache = L.init_cache(model, ids.shape[0], ids.shape[1] + new)
    tok = L._prefill(model, ids, cache, pads).argmax(-1)
    out = torch.full((ids.shape[0], new), -1 if eos_id is None else eos_id,
                     dtype=tok.dtype, device=tok.device)
    done = torch.zeros_like(tok, dtype=torch.bool) if eos_id is None \
        else tok == eos_id
    steps = 0
    while steps < new and not bool(done.all()):
        out[:, steps] = tok
        nxt = L._decode_step(model, cache, tok, pads).argmax(-1)
        if eos_id is not None:
            nxt = torch.where(done, eos_id, nxt)
            done = done | (nxt == eos_id)
        tok = nxt
        steps += 1
    assert cache.idx == int(cache.idx_dev) == ids.shape[1] + steps
    return out, steps


def _counts():
    return (fa.flash_attention_fwd.launches, fd.flash_decode.launches,
            pfd.paged_flash_decode.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("eos", [False, True])
def test_generate_graph_equals_eager_step(dev, dtype, eos):
    """generate() replays its S = 1 step from a CUDA graph: the greedy
    stream equals the eager step's bit for bit (left pads, with and
    without eos), with the same launch counts, and the host and device
    fill indices agree."""
    from sparkdl_tpu_torch.models import llama as L

    model = L.LlamaModel(L.LlamaConfig(**HD64), dtype=dtype, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    ids, pads = L.left_pad_prompts([[5, 6, 7], [9, 3, 2, 8, 1, 4, 4, 7] * 4,
                                    [11] * 70])
    ids, pads = ids.to(dev), pads.to(dev)
    new = 12
    eos_id = None
    if eos:
        free, _ = _eager_decode(L, model, ids, pads, new)
        eos_id = int(free[0, 2])
    c0 = _counts()
    want, want_steps = _eager_decode(L, model, ids, pads, new, eos_id)
    c1 = _counts()
    got, steps = L.generate(model, ids, new, pad_lens=pads, eos_id=eos_id,
                            return_steps=True)
    c2 = _counts()
    assert steps == want_steps
    assert torch.equal(got[:, ids.shape[1]:ids.shape[1] + steps],
                       want[:, :steps])
    eager = [b - a for a, b in zip(c0, c1)]
    graph = [b - a for a, b in zip(c1, c2)]
    assert graph == eager, (graph, eager)
    assert graph[1] == 2 * steps


def _eager_step(L, be):
    """The backend's S = 1 step with the model called eagerly: the eager
    arm the graph is held to."""
    def step(active_slots):
        tok, cur, pads = be._step_operands()
        if getattr(be, "paged", False):
            nxt = L.paged_slot_decode_step(be.model, be.cache, be._tables(),
                                           tok, cur, pads, be._gen,
                                           **be._sampling())
        else:
            nxt = L.slot_decode_step(be.model, be.cache, tok, cur, pads,
                                     be._gen, **be._sampling())
        return be._advance(active_slots, nxt)
    return step


@pytest.mark.parametrize("kw", [
    dict(block_size=16, prefill_chunk=32),
    dict(block_size=16, prefill_chunk=32, kv_dtype="int8"),
    dict(stall_free=False, min_bucket=8),
    dict(block_size=16, prefill_chunk=32, temperature=0.8, seed=5),
], ids=["paged_bf16", "paged_int8", "unpaged", "paged_sampled"])
def test_engine_graph_equals_eager_step(dev, kw):
    """Both engines replay every S = 1 step from a CUDA graph: with cur,
    tables and pads changing between replays (requests of different
    lengths refilling 2 slots) and one cache_lost failover (``rebuild()``
    drops the graphs and the next step captures anew), the streams equal
    the eager step's bit for bit, sampled ones included, with the same
    launch counts."""
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.serving import GenerationEngine
    from sparkdl_tpu_torch.serving.backend import SlotCacheLost

    model = L.LlamaModel(L.LlamaConfig(**HD64), dtype=torch.bfloat16,
                         device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    prompts = [[5, 6, 7], [9, 3, 2, 8, 1, 4, 4, 7] * 5, [11] * 70,
               [4, 8] * 9]

    def serve(eager):
        eng = GenerationEngine.from_model(model, num_slots=2, max_len=160,
                                          device=dev, **kw)
        be = eng.backend
        inner = _eager_step(L, be) if eager else be.step
        calls = [0]

        def step(active_slots):  # the 4th step loses the cache
            calls[0] += 1
            if calls[0] == 4:
                raise SlotCacheLost("planted: the cache is lost")
            return inner(active_slots)
        be.step = step
        c0 = _counts()
        hs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        eng.run_until_idle()
        c1 = _counts()
        assert eng.snapshot()["failovers"] == 1
        return ([h.result(1) for h in hs],
                [b - a for a, b in zip(c0, c1)], eng)

    want, eager_counts, _ = serve(True)
    got, graph_counts, eng = serve(False)
    assert got == want
    assert graph_counts == eager_counts
    snap = eng.backend.graphs.snapshot()
    # one capture before the failover, one after it on the new cache
    assert snap["captures"] == 2 and snap["replays"] >= 1, snap


# --- BERT's shapes: D 64, not causal, right pads (BASELINE config 4) ------

def _right_pad_mask(s, dev):
    """[4, S] right pads: one full row, one of length 1, one a third long,
    one S - 70 long (at S 512 its last K tile is dead)."""
    lens = [s, 1, max(1, s // 3), max(1, s - 70)]
    return torch.tensor([[float(c < n) for c in range(s)] for n in lens],
                        device=dev), lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 33, 77, 128, 512])
def test_flash_kernels_at_bert_shapes(dev, dtype, s):
    """Forward and backward kernels against their plain versions at
    BERT's shapes. A padded query row is not a dead row: it attends its
    row's live keys, so its O and lse are finite and its dq real; every
    masked column — a wholly dead K tile included — has dK = dV = 0
    exactly."""
    rng = np.random.default_rng(s * 13 + 1)
    b, h, d = 4, 2, 64
    q, k, v, do = (_randn(rng, (b, h, s, d), dtype, dev) for _ in range(4))
    mask, lens = _right_pad_mask(s, dev)
    walked = torch.zeros(1, dtype=torch.int32, device=dev)
    o, lse = fa.flash_attention_fwd(q, k, v, False, kv_mask=mask,
                                    tile_counter=walked)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.attention_plain(q.cpu(), k.cpu(), v.cpu(), False,
                                        mask.cpu())
    if dtype == torch.bfloat16:
        assert walked.item() == _tiles_walked(mask, h, False)
        _assert_tc_bf16_close(o, q, k, v, False, mask)
    else:
        np.testing.assert_allclose(o.cpu(), o_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.cpu(), lse_ref, atol=1e-4, rtol=1e-5)
    assert torch.isfinite(lse).all() and (lse > -1e29).all()
    for r, n in enumerate(lens):  # padded query rows attend live keys
        if n < s:
            assert (o[r, :, n:].float().abs().sum(-1) > 0).all()
    args = (q, k, v, o, lse, do, False, mask)
    got = fa.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    want = fa.attention_bwd_plain(*args)
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want,
                             fa.attention_bwd_abs_plain(*args)):
        excess = ((g.float() - w.float()).abs()
                  - fa.bwd_tolerance(w, a)).max().item()
        assert excess <= 0, (name, excess)
    dq, dk, dv = got
    for r, n in enumerate(lens):
        assert torch.all(dk[r, :, n:] == 0) and torch.all(dv[r, :, n:] == 0)
        if 1 < n < s:  # a padded query row has a real gradient (with one
            # live key P is 1 and dS = P·(dP - δ) is 0: dq is 0 up to
            # rounding)
            assert (dq[r, :, n:].float().abs().sum(-1) > 0).all()
        # a wholly dead 64-column K tile
        for kt in range(-(-n // 64), -(-s // 64)):
            cols = slice(kt * 64, min(s, kt * 64 + 64))
            assert torch.all(dk[r, :, cols] == 0), (r, kt)
            assert torch.all(dv[r, :, cols] == 0), (r, kt)


# BERT parameter gradients, kernel arm against the dense arm, as a share
# of each parameter's largest |dense gradient|: f32, TF32 off, the arms
# differ in summation order only (the bound is the one chip_smoke's
# phase h parity keeps). The key biases' gradient is zero up to rounding
# in both arms (a bias on every key shifts a query's scores by one
# constant, which softmax ignores): they are held below 1e-6 of the
# model's largest gradient instead
BERT_GRAD_SHARE, BERT_KEY_BIAS_SHARE = 1e-4, 1e-6


def _bert_d64(dev, dtype=torch.float32):
    from sparkdl_tpu_torch.models import bert as B

    cfg = B.BertConfig(vocab_size=512, hidden_size=128, num_layers=2,
                       num_heads=2, intermediate_size=256,
                       max_position_embeddings=256)
    assert cfg.head_dim == 64
    model = B.BertForSequenceClassification(
        cfg, num_classes=2, dtype=dtype, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(3)
    lens = torch.tensor([77, 1, 40, 64], device=dev)
    mask = (torch.arange(77, device=dev)[None] < lens[:, None]).int()
    batch = {"input_ids": torch.randint(1, 512, (4, 77), device=dev,
                                        generator=g) * mask,
             "attention_mask": mask,
             "label": torch.tensor([0, 1, 1, 0], device=dev)}
    return B, model, batch


def test_bert_kernel_gradients_match_dense_arm(dev):
    B, model, batch = _bert_d64(dev)
    assert fa.resolve_attn_fn(model.attn_fn) is fa.adaptive_attention

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = B.glue_loss_fn()(model, batch)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    loss_k, g_k = grads()
    assert fa.flash_attention_fwd.launches - f0 == 2
    assert fa.flash_attention_bwd.launches - b0 == 2
    model.attn_fn = None
    loss_d, g_d = grads()
    assert abs(loss_k - loss_d) <= 1e-4
    top = max(g.abs().max().item() for g in g_d.values())
    for name, want in g_d.items():
        if name.endswith("key.bias"):
            for g in (g_k[name], want):
                assert g.abs().max().item() <= BERT_KEY_BIAS_SHARE * top
            continue
        scale = want.abs().max().item()
        assert scale > 0, name
        share = (g_k[name] - want).abs().max().item() / scale
        assert share <= BERT_GRAD_SHARE, (name, share)


def test_bert_with_rng_repeats_on_the_card(dev):
    """with_rng draws the dropout masks from a CUDA generator seeded by
    (rng_seed, step): the same seed repeats the losses to the bit, another
    seed changes them; both flash kernels run every step."""
    from sparkdl_tpu_torch.runner import TrainState
    from sparkdl_tpu_torch.runner.train_state import adam, make_train_step

    def losses(seed):
        B, model, batch = _bert_d64(dev, torch.bfloat16)
        state = TrainState.create(model, adam(1e-3))
        step = make_train_step(B.bert_finetune_loss(model), with_rng=True,
                               rng_seed=seed)
        out = []
        for _ in range(3):
            state, m = step(state, batch)
            out.append(float(m["loss"]))
        return out

    b0 = fa.flash_attention_bwd.variant_launches["tc_mma_bf16"]
    a, again, other = losses(0), losses(0), losses(1)
    assert fa.flash_attention_bwd.variant_launches["tc_mma_bf16"] - b0 \
        == 3 * 2 * 3
    assert a == again and a != other
    assert all(math.isfinite(x) for x in a + other)


# --- image scoring on the card ------------------------------------------------
# f32 features, card (cuDNN, TF32 off) against the port's CPU forward with
# the same weights: |Δ| ≤ 1e-4·max(1, max|ref|) + 1e-3·|ref| — the CPU
# twins' f32 rule widened tenfold, because cuDNN may sum through other
# algorithms (Winograd, FFT) than the CPU's convolutions. The prologue's
# resize, card against CPU, on the 0-255 scale: |Δ| ≤ 1e-2.

IMAGE_CASES = [("ResNet18", 64), ("ResNet50", 64), ("InceptionV3", 75),
               ("Xception", 74), ("VGG16", 64)]


@pytest.mark.parametrize("name,size", IMAGE_CASES,
                         ids=[n for n, _ in IMAGE_CASES])
def test_image_model_card_matches_cpu(dev, name, size):
    from sparkdl_tpu_torch.models import registry as R

    m = R.get_model(name)
    kw = {"input_size": (size, size)} if name.startswith("VGG") else {}
    model = m.build(seed=5, **kw)
    x = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (3, size, size, 3), dtype=np.uint8))
    ref = m.apply_fn(model, features_only=True)(x).numpy()
    got = m.apply_fn(model.to(dev), features_only=True)(x.to(dev))
    assert got.device.type == "cuda" and got.dtype == torch.float32
    atol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-3, atol=atol)


def test_batch_runner_pinned_side_stream_matches_cpu(dev):
    """The card's feed (pinned staging, a non_blocking copy on a side
    stream, the step after an event, outputs copied back through pinned
    buffers started at dispatch) gives the CPU runner's outputs, for a
    stream longer than the window, with a ragged tail; no output is
    overwritten by a later batch."""
    from sparkdl_tpu_torch.core import runtime

    rng = np.random.default_rng(7)
    batches = [rng.integers(0, 256, (8, 9, 9, 3), dtype=np.uint8)
               for _ in range(6)] + [
        rng.integers(0, 256, (5, 9, 9, 3), dtype=np.uint8)]

    def fn(b):
        return {"s": (b * 0.5).sum(dim=(1, 2)), "m": b.amax(dim=(1, 2, 3))}

    outs = {}
    for d in ("cpu", "cuda"):
        r = runtime.BatchRunner(fn, 8, device=d, input_cast=torch.float32,
                                prefetch=2)
        outs[d] = list(r.run(iter(batches)))
    assert [o["s"].shape for o in outs["cuda"]] == \
        [(8, 3)] * 6 + [(5, 3)]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert isinstance(a["s"], np.ndarray)
        np.testing.assert_array_equal(a["m"], b["m"])
        np.testing.assert_allclose(a["s"], b["s"], rtol=1e-6)


def test_runner_stages_each_batch_in_one_pinned_buffer(dev):
    """On the card a batch, full or short, is padded in one write into
    pinned memory (pad rows replicate row 0), the source of the put."""
    from sparkdl_tpu_torch.core import runtime

    r = runtime.BatchRunner(lambda b: b, 4, device="cuda")
    a = np.arange(6, dtype=np.uint8).reshape(3, 2)
    staged, n, copied = r._stage({"a": a, "b": np.ones(3, np.float32)})
    assert n == 3 and copied == 4 * 2 + 4 * 4
    assert all(t.is_pinned() for t in staged.values())
    np.testing.assert_array_equal(staged["a"].numpy(),
                                  np.concatenate([a, a[:1]]))
    full, n, copied = r._stage(np.ones((4, 2), np.float32))
    assert full.is_pinned() and n == 4 and copied == full.nbytes
    with pytest.raises(ValueError, match="exceeds"):
        r._stage(np.zeros((5, 2), np.float32))


def test_image_prologue_on_card_matches_cpu(dev):
    import sparkdl_tpu_torch as tdl

    t = tdl.XlaImageTransformer(fn=lambda b: b, inputSize=(29, 29),
                                device="cuda")
    t._set(inputCol="image", outputCol="o")
    pro = t._make_preprocess()
    rng = np.random.default_rng(8)
    for e in (40, 17, 29):  # down, up, the same size
        x = torch.from_numpy(rng.integers(0, 256, (2, e, e, 3),
                                          dtype=np.uint8)).float()
        cpu, card = pro(x), pro(x.to(dev)).cpu()
        assert card.shape == (2, 29, 29, 3)
        if e == 29:
            assert torch.equal(card, x.flip(-1))
        np.testing.assert_allclose(card.numpy(), cpu.numpy(), rtol=0,
                                   atol=1e-2)


def test_featurizer_runner_and_logistic_regression_on_card(dev):
    """The card's device step of config 1 without a DataFrame: the
    featurizer's own runner over uint8 BGR batches, then
    ``LogisticRegression._fit_arrays`` on the card, against the CPU."""
    from sparkdl_tpu_torch.estimators import LogisticRegression
    from sparkdl_tpu_torch.transformers import DeepImageFeaturizer

    rng = np.random.default_rng(9)
    y = np.arange(16) % 2
    wire = (rng.integers(0, 192, (16, 40, 40, 3), dtype=np.uint8)
            + (64 * y).astype(np.uint8)[:, None, None, None])
    feats = {}
    for d in ("cpu", "cuda"):
        f = DeepImageFeaturizer(modelName="ResNet18", batchSize=8, seed=2,
                                device=d)
        feats[d] = np.concatenate(list(f._get_runner().run([wire[:8],
                                                             wire[8:]])))
    ref = feats["cpu"]
    np.testing.assert_allclose(feats["cuda"], ref, rtol=1e-3,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))
    kw = dict(maxIter=50, stepSize=0.1)
    card = LogisticRegression(**kw)._fit_arrays(feats["cuda"], y)
    cpu = LogisticRegression(device="cpu", **kw)._fit_arrays(feats["cuda"], y)
    np.testing.assert_allclose(card.weights, cpu.weights, rtol=0,
                               atol=1e-3 * np.abs(cpu.weights).max() + 1e-4)
    assert (card.predict_arrays(feats["cuda"])[0] == y).mean() > 0.9


# --- ResNet training on the card ---------------------------------------------
# BatchNorm in train mode, card against the CPU, f32 (TF32 off): the
# output, the input's gradient and the new statistics within 1e-5·max(1,
# max|ref|) + 1e-5·|ref|, the scale and bias gradients (sums over every
# position) within 1e-4·max(1, max|ref|); bf16 compute, the output and
# the input's gradient within 2^-6·max(1, max|ref|), and the scale and
# bias gradients within 2^-7·A, A each channel's sum of the magnitudes of
# its terms (Σ|dy·x̂|, Σ|dy|): PyTorch's channels-last bf16 backward on the
# card rounds each term (measured 0.27 of a gradient of 53 at 784 terms,
# where the CPU's is within 4e-5 of an f64 sum). A mutable ResNet18 step
# (10 classes, 32², batch 8) from the same weights: the largest parameter
# error as a share of the largest change the step made ≤ 1e-3, each
# statistic's as a share of its own change ≤ 1e-4 (chip_smoke.py's
# RESNET_PARITY_*_SHARE, set from the card's readings and far below what
# the same step gives with TF32 on).


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_train_mode_card_matches_cpu(dev, dtype):
    from sparkdl_tpu_torch.models.image_layers import BatchNorm

    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal((16, 32, 7, 7)) * 2 + 0.5)
                         .astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((16, 32, 7, 7))
                         .astype(np.float32))
    cpu = BatchNorm(32, 1e-5, momentum=0.9)
    with torch.no_grad():
        cpu.weight.uniform_(0.5, 1.5, generator=torch.Generator()
                            .manual_seed(0))
        cpu.running_mean.normal_(generator=torch.Generator().manual_seed(1))
    card = BatchNorm(32, 1e-5, momentum=0.9).to("cuda")
    card.load_state_dict(cpu.state_dict())
    out = {"cpu": cpu, "cuda": card}
    res = {}
    for d, layer in out.items():
        xi = x.to(d).contiguous(memory_format=torch.channels_last)
        xi.requires_grad_()
        y, (mean, var) = layer(xi, train=True)
        assert y.dtype == dtype and mean.dtype == torch.float32
        (y.float() * g.to(d)).sum().backward()
        res[d] = [t.detach().float().cpu().numpy() for t in
                  (y, xi.grad, layer.weight.grad, layer.bias.grad, mean,
                   var)]

    def close(got, ref, atol_share, rtol):
        np.testing.assert_allclose(
            got, ref, rtol=rtol,
            atol=atol_share * max(1.0, float(np.abs(ref).max())))

    y, gx, gw, gb, mean, var = res["cuda"]
    ry, rgx, rgw, rgb, rmean, rvar = res["cpu"]
    if dtype == torch.float32:
        close(y, ry, 1e-5, 1e-5)
        close(gx, rgx, 1e-5, 1e-5)
        close(gw, rgw, 1e-4, 1e-5)
        close(gb, rgb, 1e-4, 1e-5)
    else:
        close(y, ry, 2.0 ** -6, 0)
        close(gx, rgx, 2.0 ** -6, 0)
        xf = x.float().numpy()
        xhat = (xf - rmean[:, None, None]) / np.sqrt(
            xf.var(axis=(0, 2, 3))[:, None, None] + 1e-5)
        dy = g.to(dtype).float().numpy()
        for got, ref, terms in ((gw, rgw, dy * xhat), (gb, rgb, dy)):
            a = np.abs(terms).sum(axis=(0, 2, 3))
            assert (np.abs(got - ref) <= 2.0 ** -7 * a).all(), (
                np.abs(got - ref).max(), a.min())
    close(mean, rmean, 1e-5, 1e-5)
    close(var, rvar, 1e-5, 1e-5)


def test_mutable_resnet_step_card_matches_cpu(dev):
    from sparkdl_tpu_torch.models.registry import get_model
    from sparkdl_tpu_torch.runner import (TrainState, bn_classifier_loss,
                                          make_train_step, sgd)

    rng = np.random.default_rng(5)
    batch = {"image": torch.from_numpy(rng.uniform(
                 0, 1, (8, 32, 32, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 10, 8))}
    out = {}
    before = get_model("ResNet18").build(num_classes=10, seed=3).state_dict()
    for d in ("cpu", "cuda"):
        model = get_model("ResNet18").build(num_classes=10, seed=3,
                                            device=d)
        state = TrainState.create(model, sgd(0.01, momentum=0.9))
        state, m = make_train_step(bn_classifier_loss(), mutable=True)(
            state, {k: v.to(d) for k, v in batch.items()})
        assert state.step == 1 and math.isfinite(float(m["loss"]))
        out[d] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    def share(keys):
        err = max((out["cuda"][k] - out["cpu"][k]).abs().max().item()
                  for k in keys)
        return err / max((out["cpu"][k] - before[k]).abs().max().item()
                         for k in keys)

    assert share([k for k in before if "running" not in k]) <= 1e-3
    for k in before:  # each statistic against its own change
        if "running" in k:
            assert share([k]) <= 1e-4, k


def test_fit_feed_lookahead_on_card_matches_inline(dev):
    """``feed_lookahead=2`` on the card copies each batch on a side stream
    ahead of the step: the same batches in the same order, parameters bit
    for bit those of the inline feed."""
    from sparkdl_tpu_torch.runner import (XlaRunner,
                                          softmax_cross_entropy_loss, sgd)

    rng = np.random.default_rng(6)
    w0 = rng.standard_normal((1024, 10)).astype(np.float32) * 0.03
    data = [{"image": rng.standard_normal((4096, 1024)).astype(np.float32),
             "label": rng.integers(0, 10, 4096)} for _ in range(6)]
    out = []
    for ahead in (0, 2):
        model = torch.nn.Linear(1024, 10, bias=False).to(dev)
        with torch.no_grad():
            model.weight.copy_(torch.from_numpy(w0.T))
        res = XlaRunner(np=1).run(lambda ctx: ctx.fit(
            loss_fn=softmax_cross_entropy_loss(), model=model,
            tx=sgd(0.1, momentum=0.9), data=iter(data), num_steps=6,
            log_every=1, feed_lookahead=ahead))
        assert res["state"].step == 6
        out.append((model.weight.detach().cpu(),
                    [h["loss"] for h in res["history"]]))
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]


# --- data parallelism on the card ---------------------------------------------

def test_np_beyond_the_cards_raises_on_the_card(dev):
    """``XlaRunner(np=N)`` for more processes than the machine has cards
    raises ``ValueError`` before any rendezvous (NCCL allows one rank a
    card)."""
    from sparkdl_tpu_torch.runner import XlaRunner

    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="exceeds visible devices"):
        XlaRunner(np=n, coordinator="127.0.0.1:1", num_processes=n,
                  process_id=0)
    assert not torch.distributed.is_initialized()


def test_one_rank_nccl_gang_step_matches_in_process_step(dev, tmp_path):
    """A one-rank NCCL gang (``launcher.launch(np=1)`` on
    ``tests/test_torch_gang_worker.py``, synchronised BatchNorm and the
    gradient all-reduce) against ``make_train_step`` in this process, one
    f32 mutable step of a narrow ResNet18 (width 8, 32², batch 8, TF32
    off) from one carried state: the parameters within 1e-3 of the step's
    largest change, each statistic within 1e-4 of its own change
    (``chip_smoke.py``'s ``dp_parity`` limits; the two BatchNorms take
    the variance differently, so not bitwise); the statistics with
    ``remat`` bitwise as without."""
    import os

    from sparkdl_tpu_torch.models import resnet as R
    from sparkdl_tpu_torch.runner import (TrainState, bn_classifier_loss,
                                          launcher, make_train_step, sgd)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = R.ResNet(stage_sizes=[2, 2, 2, 2], block=R.BasicBlock, width=8,
                     num_classes=10, seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(before, tmp_path / "init.pt")
    rng = np.random.default_rng(1)
    batch = {"image": rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 10, 8)}
    np.savez(tmp_path / "batch.npz", **batch)
    launcher.launch(os.path.join(root, "tests", "test_torch_gang_worker.py"),
                    np=1, args=["resnet", str(tmp_path), str(tmp_path),
                                "cuda"],
                    env={"PYTHONPATH": root + os.pathsep
                         + os.environ.get("PYTHONPATH", "")},
                    timeout_s=300.0, capture=True)
    gang = torch.load(tmp_path / "rank0.pt", weights_only=False)
    model = model.to(dev)
    make_train_step(bn_classifier_loss(), mutable=True)(
        TrainState.create(model, sgd(0.01, momentum=0.9)),
        {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    want = {k: v.cpu() for k, v in model.state_dict().items()}
    got = gang["implicit"]
    params = [k for k in want if "running" not in k]
    p = (max((got[k] - want[k]).abs().max().item() for k in params)
         / max((want[k] - before[k]).abs().max().item() for k in params))
    s = max((got[k] - want[k]).abs().max().item()
            / (want[k] - before[k]).abs().max().item()
            for k in want if "running" in k)
    assert p <= 1e-3 and s <= 1e-4, (p, s)
    assert all(torch.equal(t, gang["remat"][k]) for k, t in got.items()
               if "running" in k)
    assert gang["replicated"]


def test_supervised_nccl_gang_survives_a_sigkill(dev, tmp_path):
    """``launcher.supervise`` of a one-rank NCCL gang (the narrow
    ResNet18 of ``tests/test_torch_gang_worker.py``'s ``sup_resnet``,
    6 mutable steps, a checkpoint every 2) SIGKILLed by a chaos plan at
    step 3: one retryable restart, the relaunch resumes at the newest
    committed step (2) and ends bitwise where a clean ``launch`` of the
    same worker ends, parameters and BatchNorm statistics."""
    import os

    from sparkdl_tpu_torch.runner import Fault, FaultPlan, launcher

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "test_torch_gang_worker.py")
    got_dir, clean_dir = tmp_path / "sup", tmp_path / "clean"
    got_dir.mkdir()
    clean_dir.mkdir()
    res = launcher.supervise(
        worker, np=1, args=["sup_resnet", str(got_dir), str(got_dir),
                            "cuda"],
        plan=FaultPlan([Fault("step_start", "sigkill", at_step=3)]),
        max_restarts=1, backoff_s=0.1, poll_s=0.25, timeout_s=300.0)
    assert res.restarts == 1 and res.failure_kinds == ["retryable"]
    launcher.launch(worker, np=1, args=["sup_resnet", str(clean_dir),
                                        str(clean_dir), "cuda"],
                    timeout_s=300.0, capture=True)
    got = torch.load(got_dir / "rank0.pt", weights_only=False)
    clean = torch.load(clean_dir / "rank0.pt", weights_only=False)
    assert got["step"] == clean["step"] == 6
    assert got["resumed_at"] == [2] and clean["resumed_at"] == []
    assert got["losses"] == clean["losses"][2:]
    assert all(torch.equal(v, clean["state"][k])
               for k, v in got["state"].items())


@pytest.mark.parametrize("shape", [(8, 16, 128), (32, 12, 128, 128),
                                   (32, 768)])
def test_row_window_draws_rows_of_the_global_draw(dev, shape):
    """A gang's dropout draw on the card (``utils.rng.RowWindow``, at the
    shapes of BERT's dropout sites): rank r's window is rows ``[r·n,
    (r + 1)·n)`` of the global draw from the same generator, bitwise, and
    a window over every row is ``torch.rand`` itself (a one-rank gang
    draws what one process draws)."""
    from sparkdl_tpu_torch.runner.train_state import step_generator
    from sparkdl_tpu_torch.utils.rng import RowWindow, uniform

    n, world = shape[0], 4
    want = torch.rand((world * n, *shape[1:]),
                      generator=step_generator(3, 7, dev), device=dev)
    for r in range(world):
        got = uniform(shape, RowWindow(step_generator(3, 7, dev), r * n,
                                       world * n), dev)
        assert torch.equal(got, want[r * n:(r + 1) * n]), r
    one = uniform(shape, RowWindow(step_generator(3, 7, dev), 0, n), dev)
    assert torch.equal(one, torch.rand(shape, device=dev,
                                       generator=step_generator(3, 7, dev)))


def test_int8_weight_engine_on_card_matches_cpu_int8_engine(dev):
    """A depth-2 int8-weight paged engine on the card (f32, TF32 off,
    head_dim 64) against the same engine on the CPU from the same f32
    weights: the codes and scales equal bitwise, the paged kernel
    launched once a layer a step, and the greedy streams equal wherever
    the CPU int8 model's dense top-2 gap exceeds 2e-2 (10 × the 2e-3
    logit limit of the serving parity); a flip below that is a near tie."""
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.serving import GenerationEngine

    cfg = L.LlamaConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=2, intermediate_size=512,
                        rope_theta=10000.0)
    cpu = L.LlamaModel(cfg, attn_fn=fa.flash_attention, device="cpu")
    card = L.LlamaModel(cfg, attn_fn=fa.flash_attention, device=dev)
    card.load_state_dict(cpu.state_dict())
    prompts = [[5, 6, 7], [9, 3, 2, 8, 1, 4, 4, 7] * 5, [11] * 70]
    kw = dict(num_slots=2, max_len=160, block_size=16, prefill_chunk=32,
              weight_dtype="int8")
    streams = {}
    for name, model in (("cpu", cpu), ("card", card)):
        p0 = pfd.paged_flash_decode.launches
        eng = GenerationEngine.from_model(model, device=model.device, **kw)
        hs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_idle()
        streams[name] = [h.result(1) for h in hs]
        if name == "card":
            assert pfd.paged_flash_decode.launches - p0 == \
                cfg.num_layers * eng.stats["steps"] > 0
    for (n, a), b in zip(cpu.state_dict().items(),
                         card.state_dict().values()):
        assert torch.equal(a, b.cpu()), n
    assert cpu.layers[1].mlp.down_proj.base.weight.dtype == torch.int8
    cpu.attn_fn = None
    with torch.no_grad():
        for p, got, want in zip(prompts, streams["card"], streams["cpu"]):
            logits = cpu(torch.tensor([p + want]))[0, len(p) - 1:-1]
            top2 = logits.topk(2, dim=-1).values
            gaps = (top2[:, 0] - top2[:, 1]).tolist()
            flip = next((j for j in range(len(want)) if got[j] != want[j]),
                        None)
            assert flip is None or gaps[flip] <= 2e-2, (flip, gaps)


@pytest.mark.parametrize("drive", ["inline_kill", "threaded"])
def test_fleet_on_card_matches_cpu_fleet(dev, drive):
    """A two-replica fleet (paged, blocking refill, depth 2, f32, TF32
    off, head_dim 64) on the card against the same fleet on the CPU from
    the same weights, driven inline with one replica killed uncleanly
    mid-stream (chaos ``replica_dead`` at ``fleet_route``), or threaded
    (``fleet.start()``: both replicas capture and replay their graphs on
    their own threads). The streams equal the CPU fleet's token for
    token, every token streamed exactly once, and the card's kernels
    launched once a layer a decode step and a prefill."""
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.runner import chaos
    from sparkdl_tpu_torch.serving import EngineFleet, GenerationEngine

    cfg = L.LlamaConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=2, intermediate_size=512,
                        rope_theta=10000.0)
    cpu = L.LlamaModel(cfg, attn_fn=fa.flash_attention, device="cpu")
    card = L.LlamaModel(cfg, attn_fn=fa.flash_attention, device=dev)
    card.load_state_dict(cpu.state_dict())
    head = [7, 3, 9, 1] * 8
    prompts = [head + [i + 10] * (i + 2) for i in range(4)] + [
        [5, 6, 7] * 7, head + [99]]
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        streamed = {}

        def cb(fr, tok):
            streamed.setdefault(fr.id, []).append(tok)

        engines = [GenerationEngine.from_model(
            model, device=model.device, num_slots=2, max_len=160,
            block_size=16, prefill_chunk=32, stall_free=False)
            for _ in range(2)]
        fleet = EngineFleet(engines, min_replicas=1)
        f0 = fa.flash_attention_fwd.launches
        p0 = pfd.paged_flash_decode.launches
        if name == "card" and drive == "threaded":
            fleet.start()
            try:
                frs = [fleet.submit(p, 12, stream_cb=cb) for p in prompts]
                assert all(fr.wait(120) for fr in frs)
            finally:
                fleet.stop(drain=True, timeout=60)
        else:
            chaos.install(chaos.FaultPlan([chaos.Fault(
                site="fleet_route", kind="replica_dead",
                at_step=len(prompts))]))
            try:
                frs = [fleet.submit(p, 12, stream_cb=cb)
                       for p in prompts[:-1]]
                for _ in range(4):
                    fleet.step()
                frs.append(fleet.submit(prompts[-1], 12, stream_cb=cb))
                fleet.run_until_idle()
            finally:
                chaos.uninstall()
            assert fleet.stats["replica_deaths"] == 1
            assert fleet.stats["readmissions"] >= 1
        for fr in frs:
            assert streamed[fr.id] == fr.tokens and fr.delivered == 12
        out[name] = [fr.result(1) for fr in frs]
        if name == "card":
            steps = sum(e.stats["steps"] for e in engines)
            prefills = sum(e.stats["prefills"] for e in engines)
            assert pfd.paged_flash_decode.launches - p0 == \
                cfg.num_layers * steps > 0
            assert fa.flash_attention_fwd.launches - f0 == \
                cfg.num_layers * prefills > 0
            assert sum(e.stats["failovers"] for e in engines) == 0
            assert all(e.backend.graphs.snapshot()["captures"] == 1
                       for e in engines)
    assert out["card"] == out["cpu"]


@pytest.mark.parametrize("lookahead", [0, 2])
def test_fit_on_card_postmortem_names_the_nan_batch(dev, tmp_path,
                                                    monkeypatch, lookahead):
    """A ``fit`` on the card with the flight recorder streaming, the
    heartbeat and the ledger on, and a ``batch_fetch nan`` plan at step
    2: the batch reaches the step NaN on the card (inline and through the
    pinned side-stream feed), the divergence guard raises
    ``TrainingDivergedError`` (fatal: ``run_with_restarts`` does not
    retry), and the postmortem names step 2 and batch 2."""
    import json

    from sparkdl_tpu_torch.runner import (Fault, FaultPlan,
                                          TrainingDivergedError, XlaRunner,
                                          chaos, events, sgd,
                                          softmax_cross_entropy_loss)

    for k, sub in (("SPARKDL_EVENT_DIR", "ev"), ("SPARKDL_HEARTBEAT_DIR",
                                                  "hb"),
                   ("SPARKDL_BATCH_LEDGER", "led")):
        monkeypatch.setenv(k, str(tmp_path / sub))
    monkeypatch.setenv("SPARKDL_PROCESS_ID", "0")
    events.reset()
    rng = np.random.default_rng(3)
    data = [{"image": rng.standard_normal((64, 32)).astype(np.float32),
             "label": rng.integers(0, 10, 64)} for _ in range(6)]
    seen = []
    loss = softmax_cross_entropy_loss()

    def spy(model, batch):
        seen.append(batch["image"])
        return loss(model, batch)

    attempts = []

    def main(ctx):
        attempts.append(1)
        model = torch.nn.Linear(32, 10).to(ctx.device)
        return ctx.fit(loss_fn=spy, model=model, tx=sgd(0.1), data=data,
                       num_steps=6, log_every=1, feed_lookahead=lookahead)

    chaos.install(FaultPlan([Fault("batch_fetch", "nan", at_step=2)]))
    try:
        with pytest.raises(TrainingDivergedError) as ei:
            XlaRunner(np=1).run_with_restarts(main, max_restarts=2,
                                              backoff_s=0.0)
    finally:
        chaos.uninstall()
        events.get_recorder().close()
    assert ei.value.step == 3 and attempts == [1]
    assert len(seen) == 3
    assert all(t.device.type == "cuda" for t in seen)
    assert torch.isnan(seen[2]).all().item()
    assert not torch.isnan(seen[1]).any().item()
    pm = json.loads((tmp_path / "ev" / "postmortem_rank0.json").read_text())
    assert (pm["site"], pm["step"], pm["batch_index"], pm["epoch"]) == \
        ("fit", 2, 2, 0)
    assert pm["error"]["type"] == "TrainingDivergedError"
    hb = json.loads((tmp_path / "hb" / "rank0.hb").read_text())
    assert hb["step"] == 2
    text = (tmp_path / "led" / "ledger_rank0.jsonl").read_text()
    led = [json.loads(ln) for ln in text.splitlines()]
    assert [(e["step"], e["batch_index"]) for e in led] == \
        [(0, 0), (1, 1), (2, 2)]
    tl = events.merge_timeline(str(tmp_path / "ev"),
                               heartbeat_dir=str(tmp_path / "hb"))
    assert tl["first_failure"]["site"] == "batch_fetch"
    assert tl["first_failure"]["step"] == 2


def test_hf_round_trip_on_card(dev, tmp_path):
    """Phase r's round trip at a small size: a seeded Llama and BERT on
    the card written as HF safetensors files (``chip_smoke.py``'s
    writers), read back by ``models.pretrained`` into fresh models on the
    card: every parameter equal, greedy tokens identical through the
    flash kernels, logits bitwise."""
    import importlib.util
    import os

    from safetensors.torch import save_file

    from sparkdl_tpu_torch.models import bert as B
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.models.pretrained import (import_hf_bert,
                                                     import_hf_llama)

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    cfg = L.LlamaConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=2, intermediate_size=512,
                        rope_theta=10000.0)

    def llama(seed):
        return L.LlamaModel(cfg, attn_fn=fa.flash_attention, device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(seed))

    orig = llama(0)
    f = str(tmp_path / "llama.safetensors")
    save_file(cs.hf_llama_state(torch, orig, torch.float32), f)
    new = L.load_flax_params(llama(1), import_hf_llama(f, cfg))
    for (name, a), (_, b) in zip(orig.named_parameters(),
                                 new.named_parameters()):
        assert torch.equal(a, b), name
    ids, pads = L.left_pad_prompts([[5, 6, 7], [9, 3, 2, 8, 1, 4, 4, 7],
                                    [11] * 70])
    fa0 = fa.flash_attention_fwd.launches
    want = L.generate(orig, ids, 6, pad_lens=pads)
    got = L.generate(new, ids, 6, pad_lens=pads)
    assert fa.flash_attention_fwd.launches - fa0 == 2 * cfg.num_layers
    assert torch.equal(got, want)
    x = torch.randint(0, cfg.vocab_size, (2, 33), device=dev)
    with torch.no_grad():
        assert torch.equal(new(x), orig(x))

    bcfg = B.BertConfig(vocab_size=1000, hidden_size=256, num_layers=2,
                        num_heads=4, intermediate_size=512)

    def bert(seed):
        return B.BertForSequenceClassification(
            bcfg, num_classes=2, device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed))

    bo = bert(0)
    fb = str(tmp_path / "bert.safetensors")
    save_file(cs.hf_bert_state(torch, bo), fb)
    bn = B.load_flax_params(bert(1), import_hf_bert(fb, bcfg, num_classes=2))
    ids = torch.randint(1, bcfg.vocab_size, (4, 128), device=dev)
    mask = torch.ones_like(ids)
    mask[0, 40:] = 0
    fa0 = fa.flash_attention_fwd.launches
    with torch.no_grad():
        assert torch.equal(bn(ids, mask), bo(ids, mask))
    assert fa.flash_attention_fwd.launches - fa0 == 2 * bcfg.num_layers


def test_graph_toolkit_on_card_matches_cpu(dev, tmp_path):
    """Phase s's graph at a small size: a converter → conv module →
    flattener GraphFunction on the card, its captured step (``jit``), its
    ``.pt2`` round trip (exported on the card with a free batch, loaded
    on the card, run at batches 5 and 2) and the UDF ``makeGraphUDF``
    registers (its device step, ``udfStage``), each against the same
    graph on the CPU, to the f32 rule (1e-5 of max|ref| + 1e-5·|ref|:
    one conv in cuDNN's and in the CPU's order). A graph that launches
    one of the kernels refuses to serialize."""
    from sparkdl_tpu_torch.graph import (GraphFunction, buildFlattener,
                                         buildSpImageConverter, makeGraphUDF)
    from sparkdl_tpu_torch.udf import udfStage, unregisterUDF

    def graph(device):
        torch.manual_seed(0)
        conv = torch.nn.Sequential(
            torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.ReLU(),
            torch.nn.AdaptiveAvgPool2d(2)).to(device)

        class Nhwc(torch.nn.Module):
            def forward(self, x):
                return conv(x.permute(0, 3, 1, 2))

        return GraphFunction.fromList([
            buildSpImageConverter("BGR", scale=1 / 255.0, device=device),
            GraphFunction.fromModule(Nhwc(), device=device),
            buildFlattener(device=device)])

    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (5, 16, 16, 3), dtype=np.uint8)
    gpu, cpu = graph(dev), graph("cpu")
    want = cpu(image=x)["flattened"].numpy()

    def check(got, ref=want):
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))

    live = gpu(image=x)["flattened"]
    assert live.device.type == "cuda"
    check(live)
    jitted = gpu.jit()
    for _ in range(2):  # capture, then replay
        check(jitted(image=x)["flattened"])
    path = str(tmp_path / "g.pt2")
    gpu.dump(path, {"image": ((None, 16, 16, 3), "uint8")})
    loaded = GraphFunction.load(path, device=dev)
    check(loaded(image=x)["flattened"])
    check(loaded(image=x[:2])["flattened"], want[:2])
    from_cpu = GraphFunction.load(path, device="cpu")
    check(from_cpu(image=x)["flattened"])
    makeGraphUDF(gpu, "card_graph_udf", batchSize=4)
    try:
        runner = udfStage("card_graph_udf", "image", "f")._get_runner()
        assert runner.device.type == "cuda"
        check(np.concatenate(list(runner.run(
            [x[:4].astype(np.float32), x[4:].astype(np.float32)]))))
    finally:
        unregisterUDF("card_graph_udf")

    q = torch.randn(1, 2, 128, 64, device=dev)
    attn = GraphFunction.fromTorch(
        lambda q: fa.flash_attention(q, q, q, causal=True), ["q"], ["o"],
        device=dev)
    assert attn(q=q)["o"].shape == q.shape
    with pytest.raises(ValueError, match="flash_attention's CUDA kernel"):
        attn.serialize({"q": ((None, 2, 128, 64), "float32")})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ulysses_flash_on_a_one_rank_nccl_mesh_is_the_bare_kernel(dev,
                                                                  dtype):
    """``ulysses_attention(local_attn="auto")`` on ``make_mesh({"sp":
    1})`` over a one-rank NCCL gang: the all-to-alls are copies, so the
    output and the gradient through the backward kernel are bitwise the
    bare ``fa.flash_attention`` call's; one forward and one backward
    launch. Ring attention on the same mesh runs no kernel and equals
    dense attention within the f32 rule."""
    from sparkdl_tpu_torch.core.runtime import make_mesh
    from sparkdl_tpu_torch.parallel import (dense_attention, ring_attention,
                                            ulysses_attention)
    from sparkdl_tpu_torch.runner import XlaRunner, launcher
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    rng = np.random.default_rng(20)
    q, k, v, do = (_randn(rng, (2, 4, 320, 128), dtype, dev)
                   for _ in range(4))

    def fwd_bwd(fn):
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = fn(*leaves)
        return (o.detach(), *torch.autograd.grad(o, leaves, do))

    runner = XlaRunner(device="cuda", num_processes=1, process_id=0,
                       coordinator=f"127.0.0.1:{launcher.free_port()}")
    try:
        assert runner.gang.backend == "nccl"
        mesh = make_mesh({"sp": 1})
        assert mesh.device_type == "cuda"
        fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
        got = fwd_bwd(lambda a, b, c: ulysses_attention(
            a, b, c, mesh, causal=True, local_attn="auto"))
        assert (fa.flash_attention_fwd.launches,
                fa.flash_attention_bwd.launches) == (1, 1)
        want = fwd_bwd(lambda a, b, c: fa.flash_attention(a, b, c,
                                                          causal=True))
        for a, w in zip(got, want):
            assert torch.equal(a, w)
        if dtype == torch.float32:
            ring = ring_attention(q, k, v, mesh, causal=True)
            ref = dense_attention(q, k, v, causal=True)
            assert fa.flash_attention_fwd.launches == 2
            assert torch.allclose(ring, ref, rtol=1e-5, atol=1e-5)
    finally:
        leave_gang()


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_head_shards_are_the_full_launch_heads(dev, tp):
    """What rank r of a tp gang launches: each decode kernel on the head
    shard ``parallel.local_heads`` takes (the helper
    ``head_sharded_kernel`` uses) is bitwise the full launch's heads —
    the split plan depends on positions and S·rep only, and GQA's ratio
    holds per shard — and runs the blocks ``fd.split_blocks`` gives at
    Hkv/tp. One shape: llama3_8b's 32:8 heads, D 128, bf16; the paged
    pool int8 with its scale plane, S 5."""
    from sparkdl_tpu_torch.parallel import local_heads

    rng = np.random.default_rng(21)
    curs, pads = [500, 301, 77, 16, 15, 1, 0, 200], [0, 3, 40, 0, 15, 0,
                                                      0, 190]
    q, kp, vp, sc, tables, cur, pad = _paged_case(
        rng, dev, dtype=torch.bfloat16, kv="int8", b=8, hkv=8, rep=4,
        s_q=5, d=128, bs=16, mb=33, curs=curs, pads=pads)
    full = pfd.paged_flash_decode(q, kp, vp, tables, cur, pad, sc)
    length = 33 * 16
    qd = _randn(rng, (4, 32, 1, 128), torch.bfloat16, dev)
    kd = _randn(rng, (4, 8, length, 128), torch.bfloat16, dev)
    vd = _randn(rng, (4, 8, length, 128), torch.bfloat16, dev)
    dcur = torch.tensor([length, 300, 17, 1], dtype=torch.int32, device=dev)
    dpad = torch.tensor([0, 40, 0, 0], dtype=torch.int32, device=dev)
    dfull = fd.flash_decode(qd, kd, vd, dcur, dpad)
    cnt = torch.zeros(2, dtype=torch.int32, device=dev)
    for r in range(tp):
        sh = [local_heads(x, r, tp) for x in (q, kp, vp, sc)]
        cnt.zero_()
        got = pfd.paged_flash_decode(*sh[:3], tables, cur, pad, sh[3],
                                     block_counter=cnt)
        assert torch.equal(got, local_heads(full, r, tp)), r
        plan = fd.split_blocks(length, 5 * 4, 8 // tp,
                               [(p, min(c + 5, length))
                                for c, p in zip(curs, pads)])
        assert cnt.tolist() == [plan["grid_blocks"], plan["live_blocks"]]
        want = pfd.paged_flash_decode_plain(*sh[:3], tables, cur, pad,
                                            sh[3])
        atol, rtol = _tol(torch.bfloat16, "int8")
        np.testing.assert_allclose(got.float().cpu(), want.float().cpu(),
                                   atol=atol, rtol=rtol)
        sh = [local_heads(x, r, tp) for x in (qd, kd, vd)]
        got = fd.flash_decode(*sh, dcur, dpad)
        assert torch.equal(got, local_heads(dfull, r, tp)), r


def test_step_graph_capture_survives_a_collection(dev):
    """A collection while a step is being captured must not reset another
    step's graph (a dropped engine's, unreachable until collected): the
    capturing thread may not call that reset, and the capture would be
    lost. Here the dropped step becomes garbage inside the new step's
    capture, which then allocates enough to set off full collections:
    one at nearly every allocation, with the live objects of the process
    frozen out of the collector's count, so that a full collection is not
    put off for them. The new step still captures and replays, and the
    dropped one is collected after."""
    import gc
    import weakref

    from sparkdl_tpu_torch.core.runtime import StepGraph

    x = torch.ones(4, device=dev)
    thresholds = gc.get_threshold()
    gc.collect()
    gc.freeze()
    gc.collect()
    try:
        old = StepGraph(lambda t: t * 2, (x,))
        old((x,))
        old((x,))
        assert old.graph is not None
        old.cycle = old  # freed only by a collection
        gone = weakref.ref(old)
        box = [old]
        del old

        def step(t):
            if torch.cuda.is_current_stream_capturing():
                box.clear()  # the dropped step is garbage from here on
                junk = [[] for _ in range(256)]
                del junk
            return t + 1

        gc.set_threshold(1, 1, 1)
        new = StepGraph(step, (x,))
        first = new((x,)).clone()
        out = new((x,)).clone()
    finally:
        gc.set_threshold(*thresholds)
        gc.unfreeze()
    assert not box and new.graph is not None
    assert torch.equal(first, x + 1) and torch.equal(out, x + 1)
    gc.collect()
    assert gone() is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fsdp_tp_step_on_a_one_rank_nccl_mesh_is_the_unsharded_step(dev,
                                                                    dtype):
    """One FSDP×TP step (``shard_model`` on ``{"data": 1, "model": 1}``,
    ``make_train_step(mesh=, param_rules=)``) of a 2-layer head-dim-64
    Llama through the flash kernels, against the unsharded step from the
    same seeded weights: the loss and every gathered parameter bitwise
    (at one rank the collectives are copies); two forward and two
    backward launches an arm."""
    from sparkdl_tpu_torch.core.runtime import make_mesh
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.parallel import fsdp
    from sparkdl_tpu_torch.runner import XlaRunner, launcher
    from sparkdl_tpu_torch.runner.train_state import (TrainState,
                                                      make_train_step, sgd)
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    cfg = L.LlamaConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=2, intermediate_size=512,
                        rope_theta=10000.0)
    ids = torch.as_tensor(np.random.default_rng(21).integers(
        0, 512, (4, 128)), device=dev)

    def model():
        return L.LlamaModel(cfg, dtype=dtype, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(0))

    def one_step(m, step):
        st = TrainState.create(m, sgd(1e-2))
        fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
        _, metrics = step(st, {"input_ids": ids})
        assert (fa.flash_attention_fwd.launches,
                fa.flash_attention_bwd.launches) == (2, 2)
        return metrics["loss"]

    base = model()
    want_loss = one_step(base, make_train_step(L.causal_lm_loss_fn()))
    runner = XlaRunner(device="cuda", num_processes=1, process_id=0,
                       coordinator=f"127.0.0.1:{launcher.free_port()}")
    try:
        assert runner.gang.backend == "nccl"
        mesh = make_mesh({"data": 1, "model": 1})
        sharded = L.shard_model(model(), mesh)
        got_loss = one_step(sharded, make_train_step(
            L.causal_lm_loss_fn(), mesh=mesh,
            param_rules=L.training_rules(mesh)))
        got = fsdp.full_state_dict(sharded)
    finally:
        leave_gang()
    assert torch.equal(got_loss, want_loss)
    want = base.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_switch_moe_on_the_card_matches_its_cpu_run(dev):
    """``SwitchMoE`` forward and backward (the aux loss in the loss) on the
    card against the same module on the CPU, f32 with TF32 off: output,
    input and parameter gradients within rtol 1e-5, atol 1e-5 (the two
    sum in other orders); the expert-parallel module on a one-rank NCCL
    ``{"ep": 1}`` mesh bitwise the card's unsharded run."""
    from sparkdl_tpu_torch.core.runtime import make_mesh
    from sparkdl_tpu_torch.parallel import moe as M
    from sparkdl_tpu_torch.runner import XlaRunner, launcher
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    x = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (2, 64, 32)).astype(np.float32))

    def run(m, device):
        xi = x.clone().to(device).requires_grad_(True)
        inter = {}
        y = m(xi, intermediates=inter)
        ((y ** 2).sum() + M.moe_aux_loss(inter)).backward()
        return [y.detach().cpu(), xi.grad.cpu(),
                *(p.grad.cpu() for _, p in m.named_parameters())]

    cpu = M.SwitchMoE(32, 4, 64, device="cpu")
    card = M.SwitchMoE(32, 4, 64, device=dev)
    card.load_state_dict(cpu.state_dict())
    want, got = run(cpu, "cpu"), run(card, dev)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    runner = XlaRunner(device="cuda", num_processes=1, process_id=0,
                       coordinator=f"127.0.0.1:{launcher.free_port()}")
    try:
        assert runner.gang.backend == "nccl"
        ep = run(M.shard_moe(card, make_mesh({"ep": 1})), dev)
    finally:
        leave_gang()
    card.zero_grad(set_to_none=True)
    for a, w in zip(ep, run(card, dev)):
        assert torch.equal(a, w)


def test_fleet_of_remote_one_rank_groups_matches_the_one_process_fleet(
        dev, tmp_path):
    """Two one-rank groups, each ``launcher.launch(np=1)`` of
    ``tests/torch_tp_worker.py card_fleet`` (its own NCCL gang on this
    card, a ``from_model(mesh=tp_mesh(1))`` paged engine started behind a
    ``FrontServer``), under an ``EngineFleet`` of ``RemoteEngine``
    proxies in this process, against a fleet of two engines in this
    process: the same f32 seeded model (TF32 off), the same prompts,
    every stream equal, each delivered exactly once."""
    import json
    import os
    import threading
    import time

    from sparkdl_tpu_torch import GenerationEngine
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.runner import launcher
    from sparkdl_tpu_torch.serving import EngineFleet
    from sparkdl_tpu_torch.serving.remote import RemoteEngine

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=512, rope_theta=10000.0)
    engine = dict(num_slots=2, max_len=128, prefill_chunk=16, block_size=16)
    authkey = os.urandom(16)
    rng = np.random.default_rng(47)
    prompts = [rng.integers(1, 512, n).tolist() for n in (7, 19, 33, 12)]
    dirs = [tmp_path / g for g in ("a", "b")]
    boxes = [{}, {}]

    def group(d, box):
        try:
            launcher.launch(
                os.path.join(root, "tests", "torch_tp_worker.py"), np=1,
                args=["card_fleet", str(d), str(d)],
                env={"PYTHONPATH": root + os.pathsep
                     + os.path.join(root, "tests")},
                timeout_s=300.0, capture=True)
        except BaseException as e:  # noqa: BLE001 — raised below
            box["error"] = e

    threads = []
    for d, box in zip(dirs, boxes):
        d.mkdir()
        torch.save({"fleet": dict(cfg=cfg, seed=5, engine=engine,
                                  rounds=["clean"],
                                  authkey=authkey.hex())}, d / "cases.pt")
        threads.append(threading.Thread(target=group, args=(d, box),
                                        daemon=True))
        threads[-1].start()

    def serve(engines):
        fleet = EngineFleet(engines, names=["a", "b"], routing="round_robin")
        fleet.start()
        got: dict = {}
        frs = [fleet.submit(p, 12, stream_cb=lambda fr, t: got.setdefault(
            fr.id, []).append(t)) for p in prompts]
        assert all(fr.wait(300) for fr in frs)
        fleet.stop(timeout=60)
        assert all(got[fr.id] == fr.tokens for fr in frs)
        return [fr.result(1) for fr in frs], [fr.replica for fr in frs]

    try:
        addrs = []
        for d, box in zip(dirs, boxes):
            f = d / "clean_0.addr"
            t_end = time.time() + 300
            while not f.exists() and not box and time.time() < t_end:
                time.sleep(0.05)
            assert f.exists(), box
            addrs.append(tuple(json.loads(f.read_text())))
        remote, placed = serve([RemoteEngine(a, authkey, timeout_s=60)
                                for a in addrs])
    finally:
        for t in threads:
            t.join(300)
    assert not any(t.is_alive() for t in threads)
    assert not any(boxes), boxes
    torch.backends.cuda.matmul.allow_tf32 = False
    model = L.LlamaModel(L.LlamaConfig(**cfg), device="cuda",
                         attn_fn=fa.flash_attention,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(5))
    local, _ = serve([GenerationEngine.from_model(model, device="cuda",
                                                  **engine)
                      for _ in range(2)])
    assert placed == ["a", "b", "a", "b"]
    assert remote == local
