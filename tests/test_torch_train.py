"""The port's training path (``sparkdl_tpu_torch.runner``: ``XlaRunner``,
``RunnerContext.fit``, ``train_state``, ``metrics``, ``data``; and the
LoRA utilities of ``models.llama``) against the JAX package's, on the CPU.

Twins of ``tests/test_transformer_models.py``'s LoRA tests, and one
whole-slice parity run: ``LlamaConfig.tiny(lora_rank=4)`` in f32, the
JAX model with its Pallas flash attention in interpret mode under
``XlaRunner(np=1).run(ctx.fit(causal_lm_loss_fn(), lora_optimizer(5e-3)))``
and the port's model with the same weights (``load_flax_params``) and
``attn_fn=fa.flash_attention`` (the plain forward and backward on CPU
tensors) under the port's runner, on the same numpy batch.

Tolerances: the loss of each step within 1e-5 relative (f32, two layers,
the same arithmetic in other orders); the adapters after steps 1 and 4
within 1e-5 + 1e-4·|ref| (Adam divides by sqrt(v) + 1e-8, which
magnifies the last bits of a small gradient); base weights bit-identical
to their start in both packages.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash
from sparkdl_tpu.runner import XlaRunner as JaxRunner
from sparkdl_tpu_torch.models import llama as L
from sparkdl_tpu_torch.ops import flash_attention as fa
from sparkdl_tpu_torch.runner import TrainState, XlaRunner, data as D
from sparkdl_tpu_torch.runner import metrics as M
from sparkdl_tpu_torch.runner import events
from sparkdl_tpu_torch.runner.train_state import make_train_step
from sparkdl_tpu_torch.runner.xla_runner import TrainingDivergedError

LR = 5e-3


def _np_tree(tree):
    return {k: _np_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _ids(seed=3, shape=(4, 16)):
    return np.random.RandomState(seed).randint(0, 512, size=shape)


def _model(lora_rank=4, attn_fn=fa.flash_attention, seed=0):
    return L.LlamaModel(L.LlamaConfig.tiny(lora_rank=lora_rank),
                        attn_fn=attn_fn, device="cpu",
                        generator=torch.Generator().manual_seed(seed))


def _fit(model, ids, steps, **kw):
    return XlaRunner(np=1, device="cpu").run(lambda ctx: ctx.fit(
        loss_fn=L.causal_lm_loss_fn(), model=model, tx=L.lora_optimizer(LR),
        data=[{"input_ids": ids}] * steps, num_steps=steps, log_every=1,
        **kw))


# --- twins of tests/test_transformer_models.py ------------------------------

def test_lora_mask_and_freeze():
    model = _model()
    mask = L.lora_mask(model)
    # 2 layers × (q_proj + v_proj) × (A + B) = 8 adapter leaves
    assert sum(mask.values()) == 8
    assert all(("lora_a" in n or "lora_b" in n) == m for n, m in mask.items())

    # one optimizer step: base weights must be bit-identical after
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState.create(model, L.lora_optimizer(1e-2))
    for p in state.trainable():
        p.grad = torch.ones_like(p)
    state.apply_gradients()
    assert state.step == 1
    for name, p in model.named_parameters():
        assert p.requires_grad == mask[name]
        if mask[name]:
            assert not torch.allclose(p, before[name])
        else:
            assert torch.equal(p, before[name])


def test_lora_zero_init_is_identity():
    """rank>0 with zero-init B equals the rank=0 model with the same base
    weights, exactly."""
    ids = torch.from_numpy(_ids(shape=(1, 8)))
    m1 = _model(lora_rank=4, attn_fn=None)
    m0 = _model(lora_rank=0, attn_fn=None)
    base = {n: p for n, p in m1.state_dict().items() if "lora" not in n}
    m0.load_state_dict(base)
    with torch.no_grad():
        assert torch.equal(m1(ids), m0(ids))


def test_causal_lm_loss_trains():
    res = XlaRunner(np=1, device="cpu").run(lambda ctx: ctx.fit(
        loss_fn=L.causal_lm_loss_fn(), model=_model(),
        tx=L.lora_optimizer(LR), data=[{"input_ids": _ids(shape=(16, 16))}]
        * 8, num_steps=8, log_every=2))
    losses = [h["loss"] for h in res["history"]]
    assert [h["step"] for h in res["history"]] == [2, 4, 6, 8]
    assert losses[-1] < losses[0]
    assert all(math.isclose(h["perplexity"], math.exp(h["loss"]),
                            rel_tol=1e-5) for h in res["history"])


# --- whole-slice parity against the JAX package ------------------------------

@pytest.fixture(scope="module")
def parity():
    """The JAX fit and the port's fit over 1 and 4 steps, from the same
    seeded JAX weights and batch."""
    jcfg = JL.LlamaConfig.tiny(lora_rank=4)
    jmodel = JL.LlamaModel(jcfg, attn_fn=jax_flash)
    ids = _ids()
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(0),
                                     jnp.asarray(ids)))
    out = {"ids": ids, "start": variables}
    for steps in (1, 4):
        res = JaxRunner(np=1).run(lambda ctx: ctx.fit(
            loss_fn=JL.causal_lm_loss_fn(), params=variables,
            tx=JL.lora_optimizer(LR), apply_fn=jmodel.apply,
            data=[{"input_ids": ids}] * steps, num_steps=steps,
            log_every=1))
        model = L.load_flax_params(_model(), variables)
        port = _fit(model, ids, steps)
        out[steps] = dict(
            jax_losses=[h["loss"] for h in res["history"]],
            jax_params=_np_tree(res["state"].params),
            port_losses=[h["loss"] for h in port["history"]],
            port_params=L.flax_params(model))
    return out


def test_fit_losses_match_jax(parity):
    got, want = parity[4]["port_losses"], parity[4]["jax_losses"]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] < got[0]


@pytest.mark.parametrize("steps", [1, 4])
def test_fit_adapters_match_jax_and_base_stays(parity, steps):
    start = dict(_flat(parity["start"]["params"]))
    want = dict(_flat(parity[steps]["jax_params"]["params"]))
    got = dict(_flat(parity[steps]["port_params"]))
    assert sorted(got) == sorted(want) == sorted(start)
    n_lora = 0
    for path, w in want.items():
        if "lora_a" in path or "lora_b" in path:
            n_lora += 1
            np.testing.assert_allclose(got[path], w, atol=1e-5, rtol=1e-4,
                                       err_msg="/".join(path))
        else:  # frozen: bit-identical to the start, in both packages
            np.testing.assert_array_equal(w, start[path])
            np.testing.assert_array_equal(got[path], start[path])
    assert n_lora == 8
    moved = [p for p in want if "lora_b" in p
             and not np.array_equal(want[p], start[p])]
    assert len(moved) == 4  # B moves at step 1 (A's gradient is 0 there)


# --- step options ------------------------------------------------------------

def _one_step(model, ids, **kw):
    state = TrainState.create(model, L.lora_optimizer(LR))
    state, m = make_train_step(L.causal_lm_loss_fn(), **kw)(
        state, {"input_ids": torch.from_numpy(ids)})
    return state, m


def test_accum_steps_matches_the_full_batch():
    """``accum_steps=2``: two microbatches, gradients summed in f32 and
    halved, one optimizer step: the full batch's gradients within 1e-6
    relative (f32; a mean of two half-batch means against one mean)."""
    ids = _ids(shape=(4, 16))
    base = _model()
    with torch.no_grad():  # B carries signal, so A has a gradient too
        for n, p in base.named_parameters():
            if "lora_b" in n:
                p.normal_(0.0, 0.05, generator=torch.Generator()
                          .manual_seed(len(n)))
    s1, m1 = _one_step(copy.deepcopy(base), ids)
    s2, m2 = _one_step(copy.deepcopy(base), ids, accum_steps=2)
    assert math.isclose(float(m1["loss"]), float(m2["loss"]), rel_tol=1e-6)
    for p1, p2 in zip(s1.trainable(), s2.trainable()):
        scale = p1.grad.abs().max().item()
        assert scale > 0
        assert (p1.grad - p2.grad).abs().max().item() <= 1e-6 * scale
    with pytest.raises(ValueError, match="not divisible"):
        _one_step(copy.deepcopy(base), ids, accum_steps=3)


def test_remat_is_exact_on_cpu():
    """``remat=True`` recomputes the forward in the backward: the same
    loss, gradients and updated adapters, bit for bit, on the CPU."""
    ids = _ids(shape=(2, 16))
    s1, m1 = _one_step(_model(), ids)
    s2, m2 = _one_step(_model(), ids, remat=True)
    assert torch.equal(m1["loss"], m2["loss"])
    for p1, p2 in zip(s1.trainable(), s2.trainable()):
        assert torch.equal(p1.grad, p2.grad) and torch.equal(p1, p2)


def test_unported_options_raise():
    """What still raises: ``np > 1`` without a gang (data parallelism runs
    one process a device, started by ``launcher.launch``), and the
    reference's own refusal of BatchNorm statistics under gradient
    accumulation."""
    with pytest.raises(ValueError, match="mutable"):
        make_train_step(L.causal_lm_loss_fn(), mutable=True, accum_steps=2)
    # with_rng (dropout for BERT) and mutable (BatchNorm) are ported
    assert callable(make_train_step(L.causal_lm_loss_fn(), with_rng=True))
    assert callable(make_train_step(L.causal_lm_loss_fn(), mutable=True))
    with pytest.raises(ValueError, match="launcher.launch"):
        XlaRunner(np=2, device="cpu")
    with pytest.raises(ValueError, match="no LoRA adapters"):
        L.lora_optimizer()(_model(lora_rank=0))


def test_runner_defaults_to_the_card():
    if torch.cuda.is_available():
        assert XlaRunner().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            XlaRunner()


# --- the loop ----------------------------------------------------------------

def test_fit_crops_tail_batches_and_streams_iterators():
    """A bare generator streams without a cursor; with ``accum_steps=2`` a
    5-row batch is cropped to 4 and a 1-row batch skipped without using
    a step."""
    ids = _ids(shape=(5, 16))
    batches = iter([{"input_ids": ids[:1]}, {"input_ids": ids},
                    {"input_ids": ids[:4]}])
    res = XlaRunner(np=1, device="cpu").run(lambda ctx: ctx.fit(
        loss_fn=L.causal_lm_loss_fn(), model=_model(),
        tx=L.lora_optimizer(LR), data=batches, num_steps=3, log_every=1,
        accum_steps=2))
    assert [h["step"] for h in res["history"]] == [1, 2]  # data ran out
    assert res["state"].step == 2
    assert res["meter"].summary()["examples"] == 4  # step 1 is warm-up


def test_fit_records_spans_and_the_skip_list(monkeypatch):
    monkeypatch.setenv(D.SKIP_ENV, "[1]")
    ids = _ids()
    data = D.ListDataset([{"input_ids": ids}, {"input_ids": ids[:2]},
                          {"input_ids": ids[:3]}])
    seen = []
    events.add_tee(seen.append)  # the ring may be full of earlier tests'
    try:
        res = XlaRunner(np=1, device="cpu").run(lambda ctx: ctx.fit(
            loss_fn=L.causal_lm_loss_fn(), model=_model(),
            tx=L.lora_optimizer(LR), data=data, num_steps=5, log_every=1))
    finally:
        events.remove_tee(seen.append)
    assert res["state"].step == 2  # 3 batches, one of them skipped
    names = [e["name"] for e in seen]
    for name in ("fit_start", "data_fetch", "shard_put", "step_compute",
                 "train_batch_skipped", "fit_end"):
        assert name in names, name
    assert data.state() == {"epoch": 1, "batch_index": 0, "skip_list": [1]}


def test_fit_raises_on_a_diverged_loss():
    def nan_loss(model, batch):
        loss, aux = L.causal_lm_loss_fn()(model, batch)
        return loss * float("nan"), aux

    with pytest.raises(TrainingDivergedError, match="step 1"):
        XlaRunner(np=1, device="cpu").run(lambda ctx: ctx.fit(
            loss_fn=nan_loss, model=_model(), tx=L.lora_optimizer(LR),
            data=[{"input_ids": _ids()}], num_steps=1, log_every=1))


def test_fit_eval_and_mfu(monkeypatch):
    monkeypatch.setenv("SPARKDL_PEAK_FLOPS", "1e12")
    evals = []

    def eval_fn(model, batch):
        evals.append(torch.is_grad_enabled())
        return {"loss": L.causal_lm_loss_fn()(model, batch)[0]}

    ids = _ids()
    res = XlaRunner(np=1, device="cpu").run(lambda ctx: ctx.fit(
        loss_fn=L.causal_lm_loss_fn(), model=_model(),
        tx=L.lora_optimizer(LR), data=[{"input_ids": ids}] * 3, num_steps=3,
        log_every=1, eval_fn=eval_fn, eval_data=[{"input_ids": ids}],
        eval_every=2, flops_per_step=1e9))
    assert evals == [False]
    st = res["meter"].step_stats
    assert st.count == 2  # the first step is the warm-up
    assert res["meter"].mfu() == pytest.approx(
        1e9 / (st.total_s / st.count) / 1e12, rel=1e-3)
    assert res["meter"].summary()["mfu"] == round(res["meter"].mfu(), 4)


# --- runner/metrics.py and runner/data.py -------------------------------------

def test_peak_flops_and_step_stats(monkeypatch):
    monkeypatch.setenv("SPARKDL_PEAK_FLOPS", "989e12")
    assert M.peak_flops_per_chip() == 989e12
    monkeypatch.setenv("SPARKDL_PEAK_FLOPS", "fast")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert M.peak_flops_per_chip() == 989e12  # the data sheet's bf16 peak
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "other")
    assert M.peak_flops_per_chip() is None
    st = M.StepTimeStats(capacity=4)
    for dt in (0.1, 0.4, 0.2, 0.3, 5.0, -1.0):
        st.record(dt)
    summ = st.summary()
    assert summ["n"] == 5 and summ["max_s"] == 5.0
    assert summ["mean_s"] == pytest.approx(6.0 / 5)
    assert len(st._sample) == 4


def test_list_dataset_cursor_replays_exactly():
    batches = [{"x": np.full(2, i)} for i in range(5)]
    ds = D.ListDataset(batches, epochs=2, shuffle_seed=7)
    seen = [(c, int(b["x"][0])) for c, b in ds.indexed()]
    assert len(seen) == 10
    cursor = seen[3][0]
    replay = D.ListDataset(batches, epochs=2, shuffle_seed=7)
    replay.restore(cursor)
    assert [int(b["x"][0]) for b in replay] == [v for _, v in seen[4:]]
    assert sorted(v for _, v in seen[:5]) == list(range(5))


def test_factory_dataset_and_as_dataset():
    ds = D.FactoryDataset(lambda epoch: iter([epoch, epoch + 10]), epochs=2,
                          skip_list=[1])
    assert list(ds) == [0, 1]
    assert list(D.FactoryDataset(lambda n=2: range(n))) == [0, 1]
    assert isinstance(D.as_dataset([1, 2]), D.ListDataset)
    assert isinstance(D.as_dataset(lambda: iter([1])), D.FactoryDataset)
    assert D.as_dataset(iter([1])) is None
    assert D.as_dataset(ds) is ds
    assert D.env_skip_list({D.SKIP_ENV: "[3, 5]"}) == [3, 5]
    assert D.env_skip_list({D.SKIP_ENV: "nope"}) == []
    assert D.env_skip_list({}) == []


def test_draw_failures_name_their_batch():
    def broken():
        yield 1
        raise OSError("bad record")

    with pytest.raises(OSError) as info:
        list(D.FactoryDataset(broken))
    assert info.value._sparkdl_batch_index == 1
