"""The port's BERT (``sparkdl_tpu_torch.models.bert``), its train step
with dropout (``make_train_step(with_rng=True)``, ``fit(with_rng=...)``)
and the config-4 DataFrame fine-tune, against the JAX package's, on the
CPU.

The same seeded numpy inputs go through ``sparkdl_tpu.models.bert`` and
the port, whose weights come from the JAX model's flax tree
(``load_flax_params``). The kernel arm runs the JAX package's Pallas flash
attention in interpret mode (``block_q=block_k=16``, as its own tests do)
against the port's ``fa.flash_attention``, which takes its plain forward
and backward for CPU tensors.

Tolerances:
- f32 forward: sequence output, pooled output and logits within
  1e-5 + 1e-5·|ref| (the same f32 arithmetic in other orders);
- bf16 forward: pooled within 2**-6, logits within 2**-6·(1 + |ref|) (two
  bf16 computations of a 2-layer model, each rounding its Dense outputs);
- training, 4 steps in f32: each step's loss within 1e-5 relative, every
  parameter after steps 1 and 4 within 1e-5 + 1e-4·|ref| (Adam divides by
  sqrt(v) + eps, which magnifies the last bits of a small gradient). Both
  fits take Adam with eps 1e-4: the key biases' gradient is zero up to
  rounding (a bias added to every key shifts a query's scores by one
  constant, which softmax ignores), ~5e-9 here against >= 1e-2 for every
  other weight, and Adam's step is ~lr·g/(|g| + eps): at optax's default
  eps 1e-8 that noise moves the key biases by ~0.3·lr a step, at 1e-6 by
  ~5e-3·lr, with signs that differ between the two packages
  (``test_key_bias_gradient_is_rounding_noise``);
- dropout: the keep fraction over 10**6 draws within 5 sigma of 0.9.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparkdl_tpu.models import bert as JB
from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash
from sparkdl_tpu.runner import XlaRunner as JaxRunner
from sparkdl_tpu_torch.models import bert as B
from sparkdl_tpu_torch.ops import flash_attention as fa
from sparkdl_tpu_torch.parallel.ring_attention import dense_attention
from sparkdl_tpu_torch.runner import TrainState, XlaRunner
from sparkdl_tpu_torch.runner.train_state import (adam, make_train_step,
                                                  step_generator)

LR = 1e-3
ADAM_EPS = 1e-4  # far above the key biases' rounding-noise gradient (docstring)
JAX_FLASH = functools.partial(jax_flash, block_q=16, block_k=16)


def _np_tree(tree):
    return {k: _np_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _batch(b=4, s=24, seed=0, vocab=1000, classes=3):
    """Right-padded rows: one full, one of length 1, the rest seeded."""
    rng = np.random.RandomState(seed)
    lens = [s, 1] + list(rng.randint(2, s, size=b - 2))
    mask = np.stack([(np.arange(s) < n).astype(np.int32) for n in lens])
    ids = rng.randint(1, vocab, size=(b, s)) * mask
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": (rng.rand(b, s) < 0.3).astype(np.int32) * mask,
            "label": rng.randint(0, classes, size=(b,))}


@pytest.fixture(scope="module")
def flax_tree():
    cfg = JB.BertConfig.tiny()
    model = JB.BertForSequenceClassification(cfg, num_classes=3)
    return _np_tree(model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32)))


def _port(cls, tree, attn_fn, dtype=torch.float32, **kw):
    return B.load_flax_params(
        cls(B.BertConfig.tiny(), attn_fn=attn_fn, dtype=dtype, device="cpu",
            **kw), tree)


def _t(batch, keys=("input_ids", "attention_mask", "token_type_ids")):
    return [None if batch.get(k) is None else torch.from_numpy(batch[k])
            for k in keys]


BRANCHES = {  # name: (JAX attn_fn, port attn_fn, padded)
    "dense_bias": (None, None, True),
    "kernel_kv_mask": (JAX_FLASH, fa.flash_attention, True),
    "kernel_maskless": (JAX_FLASH, fa.flash_attention, False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_forward_matches_jax(flax_tree, branch, dtype):
    jfn, pfn, padded = BRANCHES[branch]
    batch = _batch()
    if not padded:
        batch = dict(batch, attention_mask=None)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    args = [None if a is None else jnp.asarray(a) for a in (
        batch["input_ids"], batch["attention_mask"],
        batch["token_type_ids"])]
    jenc = JB.BertEncoder(JB.BertConfig.tiny(), jdt, jfn)
    seq_ref, pooled_ref = jenc.apply({"params": flax_tree["params"]["bert"]},
                                     *args)
    logits_ref = JB.BertForSequenceClassification(
        JB.BertConfig.tiny(), 3, jdt, jfn).apply(flax_tree, *args)
    enc = _port(B.BertEncoder, {"params": flax_tree["params"]["bert"]}, pfn,
                tdt)
    cls = _port(functools.partial(B.BertForSequenceClassification,
                                  num_classes=3), flax_tree, pfn, tdt)
    with torch.no_grad():
        seq, pooled = enc(*_t(batch))
        logits = cls(*_t(batch))
    assert seq.dtype == torch.float32 and pooled.dtype == tdt
    assert logits.dtype == torch.float32 and logits.shape == (4, 3)
    got = [np.asarray(t.float()) for t in (seq, pooled, logits)]
    want = [np.asarray(a, np.float32) for a in (seq_ref, pooled_ref,
                                               logits_ref)]
    if dtype == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got[1] - want[1]).max() <= 2.0 ** -6
        assert np.all(np.abs(got[2] - want[2])
                      <= 2.0 ** -6 * (1 + np.abs(want[2])))


def test_padding_is_invisible_and_positions_start_at_zero(flax_tree):
    """Right pads: tokens under a zeroed mask change nothing (dense and
    kernel arms), and a row's real tokens sit at positions 0..n-1."""
    batch = _batch()
    for fn in (None, fa.flash_attention):
        enc = _port(B.BertEncoder, {"params": flax_tree["params"]["bert"]},
                    fn)
        ids2 = batch["input_ids"] + (1 - batch["attention_mask"]) * 7
        with torch.no_grad():
            _, p1 = enc(*_t(batch))
            _, p2 = enc(*_t(dict(batch, input_ids=ids2)))
            # row 2 alone, unpadded, gives its padded row's pooled output
            n = int(batch["attention_mask"][2].sum())
            _, solo = enc(torch.from_numpy(batch["input_ids"][2:3, :n]),
                          None,
                          torch.from_numpy(batch["token_type_ids"][2:3, :n]))
        torch.testing.assert_close(p1, p2, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(p1[2:3], solo, rtol=1e-5, atol=1e-5)


def test_maskless_attn_fn_contract(flax_tree):
    """A plain ``(q, k, v, causal=...)`` attn_fn runs when no mask is
    given and equals the reference's maskless run; with a padding mask it
    raises TypeError, while a ``**kwargs`` fn is taken at its word."""
    def maskless(q, k, v, causal=False):
        return dense_attention(q, k, v, causal)

    def jax_maskless(q, k, v, causal=False):
        from sparkdl_tpu.parallel.ring_attention import \
            dense_attention as jd
        return jd(q, k, v, causal)

    ids = np.random.RandomState(2).randint(0, 1000, (2, 16))
    tree = {"params": flax_tree["params"]["bert"]}
    enc = _port(B.BertEncoder, tree, maskless)
    with torch.no_grad():
        _, pooled = enc(torch.from_numpy(ids))
    _, want = JB.BertEncoder(JB.BertConfig.tiny(), attn_fn=jax_maskless)\
        .apply(tree, jnp.asarray(ids))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(TypeError, match="kv_mask"):
        enc(torch.from_numpy(ids), torch.ones((2, 16), dtype=torch.int32))
    seen = []

    def kwargs_fn(q, k, v, causal=False, **kw):
        seen.append(sorted(kw))
        return fa.flash_attention(q, k, v, causal, **kw)

    enc.attn_fn = kwargs_fn
    with torch.no_grad():
        enc(torch.from_numpy(ids), torch.ones((2, 16), dtype=torch.int32))
    assert seen == [["kv_mask"]] * 2


def test_load_flax_params_round_trip_and_errors(flax_tree):
    model = _port(functools.partial(B.BertForSequenceClassification,
                                    num_classes=3), flax_tree, None)
    back = dict(_flat(B.flax_params(model)))
    want = dict(_flat(flax_tree["params"]))
    assert sorted(back) == sorted(want)
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], w)
    extra = {"params": dict(flax_tree["params"], stray={"w": np.zeros(2)})}
    with pytest.raises(ValueError, match="unexpected"):
        B.load_flax_params(model, extra)
    missing = {"params": {k: v for k, v in flax_tree["params"].items()
                          if k != "classifier"}}
    with pytest.raises(KeyError, match="classifier"):
        B.load_flax_params(model, missing)
    with pytest.raises(ValueError, match="does not fit"):
        B.load_flax_params(B.BertForSequenceClassification(
            B.BertConfig.tiny(), num_classes=2, device="cpu"), flax_tree)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        B.BertForSequenceClassification(B.BertConfig.tiny())
    cfg = B.BertConfig.base()
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.head_dim,
            cfg.intermediate_size, cfg.vocab_size,
            cfg.max_position_embeddings, cfg.dropout_rate) == (
        12, 768, 12, 64, 3072, 30522, 512, 0.1)


# --- whole-slice parity: 4 steps of the GLUE fine-tune ----------------------

@pytest.fixture(scope="module")
def fit_parity(flax_tree):
    """The JAX fit and the port's fit (kernel arms, f32) over 1 and 4
    steps, from the same flax weights and batch."""
    jmodel = JB.BertForSequenceClassification(JB.BertConfig.tiny(), 3,
                                              attn_fn=JAX_FLASH)
    batch = _batch(b=8, s=24, seed=5)

    def apply_fn(params, b):
        return jmodel.apply(params, b["input_ids"], b["attention_mask"],
                            b["token_type_ids"])

    out = {}
    for steps in (1, 4):
        res = JaxRunner(np=1).run(lambda ctx: ctx.fit(
            loss_fn=JB.glue_loss_fn(), params=flax_tree,
            tx=optax.adam(LR, eps=ADAM_EPS), apply_fn=apply_fn,
            data=[batch] * steps,
            num_steps=steps, log_every=1))
        model = _port(functools.partial(B.BertForSequenceClassification,
                                        num_classes=3), flax_tree,
                      fa.flash_attention)
        port = XlaRunner(np=1, device="cpu").run(lambda ctx: ctx.fit(
            loss_fn=B.glue_loss_fn(), model=model,
            tx=adam(LR, eps=ADAM_EPS), data=[batch] * steps,
            num_steps=steps, log_every=1))
        out[steps] = dict(
            jax_losses=[h["loss"] for h in res["history"]],
            jax_params=_np_tree(res["state"].params),
            port_losses=[h["loss"] for h in port["history"]],
            port_acc=[h["accuracy"] for h in port["history"]],
            jax_acc=[h["accuracy"] for h in res["history"]],
            port_params=B.flax_params(model))
    return out


def test_fit_losses_match_jax(fit_parity):
    got, want = fit_parity[4]["port_losses"], fit_parity[4]["jax_losses"]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] < got[0]
    assert fit_parity[4]["port_acc"] == fit_parity[4]["jax_acc"]


@pytest.mark.parametrize("steps", [1, 4])
def test_fit_params_match_jax(fit_parity, steps):
    want = dict(_flat(fit_parity[steps]["jax_params"]["params"]))
    got = dict(_flat(fit_parity[steps]["port_params"]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=1e-5, rtol=1e-4,
                                   err_msg="/".join(path))


def test_key_bias_gradient_is_rounding_noise(flax_tree):
    """Why the parity fit raises Adam's eps: in both packages the key
    biases' gradient is zero up to rounding, far below every other
    weight's, so its Adam step at eps 1e-8 is rounding noise."""
    batch = _batch(b=8, s=24, seed=5)
    jmodel = JB.BertForSequenceClassification(JB.BertConfig.tiny(), 3,
                                              attn_fn=JAX_FLASH)

    def jloss(params):
        return JB.glue_loss_fn()(params, lambda p, b: jmodel.apply(
            p, b["input_ids"], b["attention_mask"], b["token_type_ids"]),
            batch)[0]

    jgrads = dict(_flat(_np_tree(jax.grad(jloss)(flax_tree))["params"]))
    model = _cls(flax_tree, fa.flash_attention)
    loss, _ = B.glue_loss_fn()(model, _tensors(batch))
    loss.backward()
    pgrads = {path: p.grad.numpy().T if t else p.grad.numpy()
              for path, p, t in B._param_map(model)}
    for grads in (jgrads, pgrads):
        key_bias = max(np.abs(g).max() for path, g in grads.items()
                       if path[-2:] == ("key", "bias"))
        query_bias = min(np.abs(g).max() for path, g in grads.items()
                         if path[-2:] == ("query", "bias"))
        assert key_bias < 1e-7 < 1e-4 < query_bias, (key_bias, query_bias)


# --- dropout and the with_rng step -------------------------------------------

def test_dropout_keep_fraction_and_scale():
    g = step_generator(0, 0, "cpu")
    x = torch.ones(10 ** 6)
    y = B.dropout(x, 0.1, g)
    kept = (y != 0).float().mean().item()
    sigma = math.sqrt(0.9 * 0.1 / 10 ** 6)
    assert abs(kept - 0.9) <= 5 * sigma, kept
    assert torch.all((y == 0) | (y == torch.tensor(1 / 0.9)))
    assert B.dropout(x, 0.1, None) is x
    xb = torch.ones(64, dtype=torch.bfloat16)
    assert B.dropout(xb, 0.1, g).dtype == torch.bfloat16


def test_step_generators_repeat_by_seed_and_differ_by_step():
    def mask(seed, step, micro=None):
        return B.dropout(torch.ones(4096), 0.1,
                         step_generator(seed, step, "cpu", micro)) != 0

    assert torch.equal(mask(0, 3), mask(0, 3))
    assert not torch.equal(mask(0, 3), mask(0, 4))
    assert not torch.equal(mask(0, 3), mask(1, 3))
    assert not torch.equal(mask(0, 3, 0), mask(0, 3, 1))
    assert not torch.equal(mask(0, 3), mask(0, 3, 0))


def _cls(flax_tree, attn_fn=None):
    return _port(functools.partial(B.BertForSequenceClassification,
                                   num_classes=3), flax_tree, attn_fn)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_rng_none_equals_glue_loss(flax_tree):
    model, batch = _cls(flax_tree), _tensors(_batch())
    with torch.no_grad():
        a, aux_a = B.bert_finetune_loss(model)(model, batch)
        b, aux_b = B.glue_loss_fn()(model, batch)
        c, _ = B.bert_finetune_loss(model)(model, batch,
                                           rng=step_generator(0, 0, "cpu"))
    assert torch.equal(a, b) and torch.equal(aux_a["accuracy"],
                                             aux_b["accuracy"])
    assert not torch.equal(a, c)  # dropout is on with a generator


@pytest.mark.parametrize("attn_fn,prob_drops", [(None, 2),
                                                (fa.flash_attention, 0)])
def test_prob_dropout_only_on_the_dense_branch(flax_tree, monkeypatch,
                                               attn_fn, prob_drops):
    """The [B, H, S, S] attention probabilities are dropped once a layer
    on the dense branch and never under an attn_fn; hidden dropout runs
    on both (embeddings, 2 a layer, the pooled output)."""
    shapes = []
    real = B.dropout

    def spy(x, rate, generator):
        shapes.append(tuple(x.shape))
        return real(x, rate, generator)

    monkeypatch.setattr(B, "dropout", spy)
    model, batch = _cls(flax_tree, attn_fn), _tensors(_batch())
    with torch.no_grad():
        B.bert_finetune_loss(model)(model, batch,
                                    rng=step_generator(0, 0, "cpu"))
    assert sum(len(s) == 4 for s in shapes) == prob_drops
    assert sum(len(s) != 4 for s in shapes) == 1 + 2 * 2 + 1


def _fit_rng(flax_tree, steps=3, seed=0, **kw):
    model = _cls(flax_tree, fa.flash_attention)
    batch = _batch(b=8, seed=5)
    res = XlaRunner(np=1, device="cpu").run(lambda ctx: ctx.fit(
        loss_fn=B.bert_finetune_loss(model), model=model, tx=adam(LR),
        data=[batch] * steps, num_steps=steps, log_every=1, with_rng=True,
        **kw))
    return [h["loss"] for h in res["history"]], B.flax_params(model)


def test_with_rng_fit_is_bit_identical_per_seed(flax_tree):
    l1, p1 = _fit_rng(flax_tree)
    l2, p2 = _fit_rng(flax_tree)
    assert l1 == l2
    for (path, a), (_, b) in zip(_flat(p1), _flat(p2)):
        np.testing.assert_array_equal(a, b, err_msg="/".join(path))
    # remat recomputes the forward: the generator is rebuilt inside it,
    # so the masks, the losses and the weights are the same bits
    l3, p3 = _fit_rng(flax_tree, remat=True)
    assert l3 == l1
    for (path, a), (_, b) in zip(_flat(p1), _flat(p3)):
        np.testing.assert_array_equal(a, b, err_msg="/".join(path))


def test_with_rng_generators_by_step_and_microbatch(flax_tree):
    """The loss receives step_generator(rng_seed, step) a step, and
    step_generator(rng_seed, step, i) for microbatch i under
    accum_steps."""
    seen = []
    inner = B.glue_loss_fn()

    def loss_fn(model, batch, rng=None):
        seen.append(rng.initial_seed())
        return inner(model, batch)

    batch = _tensors(_batch(b=8, seed=5))
    for accum in (1, 2):
        state = TrainState.create(_cls(flax_tree), adam(LR))
        step = make_train_step(loss_fn, with_rng=True, rng_seed=7,
                               accum_steps=accum)
        for _ in range(2):
            state, _ = step(state, batch)
    want = [step_generator(7, s, "cpu").initial_seed() for s in (0, 1)]
    want += [step_generator(7, s, "cpu", i).initial_seed()
             for s in (0, 1) for i in (0, 1)]
    assert seen == want and len(set(want)) == 6


# --- BASELINE config 4: DataFrame → randomSplit → ArrowDataset → fit --------

def test_config4_dataframe_to_finetune_end_to_end():
    """The twin of test_transformer_models' config-4 test at np=1: a
    tokenized GLUE-shaped DataFrame streams through ArrowDataset into
    fit(bert_finetune_loss, with_rng=True); held-out accuracy >= 0.75."""
    from sparkdl_tpu_torch.core.frame import DataFrame
    from sparkdl_tpu_torch.runner.data import ArrowDataset

    cfg = B.BertConfig.tiny()
    S, n = 12, 96
    rng = np.random.RandomState(0)
    # the first token comes from a small reused id set, label = that token
    # in the upper half of the set: a rule that generalizes
    seqs, masks, labels = [], [], []
    for _ in range(n):
        ln = rng.randint(6, S + 1)
        toks = rng.randint(1, cfg.vocab_size, size=(ln,))
        toks[0] = 2 + rng.randint(0, 10)
        seqs.append(toks.tolist() + [0] * (S - ln))
        masks.append([1] * ln + [0] * (S - ln))
        labels.append(int(toks[0] >= 7))
    df = DataFrame.fromPydict(
        {"input_ids": seqs, "attention_mask": masks, "label": labels},
        numPartitions=4)
    train_df, test_df = df.randomSplit([0.75, 0.25], seed=1)
    model = B.BertForSequenceClassification(
        cfg, num_classes=2, attn_fn=fa.flash_attention, device="cpu",
        generator=torch.Generator().manual_seed(0))
    data = ArrowDataset(train_df, batch_size=16, epochs=30)
    steps = 30 * -(-train_df.count() // 16)
    res = XlaRunner(np=1, device="cpu").run(lambda ctx: ctx.fit(
        loss_fn=B.bert_finetune_loss(model), model=model, tx=adam(2e-3),
        data=data, num_steps=steps, with_rng=True, log_every=steps))
    assert res["state"].step == steps
    rows = test_df.collect()
    ids = torch.tensor([r["input_ids"] for r in rows])
    msk = torch.tensor([r["attention_mask"] for r in rows])
    y = torch.tensor([r["label"] for r in rows])
    with torch.no_grad():
        acc = (model(ids, msk).argmax(-1) == y).float().mean().item()
    assert acc >= 0.75, f"held-out accuracy {acc}"
