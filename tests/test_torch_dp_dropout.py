"""Dropout across the ranks of a gang, and the LoRA fine-tune in a gang
(BASELINE configs 4 and 5 over ``XlaRunner`` gangs), against the port's
one-process step and the JAX package's ``XlaRunner(np=2)``, on the CPU.

Two gloo ranks are started by ``runner.launcher.launch`` on
``tests/test_torch_gang_worker.py`` (modes ``bert`` and ``lora``); each
writes what it computed, and this module holds it against the port's
one-process step and the JAX package. The one-process references of the
dropout steps are made by the worker's ``bert_ref`` mode in one more
process started the same way (fresh, ``OMP_NUM_THREADS=2``), not in the
pytest process: made here, under a parallel run they once came out
1.1e-5 of the largest gradient away from the gang (5.6× the limit),
where every run on its own read 4.4e-7. That cause is not proven, so
each rank also makes the one-process step in its own process, and the
message of a failed gradient check shows both shares.

The port draws masks with ``torch.rand``, the reference with threefry, so
masks are never compared with the reference's bits. What is held:

- **the invariant** the reference keeps (its implicit step's masks come
  from one key over the global batch, whatever the number of devices):
  the two-rank implicit step with dropout equals the port's one-process
  step over the global batch (tiny BERT, dropout 0.1, one SGD step from
  one start). The gradients agree to ``GRAD_SHARE`` of the model's
  largest gradient and the loss to ``LOSS_RTOL``: the gang averages two
  rank means in f32 where one process takes one mean, and the products
  run at 4 rows instead of 8 (measured on the CPU: 4.4e-7 of the
  largest gradient, 1.0e-7 under ``accum_steps=2``, the loss 8.8e-8
  relative; the reference's own np 1/2/8 spread was ≤ 1.9e-9 of its
  weights after an Adam step). The same with ``accum_steps=2`` against one
  process fed the reference's shard-aligned microbatches; ``remat`` is
  bitwise. A gang that drew each rank's masks on its own rows would fail:
  the explicit step's gradient (other masks) lies beyond the limit;
- the explicit step: each rank's key folds in its rank, so the gradient
  is the mean of two one-process gradients, each on its rank's rows with
  ``step_generator(..., rank=r)``;
- against the reference: the rng plumbing of a two-rank ``fit(with_rng=
  True)`` at dropout 0 against the reference's ``XlaRunner(np=2)`` fit
  from carried-over weights, within ``tests/test_torch_bert.py``'s fit
  parity (losses 1e-5 relative, parameters 1e-5 + 1e-4·|ref|, Adam eps
  1e-4 as there); the
  config-4 DataFrame fine-tune in the gang reaching the reference test's
  held-out accuracy, 0.75;
- a gang's checkpoint and resume with dropout repeats the uninterrupted
  run's losses and weights bitwise (the masks are a function of the seed,
  the step and the rank's rows);
- LoRA (the twin of ``test_causal_lm_loss_trains``): two ranks of 8 rows
  against the reference's ``XlaRunner(np=2)`` over 16, losses within
  1e-5 relative, the adapters within 1e-5 + 1e-4·|ref| (the rules of
  ``tests/test_torch_train.py``), the base weights bit-identical.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparkdl_tpu.models import bert as JB
from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.runner import XlaRunner as JaxRunner
from sparkdl_tpu_torch.models import bert as B
from sparkdl_tpu_torch.runner import launcher
from sparkdl_tpu_torch.runner.train_state import step_generator

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("test_torch_gang_worker.py")
GLOBAL, SEQ, SEED = 8, 16, 3
GRAD_SHARE, LOSS_RTOL = 2e-6, 1e-6


def _gang(mode, d, out=None, ranks=2):
    """Run the worker's ``mode`` on ``ranks`` gloo ranks (inputs in
    ``d``, outputs in ``out``, default ``d``); each rank's result."""
    out = d if out is None else out
    env = {"OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(ROOT) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    launcher.launch(str(WORKER), np=ranks, args=[mode, str(d), str(out)],
                    env=env, timeout_s=180.0, capture=True)
    return [torch.load(Path(out) / f"rank{r}.pt", weights_only=False)
            for r in range(ranks)]


def _np_tree(tree):
    return {k: _np_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _bert_batch(seed):
    """GLOBAL right-padded rows of SEQ (one full, one of length 1)."""
    rng = np.random.RandomState(seed)
    lens = [SEQ, 1] + list(rng.randint(2, SEQ, size=GLOBAL - 2))
    mask = np.stack([(np.arange(SEQ) < n).astype(np.int32) for n in lens])
    return {"input_ids": rng.randint(1, 1000, (GLOBAL, SEQ)) * mask,
            "attention_mask": mask, "label": rng.randint(0, 3, GLOBAL)}


def _share(got, want):
    """The largest gradient error as a share of the largest gradient."""
    top = max(g.abs().max().item() for g in want.values())
    return max((got[n] - want[n]).abs().max().item()
               for n in want) / top


def _worst(got, want):
    """What a failed gradient check read: the share, and the parameter
    with the largest error and that error."""
    err = {n: (got[n] - want[n]).abs().max().item() for n in want}
    n = max(err, key=err.get)
    return f"share {_share(got, want):.3g}, worst {n} |diff| {err[n]:.3g}"


def _first_diff(got, want):
    """The first parameter that is not bitwise equal, and its largest
    difference; None when all are."""
    for n, g in got.items():
        if not torch.equal(g, want[n]):
            return f"{n} differs by {(g - want[n]).abs().max().item():.3g}"
    return None


@pytest.fixture(scope="module")
def bert_gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert_gang")
    tree = _np_tree(JB.BertForSequenceClassification(
        JB.BertConfig.tiny(), num_classes=3).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    init = B.load_flax_params(B.BertForSequenceClassification(
        B.BertConfig.tiny(), num_classes=3, device="cpu"),
        tree).state_dict()
    torch.save(init, d / "bert_init.pt")
    batch = _bert_batch(5)
    fit_batches = [_bert_batch(10 + i) for i in range(4)]
    np.savez(d / "bert.npz", **batch,
             **{f"fit_{k}": np.stack([b[k] for b in fit_batches])
                for k in batch})
    ref_dir = d / "ref"
    ref_dir.mkdir()
    # the one-process references, made in a process started like a rank
    # (fresh, the gang's env): what they are held to must not depend on
    # the state of the pytest process that runs this module
    ref = _gang("bert_ref", d, ref_dir, ranks=1)[0]
    return _gang("bert", d), tree, init, batch, fit_batches, ref


def test_implicit_dropout_step_equals_the_global_batch_step(bert_gang):
    """Rank r draws rows r of the one-process masks: the two-rank step's
    gradients and loss equal one process's over the global batch; the
    ranks agree to the bit; ``remat`` (the window made again in the
    recomputed forward) is bitwise."""
    outs, *_, ref = bert_gang
    want, loss = ref["global"]["grads"], ref["global"]["loss"]
    for out in outs:
        got = out["implicit"]
        # on a failure, the rank's own one-process step against the
        # reference process says which side moved: near 0, the gang's
        # step; as far off as the gang's, the process the ranks run in
        assert _share(got["grads"], want) <= GRAD_SHARE, (
            _worst(got["grads"], want) + "; the rank's own one-process "
            "step: " + _worst(out["global_here"]["grads"], want))
        assert got["loss"] == pytest.approx(loss, rel=LOSS_RTOL), \
            f"loss relative error {abs(got['loss'] - loss) / abs(loss):.3g}"
        assert _first_diff(got["grads"], out["remat"]["grads"]) is None, \
            "remat: " + _first_diff(got["grads"], out["remat"]["grads"])
        assert got["loss"] == out["remat"]["loss"], \
            (got["loss"], out["remat"]["loss"])
    assert _first_diff(outs[0]["implicit"]["grads"],
                       outs[1]["implicit"]["grads"]) is None, \
        "ranks: " + _first_diff(outs[0]["implicit"]["grads"],
                                outs[1]["implicit"]["grads"])


def test_accum_dropout_step_equals_the_shard_aligned_microbatches(
        bert_gang):
    """``accum_steps=2``: rank r's chunk i holds its rows of the global
    microbatch i, which the reference's shard-aligned split makes of
    every rank's chunk i; so one process fed the batch regrouped that way
    (rows 0, 1, 4, 5 then 2, 3, 6, 7) makes the same step."""
    outs, *_, ref = bert_gang
    want, loss = ref["accum"]["grads"], ref["accum"]["loss"]
    for out in outs:
        assert _share(out["accum"]["grads"], want) <= GRAD_SHARE, \
            _worst(out["accum"]["grads"], want)
        assert out["accum"]["loss"] == pytest.approx(loss, rel=LOSS_RTOL)


def test_explicit_step_draws_each_ranks_own_masks(bert_gang):
    """The explicit step folds the rank into the key: its gradient is the
    mean of the two ranks' one-process gradients, each on its own rows
    with ``step_generator(..., rank=r)``; and it differs from the
    implicit step's beyond the limit (other masks)."""
    outs, *_, ref = bert_gang
    grads = ref["rank_grads"]
    want = {n: (grads[0][n] + grads[1][n]) / 2 for n in grads[0]}
    for out in outs:
        assert _share(out["explicit"]["grads"], want) <= GRAD_SHARE, \
            _worst(out["explicit"]["grads"], want)
        assert _share(out["explicit"]["grads"],
                      out["implicit"]["grads"]) > 100 * GRAD_SHARE
    seeds = {step_generator(SEED, 0, "cpu", rank=r).initial_seed()
             for r in range(2)}
    assert len(seeds | {step_generator(SEED, 0, "cpu").initial_seed()}) == 3


def test_step_generator_words_never_collide():
    """Step, microbatch and rank words give distinct seeds, and a rank
    never reads as a microbatch."""
    seeds = [step_generator(0, s, "cpu", m, r).initial_seed()
             for s in range(3) for m in (None, 0, 1) for r in (None, 0, 1)]
    assert len(set(seeds)) == len(seeds)


def test_dropout0_gang_fit_matches_the_reference_np2_fit(bert_gang):
    """The rng plumbing of a two-rank ``fit(with_rng=True)`` at dropout 0
    against the reference's ``XlaRunner(np=2)`` fit with the same flags
    from the same flax weights: losses and parameters within the fit
    parity of ``tests/test_torch_bert.py``."""
    outs, tree, _, _, fit_batches, _ = bert_gang
    jmodel = JB.BertForSequenceClassification(
        dataclasses.replace(JB.BertConfig.tiny(), dropout_rate=0.0), 3)
    res = JaxRunner(np=2).run(lambda ctx: ctx.fit(
        loss_fn=JB.bert_finetune_loss(jmodel), params=tree,
        tx=optax.adam(1e-3, eps=1e-4), data=fit_batches,
        num_steps=len(fit_batches), with_rng=True, log_every=1))
    want_losses = [h["loss"] for h in res["history"]]
    want = dict(_flat(_np_tree(res["state"].params)["params"]))
    for out in outs:
        np.testing.assert_allclose(out["fit0_losses"], want_losses,
                                   rtol=1e-5, atol=0)
        got = dict(_flat(out["fit0_params"]))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, atol=1e-5, rtol=1e-4,
                                       err_msg="/".join(path))


def test_gang_resume_with_dropout_repeats_the_straight_run(bert_gang):
    """``fit(with_rng=True, checkpoint_every=2)``: 2 steps, then a resume
    to 4, give the 4 straight steps' losses and weights to the bit, on
    both ranks."""
    outs, *_ = bert_gang
    for out in outs:
        (l_straight, sd_straight), (l_resumed, sd_resumed) = \
            out["straight"], out["resumed"]
        assert len(l_straight) == 4 and l_resumed == l_straight
        for k, t in sd_straight.items():
            assert torch.equal(t, sd_resumed[k]), k
    assert outs[0]["straight"][0] == outs[1]["straight"][0]


def test_config4_dataframe_finetune_in_a_gang(bert_gang):
    """The twin of ``test_config4_dataframe_to_finetune_end_to_end`` at
    np=2: the DataFrame's whole batches of 16 split over two ranks,
    ``fit(bert_finetune_loss, with_rng=True)``; held-out accuracy ≥ 0.75
    (the reference's bar), the same weights on both ranks."""
    outs, *_ = bert_gang
    assert outs[0]["config4_accuracy"] >= 0.75, outs[0]["config4_accuracy"]
    assert outs[0]["config4_accuracy"] == outs[1]["config4_accuracy"]


# --- LoRA in a gang: twin of test_causal_lm_loss_trains --------------------

@pytest.fixture(scope="module")
def lora_gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora_gang")
    cfg = JL.LlamaConfig.tiny(lora_rank=4)
    jmodel = JL.LlamaModel(cfg)
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (16, 16))
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(0),
                                     jnp.asarray(ids)))
    torch.save(variables, d / "lora_init.pt")
    np.savez(d / "lora.npz", ids=ids)
    res = JaxRunner(np=2).run(lambda ctx: ctx.fit(
        loss_fn=JL.causal_lm_loss_fn(), params=variables,
        tx=JL.lora_optimizer(5e-3), apply_fn=jmodel.apply,
        data=[{"input_ids": ids}] * 8, num_steps=8, log_every=1))
    return _gang("lora", d), variables, res


def test_lora_gang_matches_the_reference_np2_fit(lora_gang):
    outs, start, res = lora_gang
    want_losses = [h["loss"] for h in res["history"]]
    start = dict(_flat(start["params"]))
    want = dict(_flat(_np_tree(res["state"].params)["params"]))
    assert want_losses[-1] < want_losses[0]
    for out in outs:
        assert out["trainable"] == 8  # the adapters only
        np.testing.assert_allclose(out["losses"], want_losses, rtol=1e-5,
                                   atol=0)
        got = dict(_flat(out["params"]))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            if "lora_a" in path or "lora_b" in path:
                np.testing.assert_allclose(got[path], w, atol=1e-5,
                                           rtol=1e-4, err_msg="/".join(path))
            else:
                np.testing.assert_array_equal(got[path], start[path])
    assert outs[0]["losses"] == outs[1]["losses"]
