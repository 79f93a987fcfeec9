"""Worker program of the port's data-parallel tests (started by
``sparkdl_tpu_torch.runner.launcher.launch``; it holds no test).

Every rank joins the gang through ``XlaRunner`` from the launcher's
``SPARKDL_*`` env and writes what it computed to ``<out>/rank<r>.pt``; the
parent test holds that against the JAX package. It imports only torch,
numpy and the port.

Usage: ``test_torch_gang_worker.py <mode> <in_dir> <out_dir> [device]``
(device ``cpu``, the default, or ``cuda``; TF32 off), ``mode`` one of:

- ``linear``: a linear classifier, 3 SGD steps on this rank's half of
  each global batch (``in_dir/linear.npz``), then the hvd-compat
  collectives (the port's twin of ``tests/mp_worker.py``);
- ``resnet``: one mutable SGD step of a narrow ResNet18 from
  ``in_dir/init.pt`` on this rank's rows of ``in_dir/batch.npz``: the
  implicit step, with ``remat`` too, and the explicit one; the explicit
  step's refusal of ``accum_steps``; the ``rng=`` a ``with_rng`` step
  hands its loss; ``put_replicated`` of a model drawn from this rank's
  own seed;
- ``fit``: ``ctx.fit(checkpoint_every=2)`` over a ``shard=True`` dataset,
  4 steps straight and 2 + a resume to 4, with the saves counted;
- ``bert``: the tiny BERT of ``in_dir/bert_init.pt`` with dropout on this
  rank's rows of ``in_dir/bert.npz``: one ``with_rng`` SGD step of each
  gang step (implicit, with ``remat``, with ``accum_steps=2``, explicit),
  its gradients and loss; a dropout-0 ``fit(with_rng=True)`` from the
  same start; ``fit(with_rng=True, checkpoint_every=2)``
  4 steps straight and 2 + a resume to 4; the config-4 DataFrame
  fine-tune (the twin of ``tests/test_transformer_models.py``'s); and
  the one-process step over the global batch made in the rank's own
  process (``global_here``: read only by a failure message, to tell
  whether the gang's step or the rank's process moved);
- ``bert_ref`` (one rank): the one-process references of the ``bert``
  gang's steps, made in a process like a rank's (started fresh by the
  launcher, with the gang's env): one ``with_rng`` SGD step over the
  global batch, the same with ``accum_steps=2`` over the batch regrouped
  as the reference's shard-aligned microbatches, and each rank's rows'
  gradient with ``step_generator(..., rank=r)``;
- ``lora``: the tiny LoRA Llama of ``in_dir/lora_init.pt`` through
  ``fit(causal_lm_loss_fn(), lora_optimizer(5e-3))`` on this rank's rows
  of ``in_dir/lora.npz``;
- the supervised gangs (started by ``launcher.supervise``; the chaos plan
  comes in ``SPARKDL_CHAOS``), each a 4×3 linear softmax model under
  ``runner.run(lambda ctx: ctx.fit(...))``, SGD 0.1, the reference's
  seeds: ``sup_linear`` 4 steps of 8 rows a rank from a generator (the
  twin of ``tests/chaos_mp_worker.py``); ``sup_rollback`` 6 steps with
  ``checkpoint_dir=out_dir/ckpt`` and ``checkpoint_every=2``, appending
  ``{final_step, steps_this_attempt}`` to ``out_dir/attempts.jsonl`` (the
  twin of ``tests/test_chaos.py``'s supervised rollback worker);
  ``sup_elastic`` 12 steps over 12 global batches of 12 rows
  (``ListDataset(shard=True)``, so the rows divide at every world size
  from 4 down), ``checkpoint_every=2``, ``log_every=1``, appending
  ``{final_step, final_loss, world}`` to ``out_dir/result_rank<r>.jsonl``
  (the twin of ``scripts/elastic_smoke.py``'s worker); ``sup_resnet`` the
  narrow ResNet18 (32², 10 classes) from seed 0, ``fit(mutable=True,
  checkpoint_every=2)`` for 6 steps over 6 seeded batches of 8 with
  ``checkpoint_dir=out_dir/ckpt``, cuDNN deterministic: its final
  ``state_dict`` and the step it resumed at (the card test's supervised
  NCCL gang).
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _narrow_resnet(seed=0):
    from sparkdl_tpu_torch.models import resnet as R

    return R.ResNet(stage_sizes=[2, 2, 2, 2], block=R.BasicBlock, width=8,
                    num_classes=10, seed=seed)


def _local(batch, rank, size):
    per = len(batch["label"]) // size
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def linear(ctx, in_dir):
    from sparkdl_tpu_torch.runner import (TrainState, api, sgd,
                                          softmax_cross_entropy_loss)

    d = np.load(os.path.join(in_dir, "linear.npz"))
    model = torch.nn.Linear(d["w"].shape[0], d["w"].shape[1])
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(d["w"].T))
        model.bias.copy_(torch.from_numpy(d["b"]))
    state = TrainState.create(model, sgd(0.1))
    ctx.put_replicated(model, state.optimizer)
    step = ctx.make_train_step(softmax_cross_entropy_loss())
    losses = []
    for i in range(len(d["x"])):
        local = _local({"image": d["x"][i], "label": d["y"][i]}, ctx.rank,
                       ctx.size)
        state, m = step(state, ctx.shard_batch(local))
        losses.append(float(m["loss"]))
    # the gang's FLOP count of its first step (SPARKDL_MFU_ESTIMATE): the
    # rank's count times the gang's size
    os.environ["SPARKDL_MFU_ESTIMATE"] = "1"
    fit = ctx.fit(loss_fn=softmax_cross_entropy_loss(),
                  model=torch.nn.Linear(d["w"].shape[0], d["w"].shape[1]),
                  tx=sgd(0.1), num_steps=1,
                  data=[_local({"image": d["x"][0], "label": d["y"][0]},
                               ctx.rank, ctx.size)])
    del os.environ["SPARKDL_MFU_ESTIMATE"]
    return {"w": model.weight.detach().T.clone(),
            "b": model.bias.detach().clone(),
            "losses": torch.tensor(losses),
            "fit_flops": fit["meter"].flops_per_step,
            "hvd_sum": api.allreduce(np.float32(ctx.rank + 1), average=False),
            "hvd_mean": api.allreduce(np.float32(ctx.rank + 1)),
            "hvd_bcast": api.broadcast(np.float32(ctx.rank * 10 + 7),
                                       root_rank=1),
            "hvd_size": api.size(), "hvd_rank": api.rank()}


def resnet(ctx, in_dir):
    from sparkdl_tpu_torch.runner import TrainState, bn_classifier_loss, sgd

    init = torch.load(os.path.join(in_dir, "init.pt"))
    batch = dict(np.load(os.path.join(in_dir, "batch.npz")))
    local = ctx.shard_batch(_local(batch, ctx.rank, ctx.size))
    out = {}
    for name, kw in (("implicit", {}), ("remat", {"remat": True}),
                     ("explicit", {"explicit_collectives": True})):
        model = _narrow_resnet().to(ctx.device)
        model.load_state_dict(init)
        state = TrainState.create(model, sgd(0.01, momentum=0.9))
        step = ctx.make_train_step(bn_classifier_loss(), mutable=True, **kw)
        state, m = step(state, local)
        out[name] = {k: v.detach().cpu() for k, v in
                     model.state_dict().items()}
        out[name + "_loss"] = float(m["loss"])
    try:
        ctx.make_train_step(bn_classifier_loss(), explicit_collectives=True,
                            accum_steps=2)
        out["explicit_accum_refusal"] = "did not raise"
    except ValueError as e:
        out["explicit_accum_refusal"] = str(e)
    # with_rng: the implicit step hands the loss this rank's window of
    # the global batch's rows
    seen = []

    def loss_rng(m, b, rng=None):
        seen.append((type(rng).__name__, rng.row_start, rng.global_rows))
        return bn_classifier_loss()(m, b)

    model = _narrow_resnet().to(ctx.device)
    model.load_state_dict(init)
    ctx.make_train_step(loss_rng, mutable=True, with_rng=True)(
        TrainState.create(model, sgd(0.01)), local)
    out["with_rng_window"] = seen
    # a model drawn from this rank's seed starts as rank 0's
    mine = _narrow_resnet(seed=ctx.rank).to(ctx.device)
    opt = sgd(0.01, momentum=0.9)(mine)
    for p in mine.parameters():  # momentum buffers that differ by rank
        opt.state[p]["momentum_buffer"] = torch.full_like(p, ctx.rank)
    ctx.put_replicated(mine, opt)
    ref = _narrow_resnet(seed=0).state_dict()
    out["replicated"] = all(torch.equal(v.cpu(), ref[k])
                            for k, v in mine.state_dict().items()) and all(
        bool((s["momentum_buffer"] == 0).all()) for s in opt.state.values())
    return out


def fit(ctx, in_dir, out_dir):
    from sparkdl_tpu_torch.runner import (CheckpointManager, XlaRunner,
                                          bn_classifier_loss, sgd)
    from sparkdl_tpu_torch.runner.data import ListDataset

    d = np.load(os.path.join(in_dir, "fit.npz"))
    batches = [{"image": d["x"][i], "label": d["y"][i]}
               for i in range(len(d["x"]))]
    writes = []
    real_write = CheckpointManager._write

    def counted(self, step, *a):
        writes.append(int(step))
        return real_write(self, step, *a)

    CheckpointManager._write = counted

    def run(directory, steps):
        model = _narrow_resnet().to(ctx.device)
        res = XlaRunner(np=ctx.size, device=ctx.device.type,
                        checkpoint_dir=directory).run(lambda c: c.fit(
                            loss_fn=bn_classifier_loss(), model=model,
                            tx=sgd(0.01, momentum=0.9),
                            data=ListDataset(batches, shard=True),
                            num_steps=steps, log_every=1, mutable=True,
                            checkpoint_every=2))
        return res, {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()}

    straight, sd_straight = run(os.path.join(out_dir, "straight"), 4)
    writes_straight = list(writes)
    first, _ = run(os.path.join(out_dir, "resumed"), 2)
    second, sd_resumed = run(os.path.join(out_dir, "resumed"), 4)
    return {"straight": sd_straight, "resumed": sd_resumed,
            "writes_straight": writes_straight, "writes": list(writes),
            "steps_run": [straight["meter"].steps, first["meter"].steps,
                          second["meter"].steps],
            "losses": [h["loss"] for h in straight["history"]],
            "examples": straight["meter"].summary()["examples"],
            "n_chips": straight["meter"].summary()["n_chips"]}


def _bert_model(path, device, **cfg):
    import dataclasses

    from sparkdl_tpu_torch.models import bert as B
    from sparkdl_tpu_torch.ops import flash_attention as fa

    model = B.BertForSequenceClassification(
        dataclasses.replace(B.BertConfig.tiny(), **cfg), num_classes=3,
        attn_fn=fa.flash_attention, device=device)
    model.load_state_dict(torch.load(path))
    return model


def _grads(state):
    return {n: p.grad.detach().cpu().clone()
            for n, p in state.model.named_parameters()
            if p.grad is not None}


def _bert_inputs(in_dir):
    """The start's path, the arrays of ``bert.npz`` and its global
    batch as CPU tensors."""
    d = dict(np.load(os.path.join(in_dir, "bert.npz")))
    batch = {k: torch.from_numpy(np.ascontiguousarray(d[k]))
             for k in ("input_ids", "attention_mask", "label")}
    return os.path.join(in_dir, "bert_init.pt"), d, batch


def _one_process_step(init, rows, **kw):
    """One ``with_rng`` SGD step of one process on ``rows``."""
    from sparkdl_tpu_torch.models import bert as B
    from sparkdl_tpu_torch.runner import TrainState, sgd
    from sparkdl_tpu_torch.runner.train_state import make_train_step

    model = _bert_model(init, "cpu")
    state = TrainState.create(model, sgd(0.1))
    state, m = make_train_step(B.bert_finetune_loss(model), with_rng=True,
                               rng_seed=3, **kw)(state, rows)
    return {"grads": _grads(state), "loss": float(m["loss"])}


def bert(ctx, in_dir, out_dir):
    from sparkdl_tpu_torch.models import bert as B
    from sparkdl_tpu_torch.runner import TrainState, XlaRunner, adam, sgd
    from sparkdl_tpu_torch.runner.data import ListDataset

    init, d, batch = _bert_inputs(in_dir)
    batch = {k: v.numpy() for k, v in batch.items()}
    local = ctx.shard_batch(_local(batch, ctx.rank, ctx.size))
    out = {}
    # one SGD step of each gang step with dropout, from one start
    for name, kw in (("implicit", {}), ("remat", {"remat": True}),
                     ("accum", {"accum_steps": 2}),
                     ("explicit", {"explicit_collectives": True})):
        model = _bert_model(init, ctx.device)
        state = TrainState.create(model, sgd(0.1))
        step = ctx.make_train_step(B.bert_finetune_loss(model),
                                   with_rng=True, rng_seed=3, **kw)
        state, m = step(state, local)
        out[name] = {"grads": _grads(state), "loss": float(m["loss"])}
    out["global_here"] = _one_process_step(
        init, {k: torch.from_numpy(v) for k, v in batch.items()})

    # a dropout-0 fit with with_rng (the reference's np=2 fit's twin)
    batches = [{k: v[i] for k, v in d.items() if k.startswith("fit_")}
               for i in range(len(d["fit_input_ids"]))]
    batches = [{k[4:]: v for k, v in b.items()} for b in batches]
    model = _bert_model(init, ctx.device, dropout_rate=0.0)
    res = ctx.fit(loss_fn=B.bert_finetune_loss(model), model=model,
                  tx=adam(1e-3, eps=1e-4),
                  data=ListDataset(batches, shard=True),
                  num_steps=len(batches), log_every=1, with_rng=True)
    out["fit0_losses"] = [h["loss"] for h in res["history"]]
    out["fit0_params"] = B.flax_params(model)

    # checkpoint and resume with dropout on
    def run(directory, steps):
        model = _bert_model(init, ctx.device)
        res = XlaRunner(np=ctx.size, device=ctx.device.type,
                        checkpoint_dir=directory).run(lambda c: c.fit(
                            loss_fn=B.bert_finetune_loss(model),
                            model=model, tx=adam(1e-3),
                            data=ListDataset(batches, shard=True),
                            num_steps=steps, log_every=1, with_rng=True,
                            checkpoint_every=2))
        return ([h["loss"] for h in res["history"]],
                {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()})

    out["straight"] = run(os.path.join(out_dir, "straight"), 4)
    first = run(os.path.join(out_dir, "resumed"), 2)
    second = run(os.path.join(out_dir, "resumed"), 4)
    out["resumed"] = (first[0] + second[0], second[1])
    out["config4_accuracy"] = config4(ctx)
    return out


def bert_ref(in_dir):
    from sparkdl_tpu_torch.models import bert as B
    from sparkdl_tpu_torch.runner.train_state import step_generator

    init, _, batch = _bert_inputs(in_dir)
    half = len(batch["label"]) // 2
    order = [0, 1, 4, 5, 2, 3, 6, 7]  # every rank's chunk i, in turn
    out = {"global": _one_process_step(init, batch),
           "accum": _one_process_step(
               init, {k: v[order] for k, v in batch.items()},
               accum_steps=2),
           "rank_grads": []}
    for r in range(2):
        model = _bert_model(init, "cpu")
        rows = {k: v[r * half:(r + 1) * half] for k, v in batch.items()}
        loss, _ = B.bert_finetune_loss(model)(
            model, rows, rng=step_generator(3, 0, "cpu", rank=r))
        out["rank_grads"].append(dict(zip(
            [n for n, _ in model.named_parameters()],
            torch.autograd.grad(loss, list(model.parameters())))))
    return out


def config4_frame(vocab):
    """The config-4 test's DataFrame: 96 rows of lengths 6-12, the first
    token from a set of 10 ids, the label whether it is in their upper
    half (``tests/test_transformer_models.py``), split 0.75 / 0.25."""
    from sparkdl_tpu_torch.core.frame import DataFrame

    S, n = 12, 96
    rng = np.random.RandomState(0)
    seqs, masks, labels = [], [], []
    for _ in range(n):
        ln = rng.randint(6, S + 1)
        toks = rng.randint(1, vocab, size=(ln,))
        toks[0] = 2 + rng.randint(0, 10)
        seqs.append(toks.tolist() + [0] * (S - ln))
        masks.append([1] * ln + [0] * (S - ln))
        labels.append(int(toks[0] >= 7))
    df = DataFrame.fromPydict(
        {"input_ids": seqs, "attention_mask": masks, "label": labels},
        numPartitions=4)
    return df.randomSplit([0.75, 0.25], seed=1)


def config4(ctx):
    """The config-4 DataFrame fine-tune in the gang: whole batches of 16
    (the reference drops the partial tails), each rank its 8 rows, 30
    epochs of ``fit(bert_finetune_loss, with_rng=True)``; the held-out
    accuracy."""
    from sparkdl_tpu_torch.models import bert as B
    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.runner import adam
    from sparkdl_tpu_torch.runner.data import (FactoryDataset,
                                               record_batch_to_numpy)

    cfg = B.BertConfig.tiny()
    train_df, test_df = config4_frame(cfg.vocab_size)

    def batches():
        return (record_batch_to_numpy(rb) for rb in train_df.iterBatches(16)
                if rb.num_rows == 16)

    steps = 30 * sum(1 for _ in batches())
    model = B.BertForSequenceClassification(
        cfg, num_classes=2, attn_fn=fa.flash_attention, device=ctx.device,
        generator=torch.Generator().manual_seed(0))
    res = ctx.fit(loss_fn=B.bert_finetune_loss(model), model=model,
                  tx=adam(2e-3), data=FactoryDataset(batches, epochs=30,
                                                     shard=True),
                  num_steps=steps, with_rng=True, log_every=steps)
    assert res["state"].step == steps, res["state"].step
    rows = test_df.collect()
    ids = torch.tensor([r["input_ids"] for r in rows])
    msk = torch.tensor([r["attention_mask"] for r in rows])
    y = torch.tensor([r["label"] for r in rows])
    with torch.no_grad():
        return (model(ids, msk).argmax(-1) == y).float().mean().item()


def lora(ctx, in_dir):
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.runner.data import ListDataset

    variables = torch.load(os.path.join(in_dir, "lora_init.pt"),
                           weights_only=False)
    ids = np.load(os.path.join(in_dir, "lora.npz"))["ids"]
    model = L.load_flax_params(L.LlamaModel(
        L.LlamaConfig.tiny(lora_rank=4), attn_fn=fa.flash_attention,
        device=ctx.device), variables)
    res = ctx.fit(loss_fn=L.causal_lm_loss_fn(), model=model,
                  tx=L.lora_optimizer(5e-3),
                  data=ListDataset([{"input_ids": ids}] * 8, shard=True),
                  num_steps=8, log_every=1)
    return {"losses": [h["loss"] for h in res["history"]],
            "params": L.flax_params(model),
            "trainable": len(res["state"].trainable())}


class _Linear(torch.nn.Module):
    """``x @ w``: the reference's ``apply_fn`` over ``params["w"]``."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(w))

    def forward(self, x):
        return x @ self.w


def _sup_fit(device, out_dir, data, num_steps, checkpoint=False, **kw):
    """The supervised gangs' fit: a fresh 4×3 linear model from seed 0
    through ``runner.run``, so the ``worker`` chaos site fires first."""
    from sparkdl_tpu_torch.runner import (XlaRunner, sgd,
                                          softmax_cross_entropy_loss)

    runner = XlaRunner(device=device, checkpoint_dir=os.path.join(
        out_dir, "ckpt") if checkpoint else None)
    w = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    model = _Linear(w).to(runner.device)
    return runner.run(lambda c: c.fit(
        loss_fn=softmax_cross_entropy_loss(), model=model, tx=sgd(0.1),
        data=data, num_steps=num_steps, **kw)), model


def _generator_batches(rows):
    r = np.random.RandomState(1)
    while True:
        yield {"image": r.randn(rows, 4).astype(np.float32),
               "label": r.randint(0, 3, (rows,))}


def sup_linear(device, out_dir):
    res, model = _sup_fit(device, out_dir, _generator_batches(8), 4,
                          log_every=100)
    return {"step": int(res["state"].step),
            "w": model.w.detach().cpu().clone()}


def sup_rollback(device, out_dir):
    import json

    res, _ = _sup_fit(device, out_dir, _generator_batches(8), 6,
                      checkpoint=True, checkpoint_every=2, log_every=100)
    with open(os.path.join(out_dir, "attempts.jsonl"), "a") as f:
        f.write(json.dumps({"final_step": int(res["state"].step),
                            "steps_this_attempt": res["meter"].steps})
                + "\n")
    return {"step": int(res["state"].step)}


def sup_elastic(device, out_dir):
    import json

    from sparkdl_tpu_torch.runner.data import ListDataset

    batches = [{"image": np.random.RandomState(i).randn(12, 4)
                .astype(np.float32),
                "label": np.random.RandomState(i).randint(0, 3, (12,))}
               for i in range(12)]
    res, _ = _sup_fit(device, out_dir, ListDataset(batches, shard=True), 12,
                      checkpoint=True, checkpoint_every=2, log_every=1)
    rank = os.environ.get("SPARKDL_PROCESS_ID", "0")
    with open(os.path.join(out_dir, f"result_rank{rank}.jsonl"), "a") as f:
        f.write(json.dumps({
            "final_step": int(res["state"].step),
            "final_loss": float(res["history"][-1]["loss"]),
            "world": int(os.environ.get("SPARKDL_NUM_PROCESSES", "1"))})
            + "\n")
    return {"step": int(res["state"].step)}


def sup_resnet(device, out_dir):
    from sparkdl_tpu_torch.runner import (ListDataset, XlaRunner,
                                          bn_classifier_loss, events, sgd)

    # one algorithm choice in every process: the relaunch is held bitwise
    # against a clean run in another process
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(3)
    batches = [{"image": rng.uniform(0, 1, (8, 32, 32, 3))
                .astype(np.float32), "label": rng.integers(0, 10, 8)}
               for _ in range(6)]
    resumed = []
    events.add_tee(lambda rec: resumed.append(rec["step"])
                   if rec.get("name") == "train_resume" else None)
    runner = XlaRunner(device=device,
                       checkpoint_dir=os.path.join(out_dir, "ckpt"))
    model = _narrow_resnet().to(runner.device)
    res = runner.run(lambda c: c.fit(
        loss_fn=bn_classifier_loss(), model=model,
        tx=sgd(0.01, momentum=0.9), data=ListDataset(batches), num_steps=6,
        log_every=1, mutable=True, checkpoint_every=2))
    return {"state": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()},
            "step": int(res["state"].step), "resumed_at": resumed,
            "losses": [h["loss"] for h in res["history"]]}


SUPERVISED = {"sup_linear": sup_linear, "sup_rollback": sup_rollback,
              "sup_elastic": sup_elastic, "sup_resnet": sup_resnet}


def main():
    mode, in_dir, out_dir = sys.argv[1:4]
    device = sys.argv[4] if len(sys.argv) > 4 else "cpu"
    sys.path.insert(0, ROOT)
    torch.manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sparkdl_tpu_torch.runner import XlaRunner
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    runner = XlaRunner(device=device)
    ctx = runner.make_context()
    assert ctx.size == int(os.environ["SPARKDL_NUM_PROCESSES"]), ctx.size
    if mode == "linear":
        out = runner.run(lambda c: linear(c, in_dir))
    elif mode == "resnet":
        out = resnet(ctx, in_dir)
    elif mode == "fit":
        out = fit(ctx, in_dir, out_dir)
    elif mode == "bert":
        out = bert(ctx, in_dir, out_dir)
    elif mode == "bert_ref":
        out = bert_ref(in_dir)
    elif mode == "lora":
        out = lora(ctx, in_dir)
    elif mode in SUPERVISED:
        out = SUPERVISED[mode](device, out_dir)
    else:
        raise SystemExit(f"unknown mode {mode}")
    torch.save(out, os.path.join(out_dir, f"rank{ctx.rank}.pt"))
    leave_gang()


if __name__ == "__main__":
    main()
