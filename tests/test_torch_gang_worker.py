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
  implicit step, with ``remat`` too, and the explicit one; the refusals;
  ``put_replicated`` of a model drawn from this rank's own seed;
- ``fit``: ``ctx.fit(checkpoint_every=2)`` over a ``shard=True`` dataset,
  4 steps straight and 2 + a resume to 4, with the saves counted.
"""

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
    return {"w": model.weight.detach().T.clone(),
            "b": model.bias.detach().clone(),
            "losses": torch.tensor(losses),
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
    refusals = {}
    for name, kw, err in (
            ("explicit_accum", dict(explicit_collectives=True,
                                    accum_steps=2), ValueError),
            ("with_rng", dict(with_rng=True), NotImplementedError)):
        try:
            ctx.make_train_step(bn_classifier_loss(), **kw)
            refusals[name] = "did not raise"
        except err as e:
            refusals[name] = str(e)
    out["refusals"] = refusals
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
    else:
        raise SystemExit(f"unknown mode {mode}")
    torch.save(out, os.path.join(out_dir, f"rank{ctx.rank}.pt"))
    leave_gang()


if __name__ == "__main__":
    main()
