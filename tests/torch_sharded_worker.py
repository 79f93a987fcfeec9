"""Worker program of the port's sharded-training tests (started by
``sparkdl_tpu_torch.runner.launcher.launch``; it holds no test).

Every rank joins the gloo gang through ``XlaRunner(device="cpu")`` from
the launcher's ``SPARKDL_*`` env, runs every case of its mode and writes
what it computed to ``<out_dir>/rank<r>.pt``; the parent test holds that
against the JAX package. It imports only torch, numpy and the port (and
pyarrow for the DataFrame case). The flax parameters and inputs the cases
share with the parent come from ``in_dir``.

Usage: ``torch_sharded_worker.py <mode> <in_dir> <out_dir>``, ``mode``
(4 ranks each):

- ``fsdp``: the FSDP×TP step of the tiny Llama of ``in_dir/llama.pt``
  (flax parameters) on ``{"data": 2, "model": 2}`` (the shards' local
  shapes, the gathered parameters after one sgd step, the param_rules
  refusal), the same for the LoRA model against one process's step, the
  batch_spec truncation on ``{"data": 2, "sp": 2}`` (accum 1 and 2), the
  context's ``make_train_step(mesh=)`` (on the runner's default mesh and
  on ``XlaRunner(axes=)``'s), and the checkpoint resharding
  cases (world 4 → 2 → 1 and 2 → 4 on ``data`` sub-meshes, a tp 4 → 2
  serving layout, the refusal without ``SPARKDL_ELASTIC``, the same
  topology, a placed Llama's state through save and restore);
- ``expert_pipe``: ``SwitchMoE`` of ``in_dir/moe.pt`` on ``{"ep": 4}``
  (output, the gathered gradients, the specs), GPipe on ``{"pp": 4}``
  (output, the stacked gradients, with and without remat), the sharded
  ``BatchRunner`` on ``{"data": 4}`` (and ``donate``), and
  ``XlaImageTransformer(numDevices=-1 / 99)`` over ``in_dir/imgs.pt``.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def refusal(fn, exc=Exception) -> str:
    try:
        fn()
    except exc as e:
        return f"{type(e).__name__}: {e}"
    return ""


# --- fsdp mode ---------------------------------------------------------------

def ckpt_tree(value=None, seed=0):
    """``tests/test_checkpoint.py::TestElasticReshard._tree``: an 8x4
    kernel, a 4-dim bias, a 6x4 table (6 splits at 2 and 1, not at 4)."""
    rng = np.random.RandomState(seed)

    def leaf(*shape):
        if value is not None:
            return np.full(shape, value, np.float32)
        return rng.randn(*shape).astype(np.float32)

    return {"dense": {"kernel": leaf(8, 4), "bias": leaf(4)},
            "table": {"kernel": leaf(6, 4)}}


class Tree(torch.nn.Module):
    """The tree as a module: parameters named ``dense.kernel`` etc."""

    def __init__(self, tree):
        super().__init__()
        for group, leaves in tree.items():
            m = torch.nn.Module()
            for k, v in leaves.items():
                setattr(m, k, torch.nn.Parameter(torch.as_tensor(v)))
            setattr(self, group, m)


def data_mesh(n):
    """A ``{"data": n}`` sub-mesh of the 4-rank gang (``rep`` beside)."""
    from sparkdl_tpu_torch.core.runtime import make_mesh
    if n == 4:
        return make_mesh({"data": 4})
    return make_mesh({"rep": 4 // n, "data": n})["data"]


def placed_tree(mesh, value=None, rules=None):
    from sparkdl_tpu_torch.parallel import fsdp, fsdp_rules
    from sparkdl_tpu_torch.runner.train_state import TrainState, sgd
    rules = fsdp_rules(mesh=mesh) if rules is None else rules
    from sparkdl_tpu_torch.parallel import divisible_rules
    m = fsdp.shard_module(Tree(ckpt_tree(value)), mesh,
                          divisible_rules(rules, mesh))
    return TrainState.create(m, sgd(0.1))


def checkpoint_cases(out, base: str, group):
    from sparkdl_tpu_torch.parallel import (divisible_rules, fsdp,
                                            fsdp_rules, serving_tp_layout)
    from sparkdl_tpu_torch.runner.checkpoint import (CheckpointManager,
                                                     CheckpointTopologyError)

    def save(d, n):
        st = placed_tree(data_mesh(n))
        m = CheckpointManager(d, async_save=False, group=group)
        m.save(3, st, wait=True)
        m.close()

    def restore(d, n, **kw):
        mesh = data_mesh(n)
        st = placed_tree(mesh, value=0.0)
        m = CheckpointManager(d, group=group)
        m.restore(st, mesh=mesh, rules=fsdp_rules(mesh=mesh), **kw)
        m.close()
        return st

    def record(key, st):
        out[key] = fsdp.full_state_dict(st.model)
        pl = fsdp.placement(st.model)
        out[key + "/mesh"] = pl.mesh_shape()
        out[key + "/local"] = {n: tuple(p.shape)
                               for n, p in pl.locals.items()}
        out[key + "/step"] = st.step

    shrink = os.path.join(base, "shrink")
    save(shrink, 4)
    os.environ["SPARKDL_ELASTIC"] = "1"
    for n in (2, 1):
        record(f"ckpt_shrink_{n}", restore(shrink, n))
    grow = os.path.join(base, "grow")
    save(grow, 2)
    record("ckpt_grow_4", restore(grow, 4))
    # the serving layout: a tp = 4 state restored on tp = 2
    tp = os.path.join(base, "tp")
    rng = np.random.RandomState(7)
    tree = {p: {"weight": rng.randn(8, 8).astype(np.float32)}
            for p in ("q_proj", "o_proj", "up_proj", "down_proj")}
    out["tp_tree"] = tree
    from sparkdl_tpu_torch.core.runtime import make_mesh
    from sparkdl_tpu_torch.runner.train_state import TrainState, sgd
    mesh4 = make_mesh({"tp": 4})
    st = TrainState.create(fsdp.shard_module(
        Tree(tree), mesh4, divisible_rules(serving_tp_layout(4).rules,
                                           mesh4)), sgd(0.1))
    m = CheckpointManager(tp, async_save=False, group=group)
    m.save(1, st, wait=True)
    m.close()
    mesh2 = make_mesh({"rep": 2, "tp": 2})["tp"]
    rules2 = serving_tp_layout(2).rules
    st2 = TrainState.create(fsdp.shard_module(
        Tree({k: {"weight": np.zeros((8, 8), np.float32)} for k in tree}),
        mesh2, divisible_rules(rules2, mesh2)), sgd(0.1))
    m = CheckpointManager(tp, group=group)
    m.restore(st2, mesh=mesh2, rules=rules2)
    m.close()
    record("ckpt_tp_2", st2)
    # the refusal, then the same topology, without the flag
    del os.environ["SPARKDL_ELASTIC"]
    out["ckpt_refusal"] = refusal(lambda: restore(shrink, 2, step=3),
                                  CheckpointTopologyError)
    record("ckpt_same_4", restore(shrink, 4))


def llama_step(L, flax, cfg, ids, mesh, tx, **kw):
    """One sharded step and one one-process step (``kw``: the steps'
    ``remat`` / ``accum_steps``) of the carried-across model: the
    gathered params after the sharded step, its loss, the local shapes
    and specs, the one-process params and loss, the collectives."""
    from sparkdl_tpu_torch.parallel import fsdp
    from sparkdl_tpu_torch.runner.train_state import (TrainState,
                                                      make_train_step)
    glob = L.load_flax_params(L.LlamaModel(cfg, device="cpu"), flax)
    local = L.shard_model(glob, mesh)
    st = TrainState.create(local, tx)
    step = make_train_step(L.causal_lm_loss_fn(), mesh=mesh,
                           param_rules=L.training_rules(mesh), **kw)
    fsdp.reset_collectives()
    saved = []

    def pack(t):
        # (a view of) a gathered weight kept for the backward?
        b = t if t._base is None else t._base
        saved.append(getattr(b, "sparkdl_shard", None) is not None)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _, m = step(st, {"input_ids": ids})
    colls = dict(fsdp.COLLECTIVES)
    ref = TrainState.create(glob, tx)
    _, mr = make_train_step(L.causal_lm_loss_fn(), **kw)(
        ref, {"input_ids": ids})
    pl = fsdp.placement(local)
    return {"params": fsdp.full_state_dict(local), "loss": m["loss"],
            "local": {n: tuple(p.shape) for n, p in pl.locals.items()},
            "specs": {n: str(s) for n, s in pl.specs.items()},
            "one_process": {k: v.detach().clone()
                            for k, v in glob.state_dict().items()},
            "one_process_loss": mr["loss"], "collectives": colls,
            "saved": len(saved), "saved_gathered": sum(saved)}


def fsdp_mode(in_dir: str, out_dir: str, runner) -> dict:
    from sparkdl_tpu_torch.core.runtime import make_mesh
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.parallel import P, fsdp
    from sparkdl_tpu_torch.runner.train_state import (TrainState,
                                                      make_train_step, sgd)

    out = {}
    flax = torch.load(os.path.join(in_dir, "llama.pt"), weights_only=False)
    ids = torch.as_tensor(torch.load(os.path.join(in_dir, "ids.pt"), weights_only=False))
    mesh = make_mesh({"data": 2, "model": 2})
    out["full"] = llama_step(L, flax, L.LlamaConfig.tiny(), ids, mesh,
                             sgd(1e-2))
    out["remat_accum"] = llama_step(L, flax, L.LlamaConfig.tiny(), ids,
                                    mesh, sgd(1e-2), remat=True,
                                    accum_steps=2)
    out["lora"] = llama_step(L, torch.load(
        os.path.join(in_dir, "llama_lora.pt"), weights_only=False),
        L.LlamaConfig.tiny(lora_rank=4), ids, mesh, L.lora_optimizer(1e-2))
    # param_rules pin the layout: a model placed otherwise is refused
    glob = L.load_flax_params(L.LlamaModel(L.LlamaConfig.tiny(),
                                           device="cpu"), flax)
    other = L.shard_model(glob, mesh, rules=lambda p, leaf: P())
    step = make_train_step(L.causal_lm_loss_fn(), mesh=mesh,
                           param_rules=L.training_rules(mesh))
    out["rules_refusal"] = refusal(lambda: step(
        TrainState.create(other, sgd(1e-2)), {"input_ids": ids}),
        ValueError)
    # the context's step over the runner's {"data": 4} mesh: FSDP alone
    from sparkdl_tpu_torch.runner.xla_runner import RunnerContext
    ctx = RunnerContext(device=torch.device("cpu"), gang=runner.gang)
    dmesh = ctx.mesh
    local = L.shard_model(glob, dmesh)
    st = TrainState.create(local, sgd(1e-2))
    _, m = ctx.make_train_step(L.causal_lm_loss_fn(), param_rules=L.
                               training_rules(dmesh))(st,
                                                      {"input_ids": ids})
    out["ctx_loss"] = m["loss"]
    out["ctx_params"] = fsdp.full_state_dict(local)
    out["ctx_mesh"] = fsdp.placement(local).mesh_shape()
    # XlaRunner(axes=) names the context's mesh: the FSDP×TP step over
    # {"data": 2, "model": 2} through the context alone
    from sparkdl_tpu_torch.runner import XlaRunner
    actx = XlaRunner(axes={"data": 2, "model": 2},
                     device="cpu").make_context()
    local = L.shard_model(L.load_flax_params(
        L.LlamaModel(L.LlamaConfig.tiny(), device="cpu"), flax), actx.mesh)
    st = TrainState.create(local, sgd(1e-2))
    _, m = actx.make_train_step(L.causal_lm_loss_fn(), param_rules=L.
                                training_rules(actx.mesh))(
        st, {"input_ids": ids})
    out["axes_loss"] = m["loss"]
    out["axes_params"] = fsdp.full_state_dict(local)
    out["axes_mesh"] = [fsdp.placement(local).mesh_shape(), actx.data_axis]

    # batch_spec: one spec truncated to each leaf's rank
    smesh = make_mesh({"data": 2, "sp": 2})

    class W(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(2.0))

    def loss_fn(model, batch):
        per_tok = (batch["x"] * model.w).mean(dim=1)
        return (per_tok * batch["weight"]).mean(), {}

    batch = torch.load(os.path.join(in_dir, "spec_batch.pt"),
                       weights_only=False)
    for accum in (1, 2):
        st = TrainState.create(W(), sgd(0.1))
        step = make_train_step(loss_fn, mesh=smesh, data_axis="data",
                               batch_spec=P("data", "sp"),
                               accum_steps=accum)
        _, m = step(st, {k: torch.as_tensor(v) for k, v in batch.items()})
        out[f"spec_loss_{accum}"] = m["loss"]
        out[f"spec_w_{accum}"] = st.model.w.detach().clone()

    # checkpoints across meshes (rank 0's directory)
    base = os.path.join(out_dir, "ckpt")
    checkpoint_cases(out, base, runner.gang.host_group)
    # a placed Llama's state through save and restore (sgd with momentum:
    # the optimizer state is gathered and laid out again too)
    from sparkdl_tpu_torch.runner.checkpoint import CheckpointManager
    from sparkdl_tpu_torch.runner.train_state import sgd as sgd_
    st = TrainState.create(L.shard_model(glob, mesh), sgd_(1e-2, 0.9))
    make_train_step(L.causal_lm_loss_fn(), mesh=mesh)(st,
                                                      {"input_ids": ids})
    d = os.path.join(base, "llama")
    out["llama_ckpt_no_group"] = refusal(lambda: CheckpointManager(
        os.path.join(base, "no_group")).save(1, st), ValueError)
    man = CheckpointManager(d, async_save=False,
                            group=runner.gang.host_group)
    man.save(1, st, wait=True)
    fresh = TrainState.create(L.shard_model(
        L.LlamaModel(L.LlamaConfig.tiny(), device="cpu"), mesh),
        sgd_(1e-2, 0.9))
    man.restore(fresh, mesh=mesh, rules=L.training_rules(mesh))
    man.close()
    out["llama_ckpt_equal"] = all(
        torch.equal(a, b) for a, b in zip(
            fsdp.full_state_dict(st.model).values(),
            fsdp.full_state_dict(fresh.model).values()))
    so, fo = (fsdp.full_optimizer_state(s.optimizer, s.model)["state"]
              for s in (st, fresh))
    out["llama_ckpt_opt_equal"] = len(so) > 0 and all(
        torch.equal(so[i]["momentum_buffer"], fo[i]["momentum_buffer"])
        for i in so)
    out["llama_ckpt_step"] = fresh.step
    if runner.gang.rank == 0:
        import json
        with open(os.path.join(d, "manifest_step_1.json")) as f:
            out["llama_manifest_topology"] = json.load(f)["topology"]
    return out


# --- expert_pipe mode ----------------------------------------------------------

def expert_pipe_mode(in_dir: str, out_dir: str, runner) -> dict:
    from torch.distributed.tensor import DTensor

    from sparkdl_tpu_torch.core.runtime import BatchRunner, make_mesh
    from sparkdl_tpu_torch.parallel import (describe, gpipe, moe_rules,
                                            stack_stage_params,
                                            stage_sharding)
    from sparkdl_tpu_torch.parallel import moe as M

    out = {}
    # SwitchMoE on {"ep": 4}: each rank one of the four experts
    cfg = torch.load(os.path.join(in_dir, "moe.pt"), weights_only=False)
    x = torch.as_tensor(cfg["x"])
    mesh = make_mesh({"ep": 4})
    glob = M.load_flax_params(M.SwitchMoE(8, 4, 32, capacity_factor=4.0,
                                          device="cpu"), cfg["params"])
    local = M.shard_moe(glob, mesh)
    out["moe_local_wi"] = tuple(local.experts.wi.kernel.shape)
    out["moe_specs"] = describe(dict(glob.state_dict()), moe_rules())
    inter = {}
    y = local(x, intermediates=inter)
    (y ** 2).sum().backward()
    out["moe_out"] = y.detach()
    out["moe_aux"] = M.moe_aux_loss(inter)
    grads = {}
    for name, p in local.named_parameters():
        g = p.grad
        if name.startswith("experts."):
            parts = [torch.empty_like(g) for _ in range(4)]
            torch.distributed.all_gather(parts, g.contiguous(),
                                         group=mesh.get_group("ep"))
            g = torch.cat(parts)
        grads[name] = g
    out["moe_grads"] = grads

    # GPipe on {"pp": 4}: a tanh stage per rank
    pcfg = torch.load(os.path.join(in_dir, "pipe.pt"), weights_only=False)
    pmesh = make_mesh({"pp": 4})

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    stages = [{k: torch.as_tensor(v) for k, v in s.items()}
              for s in pcfg["stages"]]
    for remat in (True, False):
        stacked = stage_sharding(pmesh, stack_stage_params(stages), "pp")
        for leaf in stacked.values():
            leaf.requires_grad_(True)
        apply = gpipe(stage_fn, pmesh, "pp", remat=remat)
        y = apply(stacked, torch.as_tensor(pcfg["x"]))
        out[f"pipe_out_{remat}"] = y.detach()
        xg = torch.as_tensor(pcfg["x_grad"])
        (apply(stacked, xg) ** 2).sum().backward()
        out[f"pipe_grads_{remat}"] = {
            k: v.grad.full_tensor() for k, v in stacked.items()}
        assert all(isinstance(v.grad, DTensor) for v in stacked.values())
    out["pipe_placements"] = str(tuple(stacked["w"].placements))

    # the sharded feed: {"data": 4}, every rank the whole output
    feed = torch.load(os.path.join(in_dir, "feed.pt"), weights_only=False)
    dmesh = make_mesh({"data": 4})

    def fn(b):
        return {"sum": b.sum(dim=(1, 2)), "max": b.amax(dim=1)}

    for name, kw in (("single", {}), ("mesh", {"mesh": dmesh}),
                     ("mesh_donate", {"mesh": dmesh, "donate": True})):
        r = BatchRunner(fn, 6, device="cpu", input_cast=torch.float32,
                        **kw)
        out[f"feed_{name}"] = [o for o in r.run(feed)]
        out[f"feed_{name}_batch"] = r.batch_size

    # XlaImageTransformer over the gang's devices
    import sparkdl_tpu_torch as tdl
    import pyarrow as pa
    from sparkdl_tpu_torch.image import imageIO
    imgs = torch.load(os.path.join(in_dir, "imgs.pt"), weights_only=False)
    structs = [imageIO.imageArrayToStruct(im, origin=f"mem://{i}")
               for i, im in enumerate(imgs)]
    df = tdl.DataFrame.fromArrow(pa.table(
        {"image": pa.array(structs, type=imageIO.imageSchema)}),
        numPartitions=2)

    def mean_fn(b):
        return b.mean(dim=(1, 2))

    for n in (1, -1):
        t = tdl.XlaImageTransformer(inputCol="image", outputCol="f",
                                    fn=mean_fn, inputSize=(8, 8),
                                    batchSize=4, numDevices=n, device="cpu")
        out[f"image_{n}"] = np.stack([r.f for r in t.transform(df)
                                      .collect()])
        out[f"image_{n}_batch"] = t._get_runner().batch_size
    out["image_99"] = refusal(lambda: tdl.XlaImageTransformer(
        inputCol="image", outputCol="f", fn=mean_fn, inputSize=(8, 8),
        numDevices=99, device="cpu").transform(df), ValueError)
    return out


def main(argv) -> int:
    mode, in_dir, out_dir = argv[1:4]
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from sparkdl_tpu_torch.runner import XlaRunner
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    runner = XlaRunner(device="cpu")
    rank = runner.gang.rank
    out = {"fsdp": fsdp_mode, "expert_pipe": expert_pipe_mode}[mode](
        in_dir, out_dir, runner)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    leave_gang()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
