"""Worker program of the port's sequence-parallel and sharding tests
(started by ``sparkdl_tpu_torch.runner.launcher.launch``; it holds no
test).

Every rank joins the gloo gang through ``XlaRunner(device="cpu")`` from
the launcher's ``SPARKDL_*`` env, runs every case of its mode and writes
what it computed to ``<out_dir>/rank<r>.pt`` (a dict of CPU tensors and
strings); the parent test holds that against the JAX package. It imports
only torch, numpy and the port. Inputs are drawn here with numpy from the
seeds the tests use (:func:`qkv`).

Usage: ``torch_parallel_worker.py <mode> <in_dir> <out_dir>``, ``mode``:

- ``parallel`` (8 ranks): ring attention and Ulysses on ``{"sp": 8}``
  (dense ×2, the gradient, bf16; Ulysses ×2, its gradient, the head
  divisibility check), the same through ``DTensor`` inputs, Ulysses with
  the flash kernel's plain version as its local attention on ``{"rep":
  2, "sp": 4}``, ring and Ulysses on the ``{"data": 2, "model": 2,
  "sp": 2}`` mesh from global and from ``DTensor`` inputs (and their
  gradients), ``make_mesh``'s
  refusals, ``shard_params`` of the reference tests' tree and of the
  tiny LoRA Llama of ``in_dir/llama_tiny.pt`` (flax parameters, carried
  across) on ``{"data": 4, "model": 2}``;
- ``generate`` (4 ranks): the tiny Llama of ``in_dir/llama_tiny.pt``
  generating ``in_dir/prompts.pt``'s prompts with ring attention over
  ``{"sp": 4}`` and with dense attention.
"""

import functools
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def qkv(seed=0, B=2, H=8, S=64, D=16):
    """The reference tests' inputs (``tests/test_parallel.py::_qkv``)."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, H, S, D).astype(np.float32) * 0.3)
            for _ in range(3)]


def qkv3(seed):
    """The 3-D composition tests' inputs: ``[4, 4, 32, 16]``."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(4, 4, 32, 16).astype(np.float32)
                             * 0.3) for _ in range(3)]


def refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def grads(attn, q, k, v):
    """(output, dq, dk, dv) of ``attn(q, k, v).sum()``."""
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    o = attn(q, k, v)
    o.sum().backward()
    return o.detach(), q.grad, k.grad, v.grad


def parallel_mode(in_dir: str) -> dict:
    from torch.distributed.tensor import Shard, distribute_tensor

    from sparkdl_tpu_torch.core.runtime import make_mesh
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.parallel import (lora_rules, ring_attention,
                                            shard_params, sharding_pytree,
                                            transformer_tp_rules,
                                            ulysses_attention)

    out = {}
    mesh = make_mesh({"sp": 8})
    for causal in (False, True):
        q, k, v = qkv()
        out[f"ring_{causal}"] = ring_attention(q, k, v, mesh, axis="sp",
                                               causal=causal)
        q, k, v = qkv(seed=3)
        out[f"ulysses_{causal}"] = ulysses_attention(q, k, v, mesh,
                                                     axis="sp", causal=causal)
    q, k, v = qkv(seed=1, S=32)
    o, *g = grads(lambda a, b, c: ring_attention(a, b, c, mesh, causal=True),
                  q, k, v)
    out["ring_grad"] = torch.stack(g)
    out["ring_grad_out"] = o
    o, *g = grads(lambda a, b, c: ulysses_attention(a, b, c, mesh,
                                                    causal=True), q, k, v)
    out["ulysses_grad"] = torch.stack(g)
    q, k, v = (x.to(torch.bfloat16) for x in qkv(seed=2))
    got = ring_attention(q, k, v, mesh, causal=True)
    out["ring_bf16_dtype"] = str(got.dtype)
    out["ring_bf16"] = got.float()
    out["ulysses_h6"] = refusal(lambda: ulysses_attention(
        *qkv(H=6), mesh))

    # DTensor inputs: the local block runs, a DTensor of the same layout
    # comes back; its gradient flows to the DTensor leaves
    q, k, v = qkv(seed=1, S=32)
    dq, dk, dv = (distribute_tensor(x, mesh, [Shard(2)]).requires_grad_(True)
                  for x in (q, k, v))
    got = ring_attention(dq, dk, dv, mesh, causal=True)
    out["dtensor_placements"] = str(tuple(got.placements))
    out["dtensor_local_shape"] = str(tuple(got.to_local().shape))
    got.sum().backward()
    out["dtensor_ring"] = got.full_tensor().detach()
    out["dtensor_ring_grad"] = torch.stack(
        [x.grad.full_tensor() for x in (dq, dk, dv)])

    # the flash kernel (its plain version on CPU tensors) as Ulysses's
    # local attention, on an 8-rank gang's {"rep": 2, "sp": 4}
    mesh4 = make_mesh({"rep": 2, "sp": 4})
    rng = np.random.RandomState(5)
    q, k, v = [torch.from_numpy(rng.randn(2, 4, 64, 16).astype(np.float32)
                                * 0.3) for _ in range(3)]
    out["ulysses_flash"] = ulysses_attention(
        q, k, v, mesh4, axis="sp", causal=True,
        local_attn=fa.flash_attention)
    out["ulysses_auto"] = ulysses_attention(q, k, v, mesh4, axis="sp",
                                            causal=True, local_attn="auto")

    # DP x TP x SP on one 3-D mesh, from global and from DTensor inputs
    mesh3 = make_mesh({"data": 2, "model": 2, "sp": 2})
    lay = [Shard(0), Shard(1), Shard(2)]
    for name, attn, seed in (("ring3", ring_attention, 9),
                             ("ulysses3", ulysses_attention, 11)):
        q, k, v = qkv3(seed)
        out[name] = attn(q, k, v, mesh3, axis="sp", causal=True,
                         batch_axis="data", head_axis="model")
        dq, dk, dv = (distribute_tensor(x, mesh3, lay) for x in (q, k, v))
        got = attn(dq, dk, dv, mesh3, axis="sp", causal=True,
                   batch_axis="data", head_axis="model")
        out[name + "_placements"] = str(tuple(got.placements))
        out[name + "_dtensor"] = got.full_tensor()
        _, *g = grads(lambda a, b, c: attn(
            a, b, c, mesh3, axis="sp", causal=True, batch_axis="data",
            head_axis="model"), q, k, v)
        out[name + "_grad"] = torch.stack(g)
    q, k, v = qkv3(11)
    out["ulysses3_h2"] = refusal(lambda: ulysses_attention(
        q[:, :2], k[:, :2], v[:, :2], mesh3, axis="sp",
        batch_axis="data", head_axis="model"))
    out["make_mesh_product"] = refusal(lambda: make_mesh({"sp": 4}))
    out["make_mesh_two_free"] = refusal(lambda: make_mesh({"a": -1,
                                                           "b": -1}))
    out["make_mesh_free"] = str(tuple(make_mesh({"data": 2, "sp": -1})
                                      .mesh.shape))

    # shard_params: the reference tests' tree, then the tiny LoRA Llama
    mesh_dm = make_mesh({"data": 4, "model": 2})
    tree = {"layer0": {
        "q_proj": {"kernel": np.zeros((64, 64)), "bias": np.zeros((64,))},
        "norm": {"scale": np.zeros((64,))}}}
    placed = shard_params(tree, mesh_dm, transformer_tp_rules())
    named = sharding_pytree(tree, mesh_dm, transformer_tp_rules())
    out["tree_q_kernel_placements"] = [
        str(tuple(placed["layer0"]["q_proj"]["kernel"].placements)),
        str(tuple(named["layer0"]["q_proj"]["kernel"].placements))]
    out["tree_q_kernel_local"] = str(tuple(
        placed["layer0"]["q_proj"]["kernel"].to_local().shape))
    out["tree_norm_local"] = str(tuple(
        placed["layer0"]["norm"]["scale"].to_local().shape))
    model = L.LlamaModel(L.LlamaConfig.tiny(lora_rank=4), device="cpu")
    L.load_flax_params(model, torch.load(os.path.join(in_dir,
                                                      "llama_tiny.pt"),
                                         weights_only=False))
    rules = lora_rules(transformer_tp_rules(data_axis="data", mesh=mesh_dm))
    placed = shard_params(model.state_dict(), mesh_dm, rules)
    for name, t in placed.items():
        out["llama_local/" + name] = t.to_local()
        out["llama_full/" + name] = t.full_tensor()
    return out


def generate_mode(in_dir: str) -> dict:
    from sparkdl_tpu_torch.core.runtime import make_mesh
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.parallel import ring_attention

    flax = torch.load(os.path.join(in_dir, "llama_tiny.pt"),
                      weights_only=False)
    prompts = torch.load(os.path.join(in_dir, "prompts.pt"))
    mesh = make_mesh({"sp": 4})
    cfg = L.LlamaConfig.tiny()
    out = {}
    for arm, attn in (("ring", functools.partial(ring_attention, mesh=mesh,
                                                 axis="sp")),
                      ("dense", None)):
        model = L.load_flax_params(L.LlamaModel(cfg, attn_fn=attn,
                                                device="cpu"), flax)
        out[arm] = L.generate(model, prompts["ids"], int(prompts["new"]))
    return out


def main(argv) -> int:
    mode, in_dir, out_dir = argv[1:4]
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from sparkdl_tpu_torch.runner import XlaRunner
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    runner = XlaRunner(device="cpu")
    rank = runner.gang.rank
    out = {"parallel": parallel_mode, "generate": generate_mode}[mode](
        in_dir)
    out = {k: v.detach().clone() if torch.is_tensor(v) else v
           for k, v in out.items()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    leave_gang()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
