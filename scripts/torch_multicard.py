#!/usr/bin/env python3
"""Drive the port's multi-rank paths on four CUDA cards over NCCL.

The port's counterpart of ``scripts/tp_serving_record.py`` and
``__graft_entry__.py::dryrun_multichip``: one gang of four ranks
(``runner.launcher.launch``, rank r on ``cuda:r``) runs legs 0–8 below in
order, then the parent runs the fleets (legs 9–10), each against a
one-card or one-process reference from the same run; every failed check
raises, so the exit code is not 0. Run from the
root of a checkout on a host with four cards::

    python3 scripts/torch_multicard.py [--legs comms,dp_resnet50,...]

and on the CPU, as a four-rank gloo gang at tiny widths and the fleets'
one- and two-rank gloo gangs (what ``tests/test_torch_multicard.py``
runs)::

    python3 scripts/torch_multicard.py --device cpu --tiny

With fewer than four cards it prints why and exits 2, before any leg.
Nothing falls back to the CPU: the CPU is reached only through
``--device cpu --tiny``.

Legs (widths full on the card; depths cut as ``chip_smoke.py`` cuts them):

0. ``comms``: every collective the port issues (``all_reduce`` sum and
   max, ``broadcast``, ``all_gather_into_tensor``,
   ``reduce_scatter_tensor``, ``all_to_all_single``, a
   ``batch_isend_irecv`` ring), once each, held exactly to the same sum or
   permutation computed on the host; then the bus bandwidth of an
   ``all_reduce`` and an ``all_gather`` of 256 MB (CUDA events, the mean
   of 10 after a warm-up).
1. ``dp_resnet50``: BASELINE config 3 through the gang's implicit step
   (synchronised BatchNorm, one flat gradient all-reduce): ResNet-50,
   bf16, 224², 256 images a rank, sgd(0.1, momentum=0.9); step ms
   (median, p10, p90), img/s/chip and each card's peak memory, beside
   the same run as a one-rank gang on ``cuda:0`` after the gang. Parity:
   ResNet18 (10 classes, 32², f32, TF32 off), 8 global rows over four
   ranks, one step, against one process's step on the 8 rows. A fit
   checkpointed on rank 0 and resumed repeats the straight fit bitwise.
2. ``dp_m``: BASELINE configs 4 and 5. BERT-base (bf16, dropout through
   ``utils.rng.RowWindow``, 8 rows a rank of phase h's batches): step
   ms and the flash kernels' launches; in f32 at depth 2 one step against
   one process's step on the global batch (``GRAD_SHARE`` of the largest
   gradient, ``LOSS_RTOL``). The LoRA fine-tune at llama3_8b widths,
   depth 4, one row of 2048 a rank: ``put_replicated``'s broadcast timed,
   the losses against one process's fit of the global batch.
3. ``tp_serve``: llama3_8b widths at depth 8, bf16, phase u's 8 prompts;
   the one-device engine (tp 1 on each card), tp 2 (two groups, ranks
   0-1 and 2-3) and tp 4, paged and unpaged. Kernel launches = head-sharded
   dispatches = layers × steps; each rank's KV pool bytes 1/tp of tp 1's;
   one capture of the decode step (its NCCL collectives inside) and a
   replay for every later step. Streams held by the top-2 rule (below)
   to the model, and counted against ``generate()``; in f32 (TF32 off, a
   depth-2 model at full head_dim) the same at tp 1/2/4. Then
   ``tp_front``: the tp 4 engine started, four client threads on rank 0.
4. ``fsdp_tp_train``: ``{"data": 2, "model": 2}``, llama3_8b widths at
   depth 4, 2 × 2048 tokens, sgd, 3 steps, against the unsharded step on
   one card; the collectives a step against ``fsdp_collectives``; in f32
   at depth 2 one step held to ``FSDP_LOSS_RTOL`` / ``FSDP_UPDATE_SHARE``.
   ``sharded_ckpt``: the state saved on 2 × 2 and restored bitwise on
   ``{"data": 4, "model": 1}`` and ``{"data": 1, "model": 4}``.
5. ``sp``: Ulysses on ``{"sp": 4}`` at (1, 32, 16384, 128), causal, bf16,
   forward and backward, against the bare flash kernel on one card;
   ``ring_generate`` at llama3_8b widths, depth 2, 2 × 4096 tokens, its
   last prefill logits against the flash prefill's.
6. ``moe``: Switch MoE at Switch-Base-8's widths, 8 × 512 tokens, bf16,
   on ``{"ep": 4}`` (2 experts a rank) against the unsharded module on
   each card: the output and every gradient bitwise, or within
   ``SHARD_SHARE``; the collectives a step.
7. ``gpipe``: four llama3_8b-width ``LlamaLayer``s on ``{"pp": 4}``, 4
   microbatches of 1 × 2048, bf16, the flash kernels, remat off and on:
   the forward bitwise the four blocks applied in turn on one card, each
   stage's gradient likewise (or within ``SHARD_SHARE``); M + P − 1 = 7
   flash launches a rank a pass, a hop a tick each way.
8. ``batch_runner_mesh``: the ResNet50 featurizer (bf16, 224²) with
   ``numDevices`` 4 (``BatchRunner`` on ``{"data": 4}``), 16 batches of
   256: the gathered output bitwise the one-card runner at the rank's 64
   rows; rows/s beside one card's at 256; each rank's host stage ms.

Then, from this process once the gang has ended, two fleets whose
groups are gangs of their own on cards of their own
(``launch(env={"CUDA_VISIBLE_DEVICES": ...})``, this script with
``--fleet-worker``), behind one ``EngineFleet`` over ``RemoteEngine``
proxies, with ``chip_smoke.py``'s phase w legs and checks (four clients,
every stream delivered exactly once, held to the clean engine's):

9. ``fleet_groups``: phase w's three one-rank groups on cards 1, 2, 3;
   a clean leg, group a drained, group b SIGKILLed.
10. ``fleet_tp_groups``: two tp-2 groups on cards 0-1 and 2-3 (phase
    u's paged llama3_8b at depth 8); a clean leg, then group b's
    follower SIGKILLed: b's gang fails, b goes DEAD, its requests finish
    on a.

The top-2 rule: a stream is fed to the model (one forward over prompt
and stream, dense attention); wherever a token is not that forward's
argmax, the top-2 gap there must be within 10 × the arm's tolerance
(bf16: 10 × 2^-6 × (1 + max |logit|), chip_smoke.py's; f32: 10 ×
``LOGIT_TOL``).

Output: one JSON line a leg, then ``{"phase_walls": {...}}``, then
``{"ok": true, "device": {...}}``; the whole record goes to ``--out``
(default ``chiprun_out/torch_multicard.json``). Imports torch, numpy,
the port and ``chip_smoke`` (for its constants and pure helpers); no
JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402  (constants and pure helpers)

WORLD = 4
# the gang's legs, then the fleets' (run from the parent after the gang)
GANG_LEGS = ("comms", "dp_resnet50", "dp_m", "tp_serve", "fsdp_tp_train",
             "sp", "moe", "gpipe", "batch_runner_mesh")
FLEET_LEGS = ("fleet_groups", "fleet_tp_groups")
LEGS = GANG_LEGS + FLEET_LEGS
T_START = time.perf_counter()
GANG_TIMEOUT_S = 600.0  # the gang's limit: its legs take ~250 s on four H100s
# dp_m's parity: tests/test_torch_dp_dropout.py's limits (the gang
# averages four rank means where one process takes one mean, and the
# products run at 8 rows instead of 32)
GRAD_SHARE, LOSS_RTOL = 2e-6, 1e-6
# dp_resnet50's parity on the CPU: tests/test_torch_dp.py's shares
TINY_PARAM_SHARE, TINY_STAT_SHARE = 5e-4, 1e-4
# fsdp_tp_train's f32 parity: the sharded step sums each row-parallel
# product's two halves and each gradient's two data shards where one card
# sums them in one product, so the two differ in f32 summation order
# alone: the loss within FSDP_LOSS_RTOL relative, each parameter within
# one f32 rounding of its value (the update p - lr·g rounds once, so a
# gradient one rounding off moves p by a whole step of p's own) plus
# FSDP_UPDATE_SHARE of the largest change the unsharded step made
FSDP_LOSS_RTOL, FSDP_UPDATE_SHARE = 1e-5, 1e-4
FSDP_PARITY_LAYERS = 2
# tp_serve's f32 streams: llama3_8b widths at this depth
TP_F32_LAYERS = 2
BUSBW_ITERS = 10
# moe and gpipe: where the sharded arm is not bitwise the one-card arm,
# each tensor within this share of its largest |value| (bf16: two
# roundings of a product whose cuBLAS kernel differs; f32 on the CPU:
# tests/test_torch_moe_pipeline.py's atol against the unsharded module)
SHARD_SHARE = {"bfloat16": 2.0 ** -7, "float32": 1e-6}
# batch_runner_mesh: seeded uint8 batches of 4 × 64 rows at 224²
RUNNER_BATCHES = 16


def sizes(tiny: bool) -> SimpleNamespace:
    """Every leg's shapes: full on the card, tiny for the CPU gang."""
    if not tiny:
        return SimpleNamespace(
            tiny=False, comms_mb=256, resnet="ResNet50",
            resnet_batch=C.RESNET_BATCH, resnet_size=C.RESNET_SIZE,
            resnet_warmup=C.RESNET_WARMUP, resnet_timed=C.RESNET_TIMED,
            parity_model="ResNet18", parity_batch=C.RESNET_PARITY_BATCH,
            parity_shares=(C.RESNET_PARITY_PARAM_SHARE,
                           C.RESNET_PARITY_STAT_SHARE),
            bert="base", bert_warmup=C.DP_BERT_WARMUP,
            bert_timed=C.DP_BERT_TIMED, bert_parity_layers=2,
            lora_layers=C.DP_LORA_LAYERS, lora_rows=WORLD,
            lora_seq=C.TRAIN_SEQ, lora_steps=C.DP_LORA_STEPS,
            tp_layers=C.TP_LAYERS, tp_f32_layers=TP_F32_LAYERS,
            tp_new=C.TP_NEW, tp_chunk=C.TP_CHUNK, tp_slots=C.TP_SLOTS,
            tp_max_len=C.TP_PROMPT_LENS[1] + C.TP_NEW,
            fsdp_layers=C.FSDP_LAYERS, fsdp_steps=C.FSDP_STEPS,
            fsdp_parity_layers=FSDP_PARITY_LAYERS, train_batch=2,
            train_seq=C.TRAIN_SEQ, ulysses=C.ULYSSES_SHAPE,
            ring_layers=C.RING_LAYERS, ring_prompts=C.RING_PROMPTS,
            ring_len=C.RING_LEN, ring_new=C.RING_NEW,
            moe=(C.MOE_D, C.MOE_FF, C.MOE_E, C.MOE_CF),
            moe_tokens=(C.MOE_BATCH, C.MOE_SEQ),
            gpipe_micro=C.GPIPE_MICRO, gpipe_seq=C.GPIPE_SEQ,
            runner_model="ResNet50", runner_dtype="bfloat16",
            runner_batch=C.RUNNER_BATCH * WORLD,
            runner_batches=RUNNER_BATCHES, runner_size=224,
            fleet_layers=C.TP_LAYERS, fleet_block=16)
    return SimpleNamespace(
        tiny=True, comms_mb=1, resnet="narrow", resnet_batch=4,
        resnet_size=32, resnet_warmup=1, resnet_timed=2,
        parity_model="narrow", parity_batch=8,
        parity_shares=(TINY_PARAM_SHARE, TINY_STAT_SHARE), bert="tiny",
        bert_warmup=1, bert_timed=2, bert_parity_layers=2, lora_layers=2,
        lora_rows=WORLD, lora_seq=16, lora_steps=2, tp_layers=2,
        tp_f32_layers=2, tp_new=8, tp_chunk=8, tp_slots=4, tp_max_len=64,
        fsdp_layers=C.FSDP_LAYERS, fsdp_steps=2, fsdp_parity_layers=2,
        train_batch=2, train_seq=16, ulysses=(1, 4, 64, 32), ring_layers=2,
        ring_prompts=2, ring_len=32, ring_new=4, moe=(16, 32, 8, 1.25),
        moe_tokens=(2, 16), gpipe_micro=C.GPIPE_MICRO, gpipe_seq=16,
        runner_model="ResNet18", runner_dtype="float32", runner_batch=WORLD,
        runner_batches=2, runner_size=32, fleet_layers=2, fleet_block=8)


# --- helpers ------------------------------------------------------------------

def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gb(torch, dev):
    if dev.type != "cuda":
        return "not measured"
    return torch.cuda.max_memory_allocated(dev) / 1e9


def free(torch, dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def smi_lines() -> list:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()


def event_ms(torch, dev, fn, iters: int, warmup: int = 1) -> float:
    """Mean ms of ``fn`` over ``iters`` calls: CUDA events on the card,
    the host clock around synced calls on the CPU."""
    for _ in range(warmup):
        fn()
    sync(torch, dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize(dev)
    return s.elapsed_time(e) / iters


def count_plain_calls(kernels) -> None:
    """On the CPU a wrapper runs its kernel's plain version and counts
    nothing; the CPU gang counts each plain call into the wrapper's
    ``launches`` instead, so the legs' launch checks run there too."""
    fa, fd, pfd = kernels
    for mod, name, wrapper in (
            (fa, "attention_plain", fa.flash_attention_fwd),
            (fa, "attention_bwd_plain", fa.flash_attention_bwd),
            (fd, "flash_decode_plain", fd.flash_decode),
            (pfd, "paged_flash_decode_plain", pfd.paged_flash_decode)):
        plain = getattr(mod, name)

        def counted(*a, _plain=plain, _w=wrapper, **k):
            _w.launches += 1
            return _plain(*a, **k)
        setattr(mod, name, counted)


def near_tie_rule(torch, model, prompts: list, streams: list,
                  gate) -> dict:
    """The top-2 rule (module docstring): ``gate(logits)`` gives each
    position's limit on the gap where a stream leaves the argmax of
    ``model`` (dense attention) fed that stream."""
    attn = model.attn_fn
    model.attn_fn = None
    compared, flips = 0, []
    try:
        for r, (p, st) in enumerate(zip(prompts, streams)):
            with torch.no_grad():
                logits = model(torch.tensor([p + st], device=model.device))[
                    0, len(p) - 1:len(p) - 1 + len(st)].float()
            top2 = logits.topk(2, dim=-1).values
            gaps = (top2[:, 0] - top2[:, 1]).tolist()
            gates = gate(logits).tolist()
            want = logits.argmax(-1).tolist()
            del logits
            for j, (t, w) in enumerate(zip(st, want)):
                compared += 1
                if t != w:
                    assert gaps[j] <= gates[j], (
                        f"prompt {r}: the stream leaves the argmax at "
                        f"position {j} with a top-2 gap of {gaps[j]} > "
                        f"{gates[j]}")
                    flips.append(dict(prompt=r, position=j, gap=gaps[j],
                                      gate=gates[j]))
    finally:
        model.attn_fn = attn
    return dict(positions_compared=compared, near_tie_flips=flips)


def bf16_gate(logits):
    return 10 * C.BF16_LOGIT_RTOL * (1 + logits.abs().amax(-1))


def f32_gate(logits):
    return logits.new_full(logits.shape[:1], 10 * C.LOGIT_TOL)


def build_llama(torch, L, cfg, dtype, dev, seed: int, attn_fn="auto"):
    return L.LlamaModel(cfg, dtype=dtype, attn_fn=attn_fn, device=dev,
                        generator=torch.Generator(device=dev)
                        .manual_seed(seed))


def llama_cfg(L, S, layers: int, **kw):
    if S.tiny:  # 4 KV heads, so the model axis can take all four ranks
        return dataclasses.replace(L.LlamaConfig.tiny(**kw),
                                   num_layers=layers, num_kv_heads=4)
    return dataclasses.replace(L.LlamaConfig.llama3_8b(**kw),
                               num_layers=layers)


def same_on_ranks(torch, ctx, values: list) -> bool:
    """Whether every rank holds the same float ``values`` (a gloo
    all-gather on the host group)."""
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.float64)
    out = [torch.empty_like(t) for _ in range(ctx.size)]
    dist.all_gather(out, t, group=ctx.gang.host_group)
    return all(torch.equal(o, out[0]) for o in out)


# --- leg 0: comms --------------------------------------------------------------

def leg_comms(torch, ctx, S, kernels, root: str) -> dict:
    import numpy as np
    import torch.distributed as dist

    dev, r, n, g = ctx.device, ctx.rank, ctx.size, ctx.gang.group
    m = 4096

    def host(rank):
        return np.arange(m, dtype=np.float64) * (rank + 1) + rank

    def exact(t, want) -> bool:
        return bool(np.array_equal(t.double().cpu().numpy(), want))

    x = torch.arange(m, dtype=torch.float32, device=dev) * (r + 1) + r
    total = sum(host(i) for i in range(n))
    c = m // n
    checks = {}
    t = x.clone()
    dist.all_reduce(t, group=g)
    checks["all_reduce_sum"] = exact(t, total)
    t = x.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
    checks["all_reduce_max"] = exact(t, host(n - 1))
    t = x.clone()
    dist.broadcast(t, src=2 % n, group=g)
    checks["broadcast"] = exact(t, host(2 % n))
    t = torch.empty(n * m, dtype=x.dtype, device=dev)
    dist.all_gather_into_tensor(t, x, group=g)
    checks["all_gather_into_tensor"] = exact(
        t, np.concatenate([host(i) for i in range(n)]))
    t = torch.empty(c, dtype=x.dtype, device=dev)
    dist.reduce_scatter_tensor(t, x, group=g)
    checks["reduce_scatter_tensor"] = exact(t, total[r * c:(r + 1) * c])
    t = torch.empty_like(x)
    dist.all_to_all_single(t, x, group=g)
    checks["all_to_all_single"] = exact(t, np.concatenate(
        [host(j)[r * c:(r + 1) * c] for j in range(n)]))
    t = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (r + 1) % n, g),
           dist.P2POp(dist.irecv, t, (r - 1) % n, g)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    checks["batch_isend_irecv_ring"] = exact(t, host((r - 1) % n))
    sync(torch, dev)
    assert all(checks.values()), checks

    # bus bandwidth (nccl-tests' definitions): all_reduce moves
    # 2(n-1)/n of its bytes a rank, all_gather (n-1)/n of its output
    nbytes = S.comms_mb << 20
    big = torch.ones(nbytes // 4, dtype=torch.float32, device=dev)
    ar_ms = event_ms(torch, dev, lambda: dist.all_reduce(big, group=g),
                     BUSBW_ITERS)
    part = torch.ones(nbytes // 4 // n, dtype=torch.float32, device=dev)
    ag_ms = event_ms(torch, dev, lambda: dist.all_gather_into_tensor(
        big, part, group=g), BUSBW_ITERS)
    del big, part
    return dict(backend=ctx.gang.backend, checks=checks,
                bytes=nbytes, iters=BUSBW_ITERS,
                all_reduce_ms=ar_ms,
                all_reduce_busbw_gb_s=nbytes / (ar_ms / 1e3) / 1e9
                * 2 * (n - 1) / n,
                all_gather_ms=ag_ms,
                all_gather_busbw_gb_s=nbytes / (ag_ms / 1e3) / 1e9
                * (n - 1) / n)


def join_comms(recs: list) -> dict:
    r0 = recs[0]
    assert all(all(r["checks"].values()) for r in recs), recs
    return dict(checks=r0["checks"], exact_on_every_rank=True,
                backend=r0["backend"], bytes=r0["bytes"], iters=r0["iters"],
                **{k: [r[k] for r in recs] for k in (
                    "all_reduce_ms", "all_reduce_busbw_gb_s",
                    "all_gather_ms", "all_gather_busbw_gb_s")})


# --- leg 1: dp_resnet50 ---------------------------------------------------------

def narrow_resnet(torch, seed: int = 0):
    from sparkdl_tpu_torch.models import resnet as R

    return R.ResNet(stage_sizes=[2, 2, 2, 2], block=R.BasicBlock, width=8,
                    num_classes=10, seed=seed)


def image_model(torch, name: str, dev, dtype=None, classes: int = 10):
    """(model on ``dev``, preprocess of the uint8 wire or None)."""
    from sparkdl_tpu_torch.models.registry import get_model

    if name == "narrow":
        return narrow_resnet(torch).to(dev), lambda x: x.float() / 255.0
    spec = get_model(name)
    kw = {} if dtype is None else {"dtype": dtype}
    return (spec.build(num_classes=classes, seed=0, device=dev, **kw),
            C.resnet_preprocess(spec))


def resnet_timed(torch, ctx, S) -> dict:
    """The timed arm: ``ctx.fit(mutable=True)`` over this rank's wire
    batches (one a step, ``log_every=1``)."""
    from sparkdl_tpu_torch.runner import bn_classifier_loss, sgd

    dev = ctx.device
    model, pre = image_model(
        torch, S.resnet, dev, dtype=None if S.tiny else torch.bfloat16,
        classes=10 if S.tiny else 1000)
    wire = C.resnet_wire(C.RESNET_DISTINCT, S.resnet_batch, S.resnet_size,
                         seed=40 + ctx.rank)
    steps = S.resnet_warmup + S.resnet_timed
    stamps = []
    loss_fn = bn_classifier_loss(preprocess=pre)

    def stamped(m, batch):
        stamps.append(time.perf_counter())
        return loss_fn(m, batch)

    reset_peak(torch, dev)
    res = ctx.fit(loss_fn=stamped, model=model,
                  tx=sgd(C.RESNET_LR if not S.tiny else 0.01, momentum=0.9),
                  data=(wire[i % len(wire)] for i in range(steps)),
                  num_steps=steps, log_every=1, mutable=True)
    sync(torch, dev)
    stamps.append(time.perf_counter())
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    line = C.step_line(step_s, S.resnet_warmup)
    losses = [h["loss"] for h in res["history"]]
    rec = dict(world_size=ctx.size, rank=ctx.rank, device=str(dev),
               batch_per_rank=S.resnet_batch, steps=steps,
               warmup_steps=S.resnet_warmup, **line,
               images_per_s_per_chip=S.resnet_batch
               / line["step_ms_median"] * 1e3,
               peak_mem_gb=peak_gb(torch, dev), losses=losses)
    del res, model
    free(torch, dev)
    assert all(x == x and abs(x) < float("inf") for x in losses), losses
    return rec


def state_cpu(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def resnet_parity(torch, ctx, S) -> dict:
    """One f32 gang step of the parity model on this rank's rows against
    rank 0's one-process step on the global rows (shares of the change,
    ``chip_smoke._update_shares``)."""
    from sparkdl_tpu_torch.runner import TrainState, bn_classifier_loss, sgd
    from sparkdl_tpu_torch.runner.train_state import make_train_step

    dev = ctx.device
    wire = C.resnet_wire(1, S.parity_batch, 32, seed=41)[0]
    per = S.parity_batch // ctx.size
    local = {k: v[ctx.rank * per:(ctx.rank + 1) * per]
             for k, v in wire.items()}
    model, pre = image_model(torch, S.parity_model, dev)
    before = state_cpu(model)
    ctx.make_train_step(bn_classifier_loss(preprocess=pre), mutable=True)(
        TrainState.create(model, sgd(0.01, momentum=0.9)),
        ctx.shard_batch(local))
    got = state_cpu(model)
    out = dict(rows_global=S.parity_batch, rows_per_rank=per,
               model=S.parity_model if not S.tiny else "ResNet18 width 8",
               dtype="float32", tf32=False,
               optimizer="sgd(0.01, momentum=0.9)",
               ranks_bitwise=same_on_ranks(torch, ctx, [
                   float(v.double().sum()) for v in got.values()]))
    if ctx.rank == 0:
        ref, _ = image_model(torch, S.parity_model, dev)
        make_train_step(bn_classifier_loss(preprocess=pre), mutable=True)(
            TrainState.create(ref, sgd(0.01, momentum=0.9)),
            {k: torch.as_tensor(v).to(dev) for k, v in wire.items()})
        p, s = C._update_shares(got, state_cpu(ref), before)
        lp, ls = S.parity_shares
        out.update(param_share=p, stat_share=s, param_share_tol=lp,
                   stat_share_tol=ls,
                   against="one process's step on the global rows")
        assert p <= lp and s <= ls, out
    assert out["ranks_bitwise"], out
    return out


def resnet_resume(torch, ctx, S, root: str) -> dict:
    """``fit(checkpoint_every=2)`` of the parity model, 4 steps straight
    and 2 + a resume to 4, in a shared directory (rank 0 writes)."""
    from sparkdl_tpu_torch.runner import (XlaRunner, bn_classifier_loss,
                                          sgd)
    from sparkdl_tpu_torch.runner.data import ListDataset

    wire = C.resnet_wire(4, S.parity_batch, 32, seed=43)

    def run(directory, steps):
        model, pre = image_model(torch, S.parity_model, ctx.device)
        res = XlaRunner(np=ctx.size, device=ctx.device.type,
                        checkpoint_dir=directory).run(lambda c: c.fit(
                            loss_fn=bn_classifier_loss(preprocess=pre),
                            model=model, tx=sgd(0.01, momentum=0.9),
                            data=ListDataset(wire, shard=True),
                            num_steps=steps, log_every=1, mutable=True,
                            checkpoint_every=2))
        return [h["loss"] for h in res["history"]], state_cpu(model)

    # cuDNN may pick a nondeterministic backward algorithm: two fresh fits
    # on the card then differ in their last bits before any resume
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        straight = run(os.path.join(root, "straight"), 4)
        first = run(os.path.join(root, "resumed"), 2)
        second = run(os.path.join(root, "resumed"), 4)
    finally:
        torch.backends.cudnn.deterministic = was
    bitwise = all(torch.equal(v, second[1][k])
                  for k, v in straight[1].items())
    saved = sorted(os.listdir(os.path.join(root, "resumed")))
    out = dict(steps=4, checkpoint_every=2, losses_straight=straight[0],
               losses_resumed=first[0] + second[0],
               resumed_state_bitwise=bitwise,
               losses_bitwise=straight[0] == first[0] + second[0],
               checkpoint_dir_entries=saved)
    assert bitwise and out["losses_bitwise"], out
    return out


def leg_dp_resnet50(torch, ctx, S, kernels, root: str) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    C.reset_counts(*kernels)
    rec = dict(timed=resnet_timed(torch, ctx, S))
    rec["launches"] = C.read_counts(*kernels)
    assert not any(rec["launches"].values()), rec["launches"]
    rec["parity"] = resnet_parity(torch, ctx, S)
    free(torch, ctx.device)
    rec["checkpoint"] = resnet_resume(torch, ctx, S,
                                      os.path.join(root, "ckpt_resnet"))
    return rec


def join_dp_resnet50(recs: list, one_rank: dict | None) -> dict:
    t = [r["timed"] for r in recs]
    worst = max(t, key=lambda x: x["step_ms_median"])
    out = dict(config="BASELINE config 3", world_size=len(recs),
               step="implicit (synchronised BatchNorm, one gradient "
                    "all-reduce)",
               images_per_s_per_chip=worst["images_per_s_per_chip"],
               step_ms_median=[x["step_ms_median"] for x in t],
               step_ms_p10=[x["step_ms_p10"] for x in t],
               step_ms_p90=[x["step_ms_p90"] for x in t],
               peak_mem_gb=[x["peak_mem_gb"] for x in t],
               batch_per_rank=t[0]["batch_per_rank"],
               steps=t[0]["steps"], warmup_steps=t[0]["warmup_steps"],
               losses_rank0=t[0]["losses"], launches=recs[0]["launches"],
               parity=recs[0]["parity"], checkpoint=recs[0]["checkpoint"])
    if one_rank is not None:
        out["one_rank_gang"] = {k: one_rank[k] for k in (
            "device", "images_per_s_per_chip", "step_ms_median",
            "step_ms_p10", "step_ms_p90", "peak_mem_gb")}
        out["per_chip_over_one_rank"] = (out["images_per_s_per_chip"]
                                         / one_rank["images_per_s_per_chip"])
    return out


# --- leg 2: dp_m ------------------------------------------------------------------

def bert_cfg(B, S, layers=None):
    cfg = B.BertConfig.base() if S.bert == "base" else B.BertConfig.tiny()
    return cfg if layers is None else dataclasses.replace(
        cfg, num_layers=layers)


def bert_batches(S, cfg, n: int) -> list:
    """Phase h's batches; on the CPU cut to 8 rows of 16 tokens."""
    out = []
    for i in range(n):
        b = C.glue_batch(i, cfg.vocab_size)
        if S.tiny:
            b = {k: v[:8, :16] if v.ndim == 2 else v[:8]
                 for k, v in b.items()}
            b["attention_mask"][:, 0] = 1
        out.append(b)
    return out


def bert_grads(model) -> dict:
    return {n: p.grad.detach().float().cpu().clone()
            for n, p in model.named_parameters() if p.grad is not None}


def dp_bert(torch, ctx, S, kernels) -> dict:
    """The bf16 fine-tune through ``ctx.fit(with_rng=True)``: step times
    and the flash kernels' launches (one forward and one backward a layer
    and step)."""
    from sparkdl_tpu_torch.models import bert as B
    from sparkdl_tpu_torch.runner import adam
    from sparkdl_tpu_torch.runner.data import FactoryDataset

    fa = kernels[0]
    dev = ctx.device
    cfg = bert_cfg(B, S)
    steps = S.bert_warmup + S.bert_timed
    batches = bert_batches(S, cfg, steps)
    model = B.BertForSequenceClassification(
        cfg, num_classes=2, dtype=torch.bfloat16, attn_fn=fa.flash_attention,
        device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    stamps = []
    loss_fn = B.bert_finetune_loss(model)

    def stamped(m, batch, **k):
        stamps.append(time.perf_counter())
        return loss_fn(m, batch, **k)

    reset_peak(torch, dev)
    C.reset_counts(*kernels)
    res = ctx.fit(loss_fn=stamped, model=model, tx=adam(C.GLUE_LR),
                  data=FactoryDataset(lambda: iter(batches), shard=True),
                  num_steps=steps, log_every=1, with_rng=True)
    sync(torch, dev)
    stamps.append(time.perf_counter())
    launches = C.read_counts(*kernels)
    line = C.step_line([b - a for a, b in zip(stamps, stamps[1:])],
                       S.bert_warmup)
    per = len(batches[0]["label"]) // ctx.size
    rec = dict(model=f"BertConfig.{S.bert}()", dtype="bfloat16",
               batch_global=per * ctx.size, batch_per_rank=per,
               seq=batches[0]["input_ids"].shape[1], steps=steps, **line,
               examples_per_s_per_chip=per / line["step_ms_median"] * 1e3,
               losses=[h["loss"] for h in res["history"]],
               launches=launches, peak_mem_gb=peak_gb(torch, dev))
    nl = cfg.num_layers
    assert launches["flash_attention"] == nl * steps, rec
    assert launches["flash_attention_bwd"] == nl * steps, rec
    del res, model
    free(torch, dev)
    return rec


def dp_bert_parity(torch, ctx, S, kernels) -> dict:
    """One f32 ``with_rng`` SGD step of BERT at ``bert_parity_layers``
    layers (TF32 off) in the gang on this rank's rows, against rank 0's
    one-process step on the global batch: gradients within GRAD_SHARE of
    the largest, the loss within LOSS_RTOL."""
    from sparkdl_tpu_torch.models import bert as B
    from sparkdl_tpu_torch.runner import TrainState, sgd
    from sparkdl_tpu_torch.runner.train_state import make_train_step

    fa = kernels[0]
    dev = ctx.device
    cfg = bert_cfg(B, S, S.bert_parity_layers)
    batch = bert_batches(S, cfg, 1)[0]
    per = len(batch["label"]) // ctx.size

    def model():
        return B.BertForSequenceClassification(
            cfg, num_classes=2, attn_fn=fa.flash_attention, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))

    m = model()
    local = {k: v[ctx.rank * per:(ctx.rank + 1) * per]
             for k, v in batch.items()}
    _, met = ctx.make_train_step(B.bert_finetune_loss(m), with_rng=True,
                                 rng_seed=3)(
        TrainState.create(m, sgd(0.1)), ctx.shard_batch(local))
    got, loss = bert_grads(m), float(met["loss"])
    del m
    out = dict(layers=cfg.num_layers, dtype="float32", tf32=False,
               rows_global=len(batch["label"]), rows_per_rank=per,
               grad_share_tol=GRAD_SHARE, loss_rtol=LOSS_RTOL,
               ranks_bitwise=same_on_ranks(torch, ctx, [
                   float(g.double().sum()) for g in got.values()] + [loss]))
    if ctx.rank == 0:
        ref = model()
        _, mr = make_train_step(B.bert_finetune_loss(ref), with_rng=True,
                                rng_seed=3)(
            TrainState.create(ref, sgd(0.1)),
            {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
        want, lref = bert_grads(ref), float(mr["loss"])
        top = max(g.abs().max().item() for g in want.values())
        err = {n: (got[n] - want[n]).abs().max().item() for n in want}
        worst = max(err, key=err.get)
        out.update(grad_share=err[worst] / top, worst_grad=worst,
                   loss=loss, loss_one_process=lref,
                   loss_rel_err=abs(loss - lref) / abs(lref))
        assert out["grad_share"] <= GRAD_SHARE, out
        assert out["loss_rel_err"] <= LOSS_RTOL, out
    assert out["ranks_bitwise"], out
    free(torch, dev)
    return out


def dp_lora(torch, ctx, S, kernels) -> dict:
    """The LoRA fine-tune: the base broadcast by ``put_replicated``
    (timed), ``lora_steps`` steps of one row a rank, the losses against
    rank 0's one-process fit of the global rows."""
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.runner import TrainState
    from sparkdl_tpu_torch.runner.data import ListDataset
    from sparkdl_tpu_torch.runner.train_state import make_train_step

    fa = kernels[0]
    dev = ctx.device
    cfg = llama_cfg(L, S, S.lora_layers, lora_rank=4 if S.tiny else 16)
    ids = torch.randint(1, cfg.vocab_size, (S.lora_rows, S.lora_seq),
                        generator=torch.Generator().manual_seed(11)).numpy()

    def model():
        return build_llama(torch, L, cfg, torch.bfloat16, dev, 0,
                           fa.flash_attention)

    m = model()
    nbytes = sum(t.numel() * t.element_size()
                 for t in [*m.parameters(), *m.buffers()])
    import torch.distributed as dist

    sync(torch, dev)
    dist.barrier(group=ctx.gang.host_group)  # every rank starts together
    t0 = time.perf_counter()
    ctx.put_replicated(m)
    sync(torch, dev)
    bcast_s = time.perf_counter() - t0
    stamps = []
    loss_fn = L.causal_lm_loss_fn()

    def stamped(mm, batch, **k):
        stamps.append(time.perf_counter())
        return loss_fn(mm, batch, **k)

    reset_peak(torch, dev)
    C.reset_counts(*kernels)
    res = ctx.fit(loss_fn=stamped, model=m, tx=L.lora_optimizer(C.TRAIN_LR),
                  data=ListDataset([{"input_ids": ids}] * S.lora_steps,
                                   shard=True),
                  num_steps=S.lora_steps, log_every=1)
    sync(torch, dev)
    stamps.append(time.perf_counter())
    launches = C.read_counts(*kernels)
    losses = [h["loss"] for h in res["history"]]
    line = C.step_line([b - a for a, b in zip(stamps, stamps[1:])], 1)
    del res, m
    free(torch, dev)
    out = dict(config=f"llama3_8b(lora_rank=16), {cfg.num_layers} layers"
               if not S.tiny else "tiny(lora_rank=4)", dtype="bfloat16",
               rows_global=S.lora_rows, rows_per_rank=S.lora_rows // ctx.size,
               seq=S.lora_seq, steps=S.lora_steps, **line,
               tokens_per_s_per_chip=S.lora_rows // ctx.size * S.lora_seq
               / line["step_ms_median"] * 1e3,
               put_replicated_bytes=nbytes, put_replicated_s=bcast_s,
               losses=losses,
               launches=launches, peak_mem_gb=peak_gb(torch, dev),
               loss_rtol=C.DP_LORA_LOSS_RTOL)
    nl = cfg.num_layers
    assert launches["flash_attention"] == nl * S.lora_steps, out
    assert launches["flash_attention_bwd"] == nl * S.lora_steps, out
    if ctx.rank == 0:
        ref = model()
        st = TrainState.create(ref, L.lora_optimizer(C.TRAIN_LR))
        step = make_train_step(L.causal_lm_loss_fn())
        batch = {"input_ids": torch.as_tensor(ids).to(dev)}
        want = [float(step(st, batch)[1]["loss"])
                for _ in range(S.lora_steps)]
        del ref, st
        free(torch, dev)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        out.update(one_process_losses=want, loss_max_rel_err=rel)
        assert rel <= C.DP_LORA_LOSS_RTOL, out
    return out


def leg_dp_m(torch, ctx, S, kernels, root: str) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dict(dp_bert=dp_bert(torch, ctx, S, kernels),
                dp_bert_parity=dp_bert_parity(torch, ctx, S, kernels),
                dp_lora=dp_lora(torch, ctx, S, kernels))


def join_dp_m(recs: list) -> dict:
    b = [r["dp_bert"] for r in recs]
    lo = [r["dp_lora"] for r in recs]
    assert all(x["losses"] == b[0]["losses"] for x in b), "dp_bert ranks"
    return dict(
        config="BASELINE configs 4 and 5",
        dp_bert={**{k: v for k, v in b[0].items()
                    if k not in ("step_ms_median", "peak_mem_gb")},
                 "step_ms_median": [x["step_ms_median"] for x in b],
                 "peak_mem_gb": [x["peak_mem_gb"] for x in b]},
        dp_bert_parity=recs[0]["dp_bert_parity"],
        dp_lora={**{k: v for k, v in lo[0].items() if k not in (
                    "put_replicated_s", "put_replicated_gb_s",
                    "peak_mem_gb")},
                 "put_replicated_s": [x["put_replicated_s"] for x in lo],
                 "put_replicated_gb_s": lo[0]["put_replicated_bytes"]
                 / max(x["put_replicated_s"] for x in lo) / 1e9,
                 "peak_mem_gb": [x["peak_mem_gb"] for x in lo]})


# --- leg 3: tp_serve ----------------------------------------------------------------

def tp_inputs(torch, L, S, tp_init: str | None):
    """(f32 config, f32 model's state or None, prompts): the test's
    carried flax tree and prompts on the CPU, else phase u's seeded
    prompts and a seeded model."""
    if tp_init:
        d = torch.load(tp_init, weights_only=False)
        return L.LlamaConfig(**d["cfg"]), d["params"], d["prompts"]
    if S.tiny:
        cfg = L.LlamaConfig(vocab_size=512, hidden_size=128, num_layers=2,
                            num_heads=4, num_kv_heads=4,
                            intermediate_size=256, rope_theta=10000.0)
        g = torch.Generator().manual_seed(5)
        return cfg, None, [torch.randint(1, 512, (n,), generator=g).tolist()
                           for n in (19, 22, 27)]
    cfg = llama_cfg(L, S, S.tp_f32_layers)
    return cfg, None, C.tp_prompts(torch, cfg)


def serve(torch, GenerationEngine, model, S, prompts, *, tp, paged,
          kernel: str, kernels) -> tuple:
    """One engine (``tp`` None: the one-device engine) serving
    ``prompts`` inline to the end: (record, engine)."""
    from sparkdl_tpu_torch.parallel import dispatch_counter

    kw = dict(block_size=16 if not S.tiny else 8) if paged else dict(
        block_size=0)
    eng = GenerationEngine.from_model(
        model, num_slots=S.tp_slots, max_len=S.tp_max_len, tp=tp,
        device=model.device, prefill_chunk=S.tp_chunk, **kw)
    iters = []
    inner = eng.backend.step

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = inner(*a, **k)
        iters.append(time.perf_counter() - t0)
        return out
    eng.backend.step = timed
    counter = dispatch_counter(kernel)
    dev = model.device
    reset_peak(torch, dev)
    counter.launches = 0
    C.reset_counts(*kernels)
    t0 = time.perf_counter()
    hs = [eng.submit(p, max_new_tokens=S.tp_new) for p in prompts]
    eng.run_until_idle()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = C.read_counts(*kernels)
    streams = [h.result(1) for h in hs]
    ttft = sorted(h.t_first_token - h.t_submit for h in hs)
    st = eng.stats
    n_new = sum(len(s) for s in streams)
    rec = dict(tp=tp or 1, family="paged" if paged else "unpaged",
               backend=type(eng.backend).__name__, steps=st["steps"],
               completed=st["completed"], new_tokens=n_new, wall_s=wall,
               new_tokens_per_s=n_new / wall,
               iter_ms_mean=1e3 * sum(iters) / max(len(iters), 1),
               iter_ms_p50=1e3 * C._pct(iters, 0.5),
               iter_ms_max=1e3 * max(iters, default=0.0),
               ttft_p50_s=C._pct(ttft, 0.5), ttft_p95_s=C._pct(ttft, 0.95),
               launches=launches, dispatch=counter.launches,
               kv_pool_device_bytes=eng.kv_pool_device_bytes,
               graphs=eng.backend.graphs.snapshot(),
               peak_mem_gb=peak_gb(torch, dev), streams=streams)
    layers = model.cfg.num_layers
    assert st["completed"] == len(prompts), rec
    assert launches[kernel] == layers * st["steps"] > 0, rec
    assert rec["dispatch"] == (layers * st["steps"] if tp else 0), rec
    assert launches["flash_attention"] == 0, rec
    if dev.type == "cuda":  # one capture, then a replay a later step
        assert rec["graphs"]["captures"] == 1, rec
        assert rec["graphs"]["replays"] == st["steps"] - 1, rec
    return rec, eng


def static_streams(torch, L, model, prompts, new: int) -> list:
    ids, pads = L.left_pad_prompts(prompts)
    out = L.generate(model, torch.as_tensor(ids).to(model.device), new,
                     pad_lens=torch.as_tensor(pads).to(model.device))
    return [out[i, ids.shape[1]:].tolist() for i in range(len(prompts))]


def tp_arms(torch, ctx, S, kernels, model, prompts, gate) -> dict:
    """tp 1 (the one-device engine), 2 and 4 × paged / unpaged on
    ``model``; each arm's streams held by the top-2 rule, counted
    against ``generate()``; each rank's pool bytes 1/tp of tp 1's."""
    from sparkdl_tpu_torch import GenerationEngine
    from sparkdl_tpu_torch.models import llama as L

    out = {"generate": static_streams(torch, L, model, prompts, S.tp_new)}
    rule = near_tie_rule(torch, model, prompts, out["generate"], gate)
    out["generate_rule"] = rule
    for paged, kernel in ((True, "paged_flash_decode"),
                          (False, "flash_decode")):
        base_bytes = None
        for tp in (None, 2, 4):
            rec, eng = serve(torch, GenerationEngine, model, S, prompts,
                             tp=tp, paged=paged, kernel=kernel,
                             kernels=kernels)
            del eng
            free(torch, ctx.device)
            if tp is None:
                base_bytes = rec["kv_pool_device_bytes"]
            else:
                assert rec["kv_pool_device_bytes"] * tp == base_bytes, (
                    rec["kv_pool_device_bytes"], tp, base_bytes)
            rec["kv_bytes_times_tp_equal_tp1"] = True
            rec["rule"] = near_tie_rule(torch, model, prompts,
                                        rec["streams"], gate)
            rec["streams_equal_generate"] = [
                a == b for a, b in zip(rec["streams"], out["generate"])]
            out[f"{rec['family']}_tp{rec['tp']}"] = rec
    return out


def tp_front(torch, ctx, S, kernels, model, prompts, inline: dict) -> dict:
    """The tp 4 engine started: every rank calls ``start()``; rank 0's
    four client threads submit the prompts; the streams must equal the
    inline tp 4 run's; the control message's host ms (rank 0)."""
    from sparkdl_tpu_torch import GenerationEngine
    from sparkdl_tpu_torch.parallel import dispatch_counter

    eng = GenerationEngine.from_model(
        model, num_slots=S.tp_slots, max_len=S.tp_max_len, tp=4,
        device=model.device, prefill_chunk=S.tp_chunk,
        block_size=16 if not S.tiny else 8)
    front = eng._front
    ctl = []
    message = front.channel.message

    def timed_message(head, payload=b""):
        t0 = time.perf_counter()
        got = message(head, payload)
        ctl.append((got[0], time.perf_counter() - t0))
        return got
    front.channel.message = timed_message
    counter = dispatch_counter("paged_flash_decode")
    counter.launches = 0
    C.reset_counts(*kernels)
    seen = []
    t0 = time.perf_counter()
    eng.start(on_request=seen.append)
    if ctx.rank == 0:
        hs = [None] * len(prompts)

        def client(k):
            for i in range(k, len(prompts), C.TP_CLIENTS):
                hs[i] = eng.submit(prompts[i], max_new_tokens=S.tp_new)
                hs[i].result(300)

        ts = [threading.Thread(target=client, args=(k,))
              for k in range(C.TP_CLIENTS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        eng.stop(drain=True, timeout=120)
    else:
        eng.stop(timeout=300)
        by_id = {h.id: h for h in seen}
        hs = sorted(by_id.values(), key=lambda h: prompts.index(h.prompt))
    sync(torch, model.device)
    wall = time.perf_counter() - t0
    launches = C.read_counts(*kernels)
    streams = [h.result(1) for h in hs]
    steps = eng.stats["steps"]
    step_ctl = [1e3 * dt for kind, dt in ctl if kind == 1]
    rec = dict(tp=4, family="paged", clients=C.TP_CLIENTS,
               requests=len(prompts), wall_s=wall, steps=steps,
               new_tokens_per_s=sum(len(s) for s in streams) / wall,
               launches=launches, dispatch=counter.launches,
               streams_equal_inline=streams == inline["streams"],
               control_ms_p50=C._pct(step_ctl, 0.5) if step_ctl else None,
               control_ms_p95=C._pct(step_ctl, 0.95) if step_ctl else None,
               messages=front.stats["messages"])
    assert rec["streams_equal_inline"], (streams, inline["streams"])
    assert launches["paged_flash_decode"] == counter.launches == \
        model.cfg.num_layers * steps > 0, rec
    del eng
    free(torch, model.device)
    return rec


def leg_tp_serve(torch, ctx, S, kernels, root: str,
                 tp_init: str | None = None) -> dict:
    from sparkdl_tpu_torch.models import llama as L

    fa = kernels[0]
    dev = ctx.device
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32, params, prompts = tp_inputs(torch, L, S, tp_init)
    # f32: the JAX test's tree on the CPU, else a seeded depth-2 model
    m32 = L.LlamaModel(cfg32, attn_fn=fa.flash_attention, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(21))
    if params is not None:
        L.load_flax_params(m32, params)
    f32 = tp_arms(torch, ctx, S, kernels, m32, prompts, f32_gate)
    # bf16: llama3_8b widths at depth tp_layers (the CPU: the f32 model
    # cast), built on this card from its seed
    if S.tiny:
        m16 = L.LlamaModel(cfg32, dtype=torch.bfloat16,
                           attn_fn=fa.flash_attention, device=dev)
        m16.load_state_dict(m32.state_dict())
    else:
        m16 = build_llama(torch, L, llama_cfg(L, S, S.tp_layers),
                          torch.bfloat16, dev, 21, fa.flash_attention)
    del m32
    free(torch, dev)
    bf16 = tp_arms(torch, ctx, S, kernels, m16, prompts, bf16_gate)
    front = tp_front(torch, ctx, S, kernels, m16, prompts,
                     bf16["paged_tp4"])
    del m16
    free(torch, dev)
    return dict(f32=f32, bf16=bf16, tp_front=front,
                prompts=[len(p) for p in prompts],
                prompt_ids=prompts if S.tiny else None)


def join_tp_serve(recs: list) -> dict:
    """Per arm: the ranks of a group stream the same; tp 2's two groups
    and tp 4 stream what tp 1 does up to near ties (each rank's own rule
    held that); the timing of rank 0 beside the ranks' iteration ms."""
    out = {}
    for dt in ("f32", "bf16"):
        arms = {}
        for key, r0 in recs[0][dt].items():
            if key in ("generate", "generate_rule"):
                continue
            ranks = [r[dt][key] for r in recs]
            groups = {1: [[0], [1], [2], [3]], 2: [[0, 1], [2, 3]],
                      4: [[0, 1, 2, 3]]}[r0["tp"]]
            for grp in groups:
                assert all(ranks[i]["streams"] == ranks[grp[0]]["streams"]
                           for i in grp), (dt, key, grp)
            arms[key] = {**{k: v for k, v in r0.items() if k != "streams"},
                         "iter_ms_mean_ranks": [x["iter_ms_mean"]
                                                for x in ranks],
                         "streams_identical_to_tp1": ranks[0]["streams"]
                         == recs[0][dt][f"{r0['family']}_tp1"]["streams"],
                         "group_streams_bitwise": True}
        out[dt] = dict(arms=arms,
                       generate_rule=recs[0][dt]["generate_rule"],
                       streams={k: recs[0][dt][k]["streams"]
                                for k in recs[0][dt]
                                if k not in ("generate", "generate_rule")},
                       generate=recs[0][dt]["generate"])
    fr = [r["tp_front"] for r in recs]
    assert all(x["streams_equal_inline"] for x in fr), fr
    out["tp_front"] = fr[0]
    out["prompt_lens"] = recs[0]["prompts"]
    out["prompt_ids"] = recs[0]["prompt_ids"]
    return out


# --- leg 4: fsdp_tp_train -----------------------------------------------------------

def fsdp_collectives(nl: int) -> dict:
    """The collectives one FSDP×TP step of an ``nl``-layer Llama makes
    (``parallel.fsdp.COLLECTIVES``): the 2 + 7·nl data-sharded weights
    gathered in the forward and, but the embedding, again in the
    backward, the embedding and logits over ``model``, one
    reduce-scatter a data-sharded weight, and the Megatron pairs'
    all-reduces (``copy_in`` / ``reduce_out``)."""
    return {"all_gather": 2 + 7 * nl + 2 + 7 * nl + 1,
            "reduce_scatter": 2 + 7 * nl, "all_reduce": 4 * nl + 2,
            "send_recv": 0}


def train_arm(torch, ctx, S, kernels, cfg, dtype, ids, mesh,
              steps: int, seed: int = 0) -> tuple:
    """``steps`` sgd steps of the seeded model, placed on ``mesh`` (or
    unsharded): (record, state)."""
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.parallel import fsdp
    from sparkdl_tpu_torch.runner.train_state import (TrainState,
                                                      make_train_step, sgd)

    dev = ctx.device
    reset_peak(torch, dev)
    model = build_llama(torch, L, cfg, dtype, dev, seed,
                        kernels[0].flash_attention)
    if mesh is not None:
        model = L.shard_model(model, mesh)
        step = make_train_step(L.causal_lm_loss_fn(), mesh=mesh,
                               param_rules=L.training_rules(mesh))
    else:
        step = make_train_step(L.causal_lm_loss_fn())
    state = TrainState.create(model, sgd(C.FSDP_LR))
    batch = {"input_ids": torch.as_tensor(ids).to(dev)}
    C.reset_counts(*kernels)
    fsdp.reset_collectives()
    losses, step_ms = [], []
    for _ in range(steps):
        sync(torch, dev)
        t0 = time.perf_counter()
        _, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = C.read_counts(*kernels)
    nl = cfg.num_layers
    assert launches["flash_attention"] == nl * steps, launches
    assert launches["flash_attention_bwd"] == nl * steps, launches
    rec = dict(arm="unsharded" if mesh is None else "sharded",
               mesh=None if mesh is None else dict(zip(
                   mesh.mesh_dim_names, mesh.mesh.shape)),
               dtype=str(dtype).replace("torch.", ""), layers=nl,
               losses=losses, step_ms=step_ms,
               step_ms_median=sorted(step_ms)[len(step_ms) // 2],
               peak_gb=peak_gb(torch, dev), launches=launches,
               collectives_per_step={k: v / steps for k, v in
                                     fsdp.COLLECTIVES.items()})
    return rec, state


def leg_fsdp_tp_train(torch, ctx, S, kernels, root: str) -> dict:
    from sparkdl_tpu_torch.core.runtime import make_mesh
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.parallel import fsdp

    dev = ctx.device
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh({"data": 2, "model": 2})
    out = {}
    # f32 parity at depth fsdp_parity_layers, one step
    cfg = llama_cfg(L, S, S.fsdp_parity_layers)
    ids = torch.randint(1, cfg.vocab_size, (S.train_batch, S.train_seq),
                        generator=torch.Generator().manual_seed(11)).numpy()
    base, st = train_arm(torch, ctx, S, kernels, cfg, torch.float32, ids,
                         None, 1)
    want = state_cpu(st.model)
    del st
    free(torch, dev)
    arm, st = train_arm(torch, ctx, S, kernels, cfg, torch.float32, ids,
                        mesh, 1)
    got = fsdp.full_state_dict(st.model, sink=lambda t: t.cpu())
    del st
    free(torch, dev)
    m0 = build_llama(torch, L, cfg, torch.float32, dev, 0)  # the start
    before = state_cpu(m0)
    del m0
    free(torch, dev)
    # each parameter within one f32 rounding of its own value (the update
    # p - lr·g rounds once) plus FSDP_UPDATE_SHARE of the largest change
    top = max((want[k] - before[k]).abs().max().item() for k in want)
    eps = torch.finfo(torch.float32).eps
    err = {k: ((got[k] - want[k]).abs() - eps * want[k].abs()).max().item()
           for k in want}
    worst = max(err, key=err.get)
    share = max(err[worst], 0.0) / top
    ulps = max(((got[k] - want[k]).abs() / (eps * want[k].abs()).clamp_min(
        1e-30)).max().item() for k in want)
    rel = abs(arm["losses"][0] - base["losses"][0]) / abs(base["losses"][0])
    out["parity_f32"] = dict(
        layers=cfg.num_layers, tf32=False, loss=arm["losses"][0],
        loss_unsharded=base["losses"][0], loss_rel_err=rel,
        loss_rtol=FSDP_LOSS_RTOL, update_share_beyond_one_rounding=share,
        worst=worst, max_abs_diff_in_ulps=ulps,
        update_share_tol=FSDP_UPDATE_SHARE,
        collectives_per_step=arm["collectives_per_step"])
    assert rel <= FSDP_LOSS_RTOL and share <= FSDP_UPDATE_SHARE, \
        out["parity_f32"]
    assert arm["collectives_per_step"] == fsdp_collectives(cfg.num_layers), \
        arm["collectives_per_step"]
    del want, got, before
    # bf16 at depth fsdp_layers, fsdp_steps steps: times and memory
    cfg = llama_cfg(L, S, S.fsdp_layers)
    base, st = train_arm(torch, ctx, S, kernels, cfg, torch.bfloat16, ids,
                         None, S.fsdp_steps)
    del st
    free(torch, dev)
    arm, st = train_arm(torch, ctx, S, kernels, cfg, torch.bfloat16, ids,
                        mesh, S.fsdp_steps)
    want_colls = fsdp_collectives(cfg.num_layers)
    assert arm["collectives_per_step"] == want_colls, arm
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(arm["losses"], base["losses"]))
    out["bf16"] = dict(arms=[base, arm], collectives_expected=want_colls,
                       loss_max_rel_err=loss_rel,
                       loss_rtol=C.BF16_LOGIT_RTOL)
    assert loss_rel <= C.BF16_LOGIT_RTOL, out["bf16"]
    out["sharded_ckpt"] = sharded_ckpt(torch, ctx, S, st, cfg,
                                       os.path.join(root, "ckpt_fsdp"))
    del st
    free(torch, dev)
    return out


def sharded_ckpt(torch, ctx, S, state, cfg, root: str) -> dict:
    """The 2 × 2 state saved (global tensors, rank 0 writes) and restored
    into freshly placed models on ``{"data": 4, "model": 1}`` and
    ``{"data": 1, "model": 4}`` (``SPARKDL_ELASTIC=1``): bitwise."""
    from sparkdl_tpu_torch.core.runtime import make_mesh
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.parallel import fsdp
    from sparkdl_tpu_torch.runner.checkpoint import CheckpointManager
    from sparkdl_tpu_torch.runner.train_state import TrainState, sgd

    dev = ctx.device
    group = ctx.gang.host_group
    man = CheckpointManager(root, async_save=False, group=group)
    sync(torch, dev)
    t0 = time.perf_counter()
    man.save(state.step, state, wait=True)
    save_s = time.perf_counter() - t0
    man.close()
    saved = fsdp.full_state_dict(state.model, sink=lambda t: t.cpu())
    nbytes = (os.path.getsize(os.path.join(root, str(state.step),
                                           "state.pt"))
              if ctx.rank == 0 else None)
    out = dict(bytes=nbytes, save_s=save_s, saved_mesh={"data": 2,
                                                        "model": 2},
               restores={})
    os.environ["SPARKDL_ELASTIC"] = "1"
    try:
        for axes in ({"data": 4, "model": 1}, {"data": 1, "model": 4}):
            mesh = make_mesh(axes)
            fresh = TrainState.create(L.shard_model(build_llama(
                torch, L, cfg, torch.bfloat16, dev, 1), mesh), sgd(C.FSDP_LR))
            man = CheckpointManager(root, group=group)
            sync(torch, dev)
            t0 = time.perf_counter()
            man.restore(fresh, mesh=mesh, rules=L.training_rules(mesh))
            sync(torch, dev)
            restore_s = time.perf_counter() - t0
            man.close()
            got = fsdp.full_state_dict(fresh.model, sink=lambda t: t.cpu())
            bitwise = set(got) == set(saved) and all(
                torch.equal(got[k], saved[k]) for k in saved)
            name = "x".join(f"{k}{v}" for k, v in axes.items())
            out["restores"][name] = dict(mesh=axes, restore_s=restore_s,
                                         step=fresh.step,
                                         bit_identical=bitwise)
            assert bitwise and fresh.step == state.step, out
            del fresh, got
            free(torch, dev)
    finally:
        del os.environ["SPARKDL_ELASTIC"]
    return out


def join_fsdp_tp_train(recs: list) -> dict:
    out = dict(recs[0])
    out["bf16"] = dict(out["bf16"])
    out["bf16"]["sharded_step_ms_median_ranks"] = [
        r["bf16"]["arms"][1]["step_ms_median"] for r in recs]
    out["bf16"]["sharded_peak_gb_ranks"] = [
        r["bf16"]["arms"][1]["peak_gb"] for r in recs]
    out["bf16"]["unsharded_peak_gb_ranks"] = [
        r["bf16"]["arms"][0]["peak_gb"] for r in recs]
    assert all(r["bf16"]["arms"][1]["losses"]
               == recs[0]["bf16"]["arms"][1]["losses"] for r in recs)
    return out


# --- leg 5: sp --------------------------------------------------------------------

def ulysses(torch, ctx, S, kernels, mesh) -> dict:
    """Ulysses (``local_attn="auto"``) forward and backward on the
    ``{"sp": 4}`` mesh against the bare flash kernel's call on this card,
    within chip_smoke's kernel rule TOL["bfloat16"] (expected bitwise:
    each head is the same kernel's arithmetic); forward and
    forward+backward ms of each."""
    from sparkdl_tpu_torch.parallel import ulysses_attention

    fa = kernels[0]
    dev = ctx.device
    b, h, s, d = S.ulysses
    g = torch.Generator(device=dev).manual_seed(40)
    q, k, v, do = (torch.randn((b, h, s, d), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    same = same_on_ranks(torch, ctx, [float(x.double().sum())
                                      for x in (q, k, v, do)])
    assert same, "the ranks drew different inputs"

    def uly(a, b_, c):
        return ulysses_attention(a, b_, c, mesh, axis="sp", causal=True,
                                 local_attn="auto" if dev.type == "cuda"
                                 else fa.flash_attention)

    def bare(a, b_, c):
        return fa.flash_attention(a, b_, c, causal=True)

    def fwd_bwd(fn, xs, dout):
        leaves = [x.detach().requires_grad_(True) for x in xs]
        o = fn(*leaves)
        return (o.detach(), *torch.autograd.grad(o, leaves, dout))

    C.reset_counts(*kernels)
    got = fwd_bwd(uly, (q, k, v), do)
    sync(torch, dev)
    launches = C.read_counts(*kernels)
    assert launches["flash_attention"] == 1, launches
    assert launches["flash_attention_bwd"] == 1, launches
    want = fwd_bwd(bare, (q, k, v), do)
    atol, rtol = C.TOL["bfloat16"]
    errs, bitwise = {}, {}
    for n, a, w in zip(("o", "dq", "dk", "dv"), got, want):
        bitwise[n] = bool(torch.equal(a, w))
        errs[n] = C.check_close(a, w, "bfloat16", f"ulysses {n}")
    del got, want
    with torch.no_grad():
        ms = event_ms(torch, dev, lambda: uly(q, k, v), 5)
        bare_ms = event_ms(torch, dev, lambda: bare(q, k, v), 5)
    fb = event_ms(torch, dev, lambda: fwd_bwd(uly, (q, k, v), do), 3)
    bare_fb = event_ms(torch, dev, lambda: fwd_bwd(bare, (q, k, v), do), 3)
    del q, k, v, do
    free(torch, dev)
    return dict(shape=list(S.ulysses), causal=True, dtype="bfloat16",
                mesh={"sp": ctx.size}, heads_per_rank=h // ctx.size,
                launches=launches, bitwise_to_bare_kernel=bitwise,
                max_abs_err=errs, tol=dict(atol=atol, rtol=rtol),
                ms=ms, bare_ms=bare_ms, fwd_bwd_ms=fb,
                bare_fwd_bwd_ms=bare_fb)


def ring_generate(torch, ctx, S, kernels, mesh) -> dict:
    """Ring attention over ``{"sp": 4}`` in ``generate()``'s prefill: the
    last prefill logits against the flash arm's within RING_LOGIT_SHARE
    of the largest; each arm's prefill ms (three) and the streams held by
    the top-2 rule."""
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.parallel import fsdp, ring_attention

    import importlib

    ra = importlib.import_module("sparkdl_tpu_torch.parallel.ring_attention")
    fa = kernels[0]
    dev = ctx.device
    hops = [0]
    post_shift = ra._Axis.post_shift

    def counted(self, *tensors):  # one batch_isend_irecv a hop
        hops[0] += 1
        return post_shift(self, *tensors)
    ra._Axis.post_shift = counted
    cfg = llama_cfg(L, S, S.ring_layers)
    model = build_llama(torch, L, cfg, torch.bfloat16, dev, 42, None)
    ids = torch.randint(1, cfg.vocab_size, (S.ring_prompts, S.ring_len),
                        generator=torch.Generator().manual_seed(42)).to(dev)
    arms = {"flash": fa.flash_attention,
            "ring": functools.partial(ring_attention, mesh=mesh, axis="sp")}
    rec = dict(layers=cfg.num_layers, dtype="bfloat16",
               mesh={"sp": ctx.size}, prompts=S.ring_prompts,
               prompt_len=S.ring_len, new_tokens=S.ring_new,
               logit_share_limit=C.RING_LOGIT_SHARE, arms={})
    streams, last = {}, {}
    for arm, fn in arms.items():
        model.attn_fn = fn
        C.reset_counts(*kernels)
        fsdp.reset_collectives()
        hops[0] = 0
        out = L.generate(model, ids, S.ring_new)
        sync(torch, dev)
        launches = C.read_counts(*kernels)
        colls = dict(fsdp.COLLECTIVES, batch_isend_irecv=hops[0])
        streams[arm] = out[:, S.ring_len:].tolist()
        pre = []
        for _ in range(3):
            cache = L.init_cache(model, S.ring_prompts,
                                 S.ring_len + S.ring_new)
            sync(torch, dev)
            t0 = time.perf_counter()
            last[arm] = L._prefill(model, ids, cache, None).float()
            sync(torch, dev)
            pre.append((time.perf_counter() - t0) * 1e3)
            del cache
        rec["arms"][arm] = dict(prefill_ms=pre, launches=launches,
                                collectives=colls)
        assert launches["flash_attention"] == (
            cfg.num_layers if arm == "flash" else 0), (arm, launches)
        # generate()'s prefill: sp - 1 hops a layer (its decode steps
        # attend over the whole cache on each rank, no hop)
        assert colls["batch_isend_irecv"] == (
            cfg.num_layers * (ctx.size - 1) if arm == "ring" else 0), (
                arm, colls)
        free(torch, dev)
    ra._Axis.post_shift = post_shift
    scale = last["flash"].abs().max().item()
    share = (last["ring"] - last["flash"]).abs().max().item() / scale
    rec["ring_vs_flash_logit_share"] = share
    assert share <= C.RING_LOGIT_SHARE, rec
    prompts = ids.tolist()
    for arm in ("ring", "flash"):
        rec[f"{arm}_rule"] = near_tie_rule(torch, model, prompts,
                                           streams[arm], bf16_gate)
    rec["ring_streams_equal_flash"] = [
        a == b for a, b in zip(streams["ring"], streams["flash"])]
    rec["streams"] = streams
    del model, last
    free(torch, dev)
    return rec


def leg_sp(torch, ctx, S, kernels, root: str) -> dict:
    from sparkdl_tpu_torch.core.runtime import make_mesh

    mesh = make_mesh({"sp": ctx.size})
    return dict(ulysses=ulysses(torch, ctx, S, kernels, mesh),
                ring_generate=ring_generate(torch, ctx, S, kernels, mesh))


def join_sp(recs: list) -> dict:
    assert all(r["ring_generate"]["streams"]
               == recs[0]["ring_generate"]["streams"] for r in recs)
    out = dict(recs[0])
    out["ulysses"] = dict(out["ulysses"])
    for k in ("ms", "bare_ms", "fwd_bwd_ms", "bare_fwd_bwd_ms"):
        out["ulysses"][k + "_ranks"] = [r["ulysses"][k] for r in recs]
    return out


# --- shared by moe and gpipe ---------------------------------------------------------

def no_tf32(torch) -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def hold(got: dict, want: dict, dtype: str) -> dict:
    """Each tensor of ``got`` against ``want``'s: whether bitwise, and its
    max |difference| as a share of ``want``'s largest |value|; a tensor
    that is not bitwise must lie within ``SHARD_SHARE[dtype]``."""
    import torch

    bitwise, share = {}, {}
    for k, w in want.items():
        g = got[k]
        bitwise[k] = torch.equal(g, w)
        top = w.float().abs().max().item()
        share[k] = (g.float() - w.float()).abs().max().item() / max(
            top, 1e-30)
    worst = max(share, key=share.get)
    out = dict(bitwise=all(bitwise.values()),
               not_bitwise=sorted(k for k, b in bitwise.items() if not b),
               max_share=share[worst], worst=worst,
               share_limit=SHARD_SHARE[dtype])
    assert out["bitwise"] or out["max_share"] <= out["share_limit"], out
    return out


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# --- leg 6: moe -------------------------------------------------------------------

def leg_moe(torch, ctx, S, kernels, root: str,
            moe_init: str | None = None) -> dict:
    """Switch MoE on ``{"ep": 4}``: the module built alike on every rank
    from a seed (on the CPU from the test's flax tree, ``--moe-init``),
    placed by ``shard_moe`` (2 of the 8 experts a rank), against the
    unsharded module on this card: the output and the gradients of
    ``(y.float()**2).sum() + moe_aux_loss`` for x, the router and the
    experts (gathered over ``ep``). Forward + backward ms of each arm, in
    turns; the collectives a step."""
    import torch.distributed as dist

    from sparkdl_tpu_torch.core.runtime import make_mesh
    from sparkdl_tpu_torch.parallel import fsdp
    from sparkdl_tpu_torch.parallel import moe as M

    dev = ctx.device
    no_tf32(torch)
    mesh = make_mesh({"ep": ctx.size})
    d, ff, e, cf = S.moe
    b, t = S.moe_tokens
    dtype = torch.float32 if S.tiny else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    glob = M.SwitchMoE(d, e, ff, capacity_factor=cf, dtype=dtype,
                       device=dev, generator=g)
    if moe_init:
        init = torch.load(moe_init, weights_only=False)
        M.load_flax_params(glob, init["params"])
        x = torch.as_tensor(init["x"]).to(dev)
    else:
        x = torch.randn((b, t, d), generator=g, device=dev).to(dtype)
    assert same_on_ranks(torch, ctx, [float(x.double().sum())] + [
        float(p.double().sum()) for p in glob.parameters()]), \
        "the ranks built different modules"
    local = M.shard_moe(glob, mesh)

    def run(m):
        xi = x.detach().clone().requires_grad_(True)
        m.zero_grad(set_to_none=True)
        inter = {}
        y = m(xi, intermediates=inter)
        aux = M.moe_aux_loss(inter)
        ((y.float() ** 2).sum() + aux).backward()
        return dict(y=y.detach(), aux=aux.detach(), x_grad=xi.grad,
                    **{n: p.grad for n, p in m.named_parameters()})

    fsdp.reset_collectives()
    got = run(local)
    sync(torch, dev)
    colls = dict(fsdp.COLLECTIVES)
    for n in [k for k in got if k.startswith("experts.")]:
        part = got[n].contiguous()
        whole = torch.empty((ctx.size * part.shape[0], *part.shape[1:]),
                            dtype=part.dtype, device=dev)
        dist.all_gather_into_tensor(whole, part, group=mesh.get_group("ep"))
        got[n] = whole
    want = run(glob)
    rec = dict(config="Switch-Base-8 (d_model 768, d_ff 3072, 8 experts, "
               "capacity factor 1.25)" if not S.tiny else
               f"d_model {d}, d_ff {ff}, {e} experts, capacity factor {cf}",
               dtype=dtype_name(dtype), tokens=b * t,
               capacity=glob.capacity(b * t), mesh={"ep": ctx.size},
               local_wi_shape=list(local.experts.wi.kernel.shape),
               held_to_unsharded=hold(got, want, dtype_name(dtype)),
               collectives_per_step=colls, aux_loss=float(got["aux"]))
    # forward: reduce_out's sum; backward: copy_in's two (tokens, gate)
    assert colls == {"all_gather": 0, "reduce_scatter": 0,
                     "all_reduce": 3, "send_recv": 0}, colls
    assert rec["local_wi_shape"][0] == e // ctx.size, rec
    assert torch.isfinite(got["y"].float()).all()
    if S.tiny:  # held to the JAX package's module by the test
        rec["tensors"] = {k: v.float().cpu().tolist()
                          for k, v in got.items()}
    del want, got
    ms = {"unsharded": [], "ep": []}
    for arm in ("unsharded", "ep", "ep", "unsharded"):
        m = glob if arm == "unsharded" else local
        ms[arm].append(event_ms(torch, dev, lambda: run(m), 5))
    rec["fwd_bwd_ms"] = ms
    del glob, local
    free(torch, dev)
    return rec


def join_moe(recs: list) -> dict:
    out = {k: v for k, v in recs[0].items() if k != "tensors"}
    assert all(r["aux_loss"] == recs[0]["aux_loss"] for r in recs)
    out["held_to_unsharded_ranks"] = [r["held_to_unsharded"] for r in recs]
    out["bitwise_on_every_rank"] = all(r["held_to_unsharded"]["bitwise"]
                                       for r in recs)
    out["fwd_bwd_ms_ranks"] = [r["fwd_bwd_ms"] for r in recs]
    if "tensors" in recs[0]:
        out["tensors_ranks"] = [r["tensors"] for r in recs]
    return out


# --- leg 7: gpipe -----------------------------------------------------------------

def gpipe_collectives(m: int, p: int, backward: bool) -> dict:
    """One ``gpipe`` pass over ``m`` microbatches and ``p`` stages: a hop
    a tick (``m + p - 1`` ticks) forward and again backward, and the
    output's one sum over ``pp``."""
    return {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 1,
            "send_recv": (m + p - 1) * (2 if backward else 1)}


def leg_gpipe(torch, ctx, S, kernels, root: str) -> dict:
    """GPipe on ``{"pp": 4}``: four different llama3_8b-width
    ``LlamaLayer``s (seeded as ``chip_smoke.gpipe_leg`` seeds one), one a
    stage, ``GPIPE_MICRO`` microbatches of 1 × ``GPIPE_SEQ``, the flash
    kernels as attention, ``remat`` off and on. The forward against the
    four blocks applied in turn to each microbatch on this card; the
    backward of a weighted sum of the output, each stage's parameter
    gradient gathered from its ``Shard(0)`` DTensor, against the one-card
    sequential backward. Launches and hops a pass; the pipeline's and the
    sequential ms (forward, and forward + backward), in turns."""
    import math

    from torch.func import functional_call

    from sparkdl_tpu_torch.core.runtime import make_mesh
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.ops.flash_attention import resolve_attn_fn
    from sparkdl_tpu_torch.parallel import (fsdp, gpipe, microbatch,
                                            stack_stage_params,
                                            stage_sharding)

    fa = kernels[0]
    dev = ctx.device
    no_tf32(torch)
    p, m = ctx.size, S.gpipe_micro
    ticks = m + p - 1
    mesh = make_mesh({"pp": p})
    cfg = llama_cfg(L, S, p)
    dtype = torch.float32 if S.tiny else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2)
    layers = []
    for _ in range(p):
        layer = L.LlamaLayer(cfg, dtype=dtype, device=dev)
        with torch.no_grad():
            for name, w in layer.named_parameters():
                if not name.endswith("scale"):
                    w.copy_(torch.randn(w.shape, generator=g, device=dev)
                            / math.sqrt(w.shape[1]))
        layers.append(layer)
    # the flash kernels: "auto" on the card; on the CPU their plain
    # version through the wrapper, so the launches count there too
    attn = resolve_attn_fn("auto") if dev.type == "cuda" \
        else fa.flash_attention
    pos = torch.arange(S.gpipe_seq, device=dev)
    x = microbatch(torch.randn((m, S.gpipe_seq, cfg.hidden_size),
                               generator=g, device=dev).to(dtype), m)
    wgt = torch.randn(x.shape, generator=g, device=dev)  # the loss's, f32
    assert same_on_ranks(torch, ctx, [float(x.double().sum())] + [
        float(w.double().sum()) for lay in layers
        for w in lay.parameters()]), "the ranks built different layers"
    stacked = stage_sharding(mesh, stack_stage_params(
        [{k: v.detach() for k, v in lay.named_parameters()}
         for lay in layers]), "pp")
    for leaf in stacked.values():
        leaf.requires_grad_(True)

    def stage_fn(params, h):
        return functional_call(layers[0], params, (h, pos, attn))

    def sequential():
        outs = []
        for i in range(m):
            h = x[i]
            for lay in layers:
                h = lay(h, pos, attn)
            outs.append(h)
        return torch.stack(outs)

    def seq_fwd_bwd():
        for lay in layers:
            lay.zero_grad(set_to_none=True)
        (sequential().float() * wgt).sum().backward()

    with torch.no_grad():
        ref = sequential()
    seq_fwd_bwd()
    want = {k: torch.stack([dict(lay.named_parameters())[k].grad
                            for lay in layers]) for k in stacked}
    rec = dict(stage="LlamaLayer at llama3_8b widths" if not S.tiny
               else "LlamaLayer at LlamaConfig.tiny() widths",
               stages=p, mesh={"pp": p}, microbatches=m,
               microbatch_shape=[1, S.gpipe_seq], dtype=dtype_name(dtype),
               ticks=ticks, bubble_share_expected=(p - 1) / ticks,
               loss="(y.float() * w).sum(), w seeded", arms={})
    for remat in (False, True):
        apply = gpipe(stage_fn, mesh, "pp", remat=remat)
        C.reset_counts(*kernels)
        fsdp.reset_collectives()
        with torch.no_grad():
            y = apply(stacked, x)
        sync(torch, dev)
        fwd = dict(launches=C.read_counts(*kernels),
                   collectives=dict(fsdp.COLLECTIVES),
                   bitwise_to_sequential=torch.equal(y, ref),
                   max_abs_diff=(y.float() - ref.float()).abs().max()
                   .item())
        del y
        # the forward is the same arithmetic on the same bits; the
        # stage calls of the bubble run too (M + P - 1 a rank, not M)
        assert fwd["bitwise_to_sequential"], fwd
        assert fwd["launches"]["flash_attention"] == ticks, fwd
        assert fwd["collectives"] == gpipe_collectives(m, p, False), fwd
        for leaf in stacked.values():
            leaf.grad = None
        C.reset_counts(*kernels)
        fsdp.reset_collectives()
        (apply(stacked, x).float() * wgt).sum().backward()
        sync(torch, dev)
        bwd = dict(launches=C.read_counts(*kernels),
                   collectives=dict(fsdp.COLLECTIVES))
        got = {k: v.grad.full_tensor() for k, v in stacked.items()}
        bwd["grads_held_to_sequential"] = hold(got, want, dtype_name(dtype))
        del got
        # each stage call once forward (once more under remat: its
        # recompute), one flash backward a stage call, bubble ones too
        assert bwd["launches"]["flash_attention"] == ticks * (
            2 if remat else 1), bwd
        assert bwd["launches"]["flash_attention_bwd"] == ticks, bwd
        assert bwd["collectives"] == gpipe_collectives(m, p, True), bwd
        rec["arms"][f"remat_{remat}"] = dict(forward=fwd, fwd_bwd=bwd)
    apply = gpipe(stage_fn, mesh, "pp", remat=False)

    def pipe_fwd_bwd():
        for leaf in stacked.values():
            leaf.grad = None
        (apply(stacked, x).float() * wgt).sum().backward()

    ms = {}
    for arm in ("sequential", "pipeline", "pipeline", "sequential"):
        with torch.no_grad():
            ms.setdefault(f"{arm}_fwd", []).append(event_ms(
                torch, dev, sequential if arm == "sequential"
                else lambda: apply(stacked, x), 3))
        ms.setdefault(f"{arm}_fwd_bwd", []).append(event_ms(
            torch, dev, seq_fwd_bwd if arm == "sequential"
            else pipe_fwd_bwd, 3))
    rec["ms"] = ms
    # one card runs M·P stage calls; the pipeline's critical path M + P - 1
    rec["pipeline_over_sequential_fwd"] = (min(ms["pipeline_fwd"])
                                           / min(ms["sequential_fwd"]))
    rec["pipeline_over_sequential_fwd_ideal"] = ticks / (m * p)
    del stacked, layers, want, ref
    free(torch, dev)
    return rec


def join_gpipe(recs: list) -> dict:
    out = dict(recs[0])
    out["ms_ranks"] = [r["ms"] for r in recs]
    out["grads_bitwise_on_every_rank"] = all(
        r["arms"][a]["fwd_bwd"]["grads_held_to_sequential"]["bitwise"]
        for r in recs for a in r["arms"])
    assert all(r["arms"][a][k]["launches"] == recs[0]["arms"][a][k][
        "launches"] for r in recs for a in r["arms"]
        for k in ("forward", "fwd_bwd")), [r["arms"] for r in recs]
    return out


# --- leg 8: batch_runner_mesh -----------------------------------------------------

def leg_batch_runner_mesh(torch, ctx, S, kernels, root: str) -> dict:
    """The ResNet50 featurizer with ``numDevices`` 4 through its
    ``_get_runner()`` (``BatchRunner(mesh=make_mesh({"data": 4}))``) over
    RUNNER_BATCHES seeded uint8 batches of the global batch: the whole
    gathered output bitwise the one-card runner at the rank's batch on the
    same rows (cuDNN may pick other algorithms at another batch, so the
    one-card runner at the global batch gives only a max |Δ|); the
    aggregate rows/s beside one card's at the global batch, in turns;
    each rank's host stage ms (pad, put, dispatch, fetch)."""
    import numpy as np
    import torch.distributed as dist

    from sparkdl_tpu_torch.runner import events
    from sparkdl_tpu_torch.transformers import DeepImageFeaturizer

    dev = ctx.device
    no_tf32(torch)
    torch.backends.cudnn.benchmark = False
    if dev.type == "cuda":  # the featurizer's "cuda" resolves to cuda:r
        assert torch.cuda.current_device() == dev.index, (
            torch.cuda.current_device(), dev)
    n, big = ctx.size, S.runner_batch
    per = big // n

    def runner(batch: int, devices: int):
        kw = {} if dev.type == "cuda" else {"device": "cpu"}
        f = DeepImageFeaturizer(modelName=S.runner_model,
                                computeDtype=S.runner_dtype,
                                batchSize=batch, seed=0, **kw)
        f.set(f.numDevices, devices)  # > 1: the {"data": n} mesh
        return f._get_runner()

    arms = {"mesh": runner(big, n), "one_card_rank_batch": runner(per, 1),
            "one_card_global_batch": runner(big, 1)}
    assert arms["mesh"].mesh is not None and arms["mesh"]._n == n
    rng = np.random.default_rng(5)
    h = S.runner_size
    wire = [rng.integers(0, 256, (big, h, h, 3), np.uint8)
            for _ in range(S.runner_batches)]
    chunks = [w[k * per:(k + 1) * per] for w in wire for k in range(n)]
    for arm, r in arms.items():  # warm: one batch each
        list(r.run(chunks[:1] if arm == "one_card_rank_batch"
                   else wire[:1]))
    outs, walls, stage_ms = {}, {a: [] for a in arms}, {}
    recorder = events.get_recorder()
    for arm in ("mesh", "one_card_global_batch", "one_card_global_batch",
                "mesh"):
        sync(torch, dev)
        dist.barrier(group=ctx.gang.host_group)  # the ranks start together
        recorder.ring.clear()
        t0 = time.perf_counter()
        outs[arm] = list(arms[arm].run(wire))
        walls[arm].append(time.perf_counter() - t0)
        if arm == "mesh":
            stage_ms = {}
            for ev in recorder.ring:
                if ev.get("ph") == "E" and ev["name"] in (
                        "pad", "put", "dispatch", "fetch"):
                    stage_ms[ev["name"]] = stage_ms.get(ev["name"], 0.0) \
                        + ev.get("dur_s", 0.0) * 1e3
    got = np.concatenate(outs["mesh"])
    t0 = time.perf_counter()
    rank_batch = np.concatenate(list(arms["one_card_rank_batch"].run(
        chunks)))
    walls["one_card_rank_batch"].append(time.perf_counter() - t0)
    whole = np.concatenate(outs["one_card_global_batch"])
    rows = big * S.runner_batches
    assert got.shape == whole.shape == (rows, whole.shape[1]), got.shape
    assert np.isfinite(got).all()
    rec = dict(model=S.runner_model, dtype=S.runner_dtype,
               batches=S.runner_batches, batch_global=big,
               batch_per_rank=per, wire=[h, h, 3], mesh={"data": n},
               cudnn_benchmark=False, rows=rows,
               bitwise_to_one_card_at_rank_batch=bool(
                   np.array_equal(got, rank_batch)),
               bitwise_to_one_card_at_global_batch=bool(
                   np.array_equal(got, whole)),
               max_abs_diff_to_one_card_at_global_batch=float(
                   np.abs(got - whole).max()),
               walls_s=walls, host_stage_ms=stage_ms,
               ranks_alike=same_on_ranks(torch, ctx, [
                   float(got.astype(np.float64).sum())]))
    assert rec["bitwise_to_one_card_at_rank_batch"], rec
    assert rec["ranks_alike"], rec
    del arms, outs
    free(torch, dev)
    return rec


def join_batch_runner_mesh(recs: list) -> dict:
    r0 = recs[0]
    assert all(r["bitwise_to_one_card_at_rank_batch"] for r in recs)
    out = {k: v for k, v in r0.items()
           if k not in ("walls_s", "host_stage_ms")}
    # every rank yields every row: the gang's rate is its slowest rank's
    mesh_s = max(min(r["walls_s"]["mesh"]) for r in recs)
    one_s = [min(r["walls_s"]["one_card_global_batch"]) for r in recs]
    out.update(aggregate_rows_per_s=r0["rows"] / mesh_s,
               one_card_rows_per_s=[r0["rows"] / s for s in one_s],
               aggregate_over_one_card=min(one_s) / mesh_s,
               walls_s_ranks=[r["walls_s"] for r in recs],
               host_stage_ms_ranks=[r["host_stage_ms"] for r in recs],
               max_abs_diff_global_batch_ranks=[
                   r["max_abs_diff_to_one_card_at_global_batch"]
                   for r in recs])
    return out


# --- legs 9 and 10: fleets of groups on cards of their own ----------------------------

# Each group is a gang of its own (``launcher.launch(np=tp, env=
# {"CUDA_VISIBLE_DEVICES": cards})``, this script with ``--fleet-worker``),
# so its rank r is ``cuda:r`` of the cards it sees. ``ref`` survives the
# faults and serves every family's clean engine inline at the end; the
# victim of ``kill`` is rank ``victim_rank`` of group b.
FLEETS = {
    # chip_smoke's phase w: three one-rank groups, on cards 1, 2 and 3
    "fleet_groups": dict(groups=C.W_GROUPS, tp=1,
                         cards={"a": "1", "b": "2", "c": "3"},
                         ref=C.W_REF_GROUP, faults=("doom", "kill"),
                         victim_rank=0),
    # two tp-2 groups, on cards 0-1 and 2-3; b's follower is killed
    "fleet_tp_groups": dict(groups={"a": "paged", "b": "paged"}, tp=2,
                            cards={"a": "0,1", "b": "2,3"}, ref="a",
                            faults=("kill",), victim_rank=1),
}


def fleet_prompts(torch, S, cfg) -> list:
    """Phase u's prompts on the card; on the CPU TP_SLOTS seeded prompts
    of 8 to 32 tokens (each with ``TP_NEW`` new tokens in ``tp_max_len``)."""
    if not S.tiny:
        return C.tp_prompts(torch, cfg)
    g = torch.Generator().manual_seed(21)
    lens = torch.randint(8, 33, (C.TP_SLOTS,), generator=g).tolist()
    return [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
            for n in lens]


def fleet_build(torch, spec: dict, dev) -> tuple:
    """A fleet group's model and engines (``chip_smoke.fleet_group_worker``'s
    ``build``): phase w's on the cards (``chip_smoke.w_build``); on the
    CPU the tiny model in f32 and ``w_engine`` at the tiny sizes, the
    kernels' plain versions counted as their launches."""
    if not spec["tiny"]:
        return C.w_build(torch, spec, dev)
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.ops import flash_decode as fd
    from sparkdl_tpu_torch.ops import paged_flash_decode as pfd

    torch.set_num_threads(1)
    count_plain_calls((fa, fd, pfd))
    S = sizes(True)
    model = build_llama(torch, L, llama_cfg(L, S, S.fleet_layers),
                        torch.float32, dev, 21, fa.flash_attention)
    return model, lambda family: C.w_engine(
        torch, model, family, spec["tp"], slots=S.tp_slots,
        max_len=S.tp_max_len, chunk=S.tp_chunk, block=S.fleet_block), \
        S.fleet_layers


def fleet_leg(torch, S, device: str, leg: str) -> dict:
    """The groups of ``FLEETS[leg]``, each a gang of this script's
    ``--fleet-worker`` on cards of its own, behind this process's
    ``EngineFleet`` (``chip_smoke.fleet_remote``: the clean leg, then
    each fault, every stream audited and held to the clean engines')."""
    from sparkdl_tpu_torch.models import llama as L

    f = FLEETS[leg]
    t0 = time.perf_counter()
    out = C.fleet_remote(
        torch, fleet_prompts(torch, S, llama_cfg(L, S, S.fleet_layers)),
        groups=f["groups"], tp=f["tp"], ref=f["ref"], faults=f["faults"],
        victim_rank=f["victim_rank"], cards=f["cards"], device=device,
        script=__file__, flag="--fleet-worker",
        env={"OMP_NUM_THREADS": "1"} if device == "cpu" else None,
        tag="torch_multicard " + leg, extra=dict(tiny=S.tiny))
    ranks = out.pop("ranks")
    return dict(
        config=(f"LlamaConfig.llama3_8b(), {S.fleet_layers} layers, bf16"
                if not S.tiny else f"LlamaConfig.tiny(), {S.fleet_layers} "
                "layers, f32"), tp=f["tp"], group_cards=f["cards"],
        groups={n: dict(family=f["groups"][n],
                        ranks=[dict(rank=g["rank"], device=g["device"],
                                    counts=g["counts"],
                                    drained=g.get("drained"),
                                    graphs=g["graphs"],
                                    peak_gb=g["peak_gb"]) for g in rs])
                for n, rs in ranks.items()},
        **out, seconds=time.perf_counter() - t0)


# --- the gang's worker and the parent ----------------------------------------------

RUN = {"comms": leg_comms, "dp_resnet50": leg_dp_resnet50,
       "dp_m": leg_dp_m, "tp_serve": leg_tp_serve,
       "fsdp_tp_train": leg_fsdp_tp_train, "sp": leg_sp, "moe": leg_moe,
       "gpipe": leg_gpipe, "batch_runner_mesh": leg_batch_runner_mesh}


def worker(args) -> int:
    """One rank: join the gang (NCCL on the card, gloo on the CPU), run
    the legs in order, write ``<leg>_rank<r>.json`` after each."""
    os.dup2(2, 1)  # the parent's stdout carries only its own lines
    import torch

    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.ops import flash_decode as fd
    from sparkdl_tpu_torch.ops import paged_flash_decode as pfd
    from sparkdl_tpu_torch.runner import XlaRunner
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    if args.device == "cpu":
        torch.set_num_threads(1)
    kernels = (fa, fd, pfd)
    if args.device == "cpu":
        count_plain_calls(kernels)
    S = sizes(args.tiny)
    ctx = XlaRunner(device=args.device).make_context()
    want = "nccl" if args.device == "cuda" else "gloo"
    assert ctx.gang is not None and ctx.gang.backend == want, ctx.gang
    assert ctx.size == WORLD, ctx.size
    d = Path(args.worker)
    try:
        for leg in args.legs:
            t0 = time.perf_counter()
            kw = {"tp_init": args.tp_init} if leg == "tp_serve" else \
                {"moe_init": args.moe_init} if leg == "moe" else {}
            rec = RUN[leg](torch, ctx, S, kernels, str(d), **kw)
            rec["leg_s"] = time.perf_counter() - t0
            (d / f"{leg}_rank{ctx.rank}.json").write_text(json.dumps(rec))
            free(torch, ctx.device)
    finally:
        leave_gang()
    return 0


JOIN = {"comms": join_comms, "dp_m": join_dp_m, "tp_serve": join_tp_serve,
        "fsdp_tp_train": join_fsdp_tp_train, "sp": join_sp,
        "moe": join_moe, "gpipe": join_gpipe,
        "batch_runner_mesh": join_batch_runner_mesh}


def env_line(torch, device: str) -> dict:
    import torch.distributed as dist

    rec = dict(leg="env", torch=torch.__version__,
               cuda=torch.version.cuda, python=sys.version.split()[0],
               nccl_env={k: v for k, v in os.environ.items()
                         if k.startswith(("NCCL_", "TORCH_NCCL_"))},
               dev_shm_bytes=shutil.disk_usage("/dev/shm").total
               if os.path.isdir("/dev/shm") else None,
               dist_available=dist.is_available())
    if device == "cuda":
        rec["cards"] = smi_lines()
        v = torch.cuda.nccl.version()
        rec["nccl_version"] = (".".join(map(str, v)) if isinstance(v, tuple)
                               else str(v))
        rec["topology"] = subprocess.run(
            ["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    else:
        rec["cards"] = ["cpu"] * WORLD
    return rec


def one_rank_resnet(torch, S, device: str) -> dict:
    """dp_resnet50's timed arm as a one-rank gang on ``cuda:0`` (or the
    CPU), joined in this process."""
    from sparkdl_tpu_torch.runner import XlaRunner, launcher
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    runner = XlaRunner(device=device, num_processes=1, process_id=0,
                       coordinator=f"127.0.0.1:{launcher.free_port()}")
    try:
        return resnet_timed(torch, runner.make_context(), S)
    finally:
        leave_gang()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths (the CPU gang's)")
    ap.add_argument("--legs", default=",".join(LEGS),
                    help="comma-separated subset of " + ",".join(LEGS))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "torch_multicard.json"))
    ap.add_argument("--tp-init", default=None,
                    help="(CPU) tp_serve's f32 model and prompts: a "
                         "torch.save'd {cfg, params (flax tree), prompts}")
    ap.add_argument("--moe-init", default=None,
                    help="(CPU) moe's module and input: a torch.save'd "
                         "{params (flax tree), x}")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--fleet-worker", nargs=2, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.legs = [x for x in args.legs.split(",") if x]
    bad = [x for x in args.legs if x not in LEGS]
    if bad:
        ap.error(f"unknown legs {bad}")
    if args.worker:
        return worker(args)
    if args.fleet_worker:
        return C.fleet_group_worker(*args.fleet_worker, build=fleet_build)
    if args.device == "cpu" and not args.tiny:
        ap.error("the CPU runs only the tiny gang: --device cpu --tiny")
    import torch

    if args.device == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < WORLD:
            print(f"torch_multicard: needs {WORLD} CUDA cards, sees {n}; "
                  f"no leg run (the CPU rehearsal is --device cpu --tiny)",
                  file=sys.stderr)
            return 2
    walls = {}
    t0 = time.perf_counter()
    if args.device == "cuda":
        from sparkdl_tpu_torch.ops import _build
        _build.library()  # once, so the four ranks load it built
        walls["build"] = time.perf_counter() - t0
    env = env_line(torch, args.device)
    C.emit(env)
    record = dict(env=env, legs={})
    from sparkdl_tpu_torch.runner import launcher

    S = sizes(args.tiny)
    d = tempfile.mkdtemp(prefix="sparkdl_multicard_")
    gang_env = {"OMP_NUM_THREADS": "1"} if args.device == "cpu" else {}
    gang_legs = [x for x in args.legs if x in GANG_LEGS]
    fleet_legs = [x for x in args.legs if x in FLEET_LEGS]
    fleets = {}  # leg: (record, or the exception it raised; seconds)

    def run_fleets():
        for leg in fleet_legs:
            t = time.perf_counter()
            try:
                fleets[leg] = (fleet_leg(torch, S, args.device, leg),
                               time.perf_counter() - t)
            except Exception as e:  # noqa: BLE001 — raised below
                fleets[leg] = (e, time.perf_counter() - t)
                return

    # on the CPU the fleets' gangs run beside the four-rank gang; on the
    # cards they take the cards once it has ended
    side = threading.Thread(target=run_fleets, daemon=True) \
        if args.device == "cpu" and fleet_legs else None
    if side is not None:
        side.start()
    err = None
    try:
        t = time.perf_counter()
        try:
            if gang_legs:
                launcher.launch(
                    __file__, np=WORLD, env=gang_env,
                    timeout_s=GANG_TIMEOUT_S,
                    args=["--worker", d, "--device", args.device,
                          "--legs", ",".join(gang_legs)]
                    + (["--tiny"] if args.tiny else [])
                    + (["--tp-init", args.tp_init] if args.tp_init else [])
                    + (["--moe-init", args.moe_init] if args.moe_init
                       else []))
        except Exception as e:  # print the legs that finished, then raise
            err = e
        if gang_legs:
            walls["gang"] = time.perf_counter() - t
        for leg in gang_legs:
            files = [Path(d) / f"{leg}_rank{r}.json" for r in range(WORLD)]
            if not all(f.exists() for f in files):
                break
            recs = [json.loads(f.read_text()) for f in files]
            if leg == "dp_resnet50":
                t = time.perf_counter()
                one = None if err else one_rank_resnet(torch, S,
                                                       args.device)
                walls["dp_resnet50_one_rank"] = time.perf_counter() - t
                rec = join_dp_resnet50(recs, one)
            else:
                rec = JOIN[leg](recs)
            rec = dict(leg=leg, leg_s=[r["leg_s"] for r in recs], **{
                k: v for k, v in rec.items() if k != "leg_s"},
                cards=env["cards"])
            record["legs"][leg] = rec
            C.emit({k: v for k, v in rec.items()
                    if k not in ("streams", "prompt_ids", "tensors_ranks")})
            walls[leg] = max(r["leg_s"] for r in recs)
        if side is not None:
            side.join()
        elif fleet_legs and err is None:  # this process holds no model
            free(torch, torch.device(args.device))
            run_fleets()
        for leg in fleet_legs:
            if leg not in fleets:
                break
            rec, walls[leg] = fleets[leg]
            if isinstance(rec, Exception):
                err = err or rec
                break
            rec = dict(leg=leg, **rec, cards=env["cards"])
            record["legs"][leg] = rec
            C.emit({k: v for k, v in rec.items() if k != "legs"}
                   | {"legs": [{k: v for k, v in lg.items()
                                if k not in ("placed", "ended")}
                               for lg in rec["legs"]]})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    walls["total"] = time.perf_counter() - T_START
    record["phase_walls"] = walls
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    if err is not None:
        raise err
    C.emit({"phase_walls": walls})
    kind = env["cards"][0].split(",")[0].strip()
    C.emit({"ok": True, "device": {
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "kind": kind, "count": WORLD}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
