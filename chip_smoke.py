#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``sparkdl_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with one CUDA device::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises, so the exit
code is not 0:

a. build — every ``sparkdl_tpu_torch/csrc/*.cu`` through its own ``nvcc``
   for ``sm_90a``, all started together, then one link; timed; registers
   and spills from ptxas (the most of any kernel, every spilling kernel,
   each tensor-core flash-attention kernel by head dim, the split-KV
   decode variants and the twelve backward kernels — delta in bf16 and
   f32, the f32 CUDA-core pair and the bf16 tensor-core pair, each at D
   64 and 128 — none of which may spill); the card's name and power
   limit from ``nvidia-smi``.
b. kernels — each kernel against its plain PyTorch version on the same
   inputs on the card, in f32 and bf16 (tolerances at ``TOL``), at the
   main path's shapes:
   flash_attention at B=4, H=16, S=2048, D=128, causal, left-pad kv_mask;
   flash_attention at a ragged S=1000 with an all-masked row (O exactly 0
   there); each flash record names its kernel variant (``tc_mma_bf16``
   for bf16, ``fma_f32`` for f32); a bf16 record adds the 64x64 tile
   pairs the tensor-core kernel walked, counted by the kernel, which must
   equal those that a model of the mask says it computes (printed beside
   the pairs that hold a live score), and the TFLOP/s it achieves on the
   live work; then one sweep of the bf16 kernel against
   ``dense_attention`` at S = 128 ... 2048 (B=4, H=16, D=128, causal, no
   pad), which records the shortest S where the kernel wins (the
   ``SPARKDL_FLASH_MIN_SEQ`` crossover); flash_decode at the main path's
   first decode step, at per-row fill levels, and at llama3_8b's 32:8 GQA
   layout. Each prints the kernel's time, its bound, the plain version's
   time and, as a yardstick the port never calls,
   ``F.scaled_dot_product_attention``'s.
   flash_attention_bwd at phase g's shape (B=2, H=32, S=2048, D=128,
   causal, no mask) and at a ragged S=1000 with a left pad and an
   all-masked row (its dq, dk, dv exactly 0), in bf16 (the tensor-core
   variant, ``tc_mma_bf16``) and f32 (``fma_f32``), O and lse from the
   forward kernel: (dq, dk, dv) held to ``fa.bwd_tolerance`` of the
   record's variant against ``fa.attention_bwd_plain``, and a second call
   bitwise equal to the first; each record gives TFLOP/s on the bound's
   five products and on the seven the two stages issue; the yardstick is
   the backward alone of SDPA under autograd on the same inputs.
   At phase h's shapes (B=32, H=12, D=64, not causal, right pads from its
   length draw with one row of 128 and one of 1): flash_attention and
   flash_attention_bwd at S=128 and at a ragged S=77, bf16; every masked
   column's dK and dV (the wholly dead K tiles among them) exactly 0;
   each backward record adds the forward plus backward time of the
   kernels and of SDPA (``fwd_bwd_ms``, ``library_fwd_bwd_ms``).
   paged_flash_decode at ``LlamaConfig.small()``'s serving shapes (8
   slots, 16/8 heads, D 128, block 16, 132 blocks a table), ragged fills
   [2047, 1500, 900, 513, 300, 64, 17, 0] (the last slot parked on the
   trash block), non-contiguous tables, every block no live range reads
   filled with NaN; S = 1 and S = 5; bf16 and f32 pools, int8 and fp8
   pools with scales. Its SDPA yardstick runs on the pre-gathered dense
   view and so excludes the gather.
   Both decode kernels are split-KV launches: each record carries the
   wrapper's plan (``chunk`` positions a split, ``n_splits``,
   ``rows_per_block``) and the blocks the kernel counted itself, those
   it ran and those that found a live position (``grid_blocks``,
   ``live_blocks``), asserted equal to the plan's model
   (``*_blocks_model``). Every time is the mean of CUDA events around
   one launch after a flush and a device sleep (``time_ms``);
   an ``event_floor`` line times an empty kernel the same way. The two
   main-path cases add the profiler's kernel time (``profiler_ms``), the
   time with the L2 flushed by a read instead of a write
   (``ms_read_flush``) and the time of the same launch with one live
   position a row (``fixed_ms``).
c. main path — ``generate()`` on ``LlamaConfig.small()`` at full width and
   depth (2048 hidden, 16 layers, 16/8 heads, head_dim 128, vocab 32000),
   bf16, random weights from a seeded generator on the card; four prompts
   of 2048, 1500, 700 and 33 tokens, left-padded; 64 new tokens, greedy.
   Four calls in turns: eager, graph, graph, eager. The graph arm is
   ``generate()`` as shipped, every S = 1 step replayed from a CUDA graph
   captured at its first step; the eager arm is the same call with its
   decode loop calling the eager step (``L._decode_step``) directly. Each
   prints a ``main_path`` line: prefill ms, decode ms a step (with and
   without the capture), capture ms (from the ``graph_capture`` event),
   new tokens/s. The launch counters are set to 0 just before each call
   and read just after: flash_attention must have launched once a layer,
   flash_decode once a layer per decode step, in both arms; the greedy
   tokens of every call must be equal. Then three ``profile`` lines: two
   prefills, 4 eager decode steps and 4 replayed ones (device busy and
   idle share from ``torch.profiler``, beside wall and CUDA-event ms; a
   window where the profiler sees no device activity says so).
d. parity — the same model in f32 (TF32 off): the dense in-model path
   (``attn_fn=None``) is fed the kernel path's tokens and its logits are
   held to the kernel path's at the prefill's last position and at every
   decode step.
e. serve — ``GenerationEngine.from_model`` on ``LlamaConfig.small()`` at
   full width and depth, bf16, seeded random weights on the card; four
   legs, each a fresh engine and one JSON line (requests completed, new
   tokens/s over the leg, TTFT p50/p95, mean decode-iteration ms, peak
   device memory, launch counters set to 0 just before the leg and read
   just after, the backend's graph captures and replays, which must be
   one capture and a replay for every later S = 1 step, and capture ms).
   After leg 1, two ``profile`` lines of 4 iterations with 8 slots
   decoding: the step from the graph, with the iteration split by the
   host clock (scheduler, operands, tables, replay, the ``_advance``
   sync), and the eager step (``L.paged_slot_decode_step`` called
   directly):
   1. paged (block 16, 256-token chunks), 12 requests of 32–1536 prompt
      tokens, four sharing their first 512 (radix grafts), 32 new tokens
      each: paged_flash_decode launches == 16 × engine steps, and
      flash_decode none;
   2. the same with ``spec_k=4`` (n-gram drafts), 4 requests whose
      prompts repeat n-grams: 16 paged launches per verify or decode
      iteration;
   3. ``kv_dtype="int8"``, 4 requests: the same identity, on int8 codes;
   4. unpaged blocking (``block_size=0, stall_free=False``), 4 requests:
      flash_attention launches == 16 × prefills and flash_decode
      launches == 16 × steps.
f. serve parity — f32, TF32 off, full depth: the paged engine (kernel)
   against the port's static ``generate()`` (flash kernels) on 4 prompts,
   16 new tokens each. Greedy streams must be identical at every position
   whose top-2 logit gap (from one dense forward over each finished
   sequence) exceeds 10 × ``LOGIT_TOL``; a flip below that is printed as
   a near tie with its gap.
g. train — ``XlaRunner(np=1).run(lambda ctx: ctx.fit(...))`` with
   ``causal_lm_loss_fn()`` and ``lora_optimizer(1e-3)`` on
   ``LlamaConfig.llama3_8b(lora_rank=16)`` at full width and depth (32
   layers, 4096 hidden, 32/8 heads, head_dim 128, FFN 14336, vocab
   128256), bf16, seeded random weights on the card, 6 steps of one
   seeded 2 x 2048 batch, ``log_every=1``. One ``train`` line: step ms
   (median after the first step), tokens/s, MFU from ``train_flops``
   against the bf16 peak, peak device memory, the losses; the launch
   counters, set to 0 just before the fit and read just after, must show
   32 flash_attention and 32 flash_attention_bwd launches a step, all of
   the backward's of the ``tc_mma_bf16`` variant; the losses finite and
   falling; a checksum of five base weights unchanged and every adapter
   moved. Then a ``profile`` line of one more step, which lists the
   backward's kernels by name (the tensor-core dK/dV and dQ kernels must
   be there), and a ``train_parity`` line: the same widths at depth 2,
   f32, TF32 off, the kernel arm's loss and adapter gradients against
   the dense arm's (``TRAIN_LOSS_TOL``, ``TRAIN_GRAD_SHARE``).

h. glue — BASELINE configuration 4, the BERT-base GLUE fine-tune:
   ``BertConfig.base()`` at full width and depth (12 layers, 768 hidden,
   12 heads, head_dim 64, FFN 3072, vocab 30522, dropout 0.1, 2 classes),
   f32 parameters computed in bf16, seeded random weights, TF32 off;
   ``XlaRunner(np=1).run(lambda ctx: ctx.fit(bert_finetune_loss(model),
   ..., with_rng=True))`` with Adam for ``GLUE_STEPS`` steps of the BERT
   paper's GLUE recipe (batch 32, max length 128): seeded numpy batches
   through a ``FactoryDataset``, row lengths in 8-128, right padded,
   labels from a learnable rule on the first token. One ``glue`` line:
   step ms (median after the first step), examples/s, live tokens/s, MFU
   (``glue_flops``; its formula printed beside it), peak memory, the
   losses (finite, the last five's mean below the first five's), and the
   launch counters, set to 0 just before the fit and read just after:
   12 flash_attention and 12 flash_attention_bwd (all ``tc_mma_bf16``)
   launches a step, so no layer attended densely. Then a ``profile`` line
   of one more step (the forward and both backward kernels by name), and
   ``glue_parity``: depth 2, f32, TF32 off, no dropout, the kernel arm's
   loss and every parameter gradient against the dense arm's (the key
   biases, whose gradient is rounding noise, held near 0 in both), and
   ``with_rng`` on a CUDA generator (one seed repeats two steps' losses
   to the bit, another changes them).
i. classify — ``udf.classify_rows`` (the sequence-classification UDF's
   device step, no DataFrame) on phase h's model: 4096 seeded rows of
   lengths 8-128 in chunks of 256, rows/s and the flash launches (12 a
   chunk); predictions equal to the f32 dense arm's (same weights) on
   every row whose top-2 logit gap allows it: the f32 kernel arm's beyond
   10 x the f32 parity tolerance, the bf16 arm's beyond 10 x 2^-6·(1 +
   |logit|).

j. image scoring — BASELINE configurations 1 and 2 on the card, with no
   DataFrame: the device step is ``DeepImageFeaturizer(...)._get_runner()``
   (the runner ``_transform`` uses; seeded random weights at full width
   and depth) over uint8 BGR NHWC wire batches made from a numpy seed,
   half at the model's input size (the prologue skips the resize) and
   half at a larger native size (320x320 for 299, 256x256 for 224; the
   prologue downscales). Image convolutions are cuDNN and the dense
   layers cuBLAS (no Pallas kernel on this path, so no ``kernels`` entry):
   - ``featurize``: 4096 rows an arm: InceptionV3 bf16 and f32 (TF32 off,
     then on, the flag in each line), ResNet50 bf16, all at 256 a batch,
     and InceptionV3 bf16 at the transformer's default 32 a batch. Each
     line: rows/s, ms a batch (median interval between outputs), peak
     device memory, FLOPs a row from the model's own conv and dense
     shapes (``image_flops``), achieved TFLOP/s and its share of 989,
     the bytes the host copies to the device and their DMA time (CUDA
     events around one pinned copy of each wire shape), and the host
     time of the runner's stages (flight-recorder spans);
   - a ``profile`` line over 4 batches of the InceptionV3 bf16 arm
     (``device_profile``): busy, idle share, launches a batch, top kernels;
   - ``transfer``: ``LogisticRegression._fit_arrays`` on the card on the
     4096 InceptionV3 bf16 features, the labels two image classes of
     different mean colour; fit seconds and train accuracy (> 0.9), and
     predictions equal to a CPU fit's on the same features wherever the
     CPU model's top-2 probability margin exceeds ``TRANSFER_MARGIN``;
   - ``image_parity`` (TF32 off): each of the nine registry models, f32,
     features on the card against the port's CPU forward with the same
     weights on 2 full-size images (``IMAGE_F32_RULE``), bf16 features
     on the card against the card's f32 (``IMAGE_BF16_RULE``), and the
     prologue's resize on the card against the CPU's, up and down
     (``RESIZE_ATOL``), the same-size skip bit-exact.

k. ResNet-50 training — BASELINE configuration 3 at ``np=1``:
   ``get_model("ResNet50")`` at full width and depth, 224², 1000 classes,
   seeded random weights on the card, through ``XlaRunner(np=1).run(
   lambda ctx: ctx.fit(bn_classifier_loss(preprocess=...), sgd(0.1,
   momentum=0.9), mutable=True, log_every=1, flops_per_step=...))`` over
   uint8 NHWC wire batches of 256 (config 3's per-card batch) made from a
   numpy seed, whose label (10 of the 1000 classes) sets their mean
   brightness. Convolutions on cuDNN, the head on cuBLAS, BatchNorm in
   train mode on PyTorch's native kernel (no Pallas kernel on this path,
   so no ``kernels`` entry; the launch counters must read 0):
   - ``resnet_train``: f32 parameters computed in bf16, 3 warm-up steps
     then 20 timed ones (from a step's loss call to the next's, each
     step ending in the loss's read): img/s (BASELINE's metric), step ms
     (median, p10/p90, min/max), MFU against 989 TFLOP/s with forward +
     backward = 3 × ``image_flops`` a row, peak memory; the losses finite
     and the last five's mean below the first five's; every BatchNorm
     statistic moved. Four such arms, inline and with
     ``feed_lookahead=2`` (each batch pinned and copied on a side stream
     ahead of its step) in turn, ``arm`` and ``feed_lookahead`` in each
     line. Then a ``profile`` line of 3 bf16 steps (busy, idle share,
     launches a step, top kernels). Then the same at f32 compute, TF32
     off (the flag in the line), 4 steps;
   - ``resnet_train_parity`` (f32, TF32 off): ResNet18 at 10 classes,
     32², batch 8 (``__graft_entry__.py``'s ResNet18 step); two mutable
     steps on the card against the same steps on the CPU, each from the
     card's state before it, parameters and statistics within
     ``RESNET_PARITY_*_SHARE`` of the step's change; the first step again
     with TF32 on, ``tf32_control``, which must fall outside both; one
     step with ``remat=True`` must leave the statistics as
     ``remat=False`` does (updated once);
   - ``checkpoint``: ResNet-50 at 64 a batch, ``fit(checkpoint_every=2)``
     for 4 steps, then a second fit with the same ``checkpoint_dir`` to 6
     (resumed at 4); the restored model and momentum buffers bit-identical
     to the saved ones; the newest step's file corrupted, and the restore
     rolls back to step 4 (``run_stats`` records it); the bytes of a step
     and the seconds of a waiting save, an asynchronous one (return and
     landing) and a restore. The directory is a temporary one.
l. data parallelism (BASELINE config 3's gang) and the other train modes:
   - ``dp_gang``: ``launcher.launch(np=1)`` starts this script again as
     the worker (``chip_smoke.py --dp-worker <dir>``), once the parent
     has freed its cached memory; the worker joins a one-rank NCCL gang
     through ``XlaRunner()`` (rank 0 on ``cuda:0``) and runs phase k's
     ResNet-50 bf16 arm (256 a batch, 3 warm-up and 20 timed steps,
     ``resnet_fit``) through the gang's implicit step: synchronised
     BatchNorm (two all-reduces a layer) and one gradient all-reduce.
     The line: img/s/chip, step ms (median, p10/p90), MFU
     (``image_flops``), peak memory, the meter's per-chip rate, launches
     a step and the NCCL kernels' device ms a step and share of busy
     from a profile of 3 steps, beside phase k's inline bf16 arms from
     the same call. Losses finite and falling, every statistic moved,
     the four kernels' counters 0 (no Pallas kernel on this path);
   - ``dp_parity`` (f32, TF32 off): one gang step of phase k's parity
     model (ResNet18, 32², batch 8) from its seed, written by the
     worker, against the same step in this process, within phase k's
     limits (``RESNET_PARITY_*_SHARE``; the two BatchNorms take the
     variance differently, so not bitwise); the gang's statistics with
     ``remat`` bitwise as without;
   - ``dp_refuses``: ``XlaRunner(np=cards + 1)`` raises ``ValueError``
     before any process group is made (NCCL runs one rank a card);
   - ``inception_train`` and ``xception_train``: InceptionV3 and
     Xception at 299, bf16, 4 mutable SGD steps of 64 through
     ``XlaRunner(np=1).fit``; losses finite, every statistic moved.

Then a ``{"kernels": [...]}`` line (four kernels: flash_attention,
flash_decode, paged_flash_decode, flash_attention_bwd; the two flash
entries add their BERT case and phase h's launches) and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, it prints no result and exits 2. Imports
nothing of JAX, and no pyarrow or pandas.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

H100_BYTES_S = 3.35e12            # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # f32 outside the tensor cores
# kernel vs plain, elementwise |kernel - plain| <= atol + rtol * |plain|.
# Both compute in f32. In f32 out they differ in summation order only
# (measured < 1e-6). In bf16 out each rounds its f32 value once, so they
# may land one bf16 step apart, and one step is at most 2**-7 of the
# value; atol covers the f32 differences under that rounding.
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-5, 2.0 ** -7)}
# bf16 flash_attention runs on the tensor cores ("tc_mma_bf16"), which
# round P to bf16 before P·V (the plain version keeps p in f32); it is
# held to fa.tc_bf16_tolerance, which adds 2**-8·(P|V|)_plain to the rule
# above (the reason is in that function).
FLASH_SWEEP = [128, 256, 512, 1024, 2048]
LOGIT_TOL = 2e-3
SLEEP_CYCLES = 200_000  # ~0.1 ms of device sleep ahead of each timed launch
PROMPT_LENS = [2048, 1500, 700, 33]
NEW_TOKENS = 64
PARITY_TOKENS = 16
# paged_flash_decode cases: LlamaConfig.small()'s serving shapes
PAGED_CUR = [2047, 1500, 900, 513, 300, 64, 17, 0]  # slot 7 parked on trash
PAGED_PADS = [0, 0, 37, 0, 0, 0, 0, 0]
PAGED_BS, PAGED_MB = 16, 132
SERVE_NEW = 32
# phase g: llama3_8b(lora_rank=16), bf16, 2 x 2048 tokens a step
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 2048, 6, 1e-3
# phase g parity (f32, TF32 off): |loss_kernel - loss_dense| and each
# adapter's max |grad_kernel - grad_dense| as a share of its max
# |grad_dense|. The two arms differ in summation order only (f32 FMA
# kernels against cuBLAS): the share read 8.4e-6 here and 1.45e-6 on the
# card tests' 2-layer D 64 model (NVIDIA H100 80GB HBM3, 700 W).
TRAIN_LOSS_TOL, TRAIN_GRAD_SHARE = 1e-4, 1e-4
# phase h: BertConfig.base(), the GLUE recipe of Devlin et al. 2019, §4.1
# (batch 32, max length 128, Adam at 3e-5, one of the paper's rates);
# row lengths drawn in 8-128, right padded; the first token one of
# GLUE_IDS ids, the label its upper half
GLUE_BATCH, GLUE_SEQ, GLUE_STEPS, GLUE_LR = 32, 128, 30, 3e-5
GLUE_MIN_LEN, GLUE_IDS = 8, 10
# phase h parity (f32, TF32 off, depth 2): the loss and each gradient's
# share of its largest, as phase g's; the key biases' gradient is zero up
# to rounding (a bias on every key shifts a query's scores by one
# constant), so they are held below GLUE_KEY_BIAS_SHARE of the model's
# largest gradient in both arms instead
GLUE_KEY_BIAS_SHARE = 1e-6
# phase i: 4096 rows of lengths 8-128 in chunks of 256
CLASSIFY_ROWS, CLASSIFY_CHUNK = 4096, 256
# phase i holds predictions to the f32 dense arm where the top-2 logit gap
# exceeds 10 x the f32 parity tolerance (the f32 kernel arm), or 10 x the
# bf16 logit rule of tests/test_torch_bert.py, 2**-6·(1 + |logit|) (the
# bf16 kernel arm, phase h's model)
BF16_LOGIT_RTOL = 2.0 ** -6
# phase j: 4096 rows an arm, wire batches half at the model's input size,
# half at NATIVE_SIZE (the prologue downscales those)
IMAGE_ROWS, IMAGE_BATCH = 4096, 256
NATIVE_SIZE = {299: 320, 224: 256}
# phase j parity. f32 card vs CPU: cuDNN and the CPU's convolutions sum in
# other orders (and cuDNN may pick Winograd / FFT algorithms), so the rule
# is the CPU tests' f32 rule widened tenfold: |Δ| ≤ 1e-4·max(1, max|ref|)
# + 1e-3·|ref|. bf16 vs f32: |Δ| ≤ 2^-5·max|f32| (the tests' bf16 rule).
# The resize, card vs CPU, on the 0-255 scale: |Δ| ≤ 1e-2 (the tests'
# rule against jax.image.resize), the same-size skip exact.
IMAGE_F32_RULE = (1e-4, 1e-3)
IMAGE_BF16_RULE = 2.0 ** -5
RESIZE_ATOL = 1e-2
# phase j transfer: predictions of the card's fit equal the CPU fit's
# wherever the CPU model's top-2 probability margin exceeds this
TRANSFER_MARGIN = 1e-3
# phase k: BASELINE configuration 3's per-card batch, ResNet-50 at 224,
# 1000 classes, sgd(0.1, momentum=0.9); uint8 wire batches whose label
# (one of RESNET_COLOURS classes) sets their mean brightness
RESNET_BATCH, RESNET_SIZE, RESNET_LR = 256, 224, 0.1
RESNET_WARMUP, RESNET_TIMED, RESNET_F32_STEPS = 3, 20, 4
# the bf16 arm again with fit(feed_lookahead=) at this depth: the batch's
# copy on a side stream, ahead of the step
RESNET_LOOKAHEAD = 2
RESNET_COLOURS, RESNET_DISTINCT = 10, 8
# phase k parity (f32, TF32 off): ResNet18 at 10 classes, 32², batch 8
# (the shape of __graft_entry__.py's ResNet18 step), each step on the card
# and on the CPU from the same state. Parameters: the largest |card − CPU|
# as a share of the largest change the step made; each statistic the
# same against its own change. Set from the card's readings (parameters
# 1.5e-5, the worst statistic 8.4e-6) with room, and far below what the
# same step gives with TF32 on (0.29 and 5.6e-3, the line's
# ``tf32_control``), so a convolution that ran in TF32, or a fault of that
# size in BatchNorm, fails.
RESNET_PARITY_PARAM_SHARE, RESNET_PARITY_STAT_SHARE = 1e-3, 1e-4
RESNET_PARITY_BATCH = 8
# phase k checkpoint: ResNet-50 at 64 a batch, saves every 2 steps
CKPT_BATCH = 64
# phase l: the one-rank NCCL gang (phase k's batch, wire and steps; its
# parity at phase k's parity shape and limits); InceptionV3 and Xception
# train steps at 299, bf16
DP_TIMEOUT_S = 600.0
IMAGE_TRAIN_BATCH, IMAGE_TRAIN_STEPS, IMAGE_TRAIN_LR = 64, 4, 0.01


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 10, flush=None,
            read_flush: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, CUDA events
    around each launch; ``flush`` (a large buffer) is zeroed before each
    one so the inputs come from device memory, not the 50 MB L2 (with
    ``read_flush``, read instead, which leaves the L2 clean rather than
    full of dirty lines to write back). A device-side sleep of
    ``SLEEP_CYCLES`` precedes the start event, so the device is still busy
    while the host enqueues ``fn`` and the events bracket the device work
    only, not the wrapper's host time."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.sum() if read_flush else flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def profiler_kernel_ms(torch, fn, match: str, iters: int = 10,
                       flush=None) -> float | str:
    """Mean device time per call of the kernels whose name holds
    ``match``, from ``torch.profiler`` over ``iters`` calls of ``fn``
    (flushed as in :func:`time_ms`): the cross-check of the event time.
    "not measured" when the profiler sees no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "device_time_total", 0.0) or 0.0
             for ev in prof.key_averages() if match in ev.key)
    return us / iters / 1e3 if us else "not measured"


def split_record(torch, launch, npos: int, rows: int, spans,
                 hkv: int) -> dict:
    """Runs ``launch(counter)`` once with the kernel's block counter and
    returns the wrapper's split plan with the blocks the kernel counted,
    asserted equal to the plan's model (``split_blocks`` over the slots'
    live ``spans``)."""
    from sparkdl_tpu_torch.ops.flash_decode import split_blocks

    cnt = torch.zeros(2, dtype=torch.int32, device="cuda")
    launch(cnt)
    model = split_blocks(npos, rows, hkv, spans)
    ran, live = cnt.tolist()
    assert (ran, live) == (model["grid_blocks"], model["live_blocks"]), (
        ran, live, model)
    return dict(chunk=model["chunk"], n_splits=model["n_splits"],
                rows_per_block=model["rows_per_block"], grid_blocks=ran,
                live_blocks=live, grid_blocks_model=model["grid_blocks"],
                live_blocks_model=model["live_blocks"])


def check_close(got, want, dtype: str, what: str, allowed=None) -> float:
    """Hold ``got`` to ``want`` elementwise within ``allowed`` (by
    default ``TOL[dtype]``: atol + rtol·|want|); return the max
    |got - want|."""
    diff = (got.float() - want.float()).abs()
    if allowed is None:
        atol, rtol = TOL[dtype]
        allowed = atol + rtol * want.float().abs()
    excess = (diff - allowed).max().item()
    err = diff.max().item()
    assert excess <= 0, (f"{what} {dtype}: |kernel - plain| exceeds its "
                         f"tolerance by {excess} (max |kernel - plain| "
                         f"{err})")
    return err


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / H100_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ptxas_summary(log: str | None) -> dict | str:
    """Registers and spill stores of every kernel, from ``nvcc -Xptxas
    -v``: the most registers any kernel uses, and each kernel that
    spills (mangled name, cut). "not measured" without a report."""
    import re

    if not log:
        return "not measured"

    fn, regs, spills = None, {}, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spills[fn] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[fn] = int(m.group(1))
    tc = {}
    for fn, n in regs.items():
        m = re.search(r"fa_fwd_tc_kernelILi(\d+)E", fn)
        if m:
            tc[f"D{m.group(1)}"] = dict(registers=n,
                                        spill_bytes=spills.get(fn))
    skv = [f for f in regs if "splitkv_kernel" in f]
    bwd = {}
    for fn, n in regs.items():
        m = re.search(r"fa_bwd_(delta|dkdv|dq)(_tc)?_kernelI(\w*?)Li(\d+)E",
                      fn)
        if m:
            kind = ("tc_bf16" if m.group(2) else
                    "bf16" if "bfloat16" in m.group(3) else "f32")
            bwd[f"{m.group(1)}_{kind}_D{m.group(4)}"] = dict(
                registers=n, spill_bytes=spills.get(fn))
    return dict(kernels=len(regs), max_registers=max(regs.values(),
                                                     default=None),
                spilling={f[:90]: n for f, n in spills.items() if n},
                flash_attention_tc=tc, flash_attention_bwd=bwd,
                decode_splitkv=dict(
                    variants=len(skv),
                    max_registers=max((regs[f] for f in skv), default=None),
                    spill_bytes=sum(spills.get(f) or 0 for f in skv)))


def phase_build(_build) -> dict:
    t0 = time.perf_counter()
    _build.library()
    cached = _build.build_info.get("cached")
    info = dict(phase="build", seconds=time.perf_counter() - t0,
                cached=cached,
                nvcc_seconds="not measured" if cached
                else _build.build_info.get("seconds"),
                library=Path(_build.build_info["library"]).name,
                ptxas=ptxas_summary(_build.build_info.get("log")),
                nvidia_smi=smi())
    print(info["nvidia_smi"], flush=True)
    emit(info)
    if isinstance(info["ptxas"], dict):  # no decode or backward kernel spills
        assert info["ptxas"]["decode_splitkv"]["spill_bytes"] == 0, info
        bwd = info["ptxas"]["flash_attention_bwd"]
        assert len(bwd) == 12 and not any(
            r["spill_bytes"] for r in bwd.values()), bwd
    return info


def kv_mask(torch, s, pads=None, lens=None):
    """[B, S] f32 0/1 key mask: left pads (a row's first ``pads[r]``
    columns masked, as ``generate()`` pads) or, with ``lens``, right pads
    (a row's columns from ``lens[r]`` on masked, as BERT pads)."""
    col = torch.arange(s, device="cuda")[None, :]
    if lens is not None:
        return (col < torch.tensor(lens, device="cuda")[:, None]).float()
    return (col >= torch.tensor(pads, device="cuda")[:, None]).float()


def dead_key_rows(s, pads=None, lens=None) -> list:
    """The batch rows with no live key."""
    if lens is not None:
        return [r for r, n in enumerate(lens) if n <= 0]
    return [r for r, p in enumerate(pads or []) if p >= s]


def attention_case(torch, fa, flush, *, name, b, h, s, d, causal, pads,
                   dtype, lens=None):
    """flash_attention kernel vs plain on one seeded input, then the
    kernel's, the plain version's and SDPA's times; returns the phase-b
    record. ``pads``: left pads; ``lens`` (with ``pads`` None): right
    pads, BERT's."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(s + d)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, h, s, d), generator=g, device="cuda",
                           dtype=torch.float32).to(dt) for _ in range(3))
    mask = kv_mask(torch, s, pads, lens)
    variant = fa.kernel_variant(dt)
    walked = torch.zeros(1, dtype=torch.int32, device="cuda")
    o, lse = fa.flash_attention_fwd(q, k, v, causal, kv_mask=mask,
                                    tile_counter=walked)
    o_ref, lse_ref = fa.attention_plain(q, k, v, causal, mask)
    tc = variant == "tc_mma_bf16"
    allowed = (fa.tc_bf16_tolerance(o_ref, fa.attention_abs_pv_plain(
        q, k, v, causal, mask)) if tc else None)
    torch.cuda.synchronize()
    err = check_close(o, o_ref, dtype, name, allowed)
    walked = int(walked.item())  # only the tensor-core kernel counts
    assert (walked > 0) == tc, f"{name}: {variant} counted {walked} tiles"
    live = lse_ref > -1e29
    lse_err = (lse[live] - lse_ref[live]).abs().max().item()
    dead_rows = dead_key_rows(s, pads, lens)
    for r in dead_rows:  # an all-masked row outputs exactly 0
        assert torch.all(o[r] == 0), f"{name}: masked row {r} is not 0"
        assert torch.all(lse[r] == lse_ref[r]), f"{name}: lse row {r}"
    tol, rtol, pv_rtol = fa.TC_BF16_RULE if tc else (*TOL[dtype], 0.0)
    assert lse_err <= 1e-3, f"{name} {dtype}: lse error {lse_err}"
    live_cols = mask > 0                                  # [B, S]
    model = tile_pairs(torch, live_cols, causal, variant)
    if tc:  # the kernel skipped exactly the tiles with no live column
        assert walked == h * model["computed"], (name, walked, model)
    rec = dict(phase="kernels", kernel="flash_attention", case=name,
               variant=variant, dtype=dtype, shape=[b, h, s, d],
               causal=causal, pads=pads, lens=lens, max_abs_err=err,
               tol=tol, rtol=rtol, pv_rtol=pv_rtol, lse_max_abs_err=lse_err,
               tile_pairs_walked=walked if tc else "not measured",
               tile_pairs_computed_model=h * model["computed"],
               tile_pairs_live_model=h * model["live"])
    if causal:
        per_row = torch.cumsum(live_cols.long(), dim=1)   # cols <= row
    else:
        per_row = live_cols.long().sum(1, keepdim=True).expand(b, s)
    pairs = float(per_row.sum().item()) * h
    # What the function must move: q only for rows with a live key, k and
    # v only for live columns, all of O and lse, the mask once.
    q_rows = int((per_row > 0).sum().item())
    kv_cols = int(live_cols.sum().item())
    elt = q.element_size()
    nbytes = (h * d * elt * (q_rows + 2 * kv_cols) + b * h * s * d * elt
              + b * h * s * 4 + b * s * 4)
    bms, by = bound(4.0 * d * pairs, nbytes, dtype)
    sdpa_mask = live_cols[:, None, None, :]
    if causal:
        sdpa_mask = sdpa_mask & torch.ones(
            (s, s), dtype=torch.bool, device="cuda").tril()
    rec.update(
        ms=time_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, causal, kv_mask=mask), flush=flush),
        plain_ms=time_ms(torch, lambda: fa.attention_plain(
            q, k, v, causal, mask), flush=flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask), flush=flush),
        bound_ms=bms, bound_by=by, flops=4.0 * d * pairs, bytes=nbytes)
    rec["live_tflops"] = rec["flops"] / rec["ms"] / 1e9
    emit(rec)
    return rec


def bwd_case(torch, fa, flush, *, name, b, h, s, d, causal, pads, dtype,
             lens=None):
    """flash_attention_bwd kernel vs plain on one seeded input (O and lse
    from the forward kernel, dO seeded), then the kernel's, the plain
    version's and SDPA's backward times, and forward plus backward of
    both; returns the phase-b record. ``pads`` None and ``lens`` None: no
    kv_mask, as phase g trains; ``lens``: right pads, as phase h trains,
    where every masked column's dK and dV must be exactly 0."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(s + d + 1)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn((b, h, s, d), generator=g, device="cuda",
                               dtype=torch.float32).to(dt) for _ in range(4))
    mask = (None if pads is None and lens is None
            else kv_mask(torch, s, pads, lens))
    o, lse = fa.flash_attention_fwd(q, k, v, causal, kv_mask=mask)
    args = (q, k, v, o, lse, do, causal, mask)
    variant = fa.kernel_variant(dt)
    got = fa.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    again = fa.flash_attention_bwd(*args)  # no atomics: the same bits
    assert all(torch.equal(a, b) for a, b in zip(got, again)), name
    del again
    want = fa.attention_bwd_plain(*args)
    err = max(check_close(gt, w, dtype, f"{name} {gn}",
                          fa.bwd_tolerance(w, a))
              for gn, gt, w, a in zip(("dq", "dk", "dv"), got, want,
                                      fa.attention_bwd_abs_plain(*args)))
    dead_rows = dead_key_rows(s, pads, lens)
    for r in dead_rows:  # a row that sees no key: every gradient exactly 0
        assert all(torch.all(gt[r] == 0) for gt in got), (
            f"{name}: the all-masked row {r} has a gradient")
    dead_tiles = 0
    if mask is not None:  # a masked column's dK and dV: exactly 0
        dead = (mask == 0)[:, None, :, None]
        for gn, gt in (("dk", got[1]), ("dv", got[2])):
            assert not torch.any(torch.where(dead, gt, 0) != 0), (
                f"{name}: {gn} of a masked column is not 0")
        n_t = -(-s // 64)
        cols = torch.nn.functional.pad(mask > 0, (0, n_t * 64 - s))
        dead_tiles = int((~cols.view(b, n_t, 64).any(-1)).sum().item())
    del want
    live_cols = (torch.ones((b, s), dtype=torch.bool, device="cuda")
                 if mask is None else mask > 0)
    if causal:
        per_row = torch.cumsum(live_cols.long(), dim=1)
    else:
        per_row = live_cols.long().sum(1, keepdim=True).expand(b, s)
    pairs = float(per_row.sum().item()) * h
    flops = 5 * 2.0 * d * pairs  # q·kᵀ again, dV, dP, dK, dQ
    # what the two stages issue: q·kᵀ and dP in both, the five above on
    # every computed 64x64 tile pair (the causal diagonal tile whole)
    n_t = -(-s // 64)
    tiles = n_t * (n_t + 1) // 2 if causal else n_t * n_t
    issued = 7 * 2.0 * d * 64 * 64 * tiles * b * h
    elt = q.element_size()
    # read q, k, v, O, dO and lse, write dq, dk and dv (and the mask)
    nbytes = (8 * b * h * s * d * elt + b * h * s * 4
              + (0 if mask is None else b * s * 4))
    bms, by = bound(flops, nbytes, dtype)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sdpa_mask = None if mask is None else live_cols[:, None, None, :]
    if causal and mask is not None:
        sdpa_mask = sdpa_mask & torch.ones(
            (s, s), dtype=torch.bool, device="cuda").tril()

    def sdpa():
        return F.scaled_dot_product_attention(
            *leaves, attn_mask=sdpa_mask, is_causal=causal and mask is None)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), leaves, do)

    def kernel_fwd_bwd():
        o_, lse_ = fa.flash_attention_fwd(q, k, v, causal, kv_mask=mask)
        fa.flash_attention_bwd(q, k, v, o_, lse_, do, causal, mask)

    out = sdpa()
    tol, rtol = (fa.TC_BWD_RULE if variant == "tc_mma_bf16"
                 else fa.BWD_RULE[dt])
    rec = dict(phase="kernels", kernel="flash_attention_bwd", case=name,
               variant=variant, dtype=dtype, shape=[b, h, s, d],
               causal=causal, pads=pads, lens=lens, max_abs_err=err,
               tol=tol, rtol=rtol,
               tol_rule="tol·grad_abs + rtol·|plain| (fa.bwd_tolerance)",
               dead_rows_exactly_zero=dead_rows,
               dead_k_tiles_dk_dv_exactly_zero=dead_tiles,
               repeat_bitwise_equal=True,
               ms=time_ms(torch, lambda: fa.flash_attention_bwd(*args),
                          flush=flush),
               plain_ms=time_ms(torch, lambda: fa.attention_bwd_plain(*args),
                                flush=flush),
               library_ms=time_ms(torch, lambda: torch.autograd.grad(
                   out, leaves, do, retain_graph=True), flush=flush),
               library="F.scaled_dot_product_attention backward",
               fwd_bwd_ms=time_ms(torch, kernel_fwd_bwd, flush=flush),
               library_fwd_bwd_ms=time_ms(torch, sdpa_fwd_bwd, flush=flush),
               bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
               flops_issued=issued)
    rec["tflops"] = flops / rec["ms"] / 1e9           # the bound's five
    rec["tflops_issued"] = issued / rec["ms"] / 1e9   # the seven issued
    rec["bound_share"] = bms / rec["ms"]
    emit(rec)
    return rec


def tile_pairs(torch, live_cols, causal: bool, variant: str) -> dict:
    """A model from the mask, not a measurement: 64x64 (Q tile, K tile)
    pairs per head, summed over the batch, that the kernel should compute
    and that hold a live score. The tensor-core kernel computes each K
    tile with a live column up to the causal stop; the f32 kernel every K
    tile up to it."""
    b, s = live_cols.shape
    n_t = -(-s // 64)
    cols = torch.nn.functional.pad(live_cols, (0, n_t * 64 - s))
    tile_live = cols.view(b, n_t, 64).any(-1)              # [B, K tiles]
    qt = torch.arange(n_t, device=live_cols.device)
    reach = (qt[None, :] <= qt[:, None]) if causal else torch.ones(
        (n_t, n_t), dtype=torch.bool, device=live_cols.device)
    if variant == "tc_mma_bf16":
        computed = (reach[None] & tile_live[:, None, :]).sum()
    else:
        computed = reach.sum() * b
    # a pair is live when some (row, col) in it has a live score
    rows = torch.arange(n_t * 64, device=live_cols.device)
    score = cols[:, None, :].expand(b, n_t * 64, n_t * 64)
    if causal:
        score = score & (rows[None, None, :] <= rows[None, :, None])
    score = score & (rows < s)[None, :, None]
    live = score.view(b, n_t, 64, n_t, 64).any(4).any(2).sum()
    return dict(computed=int(computed), live=int(live))


def flash_sweep(torch, fa, flush) -> dict:
    """bf16 flash_attention against the dense arm of adaptive_attention
    (``dense_attention``), B=4, H=16, D=128, causal, no pad, at each S of
    ``FLASH_SWEEP``; records the shortest S from which the kernel is
    faster at every longer S (the ``SPARKDL_FLASH_MIN_SEQ`` crossover)."""
    from sparkdl_tpu_torch.parallel.ring_attention import dense_attention

    rows = []
    for s in FLASH_SWEEP:
        g = torch.Generator(device="cuda").manual_seed(s)
        q, k, v = (torch.randn((4, 16, s, 128), generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        rows.append(dict(
            s=s, ms=time_ms(torch, lambda: fa.flash_attention_fwd(
                q, k, v, True), flush=flush),
            dense_ms=time_ms(torch, lambda: dense_attention(q, k, v, True),
                             flush=flush)))
        del q, k, v
    wins = [r["ms"] < r["dense_ms"] for r in rows]
    cross = next((r["s"] for i, r in enumerate(rows) if all(wins[i:])),
                 None)
    rec = dict(phase="kernels", kernel="flash_attention",
               case="sweep_vs_dense", variant=fa.kernel_variant(
                   torch.bfloat16), dtype="bfloat16", shape=[4, 16, None, 128],
               causal=True, rows=rows, kernel_faster_from_s=cross)
    emit(rec)
    return rec


def decode_inputs(torch, *, b, hq, hkv, length, d, cur, pads, dtype):
    """One seeded flash_decode input on the card: (q, k cache, v cache,
    cur, pad)."""
    g = torch.Generator(device="cuda").manual_seed(hq * 1000 + length)
    dt = getattr(torch, dtype)
    q = torch.randn((b, hq, 1, d), generator=g, device="cuda").to(dt)
    kc = torch.randn((b, hkv, length, d), generator=g, device="cuda").to(dt)
    vc = torch.randn((b, hkv, length, d), generator=g, device="cuda").to(dt)
    pad_t = None if pads is None else torch.tensor(pads, dtype=torch.int32,
                                                   device="cuda")
    cur_arg = cur if isinstance(cur, int) else torch.tensor(
        cur, dtype=torch.int32, device="cuda")
    return q, kc, vc, cur_arg, pad_t


def decode_case(torch, fd, flush, *, name, b, hq, hkv, length, d, cur, pads,
                dtype, profile=False):
    """flash_decode kernel vs plain on one seeded input, then the three
    times; returns the phase-b record."""
    import torch.nn.functional as F

    q, kc, vc, cur_arg, pad_t = decode_inputs(
        torch, b=b, hq=hq, hkv=hkv, length=length, d=d, cur=cur, pads=pads,
        dtype=dtype)
    o = fd.flash_decode(q, kc, vc, cur_arg, pad_t)
    o_ref = fd.flash_decode_plain(q, kc, vc, cur_arg, pad_t)
    torch.cuda.synchronize()
    err = check_close(o, o_ref, dtype, name)
    curs = [cur] * b if isinstance(cur, int) else list(cur)
    pl = [0] * b if pads is None else list(pads)
    live = [max(0, min(c, length) - p) for c, p in zip(curs, pl)]
    for r, n in enumerate(live):
        if n == 0:
            assert torch.all(o[r] == 0), f"{name}: empty row {r} is not 0"
    tol, rtol = TOL[dtype]
    rec = dict(phase="kernels", kernel="flash_decode", case=name,
               dtype=dtype, shape=[b, hq, hkv, length, d], cur=cur,
               pads=pads, live_slots=live, max_abs_err=err, tol=tol,
               rtol=rtol, **split_record(
                   torch, lambda c: fd.flash_decode(
                       q, kc, vc, cur_arg, pad_t, block_counter=c),
                   length, hq // hkv,
                   [(p, min(c, length)) for c, p in zip(curs, pl)], hkv))
    elt = q.element_size()
    nbytes = 2 * hkv * d * elt * sum(live) + 2 * b * hq * d * elt
    flops = 4.0 * hq * d * sum(live)
    bms, by = bound(flops, nbytes, dtype)
    col = torch.arange(length, device="cuda")
    cur_t = torch.tensor(curs, device="cuda")
    pad_v = torch.tensor(pl, device="cuda")
    sdpa_mask = ((col[None] < cur_t[:, None])
                 & (col[None] >= pad_v[:, None]))[:, None, None, :]
    rec.update(
        ms=time_ms(torch, lambda: fd.flash_decode(q, kc, vc, cur_arg,
                                                  pad_t), flush=flush),
        plain_ms=time_ms(torch, lambda: fd.flash_decode_plain(
            q, kc, vc, cur_arg, pad_t), flush=flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kc, vc, attn_mask=sdpa_mask, enable_gqa=True),
            flush=flush),
        bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes)
    if profile:  # the event time against the profiler's kernel time
        run = lambda: fd.flash_decode(q, kc, vc, cur_arg, pad_t)  # noqa: E731
        rec.update(
            profiler_ms=profiler_kernel_ms(torch, run, "splitkv_kernel",
                                           flush=flush),
            ms_read_flush=time_ms(torch, run, flush=flush, read_flush=True),
            # the same launch with one live position a row: its fixed cost
            fixed_ms=time_ms(torch, lambda: fd.flash_decode(q, kc, vc, 1),
                             flush=flush))
    emit(rec)
    return rec


def paged_inputs(torch, *, dtype, kv, s_q):
    """One seeded paged_flash_decode input on the card, the main path's
    serving shapes: (q, k pool, v pool, tables, cur, pad, scales), every
    block no live range reads filled with NaN. ``kv``: "same" (pools in
    ``dtype``), "int8" or "fp8" (codes with a scale plane)."""
    b, hq, hkv, d, bs, mb = 8, 16, 8, 128, PAGED_BS, PAGED_MB
    g = torch.Generator().manual_seed(1000 * s_q + len(kv))
    dt = getattr(torch, dtype)
    need = [0 if c == 0 else -(-min(c + s_q, mb * bs) // bs)
            for c in PAGED_CUR]
    spare = 64
    pool = 1 + sum(need) + spare
    ids = torch.randperm(pool - 1, generator=g) + 1
    dead = ids[sum(need):]
    tables = torch.zeros((b, mb), dtype=torch.int32)
    used = 0
    for r, n in enumerate(need):
        if n:  # a non-contiguous run of pool ids, then NaN blocks
            tables[r, :n] = ids[used:used + n].int()
            tables[r, n:] = int(dead[r % spare])
            used += n
    shape = (pool, hkv, bs, d)
    scales = None
    if kv == "same":
        kp, vp = (torch.randn(shape, generator=g).to(dt) for _ in range(2))
        kp[dead], vp[dead] = float("nan"), float("nan")
    else:
        code = torch.int8 if kv == "int8" else torch.float8_e4m3fn
        qmax = 127.0 if kv == "int8" else 448.0
        kp, vp = ((torch.rand(shape, generator=g) * 2 - 1) * qmax
                  for _ in range(2))
        kp, vp = kp.round().to(code), vp.round().to(code)
        scales = torch.rand((pool, hkv, 2), generator=g) * 0.02 + 1e-3
        scales[dead] = float("nan")
        if kv == "fp8":
            kp[dead], vp[dead] = float("nan"), float("nan")
    q = torch.randn((b, hq, s_q, d), generator=g).to(dt)
    cur_t = torch.tensor(PAGED_CUR, dtype=torch.int32)
    pad_t = torch.tensor(PAGED_PADS, dtype=torch.int32)
    q, kp, vp, tables, cur_t, pad_t = (
        t.to("cuda") for t in (q, kp, vp, tables, cur_t, pad_t))
    scales = None if scales is None else scales.to("cuda")
    return q, kp, vp, tables, cur_t, pad_t, scales


def paged_case(torch, pfd, flush, *, name, dtype, kv, s_q, profile=False):
    """paged_flash_decode kernel vs plain on one seeded pool
    (:func:`paged_inputs`), then the three times; returns the phase-b
    record."""
    import torch.nn.functional as F

    args = paged_inputs(torch, dtype=dtype, kv=kv, s_q=s_q)
    q, kp, vp, tables, cur_t, pad_t, scales = args
    b, hq, s_q, d = q.shape
    pool, hkv, bs, _ = kp.shape
    mb = tables.shape[1]
    dt = q.dtype
    o = pfd.paged_flash_decode(*args)
    o_ref = pfd.paged_flash_decode_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all(), f"{name}: NaN reached the output"
    err = check_close(o, o_ref, dtype, name)
    # the parked slot attends position 0 of trash block 0: finite
    # garbage, not the all-masked zero output
    assert torch.any(o[7, :, 0] != 0), f"{name}: parked slot output is 0"

    # what the function must move: the K/V rows of the live positions
    # [pad, min(cur + S, MB·bs)) of each slot, the scale pair of each
    # live block those rows lie in, q and O; the operations of the live
    # (query, column) pairs
    length = mb * bs
    spans = [(p, min(c + s_q, length)) for c, p in zip(PAGED_CUR, PAGED_PADS)]
    rows = sum(max(0, e - p) for p, e in spans)
    blocks = sum(max(0, -(-e // bs) - p // bs) for p, e in spans)
    pairs = sum(max(0, min(c + i, length - 1) - p + 1)
                for c, p in zip(PAGED_CUR, PAGED_PADS) for i in range(s_q))
    nbytes = (2 * rows * hkv * d * kp.element_size()
              + (0 if scales is None else blocks * hkv * 2 * 4)
              + 2 * q.numel() * q.element_size())
    flops = 4.0 * d * hq * pairs
    bms, by = bound(flops, nbytes, dtype)
    # yardstick: SDPA over the PRE-GATHERED dense view, never-read
    # columns zeroed and masked (the gather itself is not timed)
    kv_k = pfd.gathered_view(kp, tables, scales, 0)
    kv_v = pfd.gathered_view(vp, tables, scales, 1)
    col = torch.arange(length, device="cuda")
    qpos = cur_t.long()[:, None] + torch.arange(s_q, device="cuda")
    pad_l = pad_t.long()
    read = ((col >= pad_l[:, None]) & (col < qpos[:, -1:] + 1))
    kv_k = torch.where(read[:, None, :, None], kv_k, 0.0).to(dt)
    kv_v = torch.where(read[:, None, :, None], kv_v, 0.0).to(dt)
    mask = ((col[None, None] <= qpos[..., None])
            & (col[None, None] >= pad_l[:, None, None]))[:, None]
    tol, rtol = TOL[dtype]
    rec = dict(phase="kernels", kernel="paged_flash_decode", case=name,
               dtype=dtype, kv=kv, s_q=s_q,
               shape=[b, hq, hkv, s_q, d, bs, mb, pool], cur=PAGED_CUR,
               pads=PAGED_PADS, live_rows=rows, blocks_touched=blocks,
               max_abs_err=err,
               tol=tol, rtol=rtol,
               ms=time_ms(torch, lambda: pfd.paged_flash_decode(*args),
                          flush=flush),
               plain_ms=time_ms(torch, lambda: pfd.paged_flash_decode_plain(
                   *args), flush=flush),
               library_ms=time_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       q, kv_k, kv_v, attn_mask=mask, enable_gqa=True),
                   flush=flush),
               library="SDPA on the pre-gathered dense view (excludes "
                       "the gather)",
               bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
               **split_record(
                   torch, lambda c: pfd.paged_flash_decode(
                       *args, block_counter=c),
                   length, s_q * hq // hkv, spans, hkv))
    if profile:  # the event time against the profiler's kernel time
        run = lambda: pfd.paged_flash_decode(*args)  # noqa: E731
        one = (q, kp, vp, tables, torch.zeros_like(cur_t), None, scales)
        rec.update(
            profiler_ms=profiler_kernel_ms(torch, run, "splitkv_kernel",
                                           flush=flush),
            ms_read_flush=time_ms(torch, run, flush=flush, read_flush=True),
            # the same launch with one live position a slot: fixed cost
            fixed_ms=time_ms(torch, lambda: pfd.paged_flash_decode(*one),
                             flush=flush))
    emit(rec)
    return rec


def phase_kernels(torch, fa, fd, pfd) -> dict:
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    b, s = len(PROMPT_LENS), PROMPT_LENS[0]
    main_pads = [s - n for n in PROMPT_LENS]           # [0, 548, 1348, 2015]
    length = s + NEW_TOKENS                             # the main path's cache
    main = {}
    for dtype in ("bfloat16", "float32"):
        rec = attention_case(torch, fa, flush, name="prefill", b=b, h=16,
                             s=s, d=128, causal=True, pads=main_pads,
                             dtype=dtype)
        if dtype == "bfloat16":  # the main path's dtype
            main["flash_attention"] = rec
        else:
            main["flash_attention_f32"] = rec
        attention_case(torch, fa, flush, name="ragged_all_masked", b=4,
                       h=16, s=1000, d=128, causal=False,
                       pads=[0, 300, 999, 1000], dtype=dtype)
        rec = decode_case(torch, fd, flush, name="decode_step1", b=b, hq=16,
                          hkv=8, length=length, d=128, cur=s + 1,
                          pads=main_pads, dtype=dtype,
                          profile=dtype == "bfloat16")
        if dtype == "bfloat16":
            main["flash_decode"] = rec
        decode_case(torch, fd, flush, name="per_row_cur", b=b, hq=16, hkv=8,
                    length=length, d=128, cur=[2049, 1700, 900, 40],
                    pads=[0, 548, 348, 7], dtype=dtype)
        decode_case(torch, fd, flush, name="llama3_8b_gqa", b=b, hq=32,
                    hkv=8, length=length, d=128, cur=s + 1, pads=None,
                    dtype=dtype)
        for kv in ("same", "int8", "fp8"):
            if kv != "same" and dtype == "float32":
                continue  # a quantized pool serves the bf16 model
            for s_q in (1, 5):
                main_case = dtype == "bfloat16" and kv == "same" \
                    and s_q == 1
                rec = paged_case(torch, pfd, flush,
                                 name=f"paged_{kv}_s{s_q}", dtype=dtype,
                                 kv=kv, s_q=s_q, profile=main_case)
                if main_case:
                    main["paged_flash_decode"] = rec
    for dtype in ("bfloat16", "float32"):  # phase g's shape, and ragged
        rec = bwd_case(torch, fa, flush, name="train", b=TRAIN_BATCH, h=32,
                       s=TRAIN_SEQ, d=128, causal=True, pads=None,
                       dtype=dtype)
        main["flash_attention_bwd" if dtype == "bfloat16"
             else "flash_attention_bwd_f32"] = rec
        bwd_case(torch, fa, flush, name="ragged_all_masked", b=2, h=32,
                 s=1000, d=128, causal=False, pads=[300, 1000], dtype=dtype)
    # phase h's shapes: BERT-base (H 12, D 64), not causal, right pads
    # from its length draw with one full row and one of length 1; then a
    # ragged S 77
    lens = glue_lengths(0)
    lens[:2] = [GLUE_SEQ, 1]
    for name, s_case, ls in (("bert_glue", GLUE_SEQ, lens),
                             ("bert_ragged_s77", 77,
                              [77, 1] + [min(n, 77) for n in lens[2:]])):
        kw = dict(name=name, b=GLUE_BATCH, h=12, s=s_case, d=64,
                  causal=False, pads=None, lens=ls, dtype="bfloat16")
        rec = attention_case(torch, fa, flush, **kw)
        rec_bwd = bwd_case(torch, fa, flush, **kw)
        assert rec_bwd["dead_k_tiles_dk_dv_exactly_zero"] > 0, rec_bwd
        if name == "bert_glue":
            main["flash_attention_bert"] = rec
            main["flash_attention_bwd_bert"] = rec_bwd
    main["flash_sweep"] = flash_sweep(torch, fa, flush)
    # what the events read around an empty kernel: the floor under every
    # time of this phase
    floor = dict(phase="kernels", case="event_floor",
                 ms=time_ms(torch, lambda: torch.cuda._sleep(0), flush=flush))
    emit(floor)
    main["event_floor_ms"] = floor["ms"]
    del flush
    return main


def prompts(torch, cfg):
    from sparkdl_tpu_torch.models.llama import left_pad_prompts

    g = torch.Generator().manual_seed(1)
    toks = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
            for n in PROMPT_LENS]
    return left_pad_prompts(toks)


def graph_captures(since: float) -> list:
    """Capture times (ms) of the CUDA graphs made since ``since`` (a
    ``time.time()``), from the flight recorder's ``graph_capture``
    events."""
    from sparkdl_tpu_torch.runner import events

    return [e["ms"] for e in events.get_recorder().tail()
            if e["name"] == "graph_capture" and e["t"] >= since]


def eager_decode(torch, L):
    """``L._decode`` with every step run eagerly (``L._decode_step``
    called directly, no graph): the eager arm of phase c. Greedy, no
    eos, as phase c calls it."""
    def run(model, cache, last_logits, generator, pad_lens=None, *,
            max_new_tokens, temperature, top_k=0, top_p=1.0, eos_id=None):
        assert eos_id is None and temperature <= 0.0
        tok = last_logits.argmax(-1)
        out = []
        for _ in range(max_new_tokens):
            out.append(tok)
            tok = L._decode_step(model, cache, tok, pad_lens).argmax(-1)
        return torch.stack(out, dim=1), max_new_tokens
    return run


def generate_arm(torch, L, fa, fd, model, ids, pads, arm: str,
                 run: int) -> tuple:
    """One timed ``generate()`` call, its decode loop eager or from the
    graph (the shipped path). The prefill and the decode loop are timed
    inside that call: generate() calls the module's _prefill and _decode,
    which are wrapped here for the call only (host clock, device synced
    on both sides, so each span holds its own device work). The launch
    counters are set to 0 just before and read just after."""
    spans, outs = {}, {}

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[name] = time.perf_counter() - t0
            return outs[name]
        return wrapped

    real = L._prefill, L._decode
    decode = eager_decode(torch, L) if arm == "eager" else real[1]
    L._prefill, L._decode = timed("prefill", real[0]), timed("decode", decode)
    try:
        fa.flash_attention_fwd.launches = 0
        fd.flash_decode.launches = 0
        since = time.time()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, steps = L.generate(model, ids, NEW_TOKENS, pad_lens=pads,
                                return_steps=True)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = {"flash_attention": fa.flash_attention_fwd.launches,
                    "flash_decode": fd.flash_decode.launches}
    finally:
        L._prefill, L._decode = real
    captures = graph_captures(since)
    assert len(captures) == (arm == "graph"), (arm, captures)
    cfg = model.cfg
    assert torch.isfinite(outs["prefill"]).all(), "prefill logits not finite"
    assert steps == NEW_TOKENS, f"decode ran {steps} steps"
    assert launches["flash_attention"] == cfg.num_layers, launches
    assert launches["flash_decode"] == cfg.num_layers * steps, launches
    assert out.shape == (len(PROMPT_LENS), ids.shape[1] + NEW_TOKENS)
    assert torch.equal(out[:, :ids.shape[1]].cpu(), ids), "prompt changed"
    new = out[:, ids.shape[1]:]
    assert int(new.min()) >= 0 and int(new.max()) < cfg.vocab_size
    capture_ms = captures[0] if captures else None
    rec = dict(phase="main_path", arm=arm, run=run,
               config="LlamaConfig.small", dtype="bfloat16",
               layers=cfg.num_layers, hidden=cfg.hidden_size,
               heads=[cfg.num_heads, cfg.num_kv_heads],
               head_dim=cfg.head_dim, vocab=cfg.vocab_size,
               prompt_lens=PROMPT_LENS, new_tokens=NEW_TOKENS,
               decode_steps=steps, launches=launches, generate_s=total_s,
               prefill_ms=spans["prefill"] * 1e3,
               decode_ms_per_step=spans["decode"] * 1e3 / steps,
               capture_ms=capture_ms,
               decode_ms_per_step_without_capture=(
                   spans["decode"] * 1e3 - (capture_ms or 0.0)) / steps,
               rest_ms=(total_s - spans["prefill"] - spans["decode"]) * 1e3,
               new_tokens_per_s=len(PROMPT_LENS) * steps / total_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               first_new_tokens=new[:, :4].tolist())
    emit(rec)
    return rec, new


def phase_main(torch, fa, fd) -> dict:
    """generate() on the main path: the eager arm and the graph arm in
    turns (eager, graph, graph, eager), the same greedy tokens from
    every run; then the prefill and both decode arms profiled."""
    from sparkdl_tpu_torch.models import llama as L

    cfg = L.LlamaConfig.small()
    t0 = time.perf_counter()
    model = L.LlamaModel(cfg, dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids, pads = prompts(torch, cfg)
    L.generate(model, ids, 2, pad_lens=pads)  # warm-up: cuBLAS handles etc.
    dev_ids, dev_pads = ids.cuda(), pads.cuda()
    runs = [generate_arm(torch, L, fa, fd, model, ids, pads, arm, run)
            for arm, run in (("eager", 1), ("graph", 1), ("graph", 2),
                             ("eager", 2))]
    for rec, new in runs[1:]:
        assert torch.equal(new, runs[0][1]), (
            f"{rec['arm']} run {rec['run']}: tokens differ from the eager "
            f"arm's")
    by_arm = {a: [r for r, _ in runs if r["arm"] == a]
              for a in ("eager", "graph")}
    emit(dict(phase="main_path", arm="summary", init_s=init_s,
              tokens_equal=True,
              **{k: {a: [r[k] for r in rs] for a, rs in by_arm.items()}
                 for k in ("decode_ms_per_step", "new_tokens_per_s",
                           "prefill_ms")},
              capture_ms=[r["capture_ms"] for r in by_arm["graph"]]))
    emit(profile_prefill(torch, L, model, dev_ids, dev_pads))
    emit(profile_decode(torch, L, model, dev_ids, dev_pads))
    emit(profile_decode_graph(torch, L, model, dev_ids, dev_pads))
    del model
    torch.cuda.empty_cache()
    return dict(by_arm["graph"][0], init_s=init_s)


def device_profile(torch, step, steps: int, window: str,
                   match: str | None = None) -> dict:
    """Where ``steps`` calls of ``step`` spend their time:
    ``torch.profiler`` device busy share of the wall time and the kernels
    that take it, beside the wall time and the CUDA-event time of the
    same window; with ``match``, also every kernel whose name holds it
    (``matched_kernels``), in the top eight or not. Reports "not
    measured" when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        for _ in range(steps):
            step()
        e.record()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for ev in prof.events():
        # a user annotation's device range (e.g. "Optimizer.step#Adam.step")
        # spans kernels already counted: not device work of its own
        if getattr(ev, "is_user_annotation", False):
            continue
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(ev.name, [0, 0.0])
            kernels[ev.name][0] += 1
            kernels[ev.name][1] += ev.device_time_total \
                if hasattr(ev, "device_time_total") else ev.cuda_time_total
    busy_us = sum(t for _, t in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    matched = {} if match is None else dict(matched_kernels=[
        dict(name=n[:80], launches=c, us=t)
        for n, (c, t) in kernels.items() if match in n])
    return dict(
        phase="profile", window=window,
        wall_ms_per_step=wall_us / steps / 1e3,
        event_ms_per_step=s.elapsed_time(e) / steps,
        device_busy_ms_per_step=(busy_us / steps / 1e3) if busy_us
        else "not measured: the profiler saw no device activity",
        device_idle_share=(1 - busy_us / wall_us) if busy_us
        else "not measured",
        device_launches_per_step=sum(n for n, _ in kernels.values()) / steps,
        top_kernels=[dict(name=n[:80], launches=c, us=t)
                     for n, (c, t) in top], **matched)


def profile_prefill(torch, L, model, ids, pads, steps: int = 2) -> dict:
    """Where a prefill of ``generate()`` spends its time: ``steps``
    prefills of the main path's prompts, each into a fresh cache."""
    caches = [L.init_cache(model, ids.shape[0], ids.shape[1] + 1)
              for _ in range(steps)]

    def step():
        L._prefill(model, ids, caches.pop(), pads)
    return device_profile(torch, step, steps, f"{steps} prefills, small bf16")


def profile_decode(torch, L, model, ids, pads, steps: int = 4) -> dict:
    """Where an eager decode step of ``generate()`` spends its time, over
    ``steps`` steps after a prefill."""
    cache = L.init_cache(model, ids.shape[0], ids.shape[1] + steps + 1)
    tok = [L._prefill(model, ids, cache, pads).argmax(-1)]

    def step():
        tok[0] = L._decode_step(model, cache, tok[0], pads).argmax(-1)
    return device_profile(torch, step, steps,
                          f"{steps} eager decode steps, small bf16")


def profile_decode_graph(torch, L, model, ids, pads, steps: int = 4) -> dict:
    """:func:`profile_decode` with every step replayed from the CUDA
    graph, as ``L._decode`` runs it (captured before the window)."""
    import functools

    from sparkdl_tpu_torch.core.runtime import CompileCache

    cache = L.init_cache(model, ids.shape[0], ids.shape[1] + steps + 2)
    tok = [L._prefill(model, ids, cache, pads).argmax(-1)]
    graphs = CompileCache()
    fn = functools.partial(L._decode_step, model, cache)

    def step():
        n = cache.idx
        logits = graphs.get("decode_step", "profile", fn, (tok[0], pads),
                            L.LAUNCH_COUNTED)
        cache.idx = n + 1
        tok[0] = logits.argmax(-1)
    step()  # the warm-up step and the capture
    rec = device_profile(torch, step, steps,
                         f"{steps} decode steps from the graph, small bf16")
    assert graphs.snapshot()["replays"] == steps
    assert int(cache.idx_dev) == cache.idx
    return rec


def phase_parity(torch) -> dict:
    from sparkdl_tpu_torch.models import llama as L

    cfg = L.LlamaConfig.small()
    model = L.LlamaModel(cfg, dtype=torch.float32, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    ids, pads = prompts(torch, cfg)
    ids, pads = ids.cuda(), pads.cuda()
    max_len = ids.shape[1] + PARITY_TOKENS

    def run(tokens=None):
        """Logits at the prefill's last position and at each decode
        step; greedy tokens when ``tokens`` is None, else ``tokens`` fed."""
        cache = L.init_cache(model, ids.shape[0], max_len)
        logits = [L._prefill(model, ids, cache, pads)]
        fed = []
        for i in range(PARITY_TOKENS - 1):
            tok = logits[-1].argmax(-1) if tokens is None else tokens[i]
            fed.append(tok)
            logits.append(L._decode_step(model, cache, tok, pads))
        return torch.stack(logits, 1), fed

    assert L.resolve_attn_fn(model.attn_fn) is not None
    kern, toks = run()
    model.attn_fn = None  # the dense in-model path
    dense, _ = run(toks)
    err = (kern - dense).abs().max().item()
    scale = dense.abs().max().item()
    agree = float((kern.argmax(-1) == dense.argmax(-1)).float().mean())
    assert torch.isfinite(kern).all() and torch.isfinite(dense).all()
    assert err <= LOGIT_TOL, f"logits: kernel vs dense {err} > {LOGIT_TOL}"
    rec = dict(phase="parity", config="LlamaConfig.small", dtype="float32",
               tf32=False, positions=PARITY_TOKENS,
               max_abs_logit_err=err, tol=LOGIT_TOL, max_abs_logit=scale,
               argmax_agreement=agree)
    emit(rec)
    return rec


def serve_prompts(torch, cfg, lens, seed, shared=(), head_len=512,
                  repeat=None):
    """Seeded prompts of ``lens`` tokens; those at indices ``shared`` start
    with one common ``head_len``-token head; ``repeat`` n makes every
    prompt a cycle of an n-token phrase (n-gram drafts find matches)."""
    g = torch.Generator().manual_seed(seed)

    def rand(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()

    head = rand(head_len)
    out = []
    for i, n in enumerate(lens):
        if repeat:
            phrase = rand(repeat)
            p = (phrase * (n // repeat + 1))[:n]
        elif i in shared:
            p = head + rand(n - head_len)
        else:
            p = rand(n)
        out.append(p)
    return out


def reset_counts(fa, fd, pfd) -> None:
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    for variant in fa.flash_attention_bwd.variant_launches:
        fa.flash_attention_bwd.variant_launches[variant] = 0
    fd.flash_decode.launches = 0
    pfd.paged_flash_decode.launches = 0


def read_counts(fa, fd, pfd) -> dict:
    return {"flash_attention": fa.flash_attention_fwd.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            "flash_decode": fd.flash_decode.launches,
            "paged_flash_decode": pfd.paged_flash_decode.launches}


def serve_leg(torch, model, kernels, *, leg, prompts, **kw) -> tuple:
    """One fresh engine serving ``prompts`` (all submitted at once) to the
    end; the launch counters are set to 0 just before and read just
    after. Returns the leg's record and the engine."""
    from sparkdl_tpu_torch import GenerationEngine

    eng = GenerationEngine.from_model(model, num_slots=8, max_len=2048,
                                      device="cuda", **kw)
    iter_s = []
    for attr in ("step", "verify"):  # time each decode iteration
        fn = getattr(eng.backend, attr)

        def timed(*a, _fn=fn, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)  # returns host tokens: the device is done
            iter_s.append(time.perf_counter() - t0)
            return out
        setattr(eng.backend, attr, timed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    since = time.time()
    t0 = time.perf_counter()
    hs = [eng.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(*kernels)
    outs = [h.result(1) for h in hs]
    ttft = sorted(h.t_first_token - h.t_submit for h in hs)
    st = eng.stats
    new = sum(len(o) for o in outs)
    for o in outs:
        assert len(o) == SERVE_NEW and 0 <= min(o) and max(o) < \
            model.cfg.vocab_size, f"{leg}: bad stream {o[:8]}"
    rec = dict(phase="serve", leg=leg, config="LlamaConfig.small",
               dtype="bfloat16", layers=model.cfg.num_layers,
               engine={k: v for k, v in kw.items()}, num_slots=8,
               max_len=2048, requests=len(prompts),
               completed=st["completed"],
               prompt_lens=[len(p) for p in prompts], new_tokens=new,
               wall_s=wall, new_tokens_per_s=new / wall,
               ttft_p50_s=ttft[len(ttft) // 2],
               ttft_p95_s=ttft[max(0, -(-95 * len(ttft) // 100) - 1)],
               decode_iterations=len(iter_s),
               decode_iter_ms_mean=1e3 * sum(iter_s) / max(len(iter_s), 1),
               steps=st["steps"], prefills=st["prefills"],
               prefill_chunks=st["prefill_chunks"],
               preemptions=st["preemptions"],
               spec_verifies=st["spec_verifies"],
               spec_tokens_accepted=st["spec_tokens_accepted"],
               prefix=eng.backend.prefix_stats(), launches=launches,
               graphs=eng.backend.graphs.snapshot(),
               capture_ms=graph_captures(since),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    assert st["completed"] == len(prompts), rec
    # every S = 1 step came from the graph: one capture (whose warm-up
    # is the first step), then replays; verify windows run eagerly
    s1 = st["steps"] - st["spec_verifies"]
    assert rec["graphs"]["captures"] == min(s1, 1) == len(
        rec["capture_ms"]), rec
    assert rec["graphs"]["replays"] == max(s1 - 1, 0), rec
    return rec, eng


def eager_backend_step(L, be):
    """The backend's S = 1 step with the model called eagerly
    (``L.slot_decode_step`` / ``L.paged_slot_decode_step``, no graph):
    the eager arm of the paged profile."""
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


def iteration_split(torch, eng, steps: int) -> dict:
    """What an engine iteration spends around the replay, host clock,
    mean ms over ``steps`` iterations: the whole iteration, the
    backend's step, the step's operands and tables (host arrays to the
    device), the replay (copies into the static buffers, then the
    launch), and ``_advance`` (which waits for the device at the
    ``nxt.cpu()`` sync); the scheduler is the iteration less the
    backend's step."""
    be = eng.backend
    acc = {}

    def wrap(obj, attr, name):
        fn = getattr(obj, attr)

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
            return out
        setattr(obj, attr, timed)
        return fn

    real = {(be, "step"): wrap(be, "step", "backend_step"),
            (be, "_step_operands"): wrap(be, "_step_operands", "operands"),
            (be, "_tables"): wrap(be, "_tables", "tables"),
            (be.graphs, "get"): wrap(be.graphs, "get", "replay"),
            (be, "_advance"): wrap(be, "_advance", "advance_and_sync")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    acc["iteration"] = time.perf_counter() - t0
    for (obj, attr), fn in real.items():
        setattr(obj, attr, fn)
    ms = {k: v * 1e3 / steps for k, v in acc.items()}
    ms["scheduler"] = ms["iteration"] - ms["backend_step"]
    return ms


def profile_serve(torch, L, eng, cfg, steps: int = 4) -> list:
    """Where a paged engine iteration spends its time once all 8 slots
    decode: 8 requests of 64-token prompts are prefilled (one chunk an
    iteration), then ``steps`` decode-only iterations are profiled with
    the step from the graph (the shipped path), the same number split by
    the host clock (:func:`iteration_split`), and ``steps`` more with the
    step eager."""
    for p in serve_prompts(torch, cfg, [64] * 8, 9):
        eng.submit(p, max_new_tokens=SERVE_NEW)
    for _ in range(10):  # 8 one-chunk prefills, then decoding
        eng.step()
    replays = eng.backend.graphs.snapshot()["replays"]
    graph = device_profile(torch, eng.step, steps,
                           f"{steps} paged engine iterations from the "
                           f"graph, 8 slots decoding, small bf16")
    assert eng.backend.graphs.snapshot()["replays"] == replays + steps
    graph["host_split_ms"] = iteration_split(torch, eng, steps)
    real = eng.backend.step
    eng.backend.step = eager_backend_step(L, eng.backend)
    try:
        eager = device_profile(torch, eng.step, steps,
                               f"{steps} paged engine iterations, eager "
                               f"step, 8 slots decoding, small bf16")
    finally:
        eng.backend.step = real
    eng.run_until_idle()
    return [graph, eager]


def phase_serve(torch, kernels) -> dict:
    from sparkdl_tpu_torch.models import llama as L

    cfg = L.LlamaConfig.small()
    nl = cfg.num_layers
    model = L.LlamaModel(cfg, dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    paged = dict(block_size=16, prefill_chunk=256)
    # warm-up (cuBLAS handles, allocator), outside every counted leg
    warm, _ = serve_leg(torch, model, kernels, leg="warm-up",
                        prompts=[[1, 2, 3] * 20], **paged)
    del warm
    g = torch.Generator().manual_seed(3)
    lens = torch.randint(32, 1537, (12,), generator=g).tolist()
    shared = (0, 9, 10, 11)  # 9-11 queue behind 0's committed prefix
    for i in shared:
        lens[i] = max(lens[i], 600)
    legs = {}

    rec, eng = serve_leg(torch, model, kernels, leg="paged",
                         prompts=serve_prompts(torch, cfg, lens, 4, shared),
                         **paged)
    hits = (rec["prefix"] or {}).get("hits", 0)
    assert rec["launches"]["paged_flash_decode"] == nl * rec["steps"], rec
    assert rec["launches"]["flash_decode"] == 0, rec
    assert hits >= 1, f"no radix graft in the paged leg: {rec['prefix']}"
    emit(rec)
    legs["paged"] = rec
    for rec in profile_serve(torch, L, eng, cfg):
        emit(rec)
    del eng

    rec, eng = serve_leg(
        torch, model, kernels, leg="speculative", spec_k=4,
        prompts=serve_prompts(torch, cfg, [700, 400, 260, 96], 5,
                              repeat=24), **paged)
    assert rec["spec_verifies"] >= 1, rec
    assert rec["launches"]["paged_flash_decode"] == nl * rec["steps"], rec
    emit(rec)
    legs["speculative"] = rec
    del eng

    rec, eng = serve_leg(torch, model, kernels, leg="int8_kv",
                         kv_dtype="int8",
                         prompts=serve_prompts(torch, cfg,
                                               [700, 300, 1200, 64], 6),
                         **paged)
    assert eng.backend.cache.k[0].dtype == torch.int8
    assert rec["launches"]["paged_flash_decode"] == nl * rec["steps"] > 0, \
        rec  # every launch read int8 codes: the pool holds nothing else
    emit(rec)
    legs["int8_kv"] = rec
    del eng

    rec, eng = serve_leg(torch, model, kernels, leg="unpaged_blocking",
                         block_size=0, stall_free=False,
                         prompts=serve_prompts(torch, cfg,
                                               [900, 500, 200, 40], 7))
    assert rec["launches"]["flash_attention"] == nl * rec["prefills"], rec
    assert rec["launches"]["flash_decode"] == nl * rec["steps"], rec
    assert rec["launches"]["paged_flash_decode"] == 0, rec
    emit(rec)
    legs["unpaged_blocking"] = rec
    del eng, model
    torch.cuda.empty_cache()
    return legs


def phase_serve_parity(torch, kernels) -> dict:
    from sparkdl_tpu_torch import GenerationEngine
    from sparkdl_tpu_torch.models import llama as L

    cfg = L.LlamaConfig.small()
    model = L.LlamaModel(cfg, dtype=torch.float32, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    prompts = serve_prompts(torch, cfg, [600, 300, 90, 33], 8)
    new = PARITY_TOKENS
    ids, pads = L.left_pad_prompts(prompts)
    out = L.generate(model, ids, new, pad_lens=pads)
    refs = [out[i, ids.shape[1]:].tolist() for i in range(len(prompts))]
    eng = GenerationEngine.from_model(model, num_slots=4, max_len=1024,
                                      block_size=16, prefill_chunk=256,
                                      device="cuda")
    reset_counts(*kernels)
    hs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.run_until_idle()
    launches = read_counts(*kernels)
    got = [h.result(1) for h in hs]
    assert launches["paged_flash_decode"] == \
        cfg.num_layers * eng.stats["steps"] > 0, launches
    # top-2 logit gaps at every generated position, from one dense
    # forward over each finished engine sequence
    model.attn_fn = None
    gate = 10 * LOGIT_TOL
    near_ties, min_gap, identical = [], float("inf"), 0
    with torch.no_grad():
        for r, (p, stream, ref) in enumerate(zip(prompts, got, refs)):
            seq = torch.tensor([p + stream], device="cuda")
            logits = model(seq)[0, len(p) - 1:len(p) - 1 + new]
            top2 = logits.topk(2, dim=-1).values
            gaps = (top2[:, 0] - top2[:, 1]).tolist()
            min_gap = min(min_gap, min(gaps))
            flip = next((j for j in range(new) if stream[j] != ref[j]),
                        None)
            if flip is None:
                identical += 1
                continue
            assert gaps[flip] <= gate, (
                f"request {r}: engine and generate() differ at position "
                f"{flip} with a top-2 gap of {gaps[flip]} > {gate}")
            near_ties.append(dict(request=r, position=flip,
                                  gap=gaps[flip]))
    rec = dict(phase="serve_parity", config="LlamaConfig.small",
               dtype="float32", tf32=False, layers=cfg.num_layers,
               depth_cut=False, prompt_lens=[len(p) for p in prompts],
               new_tokens=new, engine="paged, block 16, 256-token chunks",
               reference="generate() through the flash kernels",
               identical_streams=identical, requests=len(prompts),
               near_tie_gate=gate, near_ties=near_ties,
               min_top2_gap=min_gap, launches=launches)
    emit(rec)
    del eng, model
    torch.cuda.empty_cache()
    return rec


def train_flops(model, b: int, s: int) -> float:
    """The FLOPs of one LoRA train step, for MFU: 4·N·T for the frozen
    projections (N their weights, ``lm_head`` included, the embedding
    not; T = b·s tokens; the forward and the gradient with respect to
    their inputs, no weight gradient), 6·N_lora·T for the adapters
    (forward, input and weight gradients), and attention's seven products
    of 2·D a live causal (row, col) pair a head and layer: q·kᵀ and P·V
    forward, q·kᵀ again, dV, dP, dK and dQ backward."""
    cfg = model.cfg
    n_proj = sum(p.numel() for n, p in model.named_parameters()
                 if n.endswith("base.weight") or n == "lm_head.weight")
    n_lora = sum(p.numel() for n, p in model.named_parameters()
                 if "lora_" in n)
    pairs = b * s * (s + 1) / 2 * cfg.num_heads * cfg.num_layers
    t = b * s
    return 4.0 * n_proj * t + 6.0 * n_lora * t + 7 * 2.0 * cfg.head_dim * pairs


def train_ids(torch, cfg):
    g = torch.Generator().manual_seed(11)
    return torch.randint(1, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                         generator=g).numpy()


def phase_train(torch, kernels) -> dict:
    """Phase g: the LoRA fine-tune of llama3_8b(lora_rank=16) at full
    width and depth through the runner, ``XlaRunner(np=1).run(ctx.fit)``,
    one seeded batch repeated for ``TRAIN_STEPS`` steps; then one more
    step profiled."""
    import gc

    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.runner import XlaRunner
    from sparkdl_tpu_torch.runner.train_state import make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    cfg = L.LlamaConfig.llama3_8b(lora_rank=16)
    t0 = time.perf_counter()
    model = L.LlamaModel(cfg, dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = train_ids(torch, cfg)
    mask = L.lora_mask(model)
    probe = ("layers.0.attn.q_proj.base.weight",
             "layers.31.mlp.down_proj.base.weight", "lm_head.weight",
             "embed_tokens.weight", "layers.17.attn_norm.scale")
    params = dict(model.named_parameters())
    checksum = {n: params[n].double().sum().item() for n in probe}
    adapters = {n: p.detach().clone() for n, p in params.items() if mask[n]}
    flops = train_flops(model, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    res = XlaRunner(np=1).run(lambda ctx: ctx.fit(
        loss_fn=L.causal_lm_loss_fn(), model=model,
        tx=L.lora_optimizer(TRAIN_LR),
        data=[{"input_ids": ids}] * TRAIN_STEPS, num_steps=TRAIN_STEPS,
        log_every=1, flops_per_step=flops))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counts(*kernels)
    bwd_variants = dict(kernels[0].flash_attention_bwd.variant_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in res["history"]]
    nl = cfg.num_layers
    assert len(losses) == TRAIN_STEPS, losses
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
    assert launches["flash_attention"] == nl * TRAIN_STEPS, launches
    assert launches["flash_attention_bwd"] == nl * TRAIN_STEPS, launches
    assert bwd_variants == {"fma_f32": 0, "tc_mma_bf16": nl * TRAIN_STEPS}, (
        bwd_variants)
    assert launches["flash_decode"] == launches["paged_flash_decode"] == 0
    after = {n: params[n].double().sum().item() for n in probe}
    assert after == checksum, f"base weights moved: {checksum} -> {after}"
    assert all(p.requires_grad == mask[n] for n, p in params.items())
    moved = sum(not torch.equal(params[n], a) for n, a in adapters.items())
    assert moved == len(adapters), f"{moved} of {len(adapters)} adapters"
    summ = res["meter"].summary()
    st = summ["step_time"]
    step_s = st["p50_s"]
    rec = dict(phase="train", config="LlamaConfig.llama3_8b(lora_rank=16)",
               dtype="bfloat16", layers=nl, hidden=cfg.hidden_size,
               heads=[cfg.num_heads, cfg.num_kv_heads],
               head_dim=cfg.head_dim, ffn=cfg.intermediate_size,
               vocab=cfg.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               steps=TRAIN_STEPS, lr=TRAIN_LR, attn="flash kernels (auto)",
               adapters=len(adapters),
               adapter_params=sum(a.numel() for a in adapters.values()),
               losses=losses, step_ms_median=step_s * 1e3,
               step_time=st, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
               flops_per_step=flops,
               mfu=flops / step_s / PEAK_FLOPS["bfloat16"],
               meter_mfu=summ["mfu"], peak_mem_gb=peak_gb,
               launches=launches, bwd_variant_launches=bwd_variants,
               base_checksum_unchanged=True,
               adapters_moved=moved, init_s=init_s, fit_s=fit_s,
               nvidia_smi=smi())
    emit(rec)
    step_fn = make_train_step(L.causal_lm_loss_fn())
    batch = {"input_ids": torch.as_tensor(ids).cuda()}
    prof = device_profile(torch, lambda: step_fn(res["state"], batch), 1,
                          "1 LoRA train step, llama3_8b bf16", match="fa_bwd")
    emit(prof)
    if isinstance(prof["device_busy_ms_per_step"], float):
        # the backward's kernels by name: delta, then the tensor-core pair
        names = " ".join(k["name"] for k in prof["matched_kernels"])
        assert "fa_bwd_dkdv_tc_kernel" in names and \
            "fa_bwd_dq_tc_kernel" in names, prof["matched_kernels"]
    del res, model, params, adapters, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_train_parity(torch) -> dict:
    """Phase g, parity: llama3_8b(lora_rank=16)'s widths at depth 2, f32,
    TF32 off, the seeded adapters' B made non-zero: the causal LM loss and
    every adapter gradient of the kernel arm (``attn_fn="auto"``, both
    flash kernels) against the dense arm (``attn_fn=None``) on phase g's
    batch. At full depth the dense arm's S×S scores would not fit."""
    import dataclasses

    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(L.LlamaConfig.llama3_8b(lora_rank=16),
                              num_layers=2)
    model = L.LlamaModel(cfg, dtype=torch.float32, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    L.lora_optimizer(TRAIN_LR)(model)  # freezes the base weights
    g = torch.Generator(device="cuda").manual_seed(12)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if "lora_b" in n:
                p.normal_(0.0, 0.02, generator=g)
    batch = {"input_ids": torch.as_tensor(train_ids(torch, cfg)).cuda()}

    def arm():
        model.zero_grad(set_to_none=True)
        loss, _ = L.causal_lm_loss_fn()(model, batch)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None}

    f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    loss_k, grads_k = arm()
    assert fa.flash_attention_fwd.launches - f0 == cfg.num_layers
    assert fa.flash_attention_bwd.launches - b0 == cfg.num_layers
    model.attn_fn = None
    loss_d, grads_d = arm()
    assert sorted(grads_k) == sorted(grads_d) == sorted(
        n for n in grads_d if "lora_" in n)
    shares = {}
    for n, want in grads_d.items():
        scale = want.abs().max().item()
        assert scale > 0, n
        shares[n] = (grads_k[n] - want).abs().max().item() / scale
    worst = max(shares, key=shares.get)
    rec = dict(phase="train_parity",
               config="LlamaConfig.llama3_8b(lora_rank=16), 2 layers",
               dtype="float32", tf32=False, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               loss_kernel=loss_k, loss_dense=loss_d,
               loss_abs_err=abs(loss_k - loss_d), loss_tol=TRAIN_LOSS_TOL,
               adapters=len(shares), max_grad_share=shares[worst],
               worst_adapter=worst, grad_share_tol=TRAIN_GRAD_SHARE)
    emit(rec)
    assert rec["loss_abs_err"] <= TRAIN_LOSS_TOL, rec
    assert shares[worst] <= TRAIN_GRAD_SHARE, rec
    del model, grads_k, grads_d
    torch.cuda.empty_cache()
    return rec


def glue_lengths(step: int) -> list:
    """Phase h's row lengths for batch ``step``: GLUE_BATCH draws in
    [GLUE_MIN_LEN, GLUE_SEQ]."""
    import numpy as np

    rng = np.random.RandomState(1000 + step)
    return rng.randint(GLUE_MIN_LEN, GLUE_SEQ + 1, GLUE_BATCH).tolist()


def glue_batch(step: int, vocab: int) -> dict:
    """Phase h's batch ``step``, numpy: right-padded ids and mask, the
    first token one of GLUE_IDS ids and the label whether it lies in their
    upper half (the rule of tests/test_transformer_models.py's config-4
    test)."""
    import numpy as np

    rng = np.random.RandomState(2000 + step)
    lens = np.asarray(glue_lengths(step))
    mask = (np.arange(GLUE_SEQ)[None] < lens[:, None]).astype(np.int32)
    ids = rng.randint(1, vocab, (GLUE_BATCH, GLUE_SEQ)) * mask
    ids[:, 0] = 2 + rng.randint(0, GLUE_IDS, GLUE_BATCH)
    return {"input_ids": ids, "attention_mask": mask,
            "label": (ids[:, 0] >= 2 + GLUE_IDS // 2).astype(np.int64)}


def glue_flops(model, batch) -> float:
    """The FLOPs of one BERT train step, for MFU: 6·N·T for the Dense
    weights (N their weights, all trainable, the embeddings not; T = B·S
    tokens, pads in), and 7 products of 2·D a live (row, col) pair a head
    and layer (q·kᵀ and P·V forward; q·kᵀ again, dV, dP, dK, dQ backward),
    live pairs = sum over rows b of S·L_b (every query row, pads
    included, attends its row's L_b keys)."""
    cfg = model.cfg
    n_dense = sum(p.numel() for n, p in model.named_parameters()
                  if n.endswith("weight"))
    b, s = batch["input_ids"].shape
    pairs = s * float(batch["attention_mask"].sum())
    return (6.0 * n_dense * b * s
            + 7 * 2.0 * cfg.head_dim * pairs * cfg.num_heads
            * cfg.num_layers)


GLUE_MFU_FORMULA = ("6·N·T (N Dense weights, all trainable, embeddings "
                    "out; T = B·S, pads in) + 7·2·D·H·layers·Σ_b S·L_b")


def phase_glue(torch, kernels) -> tuple:
    """Phase h: BASELINE configuration 4, the BERT-base GLUE fine-tune at
    full width and depth through the runner with dropout,
    ``XlaRunner(np=1).run(ctx.fit(bert_finetune_loss(model),
    with_rng=True))``, GLUE_STEPS seeded batches from a
    ``FactoryDataset``; then one more step profiled. Returns the record
    and the trained model (phase i classifies with it)."""
    import gc

    from sparkdl_tpu_torch.models import bert as B
    from sparkdl_tpu_torch.runner import XlaRunner
    from sparkdl_tpu_torch.runner.data import FactoryDataset
    from sparkdl_tpu_torch.runner.train_state import adam, make_train_step

    fa = kernels[0]
    gc.collect()
    torch.cuda.empty_cache()
    cfg = B.BertConfig.base()
    t0 = time.perf_counter()
    model = B.BertForSequenceClassification(
        cfg, num_classes=2, dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    assert fa.resolve_attn_fn(model.attn_fn) is fa.adaptive_attention
    batches = [glue_batch(i, cfg.vocab_size) for i in range(GLUE_STEPS)]
    flops = [glue_flops(model, b) for b in batches]
    mean_flops = sum(flops[1:]) / (GLUE_STEPS - 1)  # the steps timed
    live = [int(b["attention_mask"].sum()) for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    res = XlaRunner(np=1).run(lambda ctx: ctx.fit(
        loss_fn=B.bert_finetune_loss(model), model=model,
        tx=adam(GLUE_LR), data=FactoryDataset(lambda: iter(batches)),
        num_steps=GLUE_STEPS, log_every=1, with_rng=True,
        flops_per_step=mean_flops))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counts(*kernels)
    bwd_variants = dict(fa.flash_attention_bwd.variant_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in res["history"]]
    nl = cfg.num_layers
    assert len(losses) == GLUE_STEPS, losses
    assert all(math.isfinite(x) for x in losses), losses
    first, last = (sum(losses[:5]) / 5, sum(losses[-5:]) / 5)
    # learned: the last five steps' mean below the first step's loss
    assert last < losses[0], f"the loss did not fall: {losses}"
    # one forward and one backward kernel launch a layer a step: every
    # layer's attention went through the kernels, none through dense
    assert launches["flash_attention"] == nl * GLUE_STEPS, launches
    assert launches["flash_attention_bwd"] == nl * GLUE_STEPS, launches
    assert bwd_variants == {"fma_f32": 0, "tc_mma_bf16": nl * GLUE_STEPS}, (
        bwd_variants)
    assert launches["flash_decode"] == launches["paged_flash_decode"] == 0
    st = res["meter"].summary()["step_time"]
    step_s = st["p50_s"]
    rec = dict(phase="glue", config="BertConfig.base()", num_classes=2,
               dtype="bfloat16", params="float32", tf32=False,
               layers=nl, hidden=cfg.hidden_size, heads=cfg.num_heads,
               head_dim=cfg.head_dim, ffn=cfg.intermediate_size,
               vocab=cfg.vocab_size, dropout=cfg.dropout_rate,
               batch=GLUE_BATCH, seq=GLUE_SEQ, lengths=[GLUE_MIN_LEN,
                                                        GLUE_SEQ],
               steps=GLUE_STEPS, lr=GLUE_LR, optimizer="adam",
               attn="flash kernels (auto)", with_rng=True,
               step_ms_median=step_s * 1e3, step_time=st,
               examples_per_s=GLUE_BATCH / step_s,
               live_tokens_per_s=sum(live[1:]) / (GLUE_STEPS - 1) / step_s,
               flops_per_step=mean_flops, mfu=mean_flops / step_s
               / PEAK_FLOPS["bfloat16"], mfu_formula=GLUE_MFU_FORMULA,
               peak_mem_gb=peak_gb, loss_first=losses[0],
               loss_last=losses[-1], loss_first5_mean=first,
               loss_last5_mean=last, losses=losses,
               launches=launches, bwd_variant_launches=bwd_variants,
               fwd_variant_launches={fa.kernel_variant(model.dtype):
                                     launches["flash_attention"]},
               launches_per_step={k: v / GLUE_STEPS
                                  for k, v in launches.items()},
               init_s=init_s, fit_s=fit_s,
               nvidia_smi=smi())
    emit(rec)
    step_fn = make_train_step(B.bert_finetune_loss(model), with_rng=True)
    batch = {k: torch.as_tensor(v).cuda() for k, v in batches[0].items()}
    prof = device_profile(torch, lambda: step_fn(res["state"], batch), 1,
                          "1 BERT-base GLUE train step, bf16", match="fa_")
    emit(prof)
    if isinstance(prof["device_busy_ms_per_step"], float):
        names = " ".join(k["name"] for k in prof["matched_kernels"])
        assert "fa_fwd_tc_kernel" in names and \
            "fa_bwd_dkdv_tc_kernel" in names and \
            "fa_bwd_dq_tc_kernel" in names, prof["matched_kernels"]
    del res, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec, model


def phase_glue_parity(torch, kernels) -> dict:
    """Phase h, parity: BertConfig.base()'s widths at depth 2, f32, TF32
    off, deterministic, on phase h's first batch (right pads): the GLUE
    loss and every parameter gradient of the kernel arm
    (``attn_fn=fa.flash_attention``) against the dense arm
    (``attn_fn=None``); then ``with_rng`` on a CUDA generator: the same
    seed repeats two steps' losses to the bit, another seed changes
    them."""
    import copy
    import dataclasses

    from sparkdl_tpu_torch.models import bert as B
    from sparkdl_tpu_torch.runner import TrainState
    from sparkdl_tpu_torch.runner.train_state import adam, make_train_step

    fa = kernels[0]
    cfg = dataclasses.replace(B.BertConfig.base(), num_layers=2)
    model = B.BertForSequenceClassification(
        cfg, num_classes=2, dtype=torch.float32, attn_fn=fa.flash_attention,
        device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in glue_batch(0, cfg.vocab_size).items()}

    def arm():
        model.zero_grad(set_to_none=True)
        loss, _ = B.glue_loss_fn()(model, batch)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    f0 = fa.flash_attention_fwd.launches
    b0 = fa.flash_attention_bwd.variant_launches["fma_f32"]
    loss_k, grads_k = arm()
    assert fa.flash_attention_fwd.launches - f0 == cfg.num_layers
    assert (fa.flash_attention_bwd.variant_launches["fma_f32"] - b0
            == cfg.num_layers)
    model.attn_fn = None
    loss_d, grads_d = arm()
    top = max(g.abs().max().item() for g in grads_d.values())
    shares, key_bias = {}, 0.0
    for n, want in grads_d.items():
        if n.endswith("key.bias"):
            key_bias = max(key_bias, grads_k[n].abs().max().item() / top,
                           want.abs().max().item() / top)
            continue
        scale = want.abs().max().item()
        assert scale > 0, n
        shares[n] = (grads_k[n] - want).abs().max().item() / scale
    worst = max(shares, key=shares.get)

    model.attn_fn = fa.flash_attention
    start = copy.deepcopy(model.state_dict())

    def rng_losses(seed):
        model.load_state_dict(start)
        state = TrainState.create(model, adam(GLUE_LR))
        step = make_train_step(B.bert_finetune_loss(model), with_rng=True,
                               rng_seed=seed)
        out = []
        for _ in range(2):
            state, m = step(state, batch)
            out.append(float(m["loss"]))
        return out

    a, again, other = rng_losses(0), rng_losses(0), rng_losses(1)
    rec = dict(phase="glue_parity",
               config="BertConfig.base(), 2 layers", dtype="float32",
               tf32=False, batch=GLUE_BATCH, seq=GLUE_SEQ,
               loss_kernel=loss_k, loss_dense=loss_d,
               loss_abs_err=abs(loss_k - loss_d), loss_tol=TRAIN_LOSS_TOL,
               params=len(shares), max_grad_share=shares[worst],
               worst_param=worst, grad_share_tol=TRAIN_GRAD_SHARE,
               key_bias_grad_share=key_bias,
               key_bias_share_tol=GLUE_KEY_BIAS_SHARE,
               with_rng_losses=a, with_rng_repeat=again,
               with_rng_other_seed=other)
    emit(rec)
    assert rec["loss_abs_err"] <= TRAIN_LOSS_TOL, rec
    assert shares[worst] <= TRAIN_GRAD_SHARE, rec
    assert key_bias <= GLUE_KEY_BIAS_SHARE, rec
    assert a == again and a != other, rec
    del model, grads_k, grads_d, start
    torch.cuda.empty_cache()
    return rec


def phase_classify(torch, kernels, model) -> dict:
    """Phase i: ``udf.classify_rows``, the sequence-classification UDF's
    device step, on phase h's trained model (bf16), CLASSIFY_ROWS seeded
    rows of lengths 8-128 in chunks of CLASSIFY_CHUNK: rows/s and the
    flash launches (one a layer a chunk). The predictions are held to the
    f32 dense arm's (same weights, ``attn_fn=None``) where the top-2
    logit gap allows: the f32 kernel arm's beyond 10 x the f32 parity
    tolerance, the bf16 kernel arm's beyond 10 x the bf16 logit rule."""
    import numpy as np

    from sparkdl_tpu_torch.models import bert as B
    from sparkdl_tpu_torch.udf import classify_rows, right_pad_rows

    fa = kernels[0]
    cfg = model.cfg
    rng = np.random.RandomState(7)
    lens = rng.randint(GLUE_MIN_LEN, GLUE_SEQ + 1, CLASSIFY_ROWS)
    rows = [[2 + int(rng.randint(0, GLUE_IDS))]
            + rng.randint(1, cfg.vocab_size, n - 1).tolist() for n in lens]
    max_len = int(lens.max())
    chunks = [rows[i:i + CLASSIFY_CHUNK]
              for i in range(0, CLASSIFY_ROWS, CLASSIFY_CHUNK)]

    def classify(m):
        return np.concatenate([classify_rows(m, c, max_len) for c in chunks])

    classify(model)  # warm-up outside the counted run
    torch.cuda.synchronize()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    pred = classify(model)  # numpy out: waits for the device
    secs = time.perf_counter() - t0
    launches = read_counts(*kernels)
    assert launches["flash_attention"] == cfg.num_layers * len(chunks), (
        launches)
    assert launches["flash_attention_bwd"] == 0, launches

    f32 = B.BertForSequenceClassification(
        cfg, num_classes=model.num_classes, dtype=torch.float32,
        attn_fn=fa.flash_attention, device="cuda")
    f32.load_state_dict(model.state_dict())  # f32 parameters in both
    pred_f32 = classify(f32)
    f32.attn_fn = None
    logits = []
    with torch.no_grad():
        for c in chunks:
            ids, mask = right_pad_rows(c, max_len)
            logits.append(f32(torch.from_numpy(ids).cuda(),
                              torch.from_numpy(mask).cuda()).cpu())
    logits = torch.cat(logits)
    top2 = logits.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).numpy()
    dense = logits.argmax(-1).numpy()
    bf16_rule = 10 * BF16_LOGIT_RTOL * (1 + logits.abs().amax(-1).numpy())

    def flips(p, rule):
        bad = (p != dense)
        return (int((bad & (gap > rule)).sum()),
                sorted(float(g) for g in gap[bad & (gap <= rule)])[:8])

    f32_held, f32_ties = flips(pred_f32, 10 * TRAIN_LOSS_TOL)
    bf16_held, bf16_ties = flips(pred, bf16_rule)
    rec = dict(phase="classify", config="BertConfig.base()", dtype="bfloat16",
               rows=CLASSIFY_ROWS, chunk=CLASSIFY_CHUNK, max_len=max_len,
               lengths=[GLUE_MIN_LEN, GLUE_SEQ], seconds=secs,
               rows_per_s=CLASSIFY_ROWS / secs,
               live_tokens_per_s=float(lens.sum()) / secs,
               launches=launches, chunks=len(chunks),
               class_share=float(pred.mean()),
               f32_kernel_flips_above_rule=f32_held,
               f32_near_ties=f32_ties, f32_rule=10 * TRAIN_LOSS_TOL,
               bf16_flips_above_rule=bf16_held, bf16_near_ties=bf16_ties,
               bf16_rule="10·2^-6·(1 + max|logit|)",
               rows_agreeing_bf16=int((pred == dense).sum()),
               min_gap=float(gap.min()), nvidia_smi=smi())
    emit(rec)
    assert f32_held == 0 and bf16_held == 0, rec
    del f32
    torch.cuda.empty_cache()
    return rec


def image_flops(torch, model, h: int, w: int) -> int:
    """FLOPs a row of ``model``'s features from its own conv and dense
    shapes (2 per multiply-add; BatchNorm, pools and the prologue are not
    counted), read by forward hooks on one row at ``h`` x ``w``."""
    from sparkdl_tpu_torch.models.image_layers import Conv, Dense

    total = [0]

    def conv(m, inp, out):
        total[0] += 2 * out[0].numel() * m.weight.shape[1] * m.kernel[0] \
            * m.kernel[1]

    def dense(m, inp, out):
        total[0] += 2 * out[0].numel() * m.weight.shape[1]

    hooks = [m.register_forward_hook(conv if isinstance(m, Conv) else dense)
             for m in model.modules() if isinstance(m, (Conv, Dense))]
    dev = next(model.parameters()).device
    with torch.inference_mode():
        model(torch.zeros(1, h, w, 3, device=dev), features_only=True)
    for hk in hooks:
        hk.remove()
    return total[0]


def wire_batches(name: str, labels, seed: int) -> list:
    """uint8 BGR NHWC wire batches of IMAGE_BATCH rows for ``name``: the
    first half at the model's input size, the second at NATIVE_SIZE. A
    row of label 1 is brighter (pixels drawn in [64, 256) against [0,
    192)): two classes of different mean colour."""
    import numpy as np

    from sparkdl_tpu_torch.models.registry import get_model

    h = get_model(name).input_size[0]
    rng = np.random.default_rng(seed)
    out = []
    n_batches = len(labels) // IMAGE_BATCH
    for i in range(n_batches):
        e = h if i < n_batches // 2 else NATIVE_SIZE[h]
        y = labels[i * IMAGE_BATCH:(i + 1) * IMAGE_BATCH]
        b = rng.integers(0, 192, (IMAGE_BATCH, e, e, 3), dtype=np.uint8)
        b += (64 * y).astype(np.uint8)[:, None, None, None]
        out.append(b)
    return out


def h2d_ms(torch, batch) -> float:
    """Device time of one pinned host → device copy of ``batch`` (CUDA
    events, mean of 5)."""
    pinned = torch.from_numpy(batch).pin_memory()
    return time_ms(torch, lambda: pinned.to("cuda", non_blocking=True),
                   iters=5)


def featurize_arm(torch, name: str, dtype: str, batch_size: int, wire,
                  tf32: bool) -> tuple:
    """One ``featurize`` line: the featurizer's own runner over ``wire``
    (re-cut to ``batch_size`` rows a batch), timed end to end after a
    warm-up of one batch of each wire shape. Returns (record, features,
    featurizer)."""
    import numpy as np

    from sparkdl_tpu_torch.runner import events
    from sparkdl_tpu_torch.transformers import DeepImageFeaturizer

    torch.backends.cudnn.allow_tf32 = tf32
    f = DeepImageFeaturizer(modelName=name, computeDtype=dtype,
                            batchSize=batch_size, seed=0)
    runner = f._get_runner()
    batches = [b[i:i + batch_size] for b in wire
               for i in range(0, len(b), batch_size)]
    list(runner.run([batches[0], batches[-1]]))  # each wire shape once
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = events.get_recorder()
    rec.ring.clear()
    stamps = []
    t0 = time.perf_counter()
    feats = []
    for out in runner.run(batches):
        feats.append(out)
        stamps.append(time.perf_counter())
    secs = time.perf_counter() - t0
    feats = np.concatenate(feats)
    stage_ms = {}
    for e in rec.ring:
        if e.get("ph") == "E" and e["name"] in ("pad", "put", "dispatch",
                                               "fetch"):
            stage_ms[e["name"]] = stage_ms.get(e["name"], 0.0) \
                + e.get("dur_s", 0.0) * 1e3
    h = f._model().input_size[0]
    flops_row = image_flops(torch, _served(f), h, h)
    rows = len(feats)
    tflops = flops_row * rows / secs / 1e12
    shapes = sorted({b.shape[1] for b in wire})
    h2d = {f"{e}x{e}": h2d_ms(torch, next(b for b in wire
                                          if b.shape[1] == e)[:batch_size])
           for e in shapes}
    assert feats.shape == (IMAGE_ROWS, f.featureDim()), feats.shape
    assert np.isfinite(feats).all(), name
    out = dict(
        phase="featurize", model=name, compute_dtype=dtype,
        tf32=bool(tf32), batch_size=batch_size, rows=rows,
        wire_sizes=[f"{e}x{e}" for e in shapes],
        input_size=f._model().input_size, seconds=secs,
        rows_per_s=rows / secs,
        ms_per_batch_median=float(np.median(np.diff(stamps))) * 1e3,
        batches=len(batches), peak_mem_gb=torch.cuda.max_memory_allocated()
        / 1e9, flops_per_row=flops_row, tflops=tflops,
        share_of_989=tflops / (PEAK_FLOPS["bfloat16"] / 1e12),
        h2d_bytes=int(sum(b.nbytes for b in wire)),
        h2d_ms_per_batch=h2d,
        host_stage_ms=stage_ms, nvidia_smi=smi())
    emit(out)
    return out, feats, f


def _served(f):
    """The model the featurizer's runner serves (compute dtype, on the
    card), for ``image_flops``."""
    import copy

    m = copy.deepcopy(f._load_module()).to("cuda")
    m.dtype = f._compute_dtype()
    return m


def transfer_fit(torch, feats, labels) -> dict:
    """``transfer``: the logistic regression on the card on the featurizer's
    output, against the same fit on the CPU."""
    import numpy as np

    from sparkdl_tpu_torch.estimators import LogisticRegression

    kw = dict(maxIter=100, stepSize=0.1)
    LogisticRegression(**kw)._fit_arrays(feats[:512], labels[:512])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = LogisticRegression(**kw)._fit_arrays(feats, labels)
    secs = time.perf_counter() - t0
    pred, _ = card.predict_arrays(feats)
    t0 = time.perf_counter()
    cpu = LogisticRegression(device="cpu", **kw)._fit_arrays(feats, labels)
    cpu_secs = time.perf_counter() - t0
    cpu_pred, prob = cpu.predict_arrays(feats)
    top2 = np.sort(prob, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    held = margin > TRANSFER_MARGIN
    flips = int(((pred != cpu_pred) & held).sum())
    rec = dict(phase="transfer", model="InceptionV3", compute_dtype="bfloat16",
               rows=len(feats), feature_dim=feats.shape[1], max_iter=100,
               fit_s=secs, cpu_fit_s=cpu_secs,
               train_accuracy=float((pred == labels).mean()),
               cpu_train_accuracy=float((cpu_pred == labels).mean()),
               rows_held=int(held.sum()), flips_above_margin=flips,
               margin=TRANSFER_MARGIN,
               max_coef_diff=float(np.abs(card.weights - cpu.weights).max()),
               nvidia_smi=smi())
    emit(rec)
    assert rec["train_accuracy"] > 0.9 and flips == 0, rec
    return rec


def image_parity(torch) -> dict:
    """``image_parity`` (TF32 off): every registry model, f32 card vs the
    port's CPU forward (same weights, 2 full-size images), bf16 card vs
    f32 card; then the prologue's resize, card vs CPU."""
    import numpy as np

    from sparkdl_tpu_torch.core.runtime import resize_nhwc
    from sparkdl_tpu_torch.models.pretrained import cast_float_leaves
    from sparkdl_tpu_torch.models.registry import SUPPORTED_MODELS

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    atol_share, rtol = IMAGE_F32_RULE
    models = {}
    for name, m in SUPPORTED_MODELS.items():
        h, w = m.input_size
        x = torch.from_numpy(np.random.default_rng(11).integers(
            0, 256, (2, h, w, 3), dtype=np.uint8))
        model = m.build(seed=1)
        ref = m.apply_fn(model)(x).numpy()  # logits run the whole model
        ref_f = m.apply_fn(model, features_only=True)(x).numpy()
        card = model.to("cuda")
        got_f = m.apply_fn(card, features_only=True)(x.cuda()).cpu().numpy()
        got = m.apply_fn(card)(x.cuda()).cpu().numpy()
        card.dtype = torch.bfloat16
        bf = m.apply_fn(cast_float_leaves(card, "bfloat16"),
                        features_only=True)(x.cuda()).cpu().numpy()
        errs = {}
        for what, g, r in (("features", got_f, ref_f), ("logits", got, ref)):
            atol = atol_share * max(1.0, float(np.abs(r).max()))
            over = np.abs(g - r) - (atol + rtol * np.abs(r))
            errs[what] = dict(max_abs_err=float(np.abs(g - r).max()),
                              max_abs_ref=float(np.abs(r).max()),
                              worst_over_rule=float(over.max()))
            assert over.max() <= 0, (name, what, errs[what])
        bf_err = float(np.abs(bf - got_f).max())
        assert bf_err <= IMAGE_BF16_RULE * np.abs(got_f).max(), (name, bf_err)
        models[name] = dict(**errs, bf16_max_abs_err=bf_err,
                            bf16_share=bf_err / float(np.abs(got_f).max()))
        del card, model
        torch.cuda.empty_cache()
    resize = {}
    rng = np.random.default_rng(12)
    for src, dst in ((320, 299), (256, 224), (224, 299), (299, 299)):
        x = torch.from_numpy(rng.integers(0, 256, (4, src, src, 3),
                                          dtype=np.uint8)).float()
        cpu = resize_nhwc(x, dst, dst)
        card = resize_nhwc(x.cuda(), dst, dst).cpu()
        err = float((cpu - card).abs().max())
        resize[f"{src}->{dst}"] = err
        if src == dst:
            assert torch.equal(card, x), "the same-size skip is not exact"
        assert err <= RESIZE_ATOL, (src, dst, err)
    rec = dict(phase="image_parity", tf32=False, images=2,
               f32_rule="|d| <= 1e-4·max(1, max|ref|) + 1e-3·|ref|",
               bf16_rule="|d| <= 2^-5·max|f32|", models=models,
               resize_max_abs_err=resize, resize_atol=RESIZE_ATOL,
               nvidia_smi=smi())
    emit(rec)
    return rec


def phase_images(torch) -> dict:
    """Phase j: image scoring (module docstring)."""
    import numpy as np

    tf32_was = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    labels = np.random.default_rng(20).permutation(
        np.arange(IMAGE_ROWS) % 2).astype(np.int64)
    try:
        inc = wire_batches("InceptionV3", labels, seed=21)
        arms = {}
        arms["inception_bf16"], feats, f = featurize_arm(
            torch, "InceptionV3", "bfloat16", IMAGE_BATCH, inc, tf32=False)
        runner = f._get_runner()
        prof = device_profile(
            torch, lambda: list(runner.run(inc[:4])), 1,
            "4 batches of 256, InceptionV3 bf16 featurize")
        prof["launches_per_batch"] = prof["device_launches_per_step"] / 4
        emit(prof)
        del f, runner
        arms["inception_f32"], _, _ = featurize_arm(
            torch, "InceptionV3", "float32", IMAGE_BATCH, inc, tf32=False)
        arms["inception_f32_tf32"], _, _ = featurize_arm(
            torch, "InceptionV3", "float32", IMAGE_BATCH, inc, tf32=True)
        arms["inception_bf16_b32"], _, _ = featurize_arm(
            torch, "InceptionV3", "bfloat16", 32, inc, tf32=False)
        del inc
        rn = wire_batches("ResNet50", labels, seed=22)
        arms["resnet50_bf16"], _, _ = featurize_arm(
            torch, "ResNet50", "bfloat16", IMAGE_BATCH, rn, tf32=False)
        del rn
        torch.cuda.empty_cache()
        transfer = transfer_fit(torch, feats, labels)
        parity = image_parity(torch)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32_was
    return dict(arms=arms, profile=prof, transfer=transfer, parity=parity)


def resnet_wire(n: int, rows: int, size: int, seed: int) -> list:
    """``n`` uint8 NHWC wire batches of ``rows`` images with labels in
    [0, RESNET_COLOURS): pixels drawn in [0, 156) plus 10 × the label, so
    the classes differ in mean brightness (a rule a few steps can learn)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(0, RESNET_COLOURS, rows)
        x = rng.integers(0, 156, (rows, size, size, 3), dtype=np.uint8)
        x += (10 * y).astype(np.uint8)[:, None, None, None]
        out.append({"image": x, "label": y})
    return out


def resnet_preprocess(spec):
    """The registry model's preprocess (ImageNet mean and std) on the
    wire's uint8 images, on the card."""
    return lambda x: spec.preprocess(x.float())


def pageable_copy_ms(torch, batch) -> float:
    """Wall ms of the inline feed's copy of one wire batch (``.to`` from
    pageable host memory, which returns once the copy is done), median
    of 5."""
    import numpy as np

    t = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()}
        t.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(t))


def resnet_fit(torch, spec, model, batches, steps: int,
               lookahead: int = 0) -> tuple:
    """``XlaRunner(np=1).run(ctx.fit(bn_classifier_loss, sgd,
    mutable=True, log_every=1, feed_lookahead=lookahead))`` over
    ``steps`` batches cycled from ``batches``: (result, step seconds, fit
    seconds). A step's time runs from its loss call to the next step's
    (the last to the end of the fit): with ``log_every=1`` a step ends in
    a wait, so that is one step as the user sees it, device work, the
    host's launches and whatever of the batch's copy is not hidden. (The
    time between two draws is not: a lookahead draws ahead.)"""
    from sparkdl_tpu_torch.runner import XlaRunner, bn_classifier_loss, sgd

    flops = 3 * image_flops(torch, model, RESNET_SIZE, RESNET_SIZE) \
        * len(batches[0]["label"])
    stamps: list = []
    loss_fn = bn_classifier_loss(preprocess=resnet_preprocess(spec))

    def stamped(m, batch):
        stamps.append(time.perf_counter())
        return loss_fn(m, batch)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = XlaRunner(np=1).run(lambda ctx: ctx.fit(
        loss_fn=stamped, model=model, tx=sgd(RESNET_LR, momentum=0.9),
        data=(batches[i % len(batches)] for i in range(steps)),
        num_steps=steps, log_every=1, mutable=True, flops_per_step=flops,
        feed_lookahead=lookahead))
    torch.cuda.synchronize()
    end = time.perf_counter()
    stamps.append(end)
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    return res, step_s, end - t0, flops


def step_line(step_s: list, warmup: int) -> dict:
    """Median and spread of the steps after ``warmup``."""
    import numpy as np

    t = np.asarray(step_s[warmup:]) * 1e3
    return dict(timed_steps=len(t), step_ms_median=float(np.median(t)),
                step_ms_min=float(t.min()), step_ms_max=float(t.max()),
                step_ms_p10=float(np.percentile(t, 10)),
                step_ms_p90=float(np.percentile(t, 90)))


def resnet_train(torch, kernels) -> list:
    """Phase k, ``resnet_train``: ResNet-50 at full width and depth, f32
    parameters computed in bf16, RESNET_WARMUP + RESNET_TIMED steps
    through the runner, four times, inline and with
    ``feed_lookahead=RESNET_LOOKAHEAD`` in turn (the comparison within one
    call, neither always first); then a ``profile`` line of 3 bf16 steps
    (after the timed arms, so no timed step runs in a process that has
    been profiled); then an f32 arm with TF32 off."""
    import gc

    import numpy as np

    from sparkdl_tpu_torch.models.registry import get_model
    from sparkdl_tpu_torch.runner import bn_classifier_loss
    from sparkdl_tpu_torch.runner.train_state import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = get_model("ResNet50")
    wire = resnet_wire(RESNET_DISTINCT, RESNET_BATCH, RESNET_SIZE, seed=40)
    steps = RESNET_WARMUP + RESNET_TIMED
    arms = [("bfloat16", steps, ahead)
            for ahead in (0, RESNET_LOOKAHEAD, 0, RESNET_LOOKAHEAD)]
    out = []
    for arm, (dtype, n, ahead) in enumerate(
            arms + [("float32", RESNET_F32_STEPS, 0)]):
        gc.collect()
        torch.cuda.empty_cache()
        model = spec.build(dtype=getattr(torch, dtype), num_classes=1000,
                           seed=0, device="cuda")
        stats0 = {k: b.clone() for k, b in model.named_buffers()}
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        res, step_s, fit_s, flops = resnet_fit(torch, spec, model, wire, n,
                                               ahead)
        launches = read_counts(*kernels)
        losses = [h["loss"] for h in res["history"]]
        assert len(losses) == n and all(math.isfinite(x) for x in losses), \
            losses
        moved = sum(not torch.equal(b, stats0[k])
                    for k, b in model.named_buffers())
        assert moved == len(stats0), f"{moved} of {len(stats0)} statistics"
        warm = RESNET_WARMUP if dtype == "bfloat16" else 1
        line = step_line(step_s, warm)
        ms = line["step_ms_median"]
        rec = dict(
            phase="resnet_train", arm=arm, config="BASELINE config 3, np=1",
            model="ResNet50", compute_dtype=dtype, param_dtype="float32",
            tf32=False, image_size=RESNET_SIZE, classes=1000,
            batch=RESNET_BATCH, feed_lookahead=ahead, steps=n,
            warmup_steps=warm,
            optimizer=f"sgd({RESNET_LR}, momentum=0.9)", **line,
            images_per_s=RESNET_BATCH / ms * 1e3,
            flops_per_image_fwd=flops / 3 / RESNET_BATCH,
            flops_per_step=flops,
            mfu=flops / (ms / 1e3) / PEAK_FLOPS["bfloat16"],
            mfu_peak="989 TFLOP/s (dense bf16)",
            meter_mfu=res["meter"].summary()["mfu"],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            losses=losses, statistics_moved=moved, fit_s=fit_s,
            launches=launches, nvidia_smi=smi())
        if ahead:
            rec["inline_copy_ms"] = pageable_copy_ms(torch, wire[0])
        emit(rec)
        assert not any(launches.values()), launches  # no Pallas kernel here
        if dtype == "bfloat16":
            assert np.mean(losses[-5:]) < np.mean(losses[:5]), \
                f"the loss did not fall: {losses}"
        if arm == len(arms) - 1:
            step_fn = make_train_step(
                bn_classifier_loss(preprocess=resnet_preprocess(spec)),
                mutable=True)
            st = res["state"]
            batch = {k: torch.as_tensor(v).cuda() for k, v in
                     wire[0].items()}
            prof = device_profile(
                torch, lambda: step_fn(st, batch), 3,
                "3 ResNet-50 train steps, bf16, 256 a batch")
            prof["images_per_s_busy"] = (
                RESNET_BATCH / prof["device_busy_ms_per_step"] * 1e3
                if isinstance(prof["device_busy_ms_per_step"], float)
                else "not measured")
            emit(prof)
            out.append(prof)
        out.append(rec)
        del res, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _update_shares(got: dict, want: dict, before: dict) -> tuple:
    """(parameters, statistics). Parameters: the largest |got − want| as
    a share of the largest |want − before|. Statistics: the same share
    taken for each statistic against its own change, the largest of
    them (their scales differ by orders of magnitude between layers, and
    one share over all would let the largest hide the rest)."""
    def share(keys):
        return (max((got[k] - want[k]).abs().max().item() for k in keys)
                / max((want[k] - before[k]).abs().max().item()
                      for k in keys))

    params = share([k for k in want if "running" not in k])
    stats = max(share([k]) for k in want if "running" in k)
    return params, stats


def _parity_steps(torch, spec, loss_fn, wire, tf32: bool) -> list:
    """Mutable SGD steps of ResNet18 (10 classes) over ``wire``, each on
    the card and on the CPU from the card's state before it, with the
    card's TF32 switches set to ``tf32``: each step's shares
    (:func:`_update_shares`)."""
    import copy

    from sparkdl_tpu_torch.runner import TrainState, sgd
    from sparkdl_tpu_torch.runner.train_state import make_train_step

    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = spec.build(num_classes=10, seed=0)
    card = copy.deepcopy(cpu).to("cuda")
    s_card = TrainState.create(card, sgd(0.01, momentum=0.9))
    s_cpu = TrainState.create(cpu, sgd(0.01, momentum=0.9))
    step = make_train_step(loss_fn, mutable=True)
    steps = []
    for i, b in enumerate(wire):
        before = {k: v.detach().cpu().clone()
                  for k, v in card.state_dict().items()}
        cpu.load_state_dict(before)
        s_cpu.optimizer.load_state_dict(s_card.optimizer.state_dict())
        s_cpu.step = s_card.step
        step(s_card, {k: torch.as_tensor(v).cuda() for k, v in b.items()})
        step(s_cpu, {k: torch.as_tensor(v) for k, v in b.items()})
        got = {k: v.detach().cpu() for k, v in card.state_dict().items()}
        p, st = _update_shares(got, cpu.state_dict(), before)
        steps.append(dict(step=i + 1, param_share=p, stat_share=st))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return steps


def resnet_train_parity(torch) -> dict:
    """Phase k, ``resnet_train_parity`` (f32, TF32 off): two mutable SGD
    steps of ResNet18 (10 classes, 32², batch RESNET_PARITY_BATCH) on the
    card against the same steps on the CPU, each from the card's state
    before it; the first step again with TF32 on (the control, which
    must fall outside both limits: the check can see a convolution that
    ran in TF32); then one step with
    ``remat=True`` against ``remat=False`` from the same weights, whose
    statistics must agree (updated once)."""
    from sparkdl_tpu_torch.models.registry import get_model
    from sparkdl_tpu_torch.runner import TrainState, bn_classifier_loss, sgd
    from sparkdl_tpu_torch.runner.train_state import make_train_step

    spec = get_model("ResNet18")
    wire = resnet_wire(2, RESNET_PARITY_BATCH, 32, seed=41)
    loss_fn = bn_classifier_loss(preprocess=resnet_preprocess(spec))
    steps = _parity_steps(torch, spec, loss_fn, wire, tf32=False)
    control = _parity_steps(torch, spec, loss_fn, wire[:1], tf32=True)[0]
    remat = []
    for flag in (False, True):
        m = spec.build(num_classes=10, seed=0, device="cuda")
        make_train_step(loss_fn, mutable=True, remat=flag)(
            TrainState.create(m, sgd(0.01, momentum=0.9)),
            {k: torch.as_tensor(v).cuda() for k, v in wire[0].items()})
        remat.append({k: b.detach().cpu() for k, b in m.named_buffers()})
    remat_err = max((remat[0][k] - remat[1][k]).abs().max().item()
                    for k in remat[0])
    stat_scale = max(v.abs().max().item() for v in remat[0].values())
    rec = dict(phase="resnet_train_parity", model="ResNet18", classes=10,
               image_size=32, batch=RESNET_PARITY_BATCH, dtype="float32",
               tf32=False, optimizer="sgd(0.01, momentum=0.9)",
               steps=steps, param_share_tol=RESNET_PARITY_PARAM_SHARE,
               stat_share_tol=RESNET_PARITY_STAT_SHARE,
               tf32_control=dict(
                   control, param_over_tol=control["param_share"]
                   > RESNET_PARITY_PARAM_SHARE,
                   stat_over_tol=control["stat_share"]
                   > RESNET_PARITY_STAT_SHARE),
               remat_stats_max_abs_diff=remat_err,
               remat_stats_bitwise_equal=remat_err == 0.0,
               nvidia_smi=smi())
    emit(rec)
    for s_ in steps:
        assert s_["param_share"] <= RESNET_PARITY_PARAM_SHARE, rec
        assert s_["stat_share"] <= RESNET_PARITY_STAT_SHARE, rec
    assert rec["tf32_control"]["param_over_tol"], rec
    assert rec["tf32_control"]["stat_over_tol"], rec
    # a second update would move each statistic by (1 − m)·batch again
    assert remat_err <= 1e-6 * max(1.0, stat_scale), rec
    return rec


def checkpoint_phase(torch) -> dict:
    """Phase k, ``checkpoint``: ResNet-50 (bf16 compute) on the card,
    ``fit(checkpoint_every=2)`` for 4 steps, then a second fit with the
    same directory to 6 steps (it must resume at 4); the restored model
    and optimizer bit-identical to what was saved; then the newest step's
    file corrupted, and the restore must roll back to the verified step.
    Save and restore seconds and bytes."""
    import gc
    import os
    import tempfile

    from sparkdl_tpu_torch.models.registry import get_model
    from sparkdl_tpu_torch.runner import (CheckpointManager, TrainState,
                                          XlaRunner, bn_classifier_loss,
                                          events, metrics, sgd)
    from sparkdl_tpu_torch.runner.checkpoint import corrupt_latest_checkpoint

    spec = get_model("ResNet50")
    wire = resnet_wire(6, CKPT_BATCH, RESNET_SIZE, seed=42)

    def fit(model, d, steps):
        return XlaRunner(np=1, checkpoint_dir=d).run(lambda ctx: ctx.fit(
            loss_fn=bn_classifier_loss(preprocess=resnet_preprocess(spec)),
            model=model, tx=sgd(RESNET_LR, momentum=0.9), data=list(wire),
            num_steps=steps, log_every=1, mutable=True,
            checkpoint_every=2))

    def build():
        return spec.build(dtype=torch.bfloat16, num_classes=1000, seed=0,
                          device="cuda")

    metrics.run_stats.reset()
    rec_ring = events.get_recorder()
    with tempfile.TemporaryDirectory(prefix="sparkdl_ckpt_") as d:
        rec_ring.ring.clear()
        r1 = fit(build(), d, 4)
        saves = [e for e in rec_ring.ring
                 if e["name"] == "checkpoint_save" and e.get("ph") == "E"]
        saved = {k: v.detach().cpu().clone()
                 for k, v in r1["state"].model.state_dict().items()}
        saved_opt = [r1["state"].optimizer.state[p]["momentum_buffer"]
                     .cpu().clone() for p in r1["state"].trainable()]
        m = CheckpointManager(d)
        nbytes = sum(os.path.getsize(os.path.join(d, "4", f))
                     for f in os.listdir(os.path.join(d, "4")))
        # timed saves of the same state, beside the run's: waiting, and
        # asynchronous (returns once the tensors are on the host)
        timing = CheckpointManager(os.path.join(d, "timing"))
        t0 = time.perf_counter()
        timing.save(4, r1["state"], wait=True)
        save_wait_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        timing.save(5, r1["state"])
        save_async_return_s = time.perf_counter() - t0
        timing.wait()
        save_async_landed_s = time.perf_counter() - t0
        timing.close()
        fresh = TrainState.create(build(), sgd(RESNET_LR, momentum=0.9))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.restore(fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        assert fresh.step == 4, fresh.step
        got = fresh.model.state_dict()
        assert all(torch.equal(got[k].cpu(), v) for k, v in saved.items())
        got_opt = [fresh.optimizer.state[p]["momentum_buffer"].cpu()
                   for p in fresh.trainable()]
        assert all(torch.equal(a, b) for a, b in zip(got_opt, saved_opt))
        del fresh, r1
        r2 = fit(build(), d, 6)
        resumed = [e for e in rec_ring.ring if e["name"] == "train_resume"]
        assert resumed and resumed[-1]["step"] == 4, resumed
        assert r2["state"].step == 6 and r2["meter"].steps == 2
        assert m.latest_step() == 6
        damaged = corrupt_latest_checkpoint(d)
        assert damaged and not m.verify_step(6)[0]
        back = TrainState.create(build(), sgd(RESNET_LR, momentum=0.9))
        m.restore(back)
        assert back.step == 4, back.step
        assert metrics.run_stats.checkpoint_rollbacks == 1
        rolled = metrics.run_stats.last_rollback
        m.close()
        del r2, back
    rec = dict(phase="checkpoint", model="ResNet50", batch=CKPT_BATCH,
               checkpoint_every=2, first_fit_steps=4, resumed_at=4,
               second_fit_steps_run=2, bytes_per_step=nbytes,
               fit_save_s=[e.get("dur_s") for e in saves],
               save_wait_s=save_wait_s,
               save_async_return_s=save_async_return_s,
               save_async_landed_s=save_async_landed_s,
               restore_s=restore_s,
               save_mb_per_s=nbytes / save_wait_s / 1e6,
               restore_bit_identical=True, rollback=rolled,
               nvidia_smi=smi())
    emit(rec)
    metrics.run_stats.reset()
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_resnet(torch, kernels) -> dict:
    """Phase k: ResNet-50 training (module docstring)."""
    tf32_was = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    try:
        train = resnet_train(torch, kernels)
        parity = resnet_train_parity(torch)
        ckpt = checkpoint_phase(torch)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32_was
    return dict(train=train, parity=parity, checkpoint=ckpt)


def dp_worker(out_dir: str) -> int:
    """Phase l's gang worker (``chip_smoke.py --dp-worker <out_dir>``,
    started by ``launcher.launch``): joins the launcher's gang through
    ``XlaRunner`` (NCCL, rank r on ``cuda:r``) and writes to ``out_dir``
    ``dp_worker.json`` (the ``dp_gang`` arm: phase k's ResNet-50 run
    through the gang's implicit step, with synchronised BatchNorm, and a
    profile of 3 of its steps) and ``dp_parity.pt`` (one f32 gang step of
    phase k's parity model from its seed, and the same with ``remat``)."""
    import torch

    from sparkdl_tpu_torch.models.image_layers import BatchNorm
    from sparkdl_tpu_torch.models.registry import get_model
    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.ops import flash_decode as fd
    from sparkdl_tpu_torch.ops import paged_flash_decode as pfd
    from sparkdl_tpu_torch.runner import (TrainState, XlaRunner,
                                          bn_classifier_loss, sgd)
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runner = XlaRunner()
    ctx = runner.make_context()
    assert ctx.gang is not None and ctx.gang.backend == "nccl", ctx.gang
    assert ctx.device == torch.device("cuda", ctx.rank), ctx.device
    spec = get_model("ResNet50")
    local = RESNET_BATCH // ctx.size
    wire = resnet_wire(RESNET_DISTINCT, local, RESNET_SIZE,
                       seed=40 + ctx.rank)
    model = spec.build(dtype=torch.bfloat16, num_classes=1000, seed=0,
                       device=ctx.device)
    stats0 = {k: b.clone() for k, b in model.named_buffers()}
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, fd, pfd)
    res, step_s, fit_s, flops_local = resnet_fit(
        torch, spec, model, wire, RESNET_WARMUP + RESNET_TIMED)
    launches = read_counts(fa, fd, pfd)
    summary = res["meter"].summary()  # its rates run to this call
    losses = [h["loss"] for h in res["history"]]
    moved = sum(not torch.equal(b, stats0[k])
                for k, b in model.named_buffers())
    line = step_line(step_s, RESNET_WARMUP)
    ms = line["step_ms_median"]
    flops = flops_local * ctx.size  # the gang's step
    step_fn = ctx.make_train_step(
        bn_classifier_loss(preprocess=resnet_preprocess(spec)),
        mutable=True)
    st = res["state"]
    batch = {k: torch.as_tensor(v).to(ctx.device)
             for k, v in wire[0].items()}
    prof = device_profile(
        torch, lambda: step_fn(st, batch), 3,
        f"3 ResNet-50 gang train steps, bf16, {local} a rank", match="nccl")
    nccl_us = sum(k["us"] for k in prof.get("matched_kernels", []))
    busy = prof["device_busy_ms_per_step"]
    rec = dict(
        world_size=ctx.size, rank=ctx.rank, backend=ctx.gang.backend,
        device=str(ctx.device), batch_global=local * ctx.size,
        batch_per_rank=local, steps=len(losses),
        warmup_steps=RESNET_WARMUP, **line,
        images_per_s_per_chip=local / ms * 1e3,
        images_per_s=local * ctx.size / ms * 1e3,
        flops_per_step=flops,
        mfu=flops / (ms / 1e3) / (PEAK_FLOPS["bfloat16"] * ctx.size),
        meter_mfu=summary["mfu"],
        meter_images_per_s_per_chip=summary["examples_per_sec_per_chip"],
        meter_n_chips=summary["n_chips"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        losses=losses, statistics_moved=moved, statistics=len(stats0),
        batchnorm_layers=n_bn,
        collectives_issued_per_step=2 * n_bn + 1,
        launches=launches, fit_s=fit_s, profile=prof,
        nccl_kernels_seen=len(prof.get("matched_kernels", [])),
        nccl_device_ms_per_step=nccl_us / 3 / 1e3,
        nccl_share_of_busy=(nccl_us / 3 / 1e3 / busy
                            if isinstance(busy, float) else "not measured"))
    del res, st, model, step_fn, batch
    torch.cuda.empty_cache()
    # dp_parity: phase k's parity model and shape, f32, from its seed
    pspec = get_model("ResNet18")
    pwire = resnet_wire(1, RESNET_PARITY_BATCH, 32, seed=41)[0]
    ploss = bn_classifier_loss(preprocess=resnet_preprocess(pspec))
    parity = {}
    for arm, kw in (("gang", {}), ("gang_remat", {"remat": True})):
        m = pspec.build(num_classes=10, seed=0, device=ctx.device)
        ctx.put_replicated(m)
        ctx.make_train_step(ploss, mutable=True, **kw)(
            TrainState.create(m, sgd(0.01, momentum=0.9)),
            ctx.shard_batch(pwire))
        parity[arm] = {k: v.detach().cpu() for k, v in
                       m.state_dict().items()}
    torch.save(parity, Path(out_dir) / "dp_parity.pt")
    (Path(out_dir) / "dp_worker.json").write_text(json.dumps(rec))
    leave_gang()
    return 0


def image_train(torch, kernels, name: str) -> dict:
    """Phase l, ``inception_train`` / ``xception_train``: ``name`` at
    299, bf16 compute, IMAGE_TRAIN_STEPS mutable SGD steps of
    IMAGE_TRAIN_BATCH through ``XlaRunner(np=1).fit(mutable=True)``; the
    losses finite, every BatchNorm statistic moved, no Pallas kernel's
    port launched."""
    import gc

    from sparkdl_tpu_torch.models.registry import get_model
    from sparkdl_tpu_torch.runner import XlaRunner, bn_classifier_loss, sgd

    gc.collect()
    torch.cuda.empty_cache()
    spec = get_model(name)
    model = spec.build(dtype=torch.bfloat16, num_classes=1000, seed=0,
                       device="cuda")
    stats0 = {k: b.clone() for k, b in model.named_buffers()}
    wire = resnet_wire(IMAGE_TRAIN_STEPS, IMAGE_TRAIN_BATCH, 299, seed=44)
    flops = 3 * image_flops(torch, model, 299, 299) * IMAGE_TRAIN_BATCH
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    res = XlaRunner(np=1).run(lambda ctx: ctx.fit(
        loss_fn=bn_classifier_loss(preprocess=resnet_preprocess(spec)),
        model=model, tx=sgd(IMAGE_TRAIN_LR, momentum=0.9), data=wire,
        num_steps=IMAGE_TRAIN_STEPS, log_every=1, mutable=True,
        flops_per_step=flops))
    launches = read_counts(*kernels)
    losses = [h["loss"] for h in res["history"]]
    moved = sum(not torch.equal(b, stats0[k])
                for k, b in model.named_buffers())
    summary = res["meter"].summary()
    ms = summary["step_time"]["p50_s"] * 1e3
    momenta = sorted({m.momentum for m in model.modules()
                      if hasattr(m, "running_var")})
    rec = dict(phase=f"{name.lower().removesuffix('v3')}_train", model=name,
               compute_dtype="bfloat16", param_dtype="float32",
               image_size=299, classes=1000, batch=IMAGE_TRAIN_BATCH,
               steps=len(losses), warmup_steps=1,
               optimizer=f"sgd({IMAGE_TRAIN_LR}, momentum=0.9)",
               bn_momentum=momenta, step_ms_p50=ms,
               images_per_s=IMAGE_TRAIN_BATCH / ms * 1e3,
               flops_per_step=flops, meter_mfu=summary["mfu"],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses, statistics_moved=moved,
               statistics=len(stats0), launches=launches, nvidia_smi=smi())
    emit(rec)
    assert not any(launches.values()), launches
    assert len(losses) == IMAGE_TRAIN_STEPS and all(
        math.isfinite(x) for x in losses), rec
    assert moved == len(stats0), rec
    del res, model
    return rec


def phase_dp(torch, kernels, resnet_arms: list) -> dict:
    """Phase l (module docstring): the one-rank NCCL gang against phase
    k's in-process arms, its parity, the refusal of a second rank on one
    card, and InceptionV3 / Xception in train mode."""
    import gc
    import tempfile

    from sparkdl_tpu_torch.models.registry import get_model
    from sparkdl_tpu_torch.runner import (TrainState, XlaRunner,
                                          bn_classifier_loss, launcher, sgd)
    from sparkdl_tpu_torch.runner.train_state import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the parent hands the card to its worker: nothing cached held back
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="sparkdl_dp_") as d:
        t0 = time.perf_counter()
        launcher.launch(str(ROOT / "chip_smoke.py"), np=1,
                        args=["--dp-worker", d], timeout_s=DP_TIMEOUT_S,
                        capture=True)
        gang_wall_s = time.perf_counter() - t0
        w = json.loads((Path(d) / "dp_worker.json").read_text())
        parity = torch.load(Path(d) / "dp_parity.pt")
    inline = [r for r in resnet_arms if r.get("phase") == "resnet_train"
              and r["compute_dtype"] == "bfloat16"
              and not r["feed_lookahead"]]
    rec = dict(phase="dp_gang", config="BASELINE config 3, np=1 gang",
               model="ResNet50", compute_dtype="bfloat16",
               param_dtype="float32", tf32=False, image_size=RESNET_SIZE,
               classes=1000, optimizer=f"sgd({RESNET_LR}, momentum=0.9)",
               step="implicit (synchronised BatchNorm, one gradient "
                    "all-reduce)",
               **w, gang_wall_s=gang_wall_s,
               in_process_arms=[dict(arm=r["arm"],
                                     step_ms_median=r["step_ms_median"],
                                     step_ms_p10=r["step_ms_p10"],
                                     step_ms_p90=r["step_ms_p90"],
                                     images_per_s=r["images_per_s"],
                                     mfu=r["mfu"]) for r in inline],
               nvidia_smi=smi())
    emit(rec)
    assert w["backend"] == "nccl" and w["world_size"] == 1, w
    assert all(math.isfinite(x) for x in w["losses"]), w["losses"]
    assert sum(w["losses"][-5:]) < sum(w["losses"][:5]), w["losses"]
    assert w["statistics_moved"] == w["statistics"], w
    assert not any(w["launches"].values()), w["launches"]  # no Pallas here

    # dp_parity: the same model, seed and batch, in this process
    spec = get_model("ResNet18")
    wire = resnet_wire(1, RESNET_PARITY_BATCH, 32, seed=41)[0]
    m = spec.build(num_classes=10, seed=0, device="cuda")
    before = {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
    make_train_step(bn_classifier_loss(preprocess=resnet_preprocess(spec)),
                    mutable=True)(
        TrainState.create(m, sgd(0.01, momentum=0.9)),
        {k: torch.as_tensor(v).cuda() for k, v in wire.items()})
    want = {k: v.detach().cpu() for k, v in m.state_dict().items()}
    p_share, s_share = _update_shares(parity["gang"], want, before)
    # the statistics come from the step's one forward, remat or not (the
    # parameters came out different in the last bits on the card, so
    # only the statistics are compared here)
    remat_equal = all(torch.equal(v, parity["gang_remat"][k])
                      for k, v in parity["gang"].items() if "running" in k)
    prec = dict(phase="dp_parity", model="ResNet18", classes=10,
                image_size=32, batch=RESNET_PARITY_BATCH, dtype="float32",
                tf32=False, optimizer="sgd(0.01, momentum=0.9)",
                against="phase k's in-process make_train_step(mutable=True)",
                param_share=p_share, stat_share=s_share,
                param_share_tol=RESNET_PARITY_PARAM_SHARE,
                stat_share_tol=RESNET_PARITY_STAT_SHARE,
                remat_stats_bitwise_equal=remat_equal, nvidia_smi=smi())
    emit(prec)
    assert p_share <= RESNET_PARITY_PARAM_SHARE, prec
    assert s_share <= RESNET_PARITY_STAT_SHARE, prec
    assert remat_equal, prec

    # dp_refuses: a second rank on this card is refused before NCCL
    visible = torch.cuda.device_count()
    try:
        XlaRunner(np=visible + 1, coordinator=f"127.0.0.1:"
                  f"{launcher.free_port()}", num_processes=visible + 1,
                  process_id=0)
        err = None
    except ValueError as e:
        err = str(e)
    import torch.distributed as dist
    rrec = dict(phase="dp_refuses", np=visible + 1, visible_devices=visible,
                raised="ValueError" if err else None, message=err,
                process_group_made=dist.is_initialized(), nvidia_smi=smi())
    emit(rrec)
    assert err and "exceeds visible devices" in err, rrec
    assert not rrec["process_group_made"], rrec

    images = [image_train(torch, kernels, "InceptionV3"),
              image_train(torch, kernels, "Xception")]
    return dict(gang=rec, parity=prec, refuses=rrec, images=images)


def bert_case(r: dict) -> dict:
    """The ``kernels`` line's summary of a phase-b BERT case."""
    keys = ("case", "variant", "dtype", "shape", "causal", "max_abs_err",
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "fwd_bwd_ms", "library_fwd_bwd_ms",
            "dead_k_tiles_dk_dv_exactly_zero")
    return {k: r[k] for k in keys if k in r}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "sparkdl_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no sparkdl_tpu_torch/ package; run "
              f"it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(sys.argv[2])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sparkdl_tpu_torch.ops import _build
    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.ops import flash_decode as fd
    from sparkdl_tpu_torch.ops import paged_flash_decode as pfd

    phase_build(_build)
    main_recs = phase_kernels(torch, fa, fd, pfd)
    mp = phase_main(torch, fa, fd)
    phase_parity(torch)
    legs = phase_serve(torch, (fa, fd, pfd))
    phase_serve_parity(torch, (fa, fd, pfd))
    train = phase_train(torch, (fa, fd, pfd))
    phase_train_parity(torch)
    glue, bert = phase_glue(torch, (fa, fd, pfd))
    phase_glue_parity(torch, (fa, fd, pfd))
    phase_classify(torch, (fa, fd, pfd), bert)
    del bert
    torch.cuda.empty_cache()
    phase_images(torch)
    resnet = phase_resnet(torch, (fa, fd, pfd))
    phase_dp(torch, (fa, fd, pfd), resnet["train"])

    # each kernel's launches come from the main path that runs it:
    # generate() (phase c) for the first two, the paged serve leg for B3
    sources = {
        "flash_attention": ("sparkdl_tpu_torch/csrc/flash_attention_tc.cu",
                            "sparkdl_tpu/ops/flash_attention.py:50",
                            mp["launches"]),
        "flash_decode": ("sparkdl_tpu_torch/csrc/flash_decode.cu",
                         "sparkdl_tpu/ops/flash_decode.py:62",
                         mp["launches"]),
        "paged_flash_decode": (
            "sparkdl_tpu_torch/csrc/paged_flash_decode.cu",
            "sparkdl_tpu/ops/paged_flash_decode.py:63",
            legs["paged"]["launches"]),
    }
    kernels = []
    for name, (src, replaces, counts) in sources.items():
        r = main_recs[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts[name], max_abs_err=r["max_abs_err"],
            tol=r["tol"], rtol=r["rtol"], case=r["case"], dtype=r["dtype"],
            ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
        if name != "flash_attention":  # the split-KV decode kernels
            kernels[-1].update(
                chunk=r["chunk"], n_splits=r["n_splits"],
                rows_per_block=r["rows_per_block"],
                live_blocks=r["live_blocks"], grid_blocks=r["grid_blocks"],
                profiler_ms=r["profiler_ms"],
                ms_read_flush=r["ms_read_flush"], fixed_ms=r["fixed_ms"],
                event_floor_ms=main_recs["event_floor_ms"])
        if name == "flash_attention":  # bf16 on the main path; f32 beside
            f32 = main_recs["flash_attention_f32"]
            kernels[-1].update(
                bert_case=bert_case(main_recs["flash_attention_bert"]),
                bert_launches=glue["launches"]["flash_attention"],
                bert_launches_per_step=glue["launches_per_step"][
                    "flash_attention"])
            kernels[-1].update(
                variant=r["variant"], pv_rtol=r["pv_rtol"],
                live_tflops=r["live_tflops"],
                tile_pairs_walked=r["tile_pairs_walked"],
                f32_variant=dict(variant=f32["variant"],
                                 source="sparkdl_tpu_torch/csrc/"
                                        "flash_attention.cu",
                                 ms=f32["ms"], bound_ms=f32["bound_ms"],
                                 library_ms=f32["library_ms"],
                                 max_abs_err=f32["max_abs_err"]))
    r, f32 = (main_recs["flash_attention_bwd"],
              main_recs["flash_attention_bwd_f32"])
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="sparkdl_tpu_torch/csrc/flash_attention_bwd_tc.cu",
        replaces="sparkdl_tpu/ops/flash_attention.py:186 (_bwd_one_head; "
                 "plain JAX under custom_vjp, not a pl.pallas_call)",
        launches=train["launches"]["flash_attention_bwd"],
        max_abs_err=r["max_abs_err"], tol=r["tol"], rtol=r["rtol"],
        tol_rule=r["tol_rule"], case=r["case"], dtype=r["dtype"],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        variant=r["variant"], tflops=r["tflops"],
        tflops_issued=r["tflops_issued"],
        bwd_variant_launches=train["bwd_variant_launches"],
        bert_case=bert_case(main_recs["flash_attention_bwd_bert"]),
        bert_launches=glue["launches"]["flash_attention_bwd"],
        bert_launches_per_step=glue["launches_per_step"][
            "flash_attention_bwd"],
        bert_variant_launches=glue["bwd_variant_launches"],
        f32_variant=dict(variant=f32["variant"], route="cuda",
                         source="sparkdl_tpu_torch/csrc/"
                                "flash_attention_bwd.cu",
                         ms=f32["ms"], bound_ms=f32["bound_ms"],
                         bound_by=f32["bound_by"], plain_ms=f32["plain_ms"],
                         library_ms=f32["library_ms"],
                         max_abs_err=f32["max_abs_err"])))
    # the card path reads no DataFrame: nothing imported pyarrow or pandas
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("pyarrow", "pandas")]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
