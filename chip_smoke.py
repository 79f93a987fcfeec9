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
   the backward alone of SDPA under autograd on the same inputs, with the
   backend SDPA picked for them (``library_backend``), the torch, CUDA
   and cuDNN versions, and the backward with the forward pinned to each
   backend in turn (``library_pinned_ms``; a refused backend's reason).
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
   pools with scales; and the same pools at llama3_8b's 32:8 layout
   (phase n's, 4 query rows a KV head), S = 1 and S = 5, bf16 and f32.
   Its SDPA yardstick runs on the pre-gathered dense view and so
   excludes the gather.
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
   seeded 2 x 2048 batch, ``log_every=1``, no ``flops_per_step`` under
   ``SPARKDL_MFU_ESTIMATE=1`` (the fit counts its first step's FLOPs,
   the flash kernels reporting theirs). One ``train`` line: step ms
   (median after the first step), tokens/s, MFU from ``train_flops``
   against the bf16 peak, the meter's MFU from the count, the count
   beside ``train_flops`` (``estimate_fields``: their ratio, the
   counting step's wall time, and the residual once the formula's work
   the step does not do is taken off, which must be 0: layer 0's q, k
   and v take no input gradient), peak device memory, the losses; the launch
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
   labels from a learnable rule on the first token; no
   ``flops_per_step``, under ``SPARKDL_MFU_ESTIMATE=1``. One ``glue``
   line: step ms (median after the first step), examples/s, live
   tokens/s, MFU (``glue_flops``; its formula printed beside it), the
   count of the first step beside ``glue_flops`` of its batch (residual
   0 once the pooler and classifier are counted on the B [CLS] rows),
   the same step counted on the CPU (f32, flash's plain versions, the
   fit's first weights), which must equal the card's, peak memory, the
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
     backward = 3 × ``image_flops`` a row, peak memory (arm 0 runs
     under ``SPARKDL_MFU_ESTIMATE=1`` with no ``flops_per_step``: its
     count beside the formula, residual 0 once the stem's input gradient
     is taken off and the head the formula leaves out is added); the
     losses finite
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

m. BASELINE configs 4 and 5 over a gang, and the numeric scoring runner:
   ``launcher.launch(np=1)`` starts this script again as the worker
   (``chip_smoke.py --dp-m-worker <dir>``), which joins a one-rank NCCL
   gang through ``XlaRunner()`` and runs, one after the other:
   - ``dp_bert``: phase h's model and recipe at full width and depth
     (``BertConfig.base()``, bf16 compute, seeded weights, batch 32,
     length 128, Adam 3e-5, ``bert_finetune_loss``, the flash kernels by
     ``"auto"``) through ``fit(with_rng=True)``: the gang's implicit step,
     whose dropout draws the rank's rows of the global batch's masks
     (``utils.rng.RowWindow``; at one rank every row), DP_BERT_WARMUP +
     DP_BERT_TIMED steps over phase h's first batches. The line: step ms
     (median, p10/p90, each from a loss call to the next), examples/s/chip,
     MFU (``glue_flops``), peak memory, the gang's wall time, the flash
     forward and backward launches (set to 0 just before the fit and read
     just after: 12 and 12 a step), the losses, which must equal phase
     h's in-process losses of the same steps to the bit (phase h's own
     ``with_rng`` repeat is bitwise), and the dropout sites of one
     forward with the random numbers they draw (counted through
     ``models.bert.uniform``) and what a rank draws a step at np 1, 2, 4
     and 8 (the global batch's, ``dropout_draw_gb_per_rank``, f32);
   - ``dp_bert_accum``: the same gang and model with ``accum_steps=2``
     for 2 steps: losses finite, no refusal, 24 + 24 flash launches;
   - ``dp_lora``: ``LlamaConfig.llama3_8b(lora_rank=16)`` at full width
     (4096 hidden, 32/8 heads, head_dim 128, FFN 14336, vocab 128256),
     **depth cut to DP_LORA_LAYERS layers** (to keep the script's time),
     bf16, seeded weights, phase g's 2 x 2048 batch, ``lora_optimizer``,
     DP_LORA_STEPS steps: step ms, tokens/s, MFU (``train_flops``), peak
     memory, the flash launches (one a layer a step each way), the bytes
     ``put_replicated`` broadcasts (and at the full 32 layers, from the
     model's own per-layer bytes) and the seconds of one call at one
     rank. After the worker exits, the same fit in this process from the
     same seed: the losses held to DP_LORA_LOSS_RTOL (and reported
     bitwise or not).
   Then ``xla_transformer``: ``XlaTransformer(fn=...)._get_runner()`` on
   the card (no DataFrame, no pyarrow) over XLA_ROWS seeded numeric rows
   of XLA_WIDTH in batches of XLA_BATCH, ``fn`` a bf16 dense layer and an
   exact GELU: rows/s, and the output against the same runner on the CPU
   within 2^-6·(1 + |CPU|) (a bf16 product may round one step apart, and
   GELU's slope is at most 1.13).

n. int8 projection weights, the registry draft and the tokenizer:
   - ``int8_weights``: ``LlamaConfig.llama3_8b()`` at full width and
     depth (32 layers), bf16 compute, seeded weights; a bf16-weight leg,
     then ``GenerationEngine.from_model(model, weight_dtype="int8",
     block_size=16, prefill_chunk=256, stall_free=False)``, which
     quantizes the same model in place. Each leg: 8 slots, 8 seeded
     prompts of 64–1536 tokens, INT8_NEW new tokens each, the paged
     blocking refill (the paged prefill that runs flash_attention; a
     chunked prefill attends densely). Each line: new tokens/s, TTFT
     p50/p95, decode-iteration ms, graph captures and replays, peak
     memory, the projections' bytes (codes + scales against bf16), the
     card's name and power limit, and the launches (set to 0 just before
     the leg, read just after): flash_attention == 32 × prefills,
     paged_flash_decode == 32 × steps, flash_decode 0. Then a summary
     line of the two legs side by side;
   - ``int8_parity``: llama_small widths at depth INT8_PARITY_LAYERS,
     f32, TF32 off, int8 codes, a one-slot paged engine: its decode
     steps' logits within LOGIT_TOL of the int8 model's dense in-model
     path fed the engine's tokens, and its greedy stream equal to dense's
     argmax wherever the top-2 gap exceeds 10 × LOGIT_TOL;
   - ``draft_registry``: llama_small (bf16, seeded) served with
     ``spec_k=4`` and ``DraftModelProvider.from_registry("llama_small")``
     (llama_tiny, seeded, dense attention: the kernels do not take its
     head dim 32); the target's ``lm_head`` rows past the draft's 512
     ids are zeroed and the prompts drawn below 512, so the draft can
     read the stream. ``spec_verifies`` >= 1, paged_flash_decode == 16
     × steps; accepted draft tokens reported;
   - ``tokenizer``: a ``ByteBPETokenizer`` trained here on README.md
     (vocab TOKENIZER_VOCAB), TOKENIZER_ROWS prompts from it encoded
     (``decode(encode(s)) == s`` for each), run through
     ``udf.generate_rows`` — the per-chunk step of
     ``registerTextGenerationUDF``, no DataFrame — on llama_small, bf16,
     in chunks of TOKENIZER_CHUNK, TOKENIZER_NEW new tokens, then decoded:
     rows/s, tokenizer ms against device ms, flash_attention == 16 a
     chunk and flash_decode == 16 a step.

o. The serving fleet (``serving.router.EngineFleet``), after phase n has
   freed its model: ``LlamaConfig.llama3_8b()`` at full width and depth,
   bf16, seeded weights, one model under FLEET_REPLICAS paged replicas
   (``from_model`` copies nothing), each FLEET_SLOTS slots of
   FLEET_MAX_LEN, pool blocks of 16, the radix prefix cache. Traffic:
   FLEET_FAMILIES prefix families of FLEET_FAMILY_SIZE requests, each on
   its own FLEET_HEAD-token head, tails drawn from seed 15 (prompts
   576–1536), FLEET_NEW new tokens each, greedy, all submitted at once.
   One ``{"phase": "fleet"}`` line a leg: new tokens/s, TTFT p50/p95,
   decode-iteration ms a replica, placements a replica, fleet-wide prefix
   reuse (the requests' ``prefill_reused`` and the replicas'
   ``prefix_stats()``), peak memory, graphs, the health transitions, the
   card's name and power limit, and the launches (set to 0 just before
   the leg, read just after):
   - ``fleet_radix``: inline (``fleet.step()`` to idle), the blocking
     refill (``stall_free=False``: the paged prefill that runs
     flash_attention); flash_attention == 32 × prefills,
     paged_flash_decode == 32 × decode steps summed over the replicas,
     flash_decode 0;
   - ``fleet_radix_chunked`` and ``fleet_round_robin``: the same traffic
     through the chunked prefill (the blocking refill never radix-shares:
     its left-padded rows are not block-aligned, in the reference too),
     radix then round-robin routing; radix's reused tokens must exceed
     round-robin's;
   - ``fleet_failover``: the blocking radix fleet; the last request is
     held back, and after FLEET_KILL_AFTER steps its routing decision
     kills uncleanly (chaos ``replica_dead`` at ``fleet_route``) the
     replica it would choose, which is streaming; FLEET_DOOM_AFTER steps
     later ``doom_replica`` drains the busiest survivor. ``recovery_s``
     (the kill to the first re-admitted token), re-admissions, drains and
     deaths; the exactly-once audit (each request's streamed tokens equal
     its ``tokens``, ``delivered`` their count); each stream against a
     clean single engine's, equal up to the first position whose top-2
     gap lies within 10 × BF16_LOGIT_RTOL × (1 + max |logit|), with the
     positions compared and excused; the launches as ``fleet_radix``;
   - ``fleet_threaded``: the blocking radix fleet driven by
     ``fleet.start()`` / ``stop(drain=True)`` (three engine threads and
     the supervisor's on one card) with ``telemetry.start(port=0)`` and
     ``SPARKDL_SLO_TTFT_S`` set; ``/metrics`` (the ``fleet_*`` metrics),
     ``/metrics.json`` (every request's trace, its stages summing to its
     latency within 5 %, and the ``slo`` block), ``/serving`` (one fleet
     of three replicas) and ``/healthz`` scraped over HTTP; its tokens/s
     and plane-on iteration ms beside ``fleet_radix``'s; one capture and
     steps − 1 replays a replica, the launches as ``fleet_radix``. Then
     the same at a FLEET_SWITCH_S thread switch interval
     (``fleet_threaded_switch_0.5ms``): whether the threads, each back
     from the card, queue for the interpreter lock;
   - ``fleet_parity``: llama_small widths at depth FLEET_PARITY_LAYERS,
     f32, TF32 off, ``fleet_failover``'s fleet, kill and doom: every
     stream token for token a clean single engine's.

p. The flight recorder and data plane (``runner/events.py``,
   ``runner/data.py``'s batch ledger, ``runner/metrics.py``'s heartbeat and
   profiler helpers, ``runner/chaos.py``), armed through the env knobs
   ``SPARKDL_EVENT_DIR``, ``SPARKDL_BATCH_LEDGER``,
   ``SPARKDL_HEARTBEAT_DIR`` and ``SPARKDL_METRICS_DIR`` (a ``tempfile``
   directory each), two ``{"phase": "flight_recorder"}`` lines:
   - ``resnet_chaos``: BASELINE config 3, phase k's bf16 ResNet-50 at
     full width and depth, 256 a batch at 224², FR_BATCHES seeded wire
     batches as a looping ``ListDataset``. First FR_OVERHEAD_ARMS fits of
     FR_BATCHES steps, everything off and on in turn: step ms (median of
     the steps after the first), events and bytes streamed a step, the
     losses bitwise equal in every arm. Then, under one directory:
     a. ``XlaRunner(checkpoint_dir=).run_with_restarts(fit)`` with
        ``checkpoint_every=FR_CKPT_EVERY`` and a chaos ``step_start
        preempt`` at FR_PREEMPT_AT: one restart, the resume at step 4,
        the ledger exactly once over steps 0–11 (the replayed steps 4–5
        on the same batches), the final parameters within phase k's
        shares of an uninterrupted fit's; restart to the first resumed
        step (the ``restart`` event to the loss call after that step's
        read), the restore and first-step times behind it;
     b. the newest checkpoint corrupted (``chaos.corrupt_latest_checkpoint``),
        a fit to FR_ROLLBACK_STEPS: one rollback (12 → 8), in the meter's
        ``fault_tolerance``; the rollback restore's seconds (verify,
        quarantine, verify, load);
     c. a chaos ``batch_fetch nan`` at FR_NAN_AT on float32 images:
        ``TrainingDivergedError``, not retried, and a postmortem naming
        step 2 and batch 2;
     then ``merge_timeline`` must name part c's fault first,
     ``collect_degradations`` the two resumes and the rollback, the
     telemetry snapshot must be on disk and the heartbeat name step 2;
   - ``lora_recorder``: BASELINE config 5, ``llama3_8b(lora_rank=16)`` at
     full width, depth cut to DP_LORA_LAYERS, bf16, phase g's 2 × 2048
     batch; three fits of FR_LORA_STEPS steps (everything off; the
     recorder, ledger and heartbeat on; on with ``fit(profile_dir=)``):
     losses bitwise equal, step ms off and on, launches a step from the
     wrappers' counters, and from the Chrome trace one ``train_step#i``
     range a step holding DP_LORA_LAYERS forward and backward flash
     kernels, its size and the device's busy share of the profiled steps.
   A ``summary`` line: the phase's seconds and the memory allocated on
   the card before and after it, which must come back to what it was.

q. The gang supervisor (``runner/launcher.py::supervise``): each arm a
   one-rank NCCL gang of this script as its worker (``chip_smoke.py
   --sup-worker <dir> <arm>``) under ``launcher.supervise(...,
   capture=True)`` with a chaos ``FaultPlan``, ``max_restarts=1``,
   ``poll_s=SUP_POLL_S``; the parent frees its cached memory before each
   gang and only supervises (its launcher imports no torch). The worker
   joins through ``XlaRunner(checkpoint_dir=)`` and runs ``fit(resume=True,
   log_every=1)``; a tee on its flight recorder writes the times of its
   start-up, the restore and each loss call, and at the chaos event the
   fault's time (and the wrappers' counts) before the fault acts. One
   ``{"phase": "supervise"}`` line an arm:
   - ``sup_resnet_kill``: BASELINE config 3, phase p's bf16 ResNet-50 at
     full width and depth, 256 a batch at 224², SUP_RESNET_STEPS seeded
     wire batches (made once, in ``wire.npz``), ``checkpoint_every=
     SUP_RESNET_CKPT_EVERY``, cuDNN deterministic; a ``step_start
     sigkill`` at SUP_RESNET_FAULT_AT. ``detect_s`` (the kill to the
     supervisor's failure record), the relaunch to the first resumed step
     in a new process split into interpreter and ``import torch``, the
     CUDA context, NCCL's communicator, the model's build, the restore
     and the first step; the resume at the newest manifest committed
     when the kill struck; the batch ledger exactly once over the steps,
     the replayed steps named; the final parameters and BatchNorm
     statistics **bitwise** those of a clean ``launch`` of the same
     worker;
   - ``sup_resnet_hang``: the same worker with a ``hang`` at
     SUP_RESNET_FAULT_AT under ``watchdog_s=SUP_WATCHDOG_S``: the beat's
     age when the watchdog tripped (at most ``watchdog_s`` + 2 polls),
     the step the ``GangFailure`` names, the gang timeline's first
     failure and that the gang postmortem was written; then the relaunch
     and the same bitwise check;
   - ``sup_bert_kill``: BASELINE config 4, phase h's BERT-base at full
     width and depth, 32 × 128, ``fit(with_rng=True)`` for SUP_BERT_STEPS
     steps, ``checkpoint_every=SUP_BERT_CKPT_EVERY``, a ``sigkill`` at
     SUP_BERT_KILL_AT: the flash forward and backward launches of each
     attempt and of a clean run (12 a step each; the killed attempt's
     read at the kill), the kernel library's load time in each process
     (no ``nvcc`` after phase a), the relaunch split, and the resumed
     losses **bitwise** the clean gang's.
   The clean runs (a ``launch`` of each worker with no plan) go first,
   both at once. Elastic resizing is not shown on one card (NCCL refuses
   two ranks on it): it is held on the CPU with gloo
   (``tests/test_torch_supervise*``).
   The ResNet arms keep their heartbeats in their own directory, and
   ``sup_resnet_kill`` streams the telemetry plane's snapshots
   (``SPARKDL_METRICS_DIR``) beside its events: phase r reads all three.
   A ``summary`` line gives the phase's seconds.
r. Imported weights, and the offline reports (``models/pretrained.py``,
   ``runner/analysis.py``, ``runner/traceview.py``, the three
   ``scripts/torch_*.py``). Four legs, a line each:
   - ``import_llama3_8b``: BASELINE config 5's model,
     ``LlamaConfig.llama3_8b()`` at full width, **depth cut to
     IMPORT_LAYERS of 32**, f32 weights from a seed rounded to bf16
     values (a published file holds bf16); ``hf_llama_state`` writes them
     as an HF-named bf16 safetensors file (the inverse of the importer's
     name map and rope row permutation), ``import_hf_llama`` reads it and
     ``load_flax_params`` fills a fresh model: every parameter equal
     (max |Δ| 0). The file's bytes, the write, read and load seconds and
     the host's peak resident set. Then both models, cast to bf16 on the
     card, each serve IMPORT_REQUESTS prompts of 64–1536 tokens,
     IMPORT_NEW new tokens each, through one paged engine of 8 slots
     (phase n's blocking refill): the streams identical token for token,
     flash_attention once a layer a prefill and paged_flash_decode once a
     layer a step. The imported run streams its spans into an event dir
     with the telemetry plane's snapshots beside it;
   - ``import_bert_base``: BASELINE config 4's ``BertConfig.base()`` with
     2 classes, the same round trip through ``import_hf_bert``, then
     ``classify_rows`` over IMPORT_BERT_ROWS rows of up to
     IMPORT_BERT_SEQ tokens with each model: logits bitwise, flash
     launches once a layer;
   - ``keras_resnet50_h5``: where h5py imports, a keras-applications
     ``.h5`` of a seeded ResNet50 (``keras_resnet50_h5``) read by
     ``DeepImageFeaturizer(weightsPath=)`` on the card and on the CPU
     over IMPORT_IMAGES images, held to phase j's f32 rule; where it does
     not, the line says ``"ran": false`` and names h5py;
   - ``offline_trace`` / ``offline_requests``: the three scripts as
     subprocesses started together, as a user runs them, beside a bare
     ``import torch``: ``torch_trace_export.py --validate
     --require-ranks 1`` over ``sup_resnet_kill``'s directories must exit
     0 with the supervisor's two ``gang_attempt`` spans, every rank span
     carrying the manifest's ``trace_id`` and the clock skew measured
     from the heartbeats; ``torch_bottleneck_report.py --json`` over the
     same; ``torch_request_report.py --json`` over the llama run must
     count IMPORT_REQUESTS completed with every trace's unattributed
     share at most OFFLINE_UNATTR_MAX. Each script's wall seconds, the
     trace's bytes and event counts.
   A ``summary`` line gives the phase's seconds against PHASE_R_BUDGET_S.
s. graph — the graph toolkit over ``torch.export`` and the Keras path:
   - ``graph_resnet50``: ``GraphFunction.fromList([buildSpImageConverter
     ("BGR"), GraphFunction.fromModule(ResNet50, features_only=True),
     buildFlattener()])`` on the card (BASELINE config 2's model at
     224x224, f32, seeded) over GRAPH_ROWS seeded uint8 images in
     batches of GRAPH_BATCH, held to GRAPH_RULE against the direct
     module call on the same converted batches, its captured step
     (``jit``), its ``.pt2`` (``dump`` with a free batch, ``load`` on the
     card) at batches GRAPH_BATCH and GRAPH_TAIL, the UDF
     ``makeGraphUDF`` registers (its device step: this script reads no
     DataFrame) and an ``imageInputPlaceholder`` → ``IsolatedSession`` →
     ``asGraphFunction`` assembly; rows/s of each beside
     ``DeepImageFeaturizer(modelName="ResNet50")``'s runner on the same
     rows, the ``.pt2``'s bytes, export and load seconds;
   - ``keras``: where keras and pyarrow import, a subprocess
     (``--keras-leg``) fits a seeded small CNN ``.keras`` with
     ``KerasImageFileEstimator`` for 2 sgd steps on PNGs it writes, on
     the card, and scores with the returned ``KerasImageFileTransformer``
     on the card and the CPU (IMAGE_F32_RULE); where either does not
     import, the line says ``"ran": false`` and names it.
   A ``summary`` line gives the phase's seconds against PHASE_S_BUDGET_S.
t. parallel — sequence parallelism over a one-rank NCCL gang (one card:
   NCCL refuses two ranks of one communicator on it), joined through
   ``XlaRunner(coordinator=, num_processes=1, process_id=0)`` with
   ``make_mesh({"sp": 1})``:
   - ``ulysses_flash``: ``ulysses_attention(local_attn="auto")`` at
     llama3_8b's attention shape (ULYSSES_SHAPE, causal, bf16), forward
     and gradient, bitwise to the bare flash kernel's call (the one-rank
     all-to-alls are copies); at ULYSSES_CHECK_S held to the plain
     version (phase b's rules); ms beside the bare call's, forward and
     forward + backward, SDPA's and the bound;
   - ``ring_generate``: llama3_8b widths, depth cut to RING_LAYERS,
     bf16, seeded; RING_PROMPTS prompts of RING_LEN tokens, RING_NEW new
     tokens through ``generate()`` with dense attention, the flash kernel
     and ``partial(ring_attention, mesh=..., axis="sp")``: each arm's
     prefill ms, peak memory and launches; the ring's last prefill
     logits within RING_LOGIT_SHARE of the flash arm's (their shares
     against dense reported); each arm's streams fed to the dense model (phase n's
     top-2-gap rule): a token other than its argmax only where the
     top-2 gap lies within 10 × BF16_LOGIT_RTOL × (1 + max |logit|);
   - ``examples``: ``examples/torch_long_context_serving.py`` and
     ``torch_distributed_training.py`` under ``python -m
     sparkdl_tpu_torch.runner.launcher --np 1`` (one-rank NCCL gangs),
     started together at their default sizes: exit 0 and their marker
     lines, seconds each; the two DataFrame twins only where pyarrow and
     pandas import (else ``"ran": false`` naming what is missing).
   A ``summary`` line gives the phase's seconds against PHASE_T_BUDGET_S.
u. Tensor-parallel serving, on a one-rank NCCL gang joined as phase t's,
   with ``serving.backend.tp_mesh(1)`` (a ``{"tp": 1}`` mesh):
   - ``tp_shards``: ``flash_decode`` at phase b's main-path first-decode
     shape and at llama3_8b's 32:8 heads, ``paged_flash_decode`` at 32:8
     with S = 1 and S = 5 over bf16 and int8 pools (scale planes): for
     tp in TP_DEGREES and each rank r, the kernel on r's head shard,
     taken by ``parallel.local_heads`` (what ``head_sharded_kernel``
     runs), bitwise the full launch's heads, within phase b's TOL of the
     plain version on the shard, and its block counter the plan's
     (``split_blocks`` at Hkv/tp); the shard's ms beside the full
     launch's;
   - ``tp_collectives``: one eager ``all_reduce`` (a decode step's hidden
     state) and one logits ``all_gather`` (a prefill chunk's) on the
     one-rank mesh: host ms behind a queued device sleep (whether the
     call waits for the device) and device ms, beside an ``add_``;
   - ``tp_serve``: ``LlamaConfig.llama3_8b()`` at full width, depth cut to
     TP_LAYERS, bf16, seeded; ``TensorParallelPagedLlamaSlotBackend``
     (block 16, the radix cache) and ``TensorParallelLlamaSlotBackend``
     built at tp = 1 on the mesh, each after its base backend on the same
     model (flash attention: chunked prefill dense, decode through the
     kernels, the tp arms' choices); TP_SLOTS seeded prompts of
     TP_PROMPT_LENS tokens, TP_NEW new tokens each: the tp streams
     bitwise the base arm's, each arm's streams held to the dense model
     by phase n's top-2-gap rule; every decode launch through the
     head-sharded dispatch (kernel launches = dispatch calls = TP_LAYERS
     × steps, no flash_attention); new tokens/s, decode-iteration ms,
     graph captures and replays (the tp step, its one-rank all-reduces
     and gathers inside, is captured), peak memory, per-device pool
     bytes equal to the base's; each prefill chunk's ms, and on the
     unpaged arms 8 chunks at steady state and a profile of 4;
   - ``tp_front``: after each tp arm, its engine started (the group's
     front, ``serving.group``, on the one-rank gloo control group) with
     TP_CLIENTS closed-loop client threads over the same prompts: the
     streams bitwise the inline tp arm's, every decode launch through the
     dispatch (TP_LAYERS × steps); new tokens/s beside the inline arm's,
     decode-iteration ms, the control channel's ms an iteration (the
     message's all-reduce and, where it has one, its payload's
     broadcast; p50 / p95), messages and idle messages;
     then one cancel and one 50 ms deadline (each ended so, no slot left
     busy) and one drain → resume mid-stream: the resumed streams bitwise
     the uninterrupted ones up to the drain and, from there, up to the
     first near tie (phase o's rule, ``fleet_vs_clean``: a resume
     re-prefills prompt + delivered tokens, whose bf16 K/V is not the
     decode step's bit for bit).
   A ``summary`` line gives the phase's seconds against PHASE_U_BUDGET_S.
v. Sharded training (FSDP×TP, MoE, GPipe, the sharded feed), on a
   one-rank NCCL gang joined as phase t's, each leg on its one-rank
   mesh:
   - ``fsdp_tp_train``: ``LlamaConfig.llama3_8b()`` at full width, depth
     cut to FSDP_LAYERS, bf16, full-parameter ``sgd(FSDP_LR)``, phase g's
     batch (2 x 2048), FSDP_STEPS steps, flash kernels (``"auto"``): the
     unsharded ``make_train_step`` arm, then the FSDP×TP arm
     (``models.llama.shard_model`` on ``{"data": 1, "model": 1}``,
     ``make_train_step(mesh=, param_rules=)``) from the same seeded
     weights; every gathered parameter after the steps bitwise the
     unsharded arm's, the losses equal, each arm's flash forward and
     backward launches FSDP_LAYERS x FSDP_STEPS, the sharded arm's peak
     less than half the model's bytes above the unsharded arm's (ZeRO-3
     keeps no gathered weight from the forward to the backward); per arm
     the step ms, tokens/s, peak GB and collectives a step (the sharded
     arm's counted by ``parallel.fsdp``: all-gathers, reduce-scatters,
     all-reduces);
   - ``sharded_ckpt``: that sharded state saved (global tensors; the
     manifest names the mesh) and restored into a freshly placed model
     through ``restore(mesh=, rules=)``: bit-identical; bytes, save s,
     restore s;
   - ``moe``: ``parallel.SwitchMoE`` at Switch-Base-8's widths (MOE_*),
     8 x 512 tokens, bf16, on ``{"ep": 1}`` (``shard_moe``) against the
     unsharded module: output and gradients bitwise; forward + backward
     ms of each;
   - ``gpipe``: ``parallel.gpipe`` on ``{"pp": 1}``, the stage one
     llama3_8b-width decoder block (flash forward), GPIPE_MICRO
     microbatches of 1 x GPIPE_SEQ: bitwise the block applied in turn,
     one flash launch a microbatch; ms of each;
   - ``batch_runner_mesh``: the ResNet50 featurizer's step through
     ``BatchRunner(mesh={"data": 1})`` against ``mesh=None``, 4 batches
     of 64 at 224: outputs bitwise; rows/s of each.
   A ``summary`` line gives the phase's seconds (and each leg's) against
   PHASE_V_BUDGET_S.
w. A fleet of tensor-parallel groups in other processes
   (``serving.remote``), after this process's models are freed: three
   one-rank groups, each ``launcher.launch(np=1)`` of ``chip_smoke.py
   --fleet-group-worker <dir> <name>`` (its own one-rank NCCL gang on
   ``cuda:0``; the three processes share the card, time-sliced), each
   building phase u's model (``LlamaConfig.llama3_8b()`` at full width,
   depth TP_LAYERS, bf16, seed 21) and ``GenerationEngine.from_model(
   model, mesh=tp_mesh(1))`` — groups a and b paged (block 16, the radix
   cache, ``paged_flash_decode``), c unpaged (``flash_decode``) — started
   behind a ``FrontServer``; each group checks after every iteration that
   its decode launches = dispatch calls = TP_LAYERS × steps with no
   flash-forward launch, and writes its counts. This process puts
   ``EngineFleet`` (radix) over the three ``RemoteEngine`` proxies,
   ``fleet.start()``, and runs three legs of TP_CLIENTS closed-loop client
   threads over phase u's TP_SLOTS prompts (TP_NEW new tokens): clean;
   ``doom_replica("a")`` mid-stream (drain, re-admission on b or c); a
   SIGKILL of b's process mid-stream (b DEAD through its lost channel,
   its requests re-admitted from shadow on c; b's ``GangFailure`` is the
   expected outcome, asserted). Every stream delivered exactly once and
   held to a clean engine's of its first replica's family (group c runs
   both clean engines once the fleet stops) by phase o's rule
   (``fleet_vs_clean``). Recorded: new tokens/s and TTFT p50/p95 a leg,
   the channel's submit round trip and token-batch lag (p50/p95, one
   host's clock on both ends), kill → DEAD seconds, each group's peak
   memory. A ``summary`` line gives the phase's seconds against
   PHASE_W_BUDGET_S.

Then a ``{"phase_walls": {...}}`` line: each phase's wall seconds, keyed
by its letter and name (``a_build`` ... ``w_fleet_remote``; the parity
halves of g and h apart), and ``total``, the script's seconds from its
start to that line. Then a ``{"kernels": [...]}`` line (four kernels:
flash_attention, flash_decode, paged_flash_decode, flash_attention_bwd;
the two flash entries add their BERT case and phase h's launches, phase
m's gang launches, phase p's, ``phase_p_launches``, and phase q's
``sup_bert_kill`` attempts, ``phase_q_launches``; the three forward
kernels add phase n's and phase o's launches leg by leg,
``phase_n_launches`` and ``phase_o_launches``; flash_attention and
paged_flash_decode add phase r's, ``phase_r_launches``;
paged_flash_decode adds its llama3_8b 32:8 S = 5 verify window,
``llama3_8b_s5_case``; flash_attention, flash_decode and
flash_attention_bwd add phase t's, ``phase_t_launches``; flash_decode
and paged_flash_decode add phase u's arms and its ``tp_front`` legs
(``<family>_front``), ``phase_u_launches``;
flash_attention and flash_attention_bwd add phase v's,
``phase_v_launches``; flash_decode and paged_flash_decode add phase w's
groups, ``phase_w_launches``) and,
last, ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, it prints no result and exits 2. Imports
nothing of JAX, and no pyarrow or pandas.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()  # phase_walls' total counts from here

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
# phase m: phase h's recipe as a one-rank NCCL gang (3 warm-up steps, 10
# timed), then 2 steps with accum_steps=2; llama3_8b's widths cut to
# DP_LORA_LAYERS layers, phase g's batch. The LoRA gang against the same
# fit in this process: bf16 losses within DP_LORA_LOSS_RTOL relative
# (at one rank the gang's all-reduce leaves the gradients as they are,
# so they are expected to be bitwise; the limit allows a bf16 step)
DP_BERT_WARMUP, DP_BERT_TIMED, DP_BERT_ACCUM_STEPS = 3, 10, 2
DP_LORA_LAYERS, DP_LORA_STEPS, DP_LORA_LOSS_RTOL = 4, 5, 2.0 ** -8
# phase m's numeric scoring runner: rows, width, batch
XLA_ROWS, XLA_WIDTH, XLA_BATCH = 4096, 1024, 256


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
    library = sdpa_bwd_backends(torch, sdpa, leaves, do, sdpa_mask,
                                causal and mask is None, flush)
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
               **library,
               fwd_bwd_ms=time_ms(torch, kernel_fwd_bwd, flush=flush),
               library_fwd_bwd_ms=time_ms(torch, sdpa_fwd_bwd, flush=flush),
               bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
               flops_issued=issued)
    rec["tflops"] = flops / rec["ms"] / 1e9           # the bound's five
    rec["tflops_issued"] = issued / rec["ms"] / 1e9   # the seven issued
    rec["bound_share"] = bms / rec["ms"]
    emit(rec)
    return rec


def sdpa_bwd_backends(torch, sdpa, leaves, do, attn_mask, is_causal: bool,
                      flush) -> dict:
    """Which backend ``F.scaled_dot_product_attention`` picks for these
    inputs (``torch._fused_sdp_choice``, the dispatcher's own choice), the
    torch, CUDA and cuDNN versions, and the backward's ms with the
    forward pinned to each backend in turn (``sdpa_kernel``; the
    backward runs the backend its forward ran): a number, or why the
    backend refused these inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = {int(v.value): k for k, v in SDPBackend.__members__.items()}
    try:
        picked = names.get(int(torch._fused_sdp_choice(
            *leaves, attn_mask=attn_mask, dropout_p=0.0,
            is_causal=is_causal)), "?")
    except (AttributeError, RuntimeError, TypeError) as e:
        picked = f"unread ({type(e).__name__}: {e})"[:200]
    pinned = {}
    for be in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(be):
                out = sdpa()
            pinned[be.name] = time_ms(torch, lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), flush=flush)
            del out
        except RuntimeError as e:
            pinned[be.name] = "not admissible: " + \
                str(e).strip().splitlines()[0][:200]
    return dict(library_backend=picked, library_pinned_ms=pinned,
                torch=torch.__version__, cuda=torch.version.cuda,
                cudnn=torch.backends.cudnn.version())


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


def paged_inputs(torch, *, dtype, kv, s_q, hq=16):
    """One seeded paged_flash_decode input on the card, the main path's
    serving shapes: (q, k pool, v pool, tables, cur, pad, scales), every
    block no live range reads filled with NaN. ``kv``: "same" (pools in
    ``dtype``), "int8" or "fp8" (codes with a scale plane). ``hq``: the
    query heads over 8 KV heads (16 for llama_small, 32 for llama3_8b)."""
    b, hkv, d, bs, mb = 8, 8, 128, PAGED_BS, PAGED_MB
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


def paged_case(torch, pfd, flush, *, name, dtype, kv, s_q, hq=16,
               profile=False):
    """paged_flash_decode kernel vs plain on one seeded pool
    (:func:`paged_inputs`), then the three times; returns the phase-b
    record."""
    import torch.nn.functional as F

    args = paged_inputs(torch, dtype=dtype, kv=kv, s_q=s_q, hq=hq)
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
        for s_q in (1, 5):  # phase n's llama3_8b: 4 query rows a KV head
            rec = paged_case(torch, pfd, flush,
                             name=f"llama3_8b_gqa_paged_s{s_q}",
                             dtype=dtype, kv="same", s_q=s_q, hq=32)
            if dtype == "bfloat16" and s_q == 5:  # its verify window
                main["paged_llama3_8b_s5"] = rec
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


def graph_captures(since: float, fn: str | None = None) -> list:
    """Capture times (ms) of the CUDA graphs made since ``since`` (a
    ``time.time()``), from the flight recorder's ``graph_capture``
    events; with ``fn``, only those of that step."""
    from sparkdl_tpu_torch.runner import events

    return [e["ms"] for e in events.get_recorder().tail()
            if e["name"] == "graph_capture" and e["t"] >= since
            and fn in (None, e.get("fn"))]


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
                  repeat=None, families=None):
    """Seeded prompts of ``lens`` tokens; those at indices ``shared`` start
    with one common ``head_len``-token head; ``families`` n gives n heads
    and starts prompt i with head i mod n; ``repeat`` n makes every
    prompt a cycle of an n-token phrase (n-gram drafts find matches)."""
    g = torch.Generator().manual_seed(seed)

    def rand(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()

    heads = [rand(head_len) for _ in range(families or 1)]
    out = []
    for i, n in enumerate(lens):
        if repeat:
            phrase = rand(repeat)
            p = (phrase * (n // repeat + 1))[:n]
        elif families:
            p = heads[i % families] + rand(n - head_len)
        elif i in shared:
            p = heads[0] + rand(n - head_len)
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


def serve_leg(torch, model, kernels, *, leg, prompts, new=SERVE_NEW,
              max_len=2048, config="LlamaConfig.small", keep_streams=False,
              engine=None, **kw) -> tuple:
    """One fresh engine serving ``prompts`` (all submitted at once, ``new``
    tokens each) to the end; the launch counters are set to 0 just
    before and read just after. ``engine``: one built by the caller (of 8
    slots, on ``model``'s card), else ``from_model(model, **kw)``. Returns
    the leg's record (with every request's tokens under ``streams`` when
    ``keep_streams``) and the engine."""
    from sparkdl_tpu_torch import GenerationEngine

    eng = engine if engine is not None else GenerationEngine.from_model(
        model, num_slots=8, max_len=max_len, device="cuda", **kw)
    iter_s, chunk_s = [], []
    # time each decode iteration and each prefill chunk
    for attr, acc in (("step", iter_s), ("verify", iter_s),
                      ("prefill_chunk", chunk_s)):
        fn = getattr(eng.backend, attr)

        def timed(*a, _fn=fn, _acc=acc, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)  # returns host tokens: the device is done
            _acc.append(time.perf_counter() - t0)
            return out
        setattr(eng.backend, attr, timed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    since = time.time()
    t0 = time.perf_counter()
    hs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(*kernels)
    outs = [h.result(1) for h in hs]
    ttft = sorted(h.t_first_token - h.t_submit for h in hs)
    st = eng.stats
    n_new = sum(len(o) for o in outs)
    for o in outs:
        assert len(o) == new and 0 <= min(o) and max(o) < \
            model.cfg.vocab_size, f"{leg}: bad stream {o[:8]}"
    rec = dict(phase="serve", leg=leg, config=config,
               dtype=str(model.dtype).replace("torch.", ""),
               layers=model.cfg.num_layers,
               engine={k: v if isinstance(v, (int, float, str, type(None)))
                       else type(v).__name__ for k, v in kw.items()},
               num_slots=8,
               max_len=max_len, requests=len(prompts),
               completed=st["completed"],
               prompt_lens=[len(p) for p in prompts], new_tokens=n_new,
               wall_s=wall, new_tokens_per_s=n_new / wall,
               ttft_p50_s=ttft[len(ttft) // 2],
               ttft_p95_s=ttft[max(0, -(-95 * len(ttft) // 100) - 1)],
               decode_iterations=len(iter_s),
               decode_iter_ms_mean=1e3 * sum(iter_s) / max(len(iter_s), 1),
               prefill_chunk_ms_mean=1e3 * sum(chunk_s) / max(len(chunk_s),
                                                              1),
               prefill_chunk_ms=[1e3 * t for t in chunk_s],
               steps=st["steps"], prefills=st["prefills"],
               prefill_chunks=st["prefill_chunks"],
               preemptions=st["preemptions"],
               spec_verifies=st["spec_verifies"],
               spec_tokens_accepted=st["spec_tokens_accepted"],
               prefix=eng.backend.prefix_stats(), launches=launches,
               graphs=eng.backend.graphs.snapshot(),
               capture_ms=graph_captures(since, "serve_decode_step"),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    assert st["completed"] == len(prompts), rec
    if keep_streams:
        rec["streams"] = outs
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


def profile_serve(torch, L, eng, cfg, steps: int = 4,
                  what: str = "small bf16") -> list:
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
                           f"graph, 8 slots decoding, {what}")
    assert eng.backend.graphs.snapshot()["replays"] == replays + steps
    graph["host_split_ms"] = iteration_split(torch, eng, steps)
    real = eng.backend.step
    eng.backend.step = eager_backend_step(L, eng.backend)
    try:
        eager = device_profile(torch, eng.step, steps,
                               f"{steps} paged engine iterations, eager "
                               f"step, 8 slots decoding, {what}")
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


@contextlib.contextmanager
def flops_estimate():
    """``SPARKDL_MFU_ESTIMATE=1`` around one fit given no
    ``flops_per_step`` (the fit reads the knob when it starts; the
    variable is restored after): yields the list that receives the fit's
    ``flops_estimate`` event."""
    import os

    from sparkdl_tpu_torch.runner import events

    got: list = []

    def tee(rec):
        if rec.get("name") == "flops_estimate":
            got.append(rec)

    old = os.environ.get("SPARKDL_MFU_ESTIMATE")
    os.environ["SPARKDL_MFU_ESTIMATE"] = "1"
    events.add_tee(tee)
    try:
        yield got
    finally:
        events.remove_tee(tee)
        if old is None:
            del os.environ["SPARKDL_MFU_ESTIMATE"]
        else:
            os.environ["SPARKDL_MFU_ESTIMATE"] = old


def estimate_fields(est: list, meter, formula: float,
                    not_done: float) -> dict:
    """A phase line's FLOP-count fields: the fit's own count of its first
    step (``flops_estimate``, the kernels reporting theirs), the hand
    formula the phase passed before (``flops_formula``) and their ratio,
    the counting step's wall time, the formula's work the step does not
    do, from the model's shapes (``formula_not_done``), and the residual
    ``estimate - (formula - not_done)``, 0 when the two agree on every
    product. The meter's FLOPs must be the count, and its MFU a number."""
    assert len(est) == 1 and est[0]["flops"], est
    f = est[0]["flops"]
    assert meter.flops_per_step == f, (meter.flops_per_step, f)
    assert meter.summary()["mfu"] is not None, "the estimate gave no MFU"
    return dict(flops_estimate=f, flops_formula=formula,
                estimate_over_formula=f / formula,
                counting_step_s=est[0]["dur_s"], formula_not_done=not_done,
                estimate_residual=f - (formula - not_done))


def lora_not_done(model, tokens: int) -> float:
    """``train_flops``'s work the LoRA step does not do: layer 0's q, k
    and v projections (base weight and adapter A) take no input gradient,
    since the frozen embedding below them needs none: 2·T a weight."""
    n = sum(p.numel() for name, p in model.named_parameters()
            if name.startswith("layers.0.attn.")
            and name.split(".")[3] in ("q_proj", "k_proj", "v_proj")
            and name.endswith(("base.weight", "lora_a.weight")))
    return 2.0 * tokens * n


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
    with flops_estimate() as est:  # the fit counts its first step itself
        res = XlaRunner(np=1).run(lambda ctx: ctx.fit(
            loss_fn=L.causal_lm_loss_fn(), model=model,
            tx=L.lora_optimizer(TRAIN_LR),
            data=[{"input_ids": ids}] * TRAIN_STEPS, num_steps=TRAIN_STEPS,
            log_every=1))
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
               **estimate_fields(est, res["meter"], flops, lora_not_done(
                   model, TRAIN_BATCH * TRAIN_SEQ)),
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


def glue_not_done(model, batch) -> float:
    """``glue_flops``'s work the BERT step does not do: the pooler and the
    classifier run on the B [CLS] rows, not on all B·S tokens."""
    n = sum(p.numel() for name, p in model.named_parameters()
            if name.endswith("weight")
            and name.startswith(("bert.pooler.", "classifier.")))
    b, s = batch["input_ids"].shape
    return 6.0 * n * b * (s - 1)


def glue_cpu_count(torch, B, fa, state: dict, batch: dict) -> tuple:
    """Phase h's first step counted on the CPU: BertConfig.base() in f32
    with ``state``'s weights and flash attention's plain versions (which
    report the same FLOPs the kernels report), one
    ``fit(with_rng=True)`` step under ``SPARKDL_MFU_ESTIMATE=1``:
    (the count, seconds)."""
    from sparkdl_tpu_torch.runner import XlaRunner
    from sparkdl_tpu_torch.runner.train_state import adam

    t0 = time.perf_counter()
    cpu = B.BertForSequenceClassification(
        B.BertConfig.base(), num_classes=2, dtype=torch.float32,
        device="cpu", attn_fn=fa.flash_attention)
    cpu.load_state_dict(state)
    with flops_estimate() as est:
        res = XlaRunner(np=1, device="cpu").run(lambda ctx: ctx.fit(
            loss_fn=B.bert_finetune_loss(cpu), model=cpu,
            tx=adam(GLUE_LR), data=[batch], num_steps=1, with_rng=True))
    assert len(est) == 1, est
    del res, cpu
    return est[0]["flops"], time.perf_counter() - t0


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
    # the weights the fit starts from, for the CPU count of its first step
    state0 = {k: v.detach().to("cpu", copy=True)
              for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    with flops_estimate() as est:  # the fit counts its first step itself
        res = XlaRunner(np=1).run(lambda ctx: ctx.fit(
            loss_fn=B.bert_finetune_loss(model), model=model,
            tx=adam(GLUE_LR), data=FactoryDataset(lambda: iter(batches)),
            num_steps=GLUE_STEPS, log_every=1, with_rng=True))
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
    counted = estimate_fields(est, res["meter"], flops[0],
                              glue_not_done(model, batches[0]))
    # the card's count (the kernels reporting) is the CPU's (the plain
    # versions reporting): a kernel that went uncounted fails here
    cpu_flops, cpu_s = glue_cpu_count(torch, B, fa, state0, batches[0])
    del state0
    assert cpu_flops == counted["flops_estimate"], (
        cpu_flops, counted["flops_estimate"])
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
               **counted, cpu_flops_estimate=cpu_flops, cpu_count_s=cpu_s,
               meter_mfu=res["meter"].summary()["mfu"],
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


def image_flops(torch, model, h: int, w: int, per_layer: bool = False):
    """FLOPs a row of ``model``'s features from its own conv and dense
    shapes (2 per multiply-add; BatchNorm, pools and the prologue are not
    counted), read by forward hooks on one row at ``h`` x ``w``; with
    ``per_layer`` the list of each conv's and dense's, in the order they
    ran."""
    from sparkdl_tpu_torch.models.image_layers import Conv, Dense

    total = []

    def conv(m, inp, out):
        total.append(2 * out[0].numel() * m.weight.shape[1] * m.kernel[0]
                     * m.kernel[1])

    def dense(m, inp, out):
        total.append(2 * out[0].numel() * m.weight.shape[1])

    hooks = [m.register_forward_hook(conv if isinstance(m, Conv) else dense)
             for m in model.modules() if isinstance(m, (Conv, Dense))]
    dev = next(model.parameters()).device
    with torch.inference_mode():
        model(torch.zeros(1, h, w, 3, device=dev), features_only=True)
    for hk in hooks:
        hk.remove()
    return total if per_layer else sum(total)


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
               lookahead: int = 0, estimate: bool = False) -> tuple:
    """``XlaRunner(np=1).run(ctx.fit(bn_classifier_loss, sgd,
    mutable=True, log_every=1, feed_lookahead=lookahead))`` over
    ``steps`` batches cycled from ``batches``: (result, step seconds, fit
    seconds). A step's time runs from its loss call to the next step's
    (the last to the end of the fit): with ``log_every=1`` a step ends in
    a wait, so that is one step as the user sees it, device work, the
    host's launches and whatever of the batch's copy is not hidden. (The
    time between two draws is not: a lookahead draws ahead.) With
    ``estimate`` the fit gets no ``flops_per_step`` and counts its first
    step itself (``SPARKDL_MFU_ESTIMATE=1``); its ``flops_estimate``
    event is in the result's ``"flops_estimate"``."""

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
    with (flops_estimate() if estimate
          else contextlib.nullcontext(None)) as est:
        res = XlaRunner(np=1).run(lambda ctx: ctx.fit(
            loss_fn=stamped, model=model, tx=sgd(RESNET_LR, momentum=0.9),
            data=(batches[i % len(batches)] for i in range(steps)),
            num_steps=steps, log_every=1, mutable=True,
            flops_per_step=None if estimate else flops,
            feed_lookahead=lookahead))
    torch.cuda.synchronize()
    end = time.perf_counter()
    if estimate:
        res["flops_estimate"] = est
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
        # arm 0 counts its own first step (SPARKDL_MFU_ESTIMATE)
        res, step_s, fit_s, flops = resnet_fit(torch, spec, model, wire, n,
                                               ahead, estimate=arm == 0)
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
        if arm == 0:
            # the formula's work the step does not do: the stem's input
            # gradient (the images need none), less the head's 3 products
            # a row, which the formula (features only) leaves out
            from sparkdl_tpu_torch.models.image_layers import Dense
            stem = image_flops(torch, model, RESNET_SIZE, RESNET_SIZE,
                               per_layer=True)[0]
            head = sum(2 * m.weight.numel() for m in model.modules()
                       if isinstance(m, Dense))
            rec.update(estimate_fields(res["flops_estimate"], res["meter"],
                                       flops,
                                       (stem - 3 * head) * RESNET_BATCH))
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


def stamped_fit(torch, ctx, loss_fn, model, tx, data, steps: int,
                accum_steps: int = 1, **kw) -> tuple:
    """``ctx.fit(..., num_steps=steps, log_every=1)``: (result, step
    seconds, fit seconds), a step from its first loss call to the next
    step's (the last to the end of the fit), as ``resnet_fit`` times
    them."""
    stamps: list = []

    def stamped(m, batch, **k):
        stamps.append(time.perf_counter())
        return loss_fn(m, batch, **k)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ctx.fit(loss_fn=stamped, model=model, tx=tx, data=data,
                  num_steps=steps, log_every=1, accum_steps=accum_steps,
                  **kw)
    torch.cuda.synchronize()
    end = time.perf_counter()
    stamps = stamps[::accum_steps] + [end]  # a loss call a microbatch
    return res, [b - a for a, b in zip(stamps, stamps[1:])], end - t0


def dropout_draws(torch, model, batch: dict) -> list:
    """The elements each dropout site of one forward of ``model`` (a
    ``BertForSequenceClassification``) with dropout on draws over
    ``batch``'s rows: ``models.bert.uniform`` is wrapped for the call."""
    from sparkdl_tpu_torch.models import bert as B

    drawn, real = [], B.uniform

    def counted(shape, rng, device):
        drawn.append(math.prod(shape))
        return real(shape, rng, device)

    B.uniform = counted
    try:
        with torch.no_grad():
            model(batch["input_ids"], batch["attention_mask"],
                  deterministic=False,
                  generator=torch.Generator(model.device).manual_seed(0))
    finally:
        B.uniform = real
    return drawn


def meter_line(meter) -> dict:
    """The meter's per-chip rate and MFU, for a worker's JSON."""
    summ = meter.summary()
    return {"examples_per_sec_per_chip": summ["examples_per_sec_per_chip"],
            "mfu": summ["mfu"]}


def lora_cut_model(torch):
    """Phase m's LoRA model: llama3_8b(lora_rank=16)'s widths at
    DP_LORA_LAYERS layers, bf16, weights from seed 0 on the card."""
    import dataclasses

    from sparkdl_tpu_torch.models import llama as L

    cfg = dataclasses.replace(L.LlamaConfig.llama3_8b(lora_rank=16),
                              num_layers=DP_LORA_LAYERS)
    return L.LlamaModel(cfg, dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(0))


def dp_m_worker(out_dir: str) -> int:
    """Phase m's gang worker (``chip_smoke.py --dp-m-worker <out_dir>``,
    started by ``launcher.launch``): joins the gang through
    ``XlaRunner()`` (NCCL, rank r on ``cuda:r``), runs ``dp_bert``,
    ``dp_bert_accum`` and ``dp_lora`` on this rank's rows of each global
    batch and writes their records to ``out_dir/dp_m.json``."""
    import gc

    import torch

    from sparkdl_tpu_torch.models import bert as B
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.ops import flash_decode as fd
    from sparkdl_tpu_torch.ops import paged_flash_decode as pfd
    from sparkdl_tpu_torch.runner import XlaRunner, adam
    from sparkdl_tpu_torch.runner.data import FactoryDataset, ListDataset
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = (fa, fd, pfd)
    ctx = XlaRunner().make_context()
    assert ctx.gang is not None and ctx.gang.backend == "nccl", ctx.gang
    assert ctx.device == torch.device("cuda", ctx.rank), ctx.device
    out = {}

    # dp_bert and dp_bert_accum: phase h's model, batches and recipe
    cfg = B.BertConfig.base()
    steps = DP_BERT_WARMUP + DP_BERT_TIMED
    batches = [glue_batch(i, cfg.vocab_size) for i in range(steps)]
    local = GLUE_BATCH // ctx.size

    def bert():
        return B.BertForSequenceClassification(
            cfg, num_classes=2, dtype=torch.bfloat16, device=ctx.device,
            generator=torch.Generator(device=ctx.device).manual_seed(0))

    for arm, n_steps, kw in (("dp_bert", steps, {}),
                             ("dp_bert_accum", DP_BERT_ACCUM_STEPS,
                              {"accum_steps": 2})):
        model = bert()
        flops = [glue_flops(model, b) for b in batches[:n_steps]]
        # the random numbers a step draws: a rank draws the global
        # batch's, world x its own rows' (utils.rng.RowWindow)
        drawn = dropout_draws(torch, model, {
            k: torch.as_tensor(v[:local]).to(ctx.device)
            for k, v in batches[0].items()})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        res, step_s, fit_s = stamped_fit(
            torch, ctx, B.bert_finetune_loss(model), model, adam(GLUE_LR),
            FactoryDataset(lambda: iter(batches), shard=True), n_steps,
            with_rng=True, flops_per_step=sum(flops) / n_steps, **kw)
        rec = dict(launches=read_counts(*kernels),
                   bwd_variant_launches=dict(
                       fa.flash_attention_bwd.variant_launches),
                   losses=[h["loss"] for h in res["history"]],
                   flops=flops, step_s=step_s, fit_s=fit_s,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   dropout_sites=len(drawn),
                   dropout_uniforms_own_rows=sum(drawn),
                   dropout_draw_gb_per_rank={
                       n: 4 * n * sum(drawn) / 1e9 for n in (1, 2, 4, 8)},
                   meter=meter_line(res["meter"]), batch_per_rank=local,
                   world_size=ctx.size, rank=ctx.rank,
                   backend=ctx.gang.backend, device=str(ctx.device))
        out[arm] = rec
        del res, model
        gc.collect()
        torch.cuda.empty_cache()

    # dp_lora: llama3_8b's widths at DP_LORA_LAYERS layers
    model = lora_cut_model(torch)
    ids = train_ids(torch, model.cfg)
    per = TRAIN_BATCH // ctx.size
    flops = train_flops(model, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx.put_replicated(model)
    torch.cuda.synchronize()
    bcast_s = time.perf_counter() - t0
    bcast_bytes = sum(t.numel() * t.element_size()
                      for t in [*model.parameters(), *model.buffers()])
    # the same broadcast at llama3_8b's full depth: the per-layer bytes
    # times its layers, plus the rest
    layer_bytes = sum(t.numel() * t.element_size() for n, t in
                      [*model.named_parameters(), *model.named_buffers()]
                      if n.startswith("layers."))
    full_bytes = bcast_bytes - layer_bytes + layer_bytes \
        // model.cfg.num_layers * L.LlamaConfig.llama3_8b().num_layers
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    res, step_s, fit_s = stamped_fit(
        torch, ctx, L.causal_lm_loss_fn(), model,
        L.lora_optimizer(TRAIN_LR),
        ListDataset([{"input_ids": ids}] * DP_LORA_STEPS, shard=True),
        DP_LORA_STEPS, flops_per_step=flops)
    out["dp_lora"] = dict(
        launches=read_counts(*kernels),
        bwd_variant_launches=dict(fa.flash_attention_bwd.variant_launches),
        losses=[h["loss"] for h in res["history"]], flops=flops,
        step_s=step_s, fit_s=fit_s,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        meter=meter_line(res["meter"]), batch_per_rank=per,
        trainable=len(res["state"].trainable()),
        trainable_params=sum(p.numel() for p in res["state"].trainable()),
        put_replicated_bytes=bcast_bytes, put_replicated_s=bcast_s,
        put_replicated_bytes_full_depth=full_bytes,
        world_size=ctx.size, rank=ctx.rank)
    (Path(out_dir) / "dp_m.json").write_text(json.dumps(out))
    leave_gang()
    return 0


def phase_dp_m(torch, glue: dict) -> dict:
    """Phase m (module docstring): the one-rank NCCL gang's BERT and LoRA
    fine-tunes against phase h's losses and an in-process LoRA fit, then
    ``XlaTransformer``'s runner."""
    import gc
    import tempfile

    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.runner import XlaRunner, launcher

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="sparkdl_dp_m_") as d:
        t0 = time.perf_counter()
        launcher.launch(str(ROOT / "chip_smoke.py"), np=1,
                        args=["--dp-m-worker", d], timeout_s=DP_TIMEOUT_S,
                        capture=True)
        gang_wall_s = time.perf_counter() - t0
        w = json.loads((Path(d) / "dp_m.json").read_text())

    nl = 12  # BertConfig.base()'s layers
    recs = {}
    for arm, warm in (("dp_bert", DP_BERT_WARMUP), ("dp_bert_accum", 0)):
        r = w[arm]
        steps = len(r["losses"])
        line = step_line(r["step_s"], warm)
        ms = line["step_ms_median"]
        flops = sum(r["flops"][warm:]) / max(steps - warm, 1)
        rec = dict(phase=arm, config="BASELINE config 4, np=1 NCCL gang",
                   model="BertConfig.base()", num_classes=2,
                   dtype="bfloat16", params="float32", tf32=False,
                   batch_global=GLUE_BATCH, seq=GLUE_SEQ, lr=GLUE_LR,
                   optimizer="adam", with_rng=True,
                   accum_steps=2 if arm == "dp_bert_accum" else 1,
                   step="implicit (gradient all-reduce; dropout from the "
                        "rank's RowWindow of the global batch)",
                   steps=steps, warmup_steps=warm, **line,
                   examples_per_s_per_chip=r["batch_per_rank"] / ms * 1e3,
                   flops_per_step=flops,
                   mfu=flops / (ms / 1e3) / (PEAK_FLOPS["bfloat16"]
                                             * r["world_size"]),
                   mfu_formula=GLUE_MFU_FORMULA,
                   **{k: r[k] for k in ("losses", "launches",
                                        "bwd_variant_launches",
                                        "peak_mem_gb", "fit_s",
                                        "batch_per_rank", "world_size",
                                        "backend", "device",
                                        "dropout_sites",
                                        "dropout_uniforms_own_rows",
                                        "dropout_draw_gb_per_rank")},
                   meter_examples_per_s_per_chip=r["meter"][
                       "examples_per_sec_per_chip"],
                   meter_mfu=r["meter"]["mfu"], gang_wall_s=gang_wall_s,
                   nvidia_smi=smi())
        assert r["backend"] == "nccl" and r["world_size"] == 1, r
        assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
        launches = r["launches"]
        assert launches["flash_attention"] > 0 and \
            launches["flash_attention_bwd"] > 0, launches
        assert launches["flash_attention"] == nl * steps * rec[
            "accum_steps"], launches
        assert launches["flash_attention_bwd"] == \
            launches["flash_attention"], launches
        assert r["bwd_variant_launches"]["fma_f32"] == 0, r
        if arm == "dp_bert":
            want = glue["losses"][:steps]
            rec.update(in_process_losses=want,
                       losses_bitwise_equal=r["losses"] == want,
                       loss_max_abs_err=max(abs(a - b) for a, b in
                                            zip(r["losses"], want)),
                       against="phase h's in-process fit, same seed, "
                               "batches and rng (its with_rng repeat is "
                               "bitwise)")
        emit(rec)
        recs[arm] = rec
        if arm == "dp_bert":
            assert rec["losses_bitwise_equal"], rec

    # dp_lora, against the same fit in this process
    r = w["dp_lora"]
    model = lora_cut_model(torch)
    ids = train_ids(torch, model.cfg)
    cfg = model.cfg
    res = XlaRunner(np=1).run(lambda ctx: ctx.fit(
        loss_fn=L.causal_lm_loss_fn(), model=model,
        tx=L.lora_optimizer(TRAIN_LR),
        data=[{"input_ids": ids}] * DP_LORA_STEPS, num_steps=DP_LORA_STEPS,
        log_every=1))
    want = [h["loss"] for h in res["history"]]
    del res, model
    gc.collect()
    torch.cuda.empty_cache()
    line = step_line(r["step_s"], 1)
    ms = line["step_ms_median"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], want))
    rec = dict(phase="dp_lora",
               config=f"LlamaConfig.llama3_8b(lora_rank=16), depth cut to "
                      f"{DP_LORA_LAYERS} of 32 layers, np=1 NCCL gang",
               layers=cfg.num_layers, hidden=cfg.hidden_size,
               heads=[cfg.num_heads, cfg.num_kv_heads],
               head_dim=cfg.head_dim, ffn=cfg.intermediate_size,
               vocab=cfg.vocab_size, dtype="bfloat16", batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, lr=TRAIN_LR, optimizer="lora_optimizer",
               steps=len(r["losses"]), warmup_steps=1, **line,
               tokens_per_s_per_chip=r["batch_per_rank"] * TRAIN_SEQ / ms
               * 1e3, flops_per_step=r["flops"],
               mfu=r["flops"] / (ms / 1e3) / PEAK_FLOPS["bfloat16"],
               **{k: r[k] for k in ("losses", "launches",
                                    "bwd_variant_launches", "peak_mem_gb",
                                    "fit_s", "trainable", "trainable_params",
                                    "put_replicated_bytes",
                                    "put_replicated_s",
                                    "put_replicated_bytes_full_depth",
                                    "world_size")},
               in_process_losses=want,
               losses_bitwise_equal=r["losses"] == want,
               loss_max_rel_err=rel, loss_rtol=DP_LORA_LOSS_RTOL,
               gang_wall_s=gang_wall_s, nvidia_smi=smi())
    emit(rec)
    steps = len(r["losses"])
    assert all(math.isfinite(x) for x in r["losses"]), rec
    assert r["launches"]["flash_attention"] == cfg.num_layers * steps, rec
    assert r["launches"]["flash_attention_bwd"] == \
        cfg.num_layers * steps, rec
    assert r["bwd_variant_launches"]["tc_mma_bf16"] == \
        cfg.num_layers * steps, rec
    assert rel <= DP_LORA_LOSS_RTOL, rec
    recs["dp_lora"] = rec
    recs["xla_transformer"] = xla_transformer(torch)
    return recs


def xla_transformer(torch) -> dict:
    """Phase m, ``xla_transformer``: ``XlaTransformer``'s runner on the
    card over XLA_ROWS seeded rows (a bf16 dense layer and an exact
    GELU), timed after one warm-up batch; the output against the same
    runner on the CPU."""
    import numpy as np

    from sparkdl_tpu_torch.transformers import XlaTransformer

    rng = np.random.default_rng(7)
    x = rng.standard_normal((XLA_ROWS, XLA_WIDTH)).astype(np.float32)
    w = (rng.standard_normal((XLA_WIDTH, XLA_WIDTH))
         / np.sqrt(XLA_WIDTH)).astype(np.float32)
    b = (0.1 * rng.standard_normal(XLA_WIDTH)).astype(np.float32)

    def dense_gelu(device):
        wt = torch.from_numpy(w).to(device, torch.bfloat16)
        bt = torch.from_numpy(b).to(device, torch.bfloat16)

        def fn(batch):
            y = torch.nn.functional.linear(batch.to(torch.bfloat16), wt, bt)
            return torch.nn.functional.gelu(y).float()

        return fn

    batches = [x[i:i + XLA_BATCH] for i in range(0, XLA_ROWS, XLA_BATCH)]
    outs = {}
    for device in ("cuda", "cpu"):
        runner = XlaTransformer(
            inputCol="x", outputCol="y", fn=dense_gelu(device),
            batchSize=XLA_BATCH,
            **({} if device == "cuda" else {"device": "cpu"})
        )._get_runner()
        assert runner.device.type == device, runner.device
        list(runner.run(batches[:1]))
        t0 = time.perf_counter()
        outs[device] = np.concatenate(list(runner.run(batches)))
        outs[device + "_s"] = time.perf_counter() - t0
    got, want = outs["cuda"], outs["cpu"]
    excess = float((np.abs(got - want) - 2.0 ** -6 * (1 + np.abs(want)))
                   .max())
    rec = dict(phase="xla_transformer", rows=XLA_ROWS, width=XLA_WIDTH,
               batch_size=XLA_BATCH, fn="gelu(bf16 dense)",
               seconds=outs["cuda_s"], rows_per_s=XLA_ROWS / outs["cuda_s"],
               cpu_rows_per_s=XLA_ROWS / outs["cpu_s"],
               max_abs_err=float(np.abs(got - want).max()),
               tol_rule="2^-6·(1 + |cpu|)", excess_over_rule=excess,
               nvidia_smi=smi())
    emit(rec)
    assert got.shape == (XLA_ROWS, XLA_WIDTH) and np.isfinite(got).all()
    assert excess <= 0, rec
    return rec


# --- phase n: int8-weight serving, the registry draft, the tokenizer ------

INT8_NEW = 64                  # new tokens a request in the int8 legs
INT8_PARITY_LAYERS = 2         # int8_parity: llama_small widths, depth 2
TOKENIZER_VOCAB = 2048         # at most llama_small's 32000
TOKENIZER_ROWS, TOKENIZER_CHUNK, TOKENIZER_NEW = 256, 64, 32


def free_engines(torch) -> None:
    """Release engines just dropped: an engine whose backend methods are
    wrapped (``serve_leg``'s timers) sits in a reference cycle, and its
    pool and graph stay allocated until the collector runs."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_int8_weights(torch, kernels) -> dict:
    """``int8_weights``: llama3_8b at full width and depth, bf16 compute,
    seeded weights; a bf16-weight leg, then the same model quantized in
    place by ``from_model(weight_dtype="int8")`` and served again. Each
    leg: 8 slots, 8 prompts of 64–1536 tokens, 64 new tokens each, the
    paged blocking refill (``stall_free=False``: the paged prefill that
    runs flash_attention; the chunked prefill attends densely, as in
    the reference) with block 16."""
    from sparkdl_tpu_torch.models import llama as L

    cfg = L.LlamaConfig.llama3_8b()
    nl = cfg.num_layers
    t0 = time.perf_counter()
    model = L.LlamaModel(cfg, dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(14)
    lens = torch.randint(64, 1537, (8,), generator=g).tolist()
    lens[0], lens[-1] = 64, 1536
    prompts = serve_prompts(torch, cfg, lens, 14)
    kw = dict(block_size=16, prefill_chunk=256, stall_free=False,
              max_len=4096, new=INT8_NEW, config="LlamaConfig.llama3_8b")
    warm, eng = serve_leg(torch, model, kernels,
                          leg="int8_weights_warm-up",
                          prompts=[[1, 2, 3] * 20], **dict(kw, new=4))
    del warm, eng
    free_engines(torch)
    legs = {}
    for leg, wq in (("bf16_weights", None), ("int8_weights", "int8")):
        bf16_bytes = L.projection_bytes(model)
        t0 = time.perf_counter()
        rec, eng = serve_leg(torch, model, kernels, leg=leg, prompts=prompts,
                             **kw, **({"weight_dtype": wq} if wq else {}))
        assert eng.backend.weight_dtype == wq, rec
        assert (model.layers[0].mlp.down_proj.base.weight.dtype
                == (torch.int8 if wq else torch.bfloat16)), rec
        assert rec["launches"]["flash_attention"] == \
            nl * rec["prefills"] > 0, rec
        assert rec["launches"]["paged_flash_decode"] == \
            nl * rec["steps"] > 0, rec
        assert rec["launches"]["flash_decode"] == 0, rec
        rec.update(phase="int8_weights", weight_dtype=wq or "bfloat16",
                   init_s=init_s, projection_bytes=L.projection_bytes(model),
                   projection_bytes_bf16=bf16_bytes if wq is None
                   else legs["bf16_weights"]["projection_bytes"],
                   leg_s=time.perf_counter() - t0,
                   memory_allocated_gb=torch.cuda.memory_allocated() / 1e9,
                   nvidia_smi=smi())
        emit(rec)
        legs[leg] = rec
        for prof in profile_serve(torch, L, eng, cfg,
                                  what=f"llama3_8b {leg}"):
            emit(dict(prof, leg=leg))
        del eng
        free_engines(torch)
    b, q = legs["bf16_weights"], legs["int8_weights"]
    emit(dict(phase="int8_weights", leg="summary",
              config="LlamaConfig.llama3_8b", layers=nl,
              decode_iter_ms=[b["decode_iter_ms_mean"],
                              q["decode_iter_ms_mean"]],
              int8_over_bf16_iter=q["decode_iter_ms_mean"]
              / b["decode_iter_ms_mean"],
              new_tokens_per_s=[b["new_tokens_per_s"],
                                q["new_tokens_per_s"]],
              peak_mem_gb=[b["peak_mem_gb"], q["peak_mem_gb"]],
              projection_gb=[b["projection_bytes"] / 1e9,
                             q["projection_bytes"] / 1e9],
              nvidia_smi=smi()))
    del model
    torch.cuda.empty_cache()
    return legs


def phase_int8_parity(torch, kernels) -> dict:
    """``int8_parity``: llama_small widths at depth 2, f32, TF32 off,
    int8 codes. The paged engine (one slot, so every step's logits row 0
    is the request's) against the int8 model's dense in-model path fed
    the engine's tokens: decode-step logits within ``LOGIT_TOL`` of
    dense, and the greedy stream equal to dense's argmax wherever the
    top-2 gap exceeds 10 × ``LOGIT_TOL``."""
    import dataclasses

    from sparkdl_tpu_torch import GenerationEngine
    from sparkdl_tpu_torch.models import llama as L

    cfg = dataclasses.replace(L.LlamaConfig.small(),
                              num_layers=INT8_PARITY_LAYERS)
    model = L.LlamaModel(cfg, dtype=torch.float32, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    prompts = serve_prompts(torch, cfg, [600, 300, 90, 33], 15)
    new, gate = PARITY_TOKENS, 10 * LOGIT_TOL
    eng = GenerationEngine.from_model(
        model, num_slots=1, max_len=2048, block_size=16, prefill_chunk=256,
        stall_free=False, weight_dtype="int8", device="cuda")
    assert model.weight_quant == "int8"
    steps = []
    real = eng.backend.graphs.get

    def kept(*a, **k):
        out = real(*a, **k)
        steps.append(out[0].clone())
        return out
    eng.backend.graphs.get = kept
    reset_counts(*kernels)
    got, kern = [], []
    for p in prompts:
        steps.clear()
        h = eng.submit(p, max_new_tokens=new)
        eng.run_until_idle()
        got.append(h.result(1))
        kern.append(torch.stack(steps))        # predicts tokens 1..new-1
    launches = read_counts(*kernels)
    assert launches["paged_flash_decode"] == \
        cfg.num_layers * eng.stats["steps"] > 0, launches
    assert launches["flash_attention"] == \
        cfg.num_layers * eng.stats["prefills"], launches
    model.attn_fn = None                       # the dense in-model path
    err, min_gap, flips = 0.0, float("inf"), []
    with torch.no_grad():
        for r, (p, stream, k_logits) in enumerate(zip(prompts, got, kern)):
            seq = torch.tensor([p + stream], device="cuda")
            dense = model(seq)[0, len(p) - 1:len(p) - 1 + new]
            err = max(err, (k_logits - dense[1:]).abs().max().item())
            top2 = dense.topk(2, dim=-1).values
            gaps = (top2[:, 0] - top2[:, 1]).tolist()
            min_gap = min(min_gap, min(gaps))
            for j, t in enumerate(dense.argmax(-1).tolist()):
                if stream[j] != t:
                    assert gaps[j] <= gate, (
                        f"request {r}: engine and dense differ at position "
                        f"{j} with a top-2 gap of {gaps[j]} > {gate}")
                    flips.append(dict(request=r, position=j, gap=gaps[j]))
    assert err <= LOGIT_TOL, f"int8 logits: paged vs dense {err}"
    rec = dict(phase="int8_parity", config="LlamaConfig.small",
               layers=cfg.num_layers, depth_cut="16 -> 2",
               dtype="float32", tf32=False, weight_dtype="int8",
               prompt_lens=[len(p) for p in prompts], new_tokens=new,
               engine="paged, block 16, blocking refill, one slot",
               reference="the int8 model's dense in-model path",
               max_abs_logit_err=err, tol=LOGIT_TOL, near_tie_gate=gate,
               near_ties=flips, min_top2_gap=min_gap, launches=launches)
    emit(rec)
    del eng, model
    free_engines(torch)
    return rec


def phase_draft_registry(torch, kernels) -> dict:
    """``draft_registry``: phase e's llama_small (bf16, seeded) served with
    ``spec_k=4`` and ``DraftModelProvider.from_registry("llama_small")``
    — llama_tiny on the card, seeded, attending densely (its head dim 32
    is not one the kernels take: through them it would raise). The
    draft stands down on any token outside its 512-id vocabulary, so the
    target's ``lm_head`` rows past 512 are zeroed and the prompts drawn
    below 512: the target's stream stays where the draft can read it."""
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.serving import DraftModelProvider

    cfg = L.LlamaConfig.small()
    model = L.LlamaModel(cfg, dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    draft = DraftModelProvider.from_registry(
        "llama_small", device="cuda", dtype=torch.bfloat16, attn_fn=None,
        min_bucket=16)
    dv = draft.model.cfg.vocab_size
    assert draft.model.cfg == L.LlamaConfig.tiny()
    with torch.no_grad():
        model.lm_head.weight[dv:].zero_()
    g = torch.Generator().manual_seed(16)
    prompts = [torch.randint(1, dv, (n,), generator=g).tolist()
               for n in (200, 120, 64, 33)]
    rec, eng = serve_leg(torch, model, kernels, leg="draft_registry",
                         prompts=prompts, spec_k=4, draft_provider=draft,
                         block_size=16, prefill_chunk=256)
    assert rec["spec_verifies"] >= 1, rec
    assert rec["launches"]["paged_flash_decode"] == \
        cfg.num_layers * rec["steps"], rec
    rec.update(phase="draft_registry", draft="llama_tiny (registry pairing "
               "of llama_small)", draft_attn="dense (head dim 32)",
               target_lm_head_rows_zeroed=f"{dv}..{cfg.vocab_size - 1}",
               accepted_draft_tokens=rec["spec_tokens_accepted"])
    emit(rec)
    del eng, model, draft
    free_engines(torch)
    return rec


def readme_prompts(text: str, n: int, seed: int) -> list:
    """``n`` seeded prompts from ``text``: runs of 3–40 words starting at
    a random word (whitespace kept as written)."""
    import random
    import re

    words = [m.group() for m in re.finditer(r"\s*\S+", text)]
    rnd = random.Random(seed)
    out = []
    for _ in range(n):
        k = rnd.randint(3, 40)
        i = rnd.randrange(0, len(words) - k)
        out.append("".join(words[i:i + k]).lstrip())
    return out


def phase_tokenizer(torch, kernels) -> dict:
    """``tokenizer``: a ``ByteBPETokenizer`` trained here on the repo's
    README.md (vocab ``TOKENIZER_VOCAB``), 256 prompts from it encoded,
    run through ``udf.generate_rows`` — the per-chunk device step of
    ``registerTextGenerationUDF`` (no DataFrame: the card path runs
    without pyarrow) — on llama_small, bf16, in chunks of 64 left-padded
    to the column's longest prompt, then decoded."""
    from sparkdl_tpu_torch.models import ByteBPETokenizer
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.udf import generate_rows

    text = (ROOT / "README.md").read_text()
    t0 = time.perf_counter()
    tok = ByteBPETokenizer.train([text], vocab_size=TOKENIZER_VOCAB)
    train_s = time.perf_counter() - t0
    cfg = L.LlamaConfig.small()
    assert tok.vocab_size <= cfg.vocab_size
    rows = readme_prompts(text, TOKENIZER_ROWS, 17)
    t0 = time.perf_counter()
    ids = [tok.encode(r) for r in rows]
    encode_s = time.perf_counter() - t0
    for r, i in zip(rows, ids):
        assert tok.decode(i) == r, r
    model = L.LlamaModel(cfg, dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    max_len = max(len(i) for i in ids)
    generate_rows(model, ids[:2], max_len, 2)   # warm-up, outside the count
    torch.cuda.synchronize()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    outs, chunks = [], 0
    for c in range(0, len(ids), TOKENIZER_CHUNK):
        outs += generate_rows(model, ids[c:c + TOKENIZER_CHUNK], max_len,
                              TOKENIZER_NEW)
        chunks += 1
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    launches = read_counts(*kernels)
    t0 = time.perf_counter()
    texts = [tok.decode(o[len(i):]) for o, i in zip(outs, ids)]
    decode_s = time.perf_counter() - t0
    nl = cfg.num_layers
    assert launches["flash_attention"] == nl * chunks, launches
    assert launches["flash_decode"] == nl * chunks * TOKENIZER_NEW, launches
    for o, i in zip(outs, ids):
        assert o[:len(i)] == i and len(o) == len(i) + TOKENIZER_NEW
    assert all(isinstance(t, str) for t in texts)
    rec = dict(phase="tokenizer", corpus="README.md",
               corpus_bytes=len(text.encode()), vocab=tok.vocab_size,
               merges=len(tok.merges), train_s=train_s,
               config="LlamaConfig.small", dtype="bfloat16", layers=nl,
               rows=len(rows), chunk_rows=TOKENIZER_CHUNK, chunks=chunks,
               padded_len=max_len, new_tokens=TOKENIZER_NEW,
               bytes_per_token=sum(len(r.encode()) for r in rows)
               / sum(len(i) for i in ids),
               round_trip_equal=len(rows),
               tokenizer_ms=(encode_s + decode_s) * 1e3,
               encode_ms=encode_s * 1e3, decode_ms=decode_s * 1e3,
               device_ms=device_s * 1e3,
               rows_per_s=len(rows) / (device_s + encode_s + decode_s),
               launches=launches, first_completion=texts[0][:80])
    emit(rec)
    del model
    torch.cuda.empty_cache()
    return rec


def phase_n(torch, kernels) -> dict:
    """Phase n: int8-weight serving of llama3_8b, its parity at depth 2,
    the registry-paired draft and the in-repo tokenizer."""
    return dict(int8_weights=phase_int8_weights(torch, kernels),
                int8_parity=phase_int8_parity(torch, kernels),
                draft_registry=phase_draft_registry(torch, kernels),
                tokenizer=phase_tokenizer(torch, kernels))


# phase o: the serving fleet. FLEET_REPLICAS replicas over one model, each
# FLEET_SLOTS slots of FLEET_MAX_LEN, pool blocks of 16, the radix prefix
# cache, chunks of FLEET_CHUNK where the prefill is chunked; FLEET_FAMILIES prefix families of FLEET_FAMILY_SIZE requests, each
# family on its own FLEET_HEAD-token head, tails of FLEET_TAILS tokens drawn
# from seed 15 (prompts 576-1536), FLEET_NEW new tokens each, greedy
FLEET_REPLICAS, FLEET_SLOTS, FLEET_MAX_LEN, FLEET_CHUNK = 3, 8, 4096, 256
FLEET_FAMILIES, FLEET_FAMILY_SIZE, FLEET_HEAD = 4, 6, 512
FLEET_TAILS, FLEET_NEW = (64, 1024), 64
FLEET_PARITY_LAYERS = 2        # fleet_parity: llama_small widths, depth 2
# fleet_failover / fleet_parity: the last request is held back; after
# FLEET_KILL_AFTER inline fleet steps its routing decision kills (chaos
# replica_dead at fleet_route) the replica it would choose, and
# FLEET_DOOM_AFTER steps later the busiest survivor is doomed
FLEET_KILL_AFTER, FLEET_DOOM_AFTER = 12, 8
FLEET_SLO_TTFT_S = 10.0        # fleet_threaded: the armed TTFT objective
FLEET_SWITCH_S = 5e-4          # fleet_threaded's second run: switch interval
FLEET_WAIT_S = 600.0           # the longest any wait on the fleet may take


def fleet_prompts(torch, cfg) -> list:
    g = torch.Generator().manual_seed(15)
    n = FLEET_FAMILIES * FLEET_FAMILY_SIZE
    tails = torch.randint(FLEET_TAILS[0], FLEET_TAILS[1] + 1, (n,),
                          generator=g).tolist()
    return serve_prompts(torch, cfg, [FLEET_HEAD + t for t in tails], 15,
                         head_len=FLEET_HEAD, families=FLEET_FAMILIES)


def fleet_engine(model, stall_free: bool = False):
    """One replica: a paged engine over ``model``, which it does not
    copy."""
    from sparkdl_tpu_torch import GenerationEngine

    return GenerationEngine.from_model(
        model, num_slots=FLEET_SLOTS, max_len=FLEET_MAX_LEN, block_size=16,
        prefill_chunk=FLEET_CHUNK, stall_free=stall_free, device="cuda")


def fleet_engines(model, stall_free: bool = False) -> tuple:
    """FLEET_REPLICAS replicas and, for each, the list its decode
    iterations' host times land in."""
    engines, timers = [], []
    for _ in range(FLEET_REPLICAS):
        eng = fleet_engine(model, stall_free)
        iter_s = []

        def timed(*a, _fn=eng.backend.step, _acc=iter_s, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)  # returns host tokens: the device is done
            _acc.append(time.perf_counter() - t0)
            return out
        eng.backend.step = timed
        engines.append(eng)
        timers.append(iter_s)
    return engines, timers


def fleet_transitions() -> tuple:
    """A flight-recorder tee collecting the fleet's health transitions
    (``fleet_replica_*`` events), and the list it fills."""
    seen = []

    def tee(rec):
        if str(rec.get("name", "")).startswith("fleet_replica_"):
            seen.append((rec["name"].removeprefix("fleet_replica_"),
                         rec.get("replica")))
    return tee, seen


def fleet_serve(torch, fleet, prompts, kernels, *, failover: bool) -> dict:
    """Drive ``fleet`` inline: every prompt submitted at once (the last one
    held back when ``failover``: see FLEET_KILL_AFTER), every streamed
    token recorded with its time, then stepped to idle. The launch counts
    are set to 0 just before and read just after."""
    from sparkdl_tpu_torch.runner import chaos, events
    from sparkdl_tpu_torch.serving import DEAD, HEALTHY

    streams: dict = {}

    def cb(fr, tok):
        streams.setdefault(fr.id, []).append((time.perf_counter(), tok))

    tee, transitions = fleet_transitions()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events.add_tee(tee)
    if failover:
        chaos.install(chaos.FaultPlan([chaos.Fault(
            site="fleet_route", kind="replica_dead", at_step=len(prompts))]))
    out: dict = {}
    try:
        reset_counts(*kernels)
        t0 = time.perf_counter()
        frs = [fleet.submit(p, FLEET_NEW, stream_cb=cb)
               for p in (prompts[:-1] if failover else prompts)]
        out["placed"] = [fr.replica for fr in frs]
        if failover:
            for _ in range(FLEET_KILL_AFTER):
                fleet.step()
            home = {fr.id: fr.replica for fr in frs}
            delivered = {fr.id: fr.delivered for fr in frs}
            t_kill = time.perf_counter()
            frs.append(fleet.submit(prompts[-1], FLEET_NEW, stream_cb=cb))
            out["placed"].append(frs[-1].replica)
            dead = [r for r in fleet.replica_names()
                    if fleet.replica_state(r) == DEAD]
            assert len(dead) == 1, dead
            hit = [i for i, r in home.items() if r == dead[0]]
            assert hit and max(delivered[i] for i in hit) > 0, (
                "the kill must land on a replica streaming requests",
                home, delivered)
            hop_at = {i: delivered[i] for i in hit}
            for _ in range(FLEET_DOOM_AFTER):
                fleet.step()
            reps = fleet.debug_state()["replicas"]
            live = [r for r in reps if reps[r]["state"] == HEALTHY]
            doomed = max(live, key=lambda r: (reps[r]["load"], r))
            for fr in frs:
                if fr.replica == doomed:
                    hop_at.setdefault(fr.id, fr.delivered)
            fleet.doom_replica(doomed, "chip_smoke fleet_failover")
            out.update(killed=dead[0], doomed=doomed,
                       killed_requests=len(hit),
                       killed_delivered=[delivered[i] for i in hit],
                       hop_at=[hop_at.get(fr.id) for fr in frs])
        fleet.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(*kernels)
    finally:
        chaos.uninstall()
        events.remove_tee(tee)
    results = [fr.result(FLEET_WAIT_S) for fr in frs]
    for fr in frs:  # the exactly-once audit
        assert [t for _, t in streams.get(fr.id, [])] == fr.tokens, fr
        assert fr.delivered == len(fr.tokens) == FLEET_NEW, fr
    if failover:
        firsts = [t for i in hit for t, _ in streams[i][delivered[i]:]]
        assert firsts, "no killed request was re-admitted"
        out["recovery_s"] = min(firsts) - t_kill
    out.update(frs=frs, results=results, wall=wall, launches=launches,
               transitions=transitions)
    return out


def fleet_record(torch, fleet, timers, run: dict, *, leg: str, model,
                 config: str) -> dict:
    """The leg's JSON line from a finished :func:`fleet_serve` run."""
    frs, names = run["frs"], fleet.replica_names()
    stats = [fleet.engine(n).stats for n in names]
    ttft = sorted(fr.t_first_token - fr.t_submit for fr in frs)
    iters = [1e3 * sum(t) / max(len(t), 1) for t in timers]
    prefix = [fleet.engine(n).backend.prefix_stats() or {} for n in names]
    n_new = sum(len(r) for r in run["results"])
    return dict(
        phase="fleet", leg=leg, config=config,
        dtype=str(model.dtype).replace("torch.", ""),
        layers=model.cfg.num_layers, replicas=len(names),
        num_slots=FLEET_SLOTS, max_len=FLEET_MAX_LEN, requests=len(frs),
        families=FLEET_FAMILIES,
        prompt_lens=[min(len(fr.prompt) for fr in frs),
                     max(len(fr.prompt) for fr in frs)],
        new_tokens=n_new, wall_s=run["wall"],
        new_tokens_per_s=n_new / run["wall"],
        ttft_p50_s=ttft[len(ttft) // 2],
        ttft_p95_s=ttft[max(0, -(-95 * len(ttft) // 100) - 1)],
        decode_iter_ms_mean=dict(zip(names, iters)),
        placements={n: run["placed"].count(n) for n in names},
        steps=[s["steps"] for s in stats],
        prefills=[s["prefills"] for s in stats],
        prefill_chunks=[s["prefill_chunks"] for s in stats],
        failovers=[s["failovers"] for s in stats],
        prefix_reused_tokens=sum(p.get("reused_tokens", 0) for p in prefix),
        prefix_hits=sum(p.get("hits", 0) for p in prefix),
        prefix_misses=sum(p.get("misses", 0) for p in prefix),
        request_reused_tokens=sum(getattr(fr._primary, "prefill_reused", 0)
                                  for fr in frs),
        graphs=[fleet.engine(n).backend.graphs.snapshot() for n in names],
        fleet_stats=dict(fleet.stats), transitions=run["transitions"],
        states={n: fleet.replica_state(n) for n in names},
        launches=run["launches"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        nvidia_smi=smi())


def check_fleet_launches(rec: dict, nl: int, *, chunked: bool) -> None:
    """Every decode step of every replica ran paged_flash_decode once a
    layer; every blocking prefill ran flash_attention once a layer (the
    chunked prefill attends densely, as in the reference: none)."""
    got = rec["launches"]
    assert got["paged_flash_decode"] == nl * sum(rec["steps"]) > 0, rec
    if chunked:
        assert got["flash_attention"] == 0 < sum(rec["prefill_chunks"]), rec
    else:
        assert got["flash_attention"] == nl * sum(rec["prefills"]) > 0, rec
        assert sum(rec["prefill_chunks"]) == 0, rec
    assert got["flash_decode"] == 0, rec
    assert sum(rec["failovers"]) == 0, rec  # no engine rebuilt itself


def fleet_gaps(torch, model, prompts, streams, new: int) -> list:
    """The top-2 logit gap, and the bf16 near-tie gate 10 ×
    BF16_LOGIT_RTOL × (1 + max |logit|), at every generated position of
    each stream, from one forward over the finished sequence."""
    out = []
    with torch.no_grad():
        for p, s in zip(prompts, streams):
            logits = model(torch.tensor([p + s], device=model.device))[
                0, len(p) - 1:len(p) - 1 + new].float()
            top2 = logits.topk(2, dim=-1).values
            gate = 10 * BF16_LOGIT_RTOL * (1 + logits.abs().amax(-1))
            out.append(list(zip((top2[:, 0] - top2[:, 1]).tolist(),
                                gate.tolist())))
            del logits
    return out


def fleet_vs_clean(got: list, clean: list, gaps: list, hop_at: list
                   ) -> dict:
    """Each fleet stream against the clean engine's. Up to the position
    where the request first left its replica (``hop_at``; the whole
    stream if it never did) the fleet ran the clean engine's kernels on
    the same shapes, so the streams are equal bitwise. From there (the
    re-admission re-prefills prompt + delivered tokens in one pass) they
    are equal up to the first position whose top-2 gap lies within its
    gate; the positions from that one on are excused."""
    compared = excused = identical = 0
    flips, gap_over_gate = [], []
    for r, (a, b, g, h) in enumerate(zip(got, clean, gaps, hop_at)):
        h = len(b) if h is None else h
        tie = next((j for j, (gap, gate) in enumerate(g)
                    if j >= h and gap <= gate), len(b))
        flip = next((j for j in range(len(b)) if a[j] != b[j]), None)
        identical += flip is None
        assert flip is None or flip >= h, (
            f"request {r}: fleet and clean engine differ at position {flip}"
            f", before it left its replica ({h})")
        assert flip is None or flip >= tie, (
            f"request {r}: fleet and clean engine differ at position {flip}"
            f" before the first near tie ({tie}), gap {g[flip]}")
        compared += tie
        excused += len(b) - tie if flip is not None else 0
        if flip is not None:
            flips.append(dict(request=r, hop_at=h, position=flip,
                              gap=g[flip][0], gate=g[flip][1]))
        gap_over_gate += [gap / gate for gap, gate in g]
    gap_over_gate.sort()
    return dict(positions_compared=compared, positions_excused=excused,
                identical_streams=identical, flips=flips,
                gap_over_gate_median=gap_over_gate[len(gap_over_gate) // 2],
                gap_over_gate_share_above_1=sum(
                    x > 1 for x in gap_over_gate) / len(gap_over_gate))


def phase_fleet(torch, kernels) -> dict:
    """Phase o's legs on llama3_8b: ``fleet_radix``,
    ``fleet_round_robin``, ``fleet_failover`` and ``fleet_threaded``; then
    ``fleet_parity`` on llama_small at depth 2."""
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.serving import EngineFleet

    cfg = L.LlamaConfig.llama3_8b()
    nl, config = cfg.num_layers, "LlamaConfig.llama3_8b"
    t0 = time.perf_counter()
    model = L.LlamaModel(cfg, dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model_gb = torch.cuda.memory_allocated() / 1e9
    prompts = fleet_prompts(torch, cfg)
    legs = {}

    def leg(name, routing="radix", stall_free=False, failover=False):
        engines, timers = fleet_engines(model, stall_free)
        fleet = EngineFleet(engines, routing=routing, min_replicas=1)
        run = fleet_serve(torch, fleet, prompts, kernels, failover=failover)
        rec = fleet_record(torch, fleet, timers, run, leg=name, model=model,
                           config=config)
        rec.update(routing=routing, init_s=init_s,
                   prefill=f"chunked, {FLEET_CHUNK}" if stall_free
                   else "blocking")
        check_fleet_launches(rec, nl, chunked=stall_free)
        legs[name] = rec
        return rec, run, fleet

    rec, run, fleet = leg("fleet_radix")
    assert rec["transitions"] == [], rec  # nobody was told to change
    emit(rec)
    del run, fleet
    free_engines(torch)
    # The blocking refill never radix-shares (its left-padded rows are not
    # block-aligned, in the reference too), so the routing policies are
    # compared where the radix cache serves: the chunked prefill.
    for name, routing in (("fleet_radix_chunked", "radix"),
                          ("fleet_round_robin", "round_robin")):
        rec, run, fleet = leg(name, routing, stall_free=True)
        assert rec["transitions"] == [], rec
        emit(rec)
        del run, fleet
        free_engines(torch)
    radix, rr = legs["fleet_radix_chunked"], legs["fleet_round_robin"]
    assert radix["request_reused_tokens"] > rr["request_reused_tokens"], (
        radix["request_reused_tokens"], rr["request_reused_tokens"])

    rec, run, fleet = leg("fleet_failover", failover=True)
    st = rec["fleet_stats"]
    assert st["replica_deaths"] == 1 and st["drains"] == 1, st
    assert st["readmissions"] >= run["killed_requests"], st
    eng = fleet_engine(model)  # the clean reference: one engine, no fault
    hs = [eng.submit(p, max_new_tokens=FLEET_NEW) for p in prompts]
    eng.run_until_idle()
    ref = [h.result(FLEET_WAIT_S) for h in hs]
    del hs, eng
    free_engines(torch)
    rec.update(fleet_vs_clean(run["results"], ref, fleet_gaps(
        torch, model, prompts, ref, FLEET_NEW), run["hop_at"]))
    rec.update(recovery_s=run["recovery_s"], killed=run["killed"],
               doomed=run["doomed"], killed_requests=run["killed_requests"],
               killed_delivered=run["killed_delivered"],
               resume_prefill="blocking (flash_attention)"
               if sum(rec["prefill_chunks"]) == 0 else "chunked")
    emit(rec)
    del run, fleet
    free_engines(torch)

    # then the same with a 0.5 ms switch interval: whether the threads
    # wait on one another for the GIL
    for switch_s in (None, FLEET_SWITCH_S):
        threaded = fleet_threaded(torch, model, prompts, kernels, nl,
                                  switch_s)
        threaded.update(init_s=init_s, inline_new_tokens_per_s=legs[
            "fleet_radix"]["new_tokens_per_s"],
            inline_decode_iter_ms_mean=legs["fleet_radix"][
                "decode_iter_ms_mean"])
        emit(threaded)
        legs[threaded["leg"]] = threaded
        free_engines(torch)
    left_gb = torch.cuda.memory_allocated() / 1e9
    # every leg's engines (a dead replica's pool and graphs too) are gone
    assert left_gb - model_gb < 1.0, (left_gb, model_gb)
    del model
    free_engines(torch)
    legs["fleet_parity"] = fleet_parity(torch, kernels)
    return legs


def fleet_threaded(torch, model, prompts, kernels, nl: int,
                   switch_s: float | None = None) -> dict:
    """``fleet_threaded``: the radix fleet driven by ``fleet.start()``
    (three engine threads and the supervisor's on one card) with the
    telemetry plane armed on port 0 and a TTFT objective; its four HTTP
    routes scraped over HTTP. ``switch_s``: the interpreter's thread
    switch interval for the run (``sys.setswitchinterval``; None keeps
    the default 5 ms) — how long a thread back from the card may wait
    for another thread to hand over the GIL."""
    import os
    import urllib.request

    from sparkdl_tpu_torch.runner import events, slo, telemetry
    from sparkdl_tpu_torch.serving import EngineFleet

    env = {"SPARKDL_SLO_TTFT_S": str(FLEET_SLO_TTFT_S),
           "SPARKDL_TRACE_SLOWEST": str(len(prompts))}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    slo.reset()
    telemetry.reset()
    tee, transitions = fleet_transitions()
    streams: dict = {}
    fleet, stopped = None, False
    interval = sys.getswitchinterval()
    if switch_s is not None:
        sys.setswitchinterval(switch_s)
    try:
        telemetry.start(port=0)
        port = telemetry.server_port()
        assert port, "the telemetry endpoint did not bind"

        def get(route):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                        timeout=60) as resp:
                assert resp.status == 200, route
                return resp.read().decode()

        engines, timers = fleet_engines(model)
        fleet = EngineFleet(engines, min_replicas=1)
        get("/metrics.json")  # the SLO monitor's baseline, before traffic
        events.add_tee(tee)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        t0 = time.perf_counter()
        fleet.start()
        frs = [fleet.submit(p, FLEET_NEW, stream_cb=lambda fr, t:
                            streams.setdefault(fr.id, []).append(t))
               for p in prompts]
        placed = [fr.replica for fr in frs]
        live = json.loads(get("/serving"))  # mid-run
        for fr in frs:
            assert fr.wait(FLEET_WAIT_S), f"{fr} not done"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prom = get("/metrics")
        snap = json.loads(get("/metrics.json"))
        health = json.loads(get("/healthz"))
        serving = json.loads(get("/serving"))
        fleet.stop(drain=True, timeout=60)
        stopped = True
        launches = read_counts(*kernels)
    finally:
        events.remove_tee(tee)
        if fleet is not None and not stopped:
            fleet.stop(drain=False, timeout=60)
        sys.setswitchinterval(interval)
        telemetry.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        slo.reset()
        telemetry.reset()
    run = dict(frs=frs, results=[fr.result(1) for fr in frs], wall=wall,
               launches=launches, transitions=transitions, placed=placed)
    for fr in frs:  # the exactly-once audit
        assert streams.get(fr.id) == fr.tokens, fr
        assert fr.delivered == len(fr.tokens) == FLEET_NEW, fr
    leg = "fleet_threaded" if switch_s is None else \
        f"fleet_threaded_switch_{switch_s * 1e3:g}ms"
    rec = fleet_record(torch, fleet, timers, run, leg=leg, model=model,
                       config="LlamaConfig.llama3_8b")
    check_fleet_launches(rec, nl, chunked=False)
    for g, steps in zip(rec["graphs"], rec["steps"]):
        assert g["captures"] == 1 and g["replays"] == steps - 1, rec
    # the four routes: Prometheus text with the fleet's and the engines'
    # metrics, the JSON snapshot with every request's trace and the SLO
    # block, the inspector with one fleet of three replicas, liveness
    assert "sparkdl_fleet_replicas_healthy" in prom, prom[-2000:]
    assert "sparkdl_serving_ttft_s_bucket" in prom, prom[-2000:]
    tr = snap["request_traces"]
    assert tr["completed"] == len(prompts) == len(tr["slowest"]), tr
    worst = 0.0
    for t in tr["slowest"]:
        parts = (t["queue_s"] + t["prefill_s"] + t["prefill_wait_s"]
                 + t["decode_s"] + t["unattributed_s"])
        assert abs(parts - t["latency_s"]) <= 1e-4, t
        assert abs(t["unattributed_s"]) <= 0.05 * t["latency_s"], (
            t, transitions, rec["fleet_stats"])
        worst = max(worst, abs(t["unattributed_s"]) / t["latency_s"])
    ttft_slo = snap["slo"]["objectives"]["ttft"]
    assert ttft_slo["compliance"] is not None, snap["slo"]
    for view in (live, serving):
        assert view["n_fleets"] == 1, view.get("fleets")
        assert len(view["fleets"][0]["replicas"]) == FLEET_REPLICAS, view
    assert health["status"] == "ok", health
    rec.update(
        drive="fleet.start() / stop(drain=True): 3 engine threads and "
              "the supervisor",
        plane="telemetry.start(port=0), SPARKDL_SLO_TTFT_S="
              f"{FLEET_SLO_TTFT_S:g}",
        routing="radix", prefill="blocking",
        switch_interval_s=switch_s or interval, traces=tr["completed"], unattributed_max_share=worst,
        trace_phases_dominant=sorted({t["dominant_phase"]
                                      for t in tr["slowest"]}),
        slo_ttft=dict(compliance=ttft_slo["compliance"],
                      burn_rate=ttft_slo["burn_rate"],
                      breaching=ttft_slo["breaching"]),
        prometheus_fleet_lines=[ln for ln in prom.splitlines()
                                if ln.startswith("sparkdl_fleet_")],
        serving_replicas={n: r["state"] for n, r in
                          serving["fleets"][0]["replicas"].items()},
        healthz=health)
    return rec


def fleet_parity(torch, kernels) -> dict:
    """``fleet_parity``: llama_small widths at depth FLEET_PARITY_LAYERS,
    f32, TF32 off; fleet_failover's fleet, traffic, kill and doom. Every
    stream token for token a clean single engine's."""
    import dataclasses

    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.serving import EngineFleet

    cfg = dataclasses.replace(L.LlamaConfig.small(),
                              num_layers=FLEET_PARITY_LAYERS)
    model = L.LlamaModel(cfg, dtype=torch.float32, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    prompts = fleet_prompts(torch, cfg)
    engines, timers = fleet_engines(model)
    fleet = EngineFleet(engines, min_replicas=1)
    run = fleet_serve(torch, fleet, prompts, kernels, failover=True)
    rec = fleet_record(torch, fleet, timers, run, leg="fleet_parity",
                       model=model, config="LlamaConfig.small")
    check_fleet_launches(rec, cfg.num_layers, chunked=False)
    st = rec["fleet_stats"]
    assert st["replica_deaths"] == 1 and st["drains"] == 1, st
    del fleet, run["frs"]
    free_engines(torch)
    eng = fleet_engine(model)
    hs = [eng.submit(p, max_new_tokens=FLEET_NEW) for p in prompts]
    eng.run_until_idle()
    ref = [h.result(FLEET_WAIT_S) for h in hs]
    for r, (a, b) in enumerate(zip(run["results"], ref)):
        assert a == b, (f"request {r}: the fleet's f32 stream differs from "
                        f"the clean engine's at position "
                        f"{next(j for j in range(len(b)) if a[j] != b[j])}")
    rec.update(depth_cut=f"{L.LlamaConfig.small().num_layers} -> "
                         f"{FLEET_PARITY_LAYERS}", tf32=False,
               identical_streams=len(ref), recovery_s=run["recovery_s"],
               killed=run["killed"], doomed=run["doomed"],
               killed_requests=run["killed_requests"],
               killed_delivered=run["killed_delivered"],
               reference="one clean engine, the same prompts, no fault")
    emit(rec)
    del eng, hs, model
    free_engines(torch)
    return rec


# phase p: the flight recorder and data plane on the card. resnet_chaos:
# phase k's bf16 ResNet-50 recipe (256 a batch at 224², sgd(0.1, momentum
# 0.9)) over FR_BATCHES seeded wire batches (a looping ListDataset, so fit
# keeps a cursor); FR_OVERHEAD_ARMS fits of FR_BATCHES steps, recorder off
# and on in turn; checkpoints every FR_CKPT_EVERY steps, a preemption at
# step FR_PREEMPT_AT, a rollback fit to FR_ROLLBACK_STEPS, a NaN batch at
# step FR_NAN_AT (float32 images: ``nan`` poisons float leaves only).
# lora_recorder: phase m's LoRA model (llama3_8b widths at DP_LORA_LAYERS
# layers), phase g's batch, FR_LORA_STEPS steps a fit.
FR_BATCHES, FR_CKPT_EVERY, FR_PREEMPT_AT = 12, 4, 6
FR_ROLLBACK_STEPS, FR_NAN_AT, FR_LORA_STEPS = 16, 2, 6
FR_OVERHEAD_ARMS = ("off", "on", "off", "on")
# the env knobs phase p arms, each to its own subdirectory
FR_ENV = {"SPARKDL_EVENT_DIR": "events", "SPARKDL_BATCH_LEDGER": "ledger",
          "SPARKDL_HEARTBEAT_DIR": "heartbeat",
          "SPARKDL_METRICS_DIR": "metrics"}
# memory phase p may leave allocated beyond what it found, bytes, with
# cuBLAS's workspaces (2 × 32 MiB on an H100, kept once made) released
# before both readings
FR_MEMORY_SLACK = 4 << 20


def recorder_env(root) -> dict:
    """Arm the flight recorder's stream, the batch ledger, the heartbeat
    and the telemetry plane's snapshots under ``root`` (a subdirectory
    each; ``fit`` arms the plane itself), or with ``root`` None disarm
    them; a fresh recorder and a stopped plane either way. Returns the
    directories."""
    import os

    from sparkdl_tpu_torch.runner import events, telemetry

    dirs = {}
    for k, sub in FR_ENV.items():
        if root is None:
            os.environ.pop(k, None)
        else:
            dirs[k] = os.environ[k] = os.path.join(root, sub)
    telemetry.reset()
    events.reset()
    return dirs


def fr_resnet_main(torch, spec, batches, steps: int, stamps: list,
                   built: list, **kw):
    """``main_fn`` for ``XlaRunner.run`` / ``run_with_restarts``: a fresh
    bf16 ResNet-50 (seed 0) each call, then phase k's fit over
    ``batches`` (a looping ``ListDataset``) with ``log_every=1``; the loss
    stamps ``time.time()`` at each call and ``built`` gets the time the
    model was ready."""
    from sparkdl_tpu_torch.runner import (ListDataset, bn_classifier_loss,
                                          sgd)

    loss_fn = bn_classifier_loss(preprocess=resnet_preprocess(spec))

    def stamped(m, batch):
        stamps.append(time.time())
        return loss_fn(m, batch)

    def main(ctx):
        model = spec.build(dtype=torch.bfloat16, num_classes=1000, seed=0,
                           device="cuda")
        torch.cuda.synchronize()
        built.append(time.time())
        return ctx.fit(loss_fn=stamped, model=model,
                       tx=sgd(RESNET_LR, momentum=0.9),
                       data=ListDataset(list(batches), epochs=None),
                       num_steps=steps, log_every=1, mutable=True, **kw)

    return main


def _ring(name: str, since: float = 0.0) -> list:
    from sparkdl_tpu_torch.runner import events

    return [e for e in events.get_recorder().tail()
            if e["name"] == name and e["t"] >= since]


def _float_state(model) -> dict:
    return {k: v.detach().float().cpu()
            for k, v in model.state_dict().items() if v.is_floating_point()}


def _stream_size(path: str) -> tuple:
    """(lines, bytes) of a JSONL file (0, 0 when absent)."""
    import os

    if not os.path.exists(path):
        return 0, 0
    with open(path, "rb") as f:
        data = f.read()
    return data.count(b"\n"), len(data)


def resnet_chaos(torch, root: str) -> dict:
    """Phase p, ``resnet_chaos`` (module docstring)."""
    import gc
    import json
    import os

    import numpy as np

    from sparkdl_tpu_torch.models.registry import get_model
    from sparkdl_tpu_torch.runner import (Fault, FaultPlan,
                                          TrainingDivergedError, XlaRunner,
                                          chaos, events, metrics)
    from sparkdl_tpu_torch.runner.data import read_ledger

    spec = get_model("ResNet50")
    wire = resnet_wire(FR_BATCHES, RESNET_BATCH, RESNET_SIZE, seed=44)
    before = _float_state(spec.build(dtype=torch.bfloat16, num_classes=1000,
                                     seed=0))
    metrics.run_stats.reset()

    # the overhead: the same 12 steps with everything off and on, in turn
    arms, streamed = [], None
    for n, arm in enumerate(FR_OVERHEAD_ARMS):
        gc.collect()
        torch.cuda.empty_cache()
        dirs = recorder_env(os.path.join(root, f"overhead{n}")
                            if arm == "on" else None)
        stamps, built = [], []
        res = XlaRunner(np=1).run(fr_resnet_main(
            torch, spec, wire, FR_BATCHES, stamps, built))
        torch.cuda.synchronize()
        stamps.append(time.time())
        step_s = [b - a for a, b in zip(stamps, stamps[1:])]
        line = step_line(step_s, 1)
        losses = [h["loss"] for h in res["history"]]
        assert len(losses) == FR_BATCHES and all(map(math.isfinite, losses))
        if arm == "on":
            ev = os.path.join(dirs["SPARKDL_EVENT_DIR"], "events_rank0.jsonl")
            lines, nbytes = _stream_size(ev)
            hb = os.path.join(dirs["SPARKDL_HEARTBEAT_DIR"], "rank0.hb")
            with open(hb) as f:
                assert events.parse_heartbeat_body(f.read())["step"] == \
                    FR_BATCHES - 1
            led = read_ledger(dirs["SPARKDL_BATCH_LEDGER"])
            assert [(e["step"], e["batch_index"]) for e in led] == \
                [(i, i) for i in range(FR_BATCHES)]
            streamed = dict(events_per_step=lines / FR_BATCHES,
                            bytes_per_step=nbytes / FR_BATCHES)
        else:
            uninterrupted = _float_state(res["state"].model)
        arms.append(dict(arm=arm, losses=losses, **line))
        del res
    recorder_env(None)
    off = [a["step_ms_median"] for a in arms if a["arm"] == "off"]
    on = [a["step_ms_median"] for a in arms if a["arm"] == "on"]
    assert [a["losses"] for a in arms[1:]] == [arms[0]["losses"]] * 3, \
        "the recorder changed the losses"

    # parts a-c under one recorder directory
    dirs = recorder_env(os.path.join(root, "chaos"))
    ckpt = os.path.join(root, "ckpt")
    runner = XlaRunner(np=1, checkpoint_dir=ckpt)

    # a. a preemption at step 6, one restart, the resume at step 4
    chaos.install(FaultPlan([Fault("step_start", "preempt",
                                   at_step=FR_PREEMPT_AT)]))
    chaos.announce_injection(f"a preemption at step {FR_PREEMPT_AT} "
                             "(phase p, resnet_chaos part a)")
    stamps, built = [], []
    try:
        res = runner.run_with_restarts(
            fr_resnet_main(torch, spec, wire, FR_BATCHES, stamps, built,
                           checkpoint_every=FR_CKPT_EVERY),
            max_restarts=2, backoff_s=0.0)
    finally:
        chaos.uninstall()
    torch.cuda.synchronize()
    resumed_at = FR_PREEMPT_AT // FR_CKPT_EVERY * FR_CKPT_EVERY
    assert len(built) == 2 and metrics.run_stats.restarts == 1
    assert res["state"].step == FR_BATCHES
    assert res["meter"].steps == FR_BATCHES - resumed_at
    restart_t = _ring("restart")[-1]["t"]
    resume = [e for e in _ring("train_resume") if e["t"] >= restart_t]
    assert resume and resume[0]["step"] == resumed_at, resume
    led = read_ledger(dirs["SPARKDL_BATCH_LEDGER"])
    pairs = [(e["step"], e["batch_index"]) for e in led]
    assert pairs == [(i, i) for i in range(FR_PREEMPT_AT)] + \
        [(i, i) for i in range(resumed_at, FR_BATCHES)], pairs
    last = {}
    for e in led:
        last[e["step"]] = e["batch_index"]
    exactly_once = sorted(last.items()) == [(i, i)
                                            for i in range(FR_BATCHES)]
    assert exactly_once
    # the first resumed step's loss call is stamps[FR_PREEMPT_AT]; the next
    # call follows its loss read (log_every=1), the step done
    restart_s = stamps[FR_PREEMPT_AT + 1] - restart_t
    restore_after_restart_s = resume[0]["t"] - built[1]
    compile_s = [e["dur_s"] for e in _ring("compile", restart_t)][0]
    shares = _update_shares(_float_state(res["state"].model), uninterrupted,
                            before)
    assert shares[0] <= RESNET_PARITY_PARAM_SHARE, shares
    assert shares[1] <= RESNET_PARITY_STAT_SHARE, shares
    del res

    # b. the newest checkpoint (12) corrupted; a fit to 16 rolls back to 8
    damaged = chaos.corrupt_latest_checkpoint(ckpt)
    assert damaged
    gc.collect()
    stamps, built = [], []
    t_b = time.time()
    res = runner.run(fr_resnet_main(torch, spec, wire, FR_ROLLBACK_STEPS,
                                    stamps, built,
                                    checkpoint_every=FR_CKPT_EVERY))
    torch.cuda.synchronize()
    rolled = [e for e in _ring("checkpoint_rollback", t_b)]
    assert [(e["from_step"], e["to_step"]) for e in rolled] == \
        [(FR_BATCHES, FR_BATCHES - FR_CKPT_EVERY)], rolled
    assert res["state"].step == FR_ROLLBACK_STEPS
    assert res["meter"].steps == FR_ROLLBACK_STEPS - FR_BATCHES \
        + FR_CKPT_EVERY
    ft = res["meter"].summary()["fault_tolerance"]
    assert ft["checkpoint_rollbacks"] == 1, ft
    rollback_restore_s = _ring("train_resume", t_b)[0]["t"] - built[0]
    del res

    # c. a NaN batch at step 2: diverged, not retried, the postmortem exact
    gc.collect()
    fwire = [dict(b, image=b["image"].astype(np.float32))
             for b in wire[:FR_NAN_AT + 2]]
    chaos.install(FaultPlan([Fault("batch_fetch", "nan",
                                   at_step=FR_NAN_AT)]))
    stamps, built = [], []
    diverged = None
    try:
        XlaRunner(np=1).run_with_restarts(
            fr_resnet_main(torch, spec, fwire, len(fwire), stamps, built),
            max_restarts=2, backoff_s=0.0)
    except TrainingDivergedError as e:
        diverged = e.step
    finally:
        chaos.uninstall()
    assert diverged == FR_NAN_AT + 1 and len(built) == 1, (diverged, built)
    assert metrics.run_stats.last_failure_kind == "fatal"
    with open(os.path.join(dirs["SPARKDL_EVENT_DIR"],
                           "postmortem_rank0.json")) as f:
        pm = json.load(f)
    assert (pm["site"], pm["step"], pm["batch_index"], pm["epoch"]) == \
        ("fit", FR_NAN_AT, FR_NAN_AT, 0), pm
    assert pm["error"]["type"] == "TrainingDivergedError"

    # after a-c: the timeline, the degradations, the snapshot, the beat
    events.get_recorder().close()
    tl = events.merge_timeline(dirs["SPARKDL_EVENT_DIR"],
                               heartbeat_dir=dirs["SPARKDL_HEARTBEAT_DIR"])
    ff = tl["first_failure"]
    assert (tl["first_failing_rank"], ff["site"], ff["step"]) == \
        (0, "batch_fetch", FR_NAN_AT), tl["first_failure"]
    degr = [e["name"] for e in events.collect_degradations(
        dirs["SPARKDL_EVENT_DIR"])]
    assert degr.count("train_resume") == 2 and \
        "checkpoint_rollback" in degr, degr
    snap = os.path.join(dirs["SPARKDL_METRICS_DIR"], "metrics_rank0.json")
    with open(snap) as f:
        snap_keys = sorted(json.load(f))
    with open(os.path.join(dirs["SPARKDL_HEARTBEAT_DIR"], "rank0.hb")) as f:
        beat = events.parse_heartbeat_body(f.read())
    assert beat["step"] == FR_NAN_AT, beat
    recorder_env(None)
    metrics.run_stats.reset()
    rec = dict(
        phase="flight_recorder", arm="resnet_chaos",
        config="BASELINE config 3: ResNet50 bf16, 256 a batch at 224², "
               "np=1", batches=FR_BATCHES, checkpoint_every=FR_CKPT_EVERY,
        restarts=1, resumed_at=resumed_at,
        ledger_exactly_once=exactly_once, ledger_lines=len(led),
        replayed_steps=list(range(resumed_at, FR_PREEMPT_AT)),
        resumed_param_share=shares[0], resumed_stat_share=shares[1],
        restart_to_first_resumed_step_s=restart_s,
        restore_after_restart_s=restore_after_restart_s,
        first_resumed_step_compile_s=compile_s,
        rollback=ft["last_rollback"],
        checkpoint_rollbacks=ft["checkpoint_rollbacks"],
        rollback_restore_s=rollback_restore_s,
        postmortem=dict(site=pm["site"], step=pm["step"],
                        batch_index=pm["batch_index"], epoch=pm["epoch"],
                        error=pm["error"]["type"],
                        events=len(pm["events"])),
        timeline_first_failure=dict(site=ff["site"], step=ff["step"],
                                    error=ff["error"]),
        degradations=sorted(set(degr)), telemetry_snapshot=snap_keys,
        heartbeat_step=beat["step"], **streamed,
        step_ms_off=off, step_ms_on=on,
        overhead_ms=float(np.mean(on) - np.mean(off)),
        overhead_share=float(np.mean(on) / np.mean(off) - 1),
        arms=[{k: v for k, v in a.items() if k != "losses"} for a in arms],
        nvidia_smi=smi())
    emit(rec)
    return rec


def trace_steps(trace: dict, names: tuple) -> dict:
    """From a Chrome trace of a profiled ``fit``: each ``train_step#i``
    range (the CPU annotation) and, a step, how many kernels whose name
    holds each of ``names`` it launched; the device busy share of the
    steps after the first (the union of kernel, copy and set intervals
    over the window from the second step's start to the last device
    activity). A kernel belongs to the step whose range holds its launch,
    joined by the profiler's correlation id; without launch records, to
    the step whose device-side annotation holds it; without those, to
    the step it ran after (``fit(log_every=1)`` waits for each step's
    loss, so a step's kernels end before the next step starts)."""
    evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    steps = sorted((e for e in evs if e.get("cat") == "user_annotation"
                    and e["name"].startswith("train_step#")),
                   key=lambda e: e["ts"])
    dev = [e for e in evs if e.get("cat") in ("kernel", "gpu_memcpy",
                                              "gpu_memset")]
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in evs
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    gpu_ann = {e["name"]: e for e in evs
               if e.get("cat") == "gpu_user_annotation"
               and e["name"].startswith("train_step#")}
    starts = [s["ts"] for s in steps] + [float("inf")]

    def by_launch(i, st):
        return [k for k in kernels
                if st["ts"] <= launch_ts.get(k.get("args", {})
                                             .get("correlation"), -1)
                <= st["ts"] + st["dur"]]

    def by_gpu_annotation(i, st):
        g = gpu_ann.get(st["name"])
        return [] if g is None else [
            k for k in kernels if g["ts"] <= k["ts"] <= g["ts"] + g["dur"]]

    def by_window(i, st):
        return [k for k in kernels if starts[i] <= k["ts"] < starts[i + 1]]

    per_step, joined = [], "none"
    for join in (by_launch, by_gpu_annotation, by_window):
        per_step = [{n: sum(n in k["name"] for k in join(i, st))
                     for n in names} for i, st in enumerate(steps)]
        joined = join.__name__
        if any(any(c.values()) for c in per_step):
            break
    busy = "not measured: no device activity in the trace"
    if len(steps) > 1 and dev:
        t0 = steps[1]["ts"]
        t1 = max(e["ts"] + e["dur"] for e in dev)
        spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                       for e in dev if e["ts"] + e["dur"] > t0)
        covered, cur_lo, cur_hi = 0.0, None, None
        for a, b in spans:
            if cur_hi is None or a > cur_hi:
                if cur_hi is not None:
                    covered += cur_hi - cur_lo
                cur_lo, cur_hi = a, b
            else:
                cur_hi = max(cur_hi, b)
        if cur_hi is not None:
            covered += cur_hi - cur_lo
        busy = dict(share=covered / (t1 - t0),
                    busy_ms_per_step=covered / 1e3 / (len(steps) - 1),
                    window_ms=(t1 - t0) / 1e3)
    return dict(steps=[s["name"] for s in steps], per_step=per_step,
                joined_by=joined, device_busy=busy)


def lora_recorder(torch, kernels, root: str) -> dict:
    """Phase p, ``lora_recorder`` (module docstring)."""
    import gc
    import json
    import os

    import numpy as np

    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.runner import XlaRunner
    from sparkdl_tpu_torch.runner.data import read_ledger

    ids = None
    out = {}
    for arm in ("off", "on", "profiled"):
        gc.collect()
        torch.cuda.empty_cache()
        model = lora_cut_model(torch)
        if ids is None:
            ids = train_ids(torch, model.cfg)
        dirs = recorder_env(None if arm == "off"
                            else os.path.join(root, f"lora_{arm}"))
        prof_dir = os.path.join(root, "lora_trace") if arm == "profiled" \
            else None
        reset_counts(*kernels)
        ctx = XlaRunner(np=1).make_context()
        res, step_s, fit_s = stamped_fit(
            torch, ctx, L.causal_lm_loss_fn(), model,
            L.lora_optimizer(TRAIN_LR), [{"input_ids": ids}] * FR_LORA_STEPS,
            FR_LORA_STEPS, profile_dir=prof_dir)
        launches = read_counts(*kernels)
        nl = model.cfg.num_layers
        assert launches["flash_attention"] == nl * FR_LORA_STEPS, launches
        assert launches["flash_attention_bwd"] == nl * FR_LORA_STEPS, \
            launches
        rec = dict(losses=[h["loss"] for h in res["history"]],
                   launches=launches,
                   launches_per_step={k: v / FR_LORA_STEPS
                                      for k, v in launches.items()},
                   fit_s=fit_s, **step_line(step_s, 1))
        if arm != "off":
            led = read_ledger(dirs["SPARKDL_BATCH_LEDGER"])
            assert [e["step"] for e in led] == list(range(FR_LORA_STEPS))
            rec["events_per_step"] = _stream_size(os.path.join(
                dirs["SPARKDL_EVENT_DIR"], "events_rank0.jsonl"))[0] \
                / FR_LORA_STEPS
        if prof_dir:
            path = os.path.join(prof_dir, "trace_rank0.json")
            rec["trace_bytes"] = os.path.getsize(path)
            with open(path) as f:
                tr = trace_steps(json.load(f), ("fa_fwd_tc_kernel",
                                                "fa_bwd_dkdv_tc_kernel",
                                                "fa_bwd_dq_tc_kernel"))
            assert tr["steps"] == [f"train_step#{i}"
                                   for i in range(FR_LORA_STEPS)], tr
            assert all(c == {"fa_fwd_tc_kernel": nl,
                             "fa_bwd_dkdv_tc_kernel": nl,
                             "fa_bwd_dq_tc_kernel": nl}
                       for c in tr["per_step"]), tr["per_step"]
            rec["trace"] = tr
        out[arm] = rec
        del res, model, ctx
    recorder_env(None)
    gc.collect()
    torch.cuda.empty_cache()
    bitwise = out["on"]["losses"] == out["off"]["losses"] == \
        out["profiled"]["losses"]
    assert bitwise, {a: r["losses"] for a, r in out.items()}
    off, on = out["off"]["step_ms_median"], out["on"]["step_ms_median"]
    rec = dict(
        phase="flight_recorder", arm="lora_recorder",
        config=f"BASELINE config 5: LlamaConfig.llama3_8b(lora_rank=16), "
               f"depth cut to {DP_LORA_LAYERS} of 32, bf16",
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=FR_LORA_STEPS,
        losses_bitwise_equal=bitwise, losses=out["off"]["losses"],
        step_ms_off=off, step_ms_on=on,
        step_ms_profiled=out["profiled"]["step_ms_median"],
        overhead_ms=on - off, overhead_share=on / off - 1,
        launches_per_step=out["on"]["launches_per_step"],
        launches={a: r["launches"] for a, r in out.items()},
        events_per_step=out["on"]["events_per_step"],
        trace_bytes=out["profiled"]["trace_bytes"],
        trace_kernels_per_step=out["profiled"]["trace"]["per_step"],
        trace_joined_by=out["profiled"]["trace"]["joined_by"],
        device_busy=out["profiled"]["trace"]["device_busy"],
        arms={a: {k: v for k, v in r.items()
                  if k not in ("losses", "trace", "launches")}
              for a, r in out.items()},
        nvidia_smi=smi())
    emit(rec)
    return rec


def phase_flight_recorder(torch, kernels) -> dict:
    """Phase p: the flight recorder and data plane (module docstring).
    Everything it writes lives in a ``tempfile`` directory; the memory
    allocated on the card must come back to what the phase found. A
    ``summary`` line gives both readings and the phase's seconds."""
    import gc
    import tempfile

    def allocated() -> int:
        gc.collect()
        if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
            torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated()

    mem0 = allocated()
    t0 = time.perf_counter()
    tf32_was = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with tempfile.TemporaryDirectory(prefix="sparkdl_fr_") as root:
            resnet = resnet_chaos(torch, root)
            gc.collect()
            torch.cuda.empty_cache()
            lora = lora_recorder(torch, kernels, root)
    finally:
        recorder_env(None)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32_was
    seconds = time.perf_counter() - t0
    mem1 = allocated()
    emit(dict(phase="flight_recorder", arm="summary", seconds=seconds,
              memory_allocated_before=mem0, memory_allocated_after=mem1))
    assert mem1 <= mem0 + FR_MEMORY_SLACK, (mem0, mem1)
    return dict(resnet_chaos=resnet, lora_recorder=lora)


# phase q: the gang supervisor (``launcher.supervise``) over a one-rank
# NCCL gang. ResNet-50 (config 3): phase p's 12 batches, a checkpoint
# every 4 steps, a SIGKILL or a hang at step 6; BERT-base (config 4):
# phase h's first 8 batches, a checkpoint every 2 steps, a SIGKILL at step
# 5. The watchdog's limit lies far above the longest gap between two
# beats (the first step of a new process pays cuDNN's plans, a step that
# saves a ResNet-50 checkpoint 0.6 s on an NVIDIA H100 80GB HBM3 at
# 700 W, PERF.md §6); a hang is found within the limit and two polls.
SUP_RESNET_STEPS, SUP_RESNET_CKPT_EVERY, SUP_RESNET_FAULT_AT = 12, 4, 6
SUP_BERT_STEPS, SUP_BERT_CKPT_EVERY, SUP_BERT_KILL_AT = 8, 2, 5
SUP_WATCHDOG_S, SUP_POLL_S, SUP_BACKOFF_S = 10.0, 0.5, 0.1
SUP_TIMEOUT_S = 600.0


def sup_worker(out_dir: str, arm: str, t_torch: float) -> int:
    """Phase q's gang worker (``chip_smoke.py --sup-worker <dir> <arm>``,
    started by ``launcher.supervise`` or ``launcher.launch``): joins a
    one-rank NCCL gang through ``XlaRunner(checkpoint_dir=<dir>/ckpt)``
    and runs ``arm``'s fit (``resnet``: phase p's ResNet-50 recipe over
    the seeded wire batches in ``<dir>/../wire.npz``; ``bert``: phase h's),
    resuming from the directory.
    A tee on the flight recorder keeps the times of its start-up, the
    restore, the resume and each loss call; at a chaos event (the plan's
    SIGKILL or hang, from ``SPARKDL_CHAOS``) it writes them, with the
    wrappers' launch counts, to ``<dir>/fault_<pid>.json`` before the
    fault acts. A fit that ends writes ``<dir>/attempt_<pid>.json`` and,
    for ``resnet``, the final state to ``<dir>/state.pt``. ``t_torch``:
    the wall time ``import torch`` returned."""
    import glob
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from sparkdl_tpu_torch.runner import XlaRunner, adam, events, sgd
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # one algorithm choice in every process: the relaunch is held bitwise
    # against a clean run in another process
    torch.backends.cudnn.deterministic = True
    pid = os.getpid()
    rec = dict(arm=arm, pid=pid, t_torch=t_torch, stamps=[])
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    rec["t_cuda"] = time.time()
    ckpt = os.path.join(out_dir, "ckpt")
    runner = XlaRunner(checkpoint_dir=ckpt)
    assert runner.gang is not None and runner.gang.backend == "nccl"
    dist.all_reduce(torch.zeros(1, device=runner.device))  # NCCL's comm
    torch.cuda.synchronize()
    rec["t_nccl"] = time.time()
    committed = [int(os.path.basename(p)[len("manifest_step_"):-5])
                 for p in glob.glob(os.path.join(ckpt, "manifest_step_*"
                                                 ".json"))]
    rec["committed_at_start"] = max(committed) if committed else None
    # the first optimizer a process builds imports torch._dynamo, seconds
    # of every relaunch (PERF.md §6) that an in-process restart
    # never pays again: imported here on its own, so the split names it
    import torch._dynamo  # noqa: F401
    rec["t_dynamo"] = time.time()
    kernels = ()
    if arm == "bert":
        from sparkdl_tpu_torch.ops import _build
        from sparkdl_tpu_torch.ops import flash_attention as fa
        from sparkdl_tpu_torch.ops import flash_decode as fd
        from sparkdl_tpu_torch.ops import paged_flash_decode as pfd

        t0 = time.time()
        _build.library()
        rec["kernel_library_load_s"] = time.time() - t0
        rec["nvcc_ran"] = not _build.build_info.get("cached", False)
        kernels = (fa, fd, pfd)

    def write(name: str) -> None:
        with open(os.path.join(out_dir, f"{name}_{pid}.json"), "w") as f:
            json.dump(rec, f)

    def tee(e: dict) -> None:
        name = e.get("name")
        if name == "train_resume":
            rec["resume"] = dict(t=e["t"], step=e["step"])
        elif name == "checkpoint_restore" and e.get("ph") == "E":
            rec["restore_s"] = e["dur_s"]
        elif name == "chaos":
            rec["fault"] = dict(t=time.time(), kind=e.get("kind"),
                                step=e.get("step"))
            if kernels:
                rec["launches"] = read_counts(*kernels)
            write("fault")

    events.add_tee(tee)

    def stamped(loss_fn):
        def loss(m, batch, **kw):
            rec["stamps"].append(time.time())
            return loss_fn(m, batch, **kw)
        return loss

    if arm == "resnet":
        from sparkdl_tpu_torch.models.registry import get_model
        from sparkdl_tpu_torch.runner import ListDataset, bn_classifier_loss

        spec = get_model("ResNet50")
        with np.load(Path(out_dir).parent / "wire.npz") as wire:
            images, labels = wire["image"], wire["label"]
        batches = [{"image": images[i], "label": labels[i]}
                   for i in range(SUP_RESNET_STEPS)]
        model = spec.build(dtype=torch.bfloat16, num_classes=1000, seed=0,
                           device=runner.device)
        loss_fn = stamped(bn_classifier_loss(
            preprocess=resnet_preprocess(spec)))
        fit_kw = dict(tx=sgd(RESNET_LR, momentum=0.9),
                      data=ListDataset(batches), num_steps=SUP_RESNET_STEPS,
                      mutable=True, checkpoint_every=SUP_RESNET_CKPT_EVERY)
    else:
        from sparkdl_tpu_torch.models import bert as B
        from sparkdl_tpu_torch.runner.data import FactoryDataset

        cfg = B.BertConfig.base()
        batches = [glue_batch(i, cfg.vocab_size)
                   for i in range(SUP_BERT_STEPS)]
        model = B.BertForSequenceClassification(
            cfg, num_classes=2, dtype=torch.bfloat16, device=runner.device,
            generator=torch.Generator(device=runner.device).manual_seed(0))
        loss_fn = stamped(B.bert_finetune_loss(model))
        fit_kw = dict(tx=adam(GLUE_LR),
                      data=FactoryDataset(lambda: iter(batches)),
                      num_steps=SUP_BERT_STEPS, with_rng=True,
                      checkpoint_every=SUP_BERT_CKPT_EVERY)
    torch.cuda.synchronize()
    rec["t_model"] = time.time()
    if kernels:
        reset_counts(*kernels)
    res = runner.run(lambda ctx: ctx.fit(loss_fn=loss_fn, model=model,
                                         log_every=1, **fit_kw))
    torch.cuda.synchronize()
    rec["t_end"] = time.time()
    if kernels:
        rec["launches"] = read_counts(*kernels)
        rec["bwd_variant_launches"] = dict(
            kernels[0].flash_attention_bwd.variant_launches)
    rec["losses"] = [h["loss"] for h in res["history"]]
    rec["final_step"] = int(res["state"].step)
    rec["steps_run"] = res["meter"].steps
    if arm == "resnet":
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()},
                   os.path.join(out_dir, "state.pt"))
    write("attempt")
    leave_gang()
    return 0


class SupervisorWatch(logging.Handler):
    """A handler on the port's runner logger, for one ``supervise`` call
    (``with SupervisorWatch(event_dir) as watch``): the wall time and
    text of each ``supervise: gang attempt N failed`` record, and the
    merged gang timeline in ``event_dir`` as it stands at that moment
    (the next attempt clears it)."""

    def __init__(self, event_dir: str):
        super().__init__(logging.WARNING)
        self.event_dir = Path(event_dir)
        self.failures: list = []
        self.logger = logging.getLogger("sparkdl_tpu_torch.runner")

    def emit(self, record) -> None:
        msg = record.getMessage()
        if not msg.startswith("supervise: gang attempt"):
            return
        path = self.event_dir / "gang_timeline.json"
        self.failures.append(dict(
            t=record.created, message=msg,
            timeline=json.loads(path.read_text()) if path.exists()
            else None))

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def _sup_records(d: str) -> tuple:
    """(fault records, attempt records) the workers wrote in ``d``, each
    in the order of its time."""
    import glob

    def read(kind):
        out = []
        for p in glob.glob(str(Path(d) / f"{kind}_*.json")):
            with open(p) as f:
                out.append(json.load(f))
        return sorted(out, key=lambda r: r["t_cuda"])

    return read("fault"), read("attempt")


def _attempt_spans(event_dir: str) -> list:
    """The supervisor's ``gang_attempt`` spans (the manifest of
    ``event_dir``), in order: each has the wall time just before that
    attempt's spawn."""
    with open(Path(event_dir) / "trace_manifest.json") as f:
        spans = json.load(f)["spans"]
    return [s for s in spans if s["name"] == "gang_attempt"]


def relaunch_split(spawn_t: float, a: dict) -> dict:
    """A relaunched process's way from the supervisor's spawn to the end
    of its first resumed step (the second loss call: with
    ``log_every=1`` a step ends in the read of its loss), seconds."""
    first_end = a["stamps"][1]
    return dict(
        relaunch_to_first_resumed_step_s=first_end - spawn_t,
        interpreter_and_import_torch_s=a["t_torch"] - spawn_t,
        cuda_init_s=a["t_cuda"] - a["t_torch"],
        nccl_init_s=a["t_nccl"] - a["t_cuda"],
        import_torch_dynamo_s=a["t_dynamo"] - a["t_nccl"],
        model_build_s=a["t_model"] - a["t_dynamo"],
        # fit's start to its resume: the manifest's CRC check, the load
        # (``restore_s``, the ``checkpoint_restore`` span) and the cursor
        fit_start_to_resume_s=a["resume"]["t"] - a["t_model"],
        restore_s=a.get("restore_s"),
        first_resumed_step_s=first_end - a["resume"]["t"])


def sup_resnet(torch, root: str, arm: str, clean_state: dict) -> dict:
    """Phase q, ``sup_resnet_kill`` / ``sup_resnet_hang`` (module
    docstring): ``supervise`` of the ResNet-50 worker with a chaos plan;
    the detection, the relaunch split, the ledger and the final state
    bitwise ``clean_state``."""
    import gc
    import os

    from sparkdl_tpu_torch.runner import Fault, FaultPlan, launcher
    from sparkdl_tpu_torch.runner.data import read_ledger

    d = os.path.join(root, arm)
    os.makedirs(d)
    ev, ledger = os.path.join(d, "events"), os.path.join(d, "ledger")
    kind = "hang" if arm.endswith("hang") else "sigkill"
    plan = FaultPlan([Fault("step_start", kind,
                            at_step=SUP_RESNET_FAULT_AT)])
    # the beats and (kill arm) the telemetry plane's snapshots stay in
    # ``d`` for phase r's offline reports
    env = {"SPARKDL_BATCH_LEDGER": ledger}
    if kind == "sigkill":
        env["SPARKDL_METRICS_DIR"] = os.path.join(d, "metrics")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with SupervisorWatch(ev) as watch:
        res = launcher.supervise(
            str(ROOT / "chip_smoke.py"), np=1,
            args=["--sup-worker", d, "resnet"], env=env, plan=plan,
            max_restarts=1, backoff_s=SUP_BACKOFF_S, poll_s=SUP_POLL_S,
            timeout_s=SUP_TIMEOUT_S, event_dir=ev, capture=True,
            heartbeat_dir=os.path.join(d, "heartbeats"),
            watchdog_s=SUP_WATCHDOG_S if kind == "hang" else None)
    wall_s = time.perf_counter() - t0
    faults, attempts = _sup_records(d)
    spans = _attempt_spans(ev)
    assert res.restarts == 1 and res.failure_kinds == ["retryable"], (
        res.failure_kinds)
    assert len(faults) == 1 and len(attempts) == 1 and len(spans) == 2, (
        faults, attempts, spans)
    fault, relaunch = faults[0], attempts[0]
    (failure,) = watch.failures
    assert fault["fault"]["kind"] == kind
    assert fault["fault"]["step"] == SUP_RESNET_FAULT_AT
    # the resume is the newest committed manifest when the fault struck
    committed = fault["committed_at_start"], relaunch["committed_at_start"]
    assert committed[0] is None, committed
    assert relaunch["resume"]["step"] == committed[1] == \
        SUP_RESNET_FAULT_AT // SUP_RESNET_CKPT_EVERY * SUP_RESNET_CKPT_EVERY
    resumed_at = relaunch["resume"]["step"]
    assert relaunch["final_step"] == SUP_RESNET_STEPS
    assert relaunch["steps_run"] == SUP_RESNET_STEPS - resumed_at
    led = [(e["step"], e["batch_index"]) for e in read_ledger(ledger)]
    assert led == [(i, i) for i in range(SUP_RESNET_FAULT_AT)] + \
        [(i, i) for i in range(resumed_at, SUP_RESNET_STEPS)], led
    last = dict(led)
    exactly_once = sorted(last.items()) == [(i, i) for i in range(
        SUP_RESNET_STEPS)]
    assert exactly_once
    state = torch.load(os.path.join(d, "state.pt"))
    differ = [k for k, v in state.items()
              if not torch.equal(v, clean_state[k])]
    rec = dict(
        phase="supervise", arm=arm,
        config="BASELINE config 3: ResNet50 bf16, 256 a batch at 224², "
               "np=1 NCCL gang under launcher.supervise",
        fault=f"step_start {kind} at step {SUP_RESNET_FAULT_AT}",
        steps=SUP_RESNET_STEPS, checkpoint_every=SUP_RESNET_CKPT_EVERY,
        poll_s=SUP_POLL_S, restarts=res.restarts,
        failure_kinds=res.failure_kinds,
        degradations=sorted({x.get("name") for x in res.degradations}),
        committed_at_fault=committed[1], resumed_at=resumed_at,
        ledger_exactly_once=exactly_once, ledger_lines=len(led),
        replayed_steps=list(range(resumed_at, SUP_RESNET_FAULT_AT)),
        state_tensors=len(state), state_bitwise_equal_clean=not differ,
        state_differs=differ[:8],
        **relaunch_split(spans[1]["t"], relaunch),
        first_attempt_spawn_to_fault_s=fault["fault"]["t"] - spans[0]["t"],
        supervise_wall_s=wall_s, nvidia_smi=smi())
    if kind == "sigkill":
        rec["detect_s"] = failure["t"] - fault["fault"]["t"]
    else:
        import re

        m = re.search(r"last beat ([0-9.]+)s ago \(at step (\d+)\)",
                      failure["message"])
        assert m, failure["message"][:400]
        tl = failure["timeline"]
        ff = (tl or {}).get("first_failure") or {}
        rec.update(watchdog_s=SUP_WATCHDOG_S,
                   watchdog_age_at_detect_s=float(m.group(1)),
                   watchdog_named_step=int(m.group(2)),
                   hang_to_detect_s=failure["t"] - fault["fault"]["t"],
                   timeline_first_failure=dict(
                       site=ff.get("site"), step=ff.get("step"),
                       error=ff.get("error")),
                   gang_postmortem_written=tl is not None)
    emit(rec)
    assert not differ, rec
    if kind == "hang":
        assert rec["watchdog_age_at_detect_s"] <= \
            SUP_WATCHDOG_S + 2 * SUP_POLL_S, rec
        assert rec["watchdog_named_step"] == SUP_RESNET_FAULT_AT - 1, rec
        assert rec["gang_postmortem_written"], rec
        assert (ff.get("site"), ff.get("step")) == \
            ("step_start", SUP_RESNET_FAULT_AT), rec
    return rec


def sup_bert(torch, root: str) -> dict:
    """Phase q, ``sup_bert_kill`` (module docstring), against the clean
    run already in ``root/sup_bert_clean``."""
    import gc
    import os

    from sparkdl_tpu_torch.runner import Fault, FaultPlan, launcher

    d, clean_d = os.path.join(root, "sup_bert_kill"), \
        os.path.join(root, "sup_bert_clean")
    ev = os.path.join(d, "events")
    os.makedirs(d)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with SupervisorWatch(ev) as watch:
        res = launcher.supervise(
            str(ROOT / "chip_smoke.py"), np=1,
            args=["--sup-worker", d, "bert"],
            plan=FaultPlan([Fault("step_start", "sigkill",
                                  at_step=SUP_BERT_KILL_AT)]),
            max_restarts=1, backoff_s=SUP_BACKOFF_S, poll_s=SUP_POLL_S,
            timeout_s=SUP_TIMEOUT_S, event_dir=ev, capture=True)
    wall_s = time.perf_counter() - t0
    faults, attempts = _sup_records(d)
    _, (clean,) = _sup_records(clean_d)
    spans = _attempt_spans(ev)
    assert res.restarts == 1 and res.failure_kinds == ["retryable"], (
        res.failure_kinds)
    (fault,), (relaunch,), (failure,) = faults, attempts, watch.failures
    resumed_at = relaunch["resume"]["step"]
    assert resumed_at == relaunch["committed_at_start"] == \
        SUP_BERT_KILL_AT // SUP_BERT_CKPT_EVERY * SUP_BERT_CKPT_EVERY
    nl = 12  # BertConfig.base()'s layers
    launches = {"attempt1_killed": fault["launches"],
                "attempt2_relaunch": relaunch["launches"],
                "clean": clean["launches"]}
    want = {"attempt1_killed": SUP_BERT_KILL_AT,
            "attempt2_relaunch": SUP_BERT_STEPS - resumed_at,
            "clean": SUP_BERT_STEPS}
    got_losses = relaunch["losses"]
    clean_losses = clean["losses"][resumed_at:]
    rec = dict(
        phase="supervise", arm="sup_bert_kill",
        config="BASELINE config 4: BertConfig.base() bf16, 32 x 128, "
               "fit(with_rng=True), np=1 NCCL gang under launcher.supervise",
        fault=f"step_start sigkill at step {SUP_BERT_KILL_AT}",
        steps=SUP_BERT_STEPS, checkpoint_every=SUP_BERT_CKPT_EVERY,
        poll_s=SUP_POLL_S, restarts=res.restarts,
        failure_kinds=res.failure_kinds,
        degradations=sorted({x.get("name") for x in res.degradations}),
        committed_at_fault=relaunch["committed_at_start"],
        resumed_at=resumed_at, detect_s=failure["t"] - fault["fault"]["t"],
        **relaunch_split(spans[1]["t"], relaunch),
        kernel_library_load_s={"attempt1": fault["kernel_library_load_s"],
                               "attempt2": relaunch["kernel_library_load_s"],
                               "clean": clean["kernel_library_load_s"]},
        nvcc_ran=[fault["nvcc_ran"], relaunch["nvcc_ran"], clean["nvcc_ran"]],
        launches=launches, bwd_variant_launches=relaunch[
            "bwd_variant_launches"],
        losses=got_losses, clean_losses=clean_losses,
        losses_bitwise_equal_clean=got_losses == clean_losses,
        loss_max_abs_err=max(abs(a - b) for a, b in
                             zip(got_losses, clean_losses)),
        supervise_wall_s=wall_s, nvidia_smi=smi())
    emit(rec)
    assert not any(rec["nvcc_ran"]), rec  # no rebuild after phase a
    for k, c in launches.items():
        assert c["flash_attention"] == c["flash_attention_bwd"] == \
            nl * want[k], (k, c)
        assert c["flash_decode"] == c["paged_flash_decode"] == 0, (k, c)
    assert rec["bwd_variant_launches"]["tc_mma_bf16"] == \
        nl * want["attempt2_relaunch"], rec
    assert len(got_losses) == SUP_BERT_STEPS - resumed_at, rec
    assert rec["losses_bitwise_equal_clean"], rec
    return rec


def phase_supervise(torch, root: str) -> dict:
    """Phase q: the gang supervisor on the card (module docstring). The
    parent, which holds a CUDA context of its own, only supervises: its
    ``launcher`` imports no torch. Everything lives in ``root``, a
    ``tempfile`` directory of the caller's, which phase r reads and then
    removes; the ``sup_resnet_kill`` arm's event, heartbeat and metrics
    directories are under ``dirs``. A ``summary`` line gives the phase's
    seconds."""
    import gc
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from sparkdl_tpu_torch.runner import launcher

    t0 = time.perf_counter()
    for arm in ("sup_resnet_clean", "sup_bert_clean"):
        os.makedirs(os.path.join(root, arm))
    wire = resnet_wire(SUP_RESNET_STEPS, RESNET_BATCH, RESNET_SIZE,
                       seed=44)
    np.savez(os.path.join(root, "wire.npz"),
             image=np.stack([b["image"] for b in wire]),
             label=np.stack([b["label"] for b in wire]))
    del wire
    gc.collect()
    torch.cuda.empty_cache()
    # the clean runs, both at once (two one-rank gangs on the card;
    # nothing of theirs is timed)
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(
                launcher.launch, str(ROOT / "chip_smoke.py"), np=1,
                args=["--sup-worker", os.path.join(root, arm), kind],
                timeout_s=SUP_TIMEOUT_S, capture=True)
                for arm, kind in (("sup_resnet_clean", "resnet"),
                                  ("sup_bert_clean", "bert"))]:
            f.result()
    clean_state = torch.load(os.path.join(root, "sup_resnet_clean",
                                          "state.pt"))
    recs = {arm: sup_resnet(torch, root, arm, clean_state)
            for arm in ("sup_resnet_kill", "sup_resnet_hang")}
    del clean_state
    recs["sup_bert_kill"] = sup_bert(torch, root)
    seconds = time.perf_counter() - t0
    emit(dict(phase="supervise", arm="summary", seconds=seconds,
              nvidia_smi=smi()))
    recs["seconds"] = seconds
    kill = os.path.join(root, "sup_resnet_kill")
    recs["dirs"] = {k: os.path.join(kill, k)
                    for k in ("events", "heartbeats", "metrics")}
    return recs


# --- phase r: imported weights served and read back offline --------------

IMPORT_LAYERS = 2              # import_llama3_8b: llama3_8b widths, depth 2
IMPORT_REQUESTS, IMPORT_NEW = 16, 32
IMPORT_BERT_ROWS, IMPORT_BERT_SEQ = 256, 128
IMPORT_IMAGES = 64             # keras_resnet50_h5: images featurized
OFFLINE_UNATTR_MAX = 0.05      # phase o's limit on a trace's unattributed
PHASE_R_BUDGET_S = 90.0        # what phase r is meant to stay under
# the flax paths of a port Llama's modules → HF's names
_HF_LLAMA_MODS = {"attn": "self_attn", "mlp": "mlp"}
_HF_LLAMA_NORMS = {"attn_norm": "input_layernorm",
                   "mlp_norm": "post_attention_layernorm"}
# BERT: flax module → HF module, flax leaf → HF leaf
_HF_BERT_MODS = {"embeddings_norm": "embeddings.LayerNorm",
                 "query": "attention.self.query",
                 "key": "attention.self.key",
                 "value": "attention.self.value",
                 "attention_output": "attention.output.dense",
                 "attention_norm": "attention.output.LayerNorm",
                 "intermediate": "intermediate.dense",
                 "output_dense": "output.dense",
                 "output_norm": "output.LayerNorm",
                 "pooler": "pooler.dense"}
_HF_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
              "bias": "bias"}


def hf_llama_state(torch, model, dtype) -> dict:
    """A port Llama's weights as an HF ``LlamaForCausalLM`` state dict
    (``model.layers.N.self_attn.q_proj.weight`` ...), CPU tensors of
    ``dtype``: the inverse of ``pretrained.import_hf_llama``'s name map
    and of its rope row permutation (q and k rows go back to HF's
    half-split order). Torch ``[out, in]`` weights are HF's layout."""
    import numpy as np

    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.models.pretrained import _rope_permutation

    cfg = model.cfg
    inv = torch.from_numpy(np.argsort(_rope_permutation(cfg.head_dim)))
    out = {}
    with torch.no_grad():
        for path, p, _ in L._param_map(model):
            w = p.detach()
            if path == ("embed_tokens", "embedding"):
                name = "model.embed_tokens.weight"
            elif path == ("final_norm", "scale"):
                name = "model.norm.weight"
            elif path == ("lm_head", "kernel"):
                name = "lm_head.weight"
            elif path[1] in _HF_LLAMA_NORMS:
                name = (f"model.layers.{path[0][len('layer_'):]}."
                        f"{_HF_LLAMA_NORMS[path[1]]}.weight")
            else:
                assert path[3:] == ("base", "kernel"), path
                proj = path[2]
                name = (f"model.layers.{path[0][len('layer_'):]}."
                        f"{_HF_LLAMA_MODS[path[1]]}.{proj}.weight")
                if proj in ("q_proj", "k_proj"):
                    heads = cfg.num_heads if proj == "q_proj" \
                        else cfg.num_kv_heads
                    w = w.reshape(heads, cfg.head_dim, -1)[
                        :, inv.to(w.device), :].reshape(w.shape)
            out[name] = w.to(dtype).cpu().contiguous()
    return out


def hf_bert_state(torch, model) -> dict:
    """A port ``BertForSequenceClassification``'s weights as an HF
    ``BertForSequenceClassification`` state dict (``bert.encoder.layer.N.
    attention.self.query.weight`` ..., ``classifier.weight``), f32 CPU
    tensors: the inverse of ``pretrained.import_hf_bert``'s name map."""
    from sparkdl_tpu_torch.models import bert as B

    out = {}
    with torch.no_grad():
        for path, p, _ in B._param_map(model):
            leaf = _HF_LEAVES[path[-1]]
            mods = path[1:-1]
            if path[0] == "classifier":
                name = f"classifier.{leaf}"
            elif mods[0].endswith("_embeddings"):
                name = f"bert.embeddings.{mods[0]}.weight"
            elif mods[0].startswith("layer_"):
                name = (f"bert.encoder.layer.{mods[0][len('layer_'):]}."
                        f"{_HF_BERT_MODS[mods[-1]]}.{leaf}")
            else:
                name = f"bert.{_HF_BERT_MODS[mods[0]]}.{leaf}"
            out[name] = p.detach().float().cpu().contiguous()
    return out


def keras_resnet50_h5(model, path: str) -> None:
    """A keras-applications-layout ResNet50 ``.h5`` (the legacy
    topological format of the published ImageNet files: ``model_weights``
    with ``layer_names``, each layer's ``weight_names``) of a port
    ResNet50: the inverse of ``pretrained.import_keras_resnet``'s name
    map, the conv biases written as zeros (the importer folds them into
    the BatchNorm mean). Needs h5py."""
    import h5py
    import numpy as np

    from sparkdl_tpu_torch.models.registry import state_dict_to_flax

    v = state_dict_to_flax(model.state_dict())
    p, s = v["params"], v["batch_stats"]
    layers = {}

    def convbn(kname, bname, conv, bn, st):
        k = conv["kernel"]
        layers[kname] = [("kernel", k),
                         ("bias", np.zeros(k.shape[-1], np.float32))]
        layers[bname] = [("gamma", bn["scale"]), ("beta", bn["bias"]),
                         ("moving_mean", st["mean"]),
                         ("moving_variance", st["var"])]

    convbn("conv1_conv", "conv1_bn", p["stem_conv"], p["stem_bn"],
           s["stem_bn"])
    for si, n_blocks in enumerate((3, 4, 6, 3)):
        for b in range(n_blocks):
            kp = f"conv{si + 2}_block{b + 1}"
            mine = f"stage{si + 1}_block{b + 1}"
            bp, bs = p[mine], s[mine]
            if "proj_conv" in bp:
                convbn(f"{kp}_0_conv", f"{kp}_0_bn", bp["proj_conv"],
                       bp["proj_bn"], bs["proj_bn"])
            for k in (1, 2, 3):
                convbn(f"{kp}_{k}_conv", f"{kp}_{k}_bn", bp[f"conv{k}"],
                       bp[f"bn{k}"], bs[f"bn{k}"])
    layers["predictions"] = [("kernel", p["head"]["kernel"]),
                             ("bias", p["head"]["bias"])]
    with h5py.File(path, "w") as h:
        root = h.create_group("model_weights")
        root.attrs["layer_names"] = np.array([n.encode() for n in layers])
        for name, ws in layers.items():
            g = root.create_group(name)
            g.attrs["weight_names"] = np.array(
                [f"{name}/{w}:0".encode() for w, _ in ws])
            for w, a in ws:
                g.create_dataset(f"{name}/{w}:0", data=a)


class PeakRss:
    """``with PeakRss() as rss``: the largest resident set of this
    process while the block ran (``rss.peak_gb``), sampled every 10 ms
    from ``/proc/self/statm``, and the resident set at entry
    (``rss.start_gb``)."""

    def __init__(self):
        import os
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.peak_gb = self.start_gb = 0.0

    def _now_gb(self) -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page / 1e9

    def _run(self):
        while not self._stop.wait(0.01):
            self.peak_gb = max(self.peak_gb, self._now_gb())

    def __enter__(self):
        self.start_gb = self.peak_gb = self._now_gb()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_gb = max(self.peak_gb, self._now_gb())


def bf16_copy(torch, model):
    """A bf16-compute copy of a Llama on the card (``dtype=bfloat16``:
    the embedding and projections bf16, the norms and ``lm_head`` f32, as
    phase n serves llama3_8b) holding ``model``'s weights."""
    from sparkdl_tpu_torch.models import llama as L

    out = L.LlamaModel(model.cfg, dtype=torch.bfloat16, device="cuda")
    src = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(src[name])
    return out


def params_max_abs_diff(torch, a, b) -> float:
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert sorted(pa) == sorted(pb)
    with torch.no_grad():
        return max(float((pa[k].float() - pb[k].float()).abs().max())
                   for k in pa)


def import_llama3_8b(torch, kernels, root: str) -> dict:
    """``import_llama3_8b`` (module docstring): llama3_8b at full width,
    depth IMPORT_LAYERS, written as an HF bf16 safetensors file and read
    back through ``import_hf_llama`` / ``load_flax_params``; then served
    twice, original and imported, the imported run streaming into
    ``root/llama_events`` with the telemetry plane's snapshots in
    ``root/llama_metrics``."""
    import dataclasses
    import gc
    import os

    from safetensors.torch import save_file

    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.models.pretrained import import_hf_llama
    from sparkdl_tpu_torch.runner import events, telemetry

    cfg = dataclasses.replace(L.LlamaConfig.llama3_8b(),
                              num_layers=IMPORT_LAYERS)
    nl = cfg.num_layers
    path = os.path.join(root, "llama3_8b.safetensors")
    with PeakRss() as rss:
        orig = L.LlamaModel(cfg, dtype=torch.float32, device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(18))
        with torch.no_grad():  # a published file holds bf16 values
            for p in orig.parameters():
                p.copy_(p.to(torch.bfloat16))
        n_params = sum(p.numel() for p in orig.parameters())
        t0 = time.perf_counter()
        state = hf_llama_state(torch, orig, torch.bfloat16)
        save_file(state, path)
        del state
        gc.collect()
        write_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        tree = import_hf_llama(path, cfg)
        read_s = time.perf_counter() - t0
        tree_bytes = sum(a.nbytes for _, a in _tree_items(tree))
        fresh = L.LlamaModel(cfg, dtype=torch.float32, device="cuda",
                             generator=torch.Generator(
                                 device="cuda").manual_seed(99))
        L.load_flax_params(fresh, tree)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        del tree
        gc.collect()
    max_err = params_max_abs_diff(torch, orig, fresh)
    models = {"original": bf16_copy(torch, orig),
              "imported": bf16_copy(torch, fresh)}
    del orig, fresh
    free_engines(torch)
    g = torch.Generator().manual_seed(18)
    lens = torch.randint(64, 1537, (IMPORT_REQUESTS,), generator=g).tolist()
    lens[0], lens[-1] = 64, 1536
    prompts = serve_prompts(torch, cfg, lens, 18)
    kw = dict(block_size=16, prefill_chunk=256, stall_free=False,
              max_len=4096, new=IMPORT_NEW, keep_streams=True,
              config=f"LlamaConfig.llama3_8b, {nl} of 32 layers")
    dirs = {"SPARKDL_EVENT_DIR": os.path.join(root, "llama_events"),
            "SPARKDL_METRICS_DIR": os.path.join(root, "llama_metrics")}
    legs = {}
    for arm in ("original", "imported"):
        if arm == "imported":
            os.environ.update(dirs)
            events.reset()
            telemetry.reset()
            assert telemetry.maybe_start_from_env()
        try:
            rec, eng = serve_leg(torch, models[arm], kernels,
                                 leg=f"import_llama3_8b_{arm}",
                                 prompts=prompts, **kw)
        finally:
            if arm == "imported":
                telemetry.stop()
                events.reset()  # closes the stream
                for k in dirs:
                    os.environ.pop(k, None)
                telemetry.reset()
        assert rec["launches"]["flash_attention"] == \
            nl * rec["prefills"] > 0, rec
        assert rec["launches"]["paged_flash_decode"] == \
            nl * rec["steps"] > 0, rec
        assert rec["launches"]["flash_decode"] == 0, rec
        legs[arm] = rec
        del eng
        free_engines(torch)
    del models
    free_engines(torch)
    streams = {arm: legs[arm].pop("streams") for arm in legs}
    same = [a == b for a, b in zip(streams["original"], streams["imported"])]
    rec = dict(
        phase="import", leg="import_llama3_8b",
        config=f"LlamaConfig.llama3_8b (BASELINE config 5), full width, "
               f"depth cut to {nl} of 32; an HF bf16 safetensors file of "
               f"seeded weights",
        reduced={"num_layers": [32, nl]}, params=n_params,
        file_bytes=file_bytes, tree_bytes=tree_bytes, write_s=write_s,
        read_and_import_s=read_s, import_to_card_s=import_s,
        host_rss_gb=dict(start=rss.start_gb, peak=rss.peak_gb),
        params_max_abs_err=max_err, requests=len(prompts),
        prompt_lens=lens, new_tokens=IMPORT_NEW,
        streams_identical=sum(same),
        launches={arm: legs[arm]["launches"] for arm in legs},
        prefills={arm: legs[arm]["prefills"] for arm in legs},
        steps={arm: legs[arm]["steps"] for arm in legs},
        new_tokens_per_s={arm: legs[arm]["new_tokens_per_s"]
                          for arm in legs},
        event_dir=dirs["SPARKDL_EVENT_DIR"], nvidia_smi=smi())
    emit(rec)
    assert max_err == 0.0, rec
    assert all(same) and len(same) == IMPORT_REQUESTS, rec
    rec["dirs"] = dirs
    return rec


def _tree_items(tree, prefix=()):
    """(key path, leaf) of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def import_bert_base(torch, kernels, root: str) -> dict:
    """``import_bert_base``: BertConfig.base() with 2 classes through an HF
    safetensors file and ``import_hf_bert(num_classes=2)``, then
    ``classify_rows`` on the card over IMPORT_BERT_ROWS rows of up to
    IMPORT_BERT_SEQ tokens with each model; the logits bitwise."""
    import gc
    import os

    import numpy as np
    from safetensors.torch import save_file

    from sparkdl_tpu_torch.models import bert as B
    from sparkdl_tpu_torch.models.pretrained import import_hf_bert
    from sparkdl_tpu_torch.udf.registry import classify_rows

    cfg = B.BertConfig.base()
    path = os.path.join(root, "bert_base.safetensors")

    def build(seed):
        return B.BertForSequenceClassification(
            cfg, num_classes=2, dtype=torch.bfloat16, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(seed))

    orig = build(19)
    t0 = time.perf_counter()
    save_file(hf_bert_state(torch, orig), path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = import_hf_bert(path, cfg, num_classes=2)
    fresh = B.load_flax_params(build(98), tree)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    del tree
    gc.collect()
    max_err = params_max_abs_diff(torch, orig, fresh)
    rng = np.random.default_rng(19)
    lens = rng.integers(8, IMPORT_BERT_SEQ + 1, IMPORT_BERT_ROWS)
    lens[0] = IMPORT_BERT_SEQ
    rows = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    out = {}
    for arm, model in (("original", orig), ("imported", fresh)):
        logits = []
        hook = model.register_forward_hook(
            lambda m, a, o: logits.append(o.detach().clone()))
        reset_counts(*kernels)
        with torch.no_grad():
            preds = classify_rows(model, rows, IMPORT_BERT_SEQ)
        torch.cuda.synchronize()
        hook.remove()
        out[arm] = dict(logits=torch.cat(logits), preds=preds,
                        launches=read_counts(*kernels))
    a, b = out["original"], out["imported"]
    rec = dict(
        phase="import", leg="import_bert_base",
        config="BertConfig.base() (BASELINE config 4), 2 classes, bf16 "
               "compute over f32 weights; an HF f32 safetensors file of "
               "seeded weights",
        file_bytes=os.path.getsize(path), write_s=write_s,
        import_to_card_s=import_s, params_max_abs_err=max_err,
        rows=IMPORT_BERT_ROWS, max_len=IMPORT_BERT_SEQ,
        logits_bitwise=bool(torch.equal(a["logits"], b["logits"])),
        logits_shape=list(a["logits"].shape),
        predictions_equal=bool((a["preds"] == b["preds"]).all()),
        launches={arm: out[arm]["launches"] for arm in out},
        nvidia_smi=smi())
    emit(rec)
    del orig, fresh, out
    free_engines(torch)
    assert max_err == 0.0, rec
    assert rec["logits_bitwise"] and rec["predictions_equal"], rec
    for arm in rec["launches"]:
        assert rec["launches"][arm]["flash_attention"] == \
            cfg.num_layers, rec
    return rec


def keras_resnet50_leg(torch, root: str) -> dict:
    """``keras_resnet50_h5``: a keras-applications-layout ``.h5`` of a
    seeded ResNet50 written with h5py, read by
    ``DeepImageFeaturizer(modelName="ResNet50", weightsPath=...)``
    (keras-v1 stride placement) on the card and on the CPU over
    IMPORT_IMAGES images, held to phase j's card-vs-CPU f32 rule. Where
    h5py does not import, the line says so and nothing runs."""
    import importlib.util
    import os

    if importlib.util.find_spec("h5py") is None:
        rec = dict(phase="import", leg="keras_resnet50_h5", ran=False,
                   missing="h5py", nvidia_smi=smi())
        emit(rec)
        return rec
    import numpy as np

    from sparkdl_tpu_torch.models import pretrained, resnet
    from sparkdl_tpu_torch.models.registry import state_dict_to_flax
    from sparkdl_tpu_torch.transformers import DeepImageFeaturizer

    torch.backends.cudnn.allow_tf32 = False
    path = os.path.join(root, "resnet50.h5")
    src = resnet.ResNet50(num_classes=1000, seed=20)
    keras_resnet50_h5(src, path)
    want = dict(_tree_items(state_dict_to_flax(src.state_dict())))
    got = dict(_tree_items(pretrained.load_pretrained("ResNet50", path)))
    assert sorted(got) == sorted(want)
    tree_err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    batch = np.random.default_rng(20).integers(
        0, 256, (IMPORT_IMAGES, 224, 224, 3), dtype=np.uint8)
    feats = {}
    for device in ("cuda", "cpu"):
        f = DeepImageFeaturizer(modelName="ResNet50", weightsPath=path,
                                batchSize=IMPORT_IMAGES, device=device)
        assert f._build_kwargs() == {"stride_on_3x3": False}
        feats[device] = np.concatenate(list(f._get_runner().run([batch])))
    atol_share, rtol = IMAGE_F32_RULE
    ref = feats["cpu"]
    over = np.abs(feats["cuda"] - ref) - (
        atol_share * max(1.0, float(np.abs(ref).max())) + rtol * np.abs(ref))
    rec = dict(phase="import", leg="keras_resnet50_h5", ran=True,
               config="ResNet50 (BASELINE configs 1-2), keras v1 stride "
                      "placement, seeded weights",
               file_bytes=os.path.getsize(path), tree_max_abs_err=tree_err,
               images=IMPORT_IMAGES,
               features_shape=list(ref.shape),
               max_abs_err=float(np.abs(feats["cuda"] - ref).max()),
               worst_over_rule=float(over.max()), nvidia_smi=smi())
    emit(rec)
    assert tree_err == 0.0 and over.max() <= 0, rec
    return rec


def run_scripts(cmds: dict) -> dict:
    """Each of ``cmds`` (name → argv after the interpreter) in a
    subprocess of its own, all started together as a user would start
    them; returns name → (exit code, stdout, stderr, wall s)."""
    procs, t0 = {}, {}
    for name, argv in cmds.items():
        t0[name] = time.perf_counter()
        procs[name] = subprocess.Popen(
            [sys.executable] + argv, cwd=str(ROOT), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    for name, p in procs.items():
        so, se = p.communicate(timeout=300)
        out[name] = (p.returncode, so, se, time.perf_counter() - t0[name])
    return out


def offline_legs(root: str, sup: dict, llama: dict) -> dict:
    """``offline_trace`` and ``offline_requests`` (module docstring): the
    three ``scripts/torch_*.py`` reports over phase q's ``sup_resnet_kill``
    directories and the imported llama run's event dir, as subprocesses
    started together, beside a bare ``import torch`` timed the same
    way."""
    import glob
    import os

    trace_path = os.path.join(root, "sup_resnet_kill_trace.json")
    gangs = sorted(glob.glob(os.path.join(sup["metrics"], "gang-*")),
                   key=os.path.getmtime)
    assert gangs, sup  # the supervised run's adopted metrics dir
    cmds = {
        "torch_trace_export": [
            "scripts/torch_trace_export.py", sup["events"],
            "--heartbeat-dir", sup["heartbeats"], "--metrics-dir",
            gangs[-1], "--out", trace_path, "--validate",
            "--require-ranks", "1"],
        "torch_bottleneck_report": [
            "scripts/torch_bottleneck_report.py", sup["events"],
            "--metrics-dir", sup["metrics"], "--json"],
        "torch_request_report": [
            "scripts/torch_request_report.py",
            llama["dirs"]["SPARKDL_EVENT_DIR"], "--json"],
        "import_torch": [
            "-c", "import time; t = time.perf_counter(); import torch; "
                  "print(time.perf_counter() - t)"],
    }
    res = run_scripts(cmds)
    for name, (rc, so, se, _) in res.items():
        assert rc == 0, (name, rc, se[-3000:])
    wall = {name: r[3] for name, r in res.items()}
    summary = json.loads(res["torch_trace_export"][1].strip().splitlines()[-1])
    with open(trace_path) as f:
        trace = json.load(f)
    with open(os.path.join(sup["events"], "trace_manifest.json")) as f:
        manifest = json.load(f)
    evs = trace["traceEvents"]
    from sparkdl_tpu_torch.runner.traceview import DRIVER_PID

    attempts = [e for e in evs if e.get("ph") == "X"
                and e.get("pid") == DRIVER_PID
                and e.get("name") == "gang_attempt"]
    rank_spans = [e for e in evs if e.get("ph") in ("X", "i")
                  and e.get("pid") != DRIVER_PID
                  and not str(e.get("name")).startswith("request ")]
    foreign = sorted({e["name"] for e in rank_spans
                      if (e.get("args") or {}).get("trace_id")
                      != manifest["trace_id"]})
    kinds = {}
    for e in evs:
        kinds[e.get("ph")] = kinds.get(e.get("ph"), 0) + 1
    skew = trace["otherData"]["clock_skew"]
    bottleneck = json.loads(res["torch_bottleneck_report"][1])
    requests = json.loads(res["torch_request_report"][1])
    rec_trace = dict(
        phase="offline", leg="offline_trace",
        source="phase q sup_resnet_kill: events, heartbeats, metrics",
        validation=summary["validation"], trace_id=manifest["trace_id"],
        gang_attempt_spans=len(attempts), rank_spans=len(rank_spans),
        rank_spans_without_the_trace_id=foreign,
        trace_bytes=os.path.getsize(trace_path), event_counts=kinds,
        clock_skew=skew,
        bottleneck=dict(
            dominant_stage=(bottleneck["report"] or {}).get(
                "dominant_stage"),
            wall_s=(bottleneck["report"] or {}).get("wall_s"),
            stages=sorted((bottleneck["report"] or {}).get("stages", {})),
            gang_metrics_ranks=(bottleneck["gang_metrics"] or {}).get(
                "n_ranks")),
        wall_s={k: wall[k] for k in ("torch_trace_export",
                                     "torch_bottleneck_report")},
        import_torch_s=float(res["import_torch"][1].strip()),
        import_torch_wall_s=wall["import_torch"], nvidia_smi=smi())
    emit(rec_trace)
    rec_req = dict(
        phase="offline", leg="offline_requests",
        source="phase r import_llama3_8b imported run's event dir",
        completed=requests["completed"], errors=requests["errors"],
        open=requests["open"],
        max_unattributed_frac=requests["max_unattributed_frac"],
        mean_unattributed_frac=requests["mean_unattributed_frac"],
        latency_s=requests["latency_s"], ttft_s=requests["ttft_s"],
        tail_dominant_phase=requests["tail_dominant_phase"],
        wall_s=wall["torch_request_report"], nvidia_smi=smi())
    emit(rec_req)
    assert summary["validation"]["ok"], summary
    assert len(attempts) == 2, rec_trace
    assert rank_spans and not foreign, rec_trace
    assert skew["measured"], rec_trace
    assert bottleneck["report"] is not None, rec_trace
    assert requests["completed"] == IMPORT_REQUESTS, rec_req
    assert requests["max_unattributed_frac"] <= OFFLINE_UNATTR_MAX, rec_req
    return dict(offline_trace=rec_trace, offline_requests=rec_req)


def phase_import(torch, kernels, sup: dict) -> dict:
    """Phase r (module docstring): imported weights on the card, then the
    offline reports over this run's and phase q's directories.
    Everything lives in a ``tempfile`` directory; a ``summary`` line
    gives the phase's seconds."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sparkdl_import_") as root:
        recs = {"import_llama3_8b": import_llama3_8b(torch, kernels, root)}
        recs["import_bert_base"] = import_bert_base(torch, kernels, root)
        recs["keras_resnet50_h5"] = keras_resnet50_leg(torch, root)
        recs.update(offline_legs(root, sup, recs["import_llama3_8b"]))
    seconds = time.perf_counter() - t0
    emit(dict(phase="import", leg="summary", seconds=seconds,
              budget_s=PHASE_R_BUDGET_S,
              within_budget=seconds <= PHASE_R_BUDGET_S,
              h5_leg_ran=recs["keras_resnet50_h5"]["ran"],
              nvidia_smi=smi()))
    recs["seconds"] = seconds
    return recs


# --- phase s: the graph toolkit and the Keras path -------------------------

GRAPH_ROWS, GRAPH_BATCH = 256, 32  # phase s: ResNet50 images, batch
GRAPH_TAIL = 7                     # the exported graph's odd batch
# the exported program and the captured step run the live graph's aten
# ops on the same card, so they are expected bitwise; the limit allows
# one f32 rounding of a 2048-wide pooled feature
GRAPH_RULE = (1e-6, 1e-6)          # (share of max|ref|, relative)
KERAS_LEG_ROWS, KERAS_LEG_BATCH = 32, 16
PHASE_S_BUDGET_S = 60.0


def graph_err(got, ref) -> tuple:
    """(max |Δ|, worst excess over GRAPH_RULE) of two numpy arrays."""
    import numpy as np
    share, rtol = GRAPH_RULE
    over = np.abs(got - ref) - (share * max(1.0, float(np.abs(ref).max()))
                                + rtol * np.abs(ref))
    return float(np.abs(got - ref).max()), float(over.max())


def rows_per_s(torch, fn, batches: list) -> tuple:
    """(outputs as one numpy array, rows/s) of ``fn`` over ``batches``
    after one warm-up call, waiting for the card at the end."""
    import numpy as np
    fn(batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [fn(b) for b in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    outs = np.concatenate([o if isinstance(o, np.ndarray) else
                           o.cpu().numpy() for o in outs])
    return outs, sum(len(b) for b in batches) / seconds


def graph_leg(torch, root: str) -> dict:
    """``graph_resnet50``: BASELINE config 2's model as a GraphFunction
    (converter → ResNet50 features → flattener) on the card, held to the
    direct module call, its captured step (``jit``), its ``.pt2`` round
    trip at batches GRAPH_BATCH and GRAPH_TAIL, the UDF ``makeGraphUDF``
    registers (its device step, ``udfStage``: the card machine has
    no pyarrow) and an IsolatedSession assembly; rows/s of each beside
    ``DeepImageFeaturizer(modelName="ResNet50")``'s runner on the same
    rows."""
    import os

    import numpy as np

    from sparkdl_tpu_torch.graph import (GraphFunction, buildFlattener,
                                         buildSpImageConverter, makeGraphUDF)
    from sparkdl_tpu_torch.models import registry as R
    from sparkdl_tpu_torch.transformers import DeepImageFeaturizer
    from sparkdl_tpu_torch.transformers.utils import imageInputPlaceholder
    from sparkdl_tpu_torch.udf import udfStage, unregisterUDF

    dev = {"device": "cuda"}
    resnet = R.get_model("ResNet50").build(seed=30, **dev)
    gfn = GraphFunction.fromList([
        buildSpImageConverter("BGR", **dev),
        GraphFunction.fromModule(resnet, features_only=True, **dev),
        buildFlattener(**dev)])
    images = np.random.default_rng(30).integers(
        0, 256, (GRAPH_ROWS, 224, 224, 3), dtype=np.uint8)
    batches = [images[i:i + GRAPH_BATCH]
               for i in range(0, GRAPH_ROWS, GRAPH_BATCH)]
    rec = dict(phase="graph", leg="graph_resnet50",
               config="ResNet50 (BASELINE config 2) at 224x224, f32 (TF32 "
                      "off), seeded weights", rows=GRAPH_ROWS,
               batch=GRAPH_BATCH)

    def live(b):
        return gfn(image=b)["flattened"]

    got, rec["live_rows_per_s"] = rows_per_s(torch, live, batches)
    with torch.no_grad():
        direct = np.concatenate([
            resnet(torch.from_numpy(b).cuda().float().flip(-1),
                   features_only=True).cpu().numpy() for b in batches])
    rec["direct_max_abs_err"], over_direct = graph_err(got, direct)
    jitted = gfn.jit()
    jit_out, rec["jit_rows_per_s"] = rows_per_s(
        torch, lambda b: jitted(image=b)["flattened"], batches)
    rec["jit_max_abs_err"], over_jit = graph_err(jit_out, got)

    path = os.path.join(root, "resnet50_graph.pt2")
    t0 = time.perf_counter()
    gfn.dump(path, {"image": ((None, 224, 224, 3), "uint8")})
    rec["export_s"] = time.perf_counter() - t0
    rec["pt2_bytes"] = os.path.getsize(path)
    t0 = time.perf_counter()
    loaded = GraphFunction.load(path, **dev)
    rec["load_s"] = time.perf_counter() - t0
    exp_out, rec["exported_rows_per_s"] = rows_per_s(
        torch, lambda b: loaded(image=b)["flattened"], batches)
    rec["exported_max_abs_err"], over_exp = graph_err(exp_out, got)
    tail = images[:GRAPH_TAIL]
    rec["exported_tail_max_abs_err"], over_tail = graph_err(
        loaded(image=tail)["flattened"].cpu().numpy(),
        live(tail).cpu().numpy())

    makeGraphUDF(gfn, "graph_resnet50", batchSize=GRAPH_BATCH)
    try:
        runner = udfStage("graph_resnet50", "image", "features")._get_runner()
        assert runner.device.type == "cuda", runner.device
        fbatches = [b.astype(np.float32) for b in batches]
        udf_out, rec["udf_rows_per_s"] = rows_per_s(
            torch, lambda b: np.concatenate(list(runner.run([b]))),
            fbatches)
    finally:
        unregisterUDF("graph_resnet50")
    rec["udf_max_abs_err"], over_udf = graph_err(udf_out, got)

    node = imageInputPlaceholder(3, 224, 224, **dev)
    issn = node.session
    feats = issn.importGraphFunction(gfn, [node], prefix="resnet")
    sess_gfn = issn.asGraphFunction([node], feats)
    sess_out = sess_gfn({node.name: batches[0].astype(np.float32)})[
        feats[0].name].cpu().numpy()
    rec["session_max_abs_err"], over_sess = graph_err(
        sess_out, got[:GRAPH_BATCH])

    featurizer = DeepImageFeaturizer(modelName="ResNet50",
                                     batchSize=GRAPH_BATCH, **dev)
    frunner = featurizer._get_runner()
    _, rec["featurizer_rows_per_s"] = rows_per_s(
        torch, lambda b: np.concatenate(list(frunner.run([b]))), batches)
    rec.update(features_shape=list(got.shape),
               tol_rule=f"|Δ| <= {GRAPH_RULE[0]}·max(1, max|ref|) + "
                        f"{GRAPH_RULE[1]}·|ref|",
               nvidia_smi=smi())
    emit(rec)
    assert got.shape == (GRAPH_ROWS, 2048) and np.isfinite(got).all(), rec
    for name, over in (("direct", over_direct), ("jit", over_jit),
                       ("exported", over_exp), ("exported_tail", over_tail),
                       ("udf", over_udf), ("session", over_sess)):
        assert over <= 0, (name, rec)
    return rec


def keras_worker(out: str) -> int:
    """``chip_smoke.py --keras-leg <file>``: the Keras leg in a process of
    its own (keras and pyarrow stay out of the main process, whose card
    path imports neither). A seeded small CNN written as ``.keras`` is
    fitted by ``KerasImageFileEstimator`` for 2 sgd steps on PNGs written
    here, on the card; the returned ``KerasImageFileTransformer`` scores
    the rows on the card and on the CPU; one JSON object to ``out``."""
    import os
    import tempfile

    import numpy as np

    os.environ["KERAS_BACKEND"] = "torch"
    import sparkdl_tpu_torch as tdl
    from sparkdl_tpu_torch.transformers.keras_utils import _keras
    from PIL import Image

    keras = _keras()
    root = tempfile.mkdtemp(prefix="sparkdl_keras_leg_")
    keras.utils.set_random_seed(31)
    with keras.device("cpu"):
        model = keras.Sequential([
            keras.Input((32, 32, 3)),
            keras.layers.Conv2D(8, 3, use_bias=False),
            keras.layers.BatchNormalization(), keras.layers.ReLU(),
            keras.layers.GlobalAveragePooling2D(), keras.layers.Dense(2)])
    path = os.path.join(root, "cnn.keras")
    model.save(path)
    rng = np.random.default_rng(31)
    uris, labels = [], []
    for i in range(KERAS_LEG_ROWS):
        f = os.path.join(root, f"im{i}.png")
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), np.uint8)).save(f)
        uris.append(f)
        labels.append(i % 2)
    df = tdl.DataFrame.fromPydict({"uri": uris, "label": labels})
    loader = tdl.defaultImageLoader((32, 32))
    t0 = time.perf_counter()
    fitted = tdl.KerasImageFileEstimator(
        inputCol="uri", outputCol="scores", labelCol="label",
        modelFile=path, imageLoader=loader, batchSize=KERAS_LEG_BATCH,
        epochs=1, optimizer="sgd", learningRate=0.05,
        device="cuda").fit(df)
    fit_s = time.perf_counter() - t0
    scores = {}
    for device in ("cuda", "cpu"):
        fitted.setDevice(device)
        scores[device] = np.stack([np.asarray(r.scores, np.float32)
                                   for r in fitted.transform(df).collect()])
    got, ref = scores["cuda"], scores["cpu"]
    share, rtol = IMAGE_F32_RULE
    over = np.abs(got - ref) - (share * max(1.0, float(np.abs(ref).max()))
                                + rtol * np.abs(ref))
    with open(out, "w") as f:
        json.dump(dict(rows=KERAS_LEG_ROWS, steps=KERAS_LEG_ROWS
                       // KERAS_LEG_BATCH, fit_s=fit_s,
                       scores_shape=list(got.shape),
                       max_abs_err=float(np.abs(got - ref).max()),
                       worst_over_rule=float(over.max()),
                       keras=keras.__version__), f)
    return 0 if over.max() <= 0 and np.isfinite(got).all() else 1


def keras_leg(root: str) -> dict:
    """``keras``: :func:`keras_worker` in a subprocess where keras and
    pyarrow import; otherwise the line says ``"ran": false`` and names
    what is missing, and nothing runs."""
    import importlib.util
    import os

    missing = [m for m in ("keras", "pyarrow")
               if importlib.util.find_spec(m) is None]
    if missing:
        rec = dict(phase="graph", leg="keras", ran=False,
                   missing=missing[0], nvidia_smi=smi())
        emit(rec)
        return rec
    out = os.path.join(root, "keras_leg.json")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--keras-leg", out],
                         env=dict(os.environ, KERAS_BACKEND="torch"),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out) as f:
        rec = dict(phase="graph", leg="keras", ran=True, **json.load(f),
                   nvidia_smi=smi())
    emit(rec)
    return rec


def phase_graph(torch) -> dict:
    """Phase s (module docstring): the graph toolkit at full width, then
    the Keras leg. A ``summary`` line gives the phase's seconds."""
    import tempfile

    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sparkdl_graph_") as root:
        recs = {"graph_resnet50": graph_leg(torch, root),
                "keras": keras_leg(root)}
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit(dict(phase="graph", leg="summary", seconds=seconds,
              budget_s=PHASE_S_BUDGET_S,
              within_budget=seconds <= PHASE_S_BUDGET_S,
              keras_leg_ran=recs["keras"]["ran"], nvidia_smi=smi()))
    recs["seconds"] = seconds
    return recs


# --- phase t: sequence parallelism, the mesh layer and the examples --------

ULYSSES_SHAPE = (1, 32, 16384, 128)  # llama3_8b's attention: B, H, S, D
ULYSSES_CHECK_S = 2048               # the plain version's check (its
                                     # scores at 16384 would be 34 GB)
RING_PROMPTS, RING_LEN, RING_NEW = 2, 4096, 8
RING_LAYERS = 2                      # llama3_8b's 32 layers cut to 2
# the ring's last prefill logits against the flash arm's (both keep the
# softmax in f32; the dense bf16 path rounds its scores, and on the CPU
# dry run sat 1.6e-2 from both), as a share of the largest dense logit:
# the bf16 bound of tests/test_torch_cuda.py::GEN_BF16_BOUND
RING_LOGIT_SHARE = 2.0 ** -6
EXAMPLE_MARKERS = {
    "torch_long_context_serving.py": ["bit-identical"],
    "torch_distributed_training.py": ["-device DP: loss"],
    "torch_transfer_learning.py": ["train accuracy"],
    "torch_generation_serving.py": ["ONE prefill + ONE decode program",
                                    "in-repo tokenizer only"],
}
PHASE_T_BUDGET_S = 90.0


def attention_bound(b: int, h: int, s: int, d: int, causal: bool,
                    elt: int) -> tuple:
    """(bound ms, by, flops, bytes) of one unmasked attention forward:
    q·kᵀ and p·v over the live pairs, q, k, v read and O written once,
    the f32 lse written."""
    pairs = b * h * (s * (s + 1) / 2 if causal else s * s)
    flops = 4.0 * d * pairs
    nbytes = 4 * b * h * s * d * elt + b * h * s * 4
    return (*bound(flops, nbytes, "bfloat16" if elt == 2 else "float32"),
            flops, nbytes)


def ulysses_flash(torch, kernels, mesh, flush) -> dict:
    """``ulysses_flash``: ``ulysses_attention(local_attn="auto")`` on the
    one-rank NCCL mesh at llama3_8b's attention shape, forward and
    gradient, against the bare flash kernel's call — bitwise, since the
    one-rank exchanges are copies — then at S = ULYSSES_CHECK_S against
    the plain version (fa.tc_bf16_tolerance forward, fa.bwd_tolerance
    gradient)."""
    import torch.nn.functional as F

    from sparkdl_tpu_torch.parallel import ulysses_attention

    fa = kernels[0]
    b, h, s, d = ULYSSES_SHAPE
    g = torch.Generator(device="cuda").manual_seed(40)
    q, k, v, do = (torch.randn((b, h, s, d), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))

    def uly(a, b_, c):
        return ulysses_attention(a, b_, c, mesh, axis="sp", causal=True,
                                 local_attn="auto")

    def bare(a, b_, c):
        return fa.flash_attention(a, b_, c, causal=True)

    def fwd_bwd(fn, xs, dout):
        leaves = [x.detach().requires_grad_(True) for x in xs]
        o = fn(*leaves)
        return (o.detach(), *torch.autograd.grad(o, leaves, dout))

    reset_counts(*kernels)
    got = fwd_bwd(uly, (q, k, v), do)
    torch.cuda.synchronize()
    launches = read_counts(*kernels)
    assert launches["flash_attention"] == 1, launches
    assert launches["flash_attention_bwd"] == 1, launches
    want = fwd_bwd(bare, (q, k, v), do)
    bitwise = {n: bool(torch.equal(a, w)) for n, a, w in
               zip(("o", "dq", "dk", "dv"), got, want)}
    assert all(bitwise.values()), bitwise
    del got, want

    qs, ks, vs, dos = (x[:, :, :ULYSSES_CHECK_S].contiguous()
                       for x in (q, k, v, do))
    o_s, *g_s = fwd_bwd(uly, (qs, ks, vs), dos)
    o_ref, lse_ref = fa.attention_plain(qs, ks, vs, True, None)
    err = check_close(o_s, o_ref, "bfloat16", "ulysses_flash forward",
                      fa.tc_bf16_tolerance(o_ref, fa.attention_abs_pv_plain(
                          qs, ks, vs, True, None)))
    o_k, lse_k = fa.flash_attention_fwd(qs, ks, vs, True)
    bargs = (qs, ks, vs, o_k, lse_k, dos, True, None)
    grad_err = max(check_close(gt, w, "bfloat16", f"ulysses_flash {n}",
                               fa.bwd_tolerance(w, a))
                   for n, gt, w, a in zip(
                       ("dq", "dk", "dv"), g_s, fa.attention_bwd_plain(*bargs),
                       fa.attention_bwd_abs_plain(*bargs)))
    plain_ms = time_ms(torch, lambda: fa.attention_plain(qs, ks, vs, True,
                                                         None), iters=3)
    del o_s, g_s, o_ref, lse_ref, o_k, lse_k, bargs

    with torch.no_grad():
        ms = time_ms(torch, lambda: uly(q, k, v), flush=flush)
        bare_ms = time_ms(torch, lambda: bare(q, k, v), flush=flush)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), flush=flush)
    fb_ms = time_ms(torch, lambda: fwd_bwd(uly, (q, k, v), do), iters=5,
                    flush=flush)
    bare_fb_ms = time_ms(torch, lambda: fwd_bwd(bare, (q, k, v), do),
                         iters=5, flush=flush)
    bms, by, flops, nbytes = attention_bound(b, h, s, d, True, 2)
    rec = dict(phase="parallel", leg="ulysses_flash",
               mesh={"sp": 1}, backend="nccl", local_attn="auto",
               variant=fa.kernel_variant(torch.bfloat16), dtype="bfloat16",
               shape=list(ULYSSES_SHAPE), causal=True,
               bitwise_to_bare_kernel=bitwise, launches=launches,
               check_s=ULYSSES_CHECK_S, max_abs_err=err,
               grad_max_abs_err=grad_err,
               tol_rule="forward fa.tc_bf16_tolerance, gradient "
                        "fa.bwd_tolerance (phase b's rules)",
               ms=ms, bare_ms=bare_ms, fwd_bwd_ms=fb_ms,
               bare_fwd_bwd_ms=bare_fb_ms, plain_ms_at_check_s=plain_ms,
               library_ms=library_ms,
               library="F.scaled_dot_product_attention(is_causal=True)",
               bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
               nvidia_smi=smi())
    emit(rec)
    del q, k, v, do
    torch.cuda.empty_cache()
    return rec


def teacher_forced(torch, model, prompts: list, stream: list,
                   new: int) -> dict:
    """Phase n's top-2-gap rule for one arm's greedy streams: each stream
    fed to ``model`` (one forward over prompt + stream, the dense arm);
    wherever the stream's token is not that forward's argmax, the top-2
    gap there must lie within the bf16 gate 10 × BF16_LOGIT_RTOL × (1 +
    max |logit|) (phase o's)."""
    compared, flips, identical = 0, [], 0
    for r, (p, st) in enumerate(zip(prompts, stream)):
        with torch.no_grad():
            logits = model(torch.tensor([p + st], device=model.device))[
                0, len(p) - 1:len(p) - 1 + new].float()
        top2 = logits.topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        gates = (10 * BF16_LOGIT_RTOL * (1 + logits.abs().amax(-1))).tolist()
        want = logits.argmax(-1).tolist()
        del logits
        identical += want == st
        for j, (t, w) in enumerate(zip(st, want)):
            compared += 1
            if t != w:
                assert gaps[j] <= gates[j], (
                    f"prompt {r}: the stream leaves the dense argmax at "
                    f"position {j} with a top-2 gap of {gaps[j]} > "
                    f"{gates[j]}")
                flips.append(dict(prompt=r, position=j, gap=gaps[j],
                                  gate=gates[j]))
    return dict(positions_compared=compared, dense_argmax_streams=identical,
                near_tie_flips=flips)


def ring_generate(torch, kernels, mesh) -> dict:
    """``ring_generate``: llama3_8b's widths cut to RING_LAYERS layers,
    bf16, seeded; RING_PROMPTS prompts of RING_LEN tokens, RING_NEW new,
    through ``generate()`` with the dense in-model path, the flash kernel
    and ring attention over the one-rank mesh. Each arm's prefill ms (one
    prefill into a fresh cache, CUDA events, three times), peak memory
    and launches; the ring's last prefill logits within RING_LOGIT_SHARE
    of the flash arm's (each arm's share against dense reported); the
    ring's and the flash arm's streams held to the dense model by
    :func:`teacher_forced`."""
    import dataclasses
    import functools

    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.parallel import ring_attention

    fa = kernels[0]
    cfg = dataclasses.replace(L.LlamaConfig.llama3_8b(),
                              num_layers=RING_LAYERS)
    model = L.LlamaModel(cfg, dtype=torch.bfloat16, attn_fn=None,
                         device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(42))
    ids = torch.randint(1, cfg.vocab_size, (RING_PROMPTS, RING_LEN),
                        generator=torch.Generator().manual_seed(42)
                        ).to("cuda")
    arms = {"dense": None, "flash": fa.flash_attention,
            "ring": functools.partial(ring_attention, mesh=mesh, axis="sp")}
    rec = dict(phase="parallel", leg="ring_generate",
               config="LlamaConfig.llama3_8b", layers=RING_LAYERS,
               depth_cut=f"32 -> {RING_LAYERS}", dtype="bfloat16",
               mesh={"sp": 1}, backend="nccl", prompts=RING_PROMPTS,
               prompt_len=RING_LEN, new_tokens=RING_NEW,
               ring_score_block_bytes=RING_PROMPTS * cfg.num_heads
               * RING_LEN ** 2 * 4, logit_share_limit=RING_LOGIT_SHARE,
               arms={})
    streams, last = {}, {}
    for arm, fn in arms.items():
        model.attn_fn = fn
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts(*kernels)
        out = L.generate(model, ids, RING_NEW)
        torch.cuda.synchronize()
        launches = read_counts(*kernels)
        streams[arm] = out[:, RING_LEN:].tolist()
        peak = torch.cuda.max_memory_allocated() - base
        pre = []
        for _ in range(3):
            cache = L.init_cache(model, RING_PROMPTS, RING_LEN + RING_NEW)
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            s_ev.record()
            last[arm] = L._prefill(model, ids, cache, None).float()
            e_ev.record()
            torch.cuda.synchronize()
            pre.append(s_ev.elapsed_time(e_ev))
            del cache
        rec["arms"][arm] = dict(prefill_ms=pre, peak_bytes_over_model=peak,
                                launches=launches)
        want_fa = RING_LAYERS if arm == "flash" else 0
        assert launches["flash_attention"] == want_fa, (arm, launches)
        torch.cuda.empty_cache()
    scale = last["dense"].abs().max().item()
    for arm in ("ring", "flash"):
        rec["arms"][arm]["prefill_logit_share_vs_dense"] = (
            last[arm] - last["dense"]).abs().max().item() / scale
    share = (last["ring"] - last["flash"]).abs().max().item() / scale
    rec["ring_vs_flash_logit_share"] = share
    assert share <= RING_LOGIT_SHARE, rec
    model.attn_fn = None
    prompts = ids.tolist()
    for arm in ("ring", "flash"):
        rec[f"{arm}_tokens"] = teacher_forced(torch, model, prompts,
                                              streams[arm], RING_NEW)
        rec[f"{arm}_tokens"]["equal_dense_stream"] = [
            a == b for a, b in zip(streams[arm], streams["dense"])]
    rec.update(streams=streams, nvidia_smi=smi())
    emit(rec)
    del model, last
    torch.cuda.empty_cache()
    return rec


def examples_leg() -> dict:
    """``examples``: the two distributed example twins as one-rank NCCL
    gangs (``python -m sparkdl_tpu_torch.runner.launcher --np 1``), started
    together at their default sizes; exit 0 and their marker lines,
    seconds each. The DataFrame twins run only where pyarrow and pandas
    import."""
    import importlib.util

    launch = ["-m", "sparkdl_tpu_torch.runner.launcher", "--np", "1"]
    cmds = {"torch_long_context_serving.py":
            launch + ["examples/torch_long_context_serving.py"],
            "torch_distributed_training.py":
            launch + ["examples/torch_distributed_training.py"]}
    missing = [m for m in ("pyarrow", "pandas")
               if importlib.util.find_spec(m) is None]
    rec = dict(phase="parallel", leg="examples", scripts={})
    for name in ("torch_transfer_learning.py",
                 "torch_generation_serving.py"):
        if missing:
            rec["scripts"][name] = dict(ran=False, missing=missing[0])
        else:
            cmds[name] = [f"examples/{name}"]
    for name, (rc, so, se, secs) in run_scripts(cmds).items():
        found = [m for m in EXAMPLE_MARKERS[name] if m in so]
        rec["scripts"][name] = dict(ran=True, rc=rc, seconds=secs,
                                    markers=found,
                                    stdout=so.strip().splitlines()[-2:])
        assert rc == 0 and found == EXAMPLE_MARKERS[name], (
            name, rc, so[-2000:], se[-4000:])
    rec["nvidia_smi"] = smi()
    emit(rec)
    return rec


def phase_parallel(torch, kernels) -> dict:
    """Phase t (module docstring): a one-rank NCCL gang joined through
    ``XlaRunner``, ``make_mesh({"sp": 1})``, the ``ulysses_flash`` and
    ``ring_generate`` legs, the gang left, then the ``examples`` leg. A
    ``summary`` line gives the phase's seconds against
    PHASE_T_BUDGET_S."""
    from sparkdl_tpu_torch.core.runtime import make_mesh
    from sparkdl_tpu_torch.runner import XlaRunner, launcher
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    t0 = time.perf_counter()
    runner = XlaRunner(device="cuda", num_processes=1, process_id=0,
                       coordinator=f"127.0.0.1:{launcher.free_port()}")
    assert runner.gang.backend == "nccl", runner.gang
    try:
        mesh = make_mesh({"sp": 1})
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                            device="cuda")
        recs = {"ulysses_flash": ulysses_flash(torch, kernels, mesh, flush)}
        del flush
        recs["ring_generate"] = ring_generate(torch, kernels, mesh)
    finally:
        leave_gang()
    torch.cuda.empty_cache()
    recs["examples"] = examples_leg()
    seconds = time.perf_counter() - t0
    emit(dict(phase="parallel", leg="summary", seconds=seconds,
              budget_s=PHASE_T_BUDGET_S,
              within_budget=seconds <= PHASE_T_BUDGET_S, nvidia_smi=smi()))
    recs["seconds"] = seconds
    return recs


# --- phase u: tensor-parallel serving ------------------------------------

TP_DEGREES = (2, 4, 8)         # the gangs whose ranks tp_shards emulates
TP_LAYERS = 8                  # llama3_8b's 32 layers cut to 8
TP_SLOTS, TP_NEW = 8, 32
TP_PROMPT_LENS = (64, 1024)    # TP_SLOTS seeded lengths drawn in this range
TP_CHUNK = 256                 # the stall-free prefill chunk
TP_CLIENTS = 4                 # tp_front's closed-loop client threads
PHASE_U_BUDGET_S = 120.0


def tp_shard_cases(torch, kernels) -> list:
    """The decode launches ``tp_shards`` cuts by heads: (name, kernel
    name, wrapper, plain version, [q, K, V, scale plane or None], the
    arguments after V, positions, query rows a KV head, live spans)."""
    _, fd, pfd = kernels
    b, s = len(PROMPT_LENS), PROMPT_LENS[0]
    pads = [s - n for n in PROMPT_LENS]
    length = s + NEW_TOKENS
    spans = [(p, s + 1) for p in pads]
    cases = []
    for name, hq in (("decode_step1", 16), ("llama3_8b_gqa", 32)):
        q, kc, vc, cur, pad = decode_inputs(
            torch, b=b, hq=hq, hkv=8, length=length, d=128, cur=s + 1,
            pads=pads, dtype="bfloat16")
        cases.append((name, "flash_decode", fd.flash_decode,
                      fd.flash_decode_plain, [q, kc, vc, None], (cur, pad),
                      length, hq // 8, spans))
    npos = PAGED_MB * PAGED_BS
    for kv in ("same", "int8"):
        for s_q in (1, 5):
            q, kp, vp, tables, cur, pad, sc = paged_inputs(
                torch, dtype="bfloat16", kv=kv, s_q=s_q, hq=32)
            cases.append((f"paged_{kv}_s{s_q}_32_8", "paged_flash_decode",
                          pfd.paged_flash_decode, pfd.paged_flash_decode_plain,
                          [q, kp, vp, sc], (tables, cur, pad), npos, s_q * 4,
                          [(p, min(c + s_q, npos))
                           for c, p in zip(PAGED_CUR, PAGED_PADS)]))
    return cases


def tp_shards(torch, kernels, flush) -> dict:
    """``tp_shards`` (module docstring): per case and tp, every rank's
    shard launch checked; the rank-0 shard and the full launch timed."""
    from sparkdl_tpu_torch.parallel import local_heads

    recs = {}
    for (name, kernel, fn, plain, heads, rest, npos, rows,
         spans) in tp_shard_cases(torch, kernels):
        def call(hs, **kw):
            scales = () if hs[3] is None else (hs[3],)
            if kernel == "paged_flash_decode":
                return fn(*hs[:3], *rest, *scales, **kw)
            return fn(*hs[:3], *rest, **kw)

        def plain_call(hs):
            if kernel == "paged_flash_decode":
                return plain(*hs[:3], *rest, hs[3])
            return plain(*hs[:3], *rest)

        full = call(heads)
        torch.cuda.synchronize()
        rec = dict(phase="tp", leg="tp_shards", case=name, kernel=kernel,
                   dtype="bfloat16", shape=[list(t.shape) for t in heads[:3]],
                   scale_plane=heads[3] is not None,
                   full_ms=time_ms(torch, lambda: call(heads), flush=flush),
                   tp={})
        tol, rtol = TOL["bfloat16"]
        for tp in TP_DEGREES:
            errs, bitwise, blocks = [], [], None
            for r in range(tp):
                hs = [None if t is None else local_heads(t, r, tp)
                      for t in heads]
                out = call(hs)
                torch.cuda.synchronize()
                bitwise.append(bool(torch.equal(out,
                                                local_heads(full, r, tp))))
                errs.append(check_close(out, plain_call(hs), "bfloat16",
                                        f"{name} tp {tp} rank {r}"))
                split = split_record(torch, lambda c: call(hs,
                                                           block_counter=c),
                                     npos, rows, spans, 8 // tp)
                blocks = blocks or split
            assert all(bitwise), (name, tp, bitwise)
            hs = [None if t is None else local_heads(t, 0, tp)
                  for t in heads]
            rec["tp"][tp] = dict(
                kv_heads=8 // tp, bitwise_to_full_heads=all(bitwise),
                max_abs_err=max(errs), tol=tol, rtol=rtol,
                shard_ms=time_ms(torch, lambda: call(hs), flush=flush),
                **{k: blocks[k] for k in ("n_splits", "rows_per_block",
                                          "grid_blocks", "live_blocks")})
        rec["nvidia_smi"] = smi()
        emit(rec)
        recs[name] = rec
    return recs


def tp_collectives(torch, mesh) -> dict:
    """``tp_collectives``: what one eager call of each collective the tp
    model issues (``all_reduce`` of a decode step's hidden state, the
    logits' ``all_gather`` of a prefill chunk) costs the host on the
    one-rank mesh: the call's host ms right after a ~SLEEP_MS device
    sleep was queued (a call that waits for the device takes about the
    sleep), beside an ``add_`` on the same tensor; and the call's device
    ms between CUDA events."""
    import torch.distributed as dist

    g = mesh.get_group("tp")
    hidden = torch.zeros((8, 1, 4096), dtype=torch.bfloat16, device="cuda")
    logits = torch.zeros((1, TP_CHUNK, 128256), device="cuda")
    cycles = SLEEP_CYCLES * 20
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    sleep_ms = (time.perf_counter() - t0) * 1e3

    def gather():
        parts = [torch.empty_like(logits)]
        dist.all_gather(parts, logits, group=g)

    calls = {"add_": lambda: hidden.add_(0),
             "all_reduce": lambda: dist.all_reduce(hidden, group=g),
             "all_gather_logits": gather}
    rec = dict(phase="tp", leg="tp_collectives", mesh={"tp": 1},
               backend="nccl", sleep_ms=sleep_ms, calls={})
    for name, fn in calls.items():
        fn()
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        rec["calls"][name] = dict(host_ms_behind_sleep=host,
                                  device_ms=time_ms(torch, fn))
    rec["nvidia_smi"] = smi()
    emit(rec)
    return rec


def tp_model(torch, fa):
    """Phase u's model: llama3_8b widths, TP_LAYERS layers, bf16, seed
    21, the flash kernels as its attention."""
    import dataclasses

    from sparkdl_tpu_torch.models import llama as L

    cfg = dataclasses.replace(L.LlamaConfig.llama3_8b(),
                              num_layers=TP_LAYERS)
    return L.LlamaModel(cfg, dtype=torch.bfloat16,
                        attn_fn=fa.flash_attention, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(21))


def tp_prompts(torch, cfg) -> list:
    """Phase u's TP_SLOTS seeded prompts of TP_PROMPT_LENS tokens."""
    g = torch.Generator().manual_seed(21)
    lens = torch.randint(TP_PROMPT_LENS[0], TP_PROMPT_LENS[1] + 1,
                         (TP_SLOTS,), generator=g).tolist()
    return [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
            for n in lens]


def tp_serve(torch, kernels, mesh) -> dict:
    """``tp_serve`` (module docstring): per backend family the base arm,
    then the tensor-parallel arm at tp = 1 on ``mesh``, on one model."""
    import gc

    from sparkdl_tpu_torch import GenerationEngine
    from sparkdl_tpu_torch.parallel import dispatch_counter
    from sparkdl_tpu_torch.serving import backend as B

    fa = kernels[0]
    model = tp_model(torch, fa)
    prompts = tp_prompts(torch, model.cfg)
    max_len = TP_PROMPT_LENS[1] + TP_NEW
    counters = {n: dispatch_counter(n)
                for n in ("flash_decode", "paged_flash_decode")}
    warm = GenerationEngine(B.PagedLlamaSlotBackend(model, TP_SLOTS, 128),
                            prefill_chunk=TP_CHUNK)
    serve_leg(torch, model, kernels, leg="tp_warm-up",
              prompts=[prompts[0][:64]], new=4, engine=warm)
    del warm
    families = {
        "paged": (B.PagedLlamaSlotBackend,
                  B.TensorParallelPagedLlamaSlotBackend,
                  dict(block_size=16), "paged_flash_decode"),
        "unpaged": (B.LlamaSlotBackend, B.TensorParallelLlamaSlotBackend,
                    {}, "flash_decode")}
    out = {}
    for fam, (base_cls, tp_cls, kw, kernel) in families.items():
        arms = {}
        for arm in ("base", "tp"):
            if arm == "base":
                be = base_cls(model, TP_SLOTS, max_len, **kw)
            else:
                be = tp_cls(model, TP_SLOTS, max_len, tp=1, mesh=mesh, **kw)
            eng = GenerationEngine(be, prefill_chunk=TP_CHUNK)
            for c in counters.values():
                c.launches = 0
            rec, eng = serve_leg(torch, model, kernels, leg=f"{fam}_{arm}",
                                 prompts=prompts, new=TP_NEW,
                                 max_len=max_len,
                                 config="LlamaConfig.llama3_8b",
                                 keep_streams=True, engine=eng)
            rec.update(phase="tp", backend=type(be).__name__,
                       tp_degree=eng.tp_degree,
                       dispatch={n: c.launches for n, c in counters.items()},
                       kv_pool_device_bytes=eng.kv_pool_device_bytes,
                       prefill_chunk=TP_CHUNK)
            steps = rec["steps"]
            lc = rec["launches"]
            assert lc[kernel] == TP_LAYERS * steps > 0, rec
            assert lc["flash_attention"] == 0, rec
            want = TP_LAYERS * steps if arm == "tp" else 0
            assert rec["dispatch"][kernel] == want, rec
            if fam == "unpaged":  # where a prefill chunk's time goes
                chunk = prompts[0][:TP_CHUNK]
                steady = []
                for _ in range(8):  # host clock; each call ends synced
                    t0 = time.perf_counter()
                    be.prefill_chunk(0, chunk, 0, TP_CHUNK, TP_CHUNK)
                    steady.append((time.perf_counter() - t0) * 1e3)
                rec["chunk_steady_ms"] = steady
                rec["chunk_profile"] = device_profile(
                    torch, lambda: be.prefill_chunk(0, chunk, 0, TP_CHUNK,
                                                    TP_CHUNK), 4,
                    f"4 prefill chunks of {TP_CHUNK} into slot 0, {arm} "
                    f"arm, llama3_8b widths, {TP_LAYERS} layers, bf16",
                    match="nccl")
            if arm == "tp":
                arms["front"] = tp_front(torch, kernels, fam, model, eng,
                                         prompts, rec, kernel)
            arms[arm] = rec
            del eng, be
            gc.collect()  # a backend and its graphs hold each other
            torch.cuda.empty_cache()
        base, tp = arms["base"], arms["tp"]
        assert tp["streams"] == base["streams"], (fam, "streams differ")
        front = arms.pop("front")
        assert tp["kv_pool_device_bytes"] == base["kv_pool_device_bytes"]
        model.attn_fn = None
        tokens = teacher_forced(torch, model, prompts, base["streams"],
                                TP_NEW)
        model.attn_fn = fa.flash_attention
        for rec in (base, tp):
            rec["dense_tokens"] = tokens
            rec["streams_equal_base"] = rec["streams"] == base["streams"]
            rec["nvidia_smi"] = smi()
            emit({k: v for k, v in rec.items() if k != "streams"})
        out[fam] = dict(arms=arms, front=front, iter_ms_tp_minus_base=(
            tp["decode_iter_ms_mean"] - base["decode_iter_ms_mean"]),
            chunk_ms_tp_minus_base=(tp["prefill_chunk_ms_mean"]
                                    - base["prefill_chunk_ms_mean"]))
    del model
    torch.cuda.empty_cache()
    return out


def _pct(xs: list, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")


def tp_front(torch, kernels, fam: str, model, eng, prompts: list,
             inline: dict, kernel: str) -> dict:
    """``tp_front`` (module docstring) on the tp arm's engine ``eng`` over
    ``model``, which ``inline`` (its ``serve_leg`` record) drove
    inline."""
    import threading

    from sparkdl_tpu_torch.parallel import dispatch_counter

    front = eng._front
    assert front is not None and front.leader, "no front on the tp arm"
    iter_s, ctl = [], []
    inner, message = eng._step_inner, front.channel.message

    def timed_iter():
        t0 = time.perf_counter()
        out = inner()  # returns after the host has the tokens
        iter_s.append(time.perf_counter() - t0)
        return out

    def timed_message(head, payload=b""):
        t0 = time.perf_counter()
        out = message(head, payload)
        ctl.append((out[0], time.perf_counter() - t0))
        return out

    eng._step_inner = timed_iter
    front.channel.message = timed_message

    def started(fn):
        eng.start()
        try:
            return fn()
        finally:
            eng.stop(drain=True, timeout=60)

    def clients():
        hs = [None] * len(prompts)

        def client(k):
            for i in range(k, len(prompts), TP_CLIENTS):
                hs[i] = eng.submit(prompts[i], max_new_tokens=TP_NEW)
                hs[i].result(120)

        ts = [threading.Thread(target=client, args=(k,))
              for k in range(TP_CLIENTS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return hs

    counter = dispatch_counter(kernel)
    steps0, msgs0 = eng.stats["steps"], dict(front.stats)
    torch.cuda.synchronize()
    counter.launches = 0
    reset_counts(*kernels)
    t0 = time.perf_counter()
    hs = started(clients)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(*kernels)
    dispatched = counter.launches
    steps = eng.stats["steps"] - steps0
    streams = [h.result(1) for h in hs]
    assert streams == inline["streams"], (fam, "tp_front streams differ")
    assert launches[kernel] == dispatched == TP_LAYERS * steps > 0, (
        launches, dispatched, steps)
    assert launches["flash_attention"] == 0, launches
    n_new = sum(len(t) for t in streams)
    step_ctl = [1e3 * dt for kind, dt in ctl if kind == 1]
    rec = dict(
        phase="tp", leg="tp_front", family=fam,
        backend=type(eng.backend).__name__, clients=TP_CLIENTS,
        requests=len(prompts), new_tokens=n_new, wall_s=wall,
        new_tokens_per_s=n_new / wall,
        inline_new_tokens_per_s=inline["new_tokens_per_s"],
        started_over_inline=(n_new / wall) / inline["new_tokens_per_s"],
        iterations=len(iter_s), steps=steps,
        iter_ms_mean=1e3 * sum(iter_s) / max(len(iter_s), 1),
        iter_ms_p50=1e3 * _pct(iter_s, 0.5),
        inline_decode_iter_ms_mean=inline["decode_iter_ms_mean"],
        control_ms_p50=_pct(step_ctl, 0.5),
        control_ms_p95=_pct(step_ctl, 0.95),
        control_ms_max=max(step_ctl),
        messages=front.stats["messages"] - msgs0["messages"],
        idle_messages=front.stats["idle_messages"]
        - msgs0["idle_messages"],
        launches=launches, dispatch={kernel: dispatched},
        streams_bitwise_inline=True)

    # one cancel and one deadline, in one started run
    def cancel_deadline():
        hc = eng.submit(prompts[0], max_new_tokens=TP_NEW)
        hd = eng.submit(prompts[1], max_new_tokens=TP_NEW, deadline_s=0.05)
        t_end = time.time() + 120
        while len(hc.tokens) < 2 and not hc.done:
            assert time.time() < t_end, (fam, "no token to cancel after")
            time.sleep(0.001)
        threading.Thread(target=hc.cancel).start()
        hc.wait(60)
        hd.wait(60)
        return hc, hd
    cancelled0 = eng.stats["cancelled"]
    hc, hd = started(cancel_deadline)
    assert hc.finish_reason == "cancelled" and \
        hd.finish_reason == "deadline", (hc, hd)
    assert eng.stats["cancelled"] - cancelled0 == 2
    assert not eng._queue and all(r is None for r in eng._slots)
    rec["cancel"] = dict(reason=hc.finish_reason, tokens=len(hc.tokens))
    rec["deadline"] = dict(reason=hd.finish_reason, tokens=len(hd.tokens),
                           deadline_s=0.05)

    # drain mid-stream, then resume on the restarted engine
    eng.start()
    hs = [eng.submit(p, max_new_tokens=TP_NEW) for p in prompts[2:4]]
    t_end = time.time() + 120
    while sum(len(h.tokens) for h in hs) < 4:
        assert time.time() < t_end, (fam, "no token before the drain")
        time.sleep(0.001)
    snaps = eng.drain(timeout=60)
    at_drain = {s_.id: len(s_.tokens) for s_ in snaps}

    def resume():
        for s_ in snaps:
            eng.resume(s_)
        for h in hs:
            h.wait(120)
    started(resume)
    assert snaps, (fam, "the drain caught no live request")
    got, clean = [h.result(1) for h in hs], inline["streams"][2:4]
    rec["drain_resume"] = dict(
        snapshots=len(snaps), tokens_at_drain=list(at_drain.values()),
        resumed_bitwise_uninterrupted=got == clean,
        **fleet_vs_clean(got, clean, fleet_gaps(
            torch, model, prompts[2:4], clean, TP_NEW),
            [at_drain.get(h.id) for h in hs]))
    eng._step_inner = inner
    front.channel.message = message
    rec["nvidia_smi"] = smi()
    emit(rec)
    return rec


def phase_tp(torch, kernels) -> dict:
    """Phase u (module docstring): a one-rank NCCL gang joined through
    ``XlaRunner``, ``tp_mesh(1)``, the ``tp_shards`` and ``tp_serve``
    legs, the gang left. A ``summary`` line gives the phase's seconds
    against PHASE_U_BUDGET_S."""
    from sparkdl_tpu_torch.runner import XlaRunner, launcher
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang
    from sparkdl_tpu_torch.serving.backend import tp_mesh

    t0 = time.perf_counter()
    runner = XlaRunner(device="cuda", num_processes=1, process_id=0,
                       coordinator=f"127.0.0.1:{launcher.free_port()}")
    assert runner.gang.backend == "nccl", runner.gang
    try:
        mesh = tp_mesh(1)
        assert mesh.device_type == "cuda" and mesh.size() == 1
        flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                            device="cuda")
        recs = {"tp_shards": tp_shards(torch, kernels, flush)}
        del flush
        recs["tp_collectives"] = tp_collectives(torch, mesh)
        recs["tp_serve"] = tp_serve(torch, kernels, mesh)
    finally:
        leave_gang()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit(dict(phase="tp", leg="summary", seconds=seconds,
              budget_s=PHASE_U_BUDGET_S,
              within_budget=seconds <= PHASE_U_BUDGET_S,
              iter_ms_tp_minus_base={
                  f: r["iter_ms_tp_minus_base"]
                  for f, r in recs["tp_serve"].items()},
              chunk_ms_tp_minus_base={
                  f: r["chunk_ms_tp_minus_base"]
                  for f, r in recs["tp_serve"].items()},
              front_control_ms_p50={
                  f: r["front"]["control_ms_p50"]
                  for f, r in recs["tp_serve"].items()},
              front_started_over_inline={
                  f: r["front"]["started_over_inline"]
                  for f, r in recs["tp_serve"].items()},
              nvidia_smi=smi()))
    recs["seconds"] = seconds
    return recs


# --- phase v: sharded training ---------------------------------------------

FSDP_LAYERS, FSDP_STEPS, FSDP_LR = 4, 3, 1e-3  # llama3_8b widths, 4 layers
# Switch-Base-8 (Fedus et al. 2021; HF google/switch-base-8): d_model 768,
# d_ff 3072, 8 experts, capacity factor 1.25; 8 x 512 tokens
MOE_D, MOE_FF, MOE_E, MOE_CF = 768, 3072, 8, 1.25
MOE_BATCH, MOE_SEQ = 8, 512
GPIPE_MICRO, GPIPE_SEQ = 4, 2048  # microbatches of 1 x 2048
RUNNER_BATCHES, RUNNER_BATCH = 4, 64  # ResNet50 at 224
PHASE_V_BUDGET_S = 90.0


def sharded_arm(torch, kernels, cfg, ids, mesh) -> tuple:
    """One arm of ``fsdp_tp_train``: the seeded bf16 model (placed on
    ``mesh`` through ``shard_model`` when given), full-parameter sgd,
    FSDP_STEPS steps of phase g's batch. Returns (record, state)."""
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.parallel import fsdp
    from sparkdl_tpu_torch.runner.train_state import (TrainState,
                                                      make_train_step, sgd)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = L.LlamaModel(cfg, dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    if mesh is not None:
        model = L.shard_model(model, mesh)
        step = make_train_step(L.causal_lm_loss_fn(), mesh=mesh,
                               param_rules=L.training_rules(mesh))
    else:
        step = make_train_step(L.causal_lm_loss_fn())
    state = TrainState.create(model, sgd(FSDP_LR))
    batch = {"input_ids": torch.as_tensor(ids).cuda()}
    reset_counts(*kernels)
    fsdp.reset_collectives()
    losses, step_ms = [], []
    for _ in range(FSDP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts(*kernels)
    colls = {k: v / FSDP_STEPS for k, v in fsdp.COLLECTIVES.items()}
    nl = cfg.num_layers
    assert all(math.isfinite(x) for x in losses), losses
    assert launches["flash_attention"] == nl * FSDP_STEPS, launches
    assert launches["flash_attention_bwd"] == nl * FSDP_STEPS, launches
    if mesh is not None:
        # 2 + 7 a layer data-sharded weights: gathered once a step each
        # in the forward and, but the embedding, again in the backward
        # (parallel.fsdp.linear keeps only the shard between), embed and
        # logits gathered over model, the reduce-scatters
        assert colls["all_gather"] == 2 + 7 * nl + 2 + 7 * nl + 1, colls
        assert colls["reduce_scatter"] == 2 + 7 * nl, colls
    med = sorted(step_ms)[len(step_ms) // 2]
    rec = dict(arm="sharded" if mesh is not None else "unsharded",
               mesh=None if mesh is None else dict(zip(
                   mesh.mesh_dim_names, mesh.mesh.shape)),
               losses=losses, step_ms=step_ms, step_ms_median=med,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / med * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               param_gb=sum(p.numel() * p.element_size()
                            for p in state.model.parameters()) / 1e9,
               launches=launches, collectives_per_step=colls)
    return rec, state


def fsdp_tp_train(torch, kernels, mesh) -> tuple:
    """``fsdp_tp_train`` (module docstring). Returns (record, the sharded
    arm's state)."""
    import dataclasses

    from sparkdl_tpu_torch.parallel import fsdp

    cfg = dataclasses.replace(L_cfg(), num_layers=FSDP_LAYERS)
    ids = train_ids(torch, cfg)
    base, base_state = sharded_arm(torch, kernels, cfg, ids, None)
    # held on the host, so each arm's peak is its own
    want = {k: v.detach().cpu()
            for k, v in base_state.model.state_dict().items()}
    del base_state
    torch.cuda.empty_cache()
    arm, state = sharded_arm(torch, kernels, cfg, ids, mesh)
    got = fsdp.full_state_dict(state.model, sink=lambda t: t.cpu())
    assert set(got) == set(want)
    diff = max((got[k].float() - want[k].float()).abs().max().item()
               for k in want)
    bitwise = all(torch.equal(got[k], want[k]) for k in want)
    assert arm["losses"] == base["losses"], (arm["losses"], base["losses"])
    assert bitwise, f"sharded params differ from the unsharded: {diff}"
    del got, want
    # ZeRO-3 keeps no gathered weight from the forward to the backward:
    # held, they would add the whole model to the sharded arm's peak
    over = arm["peak_gb"] - base["peak_gb"]
    assert over < 0.5 * arm["param_gb"], (over, arm["param_gb"])
    rec = dict(phase="sharded", leg="fsdp_tp_train",
               config=f"LlamaConfig.llama3_8b(), {FSDP_LAYERS} layers",
               dtype="bfloat16", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               steps=FSDP_STEPS, optimizer=f"sgd({FSDP_LR})",
               attn="flash kernels (auto)", arms=[base, arm],
               params_bitwise=bitwise, params_max_abs_diff=diff,
               peak_over_unsharded_gb=over, nvidia_smi=smi())
    emit(rec)
    return rec, state


def L_cfg():
    from sparkdl_tpu_torch.models import llama as L
    return L.LlamaConfig.llama3_8b()


def sharded_ckpt(torch, state, mesh) -> dict:
    """``sharded_ckpt``: ``fsdp_tp_train``'s sharded state saved (global
    tensors) and restored into a freshly placed model through
    ``restore(mesh=, rules=)``; bit-identical."""
    import os
    import shutil
    import tempfile

    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.parallel import fsdp
    from sparkdl_tpu_torch.runner.checkpoint import CheckpointManager
    from sparkdl_tpu_torch.runner.train_state import TrainState, sgd

    root = tempfile.mkdtemp(prefix="sparkdl_sharded_ckpt_")
    try:
        man = CheckpointManager(root, async_save=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        man.save(state.step, state, wait=True)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(root, str(state.step),
                                              "state.pt"))
        fresh = TrainState.create(L.shard_model(L.LlamaModel(
            state.model.cfg, dtype=torch.bfloat16, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(1)),
            mesh), sgd(FSDP_LR))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        man.restore(fresh, mesh=mesh, rules=L.training_rules(mesh))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        man.close()
        a, b = (fsdp.placement(s.model).locals for s in (state, fresh))
        equal = all(torch.equal(a[k], b[k]) for k in a)
        assert equal and fresh.step == state.step
        with open(os.path.join(root, f"manifest_step_{state.step}.json")
                  ) as f:
            topo = json.load(f)["topology"]
        assert topo["mesh_shape"] == {"data": 1, "model": 1}, topo
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec = dict(phase="sharded", leg="sharded_ckpt", bytes=nbytes,
               save_s=save_s, restore_s=restore_s, bit_identical=equal,
               mesh=topo["mesh_shape"], nvidia_smi=smi())
    emit(rec)
    return rec


def moe_leg(torch, mesh) -> dict:
    """``moe``: SwitchMoE at Switch-Base-8's widths on ``{"ep": 1}``
    against the unsharded module from the same seeded weights: output
    and gradients (parameters and input) bitwise; forward + backward
    ms of each, timed in turns (unsharded, ep, ep, unsharded)."""
    from sparkdl_tpu_torch.parallel import moe as M

    glob = M.SwitchMoE(MOE_D, MOE_E, MOE_FF, capacity_factor=MOE_CF,
                       dtype=torch.bfloat16, device="cuda",
                       generator=torch.Generator(device="cuda")
                       .manual_seed(0))
    local = M.shard_moe(glob, mesh)
    x = torch.randn((MOE_BATCH, MOE_SEQ, MOE_D), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1)
                    ).to(torch.bfloat16)

    def run(m):
        xi = x.detach().clone().requires_grad_(True)
        m.zero_grad(set_to_none=True)
        inter = {}
        y = m(xi, intermediates=inter)
        ((y.float() ** 2).sum() + M.moe_aux_loss(inter)).backward()
        return y, xi.grad, {n: p.grad for n, p in m.named_parameters()}

    y0, gx0, g0 = run(glob)
    y1, gx1, g1 = run(local)
    assert torch.equal(y0, y1) and torch.equal(gx0, gx1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0), {
        n: (g0[n] - g1[n]).abs().max().item() for n in g0}
    assert torch.isfinite(y1).all()
    cap = glob.capacity(MOE_BATCH * MOE_SEQ)
    rec = dict(phase="sharded", leg="moe",
               config="Switch-Base-8 (d_model 768, d_ff 3072, 8 experts, "
                      "capacity factor 1.25)", dtype="bfloat16",
               tokens=MOE_BATCH * MOE_SEQ, capacity=cap, mesh={"ep": 1},
               output_and_grads_bitwise=True, nvidia_smi=smi())
    for arm in ("unsharded", "ep", "ep", "unsharded"):
        m = glob if arm == "unsharded" else local
        rec.setdefault(f"fwd_bwd_ms_{arm}", []).append(
            time_ms(torch, lambda: run(m), 5))
    emit(rec)
    return rec


def gpipe_leg(torch, kernels, mesh) -> dict:
    """``gpipe``: one llama3_8b-width decoder block as the stage on
    ``{"pp": 1}``, GPIPE_MICRO microbatches of 1 x GPIPE_SEQ, forward:
    bitwise the block applied to each microbatch in turn; one flash
    launch a microbatch."""
    from torch.func import functional_call

    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.ops.flash_attention import resolve_attn_fn
    from sparkdl_tpu_torch.parallel import (gpipe, microbatch,
                                            stack_stage_params,
                                            stage_sharding)

    cfg = L_cfg()
    layer = L.LlamaLayer(cfg, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if not name.endswith("scale"):
                p.copy_(torch.randn(p.shape, generator=g, device="cuda")
                        / math.sqrt(p.shape[1]))
    attn = resolve_attn_fn("auto")
    pos = torch.arange(GPIPE_SEQ, device="cuda")

    def stage_fn(params, h):
        return functional_call(layer, params, (h, pos, attn))

    stacked = stage_sharding(mesh, stack_stage_params(
        [{k: v.detach() for k, v in layer.named_parameters()}]), "pp")
    x = microbatch(torch.randn((GPIPE_MICRO, GPIPE_SEQ, cfg.hidden_size),
                               device="cuda", generator=g)
                   .to(torch.bfloat16), GPIPE_MICRO)
    apply = gpipe(stage_fn, mesh, "pp", remat=False)
    with torch.no_grad():
        reset_counts(*kernels)
        y = apply(stacked, x)
        launches = read_counts(*kernels)
        ref = torch.stack([layer(x[i], pos, attn)
                           for i in range(GPIPE_MICRO)])
        assert torch.equal(y, ref), (y.float() - ref.float()).abs().max()
        assert launches["flash_attention"] == GPIPE_MICRO, launches
        rec = dict(phase="sharded", leg="gpipe", mesh={"pp": 1},
                   stage="LlamaLayer at llama3_8b widths",
                   microbatches=GPIPE_MICRO, microbatch_shape=[1, GPIPE_SEQ],
                   dtype="bfloat16", bitwise_to_sequential=True,
                   launches=launches,
                   gpipe_ms=time_ms(torch, lambda: apply(stacked, x), 5),
                   sequential_ms=time_ms(torch, lambda: [
                       layer(x[i], pos, attn) for i in range(GPIPE_MICRO)],
                       5), nvidia_smi=smi())
    emit(rec)
    return rec


def batch_runner_mesh(torch, mesh) -> dict:
    """``batch_runner_mesh``: the ResNet50 featurizer's device step through
    ``BatchRunner(mesh={"data": 1})`` and ``mesh=None``, RUNNER_BATCHES
    seeded uint8 batches of RUNNER_BATCH at 224: outputs bitwise; rows/s
    of each, in turns (single, mesh, mesh, single), each runner warmed
    by one batch first."""
    import numpy as np

    from sparkdl_tpu_torch.core.runtime import BatchRunner
    from sparkdl_tpu_torch.transformers import DeepImageFeaturizer

    f = DeepImageFeaturizer(modelName="ResNet50", computeDtype="bfloat16",
                            batchSize=RUNNER_BATCH, seed=0)
    inner = f._get_runner()
    rng = np.random.default_rng(5)
    wire = [rng.integers(0, 256, (RUNNER_BATCH, 224, 224, 3), np.uint8)
            for _ in range(RUNNER_BATCHES)]
    outs, rate = {}, {"single": [], "mesh": []}
    runners = {arm: BatchRunner(inner._fn, RUNNER_BATCH, mesh=m,
                                input_cast=inner._input_cast,
                                preprocess=inner._preprocess, device="cuda")
               for arm, m in (("single", None), ("mesh", mesh))}
    for r in runners.values():
        list(r.run(wire[:1]))
    for arm in ("single", "mesh", "mesh", "single"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[arm] = list(runners[arm].run(wire))
        rate[arm].append(RUNNER_BATCHES * RUNNER_BATCH
                         / (time.perf_counter() - t0))
    for a, b in zip(outs["single"], outs["mesh"]):
        assert np.array_equal(a, b)
    rec = dict(phase="sharded", leg="batch_runner_mesh", model="ResNet50",
               dtype="bfloat16", batches=RUNNER_BATCHES,
               batch=RUNNER_BATCH, mesh={"data": 1}, bitwise=True,
               rows_per_s=rate, nvidia_smi=smi())
    emit(rec)
    return rec


def phase_sharded(torch, kernels) -> dict:
    """Phase v (module docstring): a one-rank NCCL gang joined as phase
    t's, the five legs on one-rank meshes, the gang left. A ``summary``
    line gives the phase's seconds against PHASE_V_BUDGET_S."""
    import gc

    from sparkdl_tpu_torch.core.runtime import make_mesh
    from sparkdl_tpu_torch.runner import XlaRunner, launcher
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    legs_s = {}
    runner = XlaRunner(device="cuda", num_processes=1, process_id=0,
                       coordinator=f"127.0.0.1:{launcher.free_port()}")
    assert runner.gang.backend == "nccl", runner.gang
    try:
        mesh = make_mesh({"data": 1, "model": 1})
        t = time.perf_counter()
        recs = {}
        recs["fsdp_tp_train"], state = fsdp_tp_train(torch, kernels, mesh)
        legs_s["fsdp_tp_train"] = time.perf_counter() - t
        t = time.perf_counter()
        recs["sharded_ckpt"] = sharded_ckpt(torch, state, mesh)
        legs_s["sharded_ckpt"] = time.perf_counter() - t
        del state
        gc.collect()
        torch.cuda.empty_cache()
        for leg, fn, axes in (("moe", moe_leg, {"ep": 1}),
                              ("gpipe", lambda t_, m: gpipe_leg(
                                  t_, kernels, m), {"pp": 1}),
                              ("batch_runner_mesh", batch_runner_mesh,
                               {"data": 1})):
            t = time.perf_counter()
            recs[leg] = fn(torch, make_mesh(axes))
            legs_s[leg] = time.perf_counter() - t
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        leave_gang()
    seconds = time.perf_counter() - t0
    emit(dict(phase="sharded", leg="summary", seconds=seconds,
              legs_s=legs_s, budget_s=PHASE_V_BUDGET_S,
              within_budget=seconds <= PHASE_V_BUDGET_S, nvidia_smi=smi()))
    recs["seconds"] = seconds
    return recs


# --- phase w: a fleet of tensor-parallel groups in other processes -------

W_GROUPS = {"a": "paged", "b": "paged", "c": "unpaged"}
W_REF_GROUP = "c"              # survives both faults: runs the clean engines
W_CHANNEL_TIMEOUT_S = 30.0     # a RemoteEngine's read and round-trip limit
W_WAIT_S = 300.0               # the longest any wait of phase w may take
W_WRITE_S = 0.25               # how often a group writes its counts
PHASE_W_BUDGET_S = 90.0


def w_engine(torch, model, family: str):
    """A group's engine: phase u's arm of ``family`` built through
    ``from_model`` on the one-rank ``tp_mesh(1)``."""
    from sparkdl_tpu_torch import GenerationEngine
    from sparkdl_tpu_torch.serving.backend import tp_mesh

    kw = dict(block_size=16) if family == "paged" else {}
    return GenerationEngine.from_model(
        model, mesh=tp_mesh(1), num_slots=TP_SLOTS,
        max_len=TP_PROMPT_LENS[1] + TP_NEW, prefill_chunk=TP_CHUNK,
        device="cuda", **kw)


def fleet_group_worker(d: str, name: str) -> int:
    """Phase w's group (``chip_smoke.py --fleet-group-worker <dir>
    <name>``, a one-rank gang of ``launcher.launch``): joins its NCCL gang,
    builds phase u's model and its family's engine on ``tp_mesh(1)``,
    warms it (one short request inline: the decode graph's capture), then
    serves the fleet behind a ``FrontServer`` (its address and pid in
    ``<dir>/<name>.addr``). After every engine iteration it checks that
    the family's kernel launches = dispatch calls = TP_LAYERS × steps and
    that nothing else launched, and writes its counts to
    ``<dir>/<name>.json`` every W_WRITE_S and at the end. Group
    W_REF_GROUP then serves both families' clean engines the prompts
    inline and writes their streams and phase o's gaps to
    ``<dir>/clean.json``."""
    import os
    import threading

    import torch

    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.ops import flash_decode as fd
    from sparkdl_tpu_torch.ops import paged_flash_decode as pfd
    from sparkdl_tpu_torch.parallel import dispatch_counter
    from sparkdl_tpu_torch.runner import XlaRunner
    from sparkdl_tpu_torch.runner.events import atomic_write_json
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang
    from sparkdl_tpu_torch.serving.remote import FrontServer

    spec = json.loads((Path(d) / "spec.json").read_text())
    family = W_GROUPS[name]
    kernel = "paged_flash_decode" if family == "paged" else "flash_decode"
    kernels = (fa, fd, pfd)
    runner = XlaRunner(device="cuda")
    assert runner.gang.backend == "nccl", runner.gang
    model = tp_model(torch, fa)
    prompts = spec["prompts"]
    eng = w_engine(torch, model, family)
    warm = eng.submit(prompts[0][:64], max_new_tokens=4)
    eng.run_until_idle()
    warm.result(1)
    counter = dispatch_counter(kernel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0 = eng.stats["steps"]
    counter.launches = 0
    reset_counts(*kernels)
    rec = dict(group=name, family=family, kernel=kernel, pid=os.getpid(),
               consistent=True, violation=None)
    lock = threading.Lock()

    def counts():
        c = read_counts(*kernels)
        return dict(c, dispatch=counter.launches,
                    steps=eng.stats["steps"] - steps0)

    def check(c) -> bool:
        want = TP_LAYERS * c["steps"]
        others = {k: v for k, v in c.items() if k not in (
            kernel, "dispatch", "steps")}
        return c[kernel] == c["dispatch"] == want and not any(
            others.values())

    inner = eng._step_inner
    last = [0.0]

    def step_inner():
        out = inner()  # the step's host tokens are in: its launches ran
        c = counts()
        with lock:
            if rec["consistent"] and not check(c):
                rec.update(consistent=False, violation=c)
            if time.time() - last[0] >= W_WRITE_S:
                last[0] = time.time()
                write(c)
        return out

    def write(c):
        atomic_write_json(Path(d) / f"{name}.json", dict(
            rec, counts=c, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            engine_stats=dict(eng.stats)))

    eng._step_inner = step_inner
    srv = FrontServer(eng, ("127.0.0.1", 0), bytes.fromhex(spec["authkey"]),
                      accept_timeout_s=W_WAIT_S)
    atomic_write_json(Path(d) / f"{name}.addr",
                      dict(address=list(srv.address), pid=os.getpid()))
    snaps = srv.serve()
    torch.cuda.synchronize()
    with lock:
        rec["drained"] = len(snaps)
        write(counts())
    if name == W_REF_GROUP:
        del eng, snaps, srv
        free_engines(torch)
        clean = {}
        for fam in ("paged", "unpaged"):
            ref = w_engine(torch, model, fam)
            hs = [ref.submit(p, max_new_tokens=TP_NEW) for p in prompts]
            ref.run_until_idle()
            streams = [h.result(1) for h in hs]
            del ref, hs
            free_engines(torch)
            clean[fam] = dict(streams=streams, gaps=fleet_gaps(
                torch, model, prompts, streams, TP_NEW))
        atomic_write_json(Path(d) / "clean.json", clean)
    leave_gang()
    return 0


def _w_launch(d: str, name: str, box: dict) -> None:
    """One group's gang, on a thread: what ``launch`` returned or
    raised lands in ``box``."""
    from sparkdl_tpu_torch.runner import launcher

    try:
        box["result"] = launcher.launch(
            str(ROOT / "chip_smoke.py"), np=1,
            args=["--fleet-group-worker", d, name], timeout_s=W_WAIT_S,
            capture=True)
    except BaseException as e:  # noqa: BLE001 — read by phase w
        box["error"] = e


def _w_until(pred, what: str, poll_s: float = 0.001) -> float:
    """Wait for ``pred`` (at most W_WAIT_S); returns when it held."""
    t_end = time.time() + W_WAIT_S
    while not pred():
        assert time.time() < t_end, f"phase w: timed out waiting for {what}"
        time.sleep(poll_s)
    return time.perf_counter()


def w_leg(fleet, prompts: list, *, leg: str, fault=None) -> dict:
    """One leg: TP_CLIENTS closed-loop client threads over ``prompts``
    through ``fleet``, every token recorded. ``fault(frs)`` runs on this
    thread once the clients run, and returns the hop positions it caused
    ({fleet request id: tokens delivered when it left its replica})."""
    import threading

    streams: dict = {}
    frs, first = [None] * len(prompts), [None] * len(prompts)
    errors = []

    def client(k):
        try:
            for i in range(k, len(prompts), TP_CLIENTS):
                frs[i] = fleet.submit(
                    prompts[i], TP_NEW, stream_cb=lambda fr, t: streams
                    .setdefault(fr.id, []).append(t))
                first[i] = frs[i].replica
                frs[i].result(W_WAIT_S)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=client, args=(k,))
          for k in range(TP_CLIENTS)]
    for t in ts:
        t.start()
    extra = fault(frs) if fault is not None else {}
    for t in ts:
        t.join(W_WAIT_S)
    wall = time.perf_counter() - t0
    assert not errors and not any(t.is_alive() for t in ts), (leg, errors)
    for fr in frs:  # the exactly-once audit
        assert streams.get(fr.id) == fr.tokens, fr
        assert fr.delivered == len(fr.tokens) == TP_NEW, fr
    ttft = [fr.t_first_token - fr.t_submit for fr in frs]
    n_new = sum(len(fr.tokens) for fr in frs)
    return dict(leg=leg, frs=frs, wall_s=wall, new_tokens=n_new,
                new_tokens_per_s=n_new / wall,
                ttft_p50_s=_pct(ttft, 0.5), ttft_p95_s=_pct(ttft, 0.95),
                placed=first, ended=[fr.replica for fr in frs], **extra)


def phase_fleet_remote(torch, kernels) -> dict:
    """Phase w (module docstring): three one-rank groups in processes of
    their own, this process's ``EngineFleet`` over their proxies, the
    clean, doom and kill legs; the groups' counts and the clean streams
    read back and held. A ``summary`` line gives the phase's seconds
    against PHASE_W_BUDGET_S."""
    import gc
    import os
    import secrets
    import shutil
    import signal
    import tempfile
    import threading

    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.runner.events import atomic_write_json
    from sparkdl_tpu_torch.runner.launcher import GangFailure
    from sparkdl_tpu_torch.serving import (DEAD, DEGRADED, HEALTHY,
                                           EngineFleet)
    from sparkdl_tpu_torch.serving.remote import RemoteEngine

    gc.collect()
    torch.cuda.empty_cache()  # the card is the groups' now
    t0 = time.perf_counter()
    main_gb = torch.cuda.memory_allocated() / 1e9
    d = tempfile.mkdtemp(prefix="sparkdl_fleet_w_")
    prompts = tp_prompts(torch, L.LlamaConfig.llama3_8b())
    authkey = secrets.token_bytes(16)
    atomic_write_json(Path(d) / "spec.json", dict(prompts=prompts,
                                            authkey=authkey.hex()))
    boxes = {n: {} for n in W_GROUPS}
    threads = {n: threading.Thread(target=_w_launch, args=(d, n, boxes[n]),
                                   daemon=True) for n in W_GROUPS}
    for t in threads.values():
        t.start()
    fleet = None
    try:
        addrs = {}
        for n in W_GROUPS:
            p = Path(d) / f"{n}.addr"
            _w_until(lambda: p.exists() or boxes[n], f"group {n}'s address",
                     0.05)
            assert p.exists(), (n, boxes[n])
            addrs[n] = json.loads(p.read_text())
        up_s = time.perf_counter() - t0
        proxies = {n: RemoteEngine(tuple(a["address"]), authkey,
                                   timeout_s=W_CHANNEL_TIMEOUT_S)
                   for n, a in addrs.items()}
        fleet = EngineFleet(list(proxies.values()), names=list(proxies),
                            min_replicas=1)
        fleet.start()
        legs = [w_leg(fleet, prompts, leg="clean")]

        def hop_fault(victim, act):
            def fault(frs):
                _w_until(lambda: any(
                    f is not None and f.replica == victim
                    and len(f.tokens) >= 2 for f in frs),
                    f"tokens on group {victim}")
                at = {f.id: f.delivered for f in frs
                      if f is not None and f.replica == victim}
                return dict(hop_at=at, **act())
            return fault

        def doom():
            fleet.doom_replica("a", "chip_smoke phase w")
            return {}

        def kill():
            t_kill, t0_kill = time.time(), time.perf_counter()
            os.kill(addrs["b"]["pid"], signal.SIGKILL)
            t_dead = _w_until(lambda: fleet.replica_state("b") == DEAD,
                              "group b DEAD")
            # the channel's end of file (proxy) and the router's verdict
            return dict(dead_s=t_dead - t0_kill,
                        lost_s=proxies["b"].t_lost - t_kill)

        legs.append(w_leg(fleet, prompts, leg="doom",
                          fault=hop_fault("a", doom)))
        legs.append(w_leg(fleet, prompts, leg="kill",
                          fault=hop_fault("b", kill)))
        states = {n: fleet.replica_state(n) for n in W_GROUPS}
        stats = dict(fleet.stats)
        fleet.stop(drain=True, timeout=W_WAIT_S)
        fleet = None
    finally:
        if fleet is not None:
            fleet.stop(drain=False, timeout=60)
        for t in threads.values():
            t.join(W_WAIT_S)
    try:
        assert not any(t.is_alive() for t in threads.values()), boxes
        # b's gang ends through the kill: its failure is the kill's
        err = boxes["b"].get("error")
        assert isinstance(err, GangFailure) and "rc=-9" in str(err), \
            boxes["b"]
        for n in ("a", "c"):
            assert "error" not in boxes[n], (n, boxes[n].get("error"))
        groups = {n: json.loads((Path(d) / f"{n}.json").read_text())
                  for n in W_GROUPS}
        clean = json.loads((Path(d) / "clean.json").read_text())
    finally:
        shutil.rmtree(d, ignore_errors=True)
    assert states["a"] == "doomed" and states["b"] == DEAD, states
    assert states["c"] in (HEALTHY, DEGRADED), states
    assert stats["drains"] == 1 and stats["replica_deaths"] == 1, stats
    for n, g in groups.items():
        c = g["counts"]
        assert g["consistent"], (n, g["violation"])
        assert c[g["kernel"]] == c["dispatch"] == TP_LAYERS * c["steps"] \
            > 0, (n, c)
        assert c["flash_attention"] == 0, (n, c)
    recs = []
    for lg in legs:
        frs = lg.pop("frs")
        got = [list(fr.tokens) for fr in frs]
        hop = lg.get("hop_at", {})
        ref = [clean[W_GROUPS[p]] for p in lg["placed"]]
        lg.update(fleet_vs_clean(
            got, [r["streams"][i] for i, r in enumerate(ref)],
            [r["gaps"][i] for i, r in enumerate(ref)],
            [hop.get(fr.id) for fr in frs]))
        lg["hop_at"] = sorted(hop.values())
        lg["hops"] = sum(fr.hops for fr in frs)
        if lg["leg"] != "clean":
            assert lg["hops"] >= 1, lg
        recs.append(lg)
    rtt = [1e3 * x for p in proxies.values()
           for x in p.stats["submit_rtt_s"]]
    lag = [1e3 * x for p in proxies.values()
           for x in p.stats["batch_lag_s"]]
    seconds = time.perf_counter() - t0
    rec = dict(
        phase="fleet_remote", leg="fleet_of_groups",
        config=f"LlamaConfig.llama3_8b(), {TP_LAYERS} layers, bf16",
        groups={n: dict(family=g["family"], kernel=g["kernel"],
                        counts=g["counts"], drained=g.get("drained"),
                        peak_gb=g["peak_gb"],
                        steps=g["counts"]["steps"])
                for n, g in groups.items()},
        note="three one-rank groups time-sliced on one card: not a "
             "fleet's rate on three cards",
        clients=TP_CLIENTS, requests=len(prompts), new=TP_NEW,
        legs=recs, states=states, fleet_stats=stats, groups_up_s=up_s,
        submit_rtt_ms_p50=_pct(rtt, 0.5), submit_rtt_ms_p95=_pct(rtt, 0.95),
        submits=len(rtt), batch_lag_ms_p50=_pct(lag, 0.5),
        batch_lag_ms_p95=_pct(lag, 0.95), token_batches=len(lag),
        dead_s=recs[2]["dead_s"], lost_s=recs[2]["lost_s"],
        main_allocated_at_start_gb=main_gb,
        nvidia_smi=smi())
    emit(rec)
    emit(dict(phase="fleet_remote", leg="summary", seconds=seconds,
              budget_s=PHASE_W_BUDGET_S,
              within_budget=seconds <= PHASE_W_BUDGET_S, nvidia_smi=smi()))
    rec["seconds"] = seconds
    return rec


def bert_case(r: dict) -> dict:
    """The ``kernels`` line's summary of a phase-b BERT case."""
    keys = ("case", "variant", "dtype", "shape", "causal", "max_abs_err",
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "fwd_bwd_ms", "library_fwd_bwd_ms",
            "dead_k_tiles_dk_dv_exactly_zero")
    return {k: r[k] for k in keys if k in r}


def main() -> int:
    import torch

    t_torch = time.time()  # phase q's workers time their start-up
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
    if sys.argv[1:2] == ["--dp-m-worker"]:
        return dp_m_worker(sys.argv[2])
    if sys.argv[1:2] == ["--sup-worker"]:
        return sup_worker(sys.argv[2], sys.argv[3], t_torch)
    if sys.argv[1:2] == ["--keras-leg"]:
        return keras_worker(sys.argv[2])
    if sys.argv[1:2] == ["--fleet-group-worker"]:
        return fleet_group_worker(sys.argv[2], sys.argv[3])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sparkdl_tpu_torch.ops import _build
    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.ops import flash_decode as fd
    from sparkdl_tpu_torch.ops import paged_flash_decode as pfd

    walls = {}

    def timed(key, phase, *args):
        """``phase(*args)``, its wall seconds kept under ``key``."""
        t0 = time.perf_counter()
        out = phase(*args)
        walls[key] = time.perf_counter() - t0
        return out

    kern = (fa, fd, pfd)
    timed("a_build", phase_build, _build)
    main_recs = timed("b_kernels", phase_kernels, torch, fa, fd, pfd)
    mp = timed("c_main", phase_main, torch, fa, fd)
    timed("d_parity", phase_parity, torch)
    legs = timed("e_serve", phase_serve, torch, kern)
    timed("f_serve_parity", phase_serve_parity, torch, kern)
    train = timed("g_train", phase_train, torch, kern)
    timed("g_parity", phase_train_parity, torch)
    glue, bert = timed("h_glue", phase_glue, torch, kern)
    timed("h_parity", phase_glue_parity, torch, kern)
    timed("i_classify", phase_classify, torch, kern, bert)
    del bert
    torch.cuda.empty_cache()
    timed("j_images", phase_images, torch)
    resnet = timed("k_resnet", phase_resnet, torch, kern)
    timed("l_dp", phase_dp, torch, kern, resnet["train"])
    gang = timed("m_dp_m", phase_dp_m, torch, glue)
    n = timed("n_int8", phase_n, torch, kern)
    o = timed("o_fleet", phase_fleet, torch, kern)
    p = timed("p_recorder", phase_flight_recorder, torch, kern)
    p_launches = p["lora_recorder"]["launches"]
    import shutil
    import tempfile

    sup_root = tempfile.mkdtemp(prefix="sparkdl_sup_")
    try:
        q = timed("q_supervise", phase_supervise, torch, sup_root)
        q_launches = q["sup_bert_kill"]["launches"]
        r = timed("r_import", phase_import, torch, kern, q["dirs"])
    finally:
        shutil.rmtree(sup_root, ignore_errors=True)
    timed("s_graph", phase_graph, torch)
    t = timed("t_parallel", phase_parallel, torch, kern)
    u = timed("u_tp", phase_tp, torch, kern)
    v = timed("v_sharded", phase_sharded, torch, kern)
    w = timed("w_fleet_remote", phase_fleet_remote, torch, kern)
    v_launches = {f"fsdp_tp_train_{a['arm']}": a["launches"]
                  for a in v["fsdp_tp_train"]["arms"]}
    v_launches["gpipe"] = v["gpipe"]["launches"]
    u_launches = {f"{fam}_{arm}": rec["launches"]
                  for fam, r_ in u["tp_serve"].items()
                  for arm, rec in r_["arms"].items()}
    u_launches.update({f"{fam}_front": r_["front"]["launches"]
                       for fam, r_ in u["tp_serve"].items()})
    t_launches = {
        "ulysses_flash": t["ulysses_flash"]["launches"],
        **{f"ring_generate_{arm}": a["launches"]
           for arm, a in t["ring_generate"]["arms"].items()}}
    r_launches = {
        f"import_llama3_8b_{arm}": c for arm, c in
        r["import_llama3_8b"]["launches"].items()}
    r_launches.update({f"import_bert_base_{arm}": c for arm, c in
                       r["import_bert_base"]["launches"].items()})

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
    # phase n's launches of each kernel, leg by leg
    n_recs = dict(n["int8_weights"], int8_parity=n["int8_parity"],
                  draft_registry=n["draft_registry"],
                  tokenizer=n["tokenizer"])
    for name, (src, replaces, counts) in sources.items():
        r = main_recs[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts[name], max_abs_err=r["max_abs_err"],
            tol=r["tol"], rtol=r["rtol"], case=r["case"], dtype=r["dtype"],
            ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            phase_n_launches={leg: rec["launches"][name]
                              for leg, rec in n_recs.items()},
            phase_o_launches={leg: rec["launches"][name]
                              for leg, rec in o.items()}))
        if name in ("flash_attention", "flash_decode"):
            kernels[-1]["phase_t_launches"] = {
                leg: c[name] for leg, c in t_launches.items()}
        if name == "flash_attention":
            kernels[-1]["phase_v_launches"] = {
                leg: c[name] for leg, c in v_launches.items()}
        if name in ("flash_decode", "paged_flash_decode"):
            kernels[-1]["phase_u_launches"] = {
                arm: c[name] for arm, c in u_launches.items()}
            # each group's own count (b's as last written before its kill)
            kernels[-1]["phase_w_launches"] = {
                g: r["counts"][name] for g, r in w["groups"].items()}
        if name in ("flash_attention", "paged_flash_decode"):
            kernels[-1]["phase_r_launches"] = {
                leg: c[name] for leg, c in r_launches.items()}
        if name == "paged_flash_decode":
            kernels[-1]["llama3_8b_s5_case"] = {
                k: main_recs["paged_llama3_8b_s5"][k]
                for k in ("case", "dtype", "shape", "max_abs_err", "ms",
                          "plain_ms", "library_ms", "bound_ms", "bound_by",
                          "bytes")}
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
                    "flash_attention"],
                gang_launches={arm: gang[arm]["launches"]["flash_attention"]
                               for arm in ("dp_bert", "dp_bert_accum",
                                           "dp_lora")},
                phase_p_launches={arm: c["flash_attention"]
                                  for arm, c in p_launches.items()},
                phase_q_launches={arm: c["flash_attention"]
                                  for arm, c in q_launches.items()})
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
        library_backend=r["library_backend"],
        library_pinned_ms=r["library_pinned_ms"], torch=r["torch"],
        variant=r["variant"], tflops=r["tflops"],
        tflops_issued=r["tflops_issued"],
        bwd_variant_launches=train["bwd_variant_launches"],
        bert_case=bert_case(main_recs["flash_attention_bwd_bert"]),
        bert_launches=glue["launches"]["flash_attention_bwd"],
        bert_launches_per_step=glue["launches_per_step"][
            "flash_attention_bwd"],
        bert_variant_launches=glue["bwd_variant_launches"],
        gang_launches={arm: gang[arm]["launches"]["flash_attention_bwd"]
                       for arm in ("dp_bert", "dp_bert_accum", "dp_lora")},
        phase_p_launches={arm: c["flash_attention_bwd"]
                          for arm, c in p_launches.items()},
        phase_q_launches={arm: c["flash_attention_bwd"]
                          for arm, c in q_launches.items()},
        phase_t_launches={leg: c["flash_attention_bwd"]
                          for leg, c in t_launches.items()},
        phase_v_launches={leg: c["flash_attention_bwd"]
                          for leg, c in v_launches.items()
                          if leg.startswith("fsdp")},
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
    walls["total"] = time.perf_counter() - T_START
    emit({"phase_walls": walls})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
