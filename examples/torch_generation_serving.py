"""Batch text generation through the UDF registry on the PyTorch port:
the twin of ``generation_serving.py``.

Part 1 (token columns): mixed-length prompts run as one left-padded
prefill and one decode loop a chunk, streamed from the DataFrame in
batchRows chunks.

Part 2 (STRING columns, zero external assets): train the in-repo
ByteBPETokenizer on a local corpus, then drive a text column through
registerTextGenerationUDF — string → tokens → generate → string.

Part 3 (online serving): the same prompts through the
continuous-batching engine — 2 slots with in-flight refill, tokens
streamed per request via callback, greedy output token-identical to the
static path of Part 1.

The DataFrame needs pyarrow and pandas. On the card the model is
LlamaConfig.tiny() with 2 heads of 64 (the flash kernels take head dims
64 and 128; tiny's are 32), so prefill and decode run the kernels; on the
CPU it is tiny itself.

Run: python examples/torch_generation_serving.py [--device cpu]
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import sparkdl_tpu_torch as sdl
from sparkdl_tpu_torch.models.llama import LlamaConfig, LlamaModel
from sparkdl_tpu_torch.models.tokenizer import ByteBPETokenizer
from sparkdl_tpu_torch.udf import (applyUDF, registerGenerationUDF,
                                   registerTextGenerationUDF)


def token_column_serving(model, cfg):
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in (5, 2, 7, 3, 6)]
    df = sdl.DataFrame.fromPydict({"prompt": prompts}, numPartitions=2)

    registerGenerationUDF("complete", model, max_new_tokens=8,
                          temperature=0.7, top_p=0.9, seed=0, batchRows=4)
    out = applyUDF(df, "complete", "prompt", "completion").toPandas()
    for p, c in zip(out["prompt"], out["completion"]):
        p, c = list(map(int, p)), list(map(int, c))
        print(f"  {p} -> {c[len(p):]}")
    assert all(len(c) == len(p) + 8 for p, c in
               zip(out["prompt"], out["completion"]))
    print("5 prompts, 3 lengths, ONE prefill + ONE decode program.")


def string_column_serving(model):
    # Train the tokenizer on any local text — here, this very script.
    with open(os.path.abspath(__file__)) as f:
        corpus = f.read().splitlines()
    tok = ByteBPETokenizer.train(corpus, vocab_size=400)
    print(f"tokenizer: {tok.vocab_size} ids "
          f"({len(tok.merges)} learned merges)")

    df = sdl.DataFrame.fromPydict({"text": [
        "batch text generation",
        "the DataFrame streams prompts",
        "left-padded prefill",
    ]})
    registerTextGenerationUDF(
        "continue", model, encode=tok.encode, decode=tok.decode,
        max_new_tokens=6, seed=0, batchRows=2,
        eos_id=ByteBPETokenizer.EOS)
    out = applyUDF(df, "continue", "text", "completion").toPandas()
    for t, c in zip(out["text"], out["completion"]):
        print(f"  {t!r} -> {c!r}")
    assert all(isinstance(c, str) for c in out["completion"])
    print("string column -> tokenize -> generate -> detokenize, "
          "in-repo tokenizer only.")


def continuous_batching_serving(model, cfg, device):
    """Part 3: greedy decoding makes the engine and the static path
    exactly comparable — token-identical per request."""
    from sparkdl_tpu_torch.models.llama import generate, left_pad_prompts
    from sparkdl_tpu_torch.serving import GenerationEngine

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in (5, 2, 7, 3, 6)]  # Part 1's prompts
    engine = GenerationEngine.from_model(model, num_slots=2, max_len=64,
                                         min_bucket=8, device=device)
    streamed: dict = {}
    handles = [
        engine.submit(p, max_new_tokens=8,
                      stream_cb=lambda r, t:
                      streamed.setdefault(r.id, []).append(t))
        for p in prompts]
    engine.run_until_idle()
    for p, h in zip(prompts, handles):
        ids, lens = left_pad_prompts([p])
        ref = generate(model, ids, 8, pad_lens=lens, pad_to=64)[0]
        want = ref[int(lens[0]) + len(p):].tolist()
        got = h.result()
        assert got == want, (p, got, want)
        assert streamed[h.id] == got
        print(f"  {p} -> {got}")
    snap = engine.snapshot()
    assert snap["completed"] == len(prompts)
    assert snap["peak_slots_busy"] == 2  # requests genuinely overlapped
    print(f"5 requests over 2 slots ({snap['steps']} decode iterations, "
          f"{snap['prefills']} slot prefills): continuous batching is "
          f"token-identical to the static path.")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = ap.parse_args().device
    cfg = LlamaConfig.tiny()  # seeded random init
    if device != "cpu":
        cfg = dataclasses.replace(cfg, num_heads=2, num_kv_heads=1)
    model = LlamaModel(cfg, device=device)
    token_column_serving(model, cfg)
    string_column_serving(model)
    continuous_batching_serving(model, cfg, device)


if __name__ == "__main__":
    main()
