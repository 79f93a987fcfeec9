#!/usr/bin/env python3
"""Which of BERT's parameter gradients differ between two identical
backward passes on one CUDA card.

Run from the root of a checkout::

    python3 scripts/torch_bert_determinism.py

``BertConfig.base()``'s widths at depth 2, f32, TF32 off, the kernel arm
(``attn_fn=fa.flash_attention``), on ``chip_smoke.py``'s first phase-h
batch, with and without dropout (a seeded generator). Two token-type
paths: ``token_type_ids`` given as zeros (a ``F.embedding`` lookup of
B·S duplicate ids, whose CUDA backward sums them in no fixed order) and
``token_type_ids=None`` (the encoder adds the type-0 row, broadcast).
Each is run with PyTorch's default kernels and under
``torch.use_deterministic_algorithms(True, warn_only=True)``. Prints one
JSON line per case with the parameters whose two gradients are not
bitwise equal, then the card's name and power limit. Imports nothing of
JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from sparkdl_tpu_torch.models import bert as B
    from sparkdl_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(B.BertConfig.base(), num_layers=2)
    model = B.BertForSequenceClassification(
        cfg, num_classes=2, dtype=torch.float32, attn_fn=fa.flash_attention,
        device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in cs.glue_batch(0, cfg.vocab_size).items()}

    def grads(types, dropout: bool):
        model.zero_grad(set_to_none=True)
        g = (torch.Generator(device="cuda").manual_seed(5) if dropout
             else None)
        logits = model(batch["input_ids"], batch["attention_mask"], types,
                       deterministic=g is None, generator=g)
        torch.nn.functional.cross_entropy(logits, batch["label"]).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    zeros = torch.zeros_like(batch["input_ids"])
    for det in (False, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        for name, types in (("lookup_of_zeros", zeros), ("none", None)):
            for dropout in (False, True):
                a, b = grads(types, dropout), grads(types, dropout)
                print(json.dumps(dict(
                    deterministic_algorithms=det, token_type_ids=name,
                    dropout=dropout,
                    grads_differ=[n for n in a if not torch.equal(a[n],
                                                                  b[n])])),
                      flush=True)
    torch.use_deterministic_algorithms(False)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
