"""Distributed data-parallel training on the PyTorch port: the twin of
``distributed_training.py`` (the HorovodRunner → XlaRunner inversion).

One process a device: ``XlaRunner(np=-1)`` joins the gang that
``sparkdl_tpu_torch.runner.launcher`` started (NCCL on the card, gloo on
the CPU), or runs alone; each rank feeds its rows of every global batch
and the step all-reduces the gradients. Rank 0 prints.

Run: python -m sparkdl_tpu_torch.runner.launcher --np 2 \\
         examples/torch_distributed_training.py --device cpu
     python examples/torch_distributed_training.py     # one rank, the card
Env: STEPS / BATCH_PER_CHIP.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from sparkdl_tpu_torch.models.registry import get_model
from sparkdl_tpu_torch.runner import (XlaRunner, adam,
                                      softmax_cross_entropy_loss)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = ap.parse_args().device
    steps = int(os.environ.get("STEPS", "6"))
    per_chip = int(os.environ.get("BATCH_PER_CHIP", "4"))

    runner = XlaRunner(np=-1, device=device)  # the gang's size, or 1

    def train(ctx):
        model = get_model("ResNet18").build(num_classes=10,
                                            device=ctx.device)

        def data():
            # every rank draws the same global batch and keeps its rows
            rng = np.random.RandomState(0)
            n = per_chip * ctx.size
            lo = ctx.rank * per_chip
            while True:
                image = rng.randint(0, 256, (n, 32, 32, 3)).astype(
                    np.float32)
                label = rng.randint(0, 10, (n,))
                yield {"image": image[lo:lo + per_chip],
                       "label": label[lo:lo + per_chip]}

        return ctx.fit(loss_fn=softmax_cross_entropy_loss(), model=model,
                       tx=adam(1e-3), data=data(), num_steps=steps,
                       log_every=max(1, steps // 3))

    res = runner.run(train)
    losses = [h["loss"] for h in res["history"]]
    rank, size = (runner.gang.rank, runner.gang.size) if runner.gang \
        else (0, 1)
    if rank == 0:
        print(f"{size}-device DP: "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {steps} steps")


if __name__ == "__main__":
    main()
