"""How far the port's float32 mutable train step of InceptionV3 and
Xception lies from the same step in float64, on the CPU of the machine
that runs it (no JAX).

For each model at ``tests/test_torch_image_train.py``'s sizes (InceptionV3
at 75², Xception at 71², a batch of 4, seeded images in [0, 1) and
labels): variables drawn from the port's own shapes by the rule of that
test's ``flax_variables`` (kernels N(0, 1/fan_in), BatchNorm scales
U(0.8, 1.2) and variances U(0.6, 1.4), the rest 0.1·N(0, 1)), one
``sgd(0.01, momentum=0.9)`` mutable step in f32 as the model runs, and
one in f64 (``build(dtype=float64)``, ``.double()``, the f32 head
lifted to f64). Prints one JSON line: the host's CPU, torch's version
and threads, and per model the largest parameter error as a share of
the largest change the f64 step made, the same share taken for each
running statistic against its own change, and the loss's relative
error: the shares the test's ``ROUNDING`` limits are set from.

Usage: ``python scripts/torch_image_step_rounding.py``
"""

import json
import os
import platform
import sys
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CASES = (("InceptionV3", 75), ("Xception", 71))
BATCH, LR = 4, 0.01


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def draw(model, seed: int = 0) -> dict:
    """A state dict for ``model`` by ``flax_variables``'s rule, in f64."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape, leaf = tuple(t.shape), name.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) > 1:      # a kernel
            w = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif leaf == "weight":                       # a BatchNorm scale
            w = rng.uniform(0.8, 1.2, shape)
        elif leaf == "running_var":
            w = rng.uniform(0.6, 1.4, shape)
        else:
            w = 0.1 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(w.astype(np.float32).astype(np.float64))
    return out


def step(model, batch, loss_fn):
    from sparkdl_tpu_torch.runner import TrainState, make_train_step, sgd
    state = TrainState.create(model, sgd(LR, momentum=0.9))
    _, m = make_train_step(loss_fn, mutable=True)(state, batch)
    return ({k: t.double() for k, t in model.state_dict().items()},
            float(m["loss"]))


def loss64(m, batch):
    logits, stats = m(batch["image"], train=True)
    return torch.nn.functional.cross_entropy(logits,
                                             batch["label"].long()), {}, stats


def shares(got, want, before) -> tuple:
    params = [k for k in want if "running" not in k]
    p = (max((got[k] - want[k]).abs().max().item() for k in params)
         / max((want[k] - before[k]).abs().max().item() for k in params))
    s = max((got[k] - want[k]).abs().max().item()
            / (want[k] - before[k]).abs().max().item()
            for k in want if "running" in k)
    return p, s


def main() -> int:
    import importlib

    from sparkdl_tpu_torch.models import registry as R
    from sparkdl_tpu_torch.runner import bn_classifier_loss

    rec = {"cpu": cpu_name(), "torch": torch.__version__,
           "threads": torch.get_num_threads(), "models": {}}
    for name, size in CASES:
        rng = np.random.default_rng(7)
        image = rng.uniform(0, 1, (BATCH, size, size, 3)).astype(np.float32)
        label = rng.integers(0, 1000, BATCH)
        batch = {"image": torch.from_numpy(image),
                 "label": torch.from_numpy(label)}
        m32 = R.get_model(name).build()
        before = draw(m32)
        m32.load_state_dict({k: v.float() for k, v in before.items()})
        got32, l32 = step(m32, batch, bn_classifier_loss())
        m64 = R.get_model(name).build(dtype=torch.float64).double()
        m64.load_state_dict(before)
        m64.head.dtype = torch.float64
        mod = importlib.import_module(type(m64).__module__)
        with mock.patch.object(mod, "global_mean_f32",
                               lambda x: x.mean(dim=(2, 3))):
            got64, l64 = step(m64, dict(batch, image=batch["image"].double()),
                              loss64)
        p, s = shares(got32, got64, before)
        rec["models"][name] = {"params": p, "stats": s,
                               "loss_rel": abs(l32 - l64) / abs(l64)}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
