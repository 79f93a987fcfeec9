"""Long-context serving on the PyTorch port: sequence-parallel prefill over
a device mesh. The twin of ``long_context_serving.py``.

The prefill of a long prompt is O(S^2) attention compute — the part of
serving that needs more than one device. Configuring the model's
``attn_fn`` with ring attention splits that compute over the ``sp`` mesh
axis (K/V blocks hop from rank to rank) while the KV cache and the
per-token decode stay exactly as in single-device serving. The tokens
must equal the dense single-device run.

One process a device: under ``sparkdl_tpu_torch.runner.launcher`` every
rank joins the gang (NCCL on the card, gloo on the CPU) and the mesh
spans it; run alone, the script is a gang of one. Rank 0 prints.

Run: python -m sparkdl_tpu_torch.runner.launcher --np 8 \\
         examples/torch_long_context_serving.py --device cpu
     python examples/torch_long_context_serving.py     # one rank, the card
"""

import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from sparkdl_tpu_torch.core.runtime import make_mesh
from sparkdl_tpu_torch.models.llama import LlamaConfig, LlamaModel, generate
from sparkdl_tpu_torch.parallel.ring_attention import ring_attention
from sparkdl_tpu_torch.runner import XlaRunner, launcher


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = ap.parse_args().device
    if os.environ.get("SPARKDL_COORDINATOR"):
        runner = XlaRunner(device=device)        # the launcher's gang
    else:                                        # a gang of one
        runner = XlaRunner(device=device, num_processes=1, process_id=0,
                           coordinator=f"127.0.0.1:{launcher.free_port()}")
    n_dev = runner.gang.size
    cfg = LlamaConfig.tiny()  # seeded random init: the same on every rank
    dense = LlamaModel(cfg, attn_fn=None, device=runner.device)

    # One knob turns on sequence parallelism: attn_fn=ring over an sp mesh.
    mesh = make_mesh({"sp": n_dev})
    sp_model = LlamaModel(cfg, attn_fn=functools.partial(
        ring_attention, mesh=mesh, axis="sp"), device=runner.device)
    sp_model.load_state_dict(dense.state_dict())

    # "Long" prompt at example scale: S = 64 tokens = 8 tokens a rank on
    # 8. The same code serves far longer prompts — S has to divide the sp
    # axis.
    S, new = 64, 8
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(2, S)))

    ref = generate(dense, ids, new)
    out = generate(sp_model, ids, new)
    assert torch.equal(out, ref), (out, ref)
    if runner.gang.rank == 0:
        print(f"prefill of {S}-token prompts sharded over {n_dev} devices "
              f"({S // n_dev} tokens/device), decode unchanged")
        print("sequence-parallel tokens == single-device tokens, "
              "bit-identical.")


if __name__ == "__main__":
    main()
