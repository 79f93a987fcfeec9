"""``leave_gang`` drops the captured steps that issue the gang's
collectives before it destroys the process group (ROADMAP.md C 12).

NCCL destroys a communicator only once no CUDA graph holds its kernels.
A tensor-parallel engine still alive at the end of a worker kept its
captured decode step, and with it the communicator: on two H100s both
ranks of a tp-2 group waited in ``destroy_process_group`` until the
launcher's limit (``scripts/torch_multicard.py``, leg ``fleet_tp_groups``).
The CPU captures no graph, so it shows the order (the steps go before the
destroy) and that both tensor-parallel backends register their cache.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import torch
import torch.distributed as dist

from sparkdl_tpu_torch.core.runtime import CompileCache
from sparkdl_tpu_torch.runner import xla_runner as X


def test_leave_gang_drops_held_steps_before_the_destroy(monkeypatch):
    held, other = CompileCache(), CompileCache()
    for cache in (held, other):
        cache._steps[("serve_decode_step", 1)] = object()
    X.hold_gang_graphs(held)
    seen = []
    monkeypatch.setattr(X, "_GANG", [object()])
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: seen.append((len(held._steps),
                                             len(other._steps))))
    X.leave_gang()
    assert seen == [(0, 1)]  # the held cache emptied, the other kept
    assert X._GANG == []
    X.leave_gang()  # outside a gang: nothing
    assert seen == [(0, 1)]


def test_tensor_parallel_backends_hold_their_graphs():
    from sparkdl_tpu_torch import GenerationEngine
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.runner import XlaRunner, launcher
    from sparkdl_tpu_torch.serving.backend import tp_mesh

    XlaRunner(device="cpu", num_processes=1, process_id=0,
              coordinator=f"127.0.0.1:{launcher.free_port()}")
    try:
        model = L.LlamaModel(L.LlamaConfig.tiny(), attn_fn=None,
                             device="cpu",
                             generator=torch.Generator().manual_seed(0))
        engines = {
            block: GenerationEngine.from_model(
                model, mesh=tp_mesh(1), num_slots=2, max_len=32,
                block_size=block, device="cpu")
            for block in (0, 8)}
        plain = GenerationEngine.from_model(model, num_slots=2, max_len=32,
                                            device="cpu")
        held = list(X._GANG_GRAPHS)
        assert {type(e.backend).__name__ for e in engines.values()} == {
            "TensorParallelLlamaSlotBackend",
            "TensorParallelPagedLlamaSlotBackend"}
        assert all(any(c is e.backend.graphs for c in held)
                   for e in engines.values())
        assert not any(c is plain.backend.graphs for c in held)
    finally:
        X.leave_gang()
    assert not dist.is_initialized()
