"""A collective that fails because a peer of a tensor-parallel group is
gone is not a request's fault, on the CPU.

When a follower of a tp group dies mid-stream, gloo raises on the dead
pair in the survivor (NCCL hangs, or raises through its watchdog). The
engine's per-request isolation used to take that error for a poisoned
request and quarantine it, so a fleet delivered the request's client an
error where it should have re-admitted the request on another replica
(``scripts/torch_multicard.py``'s ``fleet_tp_groups`` leg). Now such an
error passes every isolation site: the engine fails closed and each
request it held ends with ``EngineStopped``, which a fleet re-admits.
A request's own error is still quarantined.

The JAX package has no counterpart: one process drives a whole mesh.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import pytest

from sparkdl_tpu_torch.runner import failures
from sparkdl_tpu_torch.serving import (EngineStopped, GenerationEngine,
                                       RequestQuarantined, StubBackend)

# what a survivor reads when its peer is gone: gloo's reset pair, NCCL's
# backend error and aborted communicator, the store's loss
PEER_LOSS = [
    "[gloo/transport/tcp/pair.cc:537] Read error [127.0.0.1]:5513: "
    "Connection reset by peer",
    "[gloo/transport/tcp/pair.cc:598] Connection closed by peer",
    "DistBackendError: NCCL error in: ProcessGroupNCCL.cpp, remote "
    "process exited or there was a network error",
    "NCCL communicator was aborted on rank 0",
    "DistNetworkError: failed to recv, got 0 bytes",
]


class _Failing(StubBackend):
    """Raises ``RuntimeError(text)`` from ``where``: the prefill or the
    decode step (once ``after`` steps have run)."""

    def __init__(self, text: str, where: str, after: int = 0):
        super().__init__(2, 64)
        self.text, self.where, self.after = text, where, after

    def prefill_chunk(self, *a, **kw):
        if self.where == "prefill":
            raise RuntimeError(self.text)
        return super().prefill_chunk(*a, **kw)

    def step(self, *a, **kw):
        if self.where == "step":
            self.after -= 1
            if self.after < 0:
                raise RuntimeError(self.text)
        return super().step(*a, **kw)


@pytest.mark.parametrize("text", PEER_LOSS)
def test_peer_loss_is_classified(text):
    assert failures.is_peer_loss(RuntimeError(text))


@pytest.mark.parametrize("text", ["poisoned prompt", "CUDA out of memory",
                                  "index 7 is out of bounds"])
def test_a_request_error_is_not_peer_loss(text):
    assert not failures.is_peer_loss(RuntimeError(text))


@pytest.mark.parametrize("where", ["prefill", "step"])
@pytest.mark.parametrize("text", PEER_LOSS[:3])
def test_started_engine_fails_closed_on_peer_loss(where, text):
    """Every request the engine held ends with ``EngineStopped`` (a
    fleet's cue to re-admit it), none is quarantined."""
    eng = GenerationEngine(_Failing(text, where, after=2), retries=1,
                           prefill_chunk=8)
    eng.start()
    try:
        hs = [eng.submit([1 + i, 2, 3], max_new_tokens=8)
              for i in range(2)]
        for h in hs:
            with pytest.raises(EngineStopped):
                h.result(30)
            assert not isinstance(h.error, RequestQuarantined), h.error
    finally:
        eng.stop(drain=False, timeout=10)
    assert eng.stats["quarantined"] == 0
    assert eng._fatal is not None and failures.is_peer_loss(eng._fatal)


@pytest.mark.parametrize("where", ["prefill", "step"])
def test_a_request_error_is_still_quarantined(where):
    eng = GenerationEngine(_Failing("poisoned prompt", where), retries=1,
                           prefill_chunk=8)
    eng.start()
    try:
        h = eng.submit([1, 2, 3], max_new_tokens=8)
        with pytest.raises(RequestQuarantined):
            h.result(30)
    finally:
        eng.stop(drain=False, timeout=10)
    assert eng.stats["quarantined"] == 1
    assert eng._fatal is None
