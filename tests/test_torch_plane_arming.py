"""The telemetry plane armed from the environment by the port's entry
points, and the meter's ``fault_tolerance`` / ``compile_cache`` blocks,
on the CPU.

- ``SPARKDL_METRICS_DIR`` arms the plane in ``RunnerContext.fit``,
  ``BatchRunner.run_stream`` and ``StreamScorer.__call__``, as in the JAX
  package: the same tiny input through both packages' entry point, the
  plane on in both afterwards, the port's ``metrics_rank0.json`` on disk
  (``fit`` flushes it at its end; the streaming entry points' exporter
  writes it within the test's poll) with the reference's top-level keys.
- ``ThroughputMeter.summary()`` carries ``fault_tolerance`` (None on a
  clean run; the rollback of a resumed fit after its newest checkpoint was
  corrupted) and ``compile_cache`` (None until a signature is noted), with
  the reference's keys.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json
import os
import time

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp
from sparkdl_tpu.core import runtime as ref_runtime
from sparkdl_tpu.runner import XlaRunner as JaxRunner
from sparkdl_tpu.runner import chaos as ref_chaos
from sparkdl_tpu.runner import metrics as ref_metrics
from sparkdl_tpu.runner import softmax_cross_entropy_loss as jax_sce
from sparkdl_tpu.runner import telemetry as ref_telemetry
from sparkdl_tpu.transformers.streaming import StreamScorer as RefScorer
from sparkdl_tpu_torch.core import runtime
from sparkdl_tpu_torch.runner import (XlaRunner, chaos, metrics, sgd,
                                      softmax_cross_entropy_loss, telemetry)
from sparkdl_tpu_torch.transformers.streaming import StreamScorer

_POLL_S = 10.0


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("SPARKDL_METRICS_DIR", "SPARKDL_METRICS_PORT",
              "SPARKDL_EVENT_DIR", "SPARKDL_PROCESS_ID", chaos.CHAOS_ENV):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SPARKDL_METRICS_INTERVAL_S", "0.05")
    for mod in (telemetry, ref_telemetry):
        mod.reset()
    for mod in (chaos, ref_chaos):
        mod.uninstall()
    metrics.run_stats.reset()
    ref_metrics.run_stats.reset()
    yield
    for mod in (telemetry, ref_telemetry):
        mod.reset()
    metrics.run_stats.reset()
    ref_metrics.run_stats.reset()


class Linear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(np.array(w)))

    def forward(self, x):
        return x @ self.w


def _w():
    return np.random.RandomState(0).randn(4, 3).astype(np.float32)


def _batches(n=6, rows=8):
    rng = np.random.RandomState(1)
    return [{"image": rng.randn(rows, 4).astype(np.float32),
             "label": rng.randint(0, 3, (rows,))} for _ in range(n)]


def _port_fit(ckpt=None, steps=4, **kw):
    return XlaRunner(device="cpu", checkpoint_dir=ckpt).run(
        lambda ctx: ctx.fit(loss_fn=softmax_cross_entropy_loss(),
                            model=Linear(_w()), tx=sgd(0.1),
                            data=_batches(), num_steps=steps,
                            log_every=100, **kw))


def _ref_fit(ckpt=None, steps=4, **kw):
    return JaxRunner(np=1, checkpoint_dir=ckpt).run(
        lambda ctx: ctx.fit(loss_fn=jax_sce(), params={"w": _w()},
                            tx=optax.sgd(0.1),
                            apply_fn=lambda p, x: x @ p["w"],
                            data=_batches(), num_steps=steps,
                            log_every=100, **kw))


def _snapshot(d) -> dict:
    """``d/metrics_rank0.json`` once it exists (polled)."""
    path = os.path.join(d, "metrics_rank0.json")
    deadline = time.monotonic() + _POLL_S
    while not os.path.exists(path):
        assert time.monotonic() < deadline, f"no snapshot in {d}"
        time.sleep(0.02)
    with open(path) as f:
        return json.load(f)


def _both_armed(tmp_path, monkeypatch, run_port, run_ref):
    """Run each package's entry point with SPARKDL_METRICS_DIR set to its
    own directory; both planes must be on; the snapshots' keys equal."""
    snaps = []
    for tel, run, tag in ((telemetry, run_port, "port"),
                          (ref_telemetry, run_ref, "ref")):
        d = str(tmp_path / tag)
        monkeypatch.setenv("SPARKDL_METRICS_DIR", d)
        assert not tel.enabled()
        run()
        assert tel.enabled()
        snaps.append(_snapshot(d))
        tel.reset()
    assert set(snaps[0]) == set(snaps[1])
    return snaps[0]


def test_fit_arms_the_plane_from_env(tmp_path, monkeypatch):
    snap = _both_armed(tmp_path, monkeypatch, _port_fit, _ref_fit)
    # fit's own spans reached the accountant
    assert "step_compute" in json.dumps(snap)


def test_run_stream_arms_the_plane_from_env(tmp_path, monkeypatch):
    batches = [np.full((3, 2), i, np.float32) for i in range(4)]

    def port():
        r = runtime.BatchRunner(lambda x: x + 1.0, 4, device="cpu")
        out = list(r.run_stream((b, i) for i, b in enumerate(batches)))
        np.testing.assert_allclose(out[3][0], 4.0)

    def ref():
        r = ref_runtime.BatchRunner(lambda x: x + 1.0, batch_size=4)
        out = list(r.run_stream((jnp.asarray(b), i)
                                for i, b in enumerate(batches)))
        np.testing.assert_allclose(np.asarray(out[3][0]), 4.0)

    _both_armed(tmp_path, monkeypatch, port, ref)


def test_stream_scorer_arms_the_plane_from_env(tmp_path, monkeypatch):
    import pyarrow as pa

    batch = pa.RecordBatch.from_arrays([pa.array([1.0, 2.0, 3.0, 4.0])],
                                       ["x"])

    def scorer_kw():
        return dict(
            make_decoder=lambda rb: (
                lambda start, length: np.asarray(
                    rb.column(0).to_numpy()[start:start + length],
                    np.float32)[:, None]),
            encode=lambda r: pa.array([float(v) for v in
                                       np.asarray(r)[:, 0]]),
            empty_array=lambda: pa.array([], type=pa.float64()),
            chunk_rows=2, decode_workers=0)

    outs = []

    def port():
        r = runtime.BatchRunner(lambda x: x * 2.0, 2, device="cpu")
        outs.append(list(StreamScorer(r, "y", **scorer_kw())(iter([batch]))))

    def ref():
        r = ref_runtime.BatchRunner(lambda x: x * 2.0, batch_size=2)
        outs.append(list(RefScorer(r, "y", **scorer_kw())(iter([batch]))))

    _both_armed(tmp_path, monkeypatch, port, ref)
    got, want = ([b.column(1).to_pylist() for b in o] for o in outs)
    assert got == want == [[2.0, 4.0, 6.0, 8.0]]


def test_plane_stays_off_without_env(tmp_path):
    _port_fit()
    assert not telemetry.enabled()
    assert list(tmp_path.iterdir()) == []


def test_fault_tolerance_block_reports_a_rollback(tmp_path):
    """A fit saving every 2 steps to step 4; its newest checkpoint
    corrupted; the resumed fit rolls back to step 2 and its summary says
    so. A clean fit's block is None. Both packages alike."""
    summaries, clean = [], []
    for fit, ch, stats in ((_port_fit, chaos, metrics.run_stats),
                           (_ref_fit, ref_chaos, ref_metrics.run_stats)):
        d = str(tmp_path / ch.__name__)
        s0 = fit(d, steps=4, checkpoint_every=2)["meter"].summary()
        clean.append(s0)
        assert s0["fault_tolerance"] is None
        assert ch.corrupt_latest_checkpoint(d)
        res = fit(d, steps=6, checkpoint_every=2)
        assert int(res["state"].step) == 6
        assert res["meter"].steps == 4  # resumed at step 2
        s = res["meter"].summary()
        assert s["fault_tolerance"]["checkpoint_rollbacks"] == 1
        assert "4 -> 2" in s["fault_tolerance"]["last_rollback"]
        summaries.append(s)
        stats.reset()
    port, ref = summaries
    assert set(port) == set(ref)
    assert set(clean[0]) == set(clean[1])
    assert port["fault_tolerance"] == ref["fault_tolerance"]


def test_compile_cache_block(monkeypatch):
    """None until the process-wide cache has seen a signature, then its
    counters (the reference reports the same hits/misses pair)."""
    cache = runtime.CompileCache()
    monkeypatch.setattr(runtime, "GLOBAL_COMPILE_CACHE", cache)
    assert metrics.compile_cache_summary() is None
    assert metrics.ThroughputMeter().summary()["compile_cache"] is None
    cache.note("step", (1, 2))
    cache.note("step", (1, 2))
    got = metrics.compile_cache_summary()
    assert got == {"hits": 1, "misses": 1, "captures": 0, "replays": 0}
    ref_cache = ref_runtime.CompileCache()
    monkeypatch.setattr(ref_runtime, "GLOBAL_COMPILE_CACHE", ref_cache)
    ref_cache.note("step", (1, 2))
    ref_cache.note("step", (1, 2))
    want = ref_metrics.compile_cache_summary()
    assert {k: got[k] for k in ("hits", "misses")} == \
        {k: want[k] for k in ("hits", "misses")}
