"""The port's scoring runtime (``sparkdl_tpu_torch.core.runtime``):
``BatchRunner``, ``pad_batch``, ``background_iter``, ``parallel_map_iter``,
the dispatch retry / stall paths and ``resize_nhwc`` — twins of
``tests/test_runtime.py``'s and ``tests/test_image_io.py``'s, on the CPU
(``device="cpu"``; the pinned / side-stream path is in
``tests/test_torch_cuda.py``).

Resize tolerances against ``jax.image.resize(method="bilinear")`` on the
0-255 scale (both compute the same triangle-filter weights, in different
orders): downscale (antialiased) |Δ| ≤ 1e-2, measured 3.5e-3 at
320→299 and 6.1e-5 at 256→224; upscale |Δ| ≤ 2e-3, measured 4.7e-4 at
75→299. A batch already at the target size is returned unchanged.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sparkdl_tpu_torch.core import runtime
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.runner import chaos, events, metrics
from sparkdl_tpu_torch.runner.failures import (ScoringStageError,
                                               ScoringStallError,
                                               classify_exception)

DOWN_ATOL = 1e-2
UP_ATOL = 2e-3


def runner(fn, batch_size=4, **kw):
    return runtime.BatchRunner(fn, batch_size, device="cpu", **kw)


def test_pad_batch():
    x = np.ones((3, 4), np.float32)
    padded, n = runtime.pad_batch(x, 8)
    assert padded.shape == (8, 4) and n == 3
    np.testing.assert_array_equal(padded[3:], np.ones((5, 4)))
    d, n = runtime.pad_batch({"a": x, "b": np.zeros((3,))}, 4)
    assert d["a"].shape == (4, 4) and d["b"].shape == (4,) and n == 3
    same, n = runtime.pad_batch(x, 3)
    assert n == 3 and same.shape == (3, 4)
    with pytest.raises(ValueError):
        runtime.pad_batch(x, 2)


def test_runner_stage_full_batch_passes_through():
    arr = np.arange(12, dtype=np.float32).reshape(4, 3)
    staged, n, copied = runner(lambda b: b)._stage(arr)
    assert staged is arr and n == 4 and copied == 0


def test_runner_stage_pads_short_batch_with_row_zero():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    staged, n, copied = runner(lambda b: b)._stage(a)
    assert n == 2 and staged.shape == (4, 3) and copied == staged.nbytes
    np.testing.assert_array_equal(staged[:2], a)
    np.testing.assert_array_equal(staged[2:], np.broadcast_to(a[:1], (2, 3)))


def test_runner_stage_dict_batches_and_oversize():
    r = runner(lambda b: b)
    batch = {"a": np.zeros((2, 3), np.float32),
             "b": np.ones((2, 2), np.int32)}
    staged, n, copied = r._stage(batch)
    assert n == 2 and staged["a"].shape == (4, 3) \
        and staged["b"].shape == (4, 2)
    assert copied == sum(v.nbytes for v in staged.values())
    with pytest.raises(ValueError, match="exceeds"):
        r._stage(np.zeros((5, 3), np.float32))


def test_pad_span_records_rows_and_bytes_copied():
    rec = events.get_recorder()
    rec.ring.clear()
    list(runner(lambda b: b).run([np.ones((4, 2), np.float32),
                                  np.ones((3, 2), np.float32)]))
    pads = [(e["rows"], e["bytes"]) for e in rec.ring
            if e["name"] == "pad" and e["ph"] == "E"]
    assert pads == [(4, 0), (3, 4 * 2 * 4)]


def test_batch_runner_pads_runs_unpads():
    shapes = []

    def fn(x):
        shapes.append(tuple(x.shape))
        return x * 2.0

    r = runner(fn)
    batches = [np.ones((4, 3), np.float32), np.ones((4, 3), np.float32),
               np.ones((2, 3), np.float32)]  # ragged tail
    outs = list(r.run(iter(batches)))
    assert [o.shape for o in outs] == [(4, 3), (4, 3), (2, 3)]
    assert all(isinstance(o, np.ndarray) for o in outs)
    np.testing.assert_allclose(outs[2], 2.0)
    # one signature: the static shape is held across full and padded
    assert set(shapes) == {(4, 3)}
    assert runtime.GLOBAL_COMPILE_CACHE.signatures(r._sig_name) == 1


def test_batch_runner_dict_batches():
    r = runner(lambda d: {"s": d["a"] + d["b"]})
    out = next(iter(r.run([{"a": np.ones((3, 2), np.float32),
                            "b": np.ones((3, 2), np.float32)}])))
    assert out["s"].shape == (3, 2)
    np.testing.assert_allclose(out["s"], 2.0)


def test_batch_runner_input_cast_and_pipelining():
    """uint8 host feed + on-device cast matches a float32 feed, across a
    stream long enough to exercise the in-flight window."""
    fn = lambda b: b.sum(dim=(1, 2, 3))
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, 256, size=(4, 5, 5, 3)).astype(np.uint8)
               for _ in range(7)]
    got = list(runner(fn, input_cast=torch.float32).run(iter(batches)))
    want = list(runner(fn).run(b.astype(np.float32) for b in batches))
    assert len(got) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_batch_runner_preprocess_runs_inside_the_step():
    seen = []

    def pre(x):
        seen.append(x.dtype)
        return x.flip(-1)

    r = runner(lambda b: b[..., 0], input_cast=torch.float32, preprocess=pre)
    x = np.arange(2 * 3, dtype=np.uint8).reshape(2, 1, 1, 3)
    out = next(iter(r.run([x])))
    np.testing.assert_array_equal(out[:, 0, 0], [2.0, 5.0])
    assert seen == [torch.float32]


def test_read_only_views_are_copied_not_aliased():
    x = np.ones((4, 2), np.float32)
    x.flags.writeable = False
    out = next(iter(runner(lambda b: b.add_(1.0)).run([x])))
    np.testing.assert_allclose(out, 2.0)
    np.testing.assert_allclose(x, 1.0)


def test_recompile_accounting_per_runner_signature():
    rec = events.get_recorder()
    rec.ring.clear()
    r = runner(lambda b: b * 1.0, batch_size=2)
    list(r.run([np.ones((2, 3), np.float32), np.ones((2, 3), np.float32),
                np.ones((2, 5), np.float32), np.ones((1, 5), np.uint8)]))
    assert runtime.GLOBAL_COMPILE_CACHE.signatures(r._sig_name) == 3
    ev = [e for e in rec.ring if e["name"] == "recompile"
          and e.get("fn") == r._sig_name]
    assert len(ev) == 3
    # a new runner is a new name: the same shapes are new signatures
    r2 = runner(lambda b: b * 1.0, batch_size=2)
    list(r2.run([np.ones((2, 3), np.float32)]))
    assert runtime.GLOBAL_COMPILE_CACHE.signatures(r2._sig_name) == 1


def test_all_stages_emit_spans():
    rec = events.get_recorder()
    rec.ring.clear()
    list(runner(lambda b: b + 1.0).run([np.ones((3, 2), np.float32)]))
    names = {e["name"] for e in rec.ring if e["ph"] == "E"}
    assert {"pad", "put", "dispatch", "fetch"} <= names
    put = [e for e in rec.ring if e["name"] == "put" and e["ph"] == "E"][0]
    assert put["bytes"] == 4 * 2 * 4 and put["rows"] == 3


@pytest.mark.parametrize("value,donate", [(None, False), ("0", False),
                                          ("1", True), ("true", True),
                                          ("yes", True)])
def test_infer_donate_knob_is_the_default(monkeypatch, value, donate):
    """``SPARKDL_INFER_DONATE`` sets ``donate``'s default with the
    reference's truth table (``1``, ``true``, ``yes``); an explicit
    argument wins."""
    monkeypatch.delenv("SPARKDL_INFER_DONATE", raising=False)
    if value is not None:
        monkeypatch.setenv("SPARKDL_INFER_DONATE", value)
    assert runner(lambda b: b).donate == donate
    assert runner(lambda b: b, donate=not donate).donate == (not donate)


def test_mesh_and_donate_are_not_ported():
    """``donate`` and ``mesh`` run now: a donating runner gives the same
    outputs, and while its step runs nothing else holds the device batch
    it was given (its input cast made a new one); a runner that does not
    donate still holds it. A mesh without the data axis is refused. (The
    multi-rank feed is held in tests/test_torch_moe_pipeline.py.)"""
    import gc
    import weakref

    batches = [np.arange(6, dtype=np.uint8).reshape(3, 2)] * 3
    want = [o for o in runner(lambda b: b * 2.0,
                              input_cast=torch.float32).run(batches)]
    for donate in (False, True):
        r = runner(lambda b: b, donate=donate, input_cast=torch.float32)
        assert r.donate == donate
        put, refs, alive = r._put, [], []

        def spy(staged):
            dev, ready = put(staged)
            refs.append(weakref.ref(dev))
            return dev, ready

        def fn(b):
            gc.collect()
            alive.append(refs[len(alive)]() is not None)
            return b * 2.0

        r._put, r._fn = spy, fn
        got = [o for o in r.run(batches)]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert alive == [not donate] * 3

    class NoData:
        mesh_dim_names = ("tp",)

    with pytest.raises(ValueError, match="not an axis"):
        runner(lambda b: b, mesh=NoData())


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.BatchRunner(lambda b: b, 4)


def test_background_iter_order_and_error():
    assert list(runtime.background_iter(iter(range(20)), maxsize=3)) \
        == list(range(20))

    def boom():
        yield 1
        raise RuntimeError("decode failed")

    it = runtime.background_iter(boom(), maxsize=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        list(it)


def test_background_iter_cancellation_releases_producer():
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    before = threading.active_count()
    it = runtime.background_iter(gen(), maxsize=1)
    assert next(it) == 0
    it.close()  # abandon mid-stream
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer thread leaked"
    assert len(produced) < 100, "producer ran unbounded after close"


def test_parallel_map_iter_order_error_and_inline():
    def slow_sq(i):
        time.sleep(0.01 * ((i * 7) % 3))  # jittered: tempt reordering
        return i * i

    got = list(runtime.parallel_map_iter(slow_sq, range(20), workers=4))
    assert got == [i * i for i in range(20)]
    assert list(runtime.parallel_map_iter(slow_sq, range(5), workers=0)) \
        == [i * i for i in range(5)]

    def boom(i):
        if i == 3:
            raise RuntimeError("decode failed")
        return i

    it = runtime.parallel_map_iter(boom, range(6), workers=2)
    assert next(it) == 0
    with pytest.raises(RuntimeError, match="decode failed"):
        list(it)


def test_parallel_map_iter_env_default(monkeypatch):
    monkeypatch.setenv("SPARKDL_DECODE_WORKERS", "3")
    assert runtime.decode_workers_default() == 3
    monkeypatch.setenv("SPARKDL_DECODE_WORKERS", "junk")
    assert runtime.decode_workers_default() == 2


def test_run_stream_threads_meta_and_matches_run():
    r = runner(lambda x: x + 1.0)
    batches = [np.full((3, 2), i, np.float32) for i in range(6)]
    metas = [("part", i) for i in range(6)]
    out = list(r.run_stream(zip(batches, metas)))
    assert [m for _, m in out] == metas
    for i, (o, _) in enumerate(out):
        assert o.shape == (3, 2)
        np.testing.assert_allclose(o, i + 1.0)
    for (o, _), o2 in zip(out, r.run(iter(batches))):
        np.testing.assert_array_equal(o, o2)


def test_run_stream_no_drain_at_partition_boundaries():
    """With a full prefetch window, dispatches run ahead across
    'partition' boundaries: before the FIRST output is fetched, chunks of
    later partitions have already been dispatched."""
    r = runner(lambda x: x * 2.0, batch_size=2, prefetch=2)
    dispatched = []
    inner = r._launch
    r._launch = lambda b, ready: (dispatched.append(1), inner(b, ready))[1]
    stream = r.run_stream(
        (np.full((2, 2), i, np.float32), i) for i in range(5))
    out0, meta0 = next(stream)
    assert meta0 == 0
    np.testing.assert_allclose(out0, 0.0)
    assert len(dispatched) >= 3, dispatched
    rest = list(stream)
    assert [m for _, m in rest] == [1, 2, 3, 4]
    assert len(dispatched) == 5


@pytest.fixture
def fast_backoff(monkeypatch):
    monkeypatch.setenv("SPARKDL_DISPATCH_BACKOFF_S", "0.01")
    metrics.run_stats.reset()
    rec = events.get_recorder()
    rec.ring.clear()
    yield rec
    chaos.uninstall()
    rec.ring.clear()
    metrics.run_stats.reset()


@pytest.mark.chaos
def test_dispatch_transient_fault_retried_once(fast_backoff):
    chaos.install(chaos.FaultPlan([chaos.Fault("dispatch", "preempt",
                                               prob=1.0, once=True)]))
    out = list(runner(lambda b: b * 2.0).run(iter([
        np.ones((4, 2), np.float32), np.full((3, 2), 3.0, np.float32)])))
    assert len(out) == 2
    np.testing.assert_allclose(out[0], 2.0)
    np.testing.assert_allclose(out[1], 6.0)
    assert out[1].shape == (3, 2)  # pad rows still sliced on retry
    names = [e["name"] for e in fast_backoff.tail()]
    assert "retry" in names and "give_up" not in names
    assert metrics.run_stats.dispatch_retries == 1
    assert metrics.run_stats.faults_injected == 1


@pytest.mark.chaos
def test_dispatch_persistent_fault_exhausts_backoff(fast_backoff):
    chaos.install(chaos.FaultPlan([chaos.Fault("dispatch", "preempt",
                                               prob=1.0, once=False)]))
    with pytest.raises(ScoringStageError, match="stage 'dispatch'") as ei:
        list(runner(lambda b: b * 2.0).run(iter([np.ones((4, 2),
                                                         np.float32)])))
    assert ei.value.attempts == 1 + runtime.dispatch_retries_default()
    assert classify_exception(ei.value) == "retryable"
    evs = fast_backoff.tail()
    assert [e["name"] for e in evs].count("retry") == \
        runtime.dispatch_retries_default()
    assert any(e["name"] == "give_up" and e["stage"] == "dispatch"
               for e in evs)
    assert metrics.run_stats.dispatch_giveups == 1


@pytest.mark.chaos
def test_dispatch_fatal_fault_not_retried(fast_backoff):
    chaos.install(chaos.FaultPlan([chaos.Fault("dispatch", "fatal",
                                               prob=1.0, once=False)]))
    with pytest.raises(ScoringStageError) as ei:
        list(runner(lambda b: b * 2.0).run(iter([np.ones((4, 2),
                                                         np.float32)])))
    assert ei.value.attempts == 1
    assert classify_exception(ei.value) == "fatal"
    assert metrics.run_stats.dispatch_retries == 0


@pytest.mark.parametrize("text", [
    "CUDA out of memory. Tried to allocate 2.00 GiB",
    "CUDA error: an illegal memory access was encountered"])
def test_cuda_device_faults_are_fatal_not_retried(fast_backoff, text):
    calls = []

    def step(b):
        calls.append(1)
        raise RuntimeError(text)

    with pytest.raises(ScoringStageError) as ei:
        list(runner(step).run(iter([np.ones((4, 2), np.float32)])))
    assert ei.value.attempts == 1 and len(calls) == 1
    assert classify_exception(ei.value) == "fatal"
    assert metrics.run_stats.dispatch_retries == 0


def test_retries_disabled_restores_lean_path(fast_backoff, monkeypatch):
    monkeypatch.setenv("SPARKDL_DISPATCH_RETRIES", "0")
    chaos.install(chaos.FaultPlan([chaos.Fault("dispatch", "preempt",
                                               prob=1.0, once=True)]))
    with pytest.raises(ScoringStageError, match="1 attempt"):
        list(runner(lambda b: b * 2.0).run(iter([np.ones((4, 2),
                                                         np.float32)])))


def test_stall_watchdog_names_the_stage(fast_backoff, monkeypatch):
    monkeypatch.setenv("SPARKDL_DISPATCH_TIMEOUT_S", "0.4")

    def wedge(b):
        time.sleep(2.0)
        return b

    t0 = time.perf_counter()
    with pytest.raises(ScoringStallError, match="no progress") as ei:
        list(runner(wedge).run(iter([np.ones((4, 2), np.float32)])))
    assert ei.value.stage in ("dispatch", "fetch")
    assert classify_exception(ei.value) == "retryable"
    assert time.perf_counter() - t0 < 1.9  # did NOT wait out the hang
    assert any(e["name"] == "give_up" and e.get("stalled")
               for e in fast_backoff.tail())


RESIZE_CASES = [((12, 12), (6, 6), DOWN_ATOL),
                ((320, 320), (299, 299), DOWN_ATOL),
                ((256, 256), (224, 224), DOWN_ATOL),
                ((64, 48), (17, 33), DOWN_ATOL),
                ((75, 75), (299, 299), UP_ATOL),
                ((20, 30), (57, 41), UP_ATOL)]


@pytest.mark.parametrize("src,dst,atol", RESIZE_CASES,
                         ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}"
                              for s, d, _ in RESIZE_CASES])
def test_resize_matches_jax_image_resize(src, dst, atol):
    x = np.random.RandomState(0).randint(0, 256, (2,) + src + (3,)).astype(
        np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + dst + (3,),
                                      method="bilinear"))
    got = runtime.resize_nhwc(torch.from_numpy(x), *dst)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)


def test_resize_same_size_is_exact_and_uint8_upcasts():
    x = np.random.RandomState(1).randint(0, 256, (2, 9, 7, 3)).astype(
        np.uint8)
    got = runtime.resize_nhwc(x, 9, 7)
    np.testing.assert_array_equal(got.numpy(), x.astype(np.float32))
    t = torch.from_numpy(x.astype(np.float32))
    assert runtime.resize_nhwc(t, 9, 7) is t


def test_resize_image_batch_nhwc():
    batch = np.random.RandomState(2).randint(
        0, 256, (2, 12, 12, 3)).astype(np.float32)
    out = imageIO.resizeImageBatchNHWC(batch, 6, 6)
    assert isinstance(out, np.ndarray) and out.shape == (2, 6, 6, 3)
    dev = imageIO.resizeImageBatchNHWC(torch.from_numpy(batch), 6, 6,
                                       device=True)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), out)
