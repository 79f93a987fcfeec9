"""The port's streaming scorer on the image path
(``sparkdl_tpu_torch.transformers.streaming`` under ``XlaImageTransformer``,
``device="cpu"``): the image half of ``tests/test_streaming.py`` —
cross-partition reassembly, the no-drain window, every stage's span, the
process decode backend (equivalence, quarantine, chaos across the pool
boundary, ``workers=0``), and the fused-feed policy's regressions (static
input size, the row fallback on mixed sizes, the wire-shape budget).

The functions are torch callables over NHWC float32 tensors. Outputs are
held bitwise wherever the reference holds them so (the same host decode
feeds the same CPU step); the fused/host-pack comparison is held to 1e-4
(the reference's own rule there: the pack resizes in float on the host).
"""

import os

import numpy as np
import pyarrow as pa
import pytest

import sparkdl_tpu_torch as tdl
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.runner import chaos, events, metrics
from sparkdl_tpu_torch.runner.failures import QuarantineOverflowError


def image_df(imgs, parts=1, corrupt=()):
    structs = [imageIO.imageArrayToStruct(im, origin=f"m{i}")
               for i, im in enumerate(imgs)]
    for i in corrupt:
        structs[i] = dict(structs[i], data=b"\x00" * 5)
    return tdl.DataFrame.fromArrow(
        pa.table({"image": pa.array(structs, type=imageIO.imageSchema)}),
        numPartitions=parts)


def mean_transformer(**kw):
    kw.setdefault("inputSize", (8, 8))
    kw.setdefault("batchSize", 4)
    return tdl.XlaImageTransformer(inputCol="image", outputCol="out",
                                   fn=lambda b: b.mean(dim=(1, 2)),
                                   device="cpu", **kw)


def outs(rows):
    return np.asarray([r.out for r in rows], np.float32)


@pytest.fixture
def clean_stats():
    metrics.run_stats.reset()
    events.get_recorder().ring.clear()
    yield
    chaos.uninstall()
    metrics.run_stats.reset()


def test_image_transformer_streams_across_partitions():
    """Constant-valued rows pin row ORDER across the partition
    reassembly (model-output structs carry no origin)."""
    imgs = [np.full((8, 8, 3), i * 20, np.uint8) for i in range(10)]
    t = tdl.XlaImageTransformer(
        inputCol="image", outputCol="out", fn=lambda b: b * 0.5,
        inputSize=(8, 8), batchSize=2, outputMode="image", device="cpu")
    rows = t.transform(image_df(imgs, parts=5)).collect()
    assert len(rows) == 10
    assert all(r.out["height"] == 8 for r in rows)
    got = [np.frombuffer(r.out["data"], np.uint8)[0] for r in rows]
    assert got == [i * 10 for i in range(10)]


def test_no_drain_at_partition_boundaries():
    """After the first partition's output is materialized, chunks of
    later partitions have already been dispatched: the window crossed
    the boundaries instead of draining."""
    imgs = [np.full((8, 8, 3), i, np.uint8) for i in range(24)]
    t = mean_transformer()
    runner = t._get_runner()
    dispatched = []
    inner = runner._launch
    runner._launch = lambda b, r: (dispatched.append(1), inner(b, r))[1]
    parts = t.transform(image_df(imgs, parts=6)).iterPartitions()
    first = next(parts)
    assert first.num_rows == 4
    assert len(dispatched) >= 3, dispatched
    assert len(list(parts)) == 5
    assert len(dispatched) == 6


def test_all_scoring_stages_emit_spans(clean_stats):
    imgs = [np.full((8, 8, 3), i, np.uint8) for i in range(12)]
    assert len(mean_transformer().transform(image_df(imgs, 3)).collect()) \
        == 12
    ring = list(events.get_recorder().ring)
    for stage in ("decode", "pad", "put", "dispatch", "fetch", "encode"):
        ends = [e for e in ring if e["name"] == stage and e["ph"] == "E"]
        assert len(ends) >= 3, f"missing spans for stage {stage}"
        assert all("dur_s" in e for e in ends)


def test_process_backend_image_equivalence(monkeypatch):
    """Compacted Arrow chunk payloads over the pickle boundary: identical
    to the thread backend."""
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (8, 8, 3), np.uint8) for _ in range(10)]
    df = image_df(imgs, parts=3)
    t = mean_transformer()
    thread = outs(t.transform(df).collect())
    monkeypatch.setenv("SPARKDL_DECODE_BACKEND", "process")
    np.testing.assert_array_equal(outs(t.transform(df).collect()), thread)


def test_process_backend_quarantine_equivalence(monkeypatch, clean_stats):
    """The row fallback runs in the pool child, dead-letter rows re-base
    onto the partition, and survivors and classes match the threads'."""
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (6, 6, 3), np.uint8) for _ in range(12)]
    df = image_df(imgs, parts=2, corrupt=(2, 9))
    t = mean_transformer(inputSize=(6, 6), onError="quarantine")
    thread_out = t.transform(df).collect()
    thread_dead = t.deadLetters()
    monkeypatch.setenv("SPARKDL_DECODE_BACKEND", "process")
    out = t.transform(df).collect()
    dead = t.deadLetters()
    assert len(out) == len(thread_out) == 10
    assert [r["origin"] for r in dead.column("image").to_pylist()] == \
        [r["origin"] for r in thread_dead.column("image").to_pylist()] == \
        ["m2", "m9"]
    assert dead.column("error_class").to_pylist() == \
        thread_dead.column("error_class").to_pylist()
    np.testing.assert_array_equal(outs(out), outs(thread_out))


def test_process_backend_chaos_decode_all_rows_dead(monkeypatch,
                                                    clean_stats):
    """Chaos ``decode`` fires IN THE POOL CHILD (the plan ships with each
    task): every chunk and row attempt fails, the whole input
    quarantines and the circuit breaker trips."""
    monkeypatch.setenv("SPARKDL_DECODE_BACKEND", "process")
    imgs = [np.full((6, 6, 3), i, np.uint8) for i in range(8)]
    t = mean_transformer(inputSize=(6, 6), onError="quarantine")
    chaos.install(chaos.FaultPlan(
        [chaos.Fault("decode", "fatal", prob=1.0, once=False)]))
    with pytest.raises(QuarantineOverflowError):
        t.transform(image_df(imgs, parts=2)).collect()


def test_process_backend_chaos_once_semantics(tmp_path, monkeypatch,
                                              clean_stats):
    """once=True with a plan ``state_dir`` holds across pool children:
    one chunk fails and row-recovers, the output is whole."""
    monkeypatch.setenv("SPARKDL_DECODE_BACKEND", "process")
    imgs = [np.full((6, 6, 3), i, np.uint8) for i in range(8)]
    t = mean_transformer(inputSize=(6, 6), onError="quarantine")
    chaos.install(chaos.FaultPlan(
        [chaos.Fault("decode", "fatal", prob=1.0, once=True)],
        state_dir=str(tmp_path)))
    out = t.transform(image_df(imgs, parts=2)).collect()
    assert len(out) == 8
    assert t.deadLetters().num_rows == 0
    assert [f for f in os.listdir(tmp_path) if f.endswith(".fired")]


def test_process_backend_workers0_inline(monkeypatch):
    monkeypatch.setenv("SPARKDL_DECODE_BACKEND", "process")
    monkeypatch.setenv("SPARKDL_DECODE_WORKERS", "0")
    imgs = [np.full((8, 8, 3), i, np.uint8) for i in range(11)]
    got = outs(mean_transformer().transform(image_df(imgs, 3)).collect())
    np.testing.assert_array_equal(got, np.repeat(
        np.arange(11, dtype=np.float32)[:, None], 3, axis=1))


def test_fused_feed_requires_static_input_size():
    """No ``inputSize``: the target is pinned per partition at decode time,
    which the prologue cannot know, so the feed stays on the host pack;
    a later chunk uniformly SMALLER than the pinned target must still be
    resized."""
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (16, 16, 3), np.uint8) for _ in range(8)]
    imgs += [rng.integers(0, 256, (8, 8, 3), np.uint8) for _ in range(4)]
    t = tdl.XlaImageTransformer(inputCol="image", outputCol="out",
                                fn=lambda b: b.mean(dim=(1, 2)),
                                batchSize=4, device="cpu")
    got = outs(t.transform(image_df(imgs)).collect())
    assert got.shape == (12, 3)
    expect = imageIO.imageColumnToNHWC(
        pa.array([imageIO.imageArrayToStruct(im) for im in imgs],
                 type=imageIO.imageSchema), 16, 16, dtype=np.uint8,
        channelOrder="RGB").astype(np.float32).mean(axis=(1, 2))
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_fused_row_fallback_keeps_mixed_size_rows(monkeypatch, backend,
                                                  clean_stats):
    """A chunk mixing stored sizes (all ≤ target) plus one corrupt row
    dead-letters exactly the corrupt row: the 1-row re-decodes pack at
    the target, so valid minority-size rows keep the modal shape."""
    monkeypatch.setenv("SPARKDL_DECODE_BACKEND", backend)
    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 256, (8 if i % 2 else 6,) * 2 + (3,), np.uint8)
            for i in range(8)]
    t = mean_transformer(inputSize=(16, 16), batchSize=8,
                         onError="quarantine")
    out = t.transform(image_df(imgs, corrupt=(3,))).collect()
    assert len(out) == 7
    assert [r["origin"] for r in
            t.deadLetters().column("image").to_pylist()] == ["m3"]


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_wire_shape_cap_bounds_native_sizes(monkeypatch, backend,
                                            clean_stats):
    """SPARKDL_MAX_WIRE_SHAPES=1 and three uniform-size runs: exactly one
    native size goes over the wire (the put spans' byte ledger), all rows
    scored, and the runner sees two signatures (that size and the
    target), each one ``recompile`` event — what the budget bounds."""
    from sparkdl_tpu_torch.core.runtime import GLOBAL_COMPILE_CACHE
    monkeypatch.setenv("SPARKDL_DECODE_BACKEND", backend)
    monkeypatch.setenv("SPARKDL_MAX_WIRE_SHAPES", "1")
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, (e, e, 3), np.uint8)
            for e in (6, 6, 8, 8, 10, 10)]
    t = mean_transformer(inputSize=(16, 16), batchSize=2)
    got = outs(t.transform(image_df(imgs)).collect())
    assert got.shape == (6, 3)
    put_bytes = sorted(e["bytes"] for e in events.get_recorder().ring
                       if e["name"] == "put" and e["ph"] == "E")
    assert [b for b in put_bytes if b < 2 * 16 * 16 * 3] == \
        [2 * 6 * 6 * 3], put_bytes
    name = t._get_runner()._sig_name
    assert GLOBAL_COMPILE_CACHE.signatures(name) == 2
    assert len([e for e in events.get_recorder().ring
                if e["name"] == "recompile" and e.get("fn") == name]) == 2


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_wire_budget_not_stranded_on_undeliverable_chunk(monkeypatch,
                                                         backend,
                                                         clean_stats):
    """A metadata-uniform chunk whose zero-copy view declines (a truncated
    payload) consumes no budget slot: a later shippable size still goes
    native."""
    monkeypatch.setenv("SPARKDL_DECODE_BACKEND", backend)
    monkeypatch.setenv("SPARKDL_MAX_WIRE_SHAPES", "1")
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (8, 8, 3), np.uint8) for _ in range(4)]
    imgs += [rng.integers(0, 256, (6, 6, 3), np.uint8) for _ in range(4)]
    t = mean_transformer(inputSize=(16, 16), batchSize=4,
                         onError="quarantine")
    out = t.transform(image_df(imgs, corrupt=(1,))).collect()
    assert len(out) == 7
    assert [r["origin"] for r in
            t.deadLetters().column("image").to_pylist()] == ["m1"]
    put_bytes = sorted(e["bytes"] for e in events.get_recorder().ring
                       if e["name"] == "put" and e["ph"] == "E")
    assert 4 * 6 * 6 * 3 in put_bytes, put_bytes
