"""Twins of ``tests/test_frame.py`` on the port's copy of the DataFrame
(``sparkdl_tpu_torch.core.frame``, reached as ``sparkdl_tpu_torch.DataFrame``
too), and of ``tests/test_data.py``'s ``ArrowDataset`` tests on the port's
``runner.data.ArrowDataset``. The frame is host code, the same on both
sides; each twin asserts what its original does."""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from sparkdl_tpu_torch.core.frame import DataFrame


def make_df(n=10, parts=3):
    return DataFrame.fromPydict(
        {"x": list(range(n)), "y": [float(i) * 2 for i in range(n)]},
        numPartitions=parts)


def test_constructors_roundtrip():
    df = make_df()
    assert df.count() == 10
    assert df.numPartitions == 3
    assert df.columns == ["x", "y"]
    pdf = df.toPandas()
    assert list(pdf["x"]) == list(range(10))

    df2 = DataFrame.fromPandas(pd.DataFrame({"a": [1, 2, 3]}), numPartitions=2)
    assert df2.count() == 3 and df2.numPartitions == 2

    df3 = DataFrame.fromRows([{"a": 1}, {"a": 2}])
    assert [r.a for r in df3.collect()] == [1, 2]


def test_select_drop_rename():
    df = make_df()
    assert df.select("y").columns == ["y"]
    assert df.drop("y").columns == ["x"]
    assert df.withColumnRenamed("x", "z").columns == ["z", "y"]


def test_with_column_rowwise_and_batch():
    df = make_df(6, parts=2)
    out = df.withColumn("s", lambda x, y: x + y, inputCols=["x", "y"])
    rows = out.collect()
    assert all(r.s == r.x + r.y for r in rows)

    out2 = df.withColumnBatch(
        "z", lambda x: np.asarray(x) * 10, inputCols=["x"])
    assert [r.z for r in out2.collect()] == [i * 10 for i in range(6)]


def test_filter_and_count():
    df = make_df(10, parts=4)
    f = df.filter(lambda r: r.x % 2 == 0)
    assert f.count() == 5
    assert all(r.x % 2 == 0 for r in f.collect())


def test_iter_batches_rechunks_across_partitions():
    df = make_df(10, parts=3)  # partitions of 4,4,2
    sizes = [b.num_rows for b in df.iterBatches(3)]
    assert sizes == [3, 3, 3, 1]
    seen = []
    for b in df.iterBatches(4):
        seen.extend(b.column("x").to_pylist())
    assert seen == list(range(10))


def test_lazy_ops_compose_single_pass():
    calls = []
    df = make_df(4, parts=1)

    def op(b):
        calls.append(b.num_rows)
        return b

    chained = df.mapBatches(op).select("x")
    assert calls == []  # nothing ran yet
    chained.collect()
    assert calls == [4]


def test_nested_tensor_column():
    imgs = np.arange(2 * 2 * 3, dtype=np.float32).reshape(2, 2, 3)
    df = DataFrame.fromPydict({"img": imgs, "label": [0, 1]})
    rows = df.collect()
    assert np.allclose(np.asarray(rows[0].img), imgs[0])


def test_take_limit_first_cache_repartition():
    df = make_df(10, parts=3)
    assert [r.x for r in df.take(5)] == [0, 1, 2, 3, 4]
    assert df.limit(5).count() == 5
    assert df.first().x == 0
    cached = df.withColumn("z", lambda x: x + 1, inputCols=["x"]).cache()
    assert cached._ops == ()
    assert cached.count() == 10
    rp = df.repartition(5)
    assert rp.numPartitions == 5 and rp.count() == 10
    with pytest.raises(ValueError):
        DataFrame.fromPydict({"x": []}).first()


def test_limit_after_filter_applies_post_filter():
    # Regression: limit must see the filtered stream, not raw partitions.
    df = DataFrame.fromPydict({"x": list(range(10))}, numPartitions=3)
    out = df.filter(lambda r: r.x % 2 == 0).limit(3)
    assert [r.x for r in out.collect()] == [0, 2, 4]


def test_with_column_batch_preserves_tensor_shape():
    df = DataFrame.fromPydict({"x": list(range(4))})
    out = df.withColumnBatch("t", lambda x: np.ones((4, 2, 3), np.float32),
                             inputCols=["x"])
    assert np.asarray(out.first().t).shape == (2, 3)


def test_count_fast_path_does_not_materialize():
    calls = []
    df = make_df(6, parts=2)

    def probe(x):
        calls.append(1)
        return np.asarray(x)

    chained = df.select("x").withColumnBatch("y", probe, inputCols=["x"])
    assert chained.count() == 6
    assert calls == []  # length-preserving chain → no materialization


def test_streaming_only_for_row_wise_ops():
    """iterBatches may slice raw partitions ahead of ROW-WISE ops, but a
    withColumnBatch fn that aggregates across its batch (mean-centering)
    must keep partition granularity — collect() and iterBatches() must
    agree."""
    df = DataFrame.fromPydict({"x": [float(i) for i in range(16)]},
                              numPartitions=1)
    centered = df.withColumnBatch(
        "z", lambda x: np.asarray(x) - np.asarray(x).mean(), ["x"])
    via_collect = [r.z for r in centered.collect()]
    via_batches = [z for b in centered.iterBatches(4)
                   for z in b.column("z").to_pylist()]
    assert via_collect == via_batches

    # row-wise chain (withColumn + filter + select) IS streamed: chunks of
    # at most the batch size reach the ops
    seen = []
    probe = df.withColumn("w", lambda x: x + 1, ["x"]) \
              .filter(lambda r: r.x != 3.0)

    def spy(b):
        seen.append(b.num_rows)
        return b

    spy._changes_length = False
    spy._row_wise = True
    out = [r for b in probe.mapBatches(spy).iterBatches(4)
           for r in b.to_pylist()]
    assert len(out) == 15
    assert max(seen) <= 4


def test_parquet_round_trip(tmp_path):
    """toParquet/fromParquet: the durable interchange format — schema,
    values (incl. list columns), and partitioning survive the round trip."""
    import numpy as np

    import sparkdl_tpu_torch as sdl

    df = sdl.DataFrame.fromPydict(
        {"x": list(range(10)),
         "vec": [np.arange(3, dtype=np.float32) + i for i in range(10)]},
        numPartitions=3)
    p = str(tmp_path / "t.parquet")
    df.toParquet(p)

    back = sdl.DataFrame.fromParquet(p)
    assert back.numPartitions == df.numPartitions  # row groups = partitions
    assert back.columns == ["x", "vec"]
    rows = back.collect()
    assert [r["x"] for r in rows] == list(range(10))
    np.testing.assert_allclose(rows[4]["vec"], [4.0, 5.0, 6.0])

    # forced re-split
    re = sdl.DataFrame.fromParquet(p, numPartitions=2)
    assert re.numPartitions == 2 and re.count() == 10

    # lazy ops stream through toParquet (written post-op)
    df2 = df.withColumn("y", lambda x: x * 2, ["x"])
    p2 = str(tmp_path / "t2.parquet")
    df2.toParquet(p2)
    assert [r["y"] for r in sdl.DataFrame.fromParquet(p2).collect()] == \
        [2 * i for i in range(10)]


def test_parquet_empty_partitions_and_directories(tmp_path):
    import pyarrow.parquet as pq

    import sparkdl_tpu_torch as sdl

    # a filter emptying partition 0 leaves a degenerate null-typed op
    # column there — the writer schema must come from a NON-empty batch
    df = sdl.DataFrame.fromPydict({"x": [1, 2, 3, 4]}, numPartitions=2) \
        .filter(lambda r: r["x"] > 2) \
        .withColumn("y", lambda x: x * 2, ["x"])
    p = str(tmp_path / "filtered.parquet")
    df.toParquet(p)
    back = sdl.DataFrame.fromParquet(p)
    assert [(r["x"], r["y"]) for r in back.collect()] == [(3, 6), (4, 8)]

    # dataset DIRECTORY: row groups across all member files = partitions
    d = tmp_path / "dataset"
    d.mkdir()
    sdl.DataFrame.fromPydict({"x": [0, 1]}).toParquet(str(d / "a.parquet"))
    sdl.DataFrame.fromPydict({"x": [2, 3]}, numPartitions=2) \
        .toParquet(str(d / "b.parquet"))
    dd = sdl.DataFrame.fromParquet(str(d))
    assert dd.numPartitions == 3  # 1 row group + 2 row groups
    assert sorted(r["x"] for r in dd.collect()) == [0, 1, 2, 3]

    # an all-empty frame still writes a valid (0-row) file
    empty = sdl.DataFrame.fromPydict({"x": [1]}).filter(lambda r: False)
    pe = str(tmp_path / "empty.parquet")
    empty.toParquet(pe)
    assert pq.read_table(pe).num_rows == 0


def test_show(capsys):
    import sparkdl_tpu_torch as sdl

    df = sdl.DataFrame.fromPydict(
        {"name": ["a-very-long-string-that-overflows", "b"],
         "x": [1, 22]})
    df.show(truncate=10)
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert lines[1].count("|") == 3  # header row: | name | x |
    assert "a-very-..." in out  # truncated to 10 chars
    assert "22" in out
    # n limits the rows shown
    df.show(n=1)
    out2 = capsys.readouterr().out
    assert "22" not in out2
    # the ubiquitous Spark idiom: truncate=True means the default 20,
    # not the bool-as-int s[:True] one-char cut; False disables
    df.show(truncate=True)
    out3 = capsys.readouterr().out
    assert "a-very-long-strin..." in out3
    df.show(truncate=False)
    out4 = capsys.readouterr().out
    assert "a-very-long-string-that-overflows" in out4


def test_iter_batches_many_tiny_partitions_linear():
    """The deque-of-batches carry re-chunks
    many tiny partitions correctly — every row exactly once, in order,
    exact batch sizes — and never calls pa.concat_tables (the old
    table-carry whose repeated remainder concat was quadratic)."""
    import pyarrow as _pa
    from unittest import mock

    n = 501
    df = DataFrame.fromPydict({"x": list(range(n))}, numPartitions=n)
    assert df.numPartitions == n  # one row per partition
    with mock.patch.object(_pa, "concat_tables",
                           side_effect=AssertionError("table-carry used")):
        sizes, seen = [], []
        for b in df.iterBatches(64):
            sizes.append(b.num_rows)
            seen.extend(b.column("x").to_pylist())
    assert sizes == [64] * (n // 64) + [n % 64]
    assert seen == list(range(n))

    # big-partition → small batches direction too (zero-copy head slicing)
    df2 = DataFrame.fromPydict({"x": list(range(100))}, numPartitions=2)
    got = [b.column("x").to_pylist() for b in df2.iterBatches(7)]
    assert [len(g) for g in got] == [7] * 14 + [2]
    assert [x for g in got for x in g] == list(range(100))


def test_map_stream_op_chains_and_probes():
    """mapStream: the fn sees all partition batches in one iterator per
    materialization, composes with per-batch ops, and the 1-row schema
    probe works through it."""
    calls = []

    def stream_fn(parts):
        calls.append("open")
        for b in parts:
            yield b.set_column(
                b.schema.get_field_index("x") if "x" in b.schema.names
                else 0, "x",
                pa.array([v * 2 for v in b.column("x").to_pylist()]))

    df = make_df(9, parts=3).select("x").mapStream(stream_fn)
    assert df.columns == ["x"]  # schema probe ran the stream op on 1 row
    rows = [r.x for r in df.collect()]
    assert rows == [i * 2 for i in range(9)]
    # ONE stream-fn invocation per materialization (collect), not one per
    # partition — the property the streaming scorer needs to keep its
    # device window alive across partition boundaries.
    assert calls.count("open") >= 1
    calls.clear()
    df.collect()
    assert calls.count("open") == 1
    # length-preserving contract keeps the lazy count/limit fast paths
    assert df.count() == 9
    assert [r.x for r in df.limit(4).collect()] == [0, 2, 4, 6]


def test_package_dataframe_is_the_ports_copy():
    import sparkdl_tpu_torch as sdl
    from sparkdl_tpu_torch.core import frame

    assert sdl.DataFrame is DataFrame is frame.DataFrame
    assert sdl.Row is frame.Row
    with pytest.raises(AttributeError):
        sdl.NotAThing


# --- twins of tests/test_data.py's ArrowDataset tests ------------------------

def test_arrow_skipped_indices_never_converted():
    """Skip-listed indices yield the raw RecordBatch, unconverted: a
    record whose decode is the poison is skippable."""
    from sparkdl_tpu_torch.runner.data import ArrowDataset

    df = DataFrame.fromArrow(
        pa.table({"x": np.arange(12, dtype=np.float32)}), numPartitions=2)

    def convert(rb):
        out = {"x": rb.column("x").to_numpy(zero_copy_only=False)}
        if out["x"][0] == 4.0:  # batch index 1 is the poison
            raise RuntimeError("decode poison")
        return out

    poisoned = ArrowDataset(df, batch_size=4, convert=convert)
    with pytest.raises(RuntimeError, match="decode poison"):
        list(poisoned.indexed())
    skipping = ArrowDataset(df, batch_size=4, convert=convert,
                            skip_list=[1])
    got = [b["x"][0] for _, b in skipping.indexed()]
    assert got == [0.0, 8.0]  # batch 1 skipped without decoding


def test_arrow_dataset_round_trip():
    from sparkdl_tpu_torch.runner.data import (ArrowDataset, as_dataset,
                                               record_batch_to_numpy)

    df = DataFrame.fromArrow(
        pa.table({"x": np.arange(10, dtype=np.float32),
                  "label": np.arange(10) % 3}), numPartitions=3)
    ds = ArrowDataset(df, batch_size=4)
    assert as_dataset(ds) is ds
    got = list(ds.indexed())
    assert [len(b["x"]) for _, b in got] == [4, 4, 2]
    np.testing.assert_array_equal(got[1][1]["x"],
                                  np.arange(4, 8, dtype=np.float32))
    # restore replays the tail exactly
    ds2 = ArrowDataset(df, batch_size=4)
    ds2.restore(got[0][0])
    np.testing.assert_array_equal(
        next(ds2.indexed())[1]["x"], got[1][1]["x"])
    # a rectangular list column converts to a 2-D array
    nested = DataFrame.fromPydict({"ids": [[1, 2], [3, 4], [5, 6]]})
    rb = next(nested.iterBatches(3))
    assert record_batch_to_numpy(rb)["ids"].shape == (3, 2)
