"""The port's Data library (``ray_tpu_torch.data``) on the CPU, against the
JAX package's.

Every case of ``tests/test_data.py``, one for one, on one port runtime for
the module (``init(num_cpus=4)``, no GPU).  Where the JAX test asserts a
value, the case here asserts the same value.  Where the result is data
(a seeded shuffle, sort, groupby and aggregates, ``random_sample``,
``train_test_split``, ``split``, ``streaming_split``, a local shuffle, the
file round trips), the same pipeline (``PIPELINES``) also runs on the JAX
package's own runtime, in one child process for the module that writes its
results as ``.npz``, so the two runtimes never share a process; the port's
rows must equal them.  ``iter_jax_batches`` becomes ``iter_torch_batches``
against the JAX package's ``iter_jax_batches``, value for value.  Three
cases of the card path beyond the JAX file: a read-only column (an
Arrow-backed block's) becomes a tensor of its own, and ``read_numpy`` shards
widened by ``map_batches`` reach each of two ``streaming_split(equal=True)``
consumers whole, in order; and ``import ray_tpu_torch.data`` needs
neither pyarrow nor pandas.

This file imports neither JAX nor the JAX package at module level: the
child process and the port's workers import it.
"""

import os
import signal
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data import (ActorPoolStrategy, Count, Max, Mean, Min,
                                Std, Sum)

HERE = os.path.dirname(os.path.abspath(__file__))


# ------------------------------------------------ pipelines run on both
def _ids(rows, key="id"):
    return np.asarray([r[key] for r in rows])


def _p_shuffle_sort(rd):
    sh = rd.range(200, parallelism=4).random_shuffle(seed=7)
    return {"shuffled": _ids(sh.take_all()),
            "sorted": _ids(sh.sort("id").take_all()),
            "desc": _ids(sh.sort("id", descending=True).take_all())}


def _p_groupby(rd):
    ds = rd.from_items([{"k": i % 3, "v": float(i)} for i in range(30)])
    rows = sorted(ds.groupby("k").sum("v").take_all(), key=lambda r: r["k"])
    return {"k": _ids(rows, "k"), "sum": _ids(rows, "sum(v)"),
            "aggs": np.asarray([ds.sum("v"), ds.min("v"), ds.max("v"),
                                ds.mean("v"), ds.std("v")]),
            "global": np.asarray(list(ds.aggregate(
                Count(), Sum("v"), Min("v"), Max("v"), Mean("v"),
                Std("v")).values()))}


def _p_map_groups(rd):
    ds = rd.from_items([{"k": i % 2, "v": i} for i in range(10)])
    out = ds.groupby("k").map_groups(
        lambda g: {"k": g["k"][:1], "total": np.asarray([g["v"].sum()])})
    rows = sorted(out.take_all(), key=lambda r: r["k"])
    return {"k": _ids(rows, "k"), "total": _ids(rows, "total")}


def _p_limit_union_zip(rd):
    z = rd.range(10).zip(rd.range(10).map(lambda r: {"b": r["id"] * 2}))
    rows = z.sort("id").take_all()
    return {"limit": _ids(rd.range(1000, parallelism=10).limit(13)
                          .take_all()),
            "union": _ids(rd.range(10).union(rd.range(5)).take_all()),
            "zip_id": _ids(rows), "zip_b": _ids(rows, "b")}


def _p_local_shuffle(rd):
    ds = rd.range(100, parallelism=7)
    seen = []
    for b in ds.iter_batches(batch_size=10, local_shuffle_buffer_size=50,
                             local_shuffle_seed=3):
        seen.extend(b["id"].tolist())
    return {"ids": np.asarray(seen)}


def _consume(its, batch_size):
    got = []
    for it in its:
        ids = []
        for b in it.iter_batches(batch_size=batch_size, drop_last=False):
            ids.extend(b["id"].tolist())
        got.append(np.asarray(ids))
    return got


def _p_split(rd):
    ds = rd.range(90, parallelism=5)
    parts = ds.split(3)
    out = {f"part{i}": _ids(p.take_all()) for i, p in enumerate(parts)}
    its = ds.streaming_split(2)
    for epoch in range(2):
        for i, ids in enumerate(_consume(its, 8)):
            out[f"stream{epoch}_{i}"] = ids
    return out


def _p_split_equal(rd):
    its = rd.range(90, parallelism=5).streaming_split(2, equal=True)
    out = {}
    for epoch in range(2):
        for i, ids in enumerate(_consume(its, 9)):
            out[f"equal{epoch}_{i}"] = ids
    return out


def _p_sample_split(rd):
    train, test = rd.range(100).train_test_split(test_size=0.25)
    return {"sample": _ids(rd.range(1000).random_sample(0.1, seed=0)
                           .take_all()),
            "sample8": _ids(rd.range(2000, parallelism=8)
                            .random_sample(0.5, seed=7).take_all()),
            "train": _ids(train.take_all()), "test": _ids(test.take_all()),
            "unique": np.asarray(rd.from_items(
                [{"k": i % 4} for i in range(40)]).unique("k"))}


def _p_string_groupby(rd):
    rows = [{"k": ["a", "b", "c"][i % 3], "v": float(i)} for i in range(30)]
    out = {r["k"]: r["sum(v)"]
           for r in rd.from_items(rows).groupby("k").sum("v").take_all()}
    return {"sums": np.asarray([out[k] for k in "abc"])}


def _p_files(rd, root):
    ds = rd.from_items([{"a": i, "b": f"s{i}"} for i in range(25)])
    out = {}
    for fmt in ("parquet", "csv", "json"):
        d = os.path.join(root, fmt)
        getattr(ds, f"write_{fmt}")(d)
        rows = sorted(getattr(rd, f"read_{fmt}")(d).take_all(),
                      key=lambda r: r["a"])
        out[f"{fmt}_a"] = _ids(rows, "a")
        out[f"{fmt}_b"] = np.asarray([r["b"] for r in rows])
    return out


PIPELINES = {"shuffle_sort": _p_shuffle_sort, "groupby": _p_groupby,
             "map_groups": _p_map_groups,
             "limit_union_zip": _p_limit_union_zip,
             "local_shuffle": _p_local_shuffle, "split": _p_split,
             "split_equal": _p_split_equal, "sample_split": _p_sample_split,
             "string_groupby": _p_string_groupby}


def _jax_reference(out_dir):
    """The child process: every pipeline on the JAX package's runtime, one
    ``.npz`` each, and ``iter_jax_batches``' values."""
    import ray_tpu
    from ray_tpu import data as jrd

    ray_tpu.init(num_cpus=4, object_store_memory=256 * 1024 ** 2)
    try:
        for name, fn in PIPELINES.items():
            np.savez(os.path.join(out_dir, name + ".npz"), **fn(jrd))
        np.savez(os.path.join(out_dir, "files.npz"),
                 **_p_files(jrd, os.path.join(out_dir, "files")))
        batches = list(jrd.range(64).iter_jax_batches(batch_size=16))
        np.savez(os.path.join(out_dir, "jax_batches.npz"),
                 ids=np.stack([np.asarray(b["id"]) for b in batches]))
    finally:
        ray_tpu.shutdown()


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def jax_child(tmp_path_factory):
    """The JAX package's results, computed in a child process that starts
    with the module and runs beside the port's cases."""
    out = tmp_path_factory.mktemp("jax_data")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(HERE), HERE,
                    os.environ.get("PYTHONPATH", "")]))
    # a session of its own: a child killed at its deadline takes its
    # runtime's processes with it
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, test_torch_data as t; t._jax_reference(sys.argv[1])",
         str(out)], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, start_new_session=True)
    state = {}

    def finish():
        if "rc" not in state:
            try:
                log, _ = proc.communicate(timeout=180)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                log, _ = proc.communicate()
            state["rc"], state["log"] = proc.returncode, log.decode()[-4000:]

    def result(name):
        finish()
        assert state["rc"] == 0, state["log"]
        return dict(np.load(os.path.join(out, name + ".npz")))

    yield result
    finish()  # the child shuts its runtime down itself


@pytest.fixture(scope="module")
def cluster(jax_child):
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=256 * 1024 ** 2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      err_msg=k)


# ================================================================= cases
def test_range_count_schema(cluster):
    ds = rd.range(100)
    assert ds.count() == 100
    assert ds.schema() == {"id": "int64"}
    assert ds.take(3) == [{"id": 0}, {"id": 1}, {"id": 2}]


def test_from_items_map_filter_fusion(cluster):
    ds = (rd.from_items([{"x": i} for i in range(50)])
          .map(lambda r: {"x": r["x"] * 2})
          .filter(lambda r: r["x"] % 4 == 0))
    from ray_tpu_torch.data._logical import MapOp, optimize, plan_to_list

    chain = plan_to_list(optimize(ds._plan))
    assert sum(isinstance(op, MapOp) for op in chain) == 1
    vals = sorted(r["x"] for r in ds.take_all())
    assert vals == [i * 2 for i in range(50) if (i * 2) % 4 == 0]


def test_map_batches_formats(cluster):
    ds = rd.range(20)
    out = ds.map_batches(lambda b: {"y": b["id"] + 1}, batch_size=7)
    assert sorted(r["y"] for r in out.take_all()) == list(range(1, 21))

    def pdf(df):
        df["z"] = df["id"] * 10
        return df

    out2 = ds.map_batches(pdf, batch_format="pandas")
    assert sorted(r["z"] for r in out2.take_all()) == \
        [i * 10 for i in range(20)]


def test_map_batches_actor_pool(cluster):
    class AddState:
        def __init__(self, inc):
            self.inc = inc

        def __call__(self, batch):
            return {"v": batch["id"] + self.inc}

    ds = rd.range(40).map_batches(
        AddState, compute=ActorPoolStrategy(size=2),
        fn_constructor_args=(100,))
    assert sorted(r["v"] for r in ds.take_all()) == \
        [i + 100 for i in range(40)]


def test_flat_map_add_drop_select(cluster):
    ds = rd.from_items([{"a": 1, "b": 2}, {"a": 3, "b": 4}])
    flat = ds.flat_map(lambda r: [{"a": r["a"]}, {"a": r["a"] + 10}])
    assert sorted(r["a"] for r in flat.take_all()) == [1, 3, 11, 13]
    added = ds.add_column("c", lambda b: b["a"] + b["b"])
    assert sorted(r["c"] for r in added.take_all()) == [3, 7]
    assert added.select_columns(["c"]).columns() == ["c"]
    assert set(added.drop_columns(["b"]).columns()) == {"a", "c"}


def test_repartition_and_num_blocks(cluster):
    ds = rd.range(100, parallelism=10)
    r = ds.repartition(3)
    assert r.num_blocks() == 3
    assert r.count() == 100
    assert [row["id"] for row in r.take_all()] == list(range(100))


def test_random_shuffle_and_sort(cluster, jax_child):
    got = _p_shuffle_sort(rd)
    vals = got["shuffled"].tolist()
    assert vals != list(range(200))
    assert sorted(vals) == list(range(200))
    assert got["sorted"].tolist() == list(range(200))
    assert got["desc"].tolist() == list(range(199, -1, -1))
    _assert_same(got, jax_child("shuffle_sort"))


def test_groupby_aggregate(cluster, jax_child):
    got = _p_groupby(rd)
    for k, s in zip(got["k"], got["sum"]):
        assert s == sum(i for i in range(30) if i % 3 == k)
    total, lo, hi, mean, std = got["aggs"]
    assert total == sum(float(i) for i in range(30))
    assert lo == 0.0 and hi == 29.0
    assert abs(mean - 14.5) < 1e-9
    assert abs(std - np.std(np.arange(30.0), ddof=1)) < 1e-9
    _assert_same(got, jax_child("groupby"))


def test_map_groups(cluster, jax_child):
    got = _p_map_groups(rd)
    assert dict(zip(got["k"].tolist(), got["total"].tolist())) == \
        {0: 0 + 2 + 4 + 6 + 8, 1: 1 + 3 + 5 + 7 + 9}
    _assert_same(got, jax_child("map_groups"))


def test_limit_union_zip(cluster, jax_child):
    got = _p_limit_union_zip(rd)
    assert rd.range(1000, parallelism=10).limit(13).count() == 13
    assert rd.range(10).union(rd.range(5)).count() == 15
    assert (got["zip_b"] == got["zip_id"] * 2).all()
    _assert_same(got, jax_child("limit_union_zip"))


def test_limit_spanning_streamed_blocks(cluster):
    ds = rd.range(200, parallelism=5).limit(100)  # 40-row blocks
    rows = ds.take_all()
    assert len(rows) == 100
    assert [r["id"] for r in rows] == list(range(100))
    assert rd.range(200, parallelism=5).limit(100).count() == 100


def test_iter_batches_exact_sizes(cluster, jax_child):
    ds = rd.range(100, parallelism=7)
    sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=32)]
    assert sizes == [32, 32, 32, 4]
    sizes = [len(b["id"])
             for b in ds.iter_batches(batch_size=32, drop_last=True)]
    assert sizes == [32, 32, 32]
    got = _p_local_shuffle(rd)
    assert sorted(got["ids"].tolist()) == list(range(100))
    _assert_same(got, jax_child("local_shuffle"))


def test_split_and_streaming_split(cluster, jax_child):
    got = _p_split(rd)
    parts = [got[f"part{i}"] for i in range(3)]
    assert sum(len(p) for p in parts) == 90
    assert sorted(np.concatenate(parts).tolist()) == list(range(90))
    for epoch in range(2):
        a, b = got[f"stream{epoch}_0"], got[f"stream{epoch}_1"]
        assert sorted(np.concatenate([a, b]).tolist()) == list(range(90))
        assert len(a) and len(b)
    _assert_same(got, jax_child("split"))


def test_file_roundtrip(tmp_path, cluster, jax_child):
    got = _p_files(rd, str(tmp_path))
    for fmt in ("parquet", "csv", "json"):
        assert got[f"{fmt}_a"].tolist() == list(range(25))
        assert sorted(got[f"{fmt}_b"].tolist()) == \
            sorted(f"s{i}" for i in range(25))
    _assert_same(got, jax_child("files"))


def test_from_numpy_pandas_arrow(cluster):
    import pandas as pd
    import pyarrow as pa

    ds = rd.from_numpy(np.arange(12).reshape(12))
    assert ds.count() == 12
    ds = rd.from_pandas(pd.DataFrame({"x": [1, 2, 3]}))
    assert [r["x"] for r in ds.take_all()] == [1, 2, 3]
    ds = rd.from_arrow(pa.table({"y": [4, 5]}))
    assert [r["y"] for r in ds.take_all()] == [4, 5]
    df = rd.range(5).to_pandas()
    assert list(df["id"]) == list(range(5))


def test_iter_torch_batches_match_the_jax_iter_jax_batches(cluster,
                                                           jax_child):
    """``tests/test_data.py::test_iter_jax_batches``: the port's device
    hand-off is ``iter_torch_batches(device=...)``."""
    batches = list(rd.range(64).iter_torch_batches(
        batch_size=16, drop_last=True, device="cpu"))
    assert len(batches) == 4
    assert all(isinstance(b["id"], torch.Tensor)
               and b["id"].device.type == "cpu" for b in batches)
    assert sum(int(b["id"].sum()) for b in batches) == sum(range(64))
    np.testing.assert_array_equal(
        np.stack([b["id"].numpy() for b in batches]),
        jax_child("jax_batches")["ids"])
    assert not hasattr(rd.Dataset, "iter_jax_batches")


def test_unique_random_sample_train_test_split(cluster, jax_child):
    got = _p_sample_split(rd)
    assert got["unique"].tolist() == [0, 1, 2, 3]
    assert 40 < len(got["sample"]) < 200
    assert len(got["train"]) == 75 and len(got["test"]) == 25
    _assert_same(got, jax_child("sample_split"))


def test_streaming_split_equal(cluster, jax_child):
    got = _p_split_equal(rd)
    a, b = got["equal0_0"], got["equal0_1"]
    assert len(a) == 45 and len(b) == 45, (len(a), len(b))
    assert len(set(a.tolist()) | set(b.tolist())) == 90
    assert [len(got["equal1_0"]), len(got["equal1_1"])] == [45, 45]
    _assert_same(got, jax_child("split_equal"))


def test_groupby_string_keys(cluster, jax_child):
    got = _p_string_groupby(rd)
    for j, s in enumerate(got["sums"]):
        assert s == sum(float(i) for i in range(30) if i % 3 == j)
    _assert_same(got, jax_child("string_groupby"))


def test_random_sample_not_position_correlated(cluster, jax_child):
    kept = sorted(_p_sample_split(rd)["sample8"].tolist())
    period = 2000 // 8
    positions = {k % period for k in kept}
    assert len(positions) > period * 0.9, len(positions)
    np.testing.assert_array_equal(kept, jax_child("sample_split")["sample8"])


def test_sort_all_empty_blocks(cluster):
    ds = rd.range(40, parallelism=4).filter(lambda r: False)
    assert ds.sort("id").take_all() == []
    assert ds.count() == 0


def test_parquet_stays_arrow_end_to_end(cluster, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"x": list(range(100)),
                             "s": [f"r{i}" for i in range(100)]}), path)
    ds = rd.read_parquet(path)

    def double(t):
        assert isinstance(t, pa.Table), f"expected Arrow, got {type(t)}"
        return t.set_column(t.schema.get_field_index("x"), "x",
                            pa.chunked_array([[v * 2 for v in
                                               t.column("x").to_pylist()]]))

    out = ds.map_batches(double, batch_format="pyarrow")
    batches = list(out.iter_batches(batch_size=None,
                                    batch_format="pyarrow"))
    assert all(isinstance(b, pa.Table) for b in batches)
    vals = [v for b in batches for v in b.column("x").to_pylist()]
    assert sorted(vals) == [i * 2 for i in range(100)]
    assert ds.schema()["s"] == "string"


def test_arrow_concat_schema_mismatch_is_loud(cluster):
    import pyarrow as pa

    from ray_tpu_torch.data.block import BlockAccessor

    a = pa.table({"x": [1, 2]})
    b = pa.table({"x": [1.5]})
    with pytest.raises(ValueError, match="mismatched"):
        BlockAccessor.concat([a, b])


def test_memory_budget_backpressure(cluster):
    from ray_tpu_torch.data._executor import DataContext

    ctx = DataContext.get_current()
    old = ctx.max_buffered_bytes
    ctx.max_buffered_bytes = 4 * 1024 * 1024  # 4 MB budget
    try:
        ds = rd.range(16 * 262_144, parallelism=16).map_batches(
            lambda b: {"x": b["id"].astype(np.float64)})
        it = ds.iter_batches(batch_size=None)
        peaks = []
        rows = 0
        for b in it:
            rows += len(b["x"])
            peaks.append(ds._last_executor._buffered_bytes())
        assert rows == 16 * 262_144
        slack = 8 * 1024 * 1024
        assert max(peaks) <= ctx.max_buffered_bytes + slack, max(peaks)
    finally:
        ctx.max_buffered_bytes = old


def test_pandas_native_blocks(cluster):
    import pandas as pd

    from ray_tpu_torch.data.block import BlockAccessor, is_pandas_block

    df = pd.DataFrame({"x": range(20), "tag": [f"t{i%3}" for i in range(20)]})
    ds = rd.from_pandas(df)

    def double(batch):
        assert isinstance(batch, pd.DataFrame), type(batch)
        out = batch.copy()
        out["x"] = out["x"] * 2
        return out

    out = ds.map_batches(double, batch_format="pandas") \
            .filter(lambda r: r["x"] % 4 == 0)
    rows = out.take_all()
    assert [r["x"] for r in rows] == [i * 2 for i in range(20) if i % 2 == 0]

    blk = df
    assert is_pandas_block(blk)
    assert BlockAccessor.num_rows(blk) == 20
    assert BlockAccessor.size_bytes(blk) > 0
    assert BlockAccessor.schema(blk)["x"].startswith("int")
    sl = BlockAccessor.slice(blk, 5, 10)
    assert is_pandas_block(sl) and len(sl) == 5
    cat = BlockAccessor.concat([sl, sl])
    assert is_pandas_block(cat) and len(cat) == 10
    sel = BlockAccessor.select(blk, ["tag"])
    assert list(sel.columns) == ["tag"]
    agg = rd.from_pandas(df).groupby("tag").count().take_all()
    assert sorted(r["count()"] for r in agg) == [6, 7, 7]
    assert BlockAccessor.to_pandas(blk) is blk

    def assign(batch):
        batch = batch.copy()
        batch["y"] = pd.Series(range(len(batch)))
        assert not batch["y"].isna().any(), batch.index
        return batch

    rows = rd.from_pandas(df) \
        .map_batches(assign, batch_size=6, batch_format="pandas").take_all()
    assert all(r["y"] is not None and r["y"] == r["y"] for r in rows)


def test_iter_torch_batches(cluster):
    ds = rd.range(100).map(lambda r: {"id": r["id"],
                                      "x": float(r["id"]) * 0.5})
    seen = 0
    for batch in ds.iter_torch_batches(batch_size=32,
                                       dtypes={"x": torch.float32}):
        assert isinstance(batch["id"], torch.Tensor)
        assert batch["x"].dtype == torch.float32
        torch.testing.assert_close(batch["x"],
                                   batch["id"].to(torch.float32) * 0.5)
        seen += len(batch["id"])
    assert seen == 100


# ============================================================ card path
def test_read_only_column_becomes_a_tensor_of_its_own(cluster):
    """An Arrow-backed block's numpy columns are read-only views of the
    Arrow buffers: their tensor is a copy (no warning, no aliasing), so a
    write in the loop cannot reach the block.  A writeable column passes
    zero-copy, as ``iter_batches`` hands it out."""
    import pyarrow as pa

    table = pa.table({"x": np.arange(8, dtype=np.int64)})
    it = rd.DataIterator(lambda: iter([table]))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        (batch,) = it.iter_torch_batches(batch_size=None)
    batch["x"].add_(1)
    assert table.column("x").to_pylist() == list(range(8))
    assert batch["x"].tolist() == list(range(1, 9))
    block = {"x": np.arange(8, dtype=np.int64)}
    (batch,) = rd.DataIterator(lambda: iter([block])).iter_torch_batches(
        batch_size=None)
    assert batch["x"].data_ptr() == block["x"].ctypes.data


def _widen(batch):
    return {"input_ids": batch["data"][:, 0].astype(np.int64),
            "targets": batch["data"][:, 1].astype(np.int64)}


def test_numpy_shards_reach_split_consumers_whole(cluster, tmp_path):
    """The card path's pipeline at a small size: int32 (2, S) rows written
    as ``.npy`` shards by ``write_numpy``, read back by ``read_numpy``,
    split into int64 ``input_ids`` / ``targets`` by ``map_batches``, and
    dealt by ``streaming_split(equal=True)``: every batch is one shard,
    whole and in order."""
    rng = np.random.default_rng(0)
    shards = [rng.integers(0, 512, (4, 2, 16)).astype(np.int32)
              for _ in range(4)]
    rd.from_numpy(shards).write_numpy(str(tmp_path), column="data")
    assert len(os.listdir(tmp_path)) == 4
    ds = rd.read_numpy(str(tmp_path)).map_batches(_widen,
                                                  batch_format="numpy")
    its = ds.streaming_split(2, equal=True)
    seen = []
    for it in its:
        for b in it.iter_torch_batches(batch_size=4, drop_last=True,
                                       device="cpu"):
            assert b["input_ids"].dtype == torch.int64
            seen.append((b["input_ids"].numpy(), b["targets"].numpy()))
    assert len(seen) == 4
    got = sorted(seen, key=lambda p: p[0].tobytes())
    want = sorted(((s[:, 0].astype(np.int64), s[:, 1].astype(np.int64))
                   for s in shards), key=lambda p: p[0].tobytes())
    for (gi, gt), (wi, wt) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)


def test_import_needs_neither_pyarrow_nor_pandas():
    """The card machine has neither: ``import ray_tpu_torch.data`` (and
    Tune and offline RL over it) must not import them."""
    code = ("import sys\n"
            "sys.modules['pandas'] = None\n"
            "sys.modules['pyarrow'] = None\n"
            "import ray_tpu_torch.data, ray_tpu_torch.tune\n"
            "from ray_tpu_torch.rllib import BCConfig, MARWILConfig\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.dirname(HERE)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
