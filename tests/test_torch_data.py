"""The JAX package's Data tests (tests/test_data.py) on the port's
runtime, and the port's own cases.

Every case of the JAX package's file runs here unchanged but for the
package name: a real cluster of the port's runtime executes every plan,
and the assertions check row-level results. The port's own cases hold
``block._as_array``, the one function of ``data/`` that differs from the
JAX package's: a ``torch.Tensor`` column of any device becomes host numpy,
bf16 as float32 with exact values; a ``map_batches`` function may return
such a column; and the numpy-block path runs in a process where pyarrow
and pandas cannot be imported, with workers that cannot import them
either.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data import block as B
from torch_runtime_util import start_cluster, stop_cluster

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=4)
    yield info
    stop_cluster(info)


def test_range_count_take(cluster):
    ds = rd.range(100, parallelism=5)
    assert ds.count() == 100
    rows = ds.take(3)
    assert [r["id"] for r in rows] == [0, 1, 2]


def test_map_batches_and_filter_fused(cluster):
    ds = (
        rd.range(50, parallelism=4)
        .map_batches(lambda b: {"id": b["id"], "sq": b["id"] ** 2})
        .filter(lambda r: r["sq"] % 2 == 0)
    )
    rows = ds.take_all()
    assert len(rows) == 25
    assert all(r["sq"] == r["id"] ** 2 and r["sq"] % 2 == 0 for r in rows)


def test_map_and_flat_map(cluster):
    ds = rd.from_items([1, 2, 3], parallelism=2).map(lambda r: {"v": r["item"] * 10})
    assert sorted(r["v"] for r in ds.take_all()) == [10, 20, 30]
    ds2 = rd.from_items([1, 2], parallelism=1).flat_map(
        lambda r: [{"v": r["item"]}, {"v": -r["item"]}]
    )
    assert sorted(r["v"] for r in ds2.take_all()) == [-2, -1, 1, 2]


def test_add_drop_select_columns(cluster):
    ds = rd.range(10, parallelism=2).add_column("double", lambda b: b["id"] * 2)
    assert set(ds.schema().keys()) == {"id", "double"}
    assert ds.select_columns(["double"]).sum("double") == 90
    assert set(ds.drop_columns(["double"]).schema().keys()) == {"id"}


def test_aggregations(cluster):
    ds = rd.range(10, parallelism=3)
    assert ds.sum("id") == 45
    assert ds.min("id") == 0
    assert ds.max("id") == 9
    assert ds.mean("id") == 4.5


def test_repartition(cluster):
    ds = rd.range(100, parallelism=7).repartition(3)
    assert ds.num_blocks() == 3
    assert ds.count() == 100
    assert sorted(r["id"] for r in ds.take_all()) == list(range(100))


def test_random_shuffle(cluster):
    ds = rd.range(60, parallelism=4).random_shuffle(seed=7)
    rows = [r["id"] for r in ds.take_all()]
    assert sorted(rows) == list(range(60))
    assert rows != list(range(60))


def test_sort(cluster):
    rng = np.random.default_rng(0)
    vals = rng.permutation(80)
    ds = rd.from_blocks([{"v": c} for c in np.array_split(vals, 4)]).sort("v")
    out = [r["v"] for r in ds.take_all()]
    assert out == sorted(vals.tolist())
    desc = rd.from_blocks([{"v": c} for c in np.array_split(vals, 4)]).sort(
        "v", descending=True
    )
    assert [r["v"] for r in desc.take_all()] == sorted(vals.tolist(), reverse=True)


def test_groupby(cluster):
    ds = rd.from_items(
        [{"k": i % 3, "v": i} for i in range(30)], parallelism=4
    )
    out = {r["k"]: r["sum(v)"] for r in ds.groupby("k").sum("v").take_all()}
    expect = {}
    for i in range(30):
        expect[i % 3] = expect.get(i % 3, 0) + i
    assert out == expect
    cnt = {r["k"]: r["count"] for r in ds.groupby("k").count().take_all()}
    assert cnt == {0: 10, 1: 10, 2: 10}


def test_groupby_string_keys(cluster):
    # String keys must hash identically across worker processes (builtin
    # hash() is per-process randomized).
    ds = rd.from_items(
        [{"k": ["a", "b", "c"][i % 3], "v": 1} for i in range(30)],
        parallelism=5,
    )
    out = {r["k"]: r["sum(v)"] for r in ds.groupby("k").sum("v").take_all()}
    assert out == {"a": 10, "b": 10, "c": 10}


def test_map_groups(cluster):
    ds = rd.from_items([{"k": i % 2, "v": i} for i in range(10)], parallelism=2)
    out = ds.groupby("k").map_groups(
        lambda b: {"k": b["k"][:1], "vmax": [b["v"].max()]}
    )
    got = {r["k"]: r["vmax"] for r in out.take_all()}
    assert got == {0: 8, 1: 9}


def test_union_zip_limit(cluster):
    a = rd.range(10, parallelism=2)
    b = rd.range(10, parallelism=2).map_batches(lambda blk: {"id": blk["id"] + 10})
    assert a.union(b).count() == 20
    z = rd.range(6, parallelism=2).zip(
        rd.range(6, parallelism=3).map_batches(lambda blk: {"w": blk["id"] * 2})
    )
    rows = z.take_all()
    assert all(r["w"] == 2 * r["id"] for r in rows) and len(rows) == 6
    assert a.limit(4).count() == 4


def test_iter_batches_and_local_shuffle(cluster):
    ds = rd.range(100, parallelism=5)
    batches = list(ds.iter_batches(batch_size=32))
    assert [len(b["id"]) for b in batches] == [32, 32, 32, 4]
    batches = list(ds.iter_batches(batch_size=32, drop_last=True))
    assert [len(b["id"]) for b in batches] == [32, 32, 32]
    shuffled = list(
        ds.iter_batches(batch_size=50, local_shuffle_buffer_size=100,
                        local_shuffle_seed=3)
    )
    all_ids = np.concatenate([b["id"] for b in shuffled])
    assert sorted(all_ids.tolist()) == list(range(100))
    assert all_ids.tolist() != list(range(100))


def test_actor_compute_map_batches(cluster):
    class AddOffset:
        def __init__(self, offset):
            self.offset = offset

        def __call__(self, batch):
            return {"id": batch["id"] + self.offset}

    ds = rd.range(20, parallelism=4).map_batches(
        AddOffset, fn_constructor_args=(100,), concurrency=2
    )
    assert sorted(r["id"] for r in ds.take_all()) == list(range(100, 120))


def test_split_for_train(cluster):
    shards = rd.range(40, parallelism=4).split(4)
    counts = [s.count() for s in shards]
    assert sum(counts) == 40
    assert all(c == 10 for c in counts)


def test_read_write_parquet(cluster, tmp_path):
    path = str(tmp_path / "pq")
    rd.range(30, parallelism=3).write_parquet(path)
    back = rd.read_parquet(path)
    assert back.count() == 30
    assert sorted(r["id"] for r in back.take_all()) == list(range(30))


def test_read_csv_json_text(cluster, tmp_path):
    csv = tmp_path / "t.csv"
    csv.write_text("a,b\n1,2\n3,4\n")
    ds = rd.read_csv(str(csv))
    assert ds.take_all() == [{"a": 1, "b": 2}, {"a": 3, "b": 4}]
    jf = tmp_path / "t.jsonl"
    jf.write_text('{"x": 1}\n{"x": 2}\n')
    assert rd.read_json(str(jf)).sum("x") == 3
    tf = tmp_path / "t.txt"
    tf.write_text("hello\nworld\n")
    assert [r["text"] for r in rd.read_text(str(tf)).take_all()] == ["hello", "world"]


def test_from_pandas_roundtrip(cluster):
    import pandas as pd

    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    ds = rd.from_pandas(df)
    out = ds.to_pandas()
    assert list(out["a"]) == [1, 2, 3]
    assert list(out["b"]) == ["x", "y", "z"]


# ---------------------------------------------------------------- join
def test_inner_join(cluster):
    import ray_tpu_torch.data as rd

    left = rd.from_items(
        [{"id": i, "x": float(i)} for i in range(8)]
    ).repartition(3)
    right = rd.from_items(
        [{"id": i, "y": i * 10} for i in range(4, 12)]
    ).repartition(2)
    rows = sorted(
        left.join(right, on="id").take_all(), key=lambda r: r["id"]
    )
    assert [r["id"] for r in rows] == [4, 5, 6, 7]
    assert all(r["y"] == r["id"] * 10 and r["x"] == float(r["id"]) for r in rows)


def test_left_and_outer_join_fill(cluster):
    import numpy as np

    import ray_tpu_torch.data as rd

    left = rd.from_items([{"id": 1, "x": 1.0}, {"id": 2, "x": 2.0}])
    right = rd.from_items([{"id": 2, "y": 20}, {"id": 3, "y": 30}])

    lrows = sorted(
        left.join(right, on="id", how="left").take_all(),
        key=lambda r: r["id"],
    )
    assert [r["id"] for r in lrows] == [1, 2]
    assert np.isnan(lrows[0]["y"]) and lrows[1]["y"] == 20

    orows = sorted(
        left.join(right, on="id", how="outer").take_all(),
        key=lambda r: r["id"],
    )
    assert [r["id"] for r in orows] == [1, 2, 3]
    assert np.isnan(orows[2]["x"]) and orows[2]["y"] == 30


def test_join_suffixes_overlapping_columns(cluster):
    import ray_tpu_torch.data as rd

    left = rd.from_items([{"id": 1, "v": "L"}])
    right = rd.from_items([{"id": 1, "v": "R"}])
    rows = left.join(right, on="id").take_all()
    assert rows[0]["v"] == "L" and rows[0]["v_r"] == "R"


def test_join_duplicate_keys_cross_product(cluster):
    import ray_tpu_torch.data as rd

    left = rd.from_items([{"id": 1, "x": a} for a in (0, 1)])
    right = rd.from_items([{"id": 1, "y": b} for b in (0, 1, 2)])
    rows = left.join(right, on="id").take_all()
    assert len(rows) == 6  # 2 x 3 matches


def test_outer_join_one_sided_partitions(cluster):
    """Partitions receiving rows from only ONE side still emit (and
    null-fill) the other side's columns."""
    import numpy as np

    import ray_tpu_torch.data as rd

    left = rd.from_items([{"id": 2, "x": 2.0}])
    right = rd.from_items([{"id": 3, "y": 30}])
    rows = sorted(
        left.join(right, on="id", how="outer", num_partitions=4).take_all(),
        key=lambda r: r["id"],
    )
    assert [r["id"] for r in rows] == [2, 3]
    assert rows[0]["x"] == 2.0 and np.isnan(rows[0]["y"])
    assert np.isnan(rows[1]["x"]) and rows[1]["y"] == 30


# ------------------------------------------------- the port's own cases
@pytest.mark.parametrize("dtype,want", [
    (torch.float32, np.float32),
    (torch.int64, np.int64),
    (torch.bfloat16, np.float32),
])
def test_as_array_takes_a_tensor(dtype, want):
    """A CPU tensor column becomes host numpy with its exact values; bf16,
    which numpy lacks, becomes float32. A tensor that needs grad is
    detached."""
    values = np.random.default_rng(0).standard_normal((5, 3)) * 100
    t = torch.tensor(values).to(dtype)
    if dtype.is_floating_point:
        t.requires_grad_(True)
    out = B._as_array(t)
    assert isinstance(out, np.ndarray)
    assert out.dtype == want and out.shape == (5, 3)
    np.testing.assert_array_equal(out, t.detach().double().numpy())
    # The batch a map function returns reaches _as_array per column.
    blk = B.from_batch({"t": t, "n": [1, 2, 3, 4, 5]})
    assert blk["t"].dtype == want
    np.testing.assert_array_equal(blk["n"], np.arange(1, 6))


def test_ragged_rows_become_an_object_column(cluster):
    """Token lists of several lengths (batch inference's prompts) make an
    object column, one list per row, as the block module says; numpy >=
    1.24 refuses them in np.asarray. Lists and mixed values keep the JAX
    package's path."""
    np.testing.assert_array_equal(B._as_array([1, 2, 3]), [1, 2, 3])
    mixed = B._as_array([{"a": 1}, None])
    assert mixed.dtype == object and mixed[0] == {"a": 1}
    ragged = B._as_array([[1], [2, 3], [4, 5, 6]])
    assert ragged.dtype == object and ragged.shape == (3,)
    assert ragged[2] == [4, 5, 6]
    rows = rd.from_items([{"prompt": list(range(n))} for n in (3, 1, 4)]
                         ).map_batches(lambda b: {
                             "n": np.array([len(p) for p in b["prompt"]])}
                         ).take_all()
    assert [r["n"] for r in rows] == [3, 1, 4]


def test_map_batches_returns_tensor_columns(cluster):
    """A map function on a worker returns tensor columns (a bf16 vector
    and an int64 matrix): the blocks hold numpy, bf16 as float32."""

    def fn(batch):
        ids = torch.from_numpy(batch["id"])
        return {"id": batch["id"],
                "half": (ids.to(torch.bfloat16) * 0.5),
                "grid": ids[:, None] * torch.arange(3)}

    ds = rd.range(40, parallelism=4).map_batches(fn, batch_size=16)
    schema = ds.schema()
    assert schema["half"] == np.float32 and schema["grid"] == np.int64
    rows = sorted(ds.take_all(), key=lambda r: r["id"])
    assert [r["id"] for r in rows] == list(range(40))
    for r in rows:
        assert r["half"] == np.float32(
            torch.tensor(r["id"] * 0.5, dtype=torch.bfloat16).item())
        np.testing.assert_array_equal(r["grid"], r["id"] * np.arange(3))
    # The same column through an actor pool and iter_batches.

    class Scale:
        def __call__(self, batch):
            return {"id": batch["id"],
                    "x": torch.from_numpy(batch["id"]).float() * 2}

    out = rd.range(20, parallelism=2).map_batches(
        Scale, compute="actors", concurrency=1)
    got = np.concatenate([b["x"] for b in out.iter_batches(batch_size=8)])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.sort(got), np.arange(20) * 2.0)


_NO_ARROW = textwrap.dedent('''
    import numpy as np
    for name in ("pyarrow", "pandas"):
        try:
            __import__(name)
        except ImportError:
            continue
        raise SystemExit(f"{name} was importable")
    import ray_tpu_torch
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.data import block as B
    assert B._arrow_mod is None

    @ray_tpu_torch.remote
    def probe():
        from ray_tpu_torch.data import block
        found = []
        for name in ("pyarrow", "pandas"):
            try:
                __import__(name)
                found.append(name)
            except ImportError:
                pass
        return found, block._arrow_mod is None

    class Offset:
        def __call__(self, batch):
            return {"x": batch["x"] + 1000}

    ray_tpu_torch.init(num_cpus=2)
    try:
        assert ray_tpu_torch.get(probe.remote()) == ([], True)
        ds = (rd.from_numpy(np.arange(100), parallelism=4)
              .map_batches(lambda b: {"x": b["data"] * 3})
              .filter(lambda r: r["x"] % 2 == 0)
              .map_batches(Offset, compute="actors", concurrency=1))
        got = np.concatenate([b["x"] for b in ds.iter_batches(batch_size=7)])
        want = np.arange(100)[np.arange(100) % 2 == 0] * 3 + 1000
        assert sorted(got.tolist()) == want.tolist(), got
        print("NO-ARROW OK", len(got))
    finally:
        ray_tpu_torch.shutdown()
''')


def test_numpy_blocks_run_without_pyarrow_or_pandas(tmp_path):
    """from_numpy -> map_batches -> filter -> an actor stage ->
    iter_batches in a process, and workers, where ``import pyarrow`` and
    ``import pandas`` raise ImportError (packages of those names that
    raise stand first on the path)."""
    block = tmp_path / "blocked"
    for name in ("pyarrow", "pandas"):
        (block / name).mkdir(parents=True)
        (block / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked in this test')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(block), str(REPO)] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", _NO_ARROW], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "NO-ARROW OK 50" in proc.stdout
