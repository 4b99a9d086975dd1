"""The JAX package's Arrow-block tests (tests/test_arrow_blocks.py) on
the port's runtime: Arrow tables as blocks, tensor columns round-tripping
numpy and parquet. Every case runs unchanged but for the package name.

The port's own case: the tensor extension type is registered under the
port's name, ``ray_tpu_torch.tensor``, so both packages register theirs
in one process, and a parquet file carries the name of the package that
wrote it.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ray_tpu_torch import data as rd
from ray_tpu_torch.data import block as B
from ray_tpu_torch.data.arrow_block import (
    ArrowTensorArray,
    ArrowTensorType,
    numpy_dict_from_table,
    table_from_numpy_dict,
)
from torch_runtime_util import start_cluster, stop_cluster


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=4)
    yield info
    stop_cluster(info)


# ------------------------------------------------------ tensor extension


def test_tensor_array_roundtrip():
    arr = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
    ta = ArrowTensorArray.from_numpy(arr)
    assert isinstance(ta.type, ArrowTensorType)
    assert ta.type.shape == (2, 3)
    np.testing.assert_array_equal(ta.to_numpy(), arr)


def test_tensor_column_parquet_roundtrip(tmp_path):
    images = np.random.default_rng(0).random((8, 4, 4)).astype(np.float32)
    tbl = table_from_numpy_dict({"id": np.arange(8), "image": images})
    path = tmp_path / "t.parquet"
    pq.write_table(tbl, path)
    back = pq.read_table(path)
    # The registered extension type survives the file round trip.
    assert isinstance(back.column("image").type, ArrowTensorType)
    out = numpy_dict_from_table(back)
    np.testing.assert_array_equal(out["image"], images)
    np.testing.assert_array_equal(out["id"], np.arange(8))


def test_tensor_requires_ndim2():
    with pytest.raises(ValueError, match="ndim"):
        ArrowTensorArray.from_numpy(np.arange(3))


# ----------------------------------------------------- block dispatch


def test_block_ops_on_arrow_table():
    tbl = pa.table({"a": [1, 2, 3, 4], "b": ["w", "x", "y", "z"]})
    assert B.num_rows(tbl) == 4
    assert B.size_bytes(tbl) > 0
    sliced = B.slice_block(tbl, 1, 3)
    assert isinstance(sliced, pa.Table)  # zero-copy Arrow slice
    assert sliced.column("a").to_pylist() == [2, 3]
    taken = B.take_idx(tbl, np.array([3, 0]))
    assert taken.column("b").to_pylist() == ["z", "w"]
    cat = B.concat([tbl, tbl])
    assert isinstance(cat, pa.Table) and B.num_rows(cat) == 8
    rows = list(B.to_rows(sliced))
    assert rows == [{"a": 2, "b": "x"}, {"a": 3, "b": "y"}]


def test_mixed_concat_lands_on_numpy():
    tbl = pa.table({"a": [1, 2]})
    nd = {"a": np.array([3, 4])}
    cat = B.concat([tbl, nd])
    assert isinstance(cat, dict)
    np.testing.assert_array_equal(cat["a"], [1, 2, 3, 4])


# -------------------------------------------------------- pipeline e2e


def test_parquet_scan_stays_arrow(cluster, tmp_path):
    tbl = pa.table({"x": list(range(100)), "y": [f"r{i}" for i in range(100)]})
    pq.write_table(tbl, tmp_path / "p.parquet")

    ds = rd.read_parquet(str(tmp_path / "p.parquet"))
    # The scan's block IS the Arrow table (no eager numpy copy)...
    assert isinstance(next(ds.iter_blocks()), pa.Table)

    # ...and pyarrow batch format hands the user a Table (the assert
    # runs inside the worker; a numpy round trip would fail the task).
    def probe(batch):
        assert isinstance(batch, pa.Table), type(batch)
        return batch

    out = ds.map_batches(probe, batch_format="pyarrow").take_all()
    assert len(out) == 100 and out[0] == {"x": 0, "y": "r0"}


def test_arrow_dataset_column_math(cluster, tmp_path):
    """sort/groupby on an Arrow-born dataset normalize at the kernel
    edge and still produce correct results."""
    tbl = pa.table(
        {"k": [1, 2, 1, 2, 1], "v": [10.0, 20.0, 30.0, 40.0, 50.0]}
    )
    pq.write_table(tbl, tmp_path / "g.parquet")
    ds = rd.read_parquet(str(tmp_path / "g.parquet"))

    rows = ds.sort("v", descending=True).take(2)
    assert [r["v"] for r in rows] == [50.0, 40.0]

    agg = {
        r["k"]: r["sum(v)"]
        for r in ds.groupby("k").sum("v").take_all()
    }
    assert agg == {1: 90.0, 2: 60.0}


def test_dataset_to_arrow_with_tensor_column(cluster):
    emb = np.random.default_rng(1).random((6, 3)).astype(np.float32)
    ds = rd.from_blocks([{"id": np.arange(6), "emb": emb}])
    tbl = B.to_arrow(next(ds.iter_blocks()))
    assert isinstance(tbl.column("emb").type, ArrowTensorType)
    back = numpy_dict_from_table(tbl)
    np.testing.assert_array_equal(back["emb"], emb)


def test_to_arrow_and_parquet_write_tensor_roundtrip(cluster, tmp_path):
    """Dataset-level interop: write_parquet preserves tensor columns,
    to_arrow materializes one table."""
    emb = np.random.default_rng(2).random((5, 2, 2)).astype(np.float32)
    ds = rd.from_blocks([{"id": np.arange(5), "emb": emb}])
    ds.write_parquet(str(tmp_path / "out"))

    back = rd.read_parquet(str(tmp_path / "out"))
    tbl = back.to_arrow()
    assert isinstance(tbl.column("emb").type, ArrowTensorType)
    np.testing.assert_array_equal(
        numpy_dict_from_table(tbl)["emb"], emb
    )


def test_tensor_parquet_cross_process(tmp_path):
    """A FRESH process that never imported arrow_block directly must
    still decode tensor columns — registration rides the block module
    import, which every data path touches."""
    import subprocess
    import sys
    import textwrap

    emb = np.random.default_rng(3).random((4, 3)).astype(np.float32)
    tbl = table_from_numpy_dict({"emb": emb})
    pq.write_table(tbl, tmp_path / "x.parquet")

    script = textwrap.dedent(
        f"""
        import numpy as np
        import pyarrow.parquet as pq
        from ray_tpu_torch.data import block as B
        t = pq.read_table({str(tmp_path / 'x.parquet')!r})
        out = B.ensure_numpy(t)
        assert out["emb"].shape == (4, 3), out["emb"].shape
        assert out["emb"].dtype == np.float32, out["emb"].dtype
        print("CROSS-PROCESS OK")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True,
        text=True,
        timeout=120,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "CROSS-PROCESS OK" in proc.stdout


def test_join_over_arrow_scans(cluster, tmp_path):
    """Joins pull blocks straight from scans (Arrow tables) — the
    kernel normalizes at entry."""
    pq.write_table(
        pa.table({"k": [1, 2, 3], "a": [10, 20, 30]}), tmp_path / "l.parquet"
    )
    pq.write_table(
        pa.table({"k": [2, 3, 4], "b": [200, 300, 400]}),
        tmp_path / "r.parquet",
    )
    left = rd.read_parquet(str(tmp_path / "l.parquet"))
    right = rd.read_parquet(str(tmp_path / "r.parquet"))
    rows = sorted(
        left.join(right, on="k").take_all(), key=lambda r: r["k"]
    )
    assert rows == [
        {"k": 2, "a": 20, "b": 200},
        {"k": 3, "a": 30, "b": 300},
    ]


def test_select_drop_on_arrow(cluster, tmp_path):
    tbl = pa.table({"a": [1, 2], "b": [3, 4], "c": [5, 6]})
    pq.write_table(tbl, tmp_path / "s.parquet")
    ds = rd.read_parquet(str(tmp_path / "s.parquet"))
    assert ds.select_columns(["a", "c"]).take(1) == [{"a": 1, "c": 5}]
    assert ds.drop_columns(["b"]).take(1) == [{"a": 1, "c": 5}]


# ------------------------------------------------- the port's own case


def test_both_packages_register_their_tensor_types(tmp_path):
    """Each package registers its own extension name in one process, and
    a file comes back as the type of the package that wrote it, never as
    the other's: the two packages' parquet tensor columns are not
    interchangeable."""
    from ray_tpu.data import arrow_block as jax_arrow

    emb = np.random.default_rng(4).random((3, 2)).astype(np.float32)
    assert ArrowTensorType((2,), pa.float32()).extension_name == (
        "ray_tpu_torch.tensor")
    assert jax_arrow.ArrowTensorType((2,), pa.float32()).extension_name == (
        "ray_tpu.tensor")
    pq.write_table(table_from_numpy_dict({"emb": emb}), tmp_path / "p.parquet")
    pq.write_table(jax_arrow.table_from_numpy_dict({"emb": emb}),
                   tmp_path / "j.parquet")
    port = pq.read_table(tmp_path / "p.parquet").column("emb").type
    jax_type = pq.read_table(tmp_path / "j.parquet").column("emb").type
    assert isinstance(port, ArrowTensorType)
    assert isinstance(jax_type, jax_arrow.ArrowTensorType)
    assert not isinstance(jax_type, ArrowTensorType)
    np.testing.assert_array_equal(
        numpy_dict_from_table(pq.read_table(tmp_path / "p.parquet"))["emb"],
        emb)
