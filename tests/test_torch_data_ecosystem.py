"""The JAX package's Data-ecosystem tests (tests/test_data_ecosystem.py)
on the port's runtime: Delta Lake tables and BigQuery REST reads.

Every Delta and BigQuery case runs unchanged but for the package name and
for the BigQuery transport: the JAX package's tests take
``autoscaler.gcp.RecordedTransport``, which the port does not have, so a
transport that replays a recorded call script the same way is defined
here. The dask-bridge cases wait for ``util/dask_bridge.py``.
"""

import json
import os

import numpy as np
import pytest

import ray_tpu_torch.data as rdata
from torch_runtime_util import start_cluster, stop_cluster


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=8)
    yield info
    stop_cluster(info)


def recorded_transport(script: list[dict]):
    """A transport that replays ``script``: each entry {"method", "url",
    "response", optional "body_contains"}; calls must arrive in order and
    a mismatch raises. The class is made here so that it pickles by
    value: the read task runs it on a worker."""

    class RecordedTransport:
        def __init__(self, script):
            self.script = list(script)
            self._i = 0

        def request(self, method, url, body=None):
            if self._i >= len(self.script):
                raise AssertionError(
                    f"unexpected extra call #{self._i}: {method} {url}")
            expect = self.script[self._i]
            self._i += 1
            if expect["method"] != method or expect["url"] != url:
                raise AssertionError(
                    f"call #{self._i - 1}: got {method} {url}, expected "
                    f"{expect['method']} {expect['url']}")
            for fragment in expect.get("body_contains", ()):
                if fragment not in json.dumps(body or {}):
                    raise AssertionError(
                        f"call #{self._i - 1}: body missing {fragment!r}: "
                        f"{body}")
            return expect["response"]

    return RecordedTransport(script)


# -------------------------------------------------------------- delta
def test_delta_roundtrip(cluster, tmp_path):
    table = str(tmp_path / "tbl")
    ds = rdata.from_items(
        [{"x": i, "y": float(i) * 0.5} for i in range(100)]
    )
    from ray_tpu_torch.data.delta import write_delta

    write_delta(ds, table)
    assert os.path.exists(
        os.path.join(table, "_delta_log", "0" * 20 + ".json")
    )
    back = rdata.read_delta(table)
    rows = sorted(back.take_all(), key=lambda r: r["x"])
    assert len(rows) == 100
    assert rows[7] == {"x": 7, "y": 3.5}
    # Column pruning.
    only_x = rdata.read_delta(table, columns=["x"]).take(3)
    assert set(only_x[0]) == {"x"}


def test_delta_partitioned_roundtrip(cluster, tmp_path):
    table = str(tmp_path / "ptbl")
    ds = rdata.from_items(
        [{"k": i % 3, "v": i} for i in range(30)]
    )
    from ray_tpu_torch.data.delta import write_delta

    write_delta(ds, table, partition_by="k")
    # Hive-style layout on disk.
    assert any(
        d.startswith("k=") for d in os.listdir(table)
        if os.path.isdir(os.path.join(table, d))
    )
    back = rdata.read_delta(table)
    rows = back.take_all()
    assert len(rows) == 30
    # Partition values came back as typed columns.
    assert {r["k"] for r in rows} == {0, 1, 2}
    assert all(isinstance(r["k"], (int, np.integer)) for r in rows)
    got = sorted((r["k"], r["v"]) for r in rows)
    assert got == sorted((i % 3, i) for i in range(30))


def test_delta_log_replay_applies_removes(cluster, tmp_path):
    """A later commit's remove action must drop the file from the
    active set — the transaction-log replay rule."""
    table = str(tmp_path / "rmtbl")
    ds = rdata.from_items([{"x": i} for i in range(10)])
    from ray_tpu_torch.data.delta import DeltaSnapshot, write_delta

    write_delta(ds, table)
    snap = DeltaSnapshot(table)
    victim = snap.files()[0]["path"]
    with open(
        os.path.join(table, "_delta_log", f"{1:020d}.json"), "w"
    ) as f:
        f.write(json.dumps({"remove": {"path": victim}}) + "\n")
    back = rdata.read_delta(table)
    assert back.count() < 10  # the removed file's rows are gone
    assert DeltaSnapshot(table).version == 1


def test_delta_not_a_table(tmp_path):
    with pytest.raises(FileNotFoundError, match="_delta_log"):
        rdata.read_delta(str(tmp_path / "nope"))


# ----------------------------------------------------------- bigquery
def test_bigquery_query_over_recorded_transport(cluster):
    url = "https://bigquery.googleapis.com/bigquery/v2/projects/proj/queries"
    t = recorded_transport(
        [
            {
                "method": "POST",
                "url": url,
                "body_contains": ["SELECT x", "false"],
                "response": {
                    "jobComplete": True,
                    "jobReference": {"jobId": "j1"},
                    "schema": {
                        "fields": [
                            {"name": "x", "type": "INT64"},
                            {"name": "name", "type": "STRING"},
                            {"name": "score", "type": "FLOAT64"},
                        ]
                    },
                    "rows": [
                        {"f": [{"v": "1"}, {"v": "a"}, {"v": "0.5"}]},
                        {"f": [{"v": "2"}, {"v": "b"}, {"v": "1.5"}]},
                    ],
                    "pageToken": "tok2",
                },
            },
            {
                "method": "GET",
                "url": f"{url}/j1?pageToken=tok2&maxResults=10000",
                "response": {
                    "rows": [
                        {"f": [{"v": "3"}, {"v": "c"}, {"v": "2.5"}]},
                    ]
                },
            },
        ]
    )
    ds = rdata.read_bigquery(
        project="proj", query="SELECT x, name, score FROM t",
        transport=t,
    )
    rows = ds.take_all()
    # The read task runs on a WORKER with a pickled copy of the
    # transport, so the driver's `t` records nothing; the recorded
    # script still enforces call order/shape inside the worker (any
    # mismatch raises and fails the read), and full-row equality below
    # proves both pages were fetched and type-converted.
    assert rows == [
        {"x": 1, "name": "a", "score": 0.5},
        {"x": 2, "name": "b", "score": 1.5},
        {"x": 3, "name": "c", "score": 2.5},
    ]


def test_bigquery_dataset_sugar_and_validation(cluster):
    url = "https://bigquery.googleapis.com/bigquery/v2/projects/proj/queries"
    t = recorded_transport(
        [
            {
                "method": "POST",
                "url": url,
                "body_contains": ["SELECT * FROM `proj.ds.t`"],
                "response": {
                    "jobComplete": True,
                    "jobReference": {"jobId": "j2"},
                    "schema": {
                        "fields": [{"name": "b", "type": "BOOLEAN"}]
                    },
                    "rows": [{"f": [{"v": "true"}]}],
                },
            }
        ]
    )
    rows = rdata.read_bigquery(
        project="proj", dataset="ds.t", transport=t
    ).take_all()
    assert rows == [{"b": True}]
    with pytest.raises(ValueError, match="exactly one"):
        rdata.read_bigquery(project="p", query="q", dataset="d.t")
    with pytest.raises(ValueError, match="dataset.table"):
        rdata.read_bigquery(project="p", dataset="nodot")


def test_delta_checkpoint_seeds_replay(cluster, tmp_path):
    """A checkpoint (incl. the multi-part naming and _last_checkpoint
    pointer) seeds the active set; older JSON commits may be absent —
    the log-retention case real Delta tables hit."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ray_tpu_torch.data.delta import DeltaSnapshot, write_delta

    table = str(tmp_path / "cptbl")
    write_delta(
        rdata.from_items(
            [{"x": i} for i in range(10)], parallelism=4
        ),
        table,
    )
    snap = DeltaSnapshot(table)
    assert len(snap.files()) > 1  # several data files to checkpoint
    adds = snap.files()
    log = os.path.join(table, "_delta_log")
    # Simulate compaction: checkpoint at v1 (two parts), drop v0.json.
    rows = [
        {
            # Parquet cannot encode the empty partitionValues struct;
            # the reader tolerates its absence (.get default).
            "add": {
                k: v for k, v in a.items() if k != "partitionValues"
            },
            "remove": None,
            "metaData": None,
        }
        for a in adds
    ]
    meta_row = {
        "add": None,
        "remove": None,
        "metaData": {
            "schemaString": json.dumps(
                {
                    "type": "struct",
                    "fields": [
                        {"name": "x", "type": "long",
                         "nullable": True, "metadata": {}}
                    ],
                }
            ),
            "partitionColumns": [],
        },
    }
    half = len(rows) // 2 or 1
    pq.write_table(
        pa.Table.from_pylist(rows[:half] + [meta_row]),
        os.path.join(log, f"{1:020d}.checkpoint.{0:010d}.{2:010d}.parquet"),
    )
    pq.write_table(
        pa.Table.from_pylist(rows[half:]),
        os.path.join(log, f"{1:020d}.checkpoint.{1:010d}.{2:010d}.parquet"),
    )
    with open(os.path.join(log, "_last_checkpoint"), "w") as f:
        json.dump({"version": 1, "parts": 2}, f)
    os.remove(os.path.join(log, f"{0:020d}.json"))
    # A post-checkpoint commit removes one file.
    victim = adds[0]["path"]
    with open(os.path.join(log, f"{2:020d}.json"), "w") as f:
        f.write(json.dumps({"remove": {"path": victim}}) + "\n")

    snap2 = DeltaSnapshot(table)
    assert {a["path"] for a in snap2.files()} == {
        a["path"] for a in adds
    } - {victim}
    total = sum(1 for _ in rdata.read_delta(table).iter_rows())
    assert 0 < total < 10
