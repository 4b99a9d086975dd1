"""Delta Lake table reading (and a minimal writer for round-trips).

Reference surface: ray.data's lakehouse datasources
(python/ray/data/_internal/datasource/ — delta sharing, iceberg,
lance). Delta is the one fully implementable with this image's stack:
the table format is parquet data files plus a JSON transaction log
(`_delta_log/<version>.json`, optional parquet checkpoints), no avro.

Read path (the delta protocol's client rules):
- find the latest checkpoint from ``_delta_log/_last_checkpoint`` (or
  scan), seed the active-file set from its `add` records,
- apply newer JSON commits in version order: each line holds one
  action — ``add`` (file joins the table), ``remove`` (file leaves),
  ``metaData`` (schema + partition columns), ``protocol``/
  ``commitInfo`` (ignored for reads),
- one ReadTask per surviving data file; Hive-style partition values
  from ``add.partitionValues`` come back as columns, cast per the
  table schema.

The writer emits a spec-shaped single-commit table (data parquet +
00000000000000000000.json with protocol/metaData/add actions) — enough
for round-trip tests and for handing small tables to real Delta
readers.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Any

from ray_tpu_torch.data import block as B

_LOG_DIR = "_delta_log"
_VERSION_DIGITS = 20


def _log_path(table: str, version: int) -> str:
    return os.path.join(
        table, _LOG_DIR, f"{version:0{_VERSION_DIGITS}d}.json"
    )


def _parse_schema_types(schema_string: str) -> "dict[str, str]":
    """Spark-JSON schema → {column: primitive type name}."""
    try:
        schema = json.loads(schema_string)
    except (TypeError, ValueError):
        return {}
    out = {}
    for field in schema.get("fields", []):
        t = field.get("type")
        if isinstance(t, str):
            out[field.get("name", "")] = t
    return out


def _cast_partition(value: "str | None", typ: str):
    if value is None:
        return None
    if typ in ("integer", "long", "short", "byte"):
        return int(value)
    if typ in ("double", "float"):
        return float(value)
    if typ == "boolean":
        return value.lower() == "true"
    return value


class DeltaSnapshot:
    """Resolved table state: active files + schema metadata."""

    def __init__(self, table: str):
        self.table = table
        log_dir = os.path.join(table, _LOG_DIR)
        if not os.path.isdir(log_dir):
            raise FileNotFoundError(
                f"{table!r} is not a Delta table (no {_LOG_DIR}/)"
            )
        entries = sorted(os.listdir(log_dir))
        commits = [
            e for e in entries
            if e.endswith(".json") and e[:_VERSION_DIGITS].isdigit()
        ]
        self.active: dict[str, dict] = {}  # path -> add action
        self.partition_columns: list[str] = []
        self.schema_types: dict[str, str] = {}
        start_version = 0
        cp_version, cp_parts = self._checkpoint_ref(log_dir, entries)
        if cp_version is not None:
            start_version = cp_version + 1
            for part in cp_parts:
                self._apply_checkpoint(os.path.join(log_dir, part))
        for name in commits:
            if int(name[:_VERSION_DIGITS]) < start_version:
                continue
            with open(os.path.join(log_dir, name)) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self._apply_action(json.loads(line))
        self.version = (
            int(commits[-1][:_VERSION_DIGITS]) if commits
            else start_version - 1
        )

    @staticmethod
    def _checkpoint_ref(log_dir, entries):
        """Latest checkpoint version + its part files. Prefers the
        ``_last_checkpoint`` pointer (the spec's fast path); falls back
        to scanning for both single-part (<v>.checkpoint.parquet) and
        multi-part (<v>.checkpoint.<i>.<n>.parquet) names."""
        import re

        pointer = os.path.join(log_dir, "_last_checkpoint")
        by_version: dict[int, list[str]] = {}
        pat = re.compile(
            rf"^(\d{{{_VERSION_DIGITS}}})\.checkpoint"
            r"(?:\.\d+\.\d+)?\.parquet$"
        )
        for e in entries:
            m = pat.match(e)
            if m:
                by_version.setdefault(int(m.group(1)), []).append(e)
        if os.path.exists(pointer):
            try:
                with open(pointer) as f:
                    ref = json.load(f)
                v = int(ref["version"])
                parts = by_version.get(v)
                if parts and len(parts) == int(ref.get("parts", 1)):
                    return v, sorted(parts)
            except (OSError, ValueError, KeyError):
                pass  # corrupt pointer: trust the scan instead
        if by_version:
            v = max(by_version)
            return v, sorted(by_version[v])
        return None, []

    def _apply_checkpoint(self, path: str) -> None:
        import pyarrow.parquet as pq

        tbl = pq.read_table(path)
        for row in tbl.to_pylist():
            for kind in ("add", "remove", "metaData"):
                if row.get(kind):
                    self._apply_action({kind: row[kind]})

    def _apply_action(self, action: dict) -> None:
        if "metaData" in action and action["metaData"]:
            md = action["metaData"]
            self.partition_columns = list(
                md.get("partitionColumns", [])
            )
            self.schema_types = _parse_schema_types(
                md.get("schemaString", "")
            )
        elif "add" in action and action["add"]:
            add = action["add"]
            self.active[add["path"]] = add
        elif "remove" in action and action["remove"]:
            self.active.pop(action["remove"]["path"], None)

    def files(self) -> "list[dict]":
        return [self.active[p] for p in sorted(self.active)]


class _DeltaFileRead:
    """One active data file → one block, partition values attached."""

    def __init__(self, table, add, partition_columns, schema_types,
                 columns=None):
        self.table = table
        self.add = add
        self.partition_columns = partition_columns
        self.schema_types = schema_types
        self.columns = columns

    def __call__(self) -> B.Block:
        import pyarrow as pa
        import pyarrow.parquet as pq

        path = os.path.join(self.table, self.add["path"])
        file_cols = None
        if self.columns is not None:
            file_cols = [
                c for c in self.columns
                if c not in self.partition_columns
            ]
        tbl = pq.read_table(path, columns=file_cols)
        pv = self.add.get("partitionValues", {})
        for col in self.partition_columns:
            if self.columns is not None and col not in self.columns:
                continue
            value = _cast_partition(
                pv.get(col), self.schema_types.get(col, "string")
            )
            tbl = tbl.append_column(
                col, pa.array([value] * tbl.num_rows)
            )
        return B.from_arrow(tbl)


def delta_tasks(table: str, *, columns=None) -> list:
    snap = DeltaSnapshot(table)
    return [
        _DeltaFileRead(
            table, add, snap.partition_columns, snap.schema_types,
            columns=columns,
        )
        for add in snap.files()
    ] or [lambda: {}]


def _spark_type(np_dtype) -> str:
    import numpy as np

    if np.issubdtype(np_dtype, np.bool_):
        return "boolean"
    if np.issubdtype(np_dtype, np.integer):
        return "long"
    if np.issubdtype(np_dtype, np.floating):
        return "double"
    return "string"


def _block_columns(blk) -> "dict[str, Any]":
    """Block (arrow Table or dict of ndarrays) → {name: ndarray}."""
    import numpy as np

    if isinstance(blk, dict):
        return {k: np.asarray(v) for k, v in blk.items()}
    return {
        name: blk.column(name).to_numpy(zero_copy_only=False)
        for name in blk.schema.names
    }


def write_delta(ds, table: str, *, partition_by: "str | None" = None):
    """Write a Dataset as a NEW single-commit Delta table (errors if
    the table exists — this is a test/export surface, not a
    transactional writer)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    log_dir = os.path.join(table, _LOG_DIR)
    if os.path.exists(log_dir):
        raise FileExistsError(f"delta table {table!r} already exists")
    os.makedirs(log_dir)
    blocks = [
        _block_columns(b) for b in ds.iter_blocks() if B.num_rows(b)
    ]
    if not blocks:
        raise ValueError("cannot write an empty delta table")
    fields = [
        {
            "name": name,
            "type": _spark_type(arr.dtype),
            "nullable": True,
            "metadata": {},
        }
        for name, arr in blocks[0].items()
    ]
    schema_string = json.dumps(
        {"type": "struct", "fields": fields}
    )
    adds = []
    for i, blk in enumerate(blocks):
        parts: "dict[Any, dict]" = {}
        if partition_by is None:
            parts[None] = blk
        else:
            col = blk[partition_by]
            for v in np.unique(col):
                mask = col == v
                parts[v.item() if hasattr(v, "item") else v] = {
                    name: arr[mask]
                    for name, arr in blk.items()
                    if name != partition_by
                }
        for pv, part in parts.items():
            if partition_by is None:
                rel = f"part-{i:05d}-{uuid.uuid4().hex[:8]}.parquet"
            else:
                rel = (
                    f"{partition_by}={pv}/part-{i:05d}-"
                    f"{uuid.uuid4().hex[:8]}.parquet"
                )
                os.makedirs(
                    os.path.join(table, os.path.dirname(rel)),
                    exist_ok=True,
                )
            pq.write_table(
                pa.table(part), os.path.join(table, rel)
            )
            adds.append(
                {
                    "add": {
                        "path": rel,
                        "partitionValues": (
                            {} if partition_by is None
                            else {partition_by: str(pv)}
                        ),
                        "size": os.path.getsize(
                            os.path.join(table, rel)
                        ),
                        "modificationTime": 0,
                        "dataChange": True,
                    }
                }
            )
    actions = [
        {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
        {
            "metaData": {
                "id": str(uuid.uuid4()),
                "format": {"provider": "parquet", "options": {}},
                "schemaString": schema_string,
                "partitionColumns": (
                    [partition_by] if partition_by else []
                ),
                "configuration": {},
            }
        },
        *adds,
    ]
    with open(_log_path(table, 0), "w") as f:
        for a in actions:
            f.write(json.dumps(a) + "\n")
