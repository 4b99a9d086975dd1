"""Datasources: read tasks that produce blocks.

Mirrors the reference's datasource/read-task split (reference:
python/ray/data/datasource/datasource.py `Datasource.get_read_tasks`,
python/ray/data/read_api.py): a datasource plans a list of independent
`ReadTask`s, each a zero-arg callable producing one block, so reads
parallelize as ordinary tasks.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Callable, Iterable

import numpy as np

from ray_tpu_torch.data import block as B

# A ReadTask is a picklable zero-arg callable returning a Block.
ReadTask = Callable[[], B.Block]


class _RangeRead:
    def __init__(self, start: int, end: int):
        self.start, self.end = start, end

    def __call__(self) -> B.Block:
        return {"id": np.arange(self.start, self.end, dtype=np.int64)}


class _ItemsRead:
    def __init__(self, items: list):
        self.items = items

    def __call__(self) -> B.Block:
        return B.from_items(self.items)


class _ParquetRead:
    def __init__(self, path: str, columns=None):
        self.path, self.columns = path, columns

    def __call__(self) -> B.Block:
        import pyarrow.parquet as pq

        return B.from_arrow(pq.read_table(self.path, columns=self.columns))


class _CSVRead:
    def __init__(self, path: str):
        self.path = path

    def __call__(self) -> B.Block:
        import pyarrow.csv as pacsv

        return B.from_arrow(pacsv.read_csv(self.path))


class _JSONRead:
    def __init__(self, path: str):
        self.path = path

    def __call__(self) -> B.Block:
        import json

        rows = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        return B.from_rows(rows)


class _TextRead:
    def __init__(self, path: str):
        self.path = path

    def __call__(self) -> B.Block:
        with open(self.path) as f:
            lines = [ln.rstrip("\n") for ln in f]
        return {"text": B._as_array(lines)}


class _NumpyRead:
    def __init__(self, path: str):
        self.path = path

    def __call__(self) -> B.Block:
        return {"data": np.load(self.path)}


def _expand_paths(paths) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(os.path.join(p, f) for f in os.listdir(p) if not f.startswith(".")))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    return out


def range_tasks(n: int, parallelism: int) -> list[ReadTask]:
    parallelism = max(1, min(parallelism, n) if n else 1)
    step = (n + parallelism - 1) // parallelism if n else 0
    tasks: list[ReadTask] = []
    for s in range(0, n, step or 1):
        tasks.append(_RangeRead(s, min(s + step, n)))
    return tasks or [_RangeRead(0, 0)]


def items_tasks(items: list, parallelism: int) -> list[ReadTask]:
    n = len(items)
    parallelism = max(1, min(parallelism, n) if n else 1)
    step = (n + parallelism - 1) // parallelism if n else 0
    tasks: list[ReadTask] = []
    for s in range(0, n, step or 1):
        tasks.append(_ItemsRead(items[s : s + step]))
    return tasks or [_ItemsRead([])]


def file_tasks(paths, kind: str, **kw) -> list[ReadTask]:
    cls = {
        "parquet": _ParquetRead,
        "csv": _CSVRead,
        "json": _JSONRead,
        "text": _TextRead,
        "numpy": _NumpyRead,
    }[kind]
    files = _expand_paths(paths)
    if not files:
        raise FileNotFoundError(f"no files match {paths!r}")
    return [cls(f, **kw) if kind == "parquet" else cls(f) for f in files]
