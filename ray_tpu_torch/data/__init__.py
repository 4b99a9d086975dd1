"""ray_tpu_torch.data: distributed datasets with streaming execution.

Capability-equivalent of the reference's Data library (reference:
python/ray/data/ — lazy logical plan, streaming executor over blocks in
the object store, datasources, groupby/shuffle/sort, Train integration),
re-based on columnar-numpy blocks that feed torch input pipelines without
conversion.
"""

from __future__ import annotations

from ray_tpu_torch.data import block, datasource
from ray_tpu_torch.data.dataset import DataIterator, Dataset, GroupedData, MaterializedDataset
from ray_tpu_torch.data.executor import DataContext
from ray_tpu_torch.data.plan import LogicalPlan, Read


def _from_read_tasks(tasks) -> Dataset:
    return Dataset(LogicalPlan([Read(tasks)]))


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    if parallelism <= 0:
        parallelism = min(200, max(1, n // 1000 or 1))
    return _from_read_tasks(datasource.range_tasks(n, parallelism))


def from_items(items: list, *, parallelism: int = -1) -> Dataset:
    if parallelism <= 0:
        parallelism = min(200, max(1, len(items) // 100 or 1))
    return _from_read_tasks(datasource.items_tasks(list(items), parallelism))


def from_numpy(arr, *, parallelism: int = 4) -> Dataset:
    import numpy as np

    chunks = np.array_split(arr, max(1, parallelism))
    return from_blocks([{"data": c} for c in chunks])


def from_blocks(blocks: list) -> Dataset:
    import ray_tpu_torch

    refs = [ray_tpu_torch.put(b) for b in blocks]
    return MaterializedDataset(refs)


def from_pandas(dfs) -> Dataset:
    if not isinstance(dfs, list):
        dfs = [dfs]
    return from_blocks([block.from_pandas(df) for df in dfs])


def from_arrow(tables) -> Dataset:
    if not isinstance(tables, list):
        tables = [tables]
    return from_blocks([block.from_arrow(t) for t in tables])


def read_parquet(paths, *, columns=None) -> Dataset:
    return _from_read_tasks(datasource.file_tasks(paths, "parquet", columns=columns))


def read_csv(paths) -> Dataset:
    return _from_read_tasks(datasource.file_tasks(paths, "csv"))


def read_json(paths) -> Dataset:
    return _from_read_tasks(datasource.file_tasks(paths, "json"))


def read_text(paths) -> Dataset:
    return _from_read_tasks(datasource.file_tasks(paths, "text"))


def read_numpy(paths) -> Dataset:
    return _from_read_tasks(datasource.file_tasks(paths, "numpy"))


def read_delta(table: str, *, columns=None) -> Dataset:
    """Read a Delta Lake table (parquet + JSON transaction log): one
    read task per active data file, partition values as columns
    (data/delta.py; reference surface: ray.data lakehouse
    datasources)."""
    from ray_tpu_torch.data import delta

    return _from_read_tasks(delta.delta_tasks(table, columns=columns))


def read_bigquery(
    *,
    project: str,
    query: str | None = None,
    dataset: str | None = None,
    transport=None,
) -> Dataset:
    """Read BigQuery rows over the REST v2 API (data/bigquery.py;
    reference: python/ray/data read_bigquery). ``dataset`` is
    "dataset.table" sugar for a full-table SELECT. ``transport``
    injects a recorded transport in tests (zero-egress CI), exactly
    like the GKE provider's fixtures."""
    from ray_tpu_torch.data import bigquery

    return _from_read_tasks(
        bigquery.bigquery_tasks(
            project=project, query=query, dataset=dataset,
            transport=transport,
        )
    )


__all__ = [
    "Dataset", "MaterializedDataset", "GroupedData", "DataIterator",
    "DataContext", "range", "from_items", "from_blocks", "from_pandas",
    "from_arrow", "from_numpy", "read_parquet", "read_csv", "read_json",
    "read_text", "read_numpy", "read_delta", "read_bigquery",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu('data')
del _rlu
