"""Dataset: the lazy, distributed user-facing API.

Mirrors the reference's Dataset surface (reference:
python/ray/data/dataset.py — map_batches, filter, random_shuffle, sort,
groupby, iter_batches :5432, streaming_split for Train integration) over
the reduced logical plan + streaming executor in this package.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterator

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as B
from ray_tpu_torch.data import plan as P
from ray_tpu_torch.data.executor import DataContext, execute


class Dataset:
    def __init__(self, plan: P.LogicalPlan):
        self._plan = plan

    # ------------------------------------------------------------ lazy ops
    def _with(self, op: P.Op) -> "Dataset":
        return Dataset(self._plan.with_op(op))

    def map_batches(self, fn, *, batch_size=None, batch_format="numpy",
                    fn_args=(), fn_kwargs=None, concurrency=None,
                    compute=None, fn_constructor_args=()) -> "Dataset":
        is_class = isinstance(fn, type)
        return self._with(P.MapBatches(
            fn, batch_size=batch_size, batch_format=batch_format,
            fn_args=fn_args, fn_kwargs=fn_kwargs, concurrency=concurrency,
            compute=compute or ("actors" if is_class else "tasks"),
            fn_constructor_args=fn_constructor_args))

    def map(self, fn) -> "Dataset":
        return self._with(P.MapRows(fn))

    def filter(self, fn) -> "Dataset":
        return self._with(P.Filter(fn))

    def flat_map(self, fn) -> "Dataset":
        return self._with(P.FlatMap(fn))

    def add_column(self, name: str, fn) -> "Dataset":
        return self._with(P.AddColumn(name, fn))

    def drop_columns(self, cols: list[str]) -> "Dataset":
        return self._with(P.DropColumns(cols))

    def select_columns(self, cols: list[str]) -> "Dataset":
        return self._with(P.SelectColumns(cols))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with(P.Repartition(num_blocks))

    def random_shuffle(self, *, seed=None) -> "Dataset":
        return self._with(P.RandomShuffle(seed))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with(P.Sort(key, descending))

    def limit(self, n: int) -> "Dataset":
        return self._with(P.Limit(n))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._with(P.Union([o._plan for o in others]))

    def join(
        self,
        other: "Dataset",
        on: str,
        how: str = "inner",
        *,
        num_partitions: int | None = None,
        suffix: str = "_r",
    ) -> "Dataset":
        """Hash join on a key column (reference: the hash-shuffle join
        operator, python/ray/data/_internal/execution/operators/join.py /
        hash_shuffle.py). ``how``: inner | left | right | outer.
        Overlapping non-key columns from the right side get ``suffix``."""
        if how not in ("inner", "left", "right", "outer"):
            raise ValueError(f"unsupported join type {how!r}")
        return self._with(
            P.Join(other._plan, on, how, n_out=num_partitions, suffix=suffix)
        )

    def zip(self, other: "Dataset") -> "Dataset":
        return self._with(P.Zip(other._plan))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    # ------------------------------------------------------- aggregations
    def _global_agg(self, *specs: tuple):
        """One aggregation pass over the plan for all (kind, on) specs."""
        aggs = [(k, on, k if on is None else f"{k}({on})") for k, on in specs]
        refs = list(execute(self._plan.with_op(
            P.GroupByAggregate(None, aggs))))
        blocks = ray_tpu_torch.get(refs)
        blk = B.concat([b for b in blocks if b])
        if not B.num_rows(blk):
            return [None] * len(aggs)
        return [blk[out][0] for _, _, out in aggs]

    def count(self) -> int:
        from ray_tpu_torch.data.executor import _count_rows

        refs = list(execute(self._plan))
        return int(sum(ray_tpu_torch.get([_count_rows.remote(r) for r in refs])))

    def sum(self, on: str):
        return self._global_agg(("sum", on))[0]

    def min(self, on: str):
        return self._global_agg(("min", on))[0]

    def max(self, on: str):
        return self._global_agg(("max", on))[0]

    def mean(self, on: str):
        # exact sum/count in ONE pass over the plan (partition-mean
        # averaging would be biased; two passes would double the work)
        total, n = self._global_agg(("sum", on), ("count", on))
        return total / n if n else None

    # ------------------------------------------------------- consumption
    def materialize(self) -> "MaterializedDataset":
        refs = list(execute(self._plan))
        return MaterializedDataset(refs)

    def iter_blocks(self) -> Iterator[B.Block]:
        for ref in execute(self._plan):
            yield ray_tpu_torch.get(ref)

    def iter_rows(self) -> Iterator[dict]:
        for blk in self.iter_blocks():
            yield from B.to_rows(blk)

    def iter_batches(self, *, batch_size: int = 256, batch_format="numpy",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: int | None = None,
                     local_shuffle_seed=None) -> Iterator:
        """Rebatch the block stream (reference: dataset.py:5432 iter_batches
        → block_batching); optional local shuffle buffer mirrors
        LocalShuffleBuffer semantics."""
        buf: list[B.Block] = []
        buffered = 0
        rng = np.random.default_rng(local_shuffle_seed)
        lo = local_shuffle_buffer_size or 0

        def drain(min_rows: int):
            nonlocal buf, buffered
            while buffered >= max(batch_size, min_rows) and buffered >= batch_size:
                blk = B.concat(buf)
                if lo:
                    blk = B.take_idx(blk, rng.permutation(B.num_rows(blk)))
                out = B.slice_block(blk, 0, batch_size)
                rest = B.slice_block(blk, batch_size, B.num_rows(blk))
                buf = [rest] if B.num_rows(rest) else []
                buffered = B.num_rows(rest)
                yield B.to_batch(out, batch_format)
                if lo and buffered < lo:
                    return

        for blk in self.iter_blocks():
            if B.num_rows(blk) == 0:
                continue
            buf.append(blk)
            buffered += B.num_rows(blk)
            yield from drain(lo)
        while buffered >= batch_size:
            yield from drain(0)
            if buffered < batch_size:
                break
        if buffered and not drop_last:
            yield B.to_batch(B.concat(buf), batch_format)

    def take(self, n: int = 20) -> list[dict]:
        out = []
        for row in self.limit(n).iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> list[dict]:
        return list(self.iter_rows())

    def to_pandas(self):
        return B.to_pandas(B.concat(list(self.iter_blocks())))

    def to_arrow(self):
        """Materialize as one pyarrow Table; ndim>=2 numpy columns
        become tensor extension columns (reference: Dataset.to_arrow_refs,
        data/dataset.py — block-level tables concatenated here since
        the driver already holds the refs)."""
        return B.to_arrow(B.concat(list(self.iter_blocks())))

    def schema(self) -> dict:
        for blk in self.iter_blocks():
            if B.num_rows(blk):
                return B.schema(blk)
        return {}

    def num_blocks(self) -> int:
        return len(list(execute(self._plan)))

    # ------------------------------------------------- Train integration
    def split(self, n: int, *, equal: bool = True) -> list["MaterializedDataset"]:
        """Split into n shards (reference: dataset.py split; Train's
        DataConfig splits streams per worker)."""
        mat = self.repartition(n).materialize()
        refs = mat._refs
        shards = [[] for _ in range(n)]
        for i, ref in enumerate(refs):
            shards[i % n].append(ref)
        return [MaterializedDataset(s) for s in shards]

    def streaming_split(self, n: int) -> list["DataIterator"]:
        return [DataIterator(s) for s in self.split(n)]

    def write_parquet(self, path: str) -> None:
        import os

        import pyarrow.parquet as pq

        os.makedirs(path, exist_ok=True)
        for i, blk in enumerate(self.iter_blocks()):
            if not B.num_rows(blk):
                continue
            # Arrow blocks pass through; numpy dicts convert (ndim>=2
            # columns become tensor extension columns).
            tbl = B.to_arrow(blk)
            pq.write_table(tbl, os.path.join(path, f"part-{i:05d}.parquet"))

    def stats(self) -> str:
        return self._plan.describe()

    def __repr__(self):
        return f"Dataset(plan={self._plan.describe()!r})"


class MaterializedDataset(Dataset):
    """A dataset whose blocks are pinned refs (reference: MaterializedDataset)."""

    def __init__(self, refs: list):
        self._refs = refs
        super().__init__(P.LogicalPlan([P.RefSource(refs)]))


class GroupedData:
    """Result of ds.groupby(key) (reference: grouped_data.py)."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, kind: str, on: str | None) -> Dataset:
        out = kind if on is None else f"{kind}({on})"
        return self._ds._with(P.GroupByAggregate(self._key, [(kind, on, out)]))

    def count(self) -> Dataset:
        return self._agg("count", None)

    def sum(self, on: str) -> Dataset:
        return self._agg("sum", on)

    def min(self, on: str) -> Dataset:
        return self._agg("min", on)

    def max(self, on: str) -> Dataset:
        return self._agg("max", on)

    def mean(self, on: str) -> Dataset:
        return self._agg("mean", on)

    def aggregate(self, *specs) -> Dataset:
        """specs: (kind, column) tuples."""
        aggs = [(k, c, f"{k}({c})") for k, c in specs]
        return self._ds._with(P.GroupByAggregate(self._key, aggs))

    def map_groups(self, fn, *, batch_format="numpy") -> Dataset:
        return self._ds._with(P.MapGroups(self._key, fn, batch_format))


class DataIterator:
    """Per-worker shard iterator (reference: DataIterator / iter_torch_batches)."""

    def __init__(self, shard: MaterializedDataset):
        self._shard = shard

    def iter_batches(self, **kw) -> Iterator:
        return self._shard.iter_batches(**kw)

    def iter_rows(self) -> Iterator[dict]:
        return self._shard.iter_rows()

    def count(self) -> int:
        return self._shard.count()
