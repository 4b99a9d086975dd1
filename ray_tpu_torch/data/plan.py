"""Logical plan: a linear chain of operators over blocks.

Mirrors the reference's logical-plan layer (reference:
python/ray/data/_internal/logical/interfaces/logical_plan.py) in reduced
form: a `LogicalPlan` is a list of `Op` records; the streaming executor
(executor.py) turns each into a physical generator stage.
"""

from __future__ import annotations

from typing import Any, Callable


class Op:
    kind: str = ""

    def name(self) -> str:
        return self.kind


class Read(Op):
    kind = "read"

    def __init__(self, tasks: list, schema_hint=None):
        self.tasks = tasks  # list[ReadTask]


class RefSource(Op):
    """Source over already-materialized block refs (MaterializedDataset)."""

    kind = "ref_source"

    def __init__(self, refs: list):
        self.refs = refs


class MapBatches(Op):
    kind = "map_batches"

    def __init__(self, fn, *, batch_size=None, batch_format="numpy",
                 fn_args=(), fn_kwargs=None, concurrency=None, compute="tasks",
                 fn_constructor_args=()):
        self.fn = fn
        self.batch_size = batch_size
        self.batch_format = batch_format
        self.fn_args = tuple(fn_args)
        self.fn_kwargs = dict(fn_kwargs or {})
        self.concurrency = concurrency
        self.compute = compute  # "tasks" | "actors" (callable-class fns)
        self.fn_constructor_args = tuple(fn_constructor_args)


class MapRows(Op):
    kind = "map"

    def __init__(self, fn):
        self.fn = fn


class Filter(Op):
    kind = "filter"

    def __init__(self, fn):
        self.fn = fn


class FlatMap(Op):
    kind = "flat_map"

    def __init__(self, fn):
        self.fn = fn


class AddColumn(Op):
    kind = "add_column"

    def __init__(self, name: str, fn):
        self.col_name = name
        self.fn = fn


class DropColumns(Op):
    kind = "drop_columns"

    def __init__(self, cols: list[str]):
        self.cols = list(cols)


class SelectColumns(Op):
    kind = "select_columns"

    def __init__(self, cols: list[str]):
        self.cols = list(cols)


class Repartition(Op):
    kind = "repartition"

    def __init__(self, n: int):
        self.n = n


class RandomShuffle(Op):
    kind = "random_shuffle"

    def __init__(self, seed=None, n_out=None):
        self.seed = seed
        self.n_out = n_out


class Sort(Op):
    kind = "sort"

    def __init__(self, key: str, descending: bool = False):
        self.key = key
        self.descending = descending


class Limit(Op):
    kind = "limit"

    def __init__(self, n: int):
        self.n = n


class Union(Op):
    kind = "union"

    def __init__(self, others: list):
        self.others = others  # list[LogicalPlan]


class Zip(Op):
    kind = "zip"

    def __init__(self, other):
        self.other = other  # LogicalPlan


class Join(Op):
    kind = "join"

    def __init__(self, other, on: str, how: str = "inner", n_out=None,
                 suffix: str = "_r"):
        self.other = other  # the right side's LogicalPlan
        self.on = on
        self.how = how
        self.n_out = n_out
        self.suffix = suffix


class GroupByAggregate(Op):
    kind = "aggregate"

    def __init__(self, key: str | None, aggs: list, n_out=None):
        self.key = key
        self.aggs = aggs  # list[(agg_kind, column, out_name)]
        self.n_out = n_out


class MapGroups(Op):
    kind = "map_groups"

    def __init__(self, key: str, fn, batch_format="numpy", n_out=None):
        self.key = key
        self.fn = fn
        self.batch_format = batch_format
        self.n_out = n_out


class LogicalPlan:
    def __init__(self, ops: list[Op] | None = None):
        self.ops: list[Op] = list(ops or [])

    def with_op(self, op: Op) -> "LogicalPlan":
        return LogicalPlan(self.ops + [op])

    def describe(self) -> str:
        return " -> ".join(op.name() for op in self.ops)
