"""Dask-on-ray_tpu_torch: execute dask task graphs on the cluster.

Reference: python/ray/util/dask/__init__.py — ``ray_dask_get``, a dask
scheduler that runs each graph task as a Ray task so dask collections
(dataframe/array/delayed) compute on the cluster. The TPU-native
equivalent: :func:`ray_tpu_dask_get` implements the dask *scheduler
protocol* (``get(dsk, keys)`` over the documented graph format — a
dict of key → task tuple/literal), so with dask installed you run

    dask.compute(obj, scheduler=ray_tpu_dask_get)

and WITHOUT dask the scheduler still executes hand-built graphs in the
same format (the graph spec is plain dicts/tuples — this module has no
dask import), which is how the zero-dask CI exercises it.

Execution: one ray_tpu_torch task per graph node, submitted in dependency
order with upstream results passed as ObjectRefs — independent
subtrees run concurrently across the cluster, and intermediate results
move through the object store, never through the driver.
"""

from __future__ import annotations

from typing import Any


def _istask(x) -> bool:
    """Dask spec: a task is a tuple whose first element is callable."""
    return isinstance(x, tuple) and bool(x) and callable(x[0])


def _find_keys(expr, dsk, out: set) -> None:
    """Collect graph keys referenced inside a task expression. Keys are
    hashables present in the graph dict; per the dask spec they may
    appear nested in lists (tuples are tasks, not key containers,
    except tuple-keys which appear verbatim)."""
    if _istask(expr):
        for arg in expr[1:]:
            _find_keys(arg, dsk, out)
    elif isinstance(expr, list):
        for item in expr:
            _find_keys(item, dsk, out)
    else:
        try:
            if expr in dsk:
                out.add(expr)
        except TypeError:
            pass  # unhashable literal


def _execute_expr(expr, resolved: dict):
    """Evaluate a task expression with already-resolved dependencies
    substituted. Runs INSIDE the worker task."""
    if _istask(expr):
        fn = expr[0]
        args = [_execute_expr(a, resolved) for a in expr[1:]]
        return fn(*args)
    if isinstance(expr, list):
        return [_execute_expr(a, resolved) for a in expr]
    try:
        if expr in resolved:
            return resolved[expr]
    except TypeError:
        pass
    return expr


def _run_node(expr, dep_keys, *dep_values):
    """The remote task body: rebuild the resolved-deps mapping from
    positional ObjectRef arguments (the runtime resolves top-level
    refs) and evaluate the node expression."""
    return _execute_expr(expr, dict(zip(dep_keys, dep_values)))


def ray_tpu_dask_get(dsk: dict, keys, **kwargs) -> Any:
    """Dask scheduler protocol: compute ``keys`` from graph ``dsk``.

    ``keys`` may be a single key or (nested lists of) keys, per the
    dask ``get`` contract. Extra kwargs (dask passes scheduler hints)
    are accepted and ignored.
    """
    import ray_tpu_torch

    run_node = ray_tpu_torch.remote(_run_node)

    refs: dict[Any, Any] = {}

    def materialize(key, stack=()):
        if key in refs:
            return refs[key]
        if key in stack:
            raise ValueError(f"cycle in dask graph at {key!r}")
        expr = dsk[key]
        deps: set = set()
        _find_keys(expr, dsk, deps)
        dep_keys = sorted(deps, key=repr)
        dep_refs = [
            materialize(d, stack + (key,)) for d in dep_keys
        ]
        if not _istask(expr) and not isinstance(expr, list):
            # Alias (key -> key) or literal: no task needed.
            if dep_keys:
                refs[key] = dep_refs[0]
            else:
                refs[key] = ray_tpu_torch.put(expr)
            return refs[key]
        refs[key] = run_node.remote(expr, dep_keys, *dep_refs)
        return refs[key]

    def resolve(spec):
        if isinstance(spec, list):
            return [resolve(s) for s in spec]
        return ray_tpu_torch.get(materialize(spec))

    return resolve(keys)
