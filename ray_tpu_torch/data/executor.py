"""Streaming executor: turns a logical plan into pipelined task waves.

Mirrors the reference's streaming execution model (reference:
python/ray/data/_internal/execution/streaming_executor.py:72 — operators
pull block refs from upstream, launch bounded numbers of remote tasks,
and hand refs downstream before the whole input is materialized), with
the reference's map-fusion optimization (logical/rules/operator_fusion):
consecutive row/batch maps run as one task per block.

Blocks never pass through the driver on the hot path — stages exchange
ObjectRefs; values stay in worker memory / the shared-memory store.
"""

from __future__ import annotations

import collections
import logging
from typing import Iterator

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as B
from ray_tpu_torch.data import plan as P

logger = logging.getLogger("ray_tpu_torch.data")

_FUSABLE = {"map_batches", "map", "filter", "flat_map", "add_column",
            "drop_columns", "select_columns"}


class DataContext:
    """Execution knobs (reference: python/ray/data/context.py DataContext)."""

    _instance = None

    def __init__(self):
        self.prefetch_blocks = 4          # per-stage in-flight task window
        self.default_parallelism = None   # None → from cluster CPUs
        self.shuffle_partitions = None    # None → keep input partition count
        self.min_parallelism = 2

    @classmethod
    def get_current(cls) -> "DataContext":
        if cls._instance is None:
            cls._instance = DataContext()
        return cls._instance

    def parallelism(self) -> int:
        if self.default_parallelism:
            return self.default_parallelism
        try:
            cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 0))
        except Exception:  # noqa: BLE001
            logger.debug(
                "cluster resource probe failed; using default parallelism"
            )
            cpus = 0
        return max(self.min_parallelism, cpus or 4)


# --------------------------------------------------------------------------
# Remote kernels (run in worker processes).
# --------------------------------------------------------------------------

def _apply_chain(chain: list, blk: B.Block) -> B.Block:
    for op in chain:
        kind = op[0]
        if kind == "map_batches":
            _, fn, batch_size, batch_format, fn_args, fn_kwargs = op
            if batch_size is None or B.num_rows(blk) <= batch_size:
                blk = B.from_batch(fn(B.to_batch(blk, batch_format), *fn_args, **fn_kwargs))
            else:
                outs = []
                for s in range(0, B.num_rows(blk), batch_size):
                    piece = B.slice_block(blk, s, s + batch_size)
                    outs.append(B.from_batch(fn(B.to_batch(piece, batch_format), *fn_args, **fn_kwargs)))
                blk = B.concat(outs)
        elif kind == "map":
            blk = B.from_rows(op[1](r) for r in B.to_rows(blk))
        elif kind == "filter":
            fn = op[1]
            keep = np.fromiter((bool(fn(r)) for r in B.to_rows(blk)), dtype=bool,
                               count=B.num_rows(blk))
            blk = B.take_idx(blk, np.nonzero(keep)[0])
        elif kind == "flat_map":
            fn = op[1]
            rows = []
            for r in B.to_rows(blk):
                rows.extend(fn(r))
            blk = B.from_rows(rows)
        elif kind == "add_column":
            _, name, fn = op
            blk = dict(B.ensure_numpy(blk))
            blk[name] = B._as_array(fn(dict(blk)))
        elif kind == "drop_columns":
            if B._is_table(blk):
                blk = blk.drop_columns(
                    [c for c in op[1] if c in blk.column_names]
                )
            else:
                blk = {k: v for k, v in blk.items() if k not in op[1]}
        elif kind == "select_columns":
            if B._is_table(blk):
                blk = blk.select(op[1])
            else:
                blk = {k: blk[k] for k in op[1]}
        else:
            raise AssertionError(kind)
    return blk


@ray_tpu_torch.remote
def _exec_read(task, chain):
    return _apply_chain(chain, task())


@ray_tpu_torch.remote
def _exec_chain(chain, blk):
    return _apply_chain(chain, blk)


@ray_tpu_torch.remote
class _MapActor:
    """Actor-compute map worker (reference: actor_pool_map_operator.py)."""

    def __init__(self, fn_cls, ctor_args, chain_rest):
        self.fn = fn_cls(*ctor_args)
        self.chain_rest = chain_rest

    def apply(self, batch_size, batch_format, fn_args, fn_kwargs, blk):
        first = ("map_batches", self.fn, batch_size, batch_format, fn_args, fn_kwargs)
        return _apply_chain([first] + list(self.chain_rest), blk)


@ray_tpu_torch.remote
def _count_rows(blk):
    return B.num_rows(blk)


@ray_tpu_torch.remote
def _head(blk, n):
    return B.slice_block(blk, 0, n)


@ray_tpu_torch.remote
def _slice_concat(meta, *blks):
    # meta: list of (input_index, start, end) making up this output partition
    return B.concat([B.slice_block(blks[i], s, e) for i, s, e in meta])


@ray_tpu_torch.remote
def _shuffle_map(n, seed, blk):
    rng = np.random.default_rng(seed)
    nr = B.num_rows(blk)
    assign = rng.integers(0, n, size=nr)
    parts = tuple(B.take_idx(blk, np.nonzero(assign == j)[0]) for j in range(n))
    return parts if n > 1 else parts[0]


@ray_tpu_torch.remote
def _shuffle_reduce(seed, *parts):
    blk = B.concat(list(parts))
    rng = np.random.default_rng(seed)
    return B.take_idx(blk, rng.permutation(B.num_rows(blk)))


@ray_tpu_torch.remote
def _sample_keys(key, k, blk):
    blk = B.ensure_numpy(blk)
    nr = B.num_rows(blk)
    if nr == 0:
        return np.array([])
    idx = np.linspace(0, nr - 1, num=min(k, nr)).astype(np.int64)
    return blk[key][idx]


@ray_tpu_torch.remote
def _range_part(key, boundaries, blk):
    blk = B.ensure_numpy(blk)
    n = len(boundaries) + 1
    keys = blk[key]
    assign = np.searchsorted(boundaries, keys, side="right")
    parts = tuple(B.take_idx(blk, np.nonzero(assign == j)[0]) for j in range(n))
    return parts if n > 1 else parts[0]


@ray_tpu_torch.remote
def _merge_sorted(key, descending, *parts):
    blk = B.ensure_numpy(B.concat(list(parts)))
    order = np.argsort(blk[key], kind="stable") if blk else np.array([], dtype=np.int64)
    if descending:
        order = order[::-1]
    return B.take_idx(blk, order)


def _stable_hash(k, n: int) -> int:
    """Deterministic across processes (builtin str hash is per-process
    randomized, which would scatter equal keys across partitions)."""
    if isinstance(k, (int, np.integer)):
        return int(k) % n
    import zlib

    return zlib.crc32(repr(k).encode()) % n


@ray_tpu_torch.remote
def _hash_part(key, n, blk):
    blk = B.ensure_numpy(blk)
    if not blk:
        return tuple({} for _ in range(n)) if n > 1 else {}
    keys = blk[key]
    hashes = np.array([_stable_hash(k, n) for k in keys.tolist()], dtype=np.int64)
    parts = tuple(B.take_idx(blk, np.nonzero(hashes == j)[0]) for j in range(n))
    return parts if n > 1 else parts[0]


def _agg_one(kind, vals):
    if kind == "count":
        return len(vals)
    return getattr(np, kind)(vals) if len(vals) else None


@ray_tpu_torch.remote
def _agg_partition(key, aggs, *parts):
    blk = B.ensure_numpy(B.concat(list(parts)))
    if not blk:
        return {}
    rows = []
    if key is None:
        row = {}
        for kind, col, out in aggs:
            row[out] = _agg_one(kind, blk[col] if col else next(iter(blk.values())))
        rows.append(row)
    else:
        keys = blk[key]
        uniq, inv = np.unique(keys, return_inverse=True)
        for gi, kval in enumerate(uniq):
            idx = np.nonzero(inv == gi)[0]
            row = {key: kval}
            for kind, col, out in aggs:
                row[out] = _agg_one(kind, blk[col][idx] if col else idx)
            rows.append(row)
    return B.from_rows(rows)


@ray_tpu_torch.remote
def _map_groups(key, fn, batch_format, *parts):
    blk = B.ensure_numpy(B.concat(list(parts)))
    if not blk:
        return {}
    keys = blk[key]
    uniq, inv = np.unique(keys, return_inverse=True)
    outs = []
    for gi in range(len(uniq)):
        idx = np.nonzero(inv == gi)[0]
        group = B.take_idx(blk, idx)
        outs.append(B.from_batch(fn(B.to_batch(group, batch_format))))
    return B.concat(outs)


@ray_tpu_torch.remote
def _zip_blocks(meta, left, *rights):
    right = B.ensure_numpy(
        B.concat([B.slice_block(rights[i], s, e) for i, s, e in meta])
    )
    out = dict(B.ensure_numpy(left))
    for k, v in right.items():
        out[k if k not in out else k + "_1"] = v
    return out


# --------------------------------------------------------------------------
# Driver-side stages.
# --------------------------------------------------------------------------

def _windowed(submit, inputs, window: int) -> Iterator:
    """Submit with a bounded in-flight window — the backpressure primitive
    (reference: backpressure_policy/concurrency_cap_backpressure_policy.py)."""
    pending = collections.deque()
    for item in inputs:
        pending.append(submit(item))
        if len(pending) >= window:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def _chain_spec(ops: list[P.Op]) -> list:
    chain = []
    for op in ops:
        if op.kind == "map_batches":
            chain.append(("map_batches", op.fn, op.batch_size, op.batch_format,
                          op.fn_args, op.fn_kwargs))
        elif op.kind in ("map", "filter", "flat_map"):
            chain.append((op.kind, op.fn))
        elif op.kind == "add_column":
            chain.append(("add_column", op.col_name, op.fn))
        elif op.kind in ("drop_columns", "select_columns"):
            chain.append((op.kind, op.cols))
        else:
            raise AssertionError(op.kind)
    return chain


def _counts(refs: list) -> list[int]:
    return ray_tpu_torch.get([_count_rows.remote(r) for r in refs])


def _slice_plan(counts: list[int], n_out: int) -> list[list[tuple]]:
    """Global row-ranges → n_out balanced output partitions."""
    total = sum(counts)
    starts = [round(j * total / n_out) for j in range(n_out + 1)]
    plans: list[list[tuple]] = [[] for _ in range(n_out)]
    offset = 0
    for i, c in enumerate(counts):
        for j in range(n_out):
            lo, hi = max(starts[j], offset), min(starts[j + 1], offset + c)
            if lo < hi:
                plans[j].append((i, lo - offset, hi - offset))
        offset += c
    return plans


def execute(plan: P.LogicalPlan, ctx: DataContext | None = None) -> Iterator:
    """Yield output block refs for the plan, streaming where possible."""
    ctx = ctx or DataContext.get_current()
    ops = list(plan.ops)
    stream: Iterator = iter(())
    i = 0
    while i < len(ops):
        op = ops[i]
        if op.kind == "ref_source":
            stream = iter(op.refs)
            i += 1
            continue
        # ---- fuse a run of map-like ops into one stage
        is_actor_map = op.kind == "map_batches" and op.compute == "actors"
        if (op.kind in _FUSABLE and not is_actor_map) or op.kind == "read":
            j = i + (1 if op.kind == "read" else 0)
            while j < len(ops) and ops[j].kind in _FUSABLE:
                # actor-compute map_batches breaks fusion at its boundary
                if ops[j].kind == "map_batches" and ops[j].compute == "actors":
                    break
                j += 1
            fused = ops[i:j] if op.kind != "read" else ops[i + 1 : j]
            chain = _chain_spec(fused)
            cap = None  # explicit user concurrency cap survives fusion
            for f in fused:
                if getattr(f, "concurrency", None):
                    cap = f.concurrency if cap is None else min(cap, f.concurrency)
            if op.kind == "read":
                window = cap if cap else max(ctx.prefetch_blocks,
                                             ctx.parallelism())
                stream = _windowed(lambda t, c=chain: _exec_read.remote(t, c),
                                   iter(op.tasks), window)
            else:
                window = cap if cap else ctx.prefetch_blocks
                stream = _windowed(lambda r, c=chain: _exec_chain.remote(c, r),
                                   stream, window)
            i = j
            continue
        if op.kind == "map_batches" and op.compute == "actors":
            # actor pool stage: round-robin blocks over n stateful actors
            j = i + 1
            while j < len(ops) and ops[j].kind in _FUSABLE and not (
                ops[j].kind == "map_batches" and ops[j].compute == "actors"
            ):
                j += 1
            rest = _chain_spec(ops[i + 1 : j])
            n_actors = op.concurrency or 2
            actors = [_MapActor.remote(op.fn, op.fn_constructor_args, rest)
                      for _ in range(n_actors)]
            rr = [0]

            def submit(r, _op=op, _actors=actors, _rr=rr):
                a = _actors[_rr[0] % len(_actors)]
                _rr[0] += 1
                return a.apply.remote(_op.batch_size, _op.batch_format,
                                      _op.fn_args, _op.fn_kwargs, r)

            def actor_stage(up, _actors=actors, _n=n_actors):
                inner = _windowed(submit, up, max(2, 2 * _n))
                try:
                    yield from inner
                finally:
                    # Drain in-flight calls, then release the leased
                    # workers — actors would otherwise pin CPUs forever.
                    for a in _actors:
                        try:
                            ray_tpu_torch.kill(a)
                        # tpulint: allow(broad-except reason=stage teardown; an actor that already died released its lease, which is all kill is for here)
                        except Exception:  # noqa: BLE001
                            pass

            stream = actor_stage(stream)
            i = j
            continue
        # ---- all-to-all / terminal ops materialize upstream refs
        if op.kind == "repartition":
            refs = list(stream)
            counts = _counts(refs)
            plans = _slice_plan(counts, op.n)
            outs = []
            for pl in plans:
                order = sorted({t[0] for t in pl})
                outs.append(_slice_concat.remote(_localize(pl), *[refs[k] for k in order]))
            stream = iter(outs)
        elif op.kind == "random_shuffle":
            refs = list(stream)
            n = op.n_out or ctx.shuffle_partitions or len(refs) or 1
            if op.seed is not None:
                base = op.seed
            else:  # fresh order every execution, like an unseeded shuffle
                import os as _os

                base = int.from_bytes(_os.urandom(4), "little")
            mapped = [_shuffle_map.options(num_returns=n).remote(n, base + mi, r)
                      for mi, r in enumerate(refs)]
            mapped = [m if isinstance(m, list) else [m] for m in mapped]
            stream = iter([
                _shuffle_reduce.remote(base ^ (j + 1), *[m[j] for m in mapped])
                for j in range(n)
            ])
        elif op.kind == "sort":
            refs = list(stream)
            n = len(refs) or 1
            samples = ray_tpu_torch.get([_sample_keys.remote(op.key, 20, r) for r in refs])
            allkeys = np.sort(np.concatenate([s for s in samples if len(s)]) if any(
                len(s) for s in samples) else np.array([]))
            if len(allkeys) and n > 1:
                bidx = np.linspace(0, len(allkeys) - 1, num=n + 1).astype(int)[1:-1]
                boundaries = allkeys[bidx]
            else:
                boundaries = allkeys[:0]
            nparts = len(boundaries) + 1
            mapped = [_range_part.options(num_returns=nparts).remote(op.key, boundaries, r)
                      for r in refs]
            mapped = [m if isinstance(m, list) else [m] for m in mapped]
            out = [_merge_sorted.remote(op.key, op.descending, *[m[j] for m in mapped])
                   for j in range(nparts)]
            stream = iter(out[::-1] if op.descending else out)
        elif op.kind == "limit":
            stream = _limit_stream(stream, op.n)
        elif op.kind == "union":
            streams = [stream] + [execute(p, ctx) for p in op.others]
            stream = (r for s in streams for r in s)
        elif op.kind == "zip":
            refs = list(stream)
            rrefs = list(execute(op.other, ctx))
            lcounts, rcounts = _counts(refs), _counts(rrefs)
            if sum(lcounts) != sum(rcounts):
                raise ValueError("zip requires equal row counts "
                                 f"({sum(lcounts)} vs {sum(rcounts)})")
            plans = _row_align(lcounts, rcounts)
            stream = iter([
                _zip_blocks.remote(_localize(pl), refs[li],
                                   *[rrefs[k] for k in sorted({t[0] for t in pl})])
                for li, pl in enumerate(plans)
            ])
        elif op.kind == "join":
            # Hash join (reference: hash-shuffle join operators,
            # data/_internal/execution/operators/hash_shuffle.py):
            # both sides hash-partition on the key; partition j of the
            # left joins partition j of the right.
            lrefs = list(stream)
            rrefs = list(execute(op.other, ctx))
            n = op.n_out or max(min(len(lrefs) + len(rrefs), 8), 1)
            # Side schemas travel to every partition so a block whose
            # partition got rows from only ONE side still emits (and
            # null-fills) the other side's columns.
            lschema = _first_schema(lrefs)
            rschema = _first_schema(rrefs)
            lmap = [_hash_part.options(num_returns=n).remote(op.on, n, r)
                    for r in lrefs]
            rmap = [_hash_part.options(num_returns=n).remote(op.on, n, r)
                    for r in rrefs]
            lmap = [m if isinstance(m, list) else [m] for m in lmap]
            rmap = [m if isinstance(m, list) else [m] for m in rmap]
            stream = iter([
                _hash_join.remote(
                    op.on, op.how, op.suffix, lschema, rschema, len(lmap),
                    *[m[j] for m in lmap], *[m[j] for m in rmap],
                )
                for j in range(n)
            ])
        elif op.kind in ("aggregate", "map_groups"):
            refs = list(stream)
            if op.kind == "aggregate" and op.key is None:
                partials = [_agg_partition.remote(None, op.aggs, r) for r in refs]
                stream = iter([_combine_global.remote(op.aggs, *partials)])
            else:
                n = op.n_out or min(len(refs), 8) or 1
                mapped = [_hash_part.options(num_returns=n).remote(op.key, n, r)
                          for r in refs]
                mapped = [m if isinstance(m, list) else [m] for m in mapped]
                if op.kind == "aggregate":
                    stream = iter([
                        _agg_partition.remote(op.key, op.aggs, *[m[j] for m in mapped])
                        for j in range(n)
                    ])
                else:
                    stream = iter([
                        _map_groups.remote(op.key, op.fn, op.batch_format,
                                           *[m[j] for m in mapped])
                        for j in range(n)
                    ])
        else:
            raise NotImplementedError(op.kind)
        i += 1
    return stream


@ray_tpu_torch.remote
def _block_schema(blk):
    blk = B.ensure_numpy(blk)
    return {c: str(blk[c].dtype) for c in blk}


def _first_schema(refs) -> dict:
    """{col: dtype str} from the first non-empty block of a ref list.
    Probes one block at a time — most datasets answer on the first."""
    for r in refs:
        schema = ray_tpu_torch.get(_block_schema.remote(r))
        if schema:
            return schema
    return {}


def _join_fill(dtype, n: int) -> np.ndarray:
    """Null-fill column for unmatched join rows: NaN for numerics
    (ints promote to float), None objects otherwise."""
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.number):
        return np.full(n, np.nan)
    out = np.empty(n, dtype=object)
    out[:] = None
    return out


@ray_tpu_torch.remote
def _hash_join(on, how, suffix, lschema, rschema, n_left, *parts):
    # Join inputs can arrive as Arrow tables (direct joins without a
    # repartition pass); the kernel does numpy column math throughout.
    parts = tuple(B.ensure_numpy(p) for p in parts)
    left = [p for p in parts[:n_left] if p]
    right = [p for p in parts[n_left:] if p]
    left = B.concat(left) if left else {}
    right = B.concat(right) if right else {}
    if not left and not right:
        return {}

    index: dict = {}
    n_right = B.num_rows(right) if right else 0
    if right:
        for j, k in enumerate(right[on].tolist()):
            index.setdefault(k, []).append(j)
    li: list[int] = []
    ri: list[int] = []
    left_unmatched: list[int] = []
    matched_right: set = set()
    if left:
        for i, k in enumerate(left[on].tolist()):
            hits = index.get(k)
            if hits:
                for j in hits:
                    li.append(i)
                    ri.append(j)
                    matched_right.add(j)
            else:
                left_unmatched.append(i)
    if how not in ("left", "outer"):
        left_unmatched = []
    right_unmatched = (
        [j for j in range(n_right) if j not in matched_right]
        if how in ("right", "outer")
        else []
    )

    li_a = np.asarray(li, dtype=np.int64)
    ri_a = np.asarray(ri, dtype=np.int64)
    lu_a = np.asarray(left_unmatched, dtype=np.int64)
    ru_a = np.asarray(right_unmatched, dtype=np.int64)

    out: dict = {}
    # Key column: sourced from whichever side each row group came from.
    key_parts = []
    if left:
        key_parts += [left[on][li_a], left[on][lu_a]]
    if right and len(ru_a):
        key_parts.append(right[on][ru_a])
    out[on] = (
        np.concatenate(key_parts) if key_parts else np.array([])
    )
    # Schemas (not this partition's blocks) define the column set, so a
    # one-sided partition still emits the other side's columns as nulls.
    left_cols = [c for c in lschema if c != on]
    right_cols = [c for c in rschema if c != on]
    n_matched = len(li_a)
    for c in left_cols:
        if left:
            col = left[c]
            out[c] = np.concatenate(
                [col[li_a], col[lu_a], _join_fill(col.dtype, len(ru_a))]
            )
        else:
            out[c] = _join_fill(lschema[c], n_matched + len(lu_a) + len(ru_a))
    for c in right_cols:
        name = f"{c}{suffix}" if c in lschema else c
        if right:
            col = right[c]
            out[name] = np.concatenate(
                [col[ri_a], _join_fill(col.dtype, len(lu_a)), col[ru_a]]
            )
        else:
            out[name] = _join_fill(
                rschema[c], n_matched + len(lu_a) + len(ru_a)
            )
    return out


@ray_tpu_torch.remote
def _combine_global(aggs, *partials):
    blk = B.concat([p for p in partials if p])
    row = {}
    for kind, col, out in aggs:
        vals = blk[out]
        if kind == "count":
            row[out] = np.sum(vals)
        elif kind == "mean":
            row[out] = np.mean(vals)  # exact only for equal partitions; partial means
        elif kind in ("sum", "min", "max"):
            row[out] = _agg_one(kind, vals)
        else:
            row[out] = _agg_one(kind, vals)
    return B.from_rows([row])


def _localize(pl: list[tuple]) -> list[tuple]:
    """Rewrite input indices in a slice plan to positional arg indices."""
    order = sorted({t[0] for t in pl})
    remap = {k: i for i, k in enumerate(order)}
    return [(remap[i], s, e) for i, s, e in pl]


def _row_align(lcounts: list[int], rcounts: list[int]) -> list[list[tuple]]:
    """For each left block, the (right_idx, start, end) ranges covering the
    same global rows."""
    plans = []
    roffsets = np.cumsum([0] + rcounts)
    goff = 0
    for lc in lcounts:
        lo, hi = goff, goff + lc
        pl = []
        for ri in range(len(rcounts)):
            rlo, rhi = roffsets[ri], roffsets[ri + 1]
            a, b = max(lo, rlo), min(hi, rhi)
            if a < b:
                pl.append((ri, int(a - rlo), int(b - rlo)))
        plans.append(pl)
        goff = hi
    return plans


def _limit_stream(stream: Iterator, n: int) -> Iterator:
    remaining = n
    for ref in stream:
        if remaining <= 0:
            return
        cnt = ray_tpu_torch.get(_count_rows.remote(ref))
        if cnt <= remaining:
            remaining -= cnt
            yield ref
        else:
            yield _head.remote(ref, remaining)
            remaining = 0
