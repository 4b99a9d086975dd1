"""Blocks: the unit of data held in the object store.

The reference's block is a pyarrow Table in plasma (reference:
python/ray/data/block.py, `BlockAccessor`; arrow_block.py:213
ArrowBlockAccessor). Here a block is EITHER a **columnar dict of numpy
arrays** — the zero-copy host format for feeding torch input
pipelines — or a **pyarrow Table** (Arrow-native scans keep their
table; see arrow_block.py). Every function below dispatches on the
block kind; ops that need column math call :func:`ensure_numpy` once
at their kernel entry.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator

import numpy as np

try:
    # Eager import so the tensor extension type registers in EVERY
    # process that touches blocks BEFORE any table is deserialized or
    # scanned — a fresh worker reading parquet written elsewhere must
    # already know ray_tpu_torch.tensor or the column degrades to a plain
    # fixed_size_list and loses its shape.
    from ray_tpu_torch.data import arrow_block as _arrow_mod
except ImportError:  # pyarrow not installed: numpy-dict blocks only
    _arrow_mod = None

# A block is dict[str, np.ndarray] | pyarrow.Table; columns share length.
Block = Any


def _arrow():
    if _arrow_mod is None:
        raise ImportError("pyarrow is required for Arrow blocks")
    return _arrow_mod


def _is_table(block) -> bool:
    if isinstance(block, dict) or block is None or _arrow_mod is None:
        return False
    return _arrow_mod.is_arrow_block(block)


def ensure_numpy(block: Block) -> dict:
    """Normalize to the numpy column dict (one conversion, at the edge
    where column math happens — sort/groupby/join kernels)."""
    if _is_table(block):
        return _arrow().numpy_dict_from_table(block)
    return block


def _as_array(values) -> np.ndarray:
    if isinstance(values, np.ndarray):
        return values
    import sys

    torch = sys.modules.get("torch")  # a tensor exists only once torch is imported
    if torch is not None and isinstance(values, torch.Tensor):
        # A tensor column on any device lands on the host. numpy has no
        # bf16, so bf16 becomes float32: exact in value, wider in dtype.
        host = values.detach().cpu()
        if host.dtype == torch.bfloat16:
            host = host.float()
        return host.numpy()
    try:
        arr = np.asarray(values)
    except ValueError:  # ragged rows: numpy >= 1.24 raises, older made objects
        arr = None
    if arr is None or arr.dtype == object:
        # Ragged / mixed values stay as object arrays (mirrors ArrowVariableShapedTensor).
        arr = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            arr[i] = v
    return arr


def from_rows(rows: Iterable[dict]) -> Block:
    rows = list(rows)
    if not rows:
        return {}
    cols: dict[str, list] = {k: [] for k in rows[0]}
    for r in rows:
        if r.keys() != cols.keys():
            for k in r:
                cols.setdefault(k, [None] * (len(next(iter(cols.values()), [])) ))
        for k in cols:
            cols[k].append(r.get(k))
    return {k: _as_array(v) for k, v in cols.items()}


def from_items(items: Iterable[Any]) -> Block:
    items = list(items)
    if items and isinstance(items[0], dict):
        return from_rows(items)
    return {"item": _as_array(items)}


def from_pandas(df) -> Block:
    return {c: df[c].to_numpy() for c in df.columns}


def from_arrow(table) -> Block:
    """Arrow tables ARE blocks now — the scan's table flows through
    the pipeline without an eager numpy copy (conversion happens only
    at a numpy/pandas batch edge or a column-math kernel)."""
    return table


def num_rows(block: Block) -> int:
    if _is_table(block):
        return _arrow().num_rows(block)
    if not block:
        return 0
    return len(next(iter(block.values())))


def size_bytes(block: Block) -> int:
    if _is_table(block):
        return _arrow().size_bytes(block)
    total = 0
    for arr in block.values():
        if arr.dtype == object:
            total += sum(getattr(v, "nbytes", 64) for v in arr)
        else:
            total += arr.nbytes
    return total


def schema(block: Block) -> dict[str, Any]:
    if _is_table(block):
        return _arrow().schema(block)
    return {k: v.dtype for k, v in block.items()}


def slice_block(block: Block, start: int, end: int) -> Block:
    if _is_table(block):
        return _arrow().slice_table(block, start, end)  # zero-copy
    return {k: v[start:end] for k, v in block.items()}


def take_idx(block: Block, idx: np.ndarray) -> Block:
    if _is_table(block):
        return _arrow().take_table(block, idx)
    return {k: v[idx] for k, v in block.items()}


def concat(blocks: list[Block]) -> Block:
    blocks = [b for b in blocks if num_rows(b) > 0]
    if not blocks:
        return {}
    if all(_is_table(b) for b in blocks):
        return _arrow().concat_tables(blocks)
    # Mixed ancestry (an Arrow scan unioned with numpy-born blocks):
    # land on the numpy dict, the canonical compute format.
    blocks = [ensure_numpy(b) for b in blocks]
    keys = blocks[0].keys()
    return {k: np.concatenate([b[k] for b in blocks]) for k in keys}


def to_rows(block: Block) -> Iterator[dict]:
    if _is_table(block):
        yield from _arrow().to_rows(block)
        return
    n = num_rows(block)
    keys = list(block.keys())
    for i in range(n):
        yield {k: block[k][i] for k in keys}


def to_pandas(block: Block):
    import pandas as pd

    if _is_table(block):
        return block.to_pandas()
    return pd.DataFrame({k: list(v) if v.dtype == object else v for k, v in block.items()})


def to_arrow(block: Block):
    """Block → pyarrow Table; ndim>=2 numpy columns become tensor
    extension columns (arrow_block.ArrowTensorType)."""
    if _is_table(block):
        return block
    return _arrow().table_from_numpy_dict(block)


def to_batch(block: Block, batch_format: str):
    """Convert a block to the user-facing batch format."""
    if batch_format in ("numpy", "default", None):
        return ensure_numpy(block) if _is_table(block) else dict(block)
    if batch_format == "pandas":
        return to_pandas(block)
    if batch_format == "pyarrow":
        return to_arrow(block)
    raise ValueError(f"unknown batch_format {batch_format!r}")


def from_batch(batch) -> Block:
    """Normalize a user-returned batch back into a block."""
    if batch is None:
        return {}
    if isinstance(batch, dict):
        return {k: _as_array(v) for k, v in batch.items()}
    try:
        import pandas as pd

        if isinstance(batch, pd.DataFrame):
            return from_pandas(batch)
    except ImportError:
        pass
    try:
        import pyarrow as pa

        if isinstance(batch, pa.Table):
            return batch  # Arrow-native: stays a table
    except ImportError:
        pass
    raise TypeError(f"map_batches must return dict/DataFrame/Table, got {type(batch)}")
