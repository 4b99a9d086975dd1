"""Arrow-native blocks: pyarrow Tables as first-class dataset blocks,
plus the tensor extension type for multi-dimensional columns.

Reference: python/ray/data/_internal/arrow_block.py:213
``ArrowBlockAccessor`` (the reference's canonical block IS an Arrow
table) and python/ray/air/util/tensor_extensions/arrow.py
``ArrowTensorType``/``ArrowTensorArray`` (fixed-shape ndarrays stored
as FixedSizeList with shape metadata, parquet round-trip included).

The CANONICAL compute block stays a numpy column
dict — that is the zero-copy host format torch feeding wants — but
Arrow tables now flow through the pipeline natively: ``from_arrow``
and the parquet/CSV scans keep the table (no eager numpy copy),
streaming ops that only move rows (slice/take/concat/limit/
repartition/iter_batches) execute on Arrow zero-copy, and
``to_batch(..., "pyarrow")`` hands the table straight to the user.
Ops that do column math (sort/groupby/join/zip/add_column) normalize
to numpy at their kernel entry via ``block.ensure_numpy`` — one
conversion, at the edge where the math happens.
"""

from __future__ import annotations

import atexit
import gc
import json

import numpy as np
import pyarrow as pa

_TENSOR_EXT_NAME = "ray_tpu_torch.tensor"


class ArrowTensorType(pa.ExtensionType):
    """Fixed-shape tensor column: each row is an ndarray of ``shape``,
    stored as FixedSizeList(value_type, prod(shape)) so any Arrow
    consumer (and parquet) can read the flat data; the shape rides in
    the serialized metadata (reference: ArrowTensorType, air/util/
    tensor_extensions/arrow.py)."""

    def __init__(self, shape: tuple, value_type: pa.DataType):
        self._shape = tuple(int(s) for s in shape)
        size = int(np.prod(self._shape)) if self._shape else 1
        super().__init__(
            pa.list_(value_type, size), _TENSOR_EXT_NAME
        )

    @property
    def shape(self) -> tuple:
        return self._shape

    def __arrow_ext_serialize__(self) -> bytes:
        return json.dumps({"shape": list(self._shape)}).encode()

    @classmethod
    def __arrow_ext_deserialize__(cls, storage_type, serialized):
        shape = tuple(json.loads(serialized.decode())["shape"])
        return cls(shape, storage_type.value_type)

    def __arrow_ext_class__(self):
        return ArrowTensorArray


class ArrowTensorArray(pa.ExtensionArray):
    """Array of fixed-shape tensors; ``to_numpy`` reshapes the flat
    storage zero-copy when the buffer layout allows."""

    @staticmethod
    def from_numpy(arr: np.ndarray) -> "ArrowTensorArray":
        if arr.ndim < 2:
            raise ValueError("tensor columns need ndim >= 2")
        n = arr.shape[0]
        shape = arr.shape[1:]
        flat = np.ascontiguousarray(arr).reshape(n, -1)
        value_type = pa.from_numpy_dtype(arr.dtype)
        typ = ArrowTensorType(shape, value_type)
        storage = pa.FixedSizeListArray.from_arrays(
            pa.array(flat.reshape(-1), type=value_type), flat.shape[1]
        )
        return pa.ExtensionArray.from_storage(typ, storage)

    def to_numpy(self, zero_copy_only: bool = False) -> np.ndarray:
        typ: ArrowTensorType = self.type
        flat = self.storage.flatten().to_numpy(
            zero_copy_only=zero_copy_only
        )
        return flat.reshape((len(self),) + typ.shape)


def _register():
    try:
        pa.register_extension_type(
            ArrowTensorType((1,), pa.float32())
        )
    except pa.ArrowKeyError:
        pass  # already registered (re-import)
    # Reading a tensor column leaves reference cycles holding instances
    # of the Python extension type. Collected during interpreter
    # finalization, they take the process down (SIGABRT, "terminate
    # called without an active exception") after its work is done, in a
    # few percent of runs under load; collected before it, never.
    atexit.register(gc.collect)


_register()


# ------------------------------------------------------------ conversion


def table_from_numpy_dict(block: dict) -> pa.Table:
    """numpy column dict → Arrow table; ndim>=2 columns become tensor
    extension columns, object columns fall back to python lists."""
    cols = {}
    for name, arr in block.items():
        arr = np.asarray(arr)
        if arr.ndim >= 2:
            cols[name] = ArrowTensorArray.from_numpy(arr)
        elif arr.dtype == object:
            cols[name] = pa.array(list(arr))
        else:
            cols[name] = pa.array(arr)
    return pa.table(cols)


def numpy_dict_from_table(table: pa.Table) -> dict:
    """Arrow table → numpy column dict (the torch feeding format).
    Tensor extension columns come back as ndarrays with their original
    shape; plain columns convert zero-copy where Arrow allows."""
    out = {}
    for name, col in zip(table.column_names, table.columns):
        col = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
        # ArrowTensorArray.to_numpy reshapes via its override; plain
        # columns convert directly — one call covers both.
        out[name] = col.to_numpy(zero_copy_only=False)
    return out


# -------------------------------------------------------------- accessor


def is_arrow_block(block) -> bool:
    return isinstance(block, pa.Table)


def num_rows(table: pa.Table) -> int:
    return table.num_rows


def size_bytes(table: pa.Table) -> int:
    return table.nbytes


def schema(table: pa.Table) -> dict:
    return {
        name: typ for name, typ in zip(table.schema.names, table.schema.types)
    }


def slice_table(table: pa.Table, start: int, end: int) -> pa.Table:
    """Zero-copy: Arrow slices share buffers."""
    start = max(0, start)
    return table.slice(start, max(0, min(end, table.num_rows) - start))


def take_table(table: pa.Table, idx: np.ndarray) -> pa.Table:
    return table.take(pa.array(np.asarray(idx, dtype=np.int64)))


def concat_tables(tables: list) -> pa.Table:
    return pa.concat_tables([t for t in tables if t.num_rows > 0])


def to_rows(table: pa.Table):
    # Batchwise so a multi-GB table never materializes a full
    # list-of-dicts copy up front.
    for batch in table.to_batches():
        yield from batch.to_pylist()
