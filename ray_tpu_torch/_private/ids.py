"""Binary IDs for jobs, tasks, actors, objects.

TPU-native analogue of the reference's id scheme (reference:
src/ray/common/id.h; spec src/ray/design_docs/id_specification.md): IDs are
fixed-width random byte strings; an ObjectID embeds the TaskID that creates
it plus a return index, giving every object a lineage pointer by
construction.
"""

from __future__ import annotations

import os

_UNIQUE_LEN = 16  # bytes of entropy for task/actor/job ids
_INDEX_LEN = 4  # big-endian return index suffix for object ids


class BaseID:
    __slots__ = ("_bytes",)
    LENGTH = _UNIQUE_LEN

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.LENGTH:
            raise ValueError(
                f"{type(self).__name__} needs {self.LENGTH} bytes, "
                f"got {len(id_bytes)}"
            )
        self._bytes = id_bytes

    @classmethod
    def random(cls):
        return cls(os.urandom(cls.LENGTH))

    @classmethod
    def from_hex(cls, s: str):
        return cls(bytes.fromhex(s))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return hash((type(self).__name__, self._bytes))

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:12]}…)"


class JobID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class FunctionID(BaseID):
    pass


class ObjectID(BaseID):
    """TaskID (16B) + big-endian return index (4B)."""

    LENGTH = _UNIQUE_LEN + _INDEX_LEN

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(_INDEX_LEN, "big"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Puts use the high bit of the index space so they never collide
        # with return indices.
        return cls(
            task_id.binary()
            + (put_index | 0x8000_0000).to_bytes(_INDEX_LEN, "big")
        )

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:_UNIQUE_LEN])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[_UNIQUE_LEN:], "big")
