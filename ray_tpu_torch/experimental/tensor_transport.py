"""TPU-object helpers: refs produced with ``tensor_transport`` keep their
payload in the producing actor's device-tensor store; these helpers
inspect and free them (reference:
python/ray/experimental/gpu_object_manager/gpu_object_manager.py)."""

from __future__ import annotations

from typing import Sequence


def _owner_call(ref, method: str, **kw):
    import ray_tpu_torch.api as api

    rt = api._runtime

    async def call():
        conn = await rt.core._connect(ref.owner_addr)
        return await conn.call(method, oid_hex=ref.hex, **kw)

    return rt.run(call())


def tensor_meta(ref) -> dict | None:
    """Location metadata of a tensor-transport ref (None when the ref is
    not tensor-backed from this process's view)."""
    import ray_tpu_torch.api as api

    rt = api._runtime
    rec = rt.core.memory.get(ref.hex)
    if rec is not None:
        return dict(rec[1]) if rec[0] == "tensor" else None
    reply = _owner_call(ref, "get_object")
    if reply.get("kind") == "tensor":
        return dict(reply["meta"])
    return None


def free_tensors(refs: Sequence) -> int:
    """Explicitly drop the device payloads behind tensor-transport refs
    (producers keep tensors pinned until freed). Returns the number
    actually freed."""
    import ray_tpu_torch.api as api

    rt = api._runtime
    n = 0
    for ref in refs:
        rec = rt.core.memory.get(ref.hex)
        if rec is not None and rec[0] == "tensor":
            # This process owns the record: free directly.
            n += bool(rt.run(rt.core.free_tensor(ref.hex)))
        else:
            reply = _owner_call(ref, "free_tensor")
            n += bool(reply.get("ok"))
    return n
