"""Cross-language function registry: Python functions callable from
non-Python drivers by NAME with msgpack arguments.

Reference: the cross-language model in python/ray/cross_language.py +
cpp/include/ray/api/ray_remote.h — callees register functions under
stable descriptors, callers in another language submit tasks naming the
descriptor, and arguments/results cross the boundary as msgpack (the
reference's cross-language serialization format), never pickle.

Here a registered function lives in the head KV under ``xfn:<name>``
(the same export path pickled Python tasks use — workers fetch and
cache by id); a foreign driver (the C++ client in
ray_tpu_torch/cpp/) leases a worker and pushes
a task spec with ``fn_id="xfn:<name>"``, ``xlang=True`` and
msgpack-encoded args; the worker replies with a msgpack-encoded result
inline.
"""

from __future__ import annotations

from typing import Callable


def register_function(name: str, fn: Callable) -> str:
    """Publish ``fn`` under ``xfn:<name>`` for cross-language callers.
    Arguments arrive as plain msgpack data (numbers, strings, bytes,
    lists, maps); the return value must be msgpack-encodable the same
    way."""
    if ":" in name:
        raise ValueError(f"cross-language names must not contain ':': {name!r}")
    from ray_tpu_torch import api as core_api
    from ray_tpu_torch.runtime.core_worker import serialize

    rt = core_api._runtime
    blob = serialize(fn).materialize_buffers()

    async def put():
        await rt.core.head.call(
            "kv_put",
            key=f"xfn:{name}",
            value=blob.inband + b"".join(blob.buffers),
            overwrite=True,
        )

    rt.run(put())
    return f"xfn:{name}"


def unregister_function(name: str) -> None:
    from ray_tpu_torch import api as core_api

    rt = core_api._runtime

    async def drop():
        await rt.core.head.call("kv_del", key=f"xfn:{name}")

    rt.run(drop())
