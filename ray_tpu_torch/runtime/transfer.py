"""Pipelined, multi-source chunked object transfer.

(reference: src/ray/object_manager/pull_manager.h:50 — windowed chunk
requests with admission control; push_manager.h:28 — pipelined chunked
pushes; object_buffer_pool.h:32 — chunk assembly into store buffers.
The reference streams 5 MiB chunks one-at-a-time per transfer but keeps
many transfers in flight; here one transfer pipelines a window of chunk
requests and stripes them across every node known to hold a copy, so a
single large pull saturates the link — and a broadcast's later pullers
fan in from the nodes that already finished.)

Used by the core worker's pull path and the node daemon's prefetch
(broadcast relay) path.
"""

from __future__ import annotations

import asyncio

from ray_tpu_torch._private import rpc
from ray_tpu_torch.exceptions import GetTimeoutError, ObjectLostError

CHUNK_BYTES = 5 * 1024 * 1024  # object_manager_default_chunk_size
WINDOW = 8  # in-flight chunk requests per transfer


async def connect_sources(
    holders,
    primary: str | None,
    self_addr: str | None,
    dial,
    fallback=None,
) -> tuple[list, dict]:
    """Dial every candidate holder in parallel and fast-fail the dead.

    Merges ``primary`` + registered ``holders`` (skipping ``self_addr``
    — our own store already missed), dials them concurrently via
    ``dial(addr)``, and appends ``fallback`` (usually the owner's own
    connection) as a last-resort source so evicted/stale holder sets
    can never lose an object the owner still serves. Returns
    ``(conns, addr_by_conn)``; the mapping lets callers report dead
    holders back to the owner's location directory.
    """
    addrs = []
    if primary and primary != self_addr:
        addrs.append(primary)
    for h in holders or ():
        if h != self_addr and h not in addrs:
            addrs.append(h)
    results = await asyncio.gather(
        *(dial(a) for a in addrs), return_exceptions=True
    )
    conns, addr_by_conn = [], {}
    for a, r in zip(addrs, results):
        if isinstance(r, BaseException):
            continue
        conns.append(r)
        addr_by_conn[r] = a
    if fallback is not None and fallback not in conns:
        conns.append(fallback)
    return conns, addr_by_conn


async def pull_object(
    oid_hex: str,
    conns: list,
    timeout: float | None = None,
    chunk_bytes: int = CHUNK_BYTES,
    window: int = WINDOW,
    failed: set | None = None,
) -> tuple[bytes, list[bytes]]:
    """Fetch a store-resident object's segments from one or more holders.

    Returns ``(inband, buffers)``. Chunk requests are pipelined (up to
    ``window`` in flight) and striped round-robin across ``conns``; a
    chunk that fails on one holder (dead connection, evicted copy) is
    retried on the others. ``timeout`` bounds the WHOLE pull. Callers
    passing ``failed`` receive the connections that proved dead or
    copyless — report them to the owner's location directory.
    """
    if not conns:
        raise ObjectLostError(f"object {oid_hex[:12]}…: no holders to pull")
    loop = asyncio.get_running_loop()
    deadline = None if timeout is None else loop.time() + timeout

    def remaining():
        if deadline is None:
            return None
        left = deadline - loop.time()
        if left <= 0:
            raise GetTimeoutError(f"timed out pulling {oid_hex[:12]}…")
        return left

    # Meta from the first holder that answers; the rest may be stale.
    meta = None
    dead: set = set()
    for c in conns:
        try:
            m = await asyncio.wait_for(
                c.call("get_object_meta", oid_hex=oid_hex), remaining()
            )
        except asyncio.TimeoutError:
            raise GetTimeoutError(f"timed out pulling {oid_hex[:12]}…")
        except (rpc.ConnectionLost, rpc.RpcError):
            dead.add(c)
            continue
        if m.get("ok"):
            meta = m
            break
        dead.add(c)
    if meta is None:
        raise ObjectLostError(
            f"object {oid_hex[:12]}… vanished from every holder's store"
        )
    total = meta["total"]
    offsets = list(range(0, total, chunk_bytes))
    # Preallocate the segment buffers and write each arriving chunk
    # straight into place — assembling via a parts list + join + slice
    # would add ~3 object-sized transient copies per pull (reference:
    # object_buffer_pool.h writes chunks into the plasma buffer
    # directly for the same reason).
    seg_lens = meta["seg_lens"]
    segs = [bytearray(n) for n in seg_lens]
    seg_starts = []
    pos = 0
    for n in seg_lens:
        seg_starts.append(pos)
        pos += n

    def place(off: int, data: bytes):
        dpos = 0
        for start, buf in zip(seg_starts, segs):
            end = start + len(buf)
            if off + len(data) <= start or off >= end:
                continue
            s = max(off, start)
            e = min(off + len(data), end)
            memoryview(buf)[s - start : e - start] = memoryview(data)[
                s - off : e - off
            ]
            dpos += e - s
        return dpos

    sem = asyncio.Semaphore(window)

    async def fetch(i: int, off: int):
        async with sem:
            start = i % len(conns)
            order = conns[start:] + conns[:start]
            last_err: Exception | None = None
            for c in order:
                if c in dead:
                    continue
                try:
                    r = await asyncio.wait_for(
                        c.call(
                            "get_object_chunk",
                            oid_hex=oid_hex,
                            offset=off,
                            size=min(chunk_bytes, total - off),
                        ),
                        remaining(),
                    )
                except asyncio.TimeoutError:
                    raise GetTimeoutError(
                        f"timed out pulling {oid_hex[:12]}…"
                    )
                except (rpc.ConnectionLost, rpc.RpcError) as e:
                    dead.add(c)
                    last_err = e
                    continue
                if r.get("ok"):
                    place(off, r["data"])
                    return
                last_err = ObjectLostError(
                    f"object {oid_hex[:12]}… evicted from a holder "
                    "mid-pull"
                )
            raise last_err or ObjectLostError(
                f"object {oid_hex[:12]}… pull failed on every holder"
            )

    # return_exceptions: let in-flight siblings finish/fail on their own
    # (bounded by the shared deadline) instead of orphaning them, then
    # surface the first failure.
    results = await asyncio.gather(
        *(fetch(i, off) for i, off in enumerate(offsets)),
        return_exceptions=True,
    )
    if failed is not None:
        failed.update(dead)
    for r in results:
        if isinstance(r, BaseException):
            raise r
    # inband must be bytes (pickle stream); payload buffers stay as the
    # preallocated bytearrays (writable buffers deserialize zero-copy).
    return bytes(segs[0]), segs[1:]
