# tpulint fixture: CLEAN code for the v2 flow-sensitive rules —
# tests/test_torch_lint.py asserts ZERO findings here. Every shape below is
# the "right way" twin of a bad_* fixture pattern.
import asyncio
import threading
import time

from ray_tpu_torch import collective as col
from ray_tpu_torch import tracing
from ray_tpu_torch.runtime import memory

_table_lock = threading.Lock()
_flush_lock = threading.Lock()


# ---- TPU103: symmetric collectives reach every rank -----------------
def _sync_all(grads):
    return col.allreduce(grads)


def every_rank_syncs(rank, grads):
    # rank-dependent work is fine when the collective is OUTSIDE it
    if rank == 0:
        grads = grads * 2
    return _sync_all(grads)


# ---- TPU104: handles waited, escaped, or collected ------------------
def waited(g, grads):
    h = g.allreduce_async(grads)
    return h.wait()


def collected(g, buckets):
    handles = []
    for b in buckets:
        handles.append(g.reducescatter_async(b))
    return [h.wait() for h in handles]


class Overlapped:
    def stash(self, g, grads):
        self._pending = g.allreduce_async(grads)  # escapes to attr

    def join(self):
        return self._pending.wait()


# ---- TPU203: disciplined async locking ------------------------------
class CleanServer:
    def __init__(self):
        self._lock = threading.Lock()
        self._alock = asyncio.Lock()

    async def awaits_outside(self, fut):
        with self._lock:
            value = 1 + 1
        return await fut

    async def async_lock_async_work(self, fut):
        async with self._alock:
            return await fut

    async def balanced_manual(self):
        await self._alock.acquire()
        try:
            return 42
        finally:
            self._alock.release()

    def sync_blocking_is_tpu201s_business_not_ours(self):
        time.sleep(0)


# ---- TPU204: consistent order through the alias ---------------------
class OrderedFlusher:
    def __init__(self, lk):
        self._lk = lk

    def flush(self):
        with self._lk:
            pass


_of = OrderedFlusher(_flush_lock)


def consistent_order_a():
    with _table_lock:
        _of.flush()


def consistent_order_b():
    with _table_lock:
        with _flush_lock:
            pass


# ---- TPU404: paired resources ---------------------------------------
def with_cm(nbytes):
    with memory.track("fixture.cm", nbytes=nbytes):
        return nbytes


def closed_in_finally(nbytes, payload):
    reg = memory.track("fixture.fin", nbytes=nbytes)
    try:
        return len(payload)
    finally:
        reg.close()


def span_with(payload):
    with tracing.span("fixture:clean"):
        return payload


def enter_exit_in_finally(payload):
    s = tracing.span("fixture:manual")
    s.__enter__()
    try:
        return len(payload)
    finally:
        s.__exit__(None, None, None)
