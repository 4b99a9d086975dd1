# tpulint fixture: lock-discipline (TPU201 / TPU202).
# Line numbers are pinned by tests/test_torch_lint.py — edit with care.
import threading
import time

_table_lock = threading.Lock()
_flush_lock = threading.Lock()


class Head:
    def __init__(self):
        self._lock = threading.Lock()

    def slow_update(self, client):
        with self._lock:
            reply = client.call("sync")  # TPU201 @ line 16 (RPC under lock)
            time.sleep(0.5)  # TPU201 @ line 17
            return reply

    async def bad_async(self, fut):
        with self._lock:
            return await fut  # TPU201 @ line 22 (await under threading lock)


def order_ab():
    with _table_lock:
        with _flush_lock:  # edge table -> flush
            pass


def order_ba():
    with _flush_lock:
        taker()  # edge flush -> table via taker(): closes TPU202 cycle


def taker():
    with _table_lock:
        pass


def ok_fast_section():
    with _table_lock:
        x = 1 + 1
    return x
