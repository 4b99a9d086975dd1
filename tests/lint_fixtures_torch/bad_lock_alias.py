# tpulint fixture: cross-function lock aliasing (TPU204).
# Line numbers are pinned by tests/test_torch_lint.py — edit with care.
import threading

_table_lock = threading.Lock()


class Flusher:
    def __init__(self, lk):
        self._lk = lk  # aliases Flusher._lk to whatever callers pass

    def flush(self):
        with self._lk:
            pass

    def flush_then_update(self):
        with self._lk:
            with _table_lock:  # TPU204 @ line 18: _lk IS _flush_lock
                pass


_flush_lock = threading.Lock()
_f = Flusher(_flush_lock)


def update_then_flush():
    with _table_lock:
        _f.flush()  # table -> (aliased) flush: closes the cycle


def taker(lk):
    with lk:  # parameterized acquisition
        pass


def pass_through():
    with _flush_lock:
        taker(_table_lock)  # flush -> table via argument aliasing
