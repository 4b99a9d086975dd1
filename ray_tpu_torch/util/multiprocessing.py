"""multiprocessing.Pool shim over cluster tasks.

Reference: python/ray/util/multiprocessing/pool.py — drop-in Pool whose
workers are cluster processes, so `Pool.map` scales past one host.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable

import ray_tpu_torch


class AsyncResult:
    def __init__(self, refs: list, single: bool, on_consumed=None):
        self._refs = refs
        self._single = single
        self._on_consumed = on_consumed

    def _consumed(self):
        if self._on_consumed is not None:
            self._on_consumed(self._refs)
            self._on_consumed = None

    def get(self, timeout: float | None = None):
        from ray_tpu_torch.exceptions import GetTimeoutError

        try:
            results = ray_tpu_torch.get(self._refs, timeout=timeout)
        except GetTimeoutError:
            raise  # still in flight: keep the refs tracked
        except Exception:
            self._consumed()  # terminal task error: don't pin the refs
            raise
        self._consumed()
        return results[0] if self._single else results

    def wait(self, timeout: float | None = None):
        ray_tpu_torch.wait(
            self._refs, num_returns=len(self._refs), timeout=timeout
        )

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(
            self._refs, num_returns=len(self._refs), timeout=0
        )
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            # stdlib contract: raises rather than conflating "pending"
            # with "failed".
            raise ValueError("result is not ready")
        try:
            self.get(timeout=0)
            return True
        # tpulint: allow(broad-except reason=stdlib AsyncResult.successful() contract: ANY task error means False; the error itself is re-raised by get())
        except Exception:  # noqa: BLE001
            return False


class Pool:
    """Chunked task fan-out. `processes` bounds in-flight chunks on the
    lazy paths (map/starmap/imap*); the *_async paths submit everything
    up front since they must return immediately."""

    def __init__(self, processes: int | None = None):
        self._processes = processes or 8
        self._run_chunk = ray_tpu_torch.remote(_run_chunk)
        self._closed = False
        self._terminated = False
        # Refs handed out via *_async: join() after close() must block on
        # them. Consumed results are pruned so the pool doesn't pin every
        # historical result in the object store.
        self._outstanding: list = []

    def _drop_refs(self, refs: list):
        ids = {id(r) for r in refs}
        self._outstanding = [
            r for r in self._outstanding if id(r) not in ids
        ]

    def _windowed(self, fn, chunks, star: bool):
        """Yield chunk results in order with ≤ `processes` in flight."""
        chunks = list(chunks)
        inflight: list = []
        next_submit = 0
        for i in range(len(chunks)):
            while next_submit < len(chunks) and (
                len(inflight) < self._processes
            ):
                inflight.append(
                    self._run_chunk.remote(fn, chunks[next_submit], star)
                )
                next_submit += 1
            yield ray_tpu_torch.get(inflight.pop(0))

    def _chunks(self, iterable: Iterable, chunksize: int | None):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        for i in range(0, len(items), chunksize):
            yield items[i : i + chunksize]

    def map(self, fn: Callable, iterable: Iterable, chunksize=None) -> list:
        self._check_open()
        return list(
            itertools.chain.from_iterable(
                self._windowed(fn, self._chunks(iterable, chunksize), False)
            )
        )

    def map_async(self, fn, iterable, chunksize=None) -> AsyncResult:
        self._check_open()
        refs = [
            self._run_chunk.remote(fn, chunk, False)
            for chunk in self._chunks(iterable, chunksize)
        ]
        self._outstanding.extend(refs)
        return _FlattenResult(refs, on_consumed=self._drop_refs)

    def starmap(self, fn, iterable, chunksize=None) -> list:
        self._check_open()
        return list(
            itertools.chain.from_iterable(
                self._windowed(fn, self._chunks(iterable, chunksize), True)
            )
        )

    def apply(self, fn, args=(), kwds=None) -> Any:
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn, args=(), kwds=None) -> AsyncResult:
        self._check_open()
        task = ray_tpu_torch.remote(fn)
        ref = task.remote(*args, **(kwds or {}))
        self._outstanding.append(ref)
        return AsyncResult([ref], single=True, on_consumed=self._drop_refs)

    def imap(self, fn, iterable, chunksize=1):
        self._check_open()
        for chunk_result in self._windowed(
            fn, self._chunks(iterable, chunksize), False
        ):
            yield from chunk_result

    def imap_unordered(self, fn, iterable, chunksize=1):
        self._check_open()
        chunks = list(self._chunks(iterable, chunksize))
        inflight: list = []
        next_submit = 0
        while next_submit < len(chunks) or inflight:
            while next_submit < len(chunks) and (
                len(inflight) < self._processes
            ):
                inflight.append(
                    self._run_chunk.remote(fn, chunks[next_submit], False)
                )
                next_submit += 1
            ready, inflight = ray_tpu_torch.wait(inflight, num_returns=1)
            for ref in ready:  # wait may report more than num_returns
                yield from ray_tpu_torch.get(ref)

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        self._terminated = True  # join() must NOT wait for abandoned work

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still open")
        # stdlib contract: close()+join() waits for outstanding work;
        # terminate()+join() returns without completing it.
        if self._outstanding and not self._terminated:
            ray_tpu_torch.wait(
                self._outstanding,
                num_returns=len(self._outstanding),
                timeout=None,
            )
        self._outstanding = []

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool not running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()


class _FlattenResult(AsyncResult):
    def __init__(self, refs: list, on_consumed=None):
        super().__init__(refs, single=False, on_consumed=on_consumed)

    def get(self, timeout: float | None = None):
        out = list(
            itertools.chain.from_iterable(
                ray_tpu_torch.get(self._refs, timeout=timeout)
            )
        )
        self._consumed()
        return out


def _run_chunk(fn: Callable, chunk: list, star: bool) -> list:
    if star:
        return [fn(*item) for item in chunk]
    return [fn(item) for item in chunk]
