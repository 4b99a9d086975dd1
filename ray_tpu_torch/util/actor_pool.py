"""ActorPool: load-balance tasks over a fixed set of actors.

Reference: python/ray/util/actor_pool.py — same API surface
(submit/get_next/get_next_unordered/map/map_unordered/has_next,
push/pop_idle).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: list):
        self._idle = list(actors)
        self._future_to_actor: dict = {}
        self._index_to_future: dict[int, Any] = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending: list[tuple[Callable, Any]] = []

    def submit(self, fn: Callable, value: Any) -> None:
        """fn(actor, value) -> ObjectRef; queued if no actor is idle."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending.append((fn, value))

    def _drain_pending(self) -> None:
        while self._pending and self._idle:
            fn, value = self._pending.pop(0)
            self.submit(fn, value)

    def has_next(self) -> bool:
        return bool(self._index_to_future or self._pending)

    def get_next(self, timeout: float | None = None) -> Any:
        """Next result in submission order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        idx = self._next_return_index
        if idx not in self._index_to_future:
            self._drain_pending()
        if idx not in self._index_to_future:
            # The index was consumed by get_next_unordered(); ordered and
            # unordered retrieval cannot be mixed for the same tasks.
            raise RuntimeError(
                f"result #{idx} was already taken (mixed get_next with "
                "get_next_unordered?)"
            )
        ref = self._index_to_future[idx]
        if timeout is not None:
            # Probe readiness without consuming pool state: a timeout
            # must leave the result retrievable and the actor tracked.
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=timeout)
            if not ready:
                raise TimeoutError(f"result #{idx} not ready in {timeout}s")
        # Free the actor BEFORE fetching: a task that raised must not
        # wedge the pool (its error re-raises here, but the actor is back
        # in rotation and the index has advanced).
        del self._index_to_future[idx]
        self._next_return_index += 1
        self._idle.append(self._future_to_actor.pop(ref))
        self._drain_pending()
        return ray_tpu_torch.get(ref)

    def get_next_unordered(self, timeout: float | None = None) -> Any:
        """Next result in completion order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        self._drain_pending()
        refs = list(self._index_to_future.values())
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        for idx, r in list(self._index_to_future.items()):
            if r is ref:
                del self._index_to_future[idx]
                break
        self._idle.append(self._future_to_actor.pop(ref))
        self._drain_pending()
        return ray_tpu_torch.get(ref)  # may re-raise the task's error

    def map(self, fn: Callable, values: Iterable) -> Iterator:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable) -> Iterator:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def push(self, actor) -> None:
        self._idle.append(actor)
        self._drain_pending()

    def pop_idle(self):
        return self._idle.pop() if self._idle else None
