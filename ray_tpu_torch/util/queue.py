"""Distributed FIFO queue backed by an actor.

Reference: python/ray/util/queue.py — Queue wraps an asyncio.Queue inside
a _QueueActor; put/get work from any process holding the handle.
"""

from __future__ import annotations

import asyncio
import queue as _stdlib_queue
from typing import Any

import ray_tpu_torch


class Empty(_stdlib_queue.Empty):
    """Subclasses queue.Empty so `except queue.Empty` keeps working."""


class Full(_stdlib_queue.Full):
    """Subclasses queue.Full so `except queue.Full` keeps working."""


class _QueueActor:
    def __init__(self, maxsize: int):
        self.q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)

    async def put(self, item, timeout: float | None = None):
        if timeout is None:
            await self.q.put(item)
            return True
        try:
            await asyncio.wait_for(self.q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: float | None = None):
        if timeout is None:
            return (True, await self.q.get())
        try:
            return (True, await asyncio.wait_for(self.q.get(), timeout))
        except asyncio.TimeoutError:
            return (False, None)

    def put_nowait(self, item) -> bool:
        try:
            self.q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    def get_nowait(self):
        try:
            return (True, self.q.get_nowait())
        except asyncio.QueueEmpty:
            return (False, None)

    def qsize(self) -> int:
        return self.q.qsize()

    def empty(self) -> bool:
        return self.q.empty()

    def full(self) -> bool:
        return self.q.full()


class Queue:
    def __init__(self, maxsize: int = 0, *, actor_options: dict | None = None):
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0.01)
        cls = ray_tpu_torch.remote(_QueueActor)
        self.actor = cls.options(**opts).remote(maxsize)

    def put(self, item: Any, block: bool = True, timeout: float | None = None):
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full()
            return
        ok = ray_tpu_torch.get(self.actor.put.remote(item, timeout))
        if not ok:
            raise Full()

    def get(self, block: bool = True, timeout: float | None = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty()
            return item
        ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty()
        return item

    def put_nowait(self, item: Any):
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def shutdown(self):
        ray_tpu_torch.kill(self.actor)
