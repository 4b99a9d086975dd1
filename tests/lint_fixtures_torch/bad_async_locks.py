# tpulint fixture: async-lock discipline (TPU203).
# Line numbers are pinned by tests/test_torch_lint.py — edit with care.
import asyncio
import threading
import time


class Server:
    def __init__(self):
        self._lock = threading.Lock()
        self._alock = asyncio.Lock()

    async def held_across_await(self, fut):
        with self._lock:
            return await fut  # TPU203 @ line 15 (await under threading lock)

    async def blocking_in_async_lock(self):
        async with self._alock:
            time.sleep(0.5)  # TPU203 @ line 19 (loop freeze under asyncio lock)

    async def unbalanced(self, flag):
        await self._alock.acquire()  # TPU203 @ line 22 (release on other path)
        if flag:
            self._alock.release()
            return True
        return False
