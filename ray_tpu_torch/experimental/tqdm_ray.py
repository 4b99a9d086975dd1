"""Distributed progress bars (reference: python/ray/experimental/
tqdm_ray.py — worker-side tqdm shims report through the runtime and the
driver renders aggregated bars without interleaving).

Worker side: ``tqdm(iterable, ...)`` publishes rate-limited progress
snapshots to the head's "tqdm" pubsub channel. Driver side:
``enable_display()`` subscribes and renders one line per live bar to
stderr (plain lines, no cursor games — safe under pytest and log
capture)."""

from __future__ import annotations

import sys
import time
import uuid


class tqdm:
    """Drop-in minimal tqdm: iterable wrapper or manual update()."""

    def __init__(
        self,
        iterable=None,
        desc: str = "",
        total: int | None = None,
        position: int | None = None,  # accepted for API compat
        flush_interval_s: float = 0.5,
    ):
        self._iterable = iterable
        self.desc = desc
        self.total = total
        if total is None and iterable is not None:
            try:
                self.total = len(iterable)
            except TypeError:
                pass
        self.n = 0
        self._uuid = uuid.uuid4().hex[:12]
        self._flush_interval = flush_interval_s
        self._last_flush = 0.0
        self._closed = False

    # -- protocol ------------------------------------------------------
    def __iter__(self):
        try:
            for item in self._iterable:
                yield item
                self.update(1)
        finally:
            # Runs on break/exception too (GeneratorExit lands at the
            # yield) so the display always sees the bar finish.
            self.close()

    def update(self, n: int = 1):
        self.n += n
        now = time.monotonic()
        if now - self._last_flush >= self._flush_interval:
            self._last_flush = now
            self._publish(done=False)

    def set_description(self, desc: str):
        self.desc = desc

    def close(self):
        if not self._closed:
            self._closed = True
            self._publish(done=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- transport -----------------------------------------------------
    def _publish(self, done: bool):
        try:
            import asyncio

            import ray_tpu_torch.api as api

            rt = api._runtime
            if rt.core is None:
                return
            msg = {
                "uuid": self._uuid,
                "desc": self.desc,
                "n": self.n,
                "total": self.total,
                "done": done,
                "src": rt.core.addr,
            }
            coro = rt.core.head.call("publish", channel="tqdm", msg=msg)
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if running is rt.loop:
                # Already ON the runtime loop (async actor/task code):
                # blocking here would deadlock — fire and forget.
                asyncio.ensure_future(coro)
            else:
                rt.run(coro, timeout=5)
        # tpulint: allow(broad-except reason=progress publishing is best-effort; raising or logging from inside the bar-update path would corrupt the very output it decorates)
        except Exception:  # noqa: BLE001 - progress is best-effort
            pass


# {"head_addr": str, "out": sink} — re-calling swaps the sink, and a new
# cluster (different head) gets a fresh subscription.
_display: dict = {}


def _render_payload(payload):
    if payload.get("channel") != "tqdm":
        return
    # Coalesced ticks arrive as a "batch" list; render each.
    for msg in payload.get("batch") or [payload.get("msg", {})]:
        _render_msg(msg)


def _render_msg(msg):
    total = msg.get("total")
    frac = (
        f"{msg['n']}/{total}" if total else str(msg.get("n", 0))
    )
    state = "done" if msg.get("done") else "…"
    print(
        f"[{msg.get('desc') or msg.get('uuid', '?')}] {frac} {state}",
        file=_display.get("out", sys.stderr),
        flush=True,
    )


def enable_display(out=None) -> None:
    """Driver-side: subscribe to the tqdm channel and print progress
    lines as they arrive. Safe to call again — the latest ``out`` wins,
    and a new cluster re-subscribes."""
    import ray_tpu_torch.api as api

    rt = api._runtime
    _display["out"] = out or sys.stderr
    if _display.get("head_addr") == rt.core.head_addr:
        return  # already subscribed on this cluster; sink swapped above

    async def subscribe():
        from ray_tpu_torch._private import rpc

        conn = await rpc.connect(
            rt.core.head_addr, on_push=_render_payload
        )
        await conn.call("subscribe", channel="tqdm")
        return conn

    # The connection must be HELD: an unreferenced Connection is
    # garbage-collected, its recv task dies with it, and pushes stop
    # (GC timing made this a heisenbug).
    _display["conn"] = rt.run(subscribe())
    _display["head_addr"] = rt.core.head_addr
