"""Per-node dashboard agent: node-local HTTP observability endpoint.

(reference: python/ray/dashboard/agent.py — an aiohttp server on every
node serving node-local metrics, logs, and health directly, so the
dashboard/operators can inspect a node without routing through the
head. Here a minimal asyncio HTTP/1.1 GET server on the node daemon's
event loop; the agent address registers with the head as part of the
node record, and the dashboard links to it per node.)

Endpoints:
    /healthz         {node_id, addr, uptime_s, workers, leases}
    /api/stats       resources, store usage, spill/oom counters
    /api/logs        worker log listing (node-local files)
    /api/logs/<wid>  one worker's log (raw text, ?tail=N bytes)
    /api/train       per-job train goodput (head passthrough)
    /api/serve       per-deployment serve SLO ledger (head passthrough)
    /api/memory      per-node device-memory ledger (head passthrough)
    /api/checkpoints shard-store checkpoint table (head passthrough)
    /metrics         node-local Prometheus text
"""

from __future__ import annotations

import asyncio
import json
import time
import urllib.parse


class NodeAgent:
    def __init__(self, node):
        self.node = node  # NodeManager
        self._server: asyncio.AbstractServer | None = None
        self._t0 = time.monotonic()
        self.addr: str | None = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self._server = await asyncio.start_server(self._conn, host, port)
        p = self._server.sockets[0].getsockname()[1]
        self.addr = f"{host}:{p}"
        return self.addr

    async def stop(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # ---------------------------------------------------------- handlers
    def _healthz(self, query) -> dict:
        n = self.node
        return {
            "node_id": n.node_id,
            "addr": n.addr,
            "uptime_s": round(time.monotonic() - self._t0, 1),
            "workers": len(n.workers),
            "leases": len(n.leases),
            "draining": n.draining,
            "drain_info": n.drain_info,
            "ok": True,
        }

    def _stats(self, query) -> dict:
        n = self.node
        store = n._store()
        return {
            "node_id": n.node_id,
            "resources": n.total,
            "available": n.available,
            "pending_leases": len(n._pending),
            "store_used_bytes": store.used_bytes(),
            "store_capacity_bytes": getattr(store, "capacity_bytes", None),
            "spilled_bytes": n.spilled_bytes,
            "spilled_objects": n.spilled_objects,
            "oom_kills": n.oom_kills,
            "res_version": n._res_version,
            "draining": n.draining,
            "drain_info": n.drain_info,
        }

    async def _logs_list(self, query) -> list:
        n = self.node

        def scan():
            out = []
            if n.log_dir.is_dir():
                for path in sorted(n.log_dir.glob("worker-*.log")):
                    wid = path.name[len("worker-"):-len(".log")]
                    w = n.workers.get(wid)
                    out.append(
                        {
                            "worker_id": wid,
                            "size": path.stat().st_size,
                            "alive": bool(
                                w
                                and w.get("proc")
                                and w["proc"].poll() is None
                            ),
                        }
                    )
            return out

        # Off-loop like _log_text: a glob+stat sweep over a big log dir
        # on slow storage must not stall the scheduling loop.
        return await asyncio.to_thread(scan)

    async def _log_text(self, wid: str, query) -> str | None:
        """Seek+read off-loop: a multi-GB worker log must neither stall
        the node daemon's event loop (it also runs scheduling and the
        resource sync) nor be slurped into memory whole."""
        n = self.node
        tail = int(query.get("tail", ["0"])[0] or 0)
        cap = 16 * 1024 * 1024  # absolute response bound

        def read(path):
            with open(path, "rb") as f:
                f.seek(0, 2)
                size = f.tell()
                want = min(tail or size, cap)
                f.seek(max(0, size - want))
                return f.read(want)

        for path in n.log_dir.glob("worker-*.log"):
            if path.name[len("worker-"):-len(".log")].startswith(wid):
                data = await asyncio.to_thread(read, path)
                return data.decode("utf-8", "replace")
        return None

    async def _train(self, query) -> dict:
        """Head passthrough: per-job train goodput, answerable from any
        node's agent (operators probing a node don't need the driver
        dashboard up)."""
        if self.node.head is None:
            return {"error": "node has no head connection"}
        return await self.node.head.call("train_stats")

    async def _checkpoints(self, query) -> dict:
        """Head passthrough: shard-store checkpoint table (same data as
        the dashboard's /api/checkpoints)."""
        if self.node.head is None:
            return {"error": "node has no head connection"}
        run = query.get("run", [None])[0]
        return await self.node.head.call("ckpt_list", run=run)

    async def _serve(self, query) -> dict:
        """Head passthrough: per-deployment serve SLO ledger (same data
        as the dashboard's /api/serve)."""
        if self.node.head is None:
            return {"error": "node has no head connection"}
        return await self.node.head.call("serve_stats")

    async def _memory(self, query) -> dict:
        """Head passthrough: device-memory ledger (same data as the
        dashboard's /api/memory)."""
        if self.node.head is None:
            return {"error": "node has no head connection"}
        return await self.node.head.call("mem_stats")

    def _metrics(self, query) -> str:
        s = self._stats(query)
        lines = [
            "# TYPE ray_tpu_node_store_used_bytes gauge",
            f"ray_tpu_node_store_used_bytes {s['store_used_bytes']}",
            "# TYPE ray_tpu_node_workers gauge",
            f"ray_tpu_node_workers {len(self.node.workers)}",
            "# TYPE ray_tpu_node_leases gauge",
            f"ray_tpu_node_leases {len(self.node.leases)}",
            "# TYPE ray_tpu_node_spilled_bytes counter",
            f"ray_tpu_node_spilled_bytes {s['spilled_bytes']}",
            "# TYPE ray_tpu_node_oom_kills counter",
            f"ray_tpu_node_oom_kills {s['oom_kills']}",
            "# TYPE ray_tpu_node_draining gauge",
            f"ray_tpu_node_draining {int(self.node.draining)}",
        ]
        for k, v in self.node.available.items():
            lines.append(
                f'ray_tpu_node_available{{resource="{k}"}} {v}'
            )
        return "\n".join(lines) + "\n"

    # -------------------------------------------------------- http layer
    async def _conn(self, reader, writer):
        try:
            line = await reader.readline()
            if not line:
                return
            parts = line.decode("latin-1").split(" ")
            if len(parts) < 2 or parts[0] != "GET":
                await self._send(writer, 405, b"GET only")
                return
            while True:  # drain headers
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
            parsed = urllib.parse.urlparse(parts[1])
            path = parsed.path
            query = urllib.parse.parse_qs(parsed.query)
            if path == "/healthz":
                body, ctype = json.dumps(self._healthz(query)), "application/json"
            elif path == "/api/stats":
                body, ctype = json.dumps(self._stats(query)), "application/json"
            elif path == "/api/logs":
                body, ctype = (
                    json.dumps(await self._logs_list(query)),
                    "application/json",
                )
            elif path.startswith("/api/logs/"):
                text = await self._log_text(path[len("/api/logs/"):], query)
                if text is None:
                    await self._send(writer, 404, b"no such worker log")
                    return
                body, ctype = text, "text/plain"
            elif path == "/api/train":
                body, ctype = (
                    json.dumps(await self._train(query)),
                    "application/json",
                )
            elif path == "/api/checkpoints":
                body, ctype = (
                    json.dumps(await self._checkpoints(query)),
                    "application/json",
                )
            elif path == "/api/serve":
                body, ctype = (
                    json.dumps(await self._serve(query)),
                    "application/json",
                )
            elif path == "/api/memory":
                body, ctype = (
                    json.dumps(await self._memory(query)),
                    "application/json",
                )
            elif path == "/metrics":
                body, ctype = self._metrics(query), "text/plain; version=0.0.4"
            else:
                await self._send(writer, 404, b"not found")
                return
            await self._send(
                writer, 200, body.encode(), ctype
            )
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        # tpulint: allow(broad-except reason=not swallowed - the handler error is returned to the HTTP client as a 500 body)
        except Exception as e:
            try:
                await self._send(writer, 500, repr(e).encode())
            # tpulint: allow(broad-except reason=the client hung up before reading its 500; nobody is left to answer)
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            # tpulint: allow(broad-except reason=socket teardown on an already-broken connection; nothing actionable)
            except Exception:
                pass

    @staticmethod
    async def _send(writer, status, body: bytes, ctype="text/plain"):
        writer.write(
            (
                f"HTTP/1.1 {status} X\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
            ).encode()
            + body
        )
        await writer.drain()
