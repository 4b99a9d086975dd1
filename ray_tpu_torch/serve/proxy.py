"""Async HTTP proxy actor: routes HTTP requests to application ingress
handles, with streaming (SSE / chunked) responses.

(reference: python/ray/serve/_private/proxy.py:710 HTTPProxy — a fully
async uvicorn/ASGI proxy there with StreamingResponse support; here a
raw asyncio HTTP/1.1 server running on the worker's runtime event loop,
so request handlers await DeploymentHandle calls natively with no
thread hops.)

Request mapping: the ingress deployment is called with a single dict
argument {"method", "path", "query", "headers", "body"} where body is
parsed JSON when the payload is JSON, else raw bytes. A str/bytes return
value is sent verbatim; anything else is JSON-encoded.

Streaming: a request opts in via `Accept: text/event-stream`, a
`?stream=1` query parameter, or a JSON body containing `"stream": true`.
The proxy then makes a streaming handle call (replica generators stream
through the core's ObjectRefGenerator path) and writes each yielded item
as a Server-Sent-Events `data:` frame over chunked transfer encoding,
ending with `data: [DONE]` (the OpenAI wire convention).
"""

from __future__ import annotations

import asyncio
import json
import logging
import urllib.parse

logger = logging.getLogger("ray_tpu_torch.serve")

from ray_tpu_torch.exceptions import NoReplicaAvailableError
from ray_tpu_torch.serve.handle import (
    DeploymentHandle,
    DeploymentStreamResponse,
)

_REQUEST_TIMEOUT_S = 60.0
_BODY_READ_TIMEOUT_S = 30.0
_MAX_BODY = 64 * 1024 * 1024
_MAX_INFLIGHT = 256
_HEX = frozenset(b"0123456789abcdefABCDEF")

_REASONS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    408: "Timeout",
    413: "Payload Too Large",
    500: "Internal",
    503: "Service Unavailable",
}


def _sse_frame(item) -> bytes:
    """One SSE event per yielded item; multi-line payloads get one
    `data:` line each per the SSE spec."""
    if isinstance(item, bytes):
        payload = item.decode("utf-8", "replace")
    elif isinstance(item, str):
        payload = item
    else:
        payload = json.dumps(item)
    lines = payload.split("\n")
    return ("".join(f"data: {ln}\n" for ln in lines) + "\n").encode()


def _chunk(data: bytes) -> bytes:
    return b"%x\r\n%s\r\n" % (len(data), data)


class _BodyTooLarge(Exception):
    pass


class ProxyActor:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        max_body_bytes: int = _MAX_BODY,
        max_inflight: int = _MAX_INFLIGHT,
    ):
        # prefix → (app, ingress, request_timeout_s|None)
        from ray_tpu_torch.serve.routes import RouteTablePoller

        self._poller = RouteTablePoller()
        self._routes: dict[str, tuple] = {}
        self._handles: dict[str, DeploymentHandle] = {}
        self._server: asyncio.AbstractServer | None = None
        self._max_body = max_body_bytes
        self._max_inflight = max_inflight
        self._inflight = 0
        self._stats = {"requests": 0, "streams": 0, "errors": 0,
                       "rejected": 0}
        # Actor __init__ runs on the executor thread; the server must
        # live on the runtime loop where handle calls are native.
        from ray_tpu_torch import api as core_api

        asyncio.run_coroutine_threadsafe(
            self._start(host, port), core_api._runtime.loop
        ).result(timeout=30)

    async def _start(self, host: str, port: int):
        self._server = await asyncio.start_server(
            self._handle_conn, host, port
        )

    def get_port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    def get_stats(self) -> dict:
        return dict(self._stats)

    # ---------------------------------------------------------- routing
    async def _refresh_routes(self, force: bool = False):
        """Poll the controller's route table via the shared poller
        (routes.py — one implementation for the HTTP and gRPC
        ingresses, controller-restart recovery included)."""
        await self._poller.refresh(force)
        self._routes = self._poller.routes

    def _match_route(self, route: str):
        for prefix in sorted(self._routes, key=len, reverse=True):
            if (
                route == prefix
                or route.startswith(prefix.rstrip("/") + "/")
                or prefix == "/"
            ):
                return prefix
        return None

    def _handle_for(self, match: str) -> tuple[DeploymentHandle, float]:
        app_name, ingress, *rest = self._routes[match]
        timeout = (
            rest[0] if rest and rest[0] is not None else _REQUEST_TIMEOUT_S
        )
        handle = self._handles.get(app_name)
        if handle is None or handle.deployment_name != ingress:
            handle = DeploymentHandle(ingress, app_name)
            self._handles[app_name] = handle
        return handle, timeout

    # ------------------------------------------------------- connection
    async def _handle_conn(self, reader, writer):
        try:
            while True:
                keep_alive = await self._handle_one(reader, writer)
                if not keep_alive:
                    break
        except (
            asyncio.IncompleteReadError,
            ConnectionResetError,
            BrokenPipeError,
            TimeoutError,
        ):
            pass
        except Exception:  # noqa: BLE001 - never kill the accept loop
            self._stats["errors"] += 1
            logger.warning(
                "proxy connection handler crashed", exc_info=True
            )
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            # tpulint: allow(broad-except reason=closing a client socket that may already be reset; the request outcome was decided above)
            except Exception:  # noqa: BLE001
                pass

    async def _handle_one(self, reader, writer) -> bool:
        request_line = await reader.readline()
        if not request_line:
            return False
        try:
            method, target, version = (
                request_line.decode("latin-1").rstrip("\r\n").split(" ", 2)
            )
        except ValueError:
            await self._respond(writer, 500, b"malformed request line")
            return False
        headers: dict[str, str] = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            if b":" in line:
                k, v = line.decode("latin-1").split(":", 1)
                k = k.strip().lower()
                v = v.strip()
                if k in headers:
                    # RFC 9110 field-line merging; Cookie is special-cased
                    # per RFC 6265 (semicolon-joined, order preserved).
                    sep = "; " if k == "cookie" else ", "
                    headers[k] = headers[k] + sep + v
                else:
                    headers[k] = v
        # Shed load BEFORE buffering the body: the cap must bound body
        # memory, not just dispatch concurrency, so the slot is claimed
        # here and held through the body read. The unread body forces
        # Connection: close on the 503 (reading it would be the buffering
        # we're avoiding; not reading it would desync keep-alive).
        self._stats["requests"] += 1
        if self._inflight >= self._max_inflight:
            self._stats["rejected"] += 1
            await self._respond(writer, 503, b"proxy at capacity", False)
            return False
        self._inflight += 1
        released = False

        def release() -> None:
            # The slot guards buffered-body memory + dispatch concurrency.
            # Streams release it at dispatch (they buffer nothing after
            # the body), so the decrement must be idempotent.
            nonlocal released
            if not released:
                released = True
                self._inflight -= 1

        try:
            if "chunked" in headers.get("transfer-encoding", "").lower():
                # Decode the chunked body fully; leaving it unread would
                # desync the keep-alive stream (request-smuggling vector
                # behind another HTTP intermediary). The read deadline
                # stops a stalled sender from pinning this slot forever.
                try:
                    body = await asyncio.wait_for(
                        self._read_chunked(reader), _BODY_READ_TIMEOUT_S
                    )
                except _BodyTooLarge:
                    await self._respond(writer, 413, b"body too large")
                    return False
                except (ValueError, asyncio.TimeoutError):
                    await self._respond(writer, 400, b"bad chunked encoding")
                    return False
            else:
                try:
                    n = int(headers.get("content-length", 0) or 0)
                except ValueError:
                    await self._respond(writer, 400, b"bad content-length")
                    return False
                body = b""
                if n:
                    if n > self._max_body:
                        await self._respond(writer, 413, b"body too large")
                        return False
                    try:
                        body = await asyncio.wait_for(
                            reader.readexactly(n), _BODY_READ_TIMEOUT_S
                        )
                    except asyncio.TimeoutError:
                        await self._respond(writer, 408, b"body read timeout")
                        return False
            keep_alive = (
                headers.get("connection", "").lower() != "close"
                and version != "HTTP/1.0"
            )
            return await self._dispatch(
                writer, method, target, headers, body, keep_alive, release
            )
        finally:
            release()

    async def _dispatch(
        self, writer, method, target, headers, body, keep_alive, release
    ) -> bool:
        # Everything below must produce an HTTP response, never a bare
        # connection drop (streaming manages its own error framing).
        # Request-path telemetry: mint (or adopt from traceparent /
        # x-request-id) a trace context at ingress; everything awaited
        # inside the `with tel:` scope — handle dispatch, replica,
        # engine — parents its spans under the serve:ingress root.
        from ray_tpu_torch.serve import telemetry as stel

        tel = stel.begin_request(headers)
        app_name = dep_name = route = ""
        with tel:
            try:
                await self._refresh_routes()
                parsed = urllib.parse.urlparse(target)
                match = self._match_route(parsed.path)
                if match is None:
                    # A just-deployed app may not be in the cached table
                    # yet.
                    await self._refresh_routes(force=True)
                    match = self._match_route(parsed.path)
                if match is None:
                    # Unmatched requests never reach a deployment: no
                    # SLO sample, no span (an unbounded scan of bogus
                    # paths must not pollute the ledger).
                    await self._respond(writer, 404, b"no route", keep_alive)
                    return keep_alive

                query = dict(urllib.parse.parse_qsl(parsed.query))
                payload: object = body
                if body:
                    try:
                        payload = json.loads(body)
                    except ValueError:
                        payload = body
                request = {
                    "method": method,
                    "path": parsed.path,
                    "query": query,
                    "headers": headers,
                    "body": payload,
                }
                want_stream = (
                    "text/event-stream" in headers.get("accept", "")
                    or query.get("stream", "").lower() in ("1", "true")
                    or (isinstance(payload, dict)
                        and bool(payload.get("stream")))
                )
                handle, timeout_s = self._handle_for(match)
                app_name = handle.app_name
                dep_name = handle.deployment_name
                route = match
                if want_stream:
                    self._stats["streams"] += 1
                    # A long-lived stream buffers nothing after this
                    # point; holding the slot for its whole duration
                    # would let 256 legitimate SSE clients starve every
                    # unary request.
                    release()
                    info = {"status": 200, "items": 0}
                    ka = await self._respond_stream(
                        writer, handle, request, keep_alive, timeout_s,
                        tel, info,
                    )
                    tel.finish(
                        app_name, dep_name, route, info["status"],
                        streamed=True, items=info["items"],
                    )
                    return ka
                result = await asyncio.wait_for(
                    handle.remote(request), timeout_s
                )
                if isinstance(result, bytes):
                    out = result
                elif isinstance(result, str):
                    out = result.encode()
                else:
                    out = json.dumps(result).encode()
            except asyncio.TimeoutError:
                self._stats["errors"] += 1
                if dep_name:
                    tel.finish(app_name, dep_name, route, 408)
                await self._respond(
                    writer, 408, b"request timed out", keep_alive
                )
                return keep_alive
            except NoReplicaAvailableError as e:
                # Every replica is dead/draining/circuit-open — the
                # ONLY case the proxy answers 503 for a routed request.
                # Retry-After tells well-behaved clients when the
                # breaker window reopens.
                self._stats["errors"] += 1
                if dep_name:
                    tel.finish(app_name, dep_name, route, 503)
                await self._respond(
                    writer, 503, str(e).encode(), keep_alive,
                    extra_headers={
                        "Retry-After":
                            str(max(1, int(e.retry_after_s + 0.999))),
                    },
                )
                return keep_alive
            # tpulint: allow(broad-except reason=the failure is propagated to the client as the 500 body and counted in proxy stats)
            except Exception as e:  # noqa: BLE001 - user/routing error → 500
                self._stats["errors"] += 1
                if dep_name:
                    tel.finish(app_name, dep_name, route, 500)
                await self._respond(writer, 500, str(e).encode(), keep_alive)
                return keep_alive
            tel.finish(app_name, dep_name, route, 200)
        await self._respond(writer, 200, out, keep_alive)
        return keep_alive

    async def _respond(
        self,
        writer,
        status: int,
        payload: bytes,
        keep_alive: bool = False,
        extra_headers: dict | None = None,
    ):
        reason = _REASONS.get(status, "Unknown")
        conn = "keep-alive" if keep_alive else "close"
        extras = "".join(
            f"{k}: {v}\r\n" for k, v in (extra_headers or {}).items()
        )
        writer.write(
            (
                f"HTTP/1.1 {status} {reason}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"{extras}"
                f"Connection: {conn}\r\n\r\n"
            ).encode()
            + payload
        )
        await writer.drain()

    async def _read_chunked(self, reader) -> bytes:
        """Decode a chunked request body (RFC 9112 §7.1), bounded by the
        proxy body cap; trailer fields are read and discarded."""
        parts: list[bytes] = []
        total = 0
        while True:
            size_line = await reader.readline()
            if not size_line:
                raise ValueError("eof in chunk size")
            token = size_line.split(b";")[0].strip()
            # Strict HEXDIG only (RFC 9112 §7.1): int(x, 16) would also
            # accept '0x10'/'+10'/'1_0', forms another parser in front of
            # us may read differently — the exact desync this decoder is
            # here to prevent.
            if not token or any(c not in _HEX for c in token):
                raise ValueError("bad chunk size")
            size = int(token, 16)
            if size == 0:
                break
            total += size
            if total > self._max_body:
                raise _BodyTooLarge()
            parts.append(await reader.readexactly(size))
            if await reader.readexactly(2) != b"\r\n":
                raise ValueError("missing chunk terminator")
        for _ in range(64):  # trailer section ends at an empty line
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
        else:
            raise ValueError("unterminated trailer section")
        return b"".join(parts)

    async def _respond_stream(
        self,
        writer,
        handle: DeploymentHandle,
        request: dict,
        keep_alive: bool,
        timeout_s: float = _REQUEST_TIMEOUT_S,
        tel=None,
        info: dict | None = None,
    ) -> bool:
        """Stream the handle call as SSE over chunked transfer encoding.
        Headers are written only once the first item (or first error)
        arrives, so pre-stream failures still get a clean HTTP status.
        ``tel``/``info`` (serve telemetry): first_byte() marks TTFT on
        the first frame; item count and effective status land in
        ``info`` for the ingress span."""
        if info is None:
            info = {}
        stream: DeploymentStreamResponse = handle.options(stream=True).remote(
            request
        )
        agen = stream.__aiter__()
        started = False

        def _sse_headers() -> bytes:
            conn = "keep-alive" if keep_alive else "close"
            return (
                "HTTP/1.1 200 OK\r\n"
                "Content-Type: text/event-stream\r\n"
                "Cache-Control: no-cache\r\n"
                "Transfer-Encoding: chunked\r\n"
                f"Connection: {conn}\r\n\r\n"
            ).encode()

        try:
            while True:
                # Per-item deadline: a replica hung before its next yield
                # must not pin this connection (and its router inflight
                # slot) forever.
                try:
                    item = await asyncio.wait_for(
                        agen.__anext__(), timeout_s
                    )
                except StopAsyncIteration:
                    break
                except asyncio.TimeoutError:
                    self._stats["errors"] += 1
                    await agen.aclose()
                    if not started:
                        # Mirror the unary path: a pre-first-item timeout
                        # is a clean 408, not an empty 500.
                        info["status"] = 408
                        await self._respond(
                            writer, 408, b"request timed out", keep_alive
                        )
                        return keep_alive
                    info["status"] = 500
                    err = json.dumps({"error": "stream item timed out"})
                    writer.write(
                        _chunk(f"event: error\ndata: {err}\n\n".encode())
                        + b"0\r\n\r\n"
                    )
                    await writer.drain()
                    return False
                if not started:
                    started = True
                    if tel is not None:
                        tel.first_byte()
                    writer.write(_sse_headers())
                info["items"] = info.get("items", 0) + 1
                writer.write(_chunk(_sse_frame(item)))
                await writer.drain()
            if not started:
                # Empty stream: still a valid SSE response.
                started = True
                writer.write(_sse_headers())
            writer.write(_chunk(b"data: [DONE]\n\n") + b"0\r\n\r\n")
            await writer.drain()
            return keep_alive
        except (ConnectionResetError, BrokenPipeError):
            # Client went away: stop the replica-side generator.
            info["status"] = 499  # nginx convention: client closed
            await agen.aclose()
            return False
        # tpulint: allow(broad-except reason=the failure reaches the client — as a 500/503 before the stream starts, as a terminal SSE error event mid-stream — and is counted in proxy stats)
        except Exception as e:  # noqa: BLE001
            self._stats["errors"] += 1
            await agen.aclose()
            if not started and isinstance(e, NoReplicaAvailableError):
                # Mirror the unary path: pre-stream unavailability is a
                # clean 503 + Retry-After, not an empty 500.
                info["status"] = 503
                await self._respond(
                    writer, 503, str(e).encode(), keep_alive,
                    extra_headers={
                        "Retry-After":
                            str(max(1, int(e.retry_after_s + 0.999))),
                    },
                )
                return keep_alive
            info["status"] = 500
            if not started:
                await self._respond(writer, 500, str(e).encode(), keep_alive)
                return keep_alive
            # Mid-stream failure: emit an SSE error event, then terminate
            # the chunked body so the client sees a clean end.
            err = json.dumps({"error": str(e)})
            writer.write(
                _chunk(f"event: error\ndata: {err}\n\n".encode())
                + b"0\r\n\r\n"
            )
            await writer.drain()
            return False

    async def shutdown(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        return True
