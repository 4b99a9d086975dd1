"""gRPC Serve ingress: a standard-protocol data plane for non-Python
clients (reference: python/ray/serve/_private/proxy.py:534 ``gRPCProxy``
— the reference runs a gRPC servicer next to the HTTP proxy whose
``unary_unary``/``unary_stream`` handlers bridge into DeploymentHandles;
same shape here over ``raytpu.serve.ServeIngress`` from
``protos/serve.proto``).

Server: ``serve.start_grpc()`` deploys :class:`GrpcIngressActor` as a
detached actor running a ``grpc.aio`` server; any gRPC client in any
language can then call ``raytpu.serve.ServeIngress/Call`` (unary) or
``/Stream`` (server-streaming) using the committed ``.proto``.

The servicer is registered through ``grpc.method_handlers_generic_handler``
with protoc-generated message classes — no grpc_tools codegen needed on
the server, and the wire format is plain protobuf-over-HTTP/2.
"""

from __future__ import annotations

import asyncio
import json

from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.routes import RouteTablePoller

SERVICE_NAME = "raytpu.serve.ServeIngress"
GRPC_INGRESS_NAME = "_serve_grpc_ingress"


def _encode_reply(value, serve_pb2):
    """Pick the reply content_type from the Python value's type
    (mirrors the HTTP proxy's bytes/str/JSON response negotiation)."""
    if isinstance(value, bytes):
        return serve_pb2.ServeReply(payload=value, content_type="bytes")
    if isinstance(value, str):
        return serve_pb2.ServeReply(
            payload=value.encode(), content_type="text"
        )
    return serve_pb2.ServeReply(
        payload=json.dumps(value).encode(), content_type="json"
    )


def _decode_payload(request):
    ctype = request.content_type or "json"
    if ctype == "bytes":
        return request.payload
    if ctype == "text":
        return request.payload.decode()
    if ctype == "json":
        if not request.payload:
            return None
        return json.loads(request.payload.decode())
    raise ValueError(f"unknown content_type {ctype!r}")


def _make_auth_interceptor():
    """grpc.aio server interceptor enforcing the cluster token
    (``authorization: Bearer <AUTH_TOKEN>``). Healthz stays open —
    load balancers probe it without credentials. Built lazily: the
    class must subclass grpc.aio.ServerInterceptor and grpc imports
    stay deferred in this module."""
    import grpc

    class _AuthInterceptor(grpc.aio.ServerInterceptor):
        async def intercept_service(
            self, continuation, handler_call_details
        ):
            if handler_call_details.method.endswith("/Healthz"):
                return await continuation(handler_call_details)
            from ray_tpu_torch._private import config

            token = config.get("AUTH_TOKEN")
            meta = dict(handler_call_details.invocation_metadata or ())
            got = meta.get("authorization", "")
            if token and got == f"Bearer {token}":
                return await continuation(handler_call_details)

            def deny(request_or_iter, context):
                context.abort(
                    grpc.StatusCode.UNAUTHENTICATED,
                    "missing or invalid authorization metadata "
                    "(expected: Bearer <cluster token>)",
                )
                yield  # pragma: no cover - abort raises first

            # The deny handler must match each method's cardinality:
            # a unary handler on a streaming method would wait for the
            # first inbound message instead of failing at call start.
            method = handler_call_details.method
            if method.endswith("/Chat"):
                return grpc.stream_stream_rpc_method_handler(deny)
            if method.endswith("/Stream"):
                return grpc.unary_stream_rpc_method_handler(deny)

            def deny_unary(request, context):
                context.abort(
                    grpc.StatusCode.UNAUTHENTICATED,
                    "missing or invalid authorization metadata "
                    "(expected: Bearer <cluster token>)",
                )

            return grpc.unary_unary_rpc_method_handler(deny_unary)

    return _AuthInterceptor()


def _effective_timeout(timeout, context):
    """Deadline propagation: the gRPC client's deadline caps the
    per-deployment timeout (reference: gRPCProxy honors request
    deadlines). time_remaining() is None when the client set none."""
    remaining = context.time_remaining()
    bounds = [t for t in (timeout, remaining) if t is not None]
    return min(bounds) if bounds else None


class GrpcIngressActor:
    """Deployed detached by :func:`ray_tpu_torch.serve.api.start_grpc`.

    With ``require_auth=True`` every call must carry the cluster's
    shared-secret token as ``authorization: Bearer <token>`` metadata —
    the same token the control plane's RPC auth uses (config
    AUTH_TOKEN). Default off: like the HTTP proxy, the ingress is a
    public data plane unless the operator opts in.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        require_auth: bool = False,
    ):
        self._poller = RouteTablePoller()
        self._handles: dict = {}
        self._stream_handles: dict = {}
        self._port: int | None = None
        self._server = None
        self._require_auth = require_auth
        # Actor __init__ runs on the executor thread; the grpc.aio server
        # must live on the runtime loop where handle calls are native
        # (same pattern as proxy.ProxyActor.__init__).
        from ray_tpu_torch import api as core_api

        asyncio.run_coroutine_threadsafe(
            self._start(host, port), core_api._runtime.loop
        ).result(timeout=30)

    async def _start(self, host: str, port: int):
        import grpc

        from ray_tpu_torch.serve.protos import serve_pb2

        handlers = {
            "Call": grpc.unary_unary_rpc_method_handler(
                self._call,
                request_deserializer=serve_pb2.ServeRequest.FromString,
                response_serializer=serve_pb2.ServeReply.SerializeToString,
            ),
            "Stream": grpc.unary_stream_rpc_method_handler(
                self._stream,
                request_deserializer=serve_pb2.ServeRequest.FromString,
                response_serializer=serve_pb2.ServeReply.SerializeToString,
            ),
            "ListApplications": grpc.unary_unary_rpc_method_handler(
                self._list_applications,
                request_deserializer=(
                    serve_pb2.ListApplicationsRequest.FromString
                ),
                response_serializer=(
                    serve_pb2.ListApplicationsReply.SerializeToString
                ),
            ),
            "Chat": grpc.stream_stream_rpc_method_handler(
                self._chat,
                request_deserializer=serve_pb2.ServeRequest.FromString,
                response_serializer=serve_pb2.ServeReply.SerializeToString,
            ),
            "Healthz": grpc.unary_unary_rpc_method_handler(
                self._healthz,
                request_deserializer=serve_pb2.HealthzRequest.FromString,
                response_serializer=serve_pb2.HealthzReply.SerializeToString,
            ),
        }
        interceptors = []
        if self._require_auth:
            interceptors.append(_make_auth_interceptor())
        self._server = grpc.aio.server(interceptors=interceptors)
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
        )
        self._port = self._server.add_insecure_port(f"{host}:{port}")
        await self._server.start()

    def get_port(self) -> int:
        return self._port

    async def shutdown(self) -> bool:
        if self._server is not None:
            await self._server.stop(grace=1.0)
        return True

    # ---------------------------------------------------------- routing
    async def _resolve(self, request):
        """Map (application, deployment) onto a target deployment and
        per-deployment timeout via the controller route table."""
        await self._poller.refresh()
        app = request.application or "default"
        if app not in self._poller.by_app():
            # One forced refresh covers the just-deployed case.
            await self._poller.refresh(force=True)
        by_app = self._poller.by_app()
        if app not in by_app:
            return None, None, None
        ingress, timeout = by_app[app]
        deployment = request.deployment or ingress
        return app, deployment, timeout

    def _handle_for(self, app, deployment, method, stream):
        cache = self._stream_handles if stream else self._handles
        key = (app, deployment, method)
        handle = cache.get(key)
        if handle is None:
            handle = DeploymentHandle(
                deployment, app, method_name=method or "__call__",
                stream=stream,
            )
            cache[key] = handle
        return handle

    # --------------------------------------------------------- handlers
    async def _call(self, request, context):
        import grpc

        from ray_tpu_torch.serve.protos import serve_pb2

        app, deployment, timeout = await self._resolve(request)
        if app is None:
            await context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"application {request.application or 'default'!r} not "
                "found; call ListApplications for the live set",
            )
        try:
            arg = _decode_payload(request)
        except ValueError as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        handle = self._handle_for(
            app, deployment, request.method, stream=False
        )
        timeout = _effective_timeout(timeout, context)
        try:
            value = await asyncio.wait_for(
                handle.remote(arg), timeout=timeout
            )
        except asyncio.TimeoutError:
            await context.abort(
                grpc.StatusCode.DEADLINE_EXCEEDED,
                f"no reply within {timeout}s",
            )
        # tpulint: allow(broad-except reason=user-code failure becomes a gRPC INTERNAL status via context.abort — the error reaches the caller typed, not swallowed)
        except Exception as e:  # noqa: BLE001 - becomes a gRPC status
            await context.abort(
                grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
            )
        return _encode_reply(value, serve_pb2)

    async def _stream(self, request, context):
        import grpc

        from ray_tpu_torch.serve.protos import serve_pb2

        app, deployment, timeout = await self._resolve(request)
        if app is None:
            await context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"application {request.application or 'default'!r} not "
                "found; call ListApplications for the live set",
            )
        try:
            arg = _decode_payload(request)
        except ValueError as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        handle = self._handle_for(
            app, deployment, request.method, stream=True
        )
        timeout = _effective_timeout(timeout, context)
        agen = handle.remote(arg).__aiter__()
        while True:
            try:
                item = await asyncio.wait_for(
                    agen.__anext__(), timeout=timeout
                )
            except StopAsyncIteration:
                break
            except asyncio.TimeoutError:
                await context.abort(
                    grpc.StatusCode.DEADLINE_EXCEEDED,
                    f"no stream item within {timeout}s",
                )
            except grpc.aio.AbortError:
                raise
            # tpulint: allow(broad-except reason=stream failure becomes a gRPC INTERNAL status via context.abort — the error reaches the caller typed, not swallowed)
            except Exception as e:  # noqa: BLE001 - becomes a gRPC status
                await context.abort(
                    grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
                )
            yield _encode_reply(item, serve_pb2)

    async def _chat(self, request_iterator, context):
        """Bidi turn-based streaming: each inbound message invokes the
        deployment's STREAMING method; its items flow out before the
        next inbound message is consumed — the token-in/token-out shape
        LLM chat clients want. Routing fields are read per message, so
        one Chat connection can address several deployments."""
        import grpc

        from ray_tpu_torch.serve.protos import serve_pb2

        async for request in request_iterator:
            app, deployment, timeout = await self._resolve(request)
            if app is None:
                await context.abort(
                    grpc.StatusCode.NOT_FOUND,
                    f"application {request.application or 'default'!r} "
                    "not found; call ListApplications for the live set",
                )
            try:
                arg = _decode_payload(request)
            except ValueError as e:
                await context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT, str(e)
                )
            handle = self._handle_for(
                app, deployment, request.method, stream=True
            )
            turn_timeout = _effective_timeout(timeout, context)
            agen = handle.remote(arg).__aiter__()
            while True:
                try:
                    item = await asyncio.wait_for(
                        agen.__anext__(), timeout=turn_timeout
                    )
                except StopAsyncIteration:
                    break
                except asyncio.TimeoutError:
                    await context.abort(
                        grpc.StatusCode.DEADLINE_EXCEEDED,
                        f"no stream item within {turn_timeout}s",
                    )
                except grpc.aio.AbortError:
                    raise
                # tpulint: allow(broad-except reason=turn failure becomes a gRPC INTERNAL status via context.abort — the error reaches the caller typed, not swallowed)
                except Exception as e:  # noqa: BLE001 - gRPC status
                    await context.abort(
                        grpc.StatusCode.INTERNAL,
                        f"{type(e).__name__}: {e}",
                    )
                yield _encode_reply(item, serve_pb2)

    async def _list_applications(self, request, context):
        from ray_tpu_torch.serve.protos import serve_pb2

        await self._poller.refresh(force=True)
        apps = sorted(self._poller.by_app())
        return serve_pb2.ListApplicationsReply(application_names=apps)

    async def _healthz(self, request, context):
        from ray_tpu_torch.serve.protos import serve_pb2

        return serve_pb2.HealthzReply(message="success")


# ------------------------------------------------------------- client


def _auth_metadata(token):
    return (("authorization", f"Bearer {token}"),) if token else None


def grpc_request(
    addr: str,
    *,
    application: str = "default",
    deployment: str = "",
    method: str = "",
    payload=None,
    timeout: float | None = 60.0,
    token: str | None = None,
):
    """Convenience unary client (tests / Python callers). Non-Python
    clients should consume ``protos/serve.proto`` directly. ``timeout``
    becomes the gRPC deadline, which the server propagates into its
    handle wait; ``token`` is sent as Bearer authorization metadata for
    ingresses started with require_auth."""
    import grpc

    from ray_tpu_torch.serve.protos import serve_pb2

    with grpc.insecure_channel(addr) as channel:
        call = channel.unary_unary(
            f"/{SERVICE_NAME}/Call",
            request_serializer=serve_pb2.ServeRequest.SerializeToString,
            response_deserializer=serve_pb2.ServeReply.FromString,
        )
        req = _build_request(serve_pb2, application, deployment, method, payload)
        reply = call(req, timeout=timeout, metadata=_auth_metadata(token))
    return _decode_reply(reply)


def grpc_stream(
    addr: str,
    *,
    application: str = "default",
    deployment: str = "",
    method: str = "",
    payload=None,
    timeout: float | None = 60.0,
    token: str | None = None,
):
    """Server-streaming client: yields decoded items as they arrive."""
    import grpc

    from ray_tpu_torch.serve.protos import serve_pb2

    with grpc.insecure_channel(addr) as channel:
        call = channel.unary_stream(
            f"/{SERVICE_NAME}/Stream",
            request_serializer=serve_pb2.ServeRequest.SerializeToString,
            response_deserializer=serve_pb2.ServeReply.FromString,
        )
        req = _build_request(serve_pb2, application, deployment, method, payload)
        for reply in call(
            req, timeout=timeout, metadata=_auth_metadata(token)
        ):
            yield _decode_reply(reply)


def grpc_chat(
    addr: str,
    payloads,
    *,
    application: str = "default",
    deployment: str = "",
    method: str = "",
    timeout: float | None = 60.0,
    token: str | None = None,
):
    """Bidi client for /Chat: sends each payload as one turn and yields
    every streamed reply item in order. The SERVER processes turns
    sequentially (a turn's stream completes before the next inbound
    message is consumed), so items arrive turn-by-turn — but gRPC's
    sender thread drains the request iterator ahead of replies, so this
    sync client cannot attribute items to turns; callers needing turn
    boundaries should encode them in the reply payloads."""
    import grpc

    from ray_tpu_torch.serve.protos import serve_pb2

    def requests():
        for p in payloads:
            yield _build_request(
                serve_pb2, application, deployment, method, p
            )

    with grpc.insecure_channel(addr) as channel:
        call = channel.stream_stream(
            f"/{SERVICE_NAME}/Chat",
            request_serializer=serve_pb2.ServeRequest.SerializeToString,
            response_deserializer=serve_pb2.ServeReply.FromString,
        )
        for reply in call(
            requests(), timeout=timeout, metadata=_auth_metadata(token)
        ):
            yield _decode_reply(reply)


def _build_request(serve_pb2, application, deployment, method, payload):
    if isinstance(payload, bytes):
        body, ctype = payload, "bytes"
    elif isinstance(payload, str):
        body, ctype = payload.encode(), "text"
    else:
        body, ctype = json.dumps(payload).encode(), "json"
    return serve_pb2.ServeRequest(
        application=application,
        deployment=deployment,
        method=method,
        payload=body,
        content_type=ctype,
    )


def _decode_reply(reply):
    if reply.content_type == "bytes":
        return reply.payload
    if reply.content_type == "text":
        return reply.payload.decode()
    return json.loads(reply.payload.decode())
