"""Native-rpc ingress: the framework-protocol alternative to the HTTP
proxy (reference: python/ray/serve/_private/proxy.py gRPCProxy :534 —
typed non-HTTP ingress alongside HTTPProxy; here the wire is the
runtime's own rpc framing, so in-cluster callers skip HTTP entirely).

Server: deploy ``RpcIngressActor`` as an actor and call ``start``::

    ingress = ray_tpu_torch.remote(serve.RpcIngressActor).remote()
    addr = ray_tpu_torch.get(ingress.start.remote())

It serves ``serve_request`` rpcs that name the target deployment
directly (like a gRPC service routes by method, not by URL path).
Client: :func:`rpc_request` from any process with a runtime."""

from __future__ import annotations

from ray_tpu_torch.serve.handle import DeploymentHandle


class RpcIngressActor:
    """Deploy with ``ray_tpu_torch.remote(RpcIngressActor).remote()`` then
    ``await``/get ``start.remote()`` for the serving address."""

    def __init__(self):
        self._handles: dict[tuple, DeploymentHandle] = {}
        self._server = None
        self._addr: str | None = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        from ray_tpu_torch._private import rpc

        self._server = rpc.Server(self._on_rpc)
        p = await self._server.start(host, port)
        self._addr = f"{host}:{p}"
        return self._addr

    def get_addr(self) -> str | None:
        return self._addr

    async def _on_rpc(self, method: str, kw: dict, conn):
        from ray_tpu_torch._private import rpc

        if method != "serve_request":
            raise rpc.RpcError(f"rpc ingress: unknown method {method!r}")
        deployment = kw["deployment"]
        app = kw.get("app", "default")
        call_method = kw.get("call_method", "__call__")
        key = (app, deployment, call_method)
        handle = self._handles.get(key)
        if handle is None:
            handle = DeploymentHandle(
                deployment, app, method_name=call_method
            )
            self._handles[key] = handle
        try:
            result = await handle.remote(
                *kw.get("args", ()), **kw.get("kwargs", {})
            )
            return {"ok": True, "result": result}
        # tpulint: allow(broad-except reason=handler failure is encoded into the RPC reply envelope and travels to the caller typed — not swallowed)
        except Exception as e:  # noqa: BLE001 - travels to the caller
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    async def shutdown(self) -> bool:
        if self._server is not None:
            await self._server.stop()
        return True


def rpc_request(
    addr: str,
    deployment: str,
    *args,
    app: str = "default",
    method: str = "__call__",
    timeout: float | None = 60.0,
    **kwargs,
):
    """Call a deployment through an rpc ingress (sync, driver/task
    side). Raises RuntimeError on a deployment-side error."""
    import ray_tpu_torch.api as api

    rt = api._runtime

    async def call():
        conn = await rt.core._connect(addr)
        # tpulint: allow(TPU701 reason=the ingress is a raw dispatcher — rpc.Server routes serve_request inside _on_rpc itself, deliberately outside the _on_<method> convention)
        return await conn.call(
            "serve_request",
            deployment=deployment,
            app=app,
            call_method=method,
            args=list(args),
            kwargs=kwargs,
        )

    reply = rt.run(call(), timeout=timeout)
    if not reply.get("ok"):
        raise RuntimeError(f"serve rpc ingress: {reply.get('error')}")
    return reply["result"]
