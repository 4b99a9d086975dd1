"""TPU701 fixture: rpc call sites drifting from their handlers.

The handlers below define the contract; every call in misuse()
violates it a different way. The dynamic-method site at the bottom is
only reported under --strict.
"""


class Service:
    async def _on_ping(self, conn, payload):
        return payload

    async def _on_kv_put(self, conn, key, value, overwrite=True):
        return key, value, overwrite


async def misuse(conn):
    await conn.call("pong")
    await conn.call("kv_put", key="a")
    await conn.call("kv_put", key="a", value=1, ttl=5)
    await conn.call("ping", {"x": 1})


async def dynamic(conn, method):
    await conn.call(method, payload=1)
