# tpulint fixture: rpc-reentrancy (TPU501).
# Line numbers are pinned by tests/test_torch_lint.py — edit with care.


class Node:
    async def _handle(self, method, kw, conn):
        fn = getattr(self, f"_on_{method}")
        return await fn(conn=conn, **kw)

    async def _on_stats(self, conn):
        return {"ok": True}

    async def _on_rollup(self, conn):
        # Round-trips back into our own server instead of calling
        # self._on_stats directly.
        return await conn.call("stats")  # TPU501 @ line 16

    async def _on_peer_fetch(self, conn, peer):
        # tpulint: allow(rpc-reentrancy reason=peer is a connection to another node)
        return await peer.call("stats")

    async def helper(self, conn):
        # Not an _on_ handler: a plain client calling the server is the
        # normal shape, not reentrancy.
        return await conn.call("stats")
