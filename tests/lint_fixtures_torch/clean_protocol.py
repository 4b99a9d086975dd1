"""Clean fixture: every TPU70x pass has a target here and none fires.

A matched rpc call/handler pair, a journal table whose append, replay
branch and snapshot field line up, a declared-and-read knob, a
published+subscribed channel with a batch-aware handler, and a single
metric registration.
"""

CONFIG_DEFS = {
    "DELTA_LIMIT": (int, 8, "delta limit"),
}


class config:
    @staticmethod
    def get(name):
        return CONFIG_DEFS[name][1]


class Server:
    def __init__(self):
        self.kv = {}

    async def _on_echo(self, conn, payload, tag=None):
        return payload, tag

    def _journal_append(self, table, op, payload):
        del table, op, payload

    def put(self, k, v):
        self._journal_append("kv", "put", {"key": k, "value": v})

    def _restore_from_journal(self, table, op, payload):
        if table == "kv":
            if op == "put":
                self.kv[payload["key"]] = payload["value"]

    def _snapshot(self):
        return {"kv": dict(self.kv)}


def _deliver(payload):
    if "batch" in payload:
        return len(payload["batch"])
    return payload["msg"]


async def use(conn, bus):
    limit = config.get("DELTA_LIMIT")
    bus.publish("events", {"n": limit})
    bus.subscribe("events", _deliver)
    return await conn.call("echo", payload={"x": 1}, tag="t")
