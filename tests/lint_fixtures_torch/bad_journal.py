"""TPU702 fixture: journal writes that replay/snapshot can't honor.

Four distinct gaps: a payload key the replay branch needs but the
append never writes, an op with no replay branch, a table the replay
switch doesn't know at all, and a replayed table missing from the
snapshot.
"""


class Head:
    def __init__(self):
        self.kv = {}
        self.jobs = {}

    def _journal_append(self, table, op, payload):
        del table, op, payload

    def mutate(self, k, v):
        self._journal_append("kv", "put", {"key": k})
        self._journal_append("kv", "del", {"key": k})
        self._journal_append("ghost", "put", {"key": k})
        self._journal_append("jobs", "add", {"job": v})

    def _restore_from_journal(self, table, op, payload):
        if table == "kv":
            if op == "put":
                self.kv[payload["key"]] = payload["value"]
        elif table == "jobs":
            if op == "add":
                self.jobs[payload["job"]] = True

    def _snapshot(self):
        return {"kv": dict(self.kv)}
