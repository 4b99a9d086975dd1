"""TPU204 per-key fixture: inverted acquisition order between two
STRING-LITERAL keys of one lock dict — invisible under the old
per-container summary node (both keys collapsed to `Pool._locks[]`,
and a self-edge is never a cycle). Pinned in test_torch_lint.py.
"""
import threading


class Pool:
    def __init__(self):
        self._locks = {}
        self._locks["a"] = threading.Lock()
        self._locks["b"] = threading.Lock()

    def forward(self):
        with self._locks["a"]:
            with self._locks["b"]:
                pass

    def reverse(self):
        with self._locks["b"]:
            with self._locks["a"]:
                pass

    def variable_key(self, k):
        # A variable key stays a summary node: it COULD be any key, so
        # per-key ordering claims about it would be unsound.
        with self._locks[k]:
            pass
