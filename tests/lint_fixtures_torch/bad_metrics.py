# tpulint fixture: metrics / span hygiene (TPU401 / TPU402).
# Line numbers are pinned by tests/test_torch_lint.py — edit with care.
import contextlib

from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import Counter, Histogram

_GOOD = Counter("fixture_requests_total", "module scope is fine")


def hot_path(n):
    c = Counter("fixture_calls_total")  # TPU401 @ line 12
    c.inc(n)
    h = Histogram("fixture_latency_seconds")  # TPU401 @ line 14
    return h


def leak_span():
    tracing.span("work")  # TPU402 @ line 19 (never entered)
    return 1


def ok_with():
    with tracing.span("work"):
        return 1


def ok_enter_context():
    with contextlib.ExitStack() as stack:
        stack.enter_context(tracing.span("work"))
        return 1
