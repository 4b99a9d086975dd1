"""TPU705 fixture: one metric name, three registrations — the first
is the reference, the second drifts its label set, the third its type.
"""

from ray_tpu_torch.util.metrics import Counter, Gauge

REQS = Counter("fixture_requests_total", "requests", tag_keys=("route",))
DUP = Counter("fixture_requests_total", "requests",
              tag_keys=("route", "code"))
DRIFT = Gauge("fixture_requests_total", "requests")
