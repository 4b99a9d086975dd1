"""TPU403 fixtures: unbounded-cardinality metric labels."""
import uuid

from ray_tpu_torch.util.metrics import Counter, Gauge

OK = Counter("fixture_reqs_total", "d", tag_keys=("route",))
BAD_KEY = Counter("fixture_bad_total", "d", tag_keys=("request_id",))
G = Gauge("fixture_depth", "d", tag_keys=("k",))


def record(request_id, ctx):
    OK.inc(tags={"route": "/a"})
    OK.inc(tags={"request_id": request_id})
    OK.inc(tags={"route": request_id})
    G.set(1.0, tags={"k": uuid.uuid4().hex[:16]})
    G.set(1.0, tags={"k": f"req-{ctx.request_id}"})
    G.set(1.0, tags={"k": str(ctx.session_id)})
    # tpulint: allow(unbounded-metric-label reason=pragma escape works)
    G.set(1.0, tags={"k": request_id})
