"""The node's GCE preemption-notice source (autoscaler/gcp.py): each poll
case through its ``fetch`` seam, against the JAX package's source on the
same answers, and ``NodeManager._preemption_source`` building it when the
DMI product name says Google (patched: no test reaches a metadata
server)."""

import builtins
import io

import pytest

from ray_tpu_torch._private import config
from ray_tpu_torch.autoscaler.gcp import (
    _MAINTENANCE_EVENT_URL,
    _PREEMPTED_URL,
    GceMaintenanceEventSource,
)
from ray_tpu_torch.runtime.node import NodeManager


def _fetch(answers):
    """A metadata fetch answering ``answers[url]`` (an exception raises)."""
    def fetch(url):
        got = answers[url]
        if isinstance(got, BaseException):
            raise got
        return got
    return fetch


DEADLINE = config.get("DRAIN_DEADLINE_S")
CASES = {
    "preempted": ({_PREEMPTED_URL: "TRUE", _MAINTENANCE_EVENT_URL: "NONE"},
                  ("gce-preempted", DEADLINE)),
    "maintenance": ({_PREEMPTED_URL: "FALSE",
                     _MAINTENANCE_EVENT_URL: "MIGRATE_ON_HOST_MAINTENANCE"},
                    ("gce-maintenance:MIGRATE_ON_HOST_MAINTENANCE",
                     DEADLINE)),
    "none": ({_PREEMPTED_URL: "FALSE", _MAINTENANCE_EVENT_URL: "NONE"},
             None),
    "oserror": ({_PREEMPTED_URL: OSError("unreachable"),
                 _MAINTENANCE_EVENT_URL: OSError("unreachable")}, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_poll_through_the_fetch_seam(case):
    from ray_tpu.autoscaler.gcp import GceMaintenanceEventSource as Ref

    answers, want = CASES[case]
    assert GceMaintenanceEventSource(_fetch(answers)).poll(None) == want
    assert Ref(_fetch(answers)).poll(None) == want
    assert GceMaintenanceEventSource.interval_s == Ref.interval_s


@pytest.mark.parametrize("product,built", [("Google Compute Engine\n", True),
                                           ("Standard PC\n", False)])
def test_node_builds_the_gce_source_on_google(monkeypatch, product, built):
    real_open = builtins.open

    def fake_open(path, *a, **k):
        if path == "/sys/class/dmi/id/product_name":
            return io.StringIO(product)
        return real_open(path, *a, **k)

    monkeypatch.setattr(builtins, "open", fake_open)
    monkeypatch.setitem(config._overrides, "PREEMPT_AFTER_S", "")
    source = NodeManager._preemption_source(None)
    assert isinstance(source, GceMaintenanceEventSource) == built
    assert built or source is None
