"""The node's GCE preemption-notice source (autoscaler/gcp.py): each poll
case through its ``fetch`` seam, against the JAX package's source on the
same answers, and ``NodeManager._preemption_source`` building it when the
DMI product name says Google; and ``detect_labels``' GCE metadata labels
(the provider id and the instance name the autoscaler's GCP provider maps
nodes by) against the JAX package's on the same DMI name and metadata
answers (patched: no test reaches a metadata server)."""

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


METADATA = "http://metadata.google.internal/computeMetadata/v1/instance/"
ANSWERS = {METADATA + "attributes/ray-tpu-provider-id": "ray-tpu-c-0a1b2c3d",
           METADATA + "name": "gke-gpu-pool-node-aaa"}


class _Reply(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("product,want", [
    ("Google Compute Engine\n", {"ray-tpu-provider-id": "ray-tpu-c-0a1b2c3d",
                                 "ray-tpu-gce-instance":
                                     "gke-gpu-pool-node-aaa"}),
    ("Standard PC\n", {}),
])
def test_detect_labels_reads_gce_metadata_as_the_source_does(
        monkeypatch, product, want):
    """On a Google VM both packages' nodes register the two metadata
    labels (each read with the Metadata-Flavor header and a 2 s timeout);
    elsewhere neither probes the metadata server."""
    import urllib.request

    import ray_tpu._private.accelerators as ref_acc
    import ray_tpu._private.config as ref_config
    import ray_tpu_torch._private.accelerators as port_acc
    from ray_tpu.runtime.node import detect_labels as ref_detect
    from ray_tpu_torch.runtime.node import detect_labels

    real_open = builtins.open

    def fake_open(path, *a, **k):
        if path == "/sys/class/dmi/id/product_name":
            return io.StringIO(product)
        return real_open(path, *a, **k)

    probes = []

    def fake_urlopen(req, timeout=None):
        probes.append((req.full_url, req.get_header("Metadata-flavor"),
                       timeout))
        return _Reply(ANSWERS[req.full_url].encode())

    monkeypatch.setattr(builtins, "open", fake_open)
    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    monkeypatch.setattr(ref_acc, "detect_accelerator_labels", dict)
    monkeypatch.setattr(port_acc, "detect_accelerator_labels", dict)
    monkeypatch.setitem(config._overrides, "NODE_LABELS", "")
    monkeypatch.setitem(ref_config._overrides, "NODE_LABELS", "")
    got, ref = detect_labels(), ref_detect()
    assert got == ref == want
    if want:
        assert probes == [(url, "Google", 2) for url in ANSWERS] * 2
    else:
        assert probes == []
