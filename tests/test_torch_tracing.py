"""Tracing in the port's runtime: spans from make_trace_ctx ride task
specs into workers and nested submits and reach the head's task events,
as tests/test_tracing.py shows for the JAX package (the same cases, the
same assertions); on-device profiling via torch.profiler (torch_profile)
writes a Chrome trace.
"""

import json
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.util import tracing
from torch_runtime_util import start_cluster, stop_cluster


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=2)
    tracing.enable_tracing()
    yield info
    tracing.disable_tracing()
    stop_cluster(info)


def _spans(pred, timeout=20):
    deadline = time.time() + timeout
    while time.time() < deadline:
        spans = tracing.get_trace_events()
        hits = [s for s in spans if pred(s)]
        if hits:
            return spans, hits
        time.sleep(0.3)
    return tracing.get_trace_events(), []


def test_task_execution_creates_span(cluster):
    @ray_tpu_torch.remote
    def traced_leaf():
        return 1

    assert ray_tpu_torch.get(traced_leaf.remote(), timeout=60) == 1
    _, hits = _spans(lambda s: s.get("name") == "traced_leaf")
    assert hits, "no span recorded for the task"
    assert hits[0]["trace_id"] and hits[0]["span_id"]


def test_nested_task_links_parent(cluster):
    @ray_tpu_torch.remote
    def traced_child():
        return 2

    @ray_tpu_torch.remote
    def traced_parent():
        return ray_tpu_torch.get(traced_child.remote(), timeout=60)

    assert ray_tpu_torch.get(traced_parent.remote(), timeout=60) == 2
    spans, child_hits = _spans(
        lambda s: s.get("name") == "traced_child" and s.get("parent_id")
    )
    assert child_hits, f"child span missing parent link: {spans}"
    child = child_hits[0]
    parents = [s for s in spans if s.get("span_id") == child["parent_id"]]
    assert parents and parents[0]["name"] == "traced_parent"
    assert parents[0]["trace_id"] == child["trace_id"]


def test_driver_span_parents_remote_call(cluster):
    @ray_tpu_torch.remote
    def in_span_task():
        return 3

    with tracing.span("driver-step"):
        assert ray_tpu_torch.get(in_span_task.remote(), timeout=60) == 3
    spans, task_hits = _spans(
        lambda s: s.get("name") == "in_span_task" and s.get("parent_id")
    )
    assert task_hits, f"task span missing driver parent: {spans}"
    parent = [
        s for s in spans if s.get("span_id") == task_hits[0]["parent_id"]
    ]
    assert parent and parent[0]["name"] == "driver-step"


def test_spans_not_in_task_table(cluster):
    from ray_tpu_torch import api as core_api

    rt = core_api._runtime
    reply = rt.run(rt.core.head.call("list_task_events", limit=5000))
    assert not any(e.get("state") == "SPAN" for e in reply["events"])


def test_user_span_context_manager(cluster):
    with tracing.span("my-section"):
        time.sleep(0.01)
    _, hits = _spans(lambda s: s.get("name") == "my-section")
    assert hits and hits[0]["dur"] >= 0.01


def test_make_trace_ctx_reaches_the_head(cluster):
    """A context made by make_trace_ctx (what every submission carries)
    names the span the task records: the head's events hold it under the
    same trace id."""
    @ray_tpu_torch.remote
    def under_ctx():
        return tracing.active_context()

    with tracing.span("ctx-parent"):
        ctx = tracing.make_trace_ctx("ctx-parent")
        assert ctx is not None
        inside = ray_tpu_torch.get(under_ctx.remote(), timeout=60)
    assert inside is not None and inside[0] == ctx["trace_id"]
    _, hits = _spans(lambda s: s.get("name") == "under_ctx"
                     and s.get("trace_id") == ctx["trace_id"])
    assert hits, "the task's span is not in the head's events"


def test_torch_profile_writes_trace(cluster, tmp_path):
    """torch_profile writes a Chrome trace of the CPU work under the
    session directory it reports, and records a profile:capture span."""
    with tracing.torch_profile(str(tmp_path)) as cap:
        torch.ones((64, 64)).matmul(torch.ones((64, 64))).sum()
    assert cap.path and cap.path.startswith(str(tmp_path / "plugins"))
    traces = list((tmp_path / "plugins" / "profile").rglob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events), (
        "no matmul in the trace")
    _, hits = _spans(lambda s: s.get("name") == "profile:capture"
                     and s.get("path") == cap.path)
    assert hits, "no profile:capture span for the capture"
