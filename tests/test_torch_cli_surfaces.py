"""The CLI's observability commands on the port's runtime, as the JAX
package's tests hold them: `logs` tailing a dead worker's log from an
observer process (tests/test_logs.py's CLI case), and `slo` with the
dashboard's /api/serve over the head's serve SLO ledger
(tests/test_observability.py's smoke; the serve:ingress spans are fed to
the head as that module's SLO case feeds them). Each subprocess has its
own time limit.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import state
from torch_runtime_util import start_cluster, stop_cluster


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=2)
    yield info
    stop_cluster(info)


def test_cli_tails_dead_worker_log(cluster):
    @ray_tpu_torch.remote
    class Mouth:
        def say(self):
            print("last-words-marker")
            return "said"

    m = Mouth.remote()
    assert ray_tpu_torch.get(m.say.remote(), timeout=60) == "said"
    ray_tpu_torch.kill(m)

    # Wait until some worker's log is both dead and non-empty.
    wid = None
    deadline = time.time() + 20
    while time.time() < deadline and wid is None:
        for rec in state.list_worker_logs():
            if not rec["alive"] and rec["size"] > 0:
                text = state.read_worker_log(rec["worker_id"])
                if text and "last-words-marker" in text:
                    wid = rec["worker_id"]
                    break
        time.sleep(0.3)
    assert wid, "dead worker's log never appeared"

    # The CLI tails it from a separate observer process.
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(ray_tpu_torch.__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo_root, env.get("PYTHONPATH", "")) if p
    )
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts",
         "--address", cluster["address"], "logs", wid[:12]],
        capture_output=True, text=True, timeout=60, env=env,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "last-words-marker" in out.stdout


def test_serve_api_and_slo_cli_smoke(cluster, capsys, monkeypatch):
    """Dashboard /api/serve returns schema-complete JSON and
    `ray_tpu_torch.scripts slo` renders the same ledger."""
    from ray_tpu_torch import scripts
    from ray_tpu_torch.dashboard import start_dashboard

    rt = ray_tpu_torch.api._runtime
    base = time.time()
    rt.run(rt.core.head.call("add_task_events", events=[
        {"task_id": f"span:slo{base}-{i}", "name": "serve:ingress",
         "state": "SPAN", "ts": base + i * 0.01, "dur": 0.01,
         "deployment": "dep1", "app": "slo_app", "status": 200,
         "ttft_s": 0.01, "streamed": True, "items": 1}
        for i in range(10)]))

    dash = start_dashboard()
    try:
        with urllib.request.urlopen(dash.url + "/api/serve",
                                    timeout=10) as r:
            body = json.loads(r.read())
    finally:
        dash.stop()
    assert "deployments" in body and body["deployments"]
    required = {
        "requests", "errors", "streamed", "items", "window_requests",
        "ttft_p50_s", "ttft_p99_s", "latency_p50_s", "latency_p99_s",
        "attainment", "alert", "first_ts", "last_ts",
    }
    for name, dep in body["deployments"].items():
        assert required <= set(dep), (name, sorted(dep))
    assert "slo_app/dep1" in body["deployments"]

    # CLI wiring: `slo` end to end minus the daemon connect.
    monkeypatch.setattr(scripts, "_connect", lambda *a, **k: None)
    rc = scripts.main(["slo"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "slo_app/dep1" in out
    assert "attainment=" in out and "ttft p50=" in out
    rc = scripts.main(["slo", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and "slo_app/dep1" in out
