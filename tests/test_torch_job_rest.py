"""Job REST API, driven with real curl subprocesses the way external CI
would (reference test model: python/ray/dashboard/modules/job/tests/
test_http_job_server.py — submit/status/logs/stop/delete over HTTP).
(port of tests/test_job_rest.py on ray_tpu_torch.dashboard and
ray_tpu_torch.job)
"""

import json
import shutil
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.dashboard import start_dashboard

pytestmark = pytest.mark.skipif(
    shutil.which("curl") is None, reason="curl not installed"
)


@pytest.fixture(scope="module")
def dash():
    ray_tpu_torch.init(num_cpus=4)
    d = start_dashboard()
    yield d
    d.stop()
    ray_tpu_torch.shutdown()


def _curl(*args: str) -> str:
    out = subprocess.run(
        ["curl", "-sS", "--max-time", "30", *args],
        capture_output=True,
        text=True,
        timeout=60,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout


def _wait_status(url: str, job_id: str, want: set, timeout: float = 30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        rec = json.loads(_curl(f"{url}/api/jobs/{job_id}"))
        if rec["status"] in want:
            return rec["status"]
        time.sleep(0.3)
    raise TimeoutError(f"job never reached {want}")


def test_job_lifecycle_over_curl(dash):
    entry = f"{sys.executable} -c \"print('rest-job-ran')\""
    reply = json.loads(
        _curl(
            "-X", "POST", f"{dash.url}/api/jobs",
            "-d", json.dumps({"entrypoint": entry}),
        )
    )
    job_id = reply["job_id"]

    assert _wait_status(dash.url, job_id, {"SUCCEEDED"}) == "SUCCEEDED"
    logs = _curl(f"{dash.url}/api/jobs/{job_id}/logs")
    assert "rest-job-ran" in logs

    listed = json.loads(_curl(f"{dash.url}/api/jobs"))
    assert any(j["job_id"] == job_id for j in listed)

    deleted = json.loads(_curl("-X", "DELETE", f"{dash.url}/api/jobs/{job_id}"))
    assert deleted == {"deleted": True}
    listed = json.loads(_curl(f"{dash.url}/api/jobs"))
    assert not any(j["job_id"] == job_id for j in listed)


def test_job_stop_over_curl(dash):
    entry = f"{sys.executable} -c \"import time; time.sleep(600)\""
    job_id = json.loads(
        _curl(
            "-X", "POST", f"{dash.url}/api/jobs",
            "-d", json.dumps({"entrypoint": entry}),
        )
    )["job_id"]
    _wait_status(dash.url, job_id, {"RUNNING"})

    stopped = json.loads(
        _curl("-X", "POST", f"{dash.url}/api/jobs/{job_id}/stop")
    )
    assert stopped == {"stopped": True}
    assert _wait_status(dash.url, job_id, {"STOPPED", "FAILED"})
    # Deleting a RUNNING job is a 400; terminal is fine.
    deleted = json.loads(_curl("-X", "DELETE", f"{dash.url}/api/jobs/{job_id}"))
    assert deleted == {"deleted": True}


def test_submit_rejects_bad_body(dash):
    code = subprocess.run(
        ["curl", "-sS", "-o", "/dev/null", "-w", "%{http_code}",
         "-X", "POST", f"{dash.url}/api/jobs", "-d", "not json"],
        capture_output=True, text=True, timeout=60,
    ).stdout
    assert code == "400"

    for req in (
        [f"{dash.url}/api/jobs/does-not-exist"],
        ["-X", "POST", f"{dash.url}/api/jobs/does-not-exist/stop"],
        ["-X", "DELETE", f"{dash.url}/api/jobs/does-not-exist"],
    ):
        code = subprocess.run(
            ["curl", "-sS", "-o", "/dev/null", "-w", "%{http_code}", *req],
            capture_output=True, text=True, timeout=60,
        ).stdout
        assert code == "404", req
