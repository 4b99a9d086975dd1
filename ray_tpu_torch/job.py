"""Job submission: run driver scripts on the cluster and track them (port
of ray_tpu/job.py).

Reference: python/ray/dashboard/modules/job/job_manager.py:62 — REST
submit spawns a per-job supervisor actor that execs the entrypoint as a
subprocess, tracks status in GCS, and serves logs. Same architecture
here: `_JobSupervisor` is a detached-ish actor that Popens the entrypoint
with the cluster address in its env (RAY_TPU_ADDRESS, which the port's
config reads); job records live in the head KV under "job:<id>". A job's
log goes to <tmp>/ray_tpu_torch_jobs/<id>.log, apart from the JAX
package's.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import uuid

import ray_tpu_torch
from ray_tpu_torch import api as core_api

_JOB_KEY = "job:"


class _JobSupervisor:
    """One per job; owns the entrypoint subprocess."""

    def __init__(self, job_id: str, entrypoint: str, env: dict, log_path: str):
        import subprocess

        self.job_id = job_id
        self.log_path = log_path
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        self._log_file = open(log_path, "wb")
        full_env = {**os.environ, **env}
        self.proc = subprocess.Popen(
            entrypoint,
            shell=True,
            stdout=self._log_file,
            stderr=subprocess.STDOUT,
            env=full_env,
            start_new_session=True,
        )
        self.start_time = time.time()

    def poll(self) -> dict:
        rc = self.proc.poll()
        if rc is None:
            status = "RUNNING"
        elif rc == 0:
            status = "SUCCEEDED"
        else:
            status = "FAILED"
        return {
            "job_id": self.job_id,
            "status": status,
            "returncode": rc,
            "start_time": self.start_time,
        }

    def logs(self) -> str:
        self._log_file.flush()
        try:
            with open(self.log_path, "rb") as f:
                return f.read().decode("utf-8", "replace")
        except FileNotFoundError:
            return ""

    def stop_job(self) -> bool:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            # tpulint: allow(broad-except reason=the child ignored SIGTERM past the grace window; escalating to SIGKILL IS the handling)
            except Exception:  # noqa: BLE001
                self.proc.kill()
            return True
        return False


def _kv_put(key: str, value: dict):
    rt = core_api._runtime

    async def go():
        await rt.core.head.call(
            "kv_put", key=key, value=json.dumps(value).encode(), overwrite=True
        )

    rt.run(go())


def _kv_get(key: str) -> dict | None:
    rt = core_api._runtime

    async def go():
        return await rt.core.head.call("kv_get", key=key)

    reply = rt.run(go())
    if not reply["ok"]:
        return None
    return json.loads(reply["value"].decode())


def _kv_keys(prefix: str) -> list[str]:
    rt = core_api._runtime

    async def go():
        return await rt.core.head.call("kv_keys", prefix=prefix)

    return rt.run(go())["keys"]


class JobSubmissionClient:
    """Reference: ray.job_submission.JobSubmissionClient (sdk.py)."""

    def __init__(self):
        self._supervisors: dict[str, object] = {}

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: str | None = None,
        runtime_env: dict | None = None,
    ) -> str:
        job_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        env_vars = dict((runtime_env or {}).get("env_vars", {}))
        # The entrypoint driver connects back to THIS cluster.
        head_addr = core_api._runtime.core.head_addr
        env_vars.setdefault("RAY_TPU_ADDRESS", head_addr)
        log_path = os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch_jobs", f"{job_id}.log"
        )
        supervisor_cls = ray_tpu_torch.remote(_JobSupervisor)
        # Supervisors idle-wait on a subprocess; a fractional CPU keeps
        # many concurrent jobs from starving real work (reference: the
        # supervisor actor is scheduled with 0 CPUs, job_manager.py).
        sup = supervisor_cls.options(
            name=f"_job_supervisor:{job_id}", num_cpus=0.01
        ).remote(job_id, entrypoint, env_vars, log_path)
        self._supervisors[job_id] = sup
        record = {
            "job_id": job_id,
            "entrypoint": entrypoint,
            "status": "RUNNING",
            "submission_time": time.time(),
        }
        _kv_put(_JOB_KEY + job_id, record)
        return job_id

    def _sup(self, job_id: str):
        sup = self._supervisors.get(job_id)
        if sup is None:
            sup = ray_tpu_torch.get_actor(f"_job_supervisor:{job_id}")
            self._supervisors[job_id] = sup
        return sup

    def get_job_status(self, job_id: str) -> str:
        try:
            info = ray_tpu_torch.get(self._sup(job_id).poll.remote())
        # tpulint: allow(broad-except reason=a dead supervisor actor means the job reached a terminal state; the KV record below is the authoritative fallback answer)
        except Exception:  # noqa: BLE001 - supervisor gone → terminal state
            rec = _kv_get(_JOB_KEY + job_id)
            return rec["status"] if rec else "UNKNOWN"
        rec = _kv_get(_JOB_KEY + job_id) or {"job_id": job_id}
        if rec.get("status") != info["status"]:
            rec.update(status=info["status"], returncode=info["returncode"])
            _kv_put(_JOB_KEY + job_id, rec)
        return info["status"]

    def get_job_logs(self, job_id: str) -> str:
        return ray_tpu_torch.get(self._sup(job_id).logs.remote())

    def stop_job(self, job_id: str) -> bool:
        stopped = ray_tpu_torch.get(self._sup(job_id).stop_job.remote())
        if stopped:
            rec = _kv_get(_JOB_KEY + job_id) or {"job_id": job_id}
            rec["status"] = "STOPPED"
            _kv_put(_JOB_KEY + job_id, rec)
        return stopped

    def list_jobs(self) -> list[dict]:
        out = []
        for key in _kv_keys(_JOB_KEY):
            rec = _kv_get(key)
            if rec:
                # Refresh live status where the supervisor still answers.
                if rec.get("status") == "RUNNING":
                    rec["status"] = self.get_job_status(rec["job_id"])
                out.append(rec)
        return out

    def delete_job(self, job_id: str) -> bool:
        """Kill the supervisor and drop the record (terminal jobs only)."""
        status = self.get_job_status(job_id)
        if status == "RUNNING":
            raise RuntimeError("stop the job before deleting it")
        try:
            ray_tpu_torch.kill(self._sup(job_id))
        # tpulint: allow(broad-except reason=deleting a terminal job; a supervisor that is already gone is the desired end state)
        except Exception:  # noqa: BLE001 - already gone
            pass
        self._supervisors.pop(job_id, None)
        rt = core_api._runtime

        async def go():
            await rt.core.head.call("kv_del", key=_JOB_KEY + job_id)

        rt.run(go())
        return True

    def wait_until_finish(
        self, job_id: str, timeout: float = 120.0
    ) -> str:
        deadline = time.time() + timeout
        while True:
            status = self.get_job_status(job_id)
            if status in ("SUCCEEDED", "FAILED", "STOPPED"):
                return status
            if time.time() >= deadline:
                raise TimeoutError(
                    f"job {job_id} still {status} after {timeout}s"
                )
            time.sleep(0.5)
