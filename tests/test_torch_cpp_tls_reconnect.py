"""The port's C++ client with the Python client's hardening: TLS with the
pinned cluster cert, and reconnect-with-backoff across a head restart
(port of tests/test_cpp_tls_reconnect.py: the same cases against the
port's runtime, with the C++ programs built from ray_tpu_torch/cpp/).

(reference frame: this repo's own _private/rpc.py client semantics —
_ssl_client_ctx pinning and ReconnectingClient — which previously
stopped at the language boundary.)
"""

import shutil
import subprocess
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._native import cpp_client
from ray_tpu_torch._private import config as _config
from ray_tpu_torch._private.tls_utils import generate_self_signed

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ toolchain",
)


@pytest.fixture(scope="module")
def binaries():
    return cpp_client.build()


def test_cpp_demo_against_tls_cluster(binaries, tmp_path):
    """A --tls cluster is reachable from C++ with the pinned cert; a
    client pinning a DIFFERENT cert is refused at the handshake."""
    cert = str(tmp_path / "tls.crt")
    key = str(tmp_path / "tls.key")
    generate_self_signed(cert, key)
    info = ray_tpu_torch.init(
        num_cpus=4,
        _system_config={
            "TLS_CERT": cert,
            "TLS_KEY": key,
            "AUTH_TOKEN": "tls-test-token",
        },
    )
    try:
        import statistics

        from ray_tpu_torch._private.xlang import register_function

        register_function("cpp_add", lambda a, b: a + b)
        register_function(
            "cpp_stats",
            lambda ns: {"mean": statistics.mean(ns), "max": max(ns)},
        )
        register_function("cpp_boom", lambda: 1 / 0)
        out = subprocess.run(
            [
                str(binaries / "raytpu_demo"),
                info["address"], "tls-test-token", cert,
            ],
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode == 0, out.stdout + out.stderr
        assert "CPP DRIVER OK" in out.stdout
        assert "ADD 42" in out.stdout

        # Wrong pinned cert: the TLS handshake/verification must fail —
        # no fallback to plaintext, no partial protocol progress.
        other_cert = str(tmp_path / "other.crt")
        other_key = str(tmp_path / "other.key")
        generate_self_signed(other_cert, other_key)
        bad = subprocess.run(
            [
                str(binaries / "raytpu_demo"),
                info["address"], "tls-test-token", other_cert,
            ],
            capture_output=True, text=True, timeout=60,
        )
        assert bad.returncode != 0
        assert "CPP DRIVER OK" not in bad.stdout
    finally:
        ray_tpu_torch.shutdown()
        _config.clear_system_config("TLS_CERT", "TLS_KEY", "AUTH_TOKEN")


def test_cpp_reconnecting_client_survives_head_restart(binaries, tmp_path):
    """Kill the head mid-probe and restart it on the same port: the C++
    ReconnectingClient backs off, re-dials, and every idempotent call
    completes (the chaos test the Python ReconnectingClient has)."""
    journal = str(tmp_path / "head.journal")
    info = ray_tpu_torch.init(
        num_cpus=2, _system_config={"HEAD_JOURNAL": journal}
    )
    try:
        probe = subprocess.Popen(
            [
                str(binaries / "raytpu_reconnect_probe"),
                info["address"], "30",
            ],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        time.sleep(0.8)  # a few iterations against the original head

        rt = ray_tpu_torch.api._runtime
        old_head = rt.head
        host, port = info["address"].rsplit(":", 1)

        async def crash_restart():
            import asyncio

            from ray_tpu_torch.runtime.head import HeadService

            if old_head._reaper:
                old_head._reaper.cancel()
            await old_head.server.stop()
            if old_head.journal is not None:
                old_head.journal.close()
            await asyncio.sleep(1.5)  # leave the probe dialing a hole
            new_head = HeadService(journal_path=journal)
            await new_head.start(host, int(port))
            return new_head

        rt.head = rt.run(crash_restart(), timeout=60)
        out, err = probe.communicate(timeout=60)
        assert probe.returncode == 0, out + err
        assert "PROBE OK n=30" in out
    finally:
        ray_tpu_torch.shutdown()
        _config.clear_system_config("HEAD_JOURNAL")

def test_cpp_worker_serves_in_tls_cluster(binaries, tmp_path):
    """Full-TLS cluster with C++-defined remote functions: the worker
    binary dials the node TLS-pinned AND serves its own task endpoint
    over TLS (Python driver -> TLS -> C++ worker round trip)."""
    cert = str(tmp_path / "tls.crt")
    key = str(tmp_path / "tls.key")
    generate_self_signed(cert, key)
    info = ray_tpu_torch.init(
        num_cpus=4,
        _system_config={
            "TLS_CERT": cert,
            "TLS_KEY": key,
            "AUTH_TOKEN": "tls-worker-token",
            "CPP_WORKER_CMD": str(binaries / "raytpu_worker"),
        },
    )
    try:
        add = ray_tpu_torch.cross_language.cpp_function("Add")
        assert ray_tpu_torch.get(add.remote(40, 2)) == 42
        sort = ray_tpu_torch.cross_language.cpp_function("SortInts")
        assert ray_tpu_torch.get(sort.remote([3, 1, 2]))["sorted"] == [1, 2, 3]
    finally:
        ray_tpu_torch.shutdown()
        _config.clear_system_config(
            "TLS_CERT", "TLS_KEY", "AUTH_TOKEN", "CPP_WORKER_CMD"
        )
