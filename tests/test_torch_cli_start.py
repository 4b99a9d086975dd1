"""Cluster bootstrap CLI: `start --head` / `start --address` / `stop`
(reference: `ray start`, scripts/scripts.py:682). Brings up a 2-node
cluster as daemonized subprocesses, runs tasks on both nodes from a
client driver, then stops everything.
(port of tests/test_cli_start.py: the same cases on
``python -m ray_tpu_torch.scripts``, whose daemon is the port's; each
CLI call has its own time limit)
"""

import importlib.util
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.placement import placement_group


def _cli(args, timeout=60, extra_env=None):
    env = dict(os.environ)
    env.update(extra_env or {})
    env["JAX_PLATFORMS"] = "cpu"
    repo_root = os.path.dirname(os.path.dirname(ray_tpu_torch.__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo_root, env.get("PYTHONPATH", "")) if p
    )
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", *args],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env,
    )


def test_start_head_join_stop(tmp_path):
    d_head = str(tmp_path / "head_session")
    d_node = str(tmp_path / "node_session")

    out = _cli(
        [
            "start", "--head", "--port", "0",
            "--session-dir", d_head, "--num-cpus", "1",
        ]
    )
    assert out.returncode == 0, out.stdout + out.stderr
    addr = open(os.path.join(d_head, "head.addr")).read().strip()

    # Auth is on by default: the head generated a token (0600). The join
    # command references it WITHOUT leaking the literal secret to a
    # non-TTY stdout (captured logs must never contain the token).
    token_path = os.path.join(d_head, "auth.token")
    assert os.path.exists(token_path)
    assert os.stat(token_path).st_mode & 0o777 == 0o600
    token = open(token_path).read().strip()
    assert token and token not in out.stdout
    assert f"RAY_TPU_AUTH_TOKEN=$(cat {token_path})" in out.stdout

    from ray_tpu_torch._private import config as _config

    try:
        # A separate "host" (fresh session dir) joins WITH the token.
        out = _cli(
            [
                "start", "--address", addr, "--auth-token", token,
                "--session-dir", d_node, "--num-cpus", "1",
            ]
        )
        assert out.returncode == 0, out.stdout + out.stderr

        # A tokenless stranger is refused before any pickle parsing.
        import pytest as _pytest

        from ray_tpu_torch._private import rpc as _rpc

        with _pytest.raises(Exception):
            ray_tpu_torch.init(address=f"ray://{addr}")
        ray_tpu_torch.shutdown()

        # Client driver (joins NO node): work must land on the two
        # CLI-started nodes.
        _config.set_system_config({"AUTH_TOKEN": token})
        ray_tpu_torch.init(address=f"ray://{addr}")
        try:
            # Wait for both nodes to register.
            rt = ray_tpu_torch.api._runtime
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                nodes = rt.run(rt.core.head.call("node_table"))
                if len(nodes) >= 2:
                    break
                time.sleep(0.5)
            assert len(nodes) >= 2, f"nodes: {list(nodes)}"

            # STRICT_SPREAD gang: one actor per node, deterministically
            # proving BOTH CLI-started nodes execute work.
            pg = placement_group(
                [{"CPU": 1.0}, {"CPU": 1.0}], strategy="STRICT_SPREAD"
            )

            @ray_tpu_torch.remote
            class Home:
                def where(self):
                    import os as _os

                    return _os.environ["RAY_TPU_NODE_ADDR"]

            actors = [
                Home.options(
                    placement_group=pg, placement_group_bundle_index=i
                ).remote()
                for i in range(2)
            ]
            homes = ray_tpu_torch.get(
                [a.where.remote() for a in actors], timeout=60
            )
            assert len(set(homes)) == 2, homes
        finally:
            ray_tpu_torch.shutdown()
    finally:
        _config._overrides.pop("AUTH_TOKEN", None)
        os.environ.pop("RAY_TPU_AUTH_TOKEN", None)
        env_tok = {"RAY_TPU_AUTH_TOKEN": token}
        out1 = _cli(["stop", "--session-dir", d_node], extra_env=env_tok)
        out2 = _cli(["stop", "--session-dir", d_head], extra_env=env_tok)
    assert out1.returncode == 0 and out2.returncode == 0
    # pid files consumed; daemons gone.
    assert not [
        f for f in os.listdir(d_head) if f.endswith(".pid")
    ]
    assert not [
        f for f in os.listdir(d_node) if f.endswith(".pid")
    ]


def test_no_auth_flag_and_routable_warning(tmp_path):
    """--no-auth disables the token (loopback dev path) and keeps the
    old zero-config join working."""
    d = str(tmp_path / "noauth_session")
    out = _cli(
        [
            "start", "--head", "--port", "0", "--no-auth",
            "--session-dir", d, "--num-cpus", "1",
        ]
    )
    try:
        assert out.returncode == 0, out.stdout + out.stderr
        assert not os.path.exists(os.path.join(d, "auth.token"))
        addr = open(os.path.join(d, "head.addr")).read().strip()
        ray_tpu_torch.init(address=f"ray://{addr}")
        try:
            @ray_tpu_torch.remote
            def f():
                return "ok"

            assert ray_tpu_torch.get(f.remote(), timeout=60) == "ok"
        finally:
            ray_tpu_torch.shutdown()
    finally:
        _cli(["stop", "--session-dir", d])


@pytest.mark.skipif(importlib.util.find_spec("cryptography") is None,
                    reason="start --tls generates its certificate with the "
                           "cryptography package, which is not installed")
def test_tls_encrypted_cluster(tmp_path):
    """--tls: RPC rides an encrypted channel; a client pinning the
    generated cert (plus token) connects, a cert-less client cannot."""
    d = str(tmp_path / "tls_session")
    out = _cli(
        [
            "start", "--head", "--port", "0", "--tls",
            "--session-dir", d, "--num-cpus", "1",
        ]
    )
    from ray_tpu_torch._private import config as _config

    try:
        assert out.returncode == 0, out.stdout + out.stderr
        cert = os.path.join(d, "tls.crt")
        assert os.path.exists(cert)
        token = open(os.path.join(d, "auth.token")).read().strip()
        addr = open(os.path.join(d, "head.addr")).read().strip()

        # Without the cert the TLS handshake fails outright.
        _config.set_system_config({"AUTH_TOKEN": token})
        import pytest as _pytest

        with _pytest.raises(Exception):
            ray_tpu_torch.init(address=f"ray://{addr}")
        ray_tpu_torch.shutdown()

        _config.set_system_config({"AUTH_TOKEN": token, "TLS_CERT": cert})
        ray_tpu_torch.init(address=f"ray://{addr}")
        try:
            @ray_tpu_torch.remote
            def g():
                return 7

            assert ray_tpu_torch.get(g.remote(), timeout=60) == 7
        finally:
            ray_tpu_torch.shutdown()
    finally:
        for k in ("AUTH_TOKEN", "TLS_CERT"):
            _config._overrides.pop(k, None)
            os.environ.pop(f"RAY_TPU_{k}", None)
        _cli(
            ["stop", "--session-dir", d],
            extra_env={"RAY_TPU_AUTH_TOKEN": "x"},
        )
