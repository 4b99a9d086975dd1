"""The port's C++ driver client (``ray_tpu_torch/cpp/``): cross-language
calls over the wire protocol against the port's cluster (port of
tests/test_cpp_client.py, with the port's g++ build).

The C++ sources are built by ``ray_tpu_torch._native.cpp_client`` into
``build/ray_tpu_torch/cpp-<hash>/`` at first use (skipped without a C++
toolchain, as the JAX package's tests are). Parity: the port's demo
prints the same lines against the port's cluster as against the JAX
package's, which runs in a process of its own.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch import api as core_api
from ray_tpu_torch._native import cpp_client
from ray_tpu_torch._private.xlang import register_function, unregister_function
from torch_runtime_util import start_cluster, stop_cluster

REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ toolchain",
)

# Registered on both clusters: the demo calls all three.
FUNCTIONS = """
def cpp_add(a, b):
    return a + b

def cpp_stats(nums):
    return {"sum": sum(nums), "mean": sum(nums) / len(nums)}

def cpp_boom():
    raise ValueError("cpp-facing kaboom")
"""

JAX_SIDE = """
import subprocess, sys
import ray_tpu
from ray_tpu._private.xlang import register_function
ns = {}
exec(sys.argv[2], ns)
info = ray_tpu.init(num_cpus=2)
for name in ("cpp_add", "cpp_stats", "cpp_boom"):
    register_function(name, ns[name])
out = subprocess.run([sys.argv[1], info["address"]], capture_output=True,
                     text=True, timeout=120)
ray_tpu.shutdown()
sys.stdout.write(out.stdout)
sys.exit(out.returncode)
"""


@pytest.fixture(scope="module")
def demo_bin():
    return cpp_client.program("raytpu_demo")


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=4)
    ns = {}
    exec(FUNCTIONS, ns)
    for name in ("cpp_add", "cpp_stats", "cpp_boom"):
        register_function(name, ns[name])
    yield info
    stop_cluster(info)


def _demo_lines(out: str) -> list[str]:
    """The demo's lines with the remote error's text cut to its message
    (the traceback names each package's own files)."""
    return [re.sub(r"^(RAISED ).*?(ValueError: cpp-facing kaboom).*$",
                   r"\1\2", line) for line in out.splitlines()]


def test_sources_are_the_roots_in_the_ports_names():
    """The port's C++ tree is cpp/'s include/ and src/ with the package
    renamed in comments; cpp/Makefile is not copied (the port builds
    with g++ from Python)."""
    root = REPO / "cpp"
    ours = sorted(p.relative_to(cpp_client.CPP_DIR)
                  for p in cpp_client.CPP_DIR.rglob("*") if p.is_file())
    theirs = sorted(p.relative_to(root) for p in root.rglob("*")
                    if p.is_file() and p.parts[len(root.parts)] in
                    ("include", "src"))
    assert ours == theirs and ours
    for rel in ours:
        want = re.sub(r"\bray_tpu\b", "ray_tpu_torch",
                      (root / rel).read_text())
        assert (cpp_client.CPP_DIR / rel).read_text() == want, rel


def test_build_lands_in_the_ports_build_dir(demo_bin):
    out = cpp_client.build()
    assert out.parent == REPO / "build" / "ray_tpu_torch"
    assert out.name.startswith("cpp-")
    for name in ("libraytpu.a", *cpp_client.PROGRAMS):
        assert (out / name).is_file()
        if name != "libraytpu.a":
            assert os.access(out / name, os.X_OK)
    assert demo_bin == out / "raytpu_demo"
    with pytest.raises(KeyError):
        cpp_client.program("raytpu_nothing")


def test_concurrent_builds_agree(tmp_path):
    """Two processes build into one empty build directory at once: both
    succeed with the same path, and no temporary directory stays."""
    code = ("import sys; from pathlib import Path\n"
            "from ray_tpu_torch._native import cpp_client as c\n"
            "c.BUILD_DIR = Path(sys.argv[1])\n"
            "print(c.build())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(tmp_path)) == [Path(paths.pop()).name]


def test_failed_build_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main() { return undefined_name; }\n")
    with pytest.raises(cpp_client.NativeBuildError, match="undefined_name"):
        cpp_client.build_program(bad, tmp_path / "bad")


def test_cpp_driver_end_to_end(cluster, demo_bin):
    head_addr = core_api._runtime.core.head_addr
    out = subprocess.run([str(demo_bin), head_addr], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert "KV from-cpp" in lines
    assert any(l.startswith("NODES ") and int(l.split()[1]) >= 1
               for l in lines)
    assert "ADD 42" in lines
    assert "STATS sum=30 mean=7.5" in lines
    assert any(l.startswith("RAISED ") and "cpp-facing kaboom" in l
               for l in lines)
    assert lines[-1] == "CPP DRIVER OK"


def test_demo_prints_the_same_against_the_jax_cluster(cluster, demo_bin):
    """The port's demo against the JAX package's cluster (in its own
    process) prints the lines it prints against the port's."""
    ours = subprocess.run([str(demo_bin), core_api._runtime.core.head_addr],
                          capture_output=True, text=True, timeout=120)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               p for p in (str(REPO), os.environ.get("PYTHONPATH", ""))
               if p)}
    theirs = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, str(demo_bin), FUNCTIONS],
        capture_output=True, text=True, timeout=240, env=env)
    assert theirs.returncode == 0, theirs.stdout + theirs.stderr
    assert _demo_lines(ours.stdout) == _demo_lines(theirs.stdout)
    assert [l.split()[0] for l in _demo_lines(ours.stdout)] == [
        "KV", "NODES", "ADD", "STATS", "RAISED", "CPP"]


def test_cpp_driver_against_authed_daemons(demo_bin, tmp_path):
    """The port's CLI daemons with auth on: the C++ client's token
    preamble satisfies the handshake; a wrong token is refused."""
    session = str(tmp_path / "head_session")
    env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": os.pathsep.join(
            p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p),
    }

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts", *args],
            capture_output=True, text=True, timeout=120, env=env)

    out = cli("start", "--head", "--port", "0", "--session-dir", session,
              "--num-cpus", "2")
    assert out.returncode == 0, out.stdout + out.stderr
    try:
        addr = open(Path(session) / "head.addr").read().strip()
        token = open(Path(session) / "auth.token").read().strip()
        reg = subprocess.run(
            [sys.executable, "-c",
             "import ray_tpu_torch\n"
             "from ray_tpu_torch._private.xlang import register_function\n"
             f"ray_tpu_torch.init(address={addr!r})\n"
             "register_function('cpp_add', lambda a, b: a + b)\n"
             "register_function('cpp_stats', lambda ns: "
             "{'sum': sum(ns), 'mean': sum(ns) / len(ns)})\n"
             "register_function('cpp_boom', lambda: 1 / 0)\n"
             "print('registered')\n"],
            capture_output=True, text=True, timeout=120,
            env={**env, "RAY_TPU_AUTH_TOKEN": token})
        assert "registered" in reg.stdout, reg.stdout + reg.stderr
        bad = subprocess.run([str(demo_bin), addr, "wrong-token"],
                             capture_output=True, text=True, timeout=60)
        assert bad.returncode != 0
        good = subprocess.run([str(demo_bin), addr, token],
                              capture_output=True, text=True, timeout=120)
        assert good.returncode == 0, good.stdout + good.stderr
        assert "ADD 42" in good.stdout
        assert good.stdout.splitlines()[-1] == "CPP DRIVER OK"
    finally:
        cli("stop", "--session-dir", session)


def test_python_can_call_xlang_functions_too(cluster):
    @ray_tpu_torch.remote
    def via_python():
        return "ok"

    assert ray_tpu_torch.get(via_python.remote()) == "ok"


def _xlang_call(name, *args):
    """Drive the wire the way a C++ caller does (msgpack args/result)."""
    from ray_tpu_torch._private import rpc

    rt = core_api._runtime

    async def call():
        node_conn = rt.core.node
        lease = await node_conn.call(
            "lease_worker", resources={"CPU": 1.0}, actor=False)
        assert lease["ok"]
        conn = await rt.core._connect(lease["addr"])
        spec = {
            "task_id": os.urandom(16).hex(),
            "fn_id": f"xfn:{name}",
            "args": [(None, "mp", rpc.pack_frame(a)) for a in args],
            "num_returns": 1,
            "xlang": True,
        }
        reply = await conn.call("push_task", spec=spec)
        await node_conn.call("return_lease", lease_id=lease["lease_id"])
        return reply

    return rt.run(call())


def test_reregister_takes_effect_on_pooled_workers(cluster):
    from ray_tpu_torch._private import rpc

    register_function("cpp_versioned", lambda: "v1")
    reply = _xlang_call("cpp_versioned")
    assert reply["status"] == "ok"
    assert rpc.unpack_frame(reply["results"][0][2]) == "v1"
    register_function("cpp_versioned", lambda: "v2")
    reply = _xlang_call("cpp_versioned")
    assert rpc.unpack_frame(reply["results"][0][2]) == "v2"


def test_xlang_rejects_unencodable_result(cluster):
    register_function("cpp_bad", lambda: object())
    reply = _xlang_call("cpp_bad")
    assert reply["status"] == "error"
    assert "msgpack" in reply["error_text"]


def test_unregister_and_name_checks(cluster, demo_bin, tmp_path):
    """An unregistered name comes back to a C++ driver as an error text
    (not a crash), and ':' is refused in a name."""
    with pytest.raises(ValueError, match=":"):
        register_function("bad:name", lambda: 1)
    register_function("cpp_gone", lambda: 1)
    unregister_function("cpp_gone")
    src = tmp_path / "gone.cpp"
    src.write_text(
        '#include <iostream>\n#include "raytpu/client.h"\n'
        "int main(int, char** argv) {\n"
        "  raytpu::Driver drv(argv[1], \"\");\n"
        "  std::string v;\n"
        "  std::cout << \"KV \" << drv.head().KvGet(\"xfn:cpp_gone\", &v)\n"
        "            << \"\\n\";\n"
        "  try { drv.Call(\"cpp_gone\", {}); }\n"
        "  catch (const std::exception& e) {\n"
        "    std::cout << \"RAISED \" << e.what() << \"\\n\"; return 0; }\n"
        "  return 1;\n}\n")
    exe = cpp_client.build_program(src, tmp_path / "gone")
    out = subprocess.run([str(exe), core_api._runtime.core.head_addr],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "KV 0"
    assert lines[1].startswith("RAISED raytpu task failed: ")
    assert "cpp_gone" in lines[1]
